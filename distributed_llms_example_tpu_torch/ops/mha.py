"""Multi-head attention (port of the JAX package's ``ops/mha.py``).

One module covers BART's self- and cross-attention, LLaMA's causal
self-attention and T5's unscaled attention (``models/t5.py`` sets
``scale=1`` and passes its relative-position bias as ``learned_bias``):
dot-product attention with optional projection biases, causal masking, a
differentiable learned bias, RoPE in the HF half-rotation layout, grouped-query
attention (``num_kv_heads``; K/V repeated per group on the paths that need
full heads), and two decode caches written per row for continuous-batching
decode: a flat per-layer ``KVCache`` and a ``PagedKVCache`` over a shared
block pool, each in the compute dtype or int8 with per-position fp32
scales (the decode kernels dequantize per tile; the plain path through
``dequantize_kv``, the same expression), each written a span of rows a
slot at its own position (one row a decode step, k + 1 a speculative
verify block, a warm prompt tail).  The dispatch mirrors the JAX module:
a cached step goes to the flash decode kernel (the paged kernel for a
paged cache), an uncached pass to the flash-attention kernels (forward,
and under autograd the dq and dk/dv backward), each where ``select_*_impl`` picks it (on CUDA, for every
shape the kernels have an instance for; for CPU tensors, by the JAX
package's own rule), and to plain attention (the counterpart of the JAX
package's XLA path, hence the name ``"xla"``) otherwise.  A cached pass of
more than ``MAX_DECODE_Q_ROWS`` rows is plain attention, as in the JAX
package, but for the LLaMA prompt prefill on CUDA: a flat cache written
from slot 0 holds only the pass's own keys, so the prefill is the uncached
causal pass over them and goes to the flash-attention kernel (not into an
int8 cache: there, as in the JAX package, the prefill attends over the
dequantized cache).  A beam-search cross-attention is plain attention too,
whose ``cross_kv`` holds one row for the G beams of a row: the beam group
is folded next to the heads (``ops/attention.beam_grouped_attention``),
or under GQA K/V are repeated per beam.  Attention-probs dropout
(``probs_dropout_rate``) applies to uncached passes in training mode: one
int32 seed a call from the host-side stream of ``fused_dropout.next_seed``
(what ``train_step`` opens with ``dropout_seeds``), passed to the flash
kernels' in-kernel mask or to the plain route, which draws the same mask;
eval and cached passes never drop, as in the JAX package.  Ring attention
(which raises on CUDA, dropout or not) and sharded execution join with
later slices.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from distributed_llms_example_tpu_torch.ops.attention import (
    NEG_INF,
    beam_grouped_attention,
    dot_product_attention,
    make_causal_bias,
)
from distributed_llms_example_tpu_torch.ops.dense import Dense
from distributed_llms_example_tpu_torch.ops.fused_dropout import next_seed, shard_seed
from distributed_llms_example_tpu_torch.ops.flash_attention import (
    KERNEL_HEAD_DIMS,
    MAX_DECODE_Q_ROWS,
    flash_attention,
    flash_decode,
    flash_decode_paged,
    flash_decode_supported,
    flash_supported,
    dequantize_kv,
    quantize_kv,
)
from distributed_llms_example_tpu_torch.serving.cache_pool import gather_cache, scatter_step
from distributed_llms_example_tpu_torch.utils.jsonlog import log_json

IMPLS = ("auto", "flash", "ring", "xla")
_IMPL_LOGGED: set[tuple] = set()


def _log_impl_once(impl: str, reason: str) -> None:
    """One JSON line per (impl, reason) saying which attention path ran."""
    key = (impl, reason)
    if key not in _IMPL_LOGGED:
        _IMPL_LOGGED.add(key)
        log_json({"event": "attention_impl", "impl": impl, "reason": reason})


def _check_impl(attention_impl: str) -> None:
    if attention_impl not in IMPLS:
        raise ValueError(
            f"attention_impl={attention_impl!r}: must be 'auto', 'flash', 'ring', or 'xla'"
        )


def _ring_unported(backend: str) -> None:
    if backend == "cuda":
        raise NotImplementedError(
            "attention_impl='ring': ring attention is not ported yet (ROADMAP)"
        )


def select_attention_impl(
    attention_impl: str, *, head_dim: int, q_len: int, kv_len: int,
    use_cache: bool, backend: str, causal: bool = False, has_learned_bias: bool = False,
) -> tuple[str, str]:
    """(impl, reason) for an uncached attention call — pure selection logic.

    On CUDA, ``auto`` and ``flash`` pick the flash-attention kernel for
    every shape it has an instance for (any lengths; head_dim in
    ``KERNEL_HEAD_DIMS``), with one exception for ``auto``: a one-row q
    against a longer K/V — the cross-attention of a decode step — stays
    plain attention, as in the JAX package (``flash`` sends it to the
    kernel too).  For CPU tensors the JAX package's rule holds, so both
    packages run the same path: ``flash`` where the shape tiles (with the
    learned-bias path's tile caps when ``has_learned_bias``), plain
    attention otherwise and for ``auto``.  ``ring`` has no port yet: it
    raises on CUDA and runs plain attention on the CPU, as the JAX package
    does without a mesh."""
    _check_impl(attention_impl)
    if attention_impl == "xla":
        return "xla", "forced"
    if use_cache:
        return "xla", "kv-cache decode step"
    if attention_impl == "ring":
        _ring_unported(backend)
        return "xla", "ring requested but ring attention is not ported yet (ROADMAP)"
    if backend == "cuda":
        if head_dim not in KERNEL_HEAD_DIMS:
            return "xla", f"{attention_impl}: no kernel instance for head_dim={head_dim}"
        if causal and q_len != kv_len:
            return "xla", f"{attention_impl}: top-left causal mask needs q_len == kv_len"
        if attention_impl == "auto" and q_len == 1 < kv_len:
            return "xla", "auto: one-row cross-attention of a decode step"
        return "flash", f"{attention_impl}: CUDA"
    if not flash_supported(q_len, kv_len, head_dim, causal=causal,
                           has_learned_bias=has_learned_bias):
        return "xla", f"shape not tileable (q={q_len}, kv={kv_len}, d={head_dim})"
    if attention_impl == "flash":
        return "flash", "forced"
    return "xla", f"auto: backend={backend} (the kernel runs on CUDA only)"


def select_decode_impl(
    attention_impl: str, *, head_dim: int, q_len: int, kv_len: int, backend: str,
) -> tuple[str, str]:
    """(impl, reason) for a cached decode step — the serving twin of
    ``select_attention_impl``: on CUDA the flash decode kernel for any
    cache length (q block <= ``MAX_DECODE_Q_ROWS``, head_dim in
    ``KERNEL_HEAD_DIMS``); for CPU tensors the JAX package's rule, with
    plain per-row masked attention for ``auto``."""
    _check_impl(attention_impl)
    if attention_impl == "xla":
        return "xla", "forced"
    if attention_impl == "ring":
        _ring_unported(backend)
        return "xla", "ring attention has no KV-cache decode path"
    if backend == "cuda":
        if head_dim not in KERNEL_HEAD_DIMS:
            return "xla", f"{attention_impl}: no kernel instance for head_dim={head_dim}"
        if q_len > MAX_DECODE_Q_ROWS:
            return "xla", f"{attention_impl}: q block of {q_len} rows > {MAX_DECODE_Q_ROWS}"
        return "flash_decode", f"{attention_impl}: CUDA decode"
    if not flash_decode_supported(q_len, kv_len, head_dim):
        return "xla", f"decode shape not tileable (q={q_len}, kv={kv_len}, d={head_dim})"
    if attention_impl == "flash":
        return "flash_decode", "forced"
    return "xla", f"auto: backend={backend} (the kernel runs on CUDA only)"


def decode_step_bias(offsets: torch.Tensor, q_len: int, kv_len: int) -> torch.Tensor:
    """(B, 1, q_len, kv_len) fp32 validity+causality mask for a cached step:
    q row r (absolute position ``offsets[b] + r``) attends cache slots <=
    its own position — the plain-path semantics of the decode kernel's
    in-kernel length mask."""
    dev = offsets.device
    k_pos = torch.arange(kv_len, device=dev)[None, None, None, :]
    q_pos = offsets.long()[:, None, None, None] + torch.arange(q_len, device=dev)[None, None, :, None]
    return torch.where(k_pos <= q_pos, torch.zeros((), device=dev),
                       torch.full((), NEG_INF, device=dev))


def rope_cos_sin(positions: torch.Tensor, head_dim: int,
                 theta: float = 10000.0) -> tuple[torch.Tensor, torch.Tensor]:
    """(..., head_dim) fp32 cos/sin tables for integer ``positions``, in the
    HF half-rotation layout (frequencies repeated, not interleaved)."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=positions.device) / head_dim
    inv_freq = 1.0 / (theta ** exps)
    freqs = positions.float()[..., None] * inv_freq
    emb = torch.cat([freqs, freqs], dim=-1)
    return torch.cos(emb), torch.sin(emb)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x: (batch, heads, seq, head_dim); cos/sin broadcastable to it."""
    half = x.shape[-1] // 2
    rotated = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
    return (x * cos + rotated * sin).to(x.dtype)


@dataclasses.dataclass
class KVCache:
    """One attention layer's flat decode cache: (B, H_kv, L, d) K and V
    buffers in the compute dtype, updated in place.  A step with per-row
    ``cache_positions`` writes row b's span at its own position
    (``write_cache_rows``); a step without them writes every row at the
    shared ``index`` and advances it (the JAX package's ``cache_index``:
    the prompt prefill).  An int8 cache holds int8 K and V and one fp32
    scale per (row, head, position) in ``k_scale``/``v_scale`` ((B, H_kv,
    L)): each write quantizes its own rows (``quantize_kv``), so nothing
    is ever requantized."""

    k: torch.Tensor
    v: torch.Tensor
    index: int = 0
    k_scale: torch.Tensor | None = None
    v_scale: torch.Tensor | None = None


def kv_leaves(cache) -> tuple[torch.Tensor, ...]:
    """A cache's buffers in one order: (k, v), then (k_scale, v_scale)
    for an int8 cache."""
    if cache.k_scale is None:
        return cache.k, cache.v
    return cache.k, cache.v, cache.k_scale, cache.v_scale


@dataclasses.dataclass
class PagedKVCache:
    """One attention layer's view of a shared block pool for one decode
    step: the layer's (N, H_kv, bs, d) K and V pools, the step's (B,
    n_tiles) int32 block tables on the device, and its write plan
    ``(rows, blocks, slots)`` — which batch rows write their new K/V row
    into which pool block at which in-block slot (parked rows and sentinel
    tiles are absent from it, so their writes drop).  The engine builds the
    plan once per step for every layer (``serving/cache_pool.py``).  A
    pass of ``span`` rows a slot (a speculative verify block) writes them
    all: the plan's rows index the (B·span) flattened rows.  An int8 pool
    carries its (N, H_kv, bs) fp32 scale pools in ``k_scale``/``v_scale``."""

    k: torch.Tensor
    v: torch.Tensor
    block_tables: torch.Tensor
    write: tuple[torch.Tensor, torch.Tensor, torch.Tensor]
    span: int = 1
    k_scale: torch.Tensor | None = None
    v_scale: torch.Tensor | None = None

    @property
    def kv_len(self) -> int:
        return self.block_tables.shape[1] * self.k.shape[2]

    def write_rows(self, *new: torch.Tensor) -> None:
        """This pass's ``span`` new rows per batch row ((B, H_kv, span, d)
        K and V, then (B, H_kv, span) scales for an int8 pool) into the
        pool, in place, through ``cache_pool.scatter_step``."""
        B, _, T = new[0].shape[:3]
        if T != self.span:
            raise ValueError(f"this pass writes {T} rows per slot, the write plan {self.span}")
        flat = tuple(x.transpose(1, 2).reshape(B * T, x.shape[1], *x.shape[3:]) for x in new)
        scatter_step(kv_leaves(self), flat, self.write)


def write_cache_rows(buf: torch.Tensor, new: torch.Tensor, positions: torch.Tensor) -> None:
    """Per-row in-place span write along axis 2 of a (B, H, L[, d]) buffer:
    row b's T new entries ((B, H, T[, d])) land at ``positions[b] + [0,
    T)``; an entry past the end is a no-op, which is how idle serving
    slots park (the JAX package's ``mode="drop"``).  One scatter, without
    a host sync: an entry past the end rewrites its row's last entry that
    lands, with that entry's value, and a row none of whose entries land
    rewrites slot L - 1 with its own old value, so no two writes of one
    call disagree.  Positions are never negative."""
    B, L, T = buf.shape[0], buf.shape[2], new.shape[2]
    dev = buf.device
    rows = torch.arange(B, device=dev)[:, None]
    pos = positions.long()
    last = (L - 1 - pos).clamp(max=T - 1)  # the row's last entry that lands; < 0: none
    src = torch.minimum(torch.arange(T, device=dev)[None, :], last[:, None]).clamp(min=0)
    idx = (pos[:, None] + src).clamp(0, L - 1)
    vals = new[rows, :, src].to(buf.dtype)  # (B, T, H[, d])
    parked = (last < 0).view(B, 1, *([1] * (buf.dim() - 2)))
    buf[rows, :, idx] = torch.where(parked, buf[rows, :, idx], vals)


class MultiHeadAttention(nn.Module):
    def __init__(self, num_heads: int, head_dim: int, model_dim: int, *,
                 num_kv_heads: int | None = None, use_bias: bool = True, causal: bool = False,
                 use_rope: bool = False, rope_theta: float = 10000.0,
                 dtype: torch.dtype = torch.float32, param_dtype: torch.dtype = torch.float32,
                 attention_impl: str = "auto", probs_dropout_rate: float = 0.0,
                 scale: float | None = None, device=None):
        super().__init__()
        _check_impl(attention_impl)
        self.num_heads, self.head_dim = num_heads, head_dim
        self.scale = head_dim ** -0.5 if scale is None else float(scale)
        self.kv_heads = num_heads if num_kv_heads is None else num_kv_heads
        if num_heads % self.kv_heads:
            raise ValueError(f"{self.kv_heads} kv heads do not divide {num_heads} heads")
        self.use_rope, self.rope_theta = use_rope, rope_theta
        self.probs_dropout_rate = float(probs_dropout_rate)
        self.causal, self.dtype, self.attention_impl = causal, dtype, attention_impl

        def mk(i, o):
            return Dense(i, o, use_bias=use_bias, dtype=dtype, param_dtype=param_dtype,
                         device=device)

        self.q_proj = mk(model_dim, num_heads * head_dim)
        self.k_proj = mk(model_dim, self.kv_heads * head_dim)
        self.v_proj = mk(model_dim, self.kv_heads * head_dim)
        self.o_proj = mk(num_heads * head_dim, model_dim)

    def _split(self, x: torch.Tensor, heads: int | None = None) -> torch.Tensor:
        b, s, _ = x.shape
        return x.reshape(b, s, heads or self.num_heads, self.head_dim).transpose(1, 2)

    def _merge(self, out: torch.Tensor) -> torch.Tensor:
        b, h, s, d = out.shape
        return self.o_proj(out.transpose(1, 2).reshape(b, s, h * d))

    def _repeat_kv(self, x: torch.Tensor) -> torch.Tensor:
        """Each kv head repeated over its group of q heads (``jnp.repeat``
        on the heads axis in the JAX package): q head h reads kv head
        h // (H / H_kv)."""
        rep = self.num_heads // self.kv_heads
        return x if rep == 1 else x.repeat_interleave(rep, dim=1)

    def _rope(self, q, k, positions):
        cos, sin = rope_cos_sin(positions, self.head_dim, self.rope_theta)
        cos, sin = cos[:, None], sin[:, None]  # add the heads axis
        return apply_rope(q, cos, sin), apply_rope(k, cos, sin)

    def project_kv(self, kv_hidden: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """K/V projections alone, (B, H_kv, S, d) each, contiguous — computed
        once per sequence for cross-attention and fed back via
        ``cross_kv`` on every decode step."""
        return (
            self._split(self.k_proj(kv_hidden), self.kv_heads).contiguous(),
            self._split(self.v_proj(kv_hidden), self.kv_heads).contiguous(),
        )

    def forward(
        self,
        hidden: torch.Tensor,
        kv_hidden: torch.Tensor | None = None,
        bias: torch.Tensor | None = None,
        cache: KVCache | PagedKVCache | None = None,
        cache_positions: torch.Tensor | None = None,
        cross_kv: tuple[torch.Tensor, torch.Tensor] | None = None,
        positions: torch.Tensor | None = None,
        learned_bias: torch.Tensor | None = None,
    ) -> torch.Tensor:
        """``cache`` makes this a cached pass of a causal layer: this pass's
        K/V land in the cache in place, at the per-row ``cache_positions``
        ((B,) int32) or, without them, at a flat cache's shared index; row
        r of batch b attends slots <= its write position + r.
        ``positions`` ((B, q_len) absolute positions) feed RoPE; they
        default to the write positions (cached) or to 0.. (uncached).
        ``cross_kv`` skips the k/v projections (cross-attention decode).
        ``learned_bias`` ((1, H, q_len, kv_len), uncached passes only) is
        added after ``bias`` and gets a gradient: the flash kernels' learned
        bias branch, or a term of the plain path's bias."""
        q = self._split(self.q_proj(hidden))
        if cross_kv is not None:
            k, v = cross_kv
            if k.shape[0] != hidden.shape[0]:
                G = hidden.shape[0] // k.shape[0]
                if self.kv_heads != self.num_heads:
                    # GQA cannot fold the beams next to the heads (the head
                    # counts already differ): K/V repeated per beam instead
                    k, v = k.repeat_interleave(G, dim=0), v.repeat_interleave(G, dim=0)
                else:
                    # beam decode: the beams of a row share its cross K/V,
                    # read once a row (plain attention, as in the JAX package)
                    _log_impl_once("xla", "beam-grouped cross-attention")
                    out = beam_grouped_attention(q, k, v, bias, scale=self.scale,
                                                 dtype=self.dtype, learned_bias=learned_bias)
                    return self._merge(out)
        else:
            kv_src = hidden if kv_hidden is None else kv_hidden
            k = self._split(self.k_proj(kv_src), self.kv_heads)
            v = self._split(self.v_proj(kv_src), self.kv_heads)

        if cache is not None:
            if learned_bias is not None:
                raise ValueError("a cached pass takes its position bias in `bias`")
            return self._cached(q, k, v, bias, cache, cache_positions, positions)
        if self.use_rope:
            if positions is None:
                positions = torch.arange(q.shape[2], device=q.device)[None, :]
            q, k = self._rope(q, k, positions)
        k, v = self._repeat_kv(k), self._repeat_kv(v)

        # probs dropout: one seed a call from the host-side stream (with the
        # rank's mesh position folded in), the same mask on either route
        rate = self.probs_dropout_rate if self.training else 0.0
        drop = (dict(dropout_rate=rate, dropout_seed=shard_seed(next_seed(), heads_axis=True))
                if rate > 0.0 else {})
        causal_here = self.causal
        impl, reason = select_attention_impl(
            self.attention_impl, head_dim=self.head_dim, q_len=q.shape[2],
            kv_len=k.shape[2], use_cache=False, backend=q.device.type, causal=causal_here,
            has_learned_bias=learned_bias is not None,
        )
        _log_impl_once(impl, reason)
        if impl == "flash":
            out = flash_attention(
                q.contiguous(), k.contiguous(), v.contiguous(), bias, learned_bias=learned_bias,
                causal=causal_here, scale=self.scale, dtype=self.dtype, **drop,
            )
        else:
            if causal_here:
                step = make_causal_bias(q.shape[2], k.shape[2], device=q.device)
                bias = step if bias is None else bias + step
            if learned_bias is not None:
                bias = learned_bias if bias is None else bias + learned_bias
            out = dot_product_attention(q, k, v, bias, scale=self.scale, dtype=self.dtype,
                                        **drop)
        return self._merge(out)

    def _prefill_from_zero(self, q, k, v, bias):
        """A prompt prefill written from cache slot 0 attends only its own
        keys (the rest of the cache is masked): on CUDA it is the uncached
        causal pass over them, through the flash-attention kernel, with the
        key-padding mask cut to the prompt.  None where the kernel has no
        instance (the caller then attends over the cache)."""
        T = q.shape[2]
        impl, reason = select_attention_impl(
            self.attention_impl, head_dim=self.head_dim, q_len=T, kv_len=T, use_cache=False,
            backend=q.device.type, causal=True)
        if impl != "flash":
            return None
        _log_impl_once(impl, f"prompt prefill from slot 0: {reason}")
        kb = None if bias is None else bias[..., :T].contiguous()
        out = flash_attention(q.contiguous(), self._repeat_kv(k).contiguous(),
                              self._repeat_kv(v).contiguous(), kb, causal=True,
                              scale=self.scale, dtype=self.dtype)
        return self._merge(out)

    def _cached(self, q, k, v, bias, cache, cache_positions, positions):
        """A cached pass: write this pass's K/V, then attend over the cache
        through the decode dispatch.  ``bias`` is the caller's constant
        padding mask or position bias (T5's per-row (B, H, q_len, L)
        relative bias); validity and causality ride the kernels' per-row
        length mask or, on the plain path, ``decode_step_bias``."""
        if not self.causal:
            raise ValueError("a KV cache belongs to causal self-attention only")
        paged = isinstance(cache, PagedKVCache)
        B, _, T, _ = q.shape
        if cache_positions is None:
            if paged:
                raise ValueError("a paged step needs per-row cache_positions (B,)")
            offsets = torch.full((B,), cache.index, dtype=torch.int32, device=q.device)
        else:
            offsets = cache_positions.to(torch.int32)
        if self.use_rope:
            # RoPE sees absolute positions, so rotate before caching
            if positions is None:
                positions = offsets.long()[:, None] + torch.arange(T, device=q.device)[None, :]
            q, k = self._rope(q, k, positions)
        # an int8 cache stores each written row quantized with its scale
        int8 = cache.k_scale is not None
        if int8:
            (kq, ks), (vq, vs) = quantize_kv(k), quantize_kv(v)
            new = (kq, vq, ks, vs)  # kv_leaves' order
        else:
            new = (k, v)
        if paged:
            cache.write_rows(*new)
            kv_len = cache.kv_len
        elif cache_positions is None:
            start = cache.index
            for buf, x in zip(kv_leaves(cache), new):
                buf[:, :, start:start + T] = x.to(buf.dtype)
            cache.index += T
            kv_len = cache.k.shape[2]
            if start == 0 and T > 1 and q.device.type == "cuda" and cache.k.dtype == k.dtype \
                    and (bias is None or bias.shape[1:3] == (1, 1)):
                out = self._prefill_from_zero(q, k, v, bias)
                if out is not None:
                    return out
        else:
            for buf, x in zip(kv_leaves(cache), new):
                write_cache_rows(buf, x, cache_positions)
            kv_len = cache.k.shape[2]
        impl, reason = select_decode_impl(
            self.attention_impl, head_dim=self.head_dim, q_len=T, kv_len=kv_len,
            backend=q.device.type,
        )
        if paged and impl == "flash_decode":
            impl = "flash_decode_paged"
        _log_impl_once(impl, reason)
        if impl == "flash_decode_paged":
            # the kernel reads the pool through the block tables: the slot
            # view is never built, and the kv-head groups are never repeated
            scales = (dict(k_scale_pool=cache.k_scale, v_scale_pool=cache.v_scale)
                      if int8 else {})
            out = flash_decode_paged(q.contiguous(), cache.k, cache.v, bias,
                                     block_tables=cache.block_tables, offsets=offsets,
                                     scale=self.scale, dtype=self.dtype, **scales)
            return self._merge(out)
        leaves = (gather_cache(kv_leaves(cache), cache.block_tables) if paged
                  else kv_leaves(cache))
        k, v, *scales = (self._repeat_kv(x) for x in leaves)
        if impl == "flash_decode":
            out = flash_decode(q.contiguous(), k, v, bias, offsets=offsets, scale=self.scale,
                               dtype=self.dtype,
                               **(dict(k_scale=scales[0], v_scale=scales[1]) if int8 else {}))
        else:
            if int8:
                # the expression the kernel evaluates per tile
                k, v = dequantize_kv(k, scales[0]), dequantize_kv(v, scales[1])
            step = decode_step_bias(offsets, T, kv_len)
            out = dot_product_attention(q, k, v, step if bias is None else bias + step,
                                        scale=self.scale, dtype=self.dtype)
        return self._merge(out)
