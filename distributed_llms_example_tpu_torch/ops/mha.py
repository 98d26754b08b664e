"""Multi-head attention (port of the JAX package's ``ops/mha.py``).

One module covers BART's self- and cross-attention: scaled dot-product
attention with biased projections, causal masking, and a fixed-shape
per-layer KV cache written per row for continuous-batching decode.  The
dispatch mirrors the JAX module: a cached decode step goes to the flash
decode kernel, an uncached pass to the flash-attention kernels (forward,
and under autograd the dq and dk/dv backward),
each where ``select_*_impl`` picks it (on CUDA, for every shape the
kernels have an instance for; for CPU tensors, by the JAX package's own
rule), and to plain attention (the counterpart of the JAX package's XLA
path, hence the name ``"xla"``) otherwise.  Ring attention, sharded
execution, RoPE, GQA and attention-probs dropout (which raises in
training mode) join with later slices.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from distributed_llms_example_tpu_torch.ops.attention import (
    NEG_INF,
    dot_product_attention,
    make_causal_bias,
)
from distributed_llms_example_tpu_torch.ops.dense import Dense
from distributed_llms_example_tpu_torch.ops.flash_attention import (
    KERNEL_HEAD_DIMS,
    MAX_DECODE_Q_ROWS,
    flash_attention,
    flash_decode,
    flash_decode_supported,
    flash_supported,
)
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
    use_cache: bool, backend: str, causal: bool = False,
) -> tuple[str, str]:
    """(impl, reason) for an uncached attention call — pure selection logic.

    On CUDA, ``auto`` and ``flash`` pick the flash-attention kernel for
    every shape it has an instance for (any lengths; head_dim in
    ``KERNEL_HEAD_DIMS``), with one exception for ``auto``: a one-row q
    against a longer K/V — the cross-attention of a decode step — stays
    plain attention, as in the JAX package (``flash`` sends it to the
    kernel too).  For CPU tensors the JAX package's rule holds, so both
    packages run the same path: ``flash`` where the shape tiles, plain
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
    if not flash_supported(q_len, kv_len, head_dim, causal=causal):
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


@dataclasses.dataclass
class KVCache:
    """One attention layer's decode cache: (B, H, L, d) K and V buffers in
    the compute dtype, updated in place by ``write_cache_rows``."""

    k: torch.Tensor
    v: torch.Tensor


def write_cache_rows(buf: torch.Tensor, new: torch.Tensor, positions: torch.Tensor) -> None:
    """Per-row in-place cache write: row b's T new positions land at
    ``positions[b] + [0, T)``; an out-of-range position is a no-op, which
    is how idle serving slots park (the JAX package's ``mode="drop"``).
    Done without a host sync: the clamped slot is rewritten with its own
    old value where the position is out of range."""
    B, _, L, _ = buf.shape
    rows = torch.arange(B, device=buf.device)
    for t in range(new.shape[2]):
        pos = positions.long() + t
        valid = (pos >= 0) & (pos < L)
        idx = pos.clamp(0, L - 1)
        old = buf[rows, :, idx]  # (B, H, d)
        buf[rows, :, idx] = torch.where(valid[:, None, None], new[:, :, t].to(buf.dtype), old)


class MultiHeadAttention(nn.Module):
    def __init__(self, num_heads: int, head_dim: int, model_dim: int, *,
                 use_bias: bool = True, causal: bool = False,
                 dtype: torch.dtype = torch.float32, param_dtype: torch.dtype = torch.float32,
                 attention_impl: str = "auto", probs_dropout_rate: float = 0.0, device=None):
        super().__init__()
        _check_impl(attention_impl)
        self.num_heads, self.head_dim = num_heads, head_dim
        self.probs_dropout_rate = float(probs_dropout_rate)
        self.causal, self.dtype, self.attention_impl = causal, dtype, attention_impl
        inner = num_heads * head_dim

        def mk(i, o):
            return Dense(i, o, use_bias=use_bias, dtype=dtype, param_dtype=param_dtype,
                         device=device)

        self.q_proj = mk(model_dim, inner)
        self.k_proj = mk(model_dim, inner)
        self.v_proj = mk(model_dim, inner)
        self.o_proj = mk(inner, model_dim)

    def _split(self, x: torch.Tensor) -> torch.Tensor:
        b, s, _ = x.shape
        return x.reshape(b, s, self.num_heads, self.head_dim).transpose(1, 2)

    def _merge(self, out: torch.Tensor) -> torch.Tensor:
        b, h, s, d = out.shape
        return self.o_proj(out.transpose(1, 2).reshape(b, s, h * d))

    def project_kv(self, kv_hidden: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """K/V projections alone, (B, H, S, d) each, contiguous — computed
        once per sequence for cross-attention and fed back via
        ``cross_kv`` on every decode step."""
        return (
            self._split(self.k_proj(kv_hidden)).contiguous(),
            self._split(self.v_proj(kv_hidden)).contiguous(),
        )

    def forward(
        self,
        hidden: torch.Tensor,
        kv_hidden: torch.Tensor | None = None,
        bias: torch.Tensor | None = None,
        cache: KVCache | None = None,
        cache_positions: torch.Tensor | None = None,
        cross_kv: tuple[torch.Tensor, torch.Tensor] | None = None,
    ) -> torch.Tensor:
        """``cache`` + ``cache_positions`` ((B,) int32 per-row write offsets)
        make this a cached decode step of a causal layer: this step's K/V
        land in the cache in place, and row r of batch b attends slots <=
        ``cache_positions[b] + r``.  ``cross_kv`` skips the k/v projections
        (cross-attention decode)."""
        q = self._split(self.q_proj(hidden))
        if cross_kv is not None:
            k, v = cross_kv
            if k.shape[0] != hidden.shape[0]:
                raise NotImplementedError(
                    "beam-grouped cross-attention waits for the beam-search slice (ROADMAP)"
                )
        else:
            kv_src = hidden if kv_hidden is None else kv_hidden
            k = self._split(self.k_proj(kv_src))
            v = self._split(self.v_proj(kv_src))

        use_cache = cache is not None
        if use_cache:
            if not self.causal:
                raise ValueError("a KV cache belongs to causal self-attention only")
            if cache_positions is None:
                raise ValueError("a cached step needs per-row cache_positions (B,)")
            write_cache_rows(cache.k, k, cache_positions)
            write_cache_rows(cache.v, v, cache_positions)
            k, v = cache.k, cache.v
            impl, reason = select_decode_impl(
                self.attention_impl, head_dim=self.head_dim, q_len=q.shape[2],
                kv_len=k.shape[2], backend=q.device.type,
            )
            _log_impl_once(impl, reason)
            if impl == "flash_decode":
                # bias is the caller's constant padding mask only: validity
                # and causality ride the kernel's per-row length mask
                out = flash_decode(
                    q.contiguous(), k, v, bias,
                    offsets=cache_positions.to(torch.int32), dtype=self.dtype,
                )
            else:
                step = decode_step_bias(cache_positions, q.shape[2], k.shape[2])
                out = dot_product_attention(
                    q, k, v, step if bias is None else bias + step, dtype=self.dtype
                )
            return self._merge(out)

        if self.training and self.probs_dropout_rate > 0.0:
            # the flash kernels' in-kernel probs-dropout branch is not ported
            # (bart-large-cnn trains with attention dropout 0): refuse rather
            # than train without the configured dropout
            raise NotImplementedError(
                f"attention-probs dropout (rate {self.probs_dropout_rate}) is not ported yet "
                "(ROADMAP)"
            )
        causal_here = self.causal
        impl, reason = select_attention_impl(
            self.attention_impl, head_dim=self.head_dim, q_len=q.shape[2],
            kv_len=k.shape[2], use_cache=False, backend=q.device.type, causal=causal_here,
        )
        _log_impl_once(impl, reason)
        if impl == "flash":
            out = flash_attention(
                q.contiguous(), k.contiguous(), v.contiguous(), bias,
                causal=causal_here, dtype=self.dtype,
            )
        else:
            if causal_here:
                step = make_causal_bias(q.shape[2], k.shape[2], device=q.device)
                bias = step if bias is None else bias + step
            out = dot_product_attention(q, k, v, bias, dtype=self.dtype)
        return self._merge(out)
