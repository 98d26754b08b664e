"""Flash attention (forward and backward) and flash decode: CUDA kernels
+ plain versions.

Port of the JAX package's ``ops/flash_attention.py``.  Each kernel has a
wrapper with three parts:

- a **plain PyTorch version** of the function (``*_plain``), which the
  wrapper runs for tensors on the CPU and which the chip check holds the
  kernel against;
- the **CUDA kernel** (``csrc/flash_fwd_tc.cu`` for bf16 and
  ``csrc/flash_fwd.cu`` for fp32; ``csrc/flash_bwd_tc.cu`` for bf16 and
  ``csrc/flash_bwd.cu`` for fp32, each with two entries, dq and dk/dv;
  ``csrc/flash_bwd_dlbias_tc.cu`` for bf16 and ``csrc/flash_bwd_dlbias.cu``
  for fp32; ``csrc/flash_decode.cu`` and ``csrc/flash_decode_paged.cu``, the
  flat and paged instances of one template in ``csrc/flash_decode.cuh``),
  which the wrapper launches for tensors on a CUDA device — or raises: there is no
  fallback from a CUDA tensor to the plain version;
- a **launch counter** (``flash_attention.launches``,
  ``flash_bwd_dq.launches``, ``flash_bwd_dkv.launches``,
  ``flash_bwd_dlbias.launches``, each with a ``tc_launches`` counting its
  bf16 tensor-core launches and a ``drop_launches`` counting its
  probs-dropout launches, ``flash_decode.launches``,
  ``flash_decode_paged.launches``): a plain integer bumped where the
  kernel is launched and nowhere else.

``flash_attention`` is a ``torch.autograd.Function``: its forward saves
(q, k, v, bias, learned bias, o, lse), its backward computes delta =
rowsum(dO * O) in PyTorch (as the JAX package does outside its kernels)
and runs the dq and dk/dv kernels, and the learned-bias gradient kernel
when the learned bias needs a gradient.  The bias is a constant mask and
gets no gradient; the learned bias (T5's relative-position bias) does.

Attention-probs dropout (``dropout_rate`` > 0 with an int32
``dropout_seed``) rides inside kernels 1-4, as in the JAX package: the
keep-mask of plane (b, h) is the counter hash of (seed, b, h, absolute
query, absolute key) (``fused_dropout.attention_keep_mask``, the JAX
package's ``hw_rng=False`` stream, bit for bit), drawn in the forward after
the row sum and redrawn by each backward kernel; the autograd Function
saves the seed and the rate, never a mask.

Layouts follow the JAX package: q/k/v (B, H, S, d), an additive ``bias``
whose every dim is 1 or full (e.g. a (B, 1, 1, K) padding mask), a
``learned_bias`` of exactly (1, H, Sq, Sk), lse (B, H, Sq) fp32.  The
kernels read the bias in fp32 (the wrappers cast it) and the learned bias
in its own dtype, fp32 or bf16, widened to fp32 as they load it.  The CUDA
kernels tile internally at 64 and bounds-check every tile, so they take
any sequence length; their only shape limits are the instantiated head
dims (``KERNEL_HEAD_DIMS``) and, for decode, Q <= ``MAX_DECODE_Q_ROWS``.
``auto_block``/``flash_supported`` keep the JAX package's tiling rule (and
its TPU-chosen block caps) so that ``ops/mha`` picks the same path as the
JAX package for CPU tensors; they do not gate the CUDA kernels.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from distributed_llms_example_tpu_torch.ops import cuda_build
from distributed_llms_example_tpu_torch.ops.fused_dropout import (
    _inv_keep,
    attention_keep_mask,
    keep_threshold,
)

MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)

# Tiling caps copied from the JAX package's ``_block_caps`` so both packages
# give the same ``flash_supported`` answer; the numbers were chosen on a TPU
# and say nothing about the CUDA kernels' own tiles.
MAX_BLOCK = 512
MAX_BLOCK_NONCAUSAL = 1024
MAX_BLOCK_CAUSAL_WIDE = 1024

# head dims the CUDA kernels are instantiated for (csrc/*.cu dispatch)
KERNEL_HEAD_DIMS = (16, 32, 64, 128)


def _block_caps(causal: bool, has_learned_bias: bool, head_dim: int = 64) -> tuple[int, int]:
    if has_learned_bias:
        return MAX_BLOCK, MAX_BLOCK_NONCAUSAL
    if causal:
        cap = MAX_BLOCK_CAUSAL_WIDE if head_dim >= 128 else MAX_BLOCK
        return cap, cap
    return MAX_BLOCK_NONCAUSAL, MAX_BLOCK_NONCAUSAL


def auto_block(seq_len: int, cap: int = MAX_BLOCK) -> int:
    """Largest 16-aligned block in [128, cap] dividing ``seq_len`` (0 = not
    tileable); sequences shorter than 128 use one seq-sized tile when
    16-aligned.  The JAX package's tiling rule, kept for CPU path parity."""
    if seq_len < 128:
        return seq_len if seq_len >= 16 and seq_len % 16 == 0 else 0
    start = min(cap, seq_len) // 16 * 16
    for b in range(start, 127, -16):
        if seq_len % b == 0:
            return b
    return 0


def flash_supported(q_len: int, kv_len: int, head_dim: int,
                    block_q: int | None = None, block_k: int | None = None,
                    *, causal: bool = False, has_learned_bias: bool = False) -> bool:
    """True when shapes are flash-eligible by the JAX package's (TPU)
    tiling rule; the CUDA kernel needs none of it."""
    cap_q, cap_k = _block_caps(causal, has_learned_bias, head_dim)
    bq = auto_block(q_len, cap_q) if block_q is None else min(block_q, q_len)
    bk = auto_block(kv_len, cap_k) if block_k is None else min(block_k, kv_len)
    return (
        bq > 0 and bk > 0
        and q_len % bq == 0 and kv_len % bk == 0
        and bq % 8 == 0 and bk % 8 == 0
        and head_dim % 8 == 0
    )


def _check_bias(bias: torch.Tensor | None, full: tuple[int, int, int, int]) -> None:
    if bias is None:
        return
    if bias.dim() != 4:
        raise ValueError(f"bias must be 4-d, got shape {tuple(bias.shape)}")
    for i, (bd, f) in enumerate(zip(bias.shape, full)):
        if bd not in (1, f):
            raise ValueError(f"bias dim {i} is {bd}, must be 1 or {f}")


# the kernels' probs-dropout threshold at rate 0: every entry kept, and the
# entry runs its instance without dropout
NO_DROP_THRESHOLD = 1 << 24


class ProbsDropout(NamedTuple):
    """Attention-probs dropout as kernels 1-4 take it: the int32 seed, the
    rate, its keep threshold and the fp32 scale 1 / (1 - rate)."""

    seed: int
    rate: float
    threshold: int
    inv_keep: float


def probs_dropout(rate: float, seed) -> ProbsDropout | None:
    """The probs dropout of ``rate`` and ``seed``, or None at rate 0.  A
    rate outside [0, 1), a rate above 0 without a seed, or a seed that is
    no int32 raises."""
    rate = float(rate)
    if rate == 0.0:
        return None
    if not 0.0 < rate < 1.0:
        raise ValueError(f"dropout_rate must be in [0, 1), got {rate}")
    if seed is None:
        raise ValueError("dropout_rate > 0 requires a dropout_seed (an int32)")
    seed = int(seed)
    if not -(2**31) <= seed < 2**31:
        raise ValueError(f"dropout_seed {seed} is not an int32")
    return ProbsDropout(seed, rate, keep_threshold(rate), _inv_keep(rate))


def _drop_args(drop: ProbsDropout | None) -> tuple[int, int, float]:
    """(seed, threshold, inv_keep) as a C entry takes them."""
    return (0, NO_DROP_THRESHOLD, 1.0) if drop is None else drop[:1] + drop[2:]


def _keep(drop: ProbsDropout | None, q, k):
    """(the (B, H, Sq, Sk) keep-mask, the fp32 scale) of the plain versions,
    or (None, None) without dropout."""
    if drop is None:
        return None, None
    B, H, Sq, _ = q.shape
    keep = attention_keep_mask(drop.seed, (B, H, Sq, k.shape[2]), drop.rate, device=q.device)
    return keep, torch.tensor(drop.inv_keep, dtype=torch.float32, device=q.device)


def _dropped(x, keep, inv):
    """x where kept, scaled by the fp32 1 / (1 - rate), else 0 (x itself
    without dropout)."""
    return x if keep is None else torch.where(keep, x * inv, torch.zeros((), device=x.device))


def _bias_args(bias: torch.Tensor | None) -> tuple:
    """(pointer, 4 element strides) for a kernel reading the bias in place:
    a size-1 dim gets stride 0, so it is never broadcast in memory."""
    if bias is None:
        return (None, 0, 0, 0, 0)
    strides = [0 if n == 1 else s for n, s in zip(bias.shape, bias.stride())]
    return (bias.data_ptr(), *strides)


# ----------------------------------------------------------- forward kernel


def _scores(q, k, bias, lbias, *, causal, scale):
    """fp32 s = scale·qkᵀ + bias + lbias, -inf above the causal diagonal:
    the terms in the TPU kernels' order."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if bias is not None:
        s = s + bias.float()
    if lbias is not None:
        s = s + lbias.float()
    if causal:
        q_pos = torch.arange(q.shape[2], device=q.device)[:, None]
        k_pos = torch.arange(k.shape[2], device=q.device)[None, :]
        s = torch.where(q_pos >= k_pos, s, torch.full((), -torch.inf, device=q.device))
    return s


def flash_attention_plain(q, k, v, bias=None, *, lbias=None, causal=False, scale=None,
                          dropout_rate=0.0, dropout_seed=None):
    """Plain PyTorch version of the forward kernel: (o, lse) with o in q's
    dtype and lse (B, H, Sq) fp32.  fp32 scores and softmax; p rounded to
    v's dtype before the value product (as the TPU kernel does); rows with
    no live key give o = 0 and lse = MASK_VALUE.  With probs dropout, p is
    dropped after its row sum l, the kept entries scaled by the fp32
    1 / (1 - rate) before the rounding."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    return _fwd_plain(q, k, v, bias, lbias, causal, scale, probs_dropout(dropout_rate, dropout_seed))


def _fwd_plain(q, k, v, bias, lbias, causal, scale, drop):
    keep, inv = _keep(drop, q, k)
    s = _scores(q, k, bias, lbias, causal=causal, scale=scale)
    m = s.amax(dim=-1, keepdim=True)
    safe_m = torch.where(m == -torch.inf, torch.zeros((), device=q.device), m)
    p = torch.exp(s - safe_m)
    l = p.sum(dim=-1, keepdim=True)
    pv = torch.matmul(_dropped(p, keep, inv).to(v.dtype).float(), v.float())
    l_safe = torch.where(l == 0.0, torch.ones((), device=q.device), l)
    o = (pv / l_safe).to(q.dtype)
    lse = torch.where(l == 0.0, torch.full((), MASK_VALUE, device=q.device),
                      m + torch.log(l_safe))
    return o, lse[..., 0]


# the probs dropout: seed, threshold, fp32 1 / (1 - rate)
_DROP_ARGTYPES = [ctypes.c_int, ctypes.c_uint, ctypes.c_float]
_FWD_HEAD = (
    [ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 4 + [ctypes.c_void_p] + [ctypes.c_longlong] * 4
    + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 5 + [ctypes.c_float] + [ctypes.c_int]
    + _DROP_ARGTYPES
)
_FWD_ARGTYPES = _FWD_HEAD + [ctypes.c_int] + [ctypes.c_void_p]
_FWD_TC_ARGTYPES = _FWD_HEAD + [ctypes.c_int] * 3 + [ctypes.c_void_p]

# kernel 1's key tile, as both CUDA sources define it, and the tensor-core
# kernel's ring of stages
FWD_BLOCK_K = 64
FWD_TC_STAGES = 2


def _fwd_tc_smem(rows: int, head_dim: int, lb_bytes: int) -> int:
    """Dynamic shared-memory bytes of ``csrc/flash_fwd_tc.cu``'s ``Smem``:
    Q, then per stage K, V, a learned-bias tile (rows padded by 8
    elements) and a key-bias tile, plus 1024 bytes to align the base for
    the swizzle."""
    bk = FWD_BLOCK_K
    stage = 2 * bk * head_dim * 2 + rows * (bk + 8) * lb_bytes + bk * 4
    return rows * head_dim * 2 + FWD_TC_STAGES * stage + 1024


def fwd_plan(dtype: torch.dtype, head_dim: int, batch: int, heads: int, q_len: int,
             lbias_dtype: torch.dtype | None = None) -> dict:
    """How kernel 1 is launched for these shapes: the C entry, query rows
    per CTA, keys per tile, shared-memory stages, dynamic shared-memory
    bytes, threads and grid.  bf16 goes to the tensor-core kernel
    (``csrc/flash_fwd_tc.cu``: 128 rows as two warpgroups, or 64 when
    q_len <= 64; a two-stage K/V ring); fp32 stays on the CUDA-core kernel
    (``csrc/flash_fwd.cu``), whose fp32 products the fp32 checks hold at
    1e-4, which TF32 tensor cores would not meet.  The tensor-core launch
    checks that the bytes are its ``Smem`` layout's."""
    if head_dim not in KERNEL_HEAD_DIMS:
        raise ValueError(f"flash_attention kernel has no instance for head_dim {head_dim} "
                         f"(built for {KERNEL_HEAD_DIMS})")
    bk, d = FWD_BLOCK_K, head_dim
    if dtype == torch.float32:
        rows = 64
        smem = (rows * d + bk * (d + 1) + bk * d + rows * (bk + 1) + 3 * rows) * 4
        return dict(entry="flash_fwd", rows=rows, block_k=bk, stages=1, smem_bytes=smem,
                    threads=256, grid=(-(-q_len // rows), batch * heads))
    if dtype != torch.bfloat16:
        raise ValueError(f"flash_attention kernel takes fp32 or bf16, not {dtype}")
    lb_bytes = 0 if lbias_dtype is None else torch.finfo(lbias_dtype).bits // 8
    rows = 64 if q_len <= 64 else 128
    return dict(entry="flash_fwd_tc", rows=rows, block_k=bk, stages=FWD_TC_STAGES,
                smem_bytes=_fwd_tc_smem(rows, d, lb_bytes), threads=2 * rows,
                grid=(-(-q_len // rows), batch * heads), lb_bytes=lb_bytes)


def _kernel_biases(what: str, dev, bias, lbias) -> tuple:
    """(fp32 bias, learned bias, its bf16 flag) for a kernel, after
    checking that each lies on the kernel's device.  The learned bias is
    passed in its own dtype (a per-stack tensor shared by every layer, so
    no per-call copy); the kernels widen it to fp32 as they load it."""
    for name, b in (("bias", bias), ("learned_bias", lbias)):
        if b is not None and b.device != dev:
            raise ValueError(f"{what}: {name} is on {b.device}, q on {dev}")
    if lbias is not None and lbias.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{what}: the kernels read an fp32 or bf16 learned bias, not "
                         f"{lbias.dtype}")
    lb_bf16 = lbias is not None and lbias.dtype == torch.bfloat16
    return None if bias is None else bias.float(), lbias, int(lb_bf16)


def _flash_fwd_cuda(q, k, v, bias, lbias, *, causal, scale, drop=None):
    dev = cuda_build.check_inputs("flash_attention", {"q": q, "k": k, "v": v})
    if q.dtype not in (torch.float32, torch.bfloat16) or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention kernel takes fp32 or bf16 q/k/v of one dtype, got "
                         f"{q.dtype}/{k.dtype}/{v.dtype}")
    B, H, Lq, D = q.shape
    Lk = k.shape[2]
    bias, lbias, lb_bf16 = _kernel_biases("flash_attention", dev, bias, lbias)
    plan = fwd_plan(q.dtype, D, B, H, Lq, None if lbias is None else lbias.dtype)
    o = torch.empty_like(q)
    lse = torch.empty((B, H, Lq), dtype=torch.float32, device=dev)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), *_bias_args(bias), *_bias_args(lbias),
            o.data_ptr(), lse.data_ptr(), B, H, Lq, Lk, D, float(scale), int(causal),
            *_drop_args(drop))
    stream = torch.cuda.current_stream(dev).cuda_stream
    if plan["entry"] == "flash_fwd_tc":
        fn = cuda_build.load("flash_fwd_tc", _FWD_TC_ARGTYPES)
        err = fn(*args, plan["lb_bytes"], plan["rows"], plan["smem_bytes"], stream)
        cuda_build.check(err, "flash_fwd_tc")
        flash_attention.tc_launches += 1
    else:
        fn = cuda_build.load("flash_fwd", _FWD_ARGTYPES)
        cuda_build.check(fn(*args, lb_bf16, stream), "flash_fwd")
    flash_attention.launches += 1
    flash_attention.drop_launches += drop is not None
    return o, lse


def _flash_fwd(q, k, v, bias, lbias, causal, scale, drop):
    if q.device.type == "cpu":
        return _fwd_plain(q, k, v, bias, lbias, causal, scale, drop)
    return _flash_fwd_cuda(q, k, v, bias, lbias, causal=causal, scale=scale, drop=drop)


class _FlashAttention(torch.autograd.Function):
    """Kernel 1 under autograd: the backward is kernels 2 and 3, and kernel
    4 when the learned bias needs a gradient.  The probs dropout is saved
    as its seed and rate; each backward kernel redraws the mask."""

    @staticmethod
    def forward(ctx, q, k, v, bias, lbias, causal, scale, drop):
        o, lse = _flash_fwd(q, k, v, bias, lbias, causal, scale, drop)
        ctx.save_for_backward(q, k, v, bias, lbias, o, lse)
        ctx.causal, ctx.scale, ctx.drop = causal, scale, drop
        ctx.mark_non_differentiable(lse)
        return o, lse

    @staticmethod
    def backward(ctx, do, _dlse):
        q, k, v, bias, lbias, o, lse = ctx.saved_tensors
        do = do.to(q.dtype).contiguous()
        delta = attention_delta(do, o)
        kw = dict(causal=ctx.causal, scale=ctx.scale, drop=ctx.drop)
        dq = _bwd_dq(q, k, v, bias, do, lse, delta, lbias=lbias, **kw)
        dk, dv = _bwd_dkv(q, k, v, bias, do, lse, delta, lbias=lbias, **kw)
        dlbias = None
        if ctx.needs_input_grad[4]:
            dlbias = _bwd_dlbias(q, k, v, bias, lbias, do, lse, delta, **kw)
        return dq, dk, dv, None, dlbias, None, None, None


def flash_attention(q, k, v, bias=None, *, learned_bias=None, causal: bool = False,
                    scale: float | None = None, dtype: torch.dtype | None = None,
                    return_lse: bool = False, dropout_rate: float = 0.0, dropout_seed=None):
    """Blockwise-softmax attention; drop-in for ``dot_product_attention``,
    differentiable in q, k, v and ``learned_bias``.

    ``causal`` applies the top-left mask and requires q_len == kv_len; the
    bias is a constant additive mask (every dim 1 or full; no gradient).
    ``learned_bias`` (T5's relative-position bias) must be exactly (1, H,
    q_len, kv_len): it is added after the mask and its gradient, the batch
    sum of p·(dp − δ), comes from kernel 4 in its own dtype.  Any sequence
    lengths.  ``dropout_rate`` > 0 applies attention-probs dropout inside
    the kernels, its mask drawn from ``dropout_seed`` (an int32; the JAX
    package's signature): o = dropout(softmax(s))·v, lse of the undropped
    softmax.  Returns o (in ``dtype``, default q's), or (o, lse) with
    ``return_lse``.  A CPU tensor runs the plain versions (forward and
    backward); a CUDA tensor launches the kernels."""
    drop = probs_dropout(dropout_rate, dropout_seed)
    if q.dim() != 4 or k.shape != v.shape or k.shape[:2] != q.shape[:2] or k.shape[3] != q.shape[3]:
        raise ValueError(f"q {tuple(q.shape)} / k {tuple(k.shape)} / v {tuple(v.shape)} "
                         "are not (B, H, S, d) of one batch, head count and head_dim")
    if causal and q.shape[2] != k.shape[2]:
        raise ValueError(f"causal=True requires square self-attention, got q_len={q.shape[2]} "
                         f"!= kv_len={k.shape[2]} (the mask is top-left aligned)")
    _check_bias(bias, (q.shape[0], q.shape[1], q.shape[2], k.shape[2]))
    if learned_bias is not None:
        want = (1, q.shape[1], q.shape[2], k.shape[2])
        if tuple(learned_bias.shape) != want:
            raise ValueError(f"learned_bias shape {tuple(learned_bias.shape)} must be exactly "
                             f"{want} (batch dim 1 is what the dlbias kernel reduces over)")
        learned_bias = learned_bias.contiguous()
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if bias is not None:
        bias = bias.float()
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (q, k, v, learned_bias)):
        o, lse = _FlashAttention.apply(q, k, v, bias, learned_bias, bool(causal), float(scale),
                                       drop)
    else:  # nothing to differentiate (serving): skip the autograd node's cost
        o, lse = _flash_fwd(q, k, v, bias, learned_bias, bool(causal), float(scale), drop)
    if dtype is not None:
        o = o.to(dtype)
    return (o, lse) if return_lse else o


flash_attention.launches = 0
# the bf16 launches among them, which went to the tensor-core entry
flash_attention.tc_launches = 0
# the launches with probs dropout among them
flash_attention.drop_launches = 0


# ---------------------------------------------------------- backward kernels


def attention_delta(do: torch.Tensor, o: torch.Tensor) -> torch.Tensor:
    """delta = rowsum(dO * O) in fp32, (B, H, Sq): the one backward term
    computed outside the kernels, as in the JAX package."""
    return (do.float() * o.float()).sum(dim=-1)


def _bwd_terms(q, k, v, bias, do, lse, delta, *, lbias=None, causal, scale, drop=None):
    """(p, p·(dp − δ)) of the backward in fp32, rows with the lse sentinel
    zeroed: the learned bias's gradient terms, and ds before its scale.
    With probs dropout, the dropped p (what dv sums) and p·(m·dp/(1 −
    rate) − δ), the mask m redrawn from the seed."""
    keep, inv = _keep(drop, q, k)
    s = _scores(q, k, bias, lbias, causal=causal, scale=scale)
    lse = lse[..., None]
    p = torch.where(lse <= MASK_VALUE / 2, torch.zeros((), device=q.device), torch.exp(s - lse))
    dp = _dropped(torch.matmul(do.float(), v.float().transpose(-1, -2)), keep, inv)
    return _dropped(p, keep, inv), p * (dp - delta[..., None])


def _bwd_plain(q, k, v, bias, do, lse, delta, *, lbias=None, causal, scale, drop=None):
    """(p, ds) of the backward in fp32, rows with the lse sentinel zeroed
    (p dropped, with probs dropout)."""
    p, dsu = _bwd_terms(q, k, v, bias, do, lse, delta, lbias=lbias, causal=causal, scale=scale,
                        drop=drop)
    return p, dsu * scale


def _dq_plain(q, k, ds):
    return torch.matmul(ds.to(k.dtype).float(), k.float()).to(q.dtype)


def _dkv_plain(q, k, v, do, p, ds):
    dk = torch.matmul(ds.to(q.dtype).float().transpose(-1, -2), q.float()).to(k.dtype)
    dv = torch.matmul(p.to(do.dtype).float().transpose(-1, -2), do.float()).to(v.dtype)
    return dk, dv


def flash_attention_bwd_plain(q, k, v, bias, o, lse, do, *, lbias=None, causal=False, scale=None,
                              dropout_rate=0.0, dropout_seed=None):
    """Plain PyTorch version of the backward kernels: (dq, dk, dv) from the
    forward's inputs, its output and lse, and the output gradient.  fp32
    arithmetic; ds rounded to k's dtype before the dq product and to q's
    before the dk product, p to dO's dtype before the dv product, as the
    TPU kernels round.  With probs dropout (the forward's rate and seed),
    dp is masked and rescaled and dv sums the dropped p."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    p, ds = _bwd_plain(q, k, v, bias, do, lse, attention_delta(do, o), lbias=lbias,
                       causal=causal, scale=scale, drop=probs_dropout(dropout_rate, dropout_seed))
    return (_dq_plain(q, k, ds), *_dkv_plain(q, k, v, do, p, ds))


# kernels 2 and 3 in bf16 (csrc/flash_bwd_tc.cu): 128 query rows (dq) or
# keys (dk/dv) a CTA as two warpgroups, a two-stage ring of 64-key tiles
# (dq) or of query tiles (dk/dv: 64, or 32 at head dim 128, which keeps dK,
# dV, Sᵀ and dPᵀ in registers); fp32 (csrc/flash_bwd.cu): 64 x 64 tiles
BWD_TC_ROWS = 128
BWD_BLOCK = 64
BWD_TC_STAGES = 2

def bwd_plan(dtype: torch.dtype, head_dim: int, batch: int, heads: int, q_len: int,
             kv_len: int, lbias_dtype: torch.dtype | None = None) -> dict:
    """How kernels 2 and 3 are launched for these shapes: ``{"dq": ...,
    "dkv": ...}``, each with the library and C entry, ``rows`` (query rows
    of a dq CTA, keys of a dk/dv CTA), ``block`` (the tile streamed past
    them: keys for dq, queries for dk/dv), ring ``stages``, dynamic
    shared-memory bytes, threads and grid.  bf16 goes to the tensor-core
    kernels (``csrc/flash_bwd_tc.cu``), which check that the bytes are
    their ``DqSmem``/``DkvSmem`` layouts'; fp32 stays on the CUDA-core
    kernels (``csrc/flash_bwd.cu``), whose fp32 products the fp32 gradient
    checks hold exactly or at 5e-6, which TF32 tensor cores would not
    meet."""
    if head_dim not in KERNEL_HEAD_DIMS:
        raise ValueError(f"flash_attention backward kernels have no instance for head_dim "
                         f"{head_dim} (built for {KERNEL_HEAD_DIMS})")
    d, bh = head_dim, batch * heads
    if dtype == torch.float32:
        r = BWD_BLOCK  # csrc/flash_bwd.cu dq_smem_floats / dkv_smem_floats
        dq_smem = (2 * r * d + 2 * r * (d + 1) + r * (r + 1) + 2 * r) * 4
        dkv_smem = (2 * r * (d + 1) + 2 * r * d + 2 * r * (r + 1) + 2 * r) * 4
        common = dict(lib="flash_bwd", rows=r, block=r, stages=1, threads=256)
        return {"dq": dict(common, entry="flash_bwd_dq", smem_bytes=dq_smem,
                           grid=(-(-q_len // r), bh)),
                "dkv": dict(common, entry="flash_bwd_dkv", smem_bytes=dkv_smem,
                            grid=(-(-kv_len // r), bh))}
    if dtype != torch.bfloat16:
        raise ValueError(f"flash_attention backward kernels take fp32 or bf16, not {dtype}")
    lb = 0 if lbias_dtype is None else torch.finfo(lbias_dtype).bits // 8
    rows, bk, bq, st = BWD_TC_ROWS, BWD_BLOCK, 32 if d == 128 else 64, BWD_TC_STAGES
    # Q and dO, then per stage K, V, the learned-bias tile (rows padded by 8
    # elements) and the key-bias tile; 1024 bytes align the swizzle base
    dq_smem = 2 * rows * d * 2 + st * (2 * bk * d * 2 + rows * (bk + 8) * lb + bk * 4) + 1024
    # K and V, then per stage Q, dO, the learned-bias tile (bq rows of 128
    # keys padded by 16 bytes), lse and delta
    lb_stage = bq * (rows * lb + 16) if lb else 0
    dkv_smem = 2 * rows * d * 2 + st * (2 * bq * d * 2 + lb_stage + 2 * bq * 4) + 1024
    common = dict(lib="flash_bwd_tc", rows=rows, stages=st, threads=2 * rows, lb_bytes=lb)
    return {"dq": dict(common, entry="flash_bwd_dq_tc", block=bk, smem_bytes=dq_smem,
                       grid=(-(-q_len // rows), bh)),
            "dkv": dict(common, entry="flash_bwd_dkv_tc", block=bq, smem_bytes=dkv_smem,
                        grid=(-(-kv_len // rows), bh))}


# kernel 4 in bf16 (csrc/flash_bwd_dlbias_tc.cu): one CTA per (head, 128
# queries, 64 keys) as two warpgroups, a ring of batch rows fed by TMA,
# three deep (two at head dim 128); fp32 (csrc/flash_bwd_dlbias.cu): 64 x
# 64 tiles
DLBIAS_TC_ROWS = 128
DLBIAS_BLOCK_K = 64


def dlbias_plan(dtype: torch.dtype, head_dim: int, batch: int, heads: int, q_len: int,
                kv_len: int, lbias_dtype: torch.dtype) -> dict:
    """How kernel 4 is launched for these shapes: the library, the C entry
    and the learned bias's bytes per element.  bf16 goes to the
    tensor-core kernel (``csrc/flash_bwd_dlbias_tc.cu``), whose plan adds
    ``rows`` (query rows of a CTA), ``block_k`` (its keys), ring
    ``stages`` over the batch rows, threads, grid (key tiles, query tiles,
    heads: a head's CTAs run together) and the dynamic shared-memory
    bytes the entry is passed and checks against its ``Smem`` layout;
    fp32 stays on the CUDA-core kernel (``csrc/flash_bwd_dlbias.cu``),
    whose fp32 products the fp32 T5 gradient check holds at ~1e-10, which
    TF32 tensor cores would not meet."""
    if head_dim not in KERNEL_HEAD_DIMS:
        raise ValueError(f"flash_bwd_dlbias kernel has no instance for head_dim {head_dim} "
                         f"(built for {KERNEL_HEAD_DIMS})")
    if lbias_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"flash_bwd_dlbias kernel takes an fp32 or bf16 learned bias, not "
                         f"{lbias_dtype}")
    d, bk = head_dim, DLBIAS_BLOCK_K
    lb = torch.finfo(lbias_dtype).bits // 8
    if dtype == torch.float32:
        # the CUDA-core entry sizes its own tiles and grid
        return dict(lib="flash_bwd_dlbias", entry="flash_bwd_dlbias", lb_bytes=lb)
    if dtype != torch.bfloat16:
        raise ValueError(f"flash_bwd_dlbias kernel takes fp32 or bf16, not {dtype}")
    rows, st = DLBIAS_TC_ROWS, 2 if d == 128 else 3
    # per stage Q, dO, K, V, lse, delta, the key-bias tile and an 8-byte
    # mbarrier; after the loop the same bytes stage the output tile (rows
    # padded by 16 bytes); 1024 bytes align the swizzle base
    ring = st * (2 * rows * d * 2 + 2 * bk * d * 2 + 2 * rows * 4 + bk * 4 + 8)
    staged = rows * (bk * lb + 16)
    return dict(lib="flash_bwd_dlbias_tc", entry="flash_bwd_dlbias_tc", rows=rows, block_k=bk,
                stages=st, smem_bytes=max(ring, staged) + 1024, threads=2 * rows,
                grid=(-(-kv_len // bk), -(-q_len // rows), heads), lb_bytes=lb)


_BWD_ARGTYPES = (
    [ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 4 + [ctypes.c_void_p]
    + [ctypes.c_longlong] * 4 + [ctypes.c_void_p] * 3
)
# (B, H, Lq, Lk, D, scale, causal), the probs dropout, then each library's
# own ints and the stream
_BWD_SHAPE = [ctypes.c_int] * 5 + [ctypes.c_float] + [ctypes.c_int] + _DROP_ARGTYPES


def _bwd_cuda(entry, q, k, v, bias, do, lse, delta, outs, *, causal, scale, lbias=None,
              drop=None) -> str:
    """Launch a backward kernel after the shared input checks: kernel 2 or
    3 (``entry`` flash_bwd_dq / flash_bwd_dkv) through ``bwd_plan``, or
    kernel 4 (flash_bwd_dlbias) through ``dlbias_plan``.  Returns the
    library it launched."""
    dev = cuda_build.check_inputs(entry, {"q": q, "k": k, "v": v, "do": do, "lse": lse,
                                          "delta": delta})
    if q.dtype not in (torch.float32, torch.bfloat16) or any(
            t.dtype != q.dtype for t in (k, v, do)):
        raise ValueError(f"{entry} kernel takes fp32 or bf16 q/k/v/do of one dtype, got "
                         f"{q.dtype}/{k.dtype}/{v.dtype}/{do.dtype}")
    if lse.dtype != torch.float32 or delta.dtype != torch.float32:
        raise ValueError(f"{entry}: lse and delta must be fp32")
    B, H, Lq, D = q.shape
    if D not in KERNEL_HEAD_DIMS:
        raise ValueError(f"{entry} kernel has no instance for head_dim {D} "
                         f"(built for {KERNEL_HEAD_DIMS})")
    bias, lbias, lb_bf16 = _kernel_biases(entry, dev, bias, lbias)
    if entry == "flash_bwd_dlbias":
        plan = dlbias_plan(q.dtype, D, B, H, Lq, k.shape[2], lbias.dtype)
    else:
        plan = bwd_plan(q.dtype, D, B, H, Lq, k.shape[2],
                        None if lbias is None else lbias.dtype)[entry.removeprefix("flash_bwd_")]
    lib, entry = plan["lib"], plan["entry"]
    tail = (plan["lb_bytes"], plan["smem_bytes"]) if lib.endswith("_tc") else (lb_bf16,)
    argtypes = (_BWD_ARGTYPES + [ctypes.c_void_p] * len(outs) + _BWD_SHAPE
                + [ctypes.c_int] * len(tail) + [ctypes.c_void_p])
    fn = cuda_build.load(lib, argtypes, entry)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), *_bias_args(bias), *_bias_args(lbias),
             do.data_ptr(), lse.data_ptr(), delta.data_ptr(), *(t.data_ptr() for t in outs), B, H,
             Lq, k.shape[2], D, float(scale), int(causal), *_drop_args(drop), *tail,
             torch.cuda.current_stream(dev).cuda_stream)
    cuda_build.check(err, entry)
    return lib


def flash_bwd_dq(q, k, v, bias, do, lse, delta, *, lbias=None, causal: bool, scale: float,
                 dropout_rate: float = 0.0, dropout_seed=None):
    """dq of flash attention (kernel 2) from the saved forward inputs, lse,
    delta and dO, and the forward's probs-dropout rate and seed.  A CPU
    tensor runs the plain version; a CUDA tensor launches the kernel: bf16
    the tensor-core one, fp32 the CUDA-core one (``bwd_plan``)."""
    return _bwd_dq(q, k, v, bias, do, lse, delta, lbias=lbias, causal=causal, scale=scale,
                   drop=probs_dropout(dropout_rate, dropout_seed))


def _bwd_dq(q, k, v, bias, do, lse, delta, *, lbias, causal, scale, drop):
    """``flash_bwd_dq`` past its argument checks (the autograd backward's
    entry): the probs dropout as a validated ``ProbsDropout`` or None."""
    if q.device.type == "cpu":
        _, ds = _bwd_plain(q, k, v, bias, do, lse, delta, lbias=lbias, causal=causal,
                           scale=scale, drop=drop)
        return _dq_plain(q, k, ds)
    dq = torch.empty_like(q)
    if _bwd_cuda("flash_bwd_dq", q, k, v, bias, do, lse, delta, (dq,), causal=causal,
                 scale=scale, lbias=lbias, drop=drop) == "flash_bwd_tc":
        flash_bwd_dq.tc_launches += 1
    flash_bwd_dq.launches += 1
    flash_bwd_dq.drop_launches += drop is not None
    return dq


flash_bwd_dq.launches = 0
# the bf16 launches among them, which went to the tensor-core entry, and
# the launches with probs dropout
flash_bwd_dq.tc_launches = 0
flash_bwd_dq.drop_launches = 0


def flash_bwd_dkv(q, k, v, bias, do, lse, delta, *, lbias=None, causal: bool, scale: float,
                  dropout_rate: float = 0.0, dropout_seed=None):
    """(dk, dv) of flash attention (kernel 3); as ``flash_bwd_dq``."""
    return _bwd_dkv(q, k, v, bias, do, lse, delta, lbias=lbias, causal=causal, scale=scale,
                    drop=probs_dropout(dropout_rate, dropout_seed))


def _bwd_dkv(q, k, v, bias, do, lse, delta, *, lbias, causal, scale, drop):
    """``flash_bwd_dkv`` past its argument checks; as ``_bwd_dq``."""
    if q.device.type == "cpu":
        p, ds = _bwd_plain(q, k, v, bias, do, lse, delta, lbias=lbias, causal=causal,
                           scale=scale, drop=drop)
        return _dkv_plain(q, k, v, do, p, ds)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if _bwd_cuda("flash_bwd_dkv", q, k, v, bias, do, lse, delta, (dk, dv), causal=causal,
                 scale=scale, lbias=lbias, drop=drop) == "flash_bwd_tc":
        flash_bwd_dkv.tc_launches += 1
    flash_bwd_dkv.launches += 1
    flash_bwd_dkv.drop_launches += drop is not None
    return dk, dv


flash_bwd_dkv.launches = 0
flash_bwd_dkv.tc_launches = 0
flash_bwd_dkv.drop_launches = 0


def _dlbias_plain(q, k, v, bias, lbias, do, lse, delta, *, causal, scale, dropout_rate=0.0,
                  dropout_seed=None):
    """Plain PyTorch version of kernel 4: dlbias = Σ_batch p·(dp − δ) in
    fp32 (no scale factor: the scale multiplies only q·k), (1, H, Sq, Sk)
    in the learned bias's dtype, dp masked and rescaled with probs
    dropout.  Fully-masked rows and the causal upper triangle are exactly
    0, since p is 0 there."""
    return _dlbias_sum(q, k, v, bias, lbias, do, lse, delta, causal=causal, scale=scale,
                       drop=probs_dropout(dropout_rate, dropout_seed))


def _dlbias_sum(q, k, v, bias, lbias, do, lse, delta, *, causal, scale, drop):
    _, dsu = _bwd_terms(q, k, v, bias, do, lse, delta, lbias=lbias, causal=causal, scale=scale,
                        drop=drop)
    return dsu.sum(dim=0, keepdim=True).to(lbias.dtype)


def flash_bwd_dlbias(q, k, v, bias, lbias, do, lse, delta, *, causal: bool, scale: float,
                     dropout_rate: float = 0.0, dropout_seed=None):
    """Gradient of the learned (1, H, Sq, Sk) bias (kernel 4) from the saved
    forward inputs, lse, delta and dO, and the forward's probs-dropout rate
    and seed, in the learned bias's dtype.  A CPU tensor runs the plain
    version; a CUDA tensor launches the kernel (``dlbias_plan``: bf16 the
    tensor-core one, fp32 the CUDA-core one), which sums the batch inside
    each tile (no atomics) and writes every tile, zeros included."""
    if tuple(lbias.shape) != (1, q.shape[1], q.shape[2], k.shape[2]):
        raise ValueError(f"learned bias shape {tuple(lbias.shape)} is not "
                         f"{(1, q.shape[1], q.shape[2], k.shape[2])}")
    return _bwd_dlbias(q, k, v, bias, lbias, do, lse, delta, causal=causal, scale=scale,
                       drop=probs_dropout(dropout_rate, dropout_seed))


def _bwd_dlbias(q, k, v, bias, lbias, do, lse, delta, *, causal, scale, drop):
    """``flash_bwd_dlbias`` past its argument checks; as ``_bwd_dq``."""
    if q.device.type == "cpu":
        return _dlbias_sum(q, k, v, bias, lbias, do, lse, delta, causal=causal, scale=scale,
                           drop=drop)
    out = torch.empty(lbias.shape, dtype=lbias.dtype, device=q.device)
    if _bwd_cuda("flash_bwd_dlbias", q, k, v, bias, do, lse, delta, (out,), causal=causal,
                 scale=scale, lbias=lbias, drop=drop) == "flash_bwd_dlbias_tc":
        flash_bwd_dlbias.tc_launches += 1
    flash_bwd_dlbias.launches += 1
    flash_bwd_dlbias.drop_launches += drop is not None
    return out


flash_bwd_dlbias.launches = 0
# the bf16 launches among them, which went to the tensor-core entry, and
# the launches with probs dropout
flash_bwd_dlbias.tc_launches = 0
flash_bwd_dlbias.drop_launches = 0


# ----------------------------------------------------------- int8 KV cache


def quantize_kv(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-position int8 quantization of a (..., len, head_dim)
    K/V tensor: one fp32 scale per (..., position), round-half-to-even.
    Returns ``(q int8 like x, scale fp32 with head_dim dropped)``."""
    x32 = x.float()
    amax = x32.abs().amax(dim=-1)
    scale = torch.where(amax > 0.0, amax / 127.0, torch.ones_like(amax))
    q = torch.round(x32 / scale[..., None])
    return q.clamp(-127, 127).to(torch.int8), scale


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Inverse of ``quantize_kv`` — the one expression both the decode
    kernel (per tile) and the plain version evaluate."""
    return q.float() * scale[..., None]


# ----------------------------------------------------------- decode kernel

# The decode kernel's q-block ceiling (one decode row; a speculative
# verify block of spec_tokens + 1 rows; a warm prompt tail this short).
MAX_DECODE_Q_ROWS = 8


def flash_decode_supported(q_len: int, kv_len: int, head_dim: int,
                           block_k: int | None = None) -> bool:
    """True when a cached decode step is kernel-eligible by the JAX
    package's (TPU) rule; the CUDA kernel needs only Q <= 8."""
    bk = auto_block(kv_len) if block_k is None else min(block_k, kv_len)
    return (
        0 < q_len <= MAX_DECODE_Q_ROWS
        and bk > 0 and kv_len % bk == 0 and bk % 8 == 0
        and head_dim % 8 == 0
    )


def flash_decode_plain(q, k, v, bias=None, *, offsets, k_scale=None, v_scale=None, scale=None):
    """Plain PyTorch version of the decode kernel: row r of batch b attends
    cache slots <= offsets[b] + r; a row with sum 0 divides by 1."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if k_scale is not None:
        k = dequantize_kv(k, k_scale)
        v = dequantize_kv(v, v_scale)
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if bias is not None:
        s = s + bias.float()
    L, Q = k.shape[2], q.shape[2]
    k_pos = torch.arange(L, device=q.device)[None, None, None, :]
    q_pos = offsets.to(q.device, torch.int64)[:, None, None, None] + \
        torch.arange(Q, device=q.device)[None, None, :, None]
    s = torch.where(k_pos <= q_pos, s, torch.full((), -torch.inf, device=q.device))
    m = s.amax(dim=-1, keepdim=True)
    safe_m = torch.where(m == -torch.inf, torch.zeros((), device=q.device), m)
    p = torch.exp(s - safe_m)
    l = p.sum(dim=-1, keepdim=True)
    pv = torch.matmul(p.to(v.dtype).float(), v.float())
    l_safe = torch.where(l == 0.0, torch.ones((), device=q.device), l)
    return (pv / l_safe).to(q.dtype)


_DECODE_ARGTYPES = (
    [ctypes.c_void_p] * 6 + [ctypes.c_longlong] * 4 + [ctypes.c_void_p] * 2
    + [ctypes.c_int] * 5 + [ctypes.c_float] + [ctypes.c_int] * 2 + [ctypes.c_void_p]
)


def _flash_decode_cuda(q, k, v, bias, *, offsets, k_scale, v_scale, scale):
    tensors = {"q": q, "k": k, "v": v, "offsets": offsets}
    if k_scale is not None:
        tensors.update(k_scale=k_scale, v_scale=v_scale)
    dev = cuda_build.check_inputs("flash_decode", tensors)
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"flash_decode kernel takes fp32 or bf16 q, got {q.dtype}")
    int8 = k_scale is not None
    want_kv = torch.int8 if int8 else q.dtype
    if k.dtype != want_kv or v.dtype != want_kv:
        raise ValueError(f"flash_decode kernel: k/v must be {want_kv}, got {k.dtype}/{v.dtype}")
    if int8 and (k_scale.dtype != torch.float32 or v_scale.dtype != torch.float32):
        raise ValueError("flash_decode kernel: k_scale/v_scale must be fp32")
    if offsets.dtype != torch.int32:
        raise ValueError(f"flash_decode kernel: offsets must be int32, got {offsets.dtype}")
    B, H, Q, D = q.shape
    L = k.shape[2]
    if D not in KERNEL_HEAD_DIMS:
        raise ValueError(f"flash_decode kernel has no instance for head_dim {D} "
                         f"(built for {KERNEL_HEAD_DIMS})")
    if k.data_ptr() % 16 or v.data_ptr() % 16:
        raise ValueError("flash_decode kernel: k/v must be 16-byte aligned (it loads rows "
                         "16 bytes at a time)")
    if bias is not None:
        if bias.device != dev:
            raise ValueError(f"flash_decode: bias is on {bias.device}, q on {dev}")
        bias = bias.float()
    o = torch.empty_like(q)
    fn = cuda_build.load("flash_decode", _DECODE_ARGTYPES)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
             k_scale.data_ptr() if int8 else None, v_scale.data_ptr() if int8 else None,
             *_bias_args(bias), offsets.data_ptr(), o.data_ptr(), B, H, Q, L, D, float(scale),
             int(q.dtype == torch.bfloat16), int(int8),
             torch.cuda.current_stream(dev).cuda_stream)
    cuda_build.check(err, "flash_decode")
    flash_decode.launches += 1
    return o


def flash_decode(q, k, v, bias=None, *, offsets, k_scale=None, v_scale=None,
                 scale: float | None = None, dtype: torch.dtype | None = None):
    """Decode-step attention: a short q block (B, H, Q <= 8, d) against a
    cached (B, H, L, d) K/V buffer; row r of batch b attends cache slots
    <= ``offsets[b] + r``, so not-yet-written slots never contribute.
    ``k_scale``/``v_scale`` ((B, H, L) fp32, both or neither) mark an int8
    cache.  Any cache length L.  A CPU tensor runs the plain version; a
    CUDA tensor launches the kernel."""
    B, H, Q, D = q.shape
    L = k.shape[2]
    if k.shape != v.shape or k.shape[:2] != (B, H) or k.shape[3] != D:
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not match q {tuple(q.shape)}")
    if not 0 < Q <= MAX_DECODE_Q_ROWS:
        raise ValueError(f"decode q block of {Q} rows: the kernel takes 1..{MAX_DECODE_Q_ROWS}")
    _check_bias(bias, (B, H, Q, L))
    if (k_scale is None) != (v_scale is None):
        raise ValueError("k_scale and v_scale must be passed together")
    if k_scale is not None:
        for name, s in (("k_scale", k_scale), ("v_scale", v_scale)):
            if tuple(s.shape) != (B, H, L):
                raise ValueError(f"{name} shape {tuple(s.shape)} != {(B, H, L)}")
    if tuple(offsets.shape) != (B,):
        raise ValueError(f"offsets shape {tuple(offsets.shape)} != {(B,)}")
    if scale is None:
        scale = D ** -0.5
    if q.device.type == "cpu":
        out = flash_decode_plain(q, k, v, bias, offsets=offsets, k_scale=k_scale,
                                 v_scale=v_scale, scale=scale)
    else:
        out = _flash_decode_cuda(q, k, v, bias, offsets=offsets, k_scale=k_scale,
                                 v_scale=v_scale, scale=scale)
    return out if dtype is None else out.to(dtype)


flash_decode.launches = 0


# ----------------------------------------------------- paged decode kernel


def gather_blocks(pool: torch.Tensor, block_tables: torch.Tensor) -> torch.Tensor:
    """Slot view of a block pool: (N, H, bs[, d]) through (B, n_tiles)
    block tables → (B, H, n_tiles·bs[, d]), zeros for sentinel entries
    (>= N).  The plain path's gather (the JAX package's ``gather_cache``);
    the paged kernel never builds it."""
    N = pool.shape[0]
    bt = block_tables.long()
    g = pool[bt.clamp(0, N - 1)]  # (B, n_tiles, H, bs[, d])
    keep = (bt < N).view(*bt.shape, *([1] * (pool.dim() - 1)))
    g = torch.where(keep, g, torch.zeros((), dtype=pool.dtype, device=pool.device))
    g = g.transpose(1, 2)  # (B, H, n_tiles, bs[, d])
    return g.reshape(g.shape[0], g.shape[1], -1, *pool.shape[3:])


def flash_decode_paged_plain(q, k_pool, v_pool, bias=None, *, block_tables, offsets,
                             k_scale_pool=None, v_scale_pool=None, scale=None):
    """Plain PyTorch version of the paged decode kernel: gather the slot
    view (zeros for sentinel tiles), repeat each pool head over its group
    of q heads (``repeat_interleave``, as ``jnp.repeat`` in the JAX
    package's attention), then ``flash_decode_plain``.  Sentinel tiles
    must lie where the mask hides them (the prompt gap under the padding
    bias, or past the offset): there the kernel's skip and this zero fill
    give the same result."""
    rep = q.shape[1] // k_pool.shape[1]

    def view(pool):
        if pool is None:
            return None
        g = gather_blocks(pool, block_tables)
        return g.repeat_interleave(rep, dim=1) if rep > 1 else g

    return flash_decode_plain(q, view(k_pool), view(v_pool), bias, offsets=offsets,
                              k_scale=view(k_scale_pool), v_scale=view(v_scale_pool),
                              scale=scale)


_PAGED_ARGTYPES = (
    [ctypes.c_void_p] * 6 + [ctypes.c_longlong] * 4 + [ctypes.c_void_p] * 3
    + [ctypes.c_int] * 8 + [ctypes.c_float] + [ctypes.c_int] * 2 + [ctypes.c_void_p]
)


def _flash_decode_paged_cuda(q, k_pool, v_pool, bias, *, block_tables, offsets, k_scale_pool,
                             v_scale_pool, scale):
    tensors = {"q": q, "k_pool": k_pool, "v_pool": v_pool, "block_tables": block_tables,
               "offsets": offsets}
    int8 = k_scale_pool is not None
    if int8:
        tensors.update(k_scale_pool=k_scale_pool, v_scale_pool=v_scale_pool)
    dev = cuda_build.check_inputs("flash_decode_paged", tensors)
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"flash_decode_paged kernel takes fp32 or bf16 q, got {q.dtype}")
    want_kv = torch.int8 if int8 else q.dtype
    if k_pool.dtype != want_kv or v_pool.dtype != want_kv:
        raise ValueError(f"flash_decode_paged kernel: pools must be {want_kv}, got "
                         f"{k_pool.dtype}/{v_pool.dtype}")
    if int8 and (k_scale_pool.dtype != torch.float32 or v_scale_pool.dtype != torch.float32):
        raise ValueError("flash_decode_paged kernel: scale pools must be fp32")
    if block_tables.dtype != torch.int32 or offsets.dtype != torch.int32:
        raise ValueError("flash_decode_paged kernel: block_tables and offsets must be int32")
    B, H, Q, D = q.shape
    N, H_kv, bs, _ = k_pool.shape
    if D not in KERNEL_HEAD_DIMS:
        raise ValueError(f"flash_decode_paged kernel has no instance for head_dim {D} "
                         f"(built for {KERNEL_HEAD_DIMS})")
    if k_pool.data_ptr() % 16 or v_pool.data_ptr() % 16:
        raise ValueError("flash_decode_paged kernel: pools must be 16-byte aligned (it loads "
                         "K/V rows 16 bytes at a time)")
    if bias is not None:
        if bias.device != dev:
            raise ValueError(f"flash_decode_paged: bias is on {bias.device}, q on {dev}")
        bias = bias.float()
    o = torch.empty_like(q)
    fn = cuda_build.load("flash_decode_paged", _PAGED_ARGTYPES)
    err = fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
             k_scale_pool.data_ptr() if int8 else None,
             v_scale_pool.data_ptr() if int8 else None, *_bias_args(bias),
             block_tables.data_ptr(), offsets.data_ptr(), o.data_ptr(), B, H, H_kv, Q,
             block_tables.shape[1], bs, N, D, float(scale), int(q.dtype == torch.bfloat16),
             int(int8), torch.cuda.current_stream(dev).cuda_stream)
    cuda_build.check(err, "flash_decode_paged")
    flash_decode_paged.launches += 1
    return o


def flash_decode_paged(q, k_pool, v_pool, bias=None, *, block_tables, offsets,
                       k_scale_pool=None, v_scale_pool=None, scale: float | None = None,
                       dtype: torch.dtype | None = None):
    """Decode-step attention straight off a shared block pool: q (B, H,
    Q <= 8, d); ``k_pool``/``v_pool`` (num_blocks, H_kv, block_size, d)
    with H_kv dividing H (q head h reads pool head h // (H / H_kv));
    ``block_tables`` (B, n_tiles) int32 maps each row's logical tile to its
    pool block, an entry >= num_blocks being an unallocated tile that
    contributes nothing; ``offsets`` (B,) as in ``flash_decode``.  The
    logical cache length is n_tiles·block_size, and ``bias`` (every dim 1
    or full) is indexed in logical order.  ``k_scale_pool``/
    ``v_scale_pool`` ((num_blocks, H_kv, block_size) fp32) mark an int8
    pool.  A CPU tensor runs the plain version; a CUDA tensor launches the
    kernel."""
    if q.dim() != 4 or k_pool.dim() != 4 or k_pool.shape != v_pool.shape:
        raise ValueError(f"q {tuple(q.shape)} / k_pool {tuple(k_pool.shape)} / v_pool "
                         f"{tuple(v_pool.shape)}: expected (B, H, Q, d) and two equal "
                         "(num_blocks, H_kv, block_size, d) pools")
    B, H, Q, D = q.shape
    N, H_kv, bs, pool_d = k_pool.shape
    if pool_d != D or H % H_kv:
        raise ValueError(f"pool shape {tuple(k_pool.shape)} does not match q heads/dim "
                         f"({H}, {D}): pool heads must divide q heads")
    if bs % 8:
        raise ValueError(f"block_size {bs} must be 8-aligned")
    if not 0 < Q <= MAX_DECODE_Q_ROWS:
        raise ValueError(f"decode q block of {Q} rows: the kernel takes 1..{MAX_DECODE_Q_ROWS}")
    if block_tables.dim() != 2 or block_tables.shape[0] != B:
        raise ValueError(f"block_tables shape {tuple(block_tables.shape)} != ({B}, n_tiles)")
    _check_bias(bias, (B, H, Q, block_tables.shape[1] * bs))
    if (k_scale_pool is None) != (v_scale_pool is None):
        raise ValueError("k_scale_pool and v_scale_pool must be passed together")
    if k_scale_pool is not None:
        for name, s in (("k_scale_pool", k_scale_pool), ("v_scale_pool", v_scale_pool)):
            if tuple(s.shape) != (N, H_kv, bs):
                raise ValueError(f"{name} shape {tuple(s.shape)} != {(N, H_kv, bs)}")
    if tuple(offsets.shape) != (B,):
        raise ValueError(f"offsets shape {tuple(offsets.shape)} != {(B,)}")
    if scale is None:
        scale = D ** -0.5
    kw = dict(block_tables=block_tables, offsets=offsets, k_scale_pool=k_scale_pool,
              v_scale_pool=v_scale_pool, scale=scale)
    if q.device.type == "cpu":
        out = flash_decode_paged_plain(q, k_pool, v_pool, bias, **kw)
    else:
        out = _flash_decode_paged_cuda(q, k_pool, v_pool, bias, **kw)
    return out if dtype is None else out.to(dtype)


flash_decode_paged.launches = 0
