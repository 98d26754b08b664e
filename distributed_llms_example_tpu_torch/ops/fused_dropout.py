"""Fused residual dropout: CUDA kernel + plain version (port of the JAX
package's ``ops/fused_dropout.py``).

``out = residual + where(keep, x * 1/(1-rate), 0)`` in one pass, with the
keep-mask drawn from a counter hash of (seed, absolute row, absolute col)
of the activation's 2-D view (rows = prod(shape[:-1]), cols = shape[-1]).
This is the JAX package's ``hw_rng=False`` stream, bit for bit: the
murmur3 finalizer ``_mix32`` over uint32 arithmetic, a 24-bit threshold
compare.  The TPU hardware stream (``hw_rng=True``) has no counterpart.

The backward recomputes the mask from the seed (the autograd Function
saves one Python int), so no mask tensor is ever stored: dx is the same
kernel run on the incoming gradient without a residual, and the residual's
gradient is the incoming gradient itself.

Parts, as for every kernel of the port:

- ``dropout_plain``: the plain PyTorch version, run for CPU tensors and
  held against the kernel on the card;
- ``csrc/fused_dropout.cu``: the kernel, launched for CUDA tensors (or
  the wrapper raises; there is no fallback), through ``dropout_plan``:
  16-byte accesses between a scalar head and tail, a grid of a few CTAs
  a SM;
- ``fused_dropout.launches``: a plain integer bumped per kernel launch.

Seeds come from a host-side stream: inside ``dropout_seeds(generator)``
every training-mode :class:`Dropout` call draws its int32 seed from that
CPU ``torch.Generator`` (outside one, from torch's default CPU generator),
so no seed ever needs a device sync; a block recomputed under activation
checkpointing replays the seeds of its first run (``seed_tape``).  Over a
mesh of more than one rank every rank draws the same seed from the shared
stream and folds its mesh position into it (``shard_seed``, the JAX
package's ``_shard_seed``): the ranks hold different rows, and unfolded
they would drop the same positions of each.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import functools

import torch
from torch import nn

from distributed_llms_example_tpu_torch.ops import cuda_build

M32 = 0xFFFFFFFF


def keep_threshold(rate: float) -> int:
    """uint32 threshold T such that ``(bits >> 8) < T`` keeps with
    probability ``1 - rate`` (a 24-bit compare, no float conversion)."""
    return int(round((1.0 - float(rate)) * (1 << 24)))


def _mul32(x, c: int):
    """``(x * c) mod 2**32`` for uint32 values held in int64 (a tensor or a
    Python int) and a uint32 constant ``c``, without any int64 overflow:
    ``c`` is split into 16-bit halves, so no partial product passes 2**48."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & M32


def _mix32(x):
    """murmur3 finalizer: full-avalanche 32-bit mix (uint32 values in int64)."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def stream_key(seed: int, tag_a: int = 0, tag_b: int = 0) -> int:
    """The per-(seed, tags) word that ``_hash_bits`` mixes into every
    element, as a Python int in [0, 2**32): the int32 ``seed`` (may be
    negative) is taken mod 2**32 as the JAX package's uint32 cast does."""
    s = (
        _mul32(int(seed) & M32, 0x9E3779B9)
        + _mul32(int(tag_a) & M32, 0x85EBCA77)
        + _mul32(int(tag_b) & M32, 0xC2B2AE3D)
    ) & M32
    return _mix32(s)


def hash_keep_mask(seed: int, shape: tuple[int, int], rate: float, *, tag_a: int = 0,
                   tag_b: int = 0, row0: int = 0, col0: int = 0,
                   device: torch.device | str = "cpu") -> torch.Tensor:
    """The hash stream's (rows, cols) bool keep-mask whose top-left element
    sits at absolute (row0, col0): the reference the kernel reproduces."""
    rows, cols = shape
    r = (torch.arange(rows, dtype=torch.int64, device=device) + row0) & M32
    c = (torch.arange(cols, dtype=torch.int64, device=device) + col0) & M32
    x = (_mul32(r, 0x27D4EB2F)[:, None] + _mul32(c, 0x165667B1)[None, :]
         + stream_key(seed, tag_a, tag_b)) & M32
    return (_mix32(x) >> 8) < keep_threshold(rate)


def attention_keep_mask(seed: int, shape: tuple[int, int, int, int], rate: float, *,
                        device: torch.device | str = "cpu") -> torch.Tensor:
    """The attention-probs dropout's (B, H, Sq, Sk) bool keep-mask, the one
    kernels 1-4 draw: plane (b, h) is ``hash_keep_mask(seed, (Sq, Sk),
    rate, tag_a=b, tag_b=h)`` over absolute (query, key).  Built a batch
    row at a time, so its int64 temporaries stay (H, Sq, Sk)."""
    B, H, Sq, Sk = shape
    r = torch.arange(Sq, dtype=torch.int64, device=device)
    c = torch.arange(Sk, dtype=torch.int64, device=device)
    pos = _mul32(r, 0x27D4EB2F)[:, None] + _mul32(c, 0x165667B1)[None, :]
    thr = keep_threshold(rate)
    out = torch.empty(shape, dtype=torch.bool, device=device)
    for b in range(B):
        keys = torch.tensor([stream_key(seed, b, h) for h in range(H)], dtype=torch.int64,
                            device=device)
        out[b] = (_mix32((pos[None] + keys[:, None, None]) & M32) >> 8) < thr
    return out


@functools.lru_cache(maxsize=64)
def _inv_keep(rate: float) -> float:
    """1/(1-rate) rounded to fp32, the one scale factor both versions use."""
    return float(torch.tensor(1.0 / (1.0 - float(rate)), dtype=torch.float32))


def dropout_plain(x: torch.Tensor, seed: int, rate: float, residual: torch.Tensor | None = None):
    """Plain PyTorch version of the kernel: fp32 ``x * inv_keep`` where
    kept, then ``+ residual`` (cast to x's dtype first), output in x's
    dtype.  Every product and sum is its own op, as in the kernel, which
    forbids fused multiply-adds, so the two agree bit for bit."""
    cols = x.shape[-1]
    keep = hash_keep_mask(seed, (x.numel() // max(cols, 1), cols), rate, device=x.device)
    inv = torch.tensor(_inv_keep(rate), dtype=torch.float32, device=x.device)
    y = torch.where(keep.reshape(x.shape), x.float() * inv, torch.zeros((), device=x.device))
    if residual is not None:
        y = residual.to(x.dtype).float() + y
    return y.to(x.dtype)


# csrc/fused_dropout.cu's launch shape: threads a CTA, 16-byte vectors of x
# a thread has in flight (half of them with a residual), CTAs an SM holds
# (its __launch_bounds__)
NT, UNROLL, CTAS_PER_SM = 256, 4, 4
VEC_BYTES = 16


@dataclasses.dataclass(frozen=True)
class DropoutPlan:
    """How one launch covers ``numel`` elements: ``head`` scalar elements,
    then ``vectors`` accesses of ``width`` elements (16 bytes each, aligned
    in x, the residual and out alike), then ``tail`` scalar elements;
    ``grid`` CTAs."""

    width: int
    head: int
    vectors: int
    tail: int
    grid: int

    @property
    def vector_elements(self) -> int:
        return self.vectors * self.width


def dropout_plan(numel: int, cols: int, dtype: torch.dtype, x_ptr: int, res_ptr: int | None,
                 out_ptr: int, *, sms: int = 132) -> DropoutPlan:
    """The kernel's launch plan for a (numel // cols, cols) view in
    ``dtype`` at the given addresses (``res_ptr`` None without a
    residual) on a card of ``sms`` SMs.  The vectors start at the first
    element whose three addresses are 16-byte aligned; where the addresses
    disagree modulo 16 no element can take a vector and every one is a
    scalar.  The grid is at most CTAS_PER_SM CTAs a SM, each doing the
    same number of rounds (UNROLL * NT vectors, UNROLL / 2 * NT with a
    residual, or NT scalars, a round).  Only the addresses modulo 16
    matter, so plans are cached on them: a launch pays a lookup."""
    return _plan(numel, cols, dtype, x_ptr % VEC_BYTES,
                 None if res_ptr is None else res_ptr % VEC_BYTES, out_ptr % VEC_BYTES, sms)


@functools.lru_cache(maxsize=1024)
def _plan(numel: int, cols: int, dtype: torch.dtype, x_ptr: int, res_ptr: int | None,
          out_ptr: int, sms: int) -> DropoutPlan:
    if numel and (cols < 1 or numel % cols or cols >= 2**31):
        raise ValueError(f"fused_dropout: {numel} elements do not form rows of {cols} "
                         "(1 <= cols < 2**31)")
    size = torch.finfo(dtype).bits // 8
    width = VEC_BYTES // size
    ptrs = [p for p in (x_ptr, res_ptr, out_ptr) if p is not None]
    if any(p % size for p in ptrs):
        raise ValueError(f"fused_dropout: an address is not {dtype}-aligned")
    if len({p % VEC_BYTES for p in ptrs}) == 1:
        head = min(numel, (-x_ptr % VEC_BYTES) // size)
        vectors = (numel - head) // width
    else:
        head, vectors = numel, 0
    tail = numel - head - vectors * width
    unroll = UNROLL if res_ptr is None else UNROLL // 2
    work = max(-(-vectors // (unroll * NT)), -(-(head + tail) // NT), 1)
    rounds = -(-work // (CTAS_PER_SM * sms))
    return DropoutPlan(width, head, vectors, tail, -(-work // rounds))


@functools.lru_cache(maxsize=None)
def _sm_count(dev: torch.device) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


_ARGTYPES = (
    [ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 4 + [ctypes.c_int]
    + [ctypes.c_uint, ctypes.c_uint, ctypes.c_float] + [ctypes.c_int, ctypes.c_void_p]
)


def _dropout_cuda(x, residual, seed, rate):
    tensors = {"x": x} if residual is None else {"x": x, "residual": residual}
    dev = cuda_build.check_inputs("fused_dropout", tensors)
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"fused_dropout kernel takes fp32 or bf16, got {x.dtype}")
    if residual is not None and residual.dtype != x.dtype:
        residual = residual.to(x.dtype)
    cols = x.shape[-1]
    # out shares x's address modulo 16, so that an x at a storage offset
    # (and a residual at the same one) still takes 16-byte accesses
    off = x.data_ptr() % VEC_BYTES // x.element_size()
    out = (torch.empty(x.numel() + off, dtype=x.dtype, device=dev)[off:].view(x.shape) if off
           else torch.empty_like(x))
    res_ptr = None if residual is None else residual.data_ptr()
    plan = dropout_plan(x.numel(), cols, x.dtype, x.data_ptr(), res_ptr, out.data_ptr(),
                        sms=_sm_count(dev))
    fn = cuda_build.load("fused_dropout", _ARGTYPES)
    err = fn(x.data_ptr(), res_ptr, out.data_ptr(), x.numel(), cols, plan.head, plan.vectors,
             plan.grid, stream_key(seed), keep_threshold(rate), _inv_keep(rate),
             int(x.dtype == torch.bfloat16), torch.cuda.current_stream(dev).cuda_stream)
    cuda_build.check(err, "fused_dropout")
    fused_dropout.launches += 1
    return out


def _run(x, residual, seed, rate):
    if x.device.type == "cpu":
        return dropout_plain(x, seed, rate, residual)
    return _dropout_cuda(x, residual, seed, rate)


class _FusedDropout(torch.autograd.Function):
    """Saves the int seed only; the backward reruns the kernel on g."""

    @staticmethod
    def forward(ctx, x, residual, seed, rate):
        ctx.seed, ctx.rate = seed, rate
        ctx.res_dtype = None if residual is None else residual.dtype
        return _run(x, residual, seed, rate)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        dx = _run(g, None, ctx.seed, ctx.rate)
        dres = None if ctx.res_dtype is None else g.to(ctx.res_dtype)
        return dx, dres, None, None


def fused_dropout(x: torch.Tensor, seed: int, rate: float, *,
                  residual: torch.Tensor | None = None) -> torch.Tensor:
    """``residual + where(keep, x/(1-rate), 0)`` in one pass, differentiable
    in ``x`` and ``residual``; ``x`` is any >=1-D activation, ``seed`` an
    int32 Python int.  A CPU tensor runs the plain version, a CUDA tensor
    the kernel."""
    if not 0.0 < float(rate) < 1.0:
        raise ValueError(f"fused_dropout needs 0 < rate < 1, got {rate}")
    if residual is not None and residual.shape != x.shape:
        raise ValueError(f"residual shape {tuple(residual.shape)} != activation shape "
                         f"{tuple(x.shape)}")
    if not -(2**31) <= int(seed) < 2**31:
        raise ValueError(f"seed {seed} is not an int32")
    return _FusedDropout.apply(x.contiguous(), None if residual is None else residual.contiguous(),
                               int(seed), float(rate))


fused_dropout.launches = 0


# ------------------------------------------------------------ seed stream

_STREAMS: list[torch.Generator] = []


@contextlib.contextmanager
def dropout_seeds(generator: torch.Generator):
    """Training-mode :class:`Dropout` calls inside draw their seeds from
    ``generator`` (a CPU generator: drawing needs no device sync)."""
    if generator.device.type != "cpu":
        raise ValueError(f"dropout seeds come from a CPU generator, got {generator.device}")
    _STREAMS.append(generator)
    try:
        yield generator
    finally:
        _STREAMS.pop()


# (tape, replay, cursor) of the innermost ``seed_tape`` region
_TAPES: list[tuple[list[int], bool, list[int]]] = []


@contextlib.contextmanager
def seed_tape(tape: list[int], *, replay: bool):
    """A region whose seeds are recorded on its first run and replayed on
    its recompute: inside, ``next_seed`` appends every seed it draws to
    ``tape`` (``replay=False``), or hands out ``tape``'s seeds in order
    without drawing (``replay=True``).  Activation checkpointing
    (``utils/remat.py``) runs a block's forward again in the backward; the
    replay gives that rerun the first run's masks, and the stream is drawn
    once, as without checkpointing."""
    cursor = [0]
    _TAPES.append((tape, replay, cursor))
    try:
        yield
    finally:
        _TAPES.pop()
    if replay and cursor[0] != len(tape):
        raise RuntimeError(f"a recomputed region drew {cursor[0]} dropout seeds, its first run "
                           f"{len(tape)}")


# this rank's (data, fsdp, expert) mesh position, folded into every seed;
# None on a mesh of one device (``set_shard_coords``)
_SHARD_COORDS: list[tuple[int, ...] | None] = [None]
_FOLD = 1000003


def set_shard_coords(coords: tuple[int, ...] | None) -> None:
    """This process's (data, fsdp, expert) position on a mesh of more than
    one device, or None (one device: seeds stay as drawn)."""
    _SHARD_COORDS[0] = None if coords is None else tuple(int(c) for c in coords)


def shard_seed(seed: int, *, heads_axis: bool = False) -> int:
    """``seed`` with this rank's mesh position folded in, in wrapping int32
    arithmetic: ``seed = seed * 1000003 + index`` for each of data, fsdp
    and expert in that order (the JAX package's ``_shard_seed`` over its
    batch axes, size-1 axes included), and the ``tensor`` axis's 0 after
    them for an attention-probs seed (``heads_axis``), as the JAX flash
    path folds its head axis too.  On one device: ``seed`` itself."""
    coords = _SHARD_COORDS[0]
    if coords is None:
        return seed
    for c in coords + ((0,) if heads_axis else ()):
        seed = (seed * _FOLD + c) & M32
        seed = seed - (1 << 32) if seed >= 1 << 31 else seed
    return seed


def _draw(gen: torch.Generator | None) -> int:
    return int(torch.randint(-(2**31), 2**31, (), generator=gen))


def next_seed() -> int:
    """One int32 seed from the innermost ``dropout_seeds`` stream (or from
    torch's default CPU generator outside one); inside a replaying
    ``seed_tape``, the tape's next seed."""
    if _TAPES:
        tape, replay, cursor = _TAPES[-1]
        if replay:
            if cursor[0] >= len(tape):
                raise RuntimeError(f"a recomputed region drew more dropout seeds than the "
                                   f"{len(tape)} of its first run")
            cursor[0] += 1
            return tape[cursor[0] - 1]
    seed = _draw(_STREAMS[-1] if _STREAMS else None)
    if _TAPES:
        _TAPES[-1][0].append(seed)
    return seed


class Dropout(nn.Module):
    """Dropout with the fused residual add: ``dropout(h, residual=r)`` ==
    ``r + dropout(h)``.  In eval mode (and at rate 0) it is the identity
    plus the residual; at rate 1 it drops everything, as ``nn.Dropout``."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = float(rate)

    def forward(self, x: torch.Tensor, *, residual: torch.Tensor | None = None) -> torch.Tensor:
        if not self.training or self.rate <= 0.0:
            return x if residual is None else residual + x
        if self.rate >= 1.0:
            z = torch.zeros_like(x)
            return z if residual is None else residual + z
        return fused_dropout(x, shard_seed(next_seed()), self.rate, residual=residual)

    def extra_repr(self) -> str:
        return f"rate={self.rate}"


def count_dropout_sites(model: nn.Module) -> int:
    """Dropout call sites one training forward of ``model`` runs through
    the kernel: each call site owns its own :class:`Dropout` module, so
    this is the number of such modules with 0 < rate < 1."""
    return sum(isinstance(m, Dropout) and 0.0 < m.rate < 1.0 for m in model.modules())
