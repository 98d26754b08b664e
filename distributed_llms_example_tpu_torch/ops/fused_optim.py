"""Fused clip + AdamW (+ weight decay + health sums), and the gradient pass
before it: CUDA kernels + plain versions (port of the JAX package's
``ops/fused_optim.py``).

Per parameter tensor (leaf), one pass, in place:

    gc  = select(gnorm < max_norm, g, (g / gnorm) * max_norm)
    mu' = (1-b1)*gc + b1*mu            nu' = (1-b2)*gc^2 + b2*nu
    u   = (mu'/bc1) / (sqrt(nu'/bc2) + eps)
    u   = u + wd*p        (decay-mask leaves only)
    u   = (-lr) * u       p' = p + u

with the step scalars (global grad norm, clip trigger, bias corrections,
-lr) in an 8-float vector on the device (``_S_*`` layout, as in the JAX
package), computed outside the kernel by ``train/optim.py``.  The kernel
also returns each leaf's health sums (``STAT_*`` layout): sum of p^2, sum
of u^2 and the non-finite count of the raw, pre-clip gradient.  Before it,
the step's gradient pass divides every gradient by the token count in place
and takes the global norm of the result (the JAX package's ``g / tokens``
and ``optax.global_norm``), its sums of squares in float64.

- ``adamw_leaf_plain`` and ``grad_prep_plain``: the plain PyTorch versions
  (the first the port of ``adamw_leaf_reference``), run for CPU tensors
  and held against the kernels on the card.  One op at a time, so no
  multiply-add is fused.
- ``csrc/fused_adamw.cu``: the kernels, launched for CUDA tensors (or the
  wrappers raise), each over a table of leaves (``leaf_table``) that one
  launch covers whole, up to MAX_LEAVES leaves; the table is rebuilt every
  step, since the gradients are new tensors.  AdamW's operations are
  non-contracting IEEE intrinsics, so p', mu' and nu' equal the plain
  version's bit for bit; the health sums differ in summation order only.
  The gradient pass divides as ``div_`` does and sums in a fixed order,
  so its norm is the same bits on every run.
- The partial mode (``fused_grad_prep(..., partial=True)``), for a rank
  that holds shards of the leaves: the float64 sum of squares instead of
  the norm, which the caller all-reduces (float64 SUM) over the ranks
  that hold the other shards; ``grad_norm_finish`` then takes its root,
  rounded once to fp32, with the one-pass norm's arithmetic (a one-thread
  entry of the same source).  A leaf may hold no element (an uneven
  shard), in either pass.
- ``fused_adamw_leaf.launches``, ``fused_grad_prep.launches`` and
  ``grad_norm_finish.launches``: plain integers bumped per kernel launch.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from distributed_llms_example_tpu_torch.ops import cuda_build

# scalar-vector layout: the per-step scalars the kernel reads on the device
_S_GNORM, _S_TRIGGER, _S_BC1, _S_BC2, _S_NEG_LR = 0, 1, 2, 3, 4
SCALARS = 8

# per-leaf stats layout: health sums produced in the same pass
STAT_P_SUMSQ, STAT_U_SUMSQ, STAT_NONFINITE = 0, 1, 2
STATS = 4

# the leaf table (csrc/fused_adamw.cu): leaves one launch holds, elements
# of one work item (a multiple of 4, so float4 accesses stay aligned), the
# gradient pass's CTAs at most, and each leaf's flags
MAX_LEAVES = 640
CHUNK = 16384
MAX_GRID = 4096
FLAG_DECAY, FLAG_VEC = 1, 2


def adamw_leaf_plain(p, mu, nu, g, scal, *, b1: float, b2: float, eps: float,
                     max_norm: float, wd: float):
    """The update of one leaf in plain PyTorch: (p', mu', nu', stats[4]).
    ``g`` is the token-normalized fp32 gradient; ``scal`` the SCALARS
    vector.  The non-finite count reads the raw, pre-clip gradient."""
    g_raw = g
    if max_norm > 0:
        g = torch.where(scal[_S_TRIGGER] != 0.0, g, (g / scal[_S_GNORM]) * max_norm)
    mu2 = (1 - b1) * g + b1 * mu
    nu2 = (1 - b2) * (g * g) + b2 * nu
    u = (mu2 / scal[_S_BC1]) / (torch.sqrt(nu2 / scal[_S_BC2]) + eps)
    if wd:
        u = u + wd * p
    u = scal[_S_NEG_LR] * u
    stats = torch.stack([
        torch.sum(p.float() ** 2),
        torch.sum(u.float() ** 2),
        torch.sum(~torch.isfinite(g_raw)).float(),
        torch.zeros((), device=p.device),
    ])
    return p + u, mu2, nu2, stats


def grad_prep_plain(grads, tokens, *, partial: bool = False) -> torch.Tensor:
    """The gradient pass in plain PyTorch, in place: every ``g /= tokens``,
    then the global norm of the result, each leaf's sum of squares and
    their total in float64, the square root rounded once to fp32 (a 0-d
    tensor).  ``partial``: the float64 total (a 0-d tensor), for
    ``grad_norm_finish`` after a cross-rank sum."""
    if not grads:
        total = torch.zeros((), dtype=torch.float64, device=tokens.device)
        return total if partial else total.float()
    for g in grads:
        g.div_(tokens)
    total = torch.stack([torch.sum(g.double() ** 2) for g in grads]).sum()
    return total if partial else norm_finish_plain(total)


def norm_finish_plain(total: torch.Tensor) -> torch.Tensor:
    """The root of a float64 sum of squares, rounded once to fp32."""
    return torch.sqrt(total).float()


@dataclasses.dataclass
class LeafTable:
    """One step's table of leaves for the kernels: per leaf the p, mu, nu
    and g addresses (``ptrs``, 0 for a column not given), its element
    count and flags (FLAG_DECAY; FLAG_VEC where every address is 16-byte
    aligned).  ``groups`` are the launches: (lo, hi, first) for leaves
    [lo, hi), ``first[i]`` the first work item of leaf lo + i, int32,
    ``first[-1]`` the launch's item count; leaf i's items cover its
    elements ``chunk`` at a time."""

    device: torch.device
    ptrs: np.ndarray
    numel: np.ndarray
    flags: np.ndarray
    chunk: int
    groups: list

    def with_grads(self, grads) -> "LeafTable":
        """This table with ``grads`` (checked as ``leaf_table`` checks
        every column) in its g column: a step's table when the parameters
        and moments are this table's, as they are from step to step."""
        ptrs = self.ptrs.copy()
        ptrs[:, 3] = _addresses(grads, self.numel.tolist(), self.device, "g")
        vec = np.where((ptrs % 16 == 0).all(axis=1), FLAG_VEC, 0).astype(np.uint8)
        return dataclasses.replace(self, ptrs=ptrs, flags=(self.flags & ~np.uint8(FLAG_VEC)) | vec)


def leaf_groups(numel: np.ndarray, *, chunk: int = CHUNK, max_leaves: int = MAX_LEAVES) -> list:
    """The launches that cover leaves of ``numel`` elements: consecutive
    runs of at most ``max_leaves`` leaves, each with its prefix of work
    items (``LeafTable.groups``)."""
    if chunk < 4 or chunk % 4 or not 1 <= max_leaves <= MAX_LEAVES:
        raise ValueError(f"leaf table: chunk {chunk} (a positive multiple of 4) or "
                         f"max_leaves {max_leaves} (1..{MAX_LEAVES}) out of range")
    items = (np.asarray(numel, np.int64) + chunk - 1) // chunk
    groups = []
    for lo in range(0, len(items), max_leaves):
        hi = min(len(items), lo + max_leaves)
        first = np.zeros(hi - lo + 1, np.int64)
        np.cumsum(items[lo:hi], out=first[1:])
        if first[-1] >= 2**31:
            raise ValueError(f"leaf table: {first[-1]} work items in one launch")
        groups.append((lo, hi, first.astype(np.int32)))
    return groups


def _addresses(col, numel: list, dev: torch.device, what: str) -> list:
    """The addresses of one column of leaves, after checking that each is
    a contiguous fp32 tensor on ``dev`` with its leaf's element count."""
    f32 = torch.float32
    for i, t in enumerate(col):
        if t.dtype != f32 or not t.is_contiguous() or t.numel() != numel[i] or t.device != dev:
            raise ValueError(f"leaf table: {what} of leaf {i} is {t.dtype} {tuple(t.shape)} on "
                             f"{t.device} (contiguous: {t.is_contiguous()}); expected "
                             f"contiguous fp32 of {numel[i]} elements on {dev}")
    return [t.data_ptr() for t in col]


def leaf_table(grads, params=None, mus=None, nus=None, decay=None, *, chunk: int = CHUNK,
               max_leaves: int = MAX_LEAVES) -> LeafTable:
    """The table of ``grads`` (and of their parameters and moments, for
    AdamW; the gradient pass reads g alone): one pass over the tensors'
    addresses, no tensor op.  Every tensor is a contiguous fp32 tensor on
    one device with its leaf's element count."""
    numel = [g.numel() for g in grads]
    dev = grads[0].device if grads else torch.device("cpu")
    ptrs = np.zeros((len(grads), 4), np.uint64)
    for j, (what, col) in enumerate((("p", params), ("mu", mus), ("nu", nus), ("g", grads))):
        if col is not None and len(grads):
            ptrs[:, j] = _addresses(col, numel, dev, what)
    flags = np.where((ptrs % 16 == 0).all(axis=1), FLAG_VEC, 0).astype(np.uint8)
    if decay is not None:
        flags |= np.asarray(decay, bool).astype(np.uint8) * FLAG_DECAY
    numel = np.asarray(numel, np.int64)
    return LeafTable(dev, ptrs, numel, flags, chunk,
                     leaf_groups(numel, chunk=chunk, max_leaves=max_leaves))


def _table_args(table: LeafTable, lo: int, hi: int, first: np.ndarray) -> list:
    """The C entries' leading arguments for one launch: host addresses of
    the group's rows (ptrs, numel, flags, first), its leaf count, chunk."""
    return [table.ptrs[lo:hi].ctypes.data, table.numel[lo:hi].ctypes.data,
            table.flags[lo:hi].ctypes.data, first.ctypes.data, hi - lo, table.chunk]


_TABLE_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2
_ADAMW_ARGTYPES = _TABLE_ARGTYPES + [ctypes.c_void_p] * 2 + [ctypes.c_float] * 7 + [
    ctypes.c_int, ctypes.c_void_p]
_PREP_ARGTYPES = _TABLE_ARGTYPES + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
_FINISH_ARGTYPES = [ctypes.c_void_p] * 3


def _adamw_cuda(table: LeafTable, scal, stats, *, b1, b2, eps, max_norm, wd):
    """One launch per group of ``table``; ``stats`` is the (N, STATS)
    float64 table the kernel adds each leaf's health sums into."""
    dev = cuda_build.check_inputs("fused_adamw", {"scal": scal, "stats": stats})
    if table.device != dev:
        raise ValueError(f"fused_adamw: the leaves are on {table.device}, scal on {dev}")
    if scal.dtype != torch.float32 or scal.numel() != SCALARS:
        raise ValueError(f"fused_adamw: scal needs {SCALARS} fp32 values")
    if stats.dtype != torch.float64 or stats.numel() != STATS * len(table.numel):
        raise ValueError(f"fused_adamw: stats needs {len(table.numel)} x {STATS} float64")
    fn = cuda_build.load("fused_adamw", _ADAMW_ARGTYPES)
    stream = torch.cuda.current_stream(dev).cuda_stream
    for lo, hi, first in table.groups:
        err = fn(*_table_args(table, lo, hi, first), scal.data_ptr(),
                 stats.data_ptr() + lo * STATS * stats.element_size(), b1, 1 - b1, b2, 1 - b2,
                 eps, max_norm, wd, int(max_norm > 0), stream)
        cuda_build.check(err, "fused_adamw")
        fused_adamw_leaf.launches += 1


_WORKSPACE: dict = {}


def _prep_workspace(dev: torch.device) -> torch.Tensor:
    """The gradient pass's float64 workspace on ``dev`` (its finished-CTA
    counter, running total and partial sums), zeroed once; every launch
    leaves the counter at 0 again."""
    ws = _WORKSPACE.get(dev)
    if ws is None:
        ws = _WORKSPACE[dev] = torch.zeros(2 + MAX_GRID, dtype=torch.float64, device=dev)
    return ws


def _grad_prep_cuda(table: LeafTable, tokens, partial: bool = False) -> torch.Tensor:
    dev = cuda_build.check_inputs("fused_grad_prep", {"tokens": tokens})
    if table.device != dev:
        raise ValueError(f"fused_grad_prep: the gradients are on {table.device}, tokens on {dev}")
    if tokens.dtype != torch.float32 or tokens.numel() != 1:
        raise ValueError("fused_grad_prep: tokens must be one fp32 value")
    gnorm = torch.empty((), dtype=torch.float32, device=dev)
    total = torch.empty((), dtype=torch.float64, device=dev) if partial else None
    if not table.groups:
        return total.zero_() if partial else gnorm.zero_()
    fn = cuda_build.load("fused_adamw", _PREP_ARGTYPES, "fused_grad_prep")
    ws = _prep_workspace(dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    last = len(table.groups) - 1
    for k, (lo, hi, first) in enumerate(table.groups):
        err = fn(*_table_args(table, lo, hi, first), tokens.data_ptr(), ws.data_ptr(),
                 gnorm.data_ptr(), total.data_ptr() if partial else None, int(k == 0),
                 int(k == last), stream)
        cuda_build.check(err, "fused_grad_prep")
        fused_grad_prep.launches += 1
    return total if partial else gnorm


@torch.no_grad()
def fused_grad_prep(grads, tokens, *, table: LeafTable | None = None,
                    partial: bool = False) -> torch.Tensor:
    """Divide every gradient by ``tokens`` (a one-element fp32 tensor) IN
    PLACE and return the global norm of the result (a 0-d fp32 tensor),
    or with ``partial`` its float64 sum of squares (a 0-d tensor, for
    ``grad_norm_finish`` after a cross-rank sum).  CPU gradients run the
    plain version; CUDA ones the kernel, over ``table`` when given (it
    must hold ``grads``)."""
    if not grads or grads[0].device.type == "cpu":
        return grad_prep_plain(grads, tokens, partial=partial)
    return _grad_prep_cuda(table or leaf_table(grads), tokens.reshape(()), partial)


fused_grad_prep.launches = 0


@torch.no_grad()
def grad_norm_finish(total: torch.Tensor) -> torch.Tensor:
    """The global norm from ``fused_grad_prep(..., partial=True)``'s float64
    sum of squares (all-reduced over the ranks by the caller): its root
    rounded once to fp32, a 0-d tensor.  A CPU tensor runs the plain
    version, a CUDA tensor the one-thread kernel."""
    if total.device.type == "cpu":
        return norm_finish_plain(total)
    return _norm_finish_cuda(total)


def _norm_finish_cuda(total: torch.Tensor) -> torch.Tensor:
    dev = cuda_build.check_inputs("grad_norm_finish", {"total": total})
    if total.dtype != torch.float64 or total.numel() != 1:
        raise ValueError("grad_norm_finish: total must be one float64 value")
    total = total.reshape(()).contiguous()
    gnorm = torch.empty((), dtype=torch.float32, device=dev)
    fn = cuda_build.load("fused_adamw", _FINISH_ARGTYPES, "fused_grad_norm_finish")
    err = fn(total.data_ptr(), gnorm.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    cuda_build.check(err, "grad_norm_finish")
    grad_norm_finish.launches += 1
    return gnorm


grad_norm_finish.launches = 0


@torch.no_grad()
def fused_adamw_leaf(p, mu, nu, g, scal, *, b1: float, b2: float, eps: float, max_norm: float,
                     wd: float, stats: torch.Tensor | None = None) -> torch.Tensor:
    """The fused update of one leaf, IN PLACE on ``p``, ``mu`` and ``nu``
    (fp32).  Adds the leaf's health sums into ``stats`` (a (STATS,)
    float64 buffer, zeroed here when not given) and returns it.  A CPU
    tensor runs the plain version; a CUDA tensor launches the kernel on a
    table of this one leaf."""
    if stats is None:
        stats = torch.zeros(STATS, dtype=torch.float64, device=p.device)
    hyper = dict(b1=b1, b2=b2, eps=eps, max_norm=max_norm, wd=wd)
    if p.device.type == "cpu":
        p2, mu2, nu2, st = adamw_leaf_plain(p, mu, nu, g, scal, **hyper)
        p.copy_(p2)
        mu.copy_(mu2)
        nu.copy_(nu2)
        stats += st.double()
    else:
        _adamw_cuda(leaf_table([g], [p], [mu], [nu], [wd != 0.0]), scal, stats, **hyper)
    return stats


fused_adamw_leaf.launches = 0


@torch.no_grad()
def adamw_tree_apply(params, mus, nus, grads, scal, stats, *, b1: float, b2: float, eps: float,
                     max_norm: float, weight_decay: float, decay,
                     table: LeafTable | None = None) -> None:
    """The fused update over lists of leaves, in place: on CUDA one launch
    per MAX_LEAVES leaves (over ``table`` when given; it must hold these
    lists and ``decay``), on the CPU the plain version leaf by leaf.
    ``decay[i]`` says whether leaf i takes weight decay.  ``stats`` is the
    caller's (N, STATS) float64 table, refilled with the health sums, one
    row per leaf."""
    stats.zero_()
    if not grads or grads[0].device.type == "cpu":
        for i, (p, m, v, g, d) in enumerate(zip(params, mus, nus, grads, decay)):
            fused_adamw_leaf(p, m, v, g, scal, b1=b1, b2=b2, eps=eps, max_norm=max_norm,
                             wd=weight_decay if d else 0.0, stats=stats[i])
        return
    table = table or leaf_table(grads, params, mus, nus, decay)
    _adamw_cuda(table, scal, stats, b1=b1, b2=b2, eps=eps, max_norm=max_norm, wd=weight_decay)
