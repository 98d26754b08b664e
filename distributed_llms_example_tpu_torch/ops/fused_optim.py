"""Fused clip + AdamW (+ weight decay + health sums): CUDA kernel + plain
version (port of the JAX package's ``ops/fused_optim.py``).

Per parameter tensor, one pass, in place:

    gc  = select(gnorm < max_norm, g, (g / gnorm) * max_norm)
    mu' = (1-b1)*gc + b1*mu            nu' = (1-b2)*gc^2 + b2*nu
    u   = (mu'/bc1) / (sqrt(nu'/bc2) + eps)
    u   = u + wd*p        (decay-mask leaves only)
    u   = (-lr) * u       p' = p + u

with the step scalars (global grad norm, clip trigger, bias corrections,
-lr) in an 8-float vector on the device (``_S_*`` layout, as in the JAX
package), computed outside the kernel by ``train/optim.py``.  The kernel
also returns the leaf's health sums (``STAT_*`` layout): sum of p^2, sum
of u^2 and the non-finite count of the raw, pre-clip gradient.

- ``adamw_leaf_plain``: the plain PyTorch version (the port of
  ``adamw_leaf_reference``), run for CPU tensors and held against the
  kernel on the card.  One op at a time, so no multiply-add is fused.
- ``csrc/fused_adamw.cu``: the kernel, launched for CUDA tensors (or the
  wrapper raises).  Its operations are non-contracting IEEE intrinsics, so
  p', mu' and nu' equal the plain version's bit for bit; the health sums
  differ in summation order only (double accumulation in the kernel).
- ``fused_adamw_leaf.launches``: a plain integer bumped per launch.
"""

from __future__ import annotations

import ctypes

import torch

from distributed_llms_example_tpu_torch.ops import cuda_build

# scalar-vector layout: the per-step scalars the kernel reads on the device
_S_GNORM, _S_TRIGGER, _S_BC1, _S_BC2, _S_NEG_LR = 0, 1, 2, 3, 4
SCALARS = 8

# per-leaf stats layout: health sums produced in the same pass
STAT_P_SUMSQ, STAT_U_SUMSQ, STAT_NONFINITE = 0, 1, 2
STATS = 4


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


_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_longlong] + [ctypes.c_float] * 7 + [
    ctypes.c_int, ctypes.c_void_p]


def _adamw_cuda(p, mu, nu, g, scal, stats, *, b1, b2, eps, max_norm, wd):
    tensors = {"p": p, "mu": mu, "nu": nu, "g": g, "scal": scal, "stats": stats}
    dev = cuda_build.check_inputs("fused_adamw", tensors)
    for name, t in tensors.items():
        want = torch.float64 if name == "stats" else torch.float32
        if t.dtype != want:
            raise ValueError(f"fused_adamw: {name} must be {want}, got {t.dtype}")
    if not p.shape == mu.shape == nu.shape == g.shape:
        raise ValueError(f"fused_adamw: shapes differ: p {tuple(p.shape)}, mu {tuple(mu.shape)}, "
                         f"nu {tuple(nu.shape)}, g {tuple(g.shape)}")
    if scal.numel() != SCALARS or stats.numel() != STATS:
        raise ValueError(f"fused_adamw: scal needs {SCALARS} floats and stats {STATS}")
    fn = cuda_build.load("fused_adamw", _ARGTYPES)
    err = fn(p.data_ptr(), mu.data_ptr(), nu.data_ptr(), g.data_ptr(), scal.data_ptr(),
             stats.data_ptr(), p.numel(), b1, 1 - b1, b2, 1 - b2, eps, max_norm, wd,
             int(max_norm > 0), torch.cuda.current_stream(dev).cuda_stream)
    cuda_build.check(err, "fused_adamw")
    fused_adamw_leaf.launches += 1


@torch.no_grad()
def fused_adamw_leaf(p, mu, nu, g, scal, *, b1: float, b2: float, eps: float, max_norm: float,
                     wd: float, stats: torch.Tensor | None = None) -> torch.Tensor:
    """The fused update of one leaf, IN PLACE on ``p``, ``mu`` and ``nu``
    (fp32).  Adds the leaf's health sums into ``stats`` (a (STATS,)
    float64 buffer, zeroed here when not given) and returns it.  A CPU
    tensor runs the plain version; a CUDA tensor launches the kernel."""
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
        _adamw_cuda(p, mu, nu, g, scal, stats, **hyper)
    return stats


fused_adamw_leaf.launches = 0


@torch.no_grad()
def adamw_tree_apply(params, mus, nus, grads, scal, stats, *, b1: float, b2: float, eps: float,
                     max_norm: float, weight_decay: float, decay) -> None:
    """The fused update over lists of leaves (one kernel launch each), in
    place.  ``decay[i]`` says whether leaf i takes weight decay.  ``stats``
    is the caller's (N, STATS) float64 table, refilled with the health
    sums, one row per leaf."""
    stats.zero_()
    for i, (p, m, v, g, d) in enumerate(zip(params, mus, nus, grads, decay)):
        fused_adamw_leaf(p, m, v, g, scal, b1=b1, b2=b2, eps=eps, max_norm=max_norm,
                         wd=weight_decay if d else 0.0, stats=stats[i])
