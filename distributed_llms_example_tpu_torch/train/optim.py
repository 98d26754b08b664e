"""Optimizer and LR schedule (port of the JAX package's ``train/optim.py``).

- ``linear_schedule_with_warmup``: linear warmup then linear decay to 0,
  with optax's ``join_schedules`` semantics and its fp32 arithmetic;
- ``decay_mask``: weight decay on matrices and embeddings (rank >= 2),
  never on biases or norm scales;
- ``OptimizerSpec``: the clip + AdamW hyperparameters as data;
- ``AdamWState`` and ``fused_optimizer_apply``: the optimizer state (step
  count, fp32 mu and nu per parameter) and one clip + AdamW step through
  the fused kernels (``ops/fused_optim.py``): the gradient pass (token
  division and global norm) and the AdamW update, each one launch over a
  table of every parameter tensor.  Every step scalar stays on the
  device: a step needs no ``.item()``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from distributed_llms_example_tpu_torch.ops.fused_optim import (
    _S_BC1,
    _S_BC2,
    _S_GNORM,
    _S_NEG_LR,
    _S_TRIGGER,
    SCALARS,
    STATS,
    LeafTable,
    adamw_tree_apply,
    fused_grad_prep,
    grad_norm_finish,
    leaf_table,
)

Schedule = Callable[[int], float]


def _linear_schedule(init: float, end: float, steps: int) -> Schedule:
    """optax ``linear_schedule``: ``(init - end) * (1 - t/steps) + end`` with
    t clipped to [0, steps], evaluated in fp32 as optax does."""
    f32 = np.float32

    def schedule(count: int) -> float:
        c = min(max(int(count), 0), steps)
        frac = f32(1) - f32(c) / f32(steps)
        return float(f32(init - end) * frac + f32(end))

    return schedule


def linear_schedule_with_warmup(lr: float, warmup_steps: int, total_steps: int) -> Schedule:
    """Warmup 0 → lr over ``warmup_steps``, then lr → 0 over the rest: the
    JAX package's schedule, step by step."""
    warmup_steps = max(0, int(warmup_steps))
    decay_steps = max(1, int(total_steps) - warmup_steps)
    warm = _linear_schedule(0.0, lr, max(1, warmup_steps))
    decay = _linear_schedule(lr, 0.0, decay_steps)

    def schedule(count: int) -> float:
        return warm(count) if count < warmup_steps else decay(count - warmup_steps)

    return schedule


def decay_mask(name: str, p: torch.Tensor) -> bool:
    """True (decay) for matrices and embeddings, False for biases and norm
    scales (the leaf name is checked as well as the rank)."""
    return p.dim() >= 2 and name.rsplit(".", 1)[-1] not in ("scale", "bias")


@dataclasses.dataclass(frozen=True)
class OptimizerSpec:
    learning_rate: float = 5e-5
    weight_decay: float = 0.01
    warmup_steps: int = 500
    total_steps: int = 10_000
    max_grad_norm: float = 1.0
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8


@dataclasses.dataclass
class AdamWState:
    """optax's ``ScaleByAdamState`` for a list of parameters: the step count
    (a host int: the schedule and the bias corrections read it without a
    device round trip) and fp32 first/second moments, one per parameter.
    ``stats`` is the kernel's (N, STATS) float64 table of per-leaf health
    sums, allocated once and refilled by every step; the health numerics
    read it (``train/step.py`` ``health_metrics_from_stats``).
    ``table`` is the kernels' leaf table of the parameters and these
    moments, built (and its tensors checked) at the first step on the GPU
    and rebuilt only if the parameters' addresses change (a checkpoint
    restore copies into the parameters and moments, so it keeps them);
    each step adds its gradients to a copy."""

    count: int
    mu: list[torch.Tensor]
    nu: list[torch.Tensor]
    stats: torch.Tensor
    table: LeafTable | None = None

    @classmethod
    def zeros(cls, params: list[torch.Tensor]) -> "AdamWState":
        return cls(0, [torch.zeros_like(p, dtype=torch.float32) for p in params],
                   [torch.zeros_like(p, dtype=torch.float32) for p in params],
                   torch.zeros(len(params), STATS, dtype=torch.float64,
                               device=params[0].device))


def step_scalars(spec: OptimizerSpec, schedule: Schedule, count: int,
                 gnorm: torch.Tensor) -> torch.Tensor:
    """The kernel's SCALARS vector on gnorm's device: clip trigger from the
    norm, bias corrections in fp32 at the post-increment count, -lr at the
    pre-increment count.  Host values enter through fills, not copies, so
    building it never waits on the device."""
    dev = gnorm.device
    count_inc = torch.full((), count + 1, dtype=torch.float32, device=dev)
    bc1 = 1 - torch.full((), spec.b1, dtype=torch.float32, device=dev) ** count_inc
    bc2 = 1 - torch.full((), spec.b2, dtype=torch.float32, device=dev) ** count_inc
    trigger = ((gnorm < spec.max_grad_norm).float() if spec.max_grad_norm > 0
               else torch.ones((), device=dev))
    # a Python number assigned into a CUDA tensor is a pageable host copy,
    # which waits for the stream: -lr enters through a fill instead
    neg_lr = torch.full((), -1 * schedule(count), dtype=torch.float32, device=dev)
    scal = torch.zeros(SCALARS, dtype=torch.float32, device=dev)
    for i, v in ((_S_GNORM, gnorm), (_S_TRIGGER, trigger), (_S_BC1, bc1), (_S_BC2, bc2),
                 (_S_NEG_LR, neg_lr)):
        scal[i] = v
    return scal


def fused_optimizer_apply(spec: OptimizerSpec, schedule: Schedule, named_params, state: AdamWState,
                          grads: list[torch.Tensor], tokens: torch.Tensor, *, norm_group=None):
    """One clip + AdamW step, in place on the parameters and ``state``.
    ``named_params``: (name, fp32 parameter) pairs; ``grads``: their fp32
    token-summed gradients, divided here IN PLACE by ``tokens`` (a
    one-element fp32 tensor).  Returns the global norm of the normalized
    gradients, a device tensor.  ``norm_group``: the process group whose
    ranks hold the other shards of these leaves (FSDP): the norm is the
    root of the float64 sums of squares all-reduced over it (the gradient
    pass's partial mode, then ``grad_norm_finish``)."""
    names, params = zip(*named_params)
    params = list(params)
    decay = [decay_mask(n, p) for n, p in zip(names, params)]
    table = None
    if params[0].device.type != "cpu":
        if state.table is None or state.table.ptrs[:, 0].tolist() != [p.data_ptr() for p in params]:
            state.table = leaf_table(grads, params, state.mu, state.nu, decay)
        table = state.table.with_grads(grads)
    if norm_group is None:
        gnorm = fused_grad_prep(grads, tokens, table=table)
    else:
        total = fused_grad_prep(grads, tokens, table=table, partial=True)
        torch.distributed.all_reduce(total, group=norm_group)
        gnorm = grad_norm_finish(total)
    scal = step_scalars(spec, schedule, state.count, gnorm)
    adamw_tree_apply(
        params, state.mu, state.nu, grads, scal, state.stats, b1=spec.b1, b2=spec.b2,
        eps=spec.eps, max_norm=spec.max_grad_norm, weight_decay=spec.weight_decay,
        decay=decay, table=table,
    )
    state.count += 1
    return gnorm
