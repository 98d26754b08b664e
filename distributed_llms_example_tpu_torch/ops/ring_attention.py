"""Ring attention: exact attention over a sequence sharded across the
``sequence`` axis (port of the JAX package's ``ops/ring_attention.py``,
which writes it in ``jnp``; here in plain PyTorch, not a kernel).

- Q stays; K and V (and the K-only padding bias) rotate one hop a step
  around the ring (``parallel/activation.hop``: rank i sends its block to
  rank i - 1, so after t steps it holds the block that started on rank
  (i + t) mod n).  The next hop is posted before the current tile's
  compute, as the JAX package issues its ``ppermute`` early, and waited on
  after it.
- Each tile folds into an fp32 online-softmax state (max ``m``,
  denominator ``l``, accumulator ``acc``) with the global positions of the
  rank's queries and of the held keys, so the causal mask is exact across
  shard boundaries; under ``causal`` a tile strictly above the diagonal
  (its block started on a later rank) is skipped.
- Each step's update runs under ``torch.utils.checkpoint``, as the JAX
  package's under ``jax.checkpoint``: the backward recomputes the score
  tiles instead of keeping one a step.
- The backward of a hop sends the gradient of the received block back to
  the rank it came from (the transpose of the JAX package's ``ppermute``).
  A skipped tile still ties the held K/V into the state with a zero
  gradient, as the JAX package's ``lax.cond`` does: every rank then runs
  every hop's backward, and the ring's ranks meet in each one.

q/k/v are (batch, heads, seq, head_dim) LOCAL shards; ``bias`` is K-only
((batch|1, 1, 1, kv_block), a ``mask_to_bias`` padding mask, a constant).
Masking uses the finite NEG_INF, so a row whose keys are all masked gives
a near-uniform average of V (a padding query, which the loss masks).
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from distributed_llms_example_tpu_torch.ops.attention import NEG_INF
from distributed_llms_example_tpu_torch.ops.mm32 import mm32
from distributed_llms_example_tpu_torch.parallel.activation import hop


@dataclasses.dataclass(frozen=True)
class Ring:
    """The ring of one rank: its group over the ``sequence`` axis, the
    ring's size and this rank's index on it."""

    group: object
    size: int
    index: int


def _block_update(m, l, acc, q, k, v, bias, q_pos, k_pos, *, scale: float, causal: bool,
                  compute_dtype: torch.dtype | None = None):
    """One (q block x held kv block) tile folded into the running state
    (the JAX package's ``_block_update``): Q·Kᵀ and P·V from operands
    rounded to the compute dtype (default q's; bf16 on the tensor cores),
    each accumulated in fp32 and never rounded to bf16 (``ops/mm32``), the
    scores and the state in fp32.  q/k/v may come in fp32 (the ring keeps
    them so, for unrounded gradient sums)."""
    cd = compute_dtype or q.dtype
    s = mm32(q, k.transpose(-1, -2), cd) * scale
    if bias is not None:
        s = s + bias.float()
    if causal:
        s = torch.where(q_pos[:, None] >= k_pos[None, :], s, torch.full((), NEG_INF,
                                                                          device=s.device))
    m_next = torch.maximum(m, s.amax(dim=-1, keepdim=True))
    alpha = torch.exp(m - m_next)  # m starts at -inf; every mask is finite: no NaN
    p = torch.exp(s - m_next)
    l_next = l * alpha + p.sum(dim=-1, keepdim=True)
    pv = mm32(p, v, cd)
    return m_next, l_next, acc * alpha + pv


def _post_kv(ring: Ring, k: torch.Tensor, v: torch.Tensor, wire: torch.dtype):
    """Post the hop of the held K and V, packed into one buffer of the
    ``wire`` dtype (the inputs' own: their values are exact there),
    outside autograd: (the receive buffer, its work).  ``_Hop`` takes the
    buffer once the work is waited on."""
    return hop(torch.cat([k.detach().to(wire).reshape(-1), v.detach().to(wire).reshape(-1)]),
               ring.group, ring.size, ring.index)


class _Hop(torch.autograd.Function):
    """The K and V a hop received (``received``, from ``_post_kv``, its
    work waited on) as the autograd successors of the K and V sent: the
    forward copies them out of the buffer in the held dtype (the backend
    may have filled it by an in-place copy, which autograd must not see on
    its outputs); the backward sends their gradient, in that dtype, the
    other way round and waits."""

    @staticmethod
    def forward(ctx, ring: Ring, k, v, received):
        ctx.ring, ctx.shapes = ring, (k.shape, v.shape)
        n = k.numel()
        return (received[:n].view(k.shape).to(k.dtype, copy=True),
                received[n:].view(v.shape).to(v.dtype, copy=True))

    @staticmethod
    def backward(ctx, dk, dv):
        ring = ctx.ring
        flat, work = hop(torch.cat([dk.reshape(-1), dv.reshape(-1)]), ring.group, ring.size,
                         ring.index, reverse=True)
        work.wait()
        n = dk.numel()
        return None, flat[:n].view(ctx.shapes[0]), flat[n:].view(ctx.shapes[1]), None


class _Skip(torch.autograd.Function):
    """A skipped tile: the state as it was, and a zero gradient for the
    held K and V (the identity branch of the JAX package's ``lax.cond``)."""

    @staticmethod
    def forward(ctx, m, l, acc, k, v):
        ctx.kv = (k.shape, k.dtype, v.shape, v.dtype, k.device)
        return m.view_as(m), l.view_as(l), acc.view_as(acc)

    @staticmethod
    def backward(ctx, dm, dl, dacc):
        ks, kd, vs, vd, dev = ctx.kv
        return (dm, dl, dacc, torch.zeros(ks, dtype=kd, device=dev),
                torch.zeros(vs, dtype=vd, device=dev))


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   bias: torch.Tensor | None = None, *, ring: Ring, causal: bool = False,
                   scale: float | None = None, dtype: torch.dtype | None = None) -> torch.Tensor:
    """Exact attention of this rank's queries over the whole ring's keys.
    ``causal`` needs equal blocks (q and kv lengths equal, top-left
    aligned).  Returns (batch, heads, q_block, head_dim) in ``dtype``
    (default: q's)."""
    from torch.utils.checkpoint import checkpoint

    if scale is None:
        scale = q.shape[-1] ** -0.5
    b, h, q_blk, d = q.shape
    kv_blk = k.shape[2]
    if causal and q_blk != kv_blk:
        raise ValueError(f"causal ring attention needs equal blocks, got q={q_blk} kv={kv_blk}")
    n, idx, dev = ring.size, ring.index, q.device
    # the products round to the inputs' dtype; q, k and v ride the tiles in
    # fp32, so each one's gradient sums over the tiles (and comes back over
    # the hops) unrounded, and is rounded once, at this function's inputs;
    # the hops carry K and V in the inputs' dtype
    compute, wire = q.dtype, k.dtype
    q, k, v = q.float(), k.float(), v.float()
    q_pos = idx * q_blk + torch.arange(q_blk, device=dev)
    m = torch.full((b, h, q_blk, 1), -torch.inf, dtype=torch.float32, device=dev)
    l = torch.zeros((b, h, q_blk, 1), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, h, q_blk, d), dtype=torch.float32, device=dev)
    update = functools.partial(_block_update, scale=scale, causal=causal,
                               compute_dtype=compute)
    for t in range(n):
        pending: list = []
        if t < n - 1:  # the next hop first: it travels while this tile computes
            received, work = _post_kv(ring, k, v, wire)
            pending.append(work)
            if bias is not None:
                nb, work = hop(bias.contiguous().reshape(-1), ring.group, n, idx)
                pending.append(work)
        src = (idx + t) % n
        if causal and src > idx:  # equal blocks: the whole tile is above the diagonal
            m, l, acc = _Skip.apply(m, l, acc, k, v)
        else:
            k_pos = src * kv_blk + torch.arange(kv_blk, device=dev)
            m, l, acc = checkpoint(update, m, l, acc, q, k, v, bias, q_pos, k_pos,
                                   use_reentrant=False)
        for work in pending:
            work.wait()
        if t < n - 1:
            k, v = _Hop.apply(ring, k, v, received)
            if bias is not None:
                bias = nb.view(bias.shape)
    # l >= 1: every rank folds its diagonal tile, whose running max gives exp(0)
    return (acc / l).to(dtype or compute)


def ring_attention_sharded(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           bias: torch.Tensor | None, *, parallel, causal: bool = False,
                           scale: float | None = None,
                           dtype: torch.dtype | None = None) -> torch.Tensor:
    """The attention module's front door: this rank's shards (its rows,
    its tensor rank's heads, its sequence block) through ``ring_attention``
    over ``parallel``'s sequence ring (``parallel/activation.ModelParallel``).
    The bias must be K-only."""
    if bias is not None and (bias.shape[1] != 1 or bias.shape[2] != 1):
        raise ValueError(f"ring attention needs a K-only bias (b|1, 1, 1, K); got "
                         f"{tuple(bias.shape)}")
    ring = Ring(parallel.sequence_group, parallel.sequence, parallel.sequence_index)
    return ring_attention(q, k, v, bias, ring=ring, causal=causal, scale=scale, dtype=dtype)
