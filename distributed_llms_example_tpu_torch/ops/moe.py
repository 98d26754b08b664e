"""Mixture-of-experts MLP, Mixtral-style (port of the JAX package's
``ops/moe.py``).

Every routing decision is the JAX layer's, so the two agree token for
token:

- tokens are flattened row-major from (batch, seq) and routed in groups of
  ``group_size`` (g = min(group_size, n)); the last group's padding is
  excluded from routing, while attention-pad tokens are not (they claim
  capacity and enter the auxiliary loss, as in the JAX layer);
- the router runs in fp32 on the tokens cast to fp32, then a softmax and
  top-k; for k > 1 the chosen gates are renormalized to sum to 1;
- each expert takes ``capacity`` tokens a group: g when ``no_drop`` (every
  cached pass) or ``capacity_factor <= 0``, else
  ``max(1, ceil(K·g/E·factor))``; a token's slot is its in-group cumsum,
  and every k-th choice queues behind all (k−1)-th choices of its group;
  a token past capacity is dropped (its output is 0, the block's residual
  carries it);
- the load-balancing loss is E · Σ_e frac_e · mean_prob_e over the valid
  tokens, ``frac`` counting every top-k assignment before capacity.  It is
  an explicit output, ``(out, aux)``, so it passes through activation
  checkpointing and FSDP units as any other value;
- in a bf16 run the gate weights are rounded to the compute dtype before
  the combine, where the JAX layer rounds them.

Over ranks that split the batch's rows (``data`` and ``fsdp``: a rank
holds one contiguous stretch of the global row-major token order), the
JAX layer still routes the global batch under ``jit``.  A layer given its
``BatchShards`` (``attach_batch_shards``) routes as it does: groups of
g = min(group_size, global n) that may span ranks, each rank's token at
its global place in its group; the per-(group, k-th choice, expert)
counts of the assignments before capacity all-gathered (no gradient) over
the batch-shard group, so a rank's cumsum slot starts behind what the
earlier choices of every rank and the earlier ranks' same choice took in
that group, against the global group's capacity; and the aux loss
returned as the rank's share E · Σ frac · (Σ_own probs) / N_global, with
``frac`` from the summed counts, which is linear in the rank's own
probabilities and sums over the ranks to the JAX layer's term.  Each
expert is applied per token, so a rank dispatches only its own kept
tokens.  A cached pass (``no_drop``) drops nothing and needs no exchange.
One rank takes the same path alone (``LOCAL``: its groups its own, its
counts not gathered), which gives the single-rank routing bit for bit.

The JAX layer expresses dispatch and combine as einsums against a one-hot
(groups, g, E, capacity) tensor, the TPU's static-shape device.  Here each
(token, k) pair's slot in a (groups, E·capacity + 1, d) buffer is computed
from the same cumsum, the kept tokens are scattered there (a dropped one
into the last, discarded row), the experts run as one batched matmul
each over the E stacked weights, and the outputs are gathered back,
weighted by the gates.  Every shape is static: no ``nonzero``, no boolean
indexing, no host read, so the layer runs on the ``meta`` device (the FLOP
gauge, ``obs/gauges.py``) and the capacity-padded expert matmuls are the
FLOPs counted.  The expert products are matmuls outside any TPU kernel in
the JAX package as well (plain ``jnp.einsum``), so they run as library
matmuls here.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any

import torch
import torch.nn.functional as F
from torch import nn

from distributed_llms_example_tpu_torch.ops.dense import Dense

# tokens routed together (GShard's group): the JAX layer's default
GROUP_SIZE = 4096


def expert_capacity(g: int, num_experts: int, top_k: int, capacity_factor: float,
                    no_drop: bool) -> int:
    """Slots an expert has in a group of ``g`` tokens (the JAX layer's rule)."""
    if no_drop or capacity_factor <= 0:
        return g
    return max(1, math.ceil(top_k * g / num_experts * capacity_factor))


@dataclasses.dataclass(frozen=True)
class BatchShards:
    """The ranks that split the batch's rows (data x fsdp): their process
    group (None: the default group), their number and this rank's index,
    which is its place in the global row order."""

    group: Any
    size: int
    index: int


# a rank that routes its own tokens alone
LOCAL = BatchShards(None, 1, 0)


class MoEMLP(nn.Module):
    """Top-k routed SwiGLU experts with stacked weights: ``router`` (a
    bias-free fp32 ``Dense`` of d → E), ``gate_proj`` and ``up_proj`` of
    shape (E, d, ff), ``down_proj`` of shape (E, ff, d) (the flax leaves'
    names and layouts).  ``forward`` returns ``(out, aux)``."""

    def __init__(self, hidden_size: int, intermediate_size: int, num_experts: int, *,
                 top_k: int = 2, capacity_factor: float = 1.25, group_size: int = GROUP_SIZE,
                 dtype: torch.dtype = torch.float32, param_dtype: torch.dtype = torch.float32,
                 device=None):
        super().__init__()
        self.num_experts, self.top_k = num_experts, top_k
        self.capacity_factor, self.group_size = capacity_factor, group_size
        self.dtype = dtype
        self.router = Dense(hidden_size, num_experts, use_bias=False, dtype=torch.float32,
                            param_dtype=param_dtype, device=device)

        def stack(i, o):
            return nn.Parameter(torch.empty(num_experts, i, o, dtype=param_dtype, device=device))

        self.gate_proj = stack(hidden_size, intermediate_size)
        self.up_proj = stack(hidden_size, intermediate_size)
        self.down_proj = stack(intermediate_size, hidden_size)
        # the batch-shard ranks the layer routes across (attach_batch_shards)
        self.batch_shards: BatchShards | None = None

    def place(self, x: torch.Tensor, no_drop: bool = False):
        """The (b, s, d) ``x`` at its places in the routing groups:
        (tokens (G, g, d) in the compute dtype, valid (G, g), capacity, the
        exchange of the counts (``_exchange``), the place of the rank's
        first token).  Over batch shards the groups are the global batch's
        that hold the rank's tokens, the other ranks' places invalid (they
        claim no slot); alone (no shards, or a cached pass) the shards are
        ``LOCAL`` and the groups the rank's own, the last one padded."""
        b, s, d = x.shape
        n = b * s
        shards = self.batch_shards if self.batch_shards is not None and not no_drop else LOCAL
        total = n * shards.size  # every rank holds as many rows of one width
        g = min(self.group_size, total)
        lo = shards.index * n
        first = lo // g
        G = (lo + n - 1) // g - first + 1
        at = lo - first * g  # the rank's first token in its first group
        tokens = x.new_zeros(G * g, d, dtype=self.dtype)
        tokens[at:at + n] = x.reshape(n, d).to(self.dtype)
        valid = torch.zeros(G * g, dtype=torch.float32, device=x.device)
        valid[at:at + n] = 1.0
        cap = expert_capacity(g, self.num_experts, self.top_k, self.capacity_factor, no_drop)
        exchange = functools.partial(_exchange, shards=shards, n=n, groups=-(-total // g),
                                     first=first)
        return tokens.reshape(G, g, d), valid.reshape(G, g), cap, exchange, at

    def route(self, tokens: torch.Tensor, valid: torch.Tensor, capacity: int, exchange):
        """The routing of (G, g, d) ``tokens``: (slot index (G, g·K) into
        the (E·capacity + 1)-row buffer, the last row for a dropped choice;
        combine weights (G, g, K), 0 for a dropped choice; aux).
        ``exchange`` (``_exchange``): for each (group, choice k) the slots
        taken before this rank's tokens, and the aux terms of the global
        batch."""
        E, K = self.num_experts, self.top_k
        probs = torch.softmax(self.router(tokens.float()), dim=-1)  # (G, g, E), fp32
        gate_vals, expert_idx = torch.topk(probs, K, dim=-1)  # (G, g, K)
        if K > 1:
            gate_vals = gate_vals / gate_vals.sum(dim=-1, keepdim=True)
        experts = torch.arange(E, device=tokens.device)
        masks = [(expert_idx[..., k, None] == experts).float() * valid[..., None]  # (G, g, E)
                 for k in range(K)]
        base, frac, n_real = exchange(torch.stack([m.sum(dim=1) for m in masks], dim=1))
        slots, kept = [], []
        for k, mask_k in enumerate(masks):
            pos_k = torch.cumsum(mask_k, dim=1) - mask_k + base[:, k, None, :]
            mask_k = mask_k * (pos_k < capacity)
            keep = mask_k.sum(dim=-1)  # (G, g): 1 where the choice holds a slot
            slot = (pos_k * mask_k).sum(dim=-1)
            index = expert_idx[..., k] * capacity + slot.long()
            slots.append(torch.where(keep > 0, index, E * capacity))
            kept.append(keep)
        # load balance over the real tokens: frac counts every pre-capacity
        # assignment (it sums to K); mean_prob sums this rank's probabilities
        # only, so over shards aux is this rank's share
        mean_prob = (probs * valid[..., None]).sum(dim=(0, 1)) / n_real
        aux = E * torch.sum(frac * mean_prob)
        index = torch.stack(slots, dim=-1).reshape(tokens.shape[0], -1)  # (G, g·K)
        combine = gate_vals * torch.stack(kept, dim=-1)
        return index, combine, aux

    def forward(self, x: torch.Tensor, no_drop: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
        """(out (b, s, d) in the compute dtype, the fp32 scalar aux loss:
        over batch shards, this rank's share of it).  ``no_drop`` sizes
        capacity at the group size, so no token drops: every cached pass
        (prefill, decode, verify) routes so."""
        b, s, d = x.shape
        tokens, valid, cap, exchange, at = self.place(x, no_drop)
        index, combine, aux = self.route(tokens, valid, cap, exchange)
        out = self._experts(tokens, index, combine, cap)[at:at + b * s]
        return out.reshape(b, s, d), aux

    def _experts(self, tokens: torch.Tensor, index: torch.Tensor, combine: torch.Tensor,
                 cap: int) -> torch.Tensor:
        """The routed (G, g, d) ``tokens`` through their experts, weighted
        and combined: (G·g, d) in the compute dtype."""
        G, g, d = tokens.shape
        E, K = self.num_experts, self.top_k
        # dispatch: each kept (token, k) into its expert's slot; dropped ones
        # all land in the discarded last row
        src = tokens[:, :, None, :].expand(G, g, K, d).reshape(G, g * K, d)
        at = index[..., None].expand(G, g * K, d)
        buf = tokens.new_zeros(G, E * cap + 1, d).scatter(1, at, src)
        expert_in = buf[:, : E * cap].reshape(G, E, cap, d).transpose(0, 1).reshape(E, G * cap, d)
        w_gate, w_up, w_down = (w.to(self.dtype) for w in (self.gate_proj, self.up_proj,
                                                            self.down_proj))
        h = F.silu(torch.bmm(expert_in, w_gate)) * torch.bmm(expert_in, w_up)
        expert_out = torch.bmm(h, w_down)  # (E, G·cap, d)
        expert_out = expert_out.reshape(E, G, cap, d).transpose(0, 1).reshape(G, E * cap, d)
        expert_out = torch.cat([expert_out, expert_out.new_zeros(G, 1, d)], dim=1)

        # combine: the K outputs of each token, weighted by its gates (rounded
        # to the compute dtype first, as the JAX layer rounds its combine
        # tensor), summed in fp32 and rounded once
        picked = expert_out.gather(1, at).reshape(G, g, K, d)
        weights = combine.to(self.dtype).float()[..., None]
        out = (weights * picked.float()).sum(dim=2).to(self.dtype)
        return out.reshape(G * g, d)


@torch.no_grad()
def _exchange(own: torch.Tensor, *, shards: BatchShards, n: int, groups: int, first: int):
    """The batch shards' counts, all-gathered (one rank: its own): for this
    rank's groups, ``base`` (G_loc, K, E), the slots the earlier choices of
    every rank and the same choice of earlier ranks take first; ``frac``
    (E,), every rank's assignments before capacity over the global token
    count; and that count.  ``own`` (G_loc, K, E) sits at global groups
    ``first``..; the rank's token count ``n`` rides along, and ranks that
    disagree on it raise."""
    G_loc, K, E = own.shape
    mine = own.new_zeros(groups * K * E + 1)
    mine[first * K * E:(first + G_loc) * K * E] = own.reshape(-1)
    mine[-1] = n
    every = mine[None]
    if shards.size > 1:
        parts = [torch.empty_like(mine) for _ in range(shards.size)]
        torch.distributed.all_gather(parts, mine, group=shards.group)
        every = torch.stack(parts)  # (R, G·K·E + 1)
        if bool((every[:, -1] != n).any()):
            raise ValueError(f"MoE routing across batch shards needs as many tokens on every "
                             f"rank; got {every[:, -1].tolist()}")
    counts = every[:, :-1].reshape(shards.size, groups, K, E)
    here = counts[:, first:first + G_loc]  # (R, G_loc, K, E)
    whole = here.sum(dim=0)  # every rank's assignments in these groups
    base = (torch.cumsum(whole, dim=1) - whole) + here[:shards.index].sum(dim=0)
    n_real = float(n * shards.size)
    return base, counts.sum(dim=(0, 1, 2)) / n_real, n_real


def attach_batch_shards(model: nn.Module, shards: BatchShards | None) -> None:
    """Route every MoE layer of ``model`` across ``shards`` (None: each
    rank alone)."""
    for m in model.modules():
        if isinstance(m, MoEMLP):
            m.batch_shards = shards


def batch_shards_of(model: nn.Module) -> BatchShards | None:
    """The batch shards ``model``'s MoE layers route across (None)."""
    return next((m.batch_shards for m in model.modules() if isinstance(m, MoEMLP)), None)
