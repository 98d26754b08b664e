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

import math

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

    def route(self, tokens: torch.Tensor, valid: torch.Tensor, capacity: int):
        """The routing of (G, g, d) ``tokens``: (slot index (G, g·K) into
        the (E·capacity + 1)-row buffer, the last row for a dropped choice;
        combine weights (G, g, K), 0 for a dropped choice; aux)."""
        E, K = self.num_experts, self.top_k
        probs = torch.softmax(self.router(tokens.float()), dim=-1)  # (G, g, E), fp32
        gate_vals, expert_idx = torch.topk(probs, K, dim=-1)  # (G, g, K)
        if K > 1:
            gate_vals = gate_vals / gate_vals.sum(dim=-1, keepdim=True)
        experts = torch.arange(E, device=tokens.device)
        counts = torch.zeros(tokens.shape[0], E, dtype=torch.float32, device=tokens.device)
        slots, kept = [], []
        for k in range(K):
            mask_k = (expert_idx[..., k, None] == experts).float() * valid[..., None]  # (G, g, E)
            pos_k = torch.cumsum(mask_k, dim=1) - mask_k + counts[:, None, :]
            counts = counts + mask_k.sum(dim=1)
            mask_k = mask_k * (pos_k < capacity)
            keep = mask_k.sum(dim=-1)  # (G, g): 1 where the choice holds a slot
            slot = (pos_k * mask_k).sum(dim=-1)
            index = expert_idx[..., k] * capacity + slot.long()
            slots.append(torch.where(keep > 0, index, E * capacity))
            kept.append(keep)
        # load balance over the real tokens: counts holds every pre-capacity
        # (valid) assignment, so frac sums to K
        n_real = torch.clamp(valid.sum(), min=1.0)
        frac = counts.sum(dim=0) / n_real
        mean_prob = (probs * valid[..., None]).sum(dim=(0, 1)) / n_real
        aux = E * torch.sum(frac * mean_prob)
        index = torch.stack(slots, dim=-1).reshape(tokens.shape[0], -1)  # (G, g·K)
        combine = gate_vals * torch.stack(kept, dim=-1)
        return index, combine, aux

    def forward(self, x: torch.Tensor, no_drop: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
        """(out (b, s, d) in the compute dtype, the fp32 scalar aux loss).
        ``no_drop`` sizes capacity at the group size, so no token drops:
        every cached pass (prefill, decode, verify) routes so."""
        b, s, d = x.shape
        E, K = self.num_experts, self.top_k
        n = b * s
        g = min(self.group_size, n)
        G = -(-n // g)
        tokens = x.reshape(n, d).to(self.dtype)
        if G * g > n:
            tokens = F.pad(tokens, (0, 0, 0, G * g - n))
        tokens = tokens.reshape(G, g, d)
        valid = (torch.arange(G * g, device=x.device) < n).float().reshape(G, g)
        cap = expert_capacity(g, E, K, self.capacity_factor, no_drop)
        index, combine, aux = self.route(tokens, valid, cap)

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
        return out.reshape(G * g, d)[:n].reshape(b, s, d), aux
