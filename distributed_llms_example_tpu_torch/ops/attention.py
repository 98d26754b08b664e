"""Attention core shared by the model families (port of the JAX package's
``ops/attention.py``).

Conventions: q/k/v are (batch, heads, q_len/kv_len, head_dim); ``bias`` is
additive, broadcastable to (batch, heads, q_len, kv_len) and already
encodes masking as large negative values.  This is the plain path — the
counterpart of the JAX package's XLA attention; the hand-written kernels
live in ``ops/flash_attention.py``.
"""

from __future__ import annotations

import torch

NEG_INF = -1e9  # large-negative mask value; safe in both fp32 and bf16


def dot_product_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: torch.Tensor | None = None,
    *,
    scale: float | None = None,
    dtype: torch.dtype | None = None,
) -> torch.Tensor:
    """Plain softmax attention; scores and softmax in fp32, the value
    product in ``dtype`` (default q's), as the JAX version computes it."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    dtype = dtype or q.dtype
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if bias is not None:
        scores = scores + bias.float()
    probs = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    probs = probs / probs.sum(dim=-1, keepdim=True)
    return torch.matmul(probs.to(dtype), v.to(dtype))


def make_causal_bias(q_len: int, kv_len: int, *, device: torch.device | str = "cpu") -> torch.Tensor:
    """(1, 1, q_len, kv_len) additive causal mask (query i sees keys <= i)."""
    q_pos = torch.arange(q_len, device=device)[:, None]
    kv_pos = torch.arange(kv_len, device=device)[None, :]
    zero = torch.zeros((), device=device)
    return torch.where(q_pos >= kv_pos, zero, torch.full((), NEG_INF, device=device))[None, None]


def mask_to_bias(attention_mask: torch.Tensor) -> torch.Tensor:
    """(batch, kv_len) {0,1} padding mask → (batch, 1, 1, kv_len) fp32 bias."""
    zero = torch.zeros((), device=attention_mask.device)
    neg = torch.full((), NEG_INF, device=attention_mask.device)
    return torch.where(attention_mask[:, None, None, :] > 0, zero, neg)
