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

from distributed_llms_example_tpu_torch.ops.flash_attention import _dropped, _keep, probs_dropout

NEG_INF = -1e9  # large-negative mask value; safe in both fp32 and bf16


def dot_product_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: torch.Tensor | None = None,
    *,
    scale: float | None = None,
    dtype: torch.dtype | None = None,
    dropout_rate: float = 0.0,
    dropout_seed: int | None = None,
) -> torch.Tensor:
    """Plain softmax attention; scores and softmax in fp32, the value
    product in ``dtype`` (default q's), as the JAX version computes it.

    ``dropout_rate`` > 0 (with an int32 ``dropout_seed``) applies inverted
    dropout to the probs.  The JAX package's plain route draws that mask
    with ``jax.random.bernoulli``, whose bits PyTorch cannot give; this
    route draws the flash kernels' mask instead (the counter hash of
    (seed, b, h, query, key), ``fused_dropout.attention_keep_mask``), so
    both routes of the port use one stream.  It materializes the (B, H, Q,
    K) mask, the cost the kernels' in-kernel draw avoids."""
    keep, inv = _keep(probs_dropout(dropout_rate, dropout_seed), q, k)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    dtype = dtype or q.dtype
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if bias is not None:
        scores = scores + bias.float()
    probs = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    probs = _dropped(probs / probs.sum(dim=-1, keepdim=True), keep, inv)
    return torch.matmul(probs.to(dtype), v.to(dtype))


def grouped_dot_product_attention(
    q5: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: torch.Tensor | None = None,
    *,
    scale: float | None = None,
    dtype: torch.dtype | None = None,
) -> torch.Tensor:
    """``dot_product_attention`` with a beam group folded next to the heads.

    ``q5`` (B, G, H, Q, d) attends the shared ``k``/``v`` (B, H, K, d):
    the einsum contracts without building the (B·G, H, K, d) repeat, so
    the K/V of a row are read once for all its beams.  The same arithmetic
    per element as ``dot_product_attention`` on repeated K/V: scores and
    softmax in fp32, the value product in ``dtype``.  ``bias`` is (B|1,
    1|H, Q, K): per row, like K/V, never per beam."""
    if scale is None:
        scale = q5.shape[-1] ** -0.5
    dtype = dtype or q5.dtype
    scores = torch.einsum("bghqd,bhkd->bghqk", q5.float(), k.float()) * scale
    if bias is not None:
        scores = scores + bias.float()[:, None]
    probs = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    probs = probs / probs.sum(dim=-1, keepdim=True)
    return torch.einsum("bghqk,bhkd->bghqd", probs.to(dtype), v.to(dtype))


def beam_grouped_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: torch.Tensor | None = None,
    *,
    scale: float | None = None,
    dtype: torch.dtype | None = None,
    learned_bias: torch.Tensor | None = None,
) -> torch.Tensor:
    """Beam-decode front end of ``grouped_dot_product_attention``: ``q``
    (B·G, H, Q, d) is the flat beam batch, ``k``/``v`` (B, H, K, d) are
    shared by the G beams of a row.  A per-beam ``bias`` (leading dim B·G)
    is stride-sliced to one row a group (the beams of a row share their
    mask); ``learned_bias`` (1, H, Q, K) is added on top.  Returns (B·G,
    H, Q, d)."""
    B = k.shape[0]
    G = q.shape[0] // B
    H, Q, d = q.shape[1], q.shape[2], q.shape[3]
    bb = None
    if bias is not None:
        bb = bias if bias.shape[0] in (1, B) else bias[::G]
    if learned_bias is not None:
        bb = learned_bias if bb is None else bb + learned_bias
    out = grouped_dot_product_attention(q.reshape(B, G, H, Q, d), k, v, bb, scale=scale,
                                        dtype=dtype)
    return out.reshape(B * G, H, Q, d)


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
