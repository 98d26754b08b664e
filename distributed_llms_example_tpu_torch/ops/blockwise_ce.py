"""Blockwise (vocab-chunked) cross entropy for large-vocab LM heads (port
of the JAX package's ``ops/blockwise_ce.py``).

The unfused causal loss materializes the (tokens, vocab) logits: at the
llama-2-7b recipe (8 x 1024 tokens x 32 000) 0.5 GB in bf16 plus 1 GB
in fp32, written and read again by the logsumexp, the gather and the
backward's softmax.  Here the LM head and the loss run chunk by chunk over
the vocab: a (tokens, block) tile of logits is made, reduced to per-row
scalars and dropped.

- **Residuals are per-chunk scalars**: the forward saves the per-chunk
  logsumexp rows (chunks, tokens) in fp32 beside its own inputs, no
  logits.
- **One recompute feeds both contractions**: the backward remakes each
  chunk's logits once and contracts the softmax term into dh (g @ w_c)
  and dw_c (gᵀ @ h).  The correct-class term (one gather of w's target
  rows, one scatter-add into dw's, a fixed-order reduction) and the
  label-smoothing term (rank 1) are applied outside the chunk loop.
- All-masked rows (``LABEL_PAD``) weigh 0 and produce no NaN.

Semantics are ``train/step.cross_entropy_sums``'s: (loss sum, unmasked
token count), so token weighting and accumulation compose alike.  The
chunk products take their operands in the compute dtype and give fp32
results accumulated in fp32 (``_mm32``, the JAX package's
``preferred_element_type=float32``): a chunk's logits are not rounded to
bf16 before the logsumexp and the target gather, as the unfused LM head's
are, and each chunk's dh and dw leave their product in fp32.  The
backward's softmax term enters its two products in the compute dtype, as
a default-precision dot takes it on a TPU.  Everything else runs in fp32.
The weight is the LM head's in PyTorch's layout, (vocab, hidden): a chunk is a
block of contiguous rows.  This is no kernel of the JAX package (it has
no ``pallas_call``): it is plain PyTorch on every device.
"""

from __future__ import annotations

import torch

from distributed_llms_example_tpu_torch.data.batching import LABEL_PAD


def pick_block(vocab: int, target: int = 4096) -> int:
    """The largest divisor of ``vocab`` that is <= ``target``: chunks tile
    the vocab exactly, so no chunk needs masking (llama's 32 000 -> 4 000,
    8 chunks)."""
    for b in range(min(target, vocab), 0, -1):
        if vocab % b == 0:
            return b
    return vocab


def _mm32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` as fp32, accumulated in fp32 from operands of one compute
    dtype.  A bf16 product is exact in fp32, so on the CPU, which has no
    mixed-dtype ``mm``, the operands are widened first."""
    if a.dtype == torch.float32:
        return a @ b
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


def _chunk_logits(hidden: torch.Tensor, w_c: torch.Tensor) -> torch.Tensor:
    return _mm32(hidden, w_c.t())


def _logz(lse: torch.Tensor) -> torch.Tensor:
    """The global logsumexp (N,) from the per-chunk rows (nc, N)."""
    m = lse.max(dim=0).values
    return m + torch.log(torch.exp(lse - m[None]).sum(dim=0))


class _BlockwiseCE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, hidden, w, labels, label_smoothing, blk):
        V = w.shape[0]
        mask = labels != LABEL_PAD
        targets = torch.where(mask, labels, torch.zeros_like(labels)).long()
        smooth_on = label_smoothing > 0.0
        lse, t_logit = [], torch.zeros(hidden.shape[0], dtype=torch.float32,
                                       device=hidden.device)
        logit_sum = torch.zeros_like(t_logit) if smooth_on else None
        for c0 in range(0, V, blk):
            lg = _chunk_logits(hidden, w[c0:c0 + blk])  # (N, blk) fp32
            m_c = lg.max(dim=-1).values
            lse.append(m_c + torch.log(torch.exp(lg - m_c[:, None]).sum(dim=-1)))
            # each target lives in exactly one chunk
            in_chunk = (targets >= c0) & (targets < c0 + blk)
            idx = (targets - c0).clamp(0, blk - 1)
            t = torch.gather(lg, 1, idx[:, None])[:, 0]
            t_logit = t_logit + torch.where(in_chunk, t, torch.zeros_like(t))
            if smooth_on:
                logit_sum = logit_sum + lg.sum(dim=-1)
        lse = torch.stack(lse)  # (nc, N)
        logz = _logz(lse)
        loss = logz - t_logit
        if smooth_on:
            # mean over the vocab of -log_softmax = logz - mean(logits)
            loss = (1.0 - label_smoothing) * loss + label_smoothing * (logz - logit_sum / V)
        maskf = mask.float()
        ctx.save_for_backward(hidden, w, targets, maskf, lse)
        ctx.label_smoothing, ctx.blk = label_smoothing, blk
        tokens = torch.sum(maskf)
        ctx.mark_non_differentiable(tokens)
        return torch.sum(loss * maskf), tokens

    @staticmethod
    def backward(ctx, d_lsum, _d_tokens):
        hidden, w, targets, maskf, lse = ctx.saved_tensors
        ls, blk = ctx.label_smoothing, ctx.blk
        V, D = w.shape
        logz = _logz(lse)
        scale = maskf * d_lsum  # (N,)
        dh = torch.zeros(hidden.shape, dtype=torch.float32, device=hidden.device)
        dw = torch.empty(V, D, dtype=torch.float32, device=w.device)
        for c0 in range(0, V, blk):
            w_c = w[c0:c0 + blk]
            # the one recompute, feeding both contractions
            g = torch.exp(_chunk_logits(hidden, w_c) - logz[:, None]) * scale[:, None]
            g = g.to(hidden.dtype)
            dh += _mm32(g, w_c)
            dw[c0:c0 + blk] = _mm32(g.t(), hidden)
        # the correct-class term: a gather of the target rows and a
        # scatter-add into them (the embedding backward: a fixed-order sum)
        coef = (1.0 - ls) * scale  # (N,)
        h32 = hidden.float()
        dh -= coef[:, None] * w[targets].float()
        dw -= torch.ops.aten.embedding_dense_backward(coef[:, None] * h32, targets, V, -1, False)
        if ls > 0.0:
            sm = ls / V
            dh -= (sm * scale)[:, None] * w.float().sum(dim=0)[None, :]
            dw -= sm * (scale[:, None] * h32).sum(dim=0)[None, :]
        return dh.to(hidden.dtype), dw.to(w.dtype), None, None, None


def blockwise_cross_entropy_sums(hidden: torch.Tensor, w: torch.Tensor, labels: torch.Tensor,
                                 label_smoothing: float = 0.0,
                                 block: int | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """(loss sum, token count) of next-token cross entropy without the
    logits.  ``hidden``: (N, D) pre-head activations (the caller flattens
    and shifts); ``w``: (V, D) LM-head weight in the compute dtype;
    ``labels``: (N,) ids, ``LABEL_PAD`` where masked.  Gradients reach
    ``hidden`` and ``w``; the count has none."""
    V = w.shape[0]
    blk = pick_block(V) if block is None else int(block)
    if V % blk:
        raise ValueError(f"block {blk} does not divide vocab {V}")
    if hidden.dtype != w.dtype:
        raise ValueError(f"hidden ({hidden.dtype}) and w ({w.dtype}) must share the compute dtype")
    return _BlockwiseCE.apply(hidden.contiguous(), w, labels, float(label_smoothing), blk)
