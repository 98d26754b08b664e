"""The train step (port of the JAX package's ``train/step.py``, one device).

- ``cross_entropy_sums``: token-summed cross entropy (optional label
  smoothing) and the count of unmasked tokens, fp32;
- ``seq2seq_loss_sums``: teacher-forced decoder on ``shift_right(labels)``
  (BART and T5 alike; ``shift_right`` lives in ``models/t5.py``, as in the
  JAX package);
- ``train_step``: the batch's rows split into ``grad_accum_steps``
  microbatches (row r joins microbatch r mod N, as in the JAX package),
  loss and gradient SUMS accumulated over them, then ONE optimizer apply
  (``optimizer_apply_block``): normalize by tokens and take the global
  norm, then clip + AdamW, through the fused kernels.  Any grouping gives
  the same step, since the sums are additive over rows.

Dropout seeds come from the caller's CPU generator (``dropout_seeds``), so
the step draws no random number on the device and waits on nothing.
"""

from __future__ import annotations

import contextlib

import torch

from distributed_llms_example_tpu_torch.data.batching import LABEL_PAD
from distributed_llms_example_tpu_torch.models.t5 import shift_right
from distributed_llms_example_tpu_torch.ops.fused_dropout import dropout_seeds
from distributed_llms_example_tpu_torch.train.optim import (
    AdamWState,
    OptimizerSpec,
    Schedule,
    fused_optimizer_apply,
)


def cross_entropy_sums(logits: torch.Tensor, labels: torch.Tensor,
                       label_smoothing: float = 0.0) -> tuple[torch.Tensor, torch.Tensor]:
    """(sum of token losses, number of unmasked tokens); fp32 accumulation."""
    mask = (labels != LABEL_PAD).float()
    targets = torch.where(labels == LABEL_PAD, torch.zeros_like(labels), labels).long()
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    true_logit = torch.gather(logits, -1, targets[..., None])[..., 0]
    loss = logz - true_logit
    if label_smoothing > 0.0:
        smooth = -torch.mean(torch.log_softmax(logits, dim=-1), dim=-1)
        loss = (1.0 - label_smoothing) * loss + label_smoothing * smooth
    return torch.sum(loss * mask), torch.sum(mask)


def seq2seq_loss_sums(model, batch: dict, label_smoothing: float = 0.0):
    """Loss sums of one (micro)batch of input_ids / attention_mask / labels."""
    cfg = model.config
    labels = batch["labels"]
    dec_in = shift_right(labels, cfg.decoder_start_token_id, cfg.pad_token_id)
    logits = model(batch["input_ids"], batch["attention_mask"], dec_in)
    return cross_entropy_sums(logits, labels, label_smoothing)


def optimizer_apply_block(spec: OptimizerSpec, schedule: Schedule, named_params,
                          state: AdamWState, lsum: torch.Tensor, tokens: torch.Tensor) -> dict:
    """The once-per-step tail: normalize the token-weighted sums (the
    gradients in place in ``.grad``) and take their norm, clip + AdamW,
    metrics.  Every metric but the learning rate is a device tensor."""
    tokens = torch.clamp(tokens, min=1.0)
    grads = []
    for _, p in named_params:
        if p.grad is None:
            p.grad = torch.zeros_like(p, dtype=torch.float32)
        grads.append(p.grad)
    lr = schedule(state.count)
    grad_norm = fused_optimizer_apply(spec, schedule, named_params, state, grads, tokens)
    return {"loss": lsum / tokens, "learning_rate": lr, "grad_norm": grad_norm,
            "target_tokens": tokens}


def train_step(model, named_params, state: AdamWState, spec: OptimizerSpec, schedule: Schedule,
               batch: dict, *, grad_accum_steps: int = 1, label_smoothing: float = 0.0,
               generator: torch.Generator | None = None) -> dict:
    """One optimizer step on ``batch`` (tensors on the model's device).
    ``generator`` (CPU) seeds the dropout of a model in training mode."""
    n = int(grad_accum_steps)
    rows = batch["labels"].shape[0]
    if n < 1 or rows % n:
        raise ValueError(f"global batch {rows} is not divisible by grad_accum_steps={n}")
    for _, p in named_params:
        p.grad = None
    lsum = tokens = None
    seeds = dropout_seeds(generator) if generator is not None else contextlib.nullcontext()
    with seeds:
        for i in range(n):
            micro = {k: v[i::n] for k, v in batch.items()} if n > 1 else batch
            ls, tk = seq2seq_loss_sums(model, micro, label_smoothing)
            ls.backward()
            ls = ls.detach()
            lsum, tokens = (ls, tk) if lsum is None else (lsum + ls, tokens + tk)
    return optimizer_apply_block(spec, schedule, named_params, state, lsum, tokens)
