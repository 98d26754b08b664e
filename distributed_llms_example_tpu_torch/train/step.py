"""The train step (port of the JAX package's ``train/step.py``).

- ``cross_entropy_sums``: token-summed cross entropy (optional label
  smoothing) and the count of unmasked tokens, fp32;
- ``seq2seq_loss_sums``: teacher-forced decoder on ``shift_right(labels)``
  (BART and T5 alike; ``shift_right`` lives in ``models/t5.py``, as in the
  JAX package);
- ``causal_loss_sums``: decoder-only next-token loss, position t's logits
  against ``labels[t + 1]``; under the config's ``fused_ce`` the final
  hidden states and the LM head go through the vocab-chunked
  ``ops/blockwise_ce.py`` (no logits materialized), as the JAX package's
  ``make_loss_fn`` does, and a MoE model's load-balancing loss joins the
  sum when its config weighs it;
- ``train_step``: the batch's rows split into ``grad_accum_steps``
  microbatches (row r joins microbatch r mod N, as in the JAX package),
  loss and gradient SUMS accumulated over them, then ONE optimizer apply
  (``optimizer_apply_block``): normalize by tokens and take the global
  norm, then clip + AdamW, through the fused kernels.  Any grouping gives
  the same step, since the sums are additive over rows.

Dropout seeds come from the caller's CPU generator (``dropout_seeds``), so
the step draws no random number on the device and waits on nothing.

Over a process group (``StepGroups``) each rank runs its rows of the
global batch.  Its loss and token sums are all-reduced (SUM) before the
division, so ``loss`` and ``target_tokens`` are global, as the JAX
package's are.  The gradient sums meet once a step, after the last
microbatch: sharded (FSDP, ``parallel/fsdp.py``) they are reduce-scattered
in the backward, the earlier microbatches' sync turned off; replicated
(``data`` only) they are all-reduced here in coalesced buckets, as the
reference's hand-rolled all-reduce and the JAX package's psum.  Kernel 8
then runs over the rank's shards, its norm summed over the ``fsdp`` axis.

On a model-parallel mesh (``tensor`` or ``sequence`` above 1) the sums
meet over the ranks that hold other rows or other positions of the same
shards (``StepGroups.row_group``: data x sequence, or data alone when the
batch is not sequence-sharded), never over ``tensor``, whose ranks hold
the same rows: the loss and token sums and every gradient (a replicated
leaf's and a tensor rank's shard alike).  Kernel 8's float64 partial norm
is then summed over the tensor group, each replicated leaf counted on
tensor rank 0 only, and so are the health sums.  A sequence-sharded batch
carries its shard's ``positions`` and its labels already shifted across
the shard boundaries (``parallel/activation.split_sequence``), so the
loss compares every position with its label.

Health numerics (``train_step(..., health_buckets=...)``): the global param norm,
the non-finite gradient count and per-bucket update ratios ||Δw|| / ||w||
(``HEALTH_BUCKETS``: embed, attn, mlp, head), assembled by
``health_metrics_from_stats`` from fused AdamW's per-leaf sums
(``AdamWState.stats``), as device tensors: the watchdog (``obs/health.py``)
reads them at the logging cadence.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any

import torch

from torch import nn

from distributed_llms_example_tpu_torch.data.batching import LABEL_PAD
from distributed_llms_example_tpu_torch.models.bart import _Embed
from distributed_llms_example_tpu_torch.models.t5 import shift_right
from distributed_llms_example_tpu_torch.obs.devprof import scope
from distributed_llms_example_tpu_torch.ops.blockwise_ce import blockwise_cross_entropy_sums
from distributed_llms_example_tpu_torch.ops.fused_dropout import dropout_seeds
from distributed_llms_example_tpu_torch.ops.fused_optim import (
    STAT_NONFINITE,
    STAT_P_SUMSQ,
    STAT_U_SUMSQ,
)
from distributed_llms_example_tpu_torch.ops.moe import batch_shards_of
from distributed_llms_example_tpu_torch.parallel.fsdp import local
from distributed_llms_example_tpu_torch.train.optim import (
    AdamWState,
    OptimizerSpec,
    Schedule,
    fused_optimizer_apply,
)


# Coarse parameter buckets for the per-bucket update ratio (the JAX
# package's ``HEALTH_BUCKETS``): four buckets are the resolution operators
# act on.
HEALTH_BUCKETS = ("embed", "attn", "mlp", "head")

# The per-step scalars a health-enabled step adds to its metrics.
HEALTH_METRIC_KEYS: tuple[str, ...] = ("param_norm", "nonfinite_count") + tuple(
    f"update_ratio_{b}" for b in HEALTH_BUCKETS)

# The port's copy of the JAX package's ``analysis/ir_lint.py``
# ``MODULE_BUCKET_PATTERNS``.  Ordered: first match wins; head before embed
# (an lm_head tied to the embedding table must not read as embed), embed
# before attn/mlp.
MODULE_BUCKET_PATTERNS: tuple[tuple[str, tuple[str, ...]], ...] = (
    ("head", ("lm_head", "logits")),
    ("embed", ("embed", "shared", "wte", "wpe")),
    ("attn", ("attn", "attention")),
    ("mlp", ("mlp", "ffn", "feed_forward", "densereludense", "fc1", "fc2")),
)


def bucket_of_path(path: str) -> str:
    """The bucket of one parameter path: the first pattern any of whose
    needles the lower-cased path contains; unmatched leaves (norms,
    biases) fall to ``mlp``, since a parameter bucket must be total."""
    p = path.lower()
    for bucket, needles in MODULE_BUCKET_PATTERNS:
        if any(n in p for n in needles):
            return bucket
    return "mlp"


def param_buckets(model: nn.Module) -> torch.Tensor:
    """Each parameter's ``HEALTH_BUCKETS`` index, in ``named_parameters``
    order, as an int64 tensor on the model's device.  An embedding table's
    path ends in ``embedding``, as the flax tree names its leaf, so every
    parameter lands in its JAX counterpart's bucket (T5's relative-position
    table among the embeddings)."""
    tables = {name for name, m in model.named_modules() if isinstance(m, _Embed)}
    out = []
    for name, p in model.named_parameters():
        owner = name.rpartition(".")[0]
        out.append(HEALTH_BUCKETS.index(bucket_of_path(
            f"{owner}.embedding" if owner in tables else name)))
    return torch.tensor(out, dtype=torch.int64, device=p.device)


def health_metrics_from_stats(stats: torch.Tensor,
                              buckets: torch.Tensor) -> dict[str, torch.Tensor]:
    """The health numerics from fused AdamW's (N, STATS) float64 per-leaf
    sums (``buckets[i]``: leaf i's ``HEALTH_BUCKETS`` index, on the same
    device): the global param norm, the non-finite gradient count, and per
    bucket ||update|| / ||param|| (0 for an empty bucket).  Summed in
    float64 (a fixed-order reduction, no atomics; a non-finite leaf
    reaches its own bucket only), returned as fp32 device tensors; nothing
    waits on the device."""
    ids = torch.arange(len(HEALTH_BUCKETS), device=stats.device)
    member = (buckets[None, :] == ids[:, None])[:, :, None]  # (buckets, N, 1)
    sums = torch.where(member, stats[None], 0.0).sum(dim=1)  # (buckets, STATS)
    p_sq, u_sq = sums[:, STAT_P_SUMSQ], sums[:, STAT_U_SUMSQ]
    ratio = torch.sqrt(u_sq) / torch.clamp(torch.sqrt(p_sq), min=1e-12)
    out = {"param_norm": torch.sqrt(p_sq.sum()).float(),
           "nonfinite_count": stats[:, STAT_NONFINITE].sum().float()}
    for i, b in enumerate(HEALTH_BUCKETS):
        out[f"update_ratio_{b}"] = ratio[i].float()
    return out


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


def causal_loss_sums(model, batch: dict, label_smoothing: float = 0.0):
    """Loss sums of one (micro)batch of a decoder-only model: ``labels``
    align with ``input_ids`` (-100 over the prompt and the padding), so
    position t's logits predict ``labels[t + 1]``.  With the config's
    ``fused_ce`` the LM head's weight, cast to the compute dtype as the
    unfused head casts it, meets the hidden states chunk by chunk.  With
    ``moe_aux_weight`` > 0 (Mixtral) the loss sum takes w · the layers'
    mean aux loss · the microbatch's tokens, so the normalized loss is the
    mean CE + w · aux, as in the JAX package's ``make_loss_fn``; over batch
    shards the aux is the rank's share and the tokens the global count
    (``_global_tokens``)."""
    labels = batch["labels"]
    cfg = model.config
    weight = float(getattr(cfg, "moe_aux_weight", 0.0) or 0.0)
    ask = {"return_aux": True} if weight > 0.0 else {}
    if "positions" in batch:
        # a sequence shard: its labels are already the next-token targets
        logits = model(batch["input_ids"], batch["attention_mask"],
                       positions=batch["positions"])
        return cross_entropy_sums(logits, labels, label_smoothing)
    if cfg.fused_ce:
        h, w, *aux = model.head_inputs(batch["input_ids"], batch["attention_mask"], **ask)
        with scope("lm_head"):  # the head's matmuls, chunked into the loss
            lsum, tokens = blockwise_cross_entropy_sums(
                h[:, :-1].reshape(-1, h.shape[-1]), w, labels[:, 1:].reshape(-1),
                label_smoothing)
    else:
        out = model(batch["input_ids"], batch["attention_mask"], **ask)
        logits, *aux = out if ask else (out,)
        lsum, tokens = cross_entropy_sums(logits[:, :-1], labels[:, 1:], label_smoothing)
    if aux:
        lsum = lsum + weight * aux[0] * _global_tokens(model, tokens)
    return lsum, tokens


def _global_tokens(model, tokens: torch.Tensor) -> torch.Tensor:
    """The microbatch's target tokens over the ranks its MoE layers route
    across (``ops/moe.batch_shards_of``; a constant): each rank's aux term
    is its share of the global batch's aux, so weighted by the global count
    the ranks' loss sums add up to the JAX package's
    ``ce_sum + weight · aux · tokens``, and so do their gradients."""
    shards = batch_shards_of(model)
    if shards is None or shards.size == 1:
        return tokens
    total = tokens.detach().clone()
    torch.distributed.all_reduce(total, group=shards.group)
    return total


def loss_sums(model, batch: dict, label_smoothing: float = 0.0, *, is_seq2seq: bool = True):
    """The family's loss sums (the JAX package's ``make_loss_fn``)."""
    if is_seq2seq:
        return seq2seq_loss_sums(model, batch, label_smoothing)
    return causal_loss_sums(model, batch, label_smoothing)


@dataclasses.dataclass(frozen=True)
class StepGroups:
    """Where a step's sums meet over the process group: ``world`` ranks,
    each with its own rows; ``shard_group``: the ranks that hold the other
    shards of a leaf (the ``fsdp`` axis), over which the norm and the
    health sums add up.  With a shard group the model's parameters are
    FSDP shards (the backward reduces their gradients); without one each
    rank holds whole leaves, replicas the step all-reduces.

    A model-parallel step (``model_parallel``) reduces the loss, the token
    count and the gradients over ``row_group`` (None: nothing to reduce),
    and with ``tensor_group`` sums kernel 8's norm and the health sums over
    it, the leaves ``replicated`` over ``tensor`` (a flag a parameter, in
    ``named_params`` order) counted on tensor rank 0 (``tensor_index``)."""

    world: int = 1
    shard_group: Any = None
    model_parallel: bool = False
    row_group: Any = None
    tensor_group: Any = None
    tensor_index: int = 0
    replicated: tuple[bool, ...] = ()


# 64 MB of fp32 gradients an all-reduce: a guess, not measured (the
# data-only all-reduce has not run on the card)
GRAD_BUCKET_ELEMENTS = 1 << 24


@torch.no_grad()
def all_reduce_grads(grads: list[torch.Tensor], group=None) -> None:
    """SUM every gradient over ``group`` (default: the process group) in
    place, in coalesced buckets of at most ``GRAD_BUCKET_ELEMENTS`` (a
    larger tensor alone)."""
    dist = torch.distributed
    bucket: list[torch.Tensor] = []

    def flush():
        if not bucket:
            return
        flat = torch.cat([g.reshape(-1) for g in bucket])
        dist.all_reduce(flat, group=group)
        off = 0
        for g in bucket:
            g.copy_(flat[off:off + g.numel()].view_as(g))
            off += g.numel()
        bucket.clear()

    size = 0
    for g in grads:
        if bucket and size + g.numel() > GRAD_BUCKET_ELEMENTS:
            flush()
            size = 0
        bucket.append(g)
        size += g.numel()
    flush()


def optimizer_apply_block(spec: OptimizerSpec, schedule: Schedule, named_params,
                          state: AdamWState, lsum: torch.Tensor, tokens: torch.Tensor, *,
                          health_buckets=None, groups: StepGroups = StepGroups()) -> dict:
    """The once-per-step tail: normalize the token-weighted sums (the
    gradients in place in ``.grad``) and take their norm, clip + AdamW,
    metrics, with the health numerics when ``health_buckets`` (each
    leaf's bucket index) is given.  Every metric but the learning rate is
    a device tensor.  Sharded parameters are updated in their rank's
    shards (``state`` holds the shards' moments)."""
    tokens = torch.clamp(tokens, min=1.0)
    with torch.no_grad():
        grads = []
        for _, p in named_params:
            if p.grad is None:
                p.grad = torch.zeros_like(p, dtype=torch.float32)
            grads.append(local(p.grad))
        shards = [(n, local(p)) for n, p in named_params]
    lr = schedule(state.count)
    tensor = ((groups.tensor_group, groups.tensor_index, groups.replicated)
              if groups.tensor_group is not None else None)
    grad_norm = fused_optimizer_apply(spec, schedule, shards, state, grads, tokens,
                                      norm_group=groups.shard_group, tensor=tensor)
    metrics = {"loss": lsum / tokens, "learning_rate": lr, "grad_norm": grad_norm,
               "target_tokens": tokens}
    if health_buckets is not None:
        if groups.shard_group is not None:
            torch.distributed.all_reduce(state.stats, group=groups.shard_group)
        if groups.tensor_group is not None:
            if groups.tensor_index:  # a replicated leaf counts once, on tensor rank 0
                mask = torch.tensor(groups.replicated, device=state.stats.device)
                state.stats.copy_(torch.where(mask[:, None], 0.0, state.stats))
            torch.distributed.all_reduce(state.stats, group=groups.tensor_group)
        metrics.update(health_metrics_from_stats(state.stats, health_buckets))
    return metrics


def train_step(model, named_params, state: AdamWState, spec: OptimizerSpec, schedule: Schedule,
               batch: dict, *, grad_accum_steps: int = 1, label_smoothing: float = 0.0,
               generator: torch.Generator | None = None, health_buckets=None,
               is_seq2seq: bool = True, groups: StepGroups = StepGroups(),
               opt_timer=None) -> dict:
    """One optimizer step on ``batch`` (tensors on the model's device: the
    rank's rows of the global batch).  ``generator`` (CPU) seeds the
    dropout of a model in training mode; ``health_buckets``
    (``param_buckets``) adds the health numerics; ``is_seq2seq`` picks the
    family's loss (``loss_sums``); ``groups`` says how the sums meet over
    the process group; ``opt_timer`` (``obs/budget.OptimizerTimer``)
    brackets the optimizer tail.  The tail runs in the ``optimizer_apply_block``
    profiler scope (``obs/devprof.py``)."""
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
            if groups.shard_group is not None:
                # the gradients meet once, in the last microbatch's backward
                model.set_requires_gradient_sync(i == n - 1)
            ls, tk = loss_sums(model, micro, label_smoothing, is_seq2seq=is_seq2seq)
            ls.backward()
            ls = ls.detach()
            lsum, tokens = (ls, tk) if lsum is None else (lsum + ls, tokens + tk)
    if groups.world > 1 and not (groups.model_parallel and groups.row_group is None):
        reduce_group = groups.row_group if groups.model_parallel else None
        if groups.shard_group is None:
            for _, p in named_params:
                if p.grad is None:
                    p.grad = torch.zeros_like(p, dtype=torch.float32)
            all_reduce_grads([p.grad for _, p in named_params], group=reduce_group)
        sums = torch.stack([lsum, tokens.to(lsum.dtype)])
        torch.distributed.all_reduce(sums, group=reduce_group)
        lsum, tokens = sums[0], sums[1]
    with scope("optimizer_apply_block"), opt_timer or contextlib.nullcontext():
        return optimizer_apply_block(spec, schedule, named_params, state, lsum, tokens,
                                     health_buckets=health_buckets, groups=groups)
