"""Derived gauges of a training run (port of the JAX package's
``obs/gauges.py``): the MFU numerator and the per-step collective byte
account.

- **FLOPs per step**: the JAX package reads them from XLA's cost analysis of
  the compiled step.  The port counts them with
  ``torch.utils.flop_counter.FlopCounterMode`` over one forward and backward
  of the run's architecture on the ``meta`` device
  (``flops_source: "flop_counter"``): no weight is materialized and nothing
  runs on a device, so no kernel is launched (the model runs with its
  plain attention and in eval mode, whose dropout is the identity; neither
  changes the matmuls).  What is counted (``FLOPS_COUNTED``, stamped on the
  ``obs_gauges`` line) is the step's model FLOPs, the one definition of
  MFU in the repo: every matmul of one forward and its backward at the
  run's padded global batch shape (``batch_size`` rows of
  ``max_source_length`` and the target cap; a batch padded narrower does
  fewer), the attention products over the whole S x S square, and no
  recompute: the meta model is built without remat and with the plain LM
  head and loss (the vocab-chunked loss remakes each chunk's logits in its
  backward).  One pass over
  the whole global batch does the same matmuls as its microbatches, so the
  count does not change with ``--grad-accum-steps``.  Where the count fails
  the JAX package's estimate stands, under its source name
  (``6N_tokens_estimate``).  ``mfu`` divides by the window's step time,
  the world size and ``--obs-peak-tflops`` (989: the H100 SXM's dense
  bf16 rate).
- **The collective byte account** (``collective_account``): the JAX package
  reads it from the compiled program's collectives; the port reckons it
  from its own step, per rank, by op, in the JAX package's shape
  (``{op: {count, gradient_bytes, activation_bytes}}`` and the totals).
  What a step moves: under ``data`` alone the coalesced gradient
  all-reduce (``train/step.py all_reduce_grads``, fp32, one call a bucket);
  under ``fsdp`` FSDP2's all-gather of each unit (``parallel/fsdp.py``: the
  root and every block; each block gathered again for its backward, every
  microbatch) and one reduce-scatter of each unit's gradients a step (plus
  their all-reduce over ``data`` under HSDP), each of padded dim-0 shards;
  kernel 8's float64 partial-norm all-reduce and the health sums' over the
  ``fsdp`` ranks; the loss and token all-reduce of every multi-rank step.
  Sizes are the tensor bytes a call defines on the rank (an all-gather's
  output, a reduce-scatter's output), as the JAX account sizes an HLO
  instruction.  Gradient and parameter traffic is ``gradient_bytes``;
  everything else (the loss, the norm and the health sums) is
  ``activation_bytes``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

# what ``count_step_flops`` counts, on the ``obs_gauges`` line
FLOPS_COUNTED = ("model FLOPs: every matmul of one forward and backward at the padded "
                 "global batch shape, the whole S x S attention square, no recompute "
                 "(remat's or the chunked loss's)")


def training_flops_estimate(n_params: int, tokens_per_step: int) -> float:
    """The standard 6·N FLOPs/token training estimate (forward 2N, backward
    4N; attention left out)."""
    return 6.0 * float(n_params) * float(tokens_per_step)


def mfu(flops_per_step: float, step_time_s: float, n_chips: int,
        peak_flops_per_chip: float) -> float:
    """Model FLOPs utilization: achieved FLOP rate over aggregate peak."""
    denom = step_time_s * n_chips * peak_flops_per_chip
    if denom <= 0:
        return 0.0
    return flops_per_step / denom


def _plain_class(model: torch.nn.Module) -> type:
    """The model's own class (an FSDP2-sharded module's class is a subclass
    ``FSDP<name>`` of it)."""
    return next(c for c in type(model).__mro__
                if issubclass(c, torch.nn.Module) and not c.__name__.startswith("FSDP"))


def count_step_flops(model: torch.nn.Module, *, global_batch: int, src_len: int, tgt_len: int,
                     is_seq2seq: bool) -> float:
    """The model FLOPs of one forward and backward of ``model``'s
    architecture (its config and compute dtype; no remat, the plain head
    and loss) over a global batch of ``global_batch`` rows, on the ``meta``
    device."""
    from torch.utils.flop_counter import FlopCounterMode

    from distributed_llms_example_tpu_torch.train.step import loss_sums

    plain = {"attention_impl": "xla"}
    if getattr(model.config, "fused_ce", False):
        plain["fused_ce"] = False
    config = dataclasses.replace(model.config, **plain)
    meta = _plain_class(model)(config, dtype=model.dtype, param_dtype=torch.float32,
                               device="meta").eval()
    for p in meta.parameters():
        p.requires_grad_(True)
    ids = torch.zeros((global_batch, src_len), dtype=torch.long, device="meta")
    batch = {"input_ids": ids, "attention_mask": torch.ones_like(ids),
             "labels": torch.zeros((global_batch, tgt_len if is_seq2seq else src_len),
                                   dtype=torch.long, device="meta")}
    with FlopCounterMode(display=False) as counter:
        lsum, _ = loss_sums(meta, batch, is_seq2seq=is_seq2seq)
        lsum.backward()
    return float(counter.get_total_flops())


def _slot(account: dict, op: str) -> dict:
    return account.setdefault(op, {"count": 0, "gradient_bytes": 0, "activation_bytes": 0})


def _add(account: dict, op: str, nbytes: int, *, gradient: bool, count: int = 1) -> None:
    slot = _slot(account, op)
    slot["count"] += count
    slot["gradient_bytes" if gradient else "activation_bytes"] += int(nbytes) * count


def collective_account(model: torch.nn.Module, *, data: int, fsdp: int,
                       grad_accum_steps: int = 1, health: bool = False) -> dict:
    """The per-step, per-rank collective byte account of the port's train
    step on a (``data``, ``fsdp``) mesh (``model``: its global parameter
    shapes; fp32 master parameters and gradients)."""
    from distributed_llms_example_tpu_torch.parallel.fsdp import transformer_blocks
    from distributed_llms_example_tpu_torch.train.step import GRAD_BUCKET_ELEMENTS

    world = data * fsdp
    account: dict[str, Any] = {}
    params = list(model.named_parameters())
    if world > 1 and fsdp == 1:
        group: list[int] = []
        for _, p in params:  # all_reduce_grads' coalescing
            if group and sum(group) + p.numel() > GRAD_BUCKET_ELEMENTS:
                _add(account, "all-reduce", sum(group) * 4, gradient=True)
                group = []
            group.append(p.numel())
        if group:
            _add(account, "all-reduce", sum(group) * 4, gradient=True)
    if fsdp > 1:
        blocks = transformer_blocks(model)
        in_block = {id(p) for blk in blocks for p in blk.parameters()}
        units = [list(blk.parameters()) for blk in blocks]
        root = [p for _, p in params if id(p) not in in_block]
        n = int(grad_accum_steps)
        for i, unit in enumerate([root, *units]):
            shard = sum(-(-p.shape[0] // fsdp) * (p.numel() // max(1, p.shape[0])) for p in unit)
            # the root is gathered once a microbatch (FSDP2 keeps it for the
            # backward); a block again for its backward
            _add(account, "all-gather", shard * fsdp * 4, gradient=True, count=n * (1 if i == 0 else 2))
            _add(account, "reduce-scatter", shard * 4, gradient=True)
            if data > 1:
                _add(account, "all-reduce", shard * 4, gradient=True)
        _add(account, "all-reduce", 8, gradient=False)  # kernel 8's float64 partial norm
        if health:
            from distributed_llms_example_tpu_torch.ops.fused_optim import STATS

            _add(account, "all-reduce", len(params) * STATS * 8, gradient=False)
    if world > 1:
        _add(account, "all-reduce", 8, gradient=False)  # the loss and token sums
    total = sum(s["gradient_bytes"] + s["activation_bytes"] for s in account.values())
    grad = sum(s["gradient_bytes"] for s in account.values())
    return {**dict(sorted(account.items())), "total_bytes": total, "gradient_bytes": grad,
            "activation_bytes": total - grad}


def train_step_static_gauges(model: torch.nn.Module, *, model_name: str, data: int, fsdp: int,
                             global_batch: int, src_len: int, tgt_len: int, is_seq2seq: bool,
                             grad_accum_steps: int = 1, health: bool = False) -> dict:
    """The startup gauges of a run: its parameters, tokens and FLOPs a step
    (``count_step_flops``, else the 6N estimate) and the collective byte
    account, in the JAX package's ``obs_gauges`` fields."""
    n_params = int(sum(math.prod(p.shape) for p in model.parameters()))
    tokens_per_step = global_batch * (src_len + tgt_len if is_seq2seq else src_len)
    flops_source = "flop_counter"
    try:
        flops = count_step_flops(model, global_batch=global_batch, src_len=src_len,
                                 tgt_len=tgt_len, is_seq2seq=is_seq2seq)
    except (RuntimeError, NotImplementedError, TypeError, ValueError):
        flops = 0.0
    if flops <= 0.0:
        flops = training_flops_estimate(n_params, tokens_per_step)
        flops_source = "6N_tokens_estimate"
    return {
        "model": model_name,
        "mesh": {"data": int(data), "fsdp": int(fsdp)},
        "global_batch": int(global_batch),
        "grad_accum_steps": int(grad_accum_steps),
        "grad_compression": "off",
        "params": n_params,
        "tokens_per_step": int(tokens_per_step),
        "flops_per_step": flops,
        "flops_source": flops_source,
        "flops_counted": FLOPS_COUNTED if flops_source == "flop_counter" else
        "6 x parameters x tokens a step",
        "comm": collective_account(model, data=data, fsdp=fsdp,
                                   grad_accum_steps=grad_accum_steps, health=health),
    }
