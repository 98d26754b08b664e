"""Fixed-shape bucketed batching (the port's own copy of the JAX package's
``data/batching.py``).

Each batch is padded to the smallest multiple of ``bucket_multiple`` that
fits its longest example, capped at the configured maximum: the number of
distinct shapes stays bounded (max_len / bucket_multiple) while a short
dialogue does not pay for a 1024-wide row.  Labels pad with ``LABEL_PAD``
(-100), which the loss masks out.  The iterator reads only ``input_ids``
and ``labels`` of an example, so it takes either dataset: a causal
example's two have one length, and the trainer caps both widths at the
source cap.

Over a process group each process materializes its contiguous rows of
every global batch (``host_batch_slices``), padded to the widths of the
global batch: every rank's batch has one shape, as the JAX package's
global arrays do.
"""

from __future__ import annotations

from typing import Iterator, Sequence

import numpy as np

from distributed_llms_example_tpu_torch.data.dataset import (
    CausalLMDataset,
    SummarizationDataset,
    host_batch_slices,
    iter_global_batches,
)

LABEL_PAD = -100  # loss-mask value, parity with HF label padding


def microbatch_size(global_batch: int, grad_accum_steps: int, *, batch_shards: int = 1,
                    process_count: int = 1) -> int:
    """Check the (global batch, accumulation, sharding) triple and return
    the microbatch size: the batch splits into ``grad_accum_steps``
    microbatches, each microbatch evenly over the batch shards, and the
    batch evenly over the processes."""
    if grad_accum_steps < 1:
        raise ValueError(f"grad_accum_steps must be >= 1, got {grad_accum_steps}")
    if global_batch % grad_accum_steps:
        raise ValueError(f"global batch {global_batch} is not divisible by "
                         f"grad_accum_steps={grad_accum_steps}")
    micro = global_batch // grad_accum_steps
    if micro % max(1, batch_shards):
        raise ValueError(
            f"microbatch {micro} (batch {global_batch} / grad_accum_steps "
            f"{grad_accum_steps}) is not divisible by the mesh's {batch_shards} batch "
            "shards (data x fsdp x expert) — the shard-local microbatch regrouping needs "
            "every microbatch to split evenly over the batch axes")
    if global_batch % max(1, process_count):
        raise ValueError(f"global batch {global_batch} is not divisible by "
                         f"{process_count} processes")
    return micro


def validate_batch_mesh(global_batch: int, mesh_axes: dict, *, process_count: int = 1,
                        grad_accum_steps: int = 1) -> None:
    """``microbatch_size``'s checks against a mesh's axis sizes (the batch
    shards are data x fsdp x expert)."""
    shards = 1
    for ax in ("data", "fsdp", "expert"):
        shards *= max(1, int(mesh_axes.get(ax, 1) or 1))
    microbatch_size(global_batch, max(1, grad_accum_steps), batch_shards=shards,
                    process_count=max(1, process_count))


def bucket_len(max_len_in_batch: int, multiple: int, cap: int) -> int:
    b = ((max(1, max_len_in_batch) + multiple - 1) // multiple) * multiple
    return min(b, cap)


def pad_2d(seqs: Sequence[Sequence[int]], width: int, pad_value: int) -> np.ndarray:
    out = np.full((len(seqs), width), pad_value, dtype=np.int32)
    for i, s in enumerate(seqs):
        s = list(s)[:width]
        out[i, : len(s)] = s
    return out


class BatchIterator:
    """Per-epoch iterator over padded batches: a deterministic function of
    (seed, epoch), the same arrays the JAX package's iterator yields.
    Training takes the defaults (shuffled, last partial batch dropped);
    evaluation passes ``shuffle=False, drop_last=False`` (the corpus in
    order, the last batch wrapped around to the start).  With
    ``process_count`` > 1 each process yields rows ``host_batch_slices``
    of every global batch, at the global batch's widths."""

    def __init__(self, ds: SummarizationDataset | CausalLMDataset, *, global_batch: int,
                 process_count: int = 1, process_index: int = 0, seed: int = 1234,
                 shuffle: bool = True, drop_last: bool = True,
                 bucket_multiple: int = 128, max_source_length: int = 1024,
                 max_target_length: int = 128):
        self.ds = ds
        self.global_batch = global_batch
        self.process_count = process_count
        self.process_index = process_index
        self.seed = seed
        self.shuffle, self.drop_last = shuffle, drop_last
        self.bucket_multiple = bucket_multiple
        self.max_source_length = max_source_length
        self.max_target_length = max_target_length
        self._slice = host_batch_slices(global_batch, process_count, process_index)

    def steps_per_epoch(self) -> int:
        steps, rem = divmod(len(self.ds), self.global_batch)
        return steps + (1 if rem and not self.drop_last else 0)

    @staticmethod
    def _maxima(ex) -> tuple[int, int]:
        return max(len(e.input_ids) for e in ex), max(len(e.labels) for e in ex)

    def epoch(self, epoch: int, start_step: int = 0) -> Iterator[dict[str, np.ndarray]]:
        """The epoch's batches from its ``start_step``-th on (the in-epoch
        resume): input_ids, attention_mask (from lengths, so a pad id
        inside a sequence stays attended) and labels, int32.  The batch
        plan is a function of (seed, epoch), so the skip is on its index
        lists: no skipped batch is tokenized or padded.

        Over a process group the widths are agreed once an epoch, on the
        caller's thread: each process tokenizes its own rows of every batch
        for their length maxima, and one all-gather takes the maxima over
        the processes (never on the prefetch thread, where collectives
        could interleave differently across ranks).  One process stays
        lazy: each batch's widths come with it.  Several iterators of one
        process (``process_count`` > 1 without a group) scan the global
        rows per batch: the same widths."""
        from distributed_llms_example_tpu_torch.core.mesh import process_allgather, process_count

        batches = list(iter_global_batches(len(self.ds), self.global_batch, seed=self.seed,
                                           epoch=epoch, shuffle=self.shuffle,
                                           drop_last=self.drop_last))[start_step:]
        maxima = None
        if self.process_count > 1 and process_count() > 1:
            local = np.zeros((len(batches), 2), np.int64)
            for s, global_idx in enumerate(batches):
                local[s] = self._maxima([self.ds[int(i)] for i in global_idx[self._slice]])
            maxima = process_allgather(local).max(axis=0)
        return self._iter_batches(batches, maxima)

    def _iter_batches(self, batches, maxima) -> Iterator[dict[str, np.ndarray]]:
        pad_id = self.ds.tokenizer.pad_id
        for s, global_idx in enumerate(batches):
            ex = [self.ds[int(i)] for i in global_idx[self._slice]]
            if maxima is not None:
                src_max, tgt_max = maxima[s]
            elif self.process_count > 1:
                src_max, tgt_max = self._maxima([self.ds[int(i)] for i in global_idx])
            else:
                src_max, tgt_max = self._maxima(ex)
            src_w = bucket_len(int(src_max), self.bucket_multiple, self.max_source_length)
            tgt_w = bucket_len(int(tgt_max), min(self.bucket_multiple, self.max_target_length),
                               self.max_target_length)
            input_ids = pad_2d([e.input_ids for e in ex], src_w, pad_id)
            attention_mask = np.zeros_like(input_ids)
            for i, e in enumerate(ex):
                attention_mask[i, : min(len(e.input_ids), src_w)] = 1
            labels = pad_2d([e.labels for e in ex], tgt_w, LABEL_PAD)
            yield {"input_ids": input_ids, "attention_mask": attention_mask, "labels": labels}
