"""Fixed-shape bucketed batching (the port's own copy of the JAX package's
``data/batching.py``, one process).

Each batch is padded to the smallest multiple of ``bucket_multiple`` that
fits its longest example, capped at the configured maximum: the number of
distinct shapes stays bounded (max_len / bucket_multiple) while a short
dialogue does not pay for a 1024-wide row.  Labels pad with ``LABEL_PAD``
(-100), which the loss masks out.  The iterator reads only ``input_ids``
and ``labels`` of an example, so it takes either dataset: a causal
example's two have one length, and the trainer caps both widths at the
source cap.
"""

from __future__ import annotations

from typing import Iterator, Sequence

import numpy as np

from distributed_llms_example_tpu_torch.data.dataset import (
    CausalLMDataset,
    SummarizationDataset,
    iter_global_batches,
)

LABEL_PAD = -100  # loss-mask value, parity with HF label padding


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
    (seed, epoch), the same arrays the JAX package's iterator yields in a
    single process.  Training takes the defaults (shuffled, last partial
    batch dropped); evaluation passes ``shuffle=False, drop_last=False``
    (the corpus in order, the last batch wrapped around to the start)."""

    def __init__(self, ds: SummarizationDataset | CausalLMDataset, *, global_batch: int, seed: int = 1234,
                 shuffle: bool = True, drop_last: bool = True,
                 bucket_multiple: int = 128, max_source_length: int = 1024,
                 max_target_length: int = 128):
        self.ds = ds
        self.global_batch = global_batch
        self.seed = seed
        self.shuffle, self.drop_last = shuffle, drop_last
        self.bucket_multiple = bucket_multiple
        self.max_source_length = max_source_length
        self.max_target_length = max_target_length

    def steps_per_epoch(self) -> int:
        steps, rem = divmod(len(self.ds), self.global_batch)
        return steps + (1 if rem and not self.drop_last else 0)

    def epoch(self, epoch: int, start_step: int = 0) -> Iterator[dict[str, np.ndarray]]:
        """The epoch's batches from its ``start_step``-th on (the in-epoch
        resume): input_ids, attention_mask (from lengths, so a pad id
        inside a sequence stays attended) and labels, int32.  The batch
        plan is a function of (seed, epoch), so the skip is on its index
        lists: no skipped batch is tokenized or padded."""
        pad_id = self.ds.tokenizer.pad_id
        plan = list(iter_global_batches(len(self.ds), self.global_batch, seed=self.seed,
                                        epoch=epoch, shuffle=self.shuffle,
                                        drop_last=self.drop_last))
        for idx in plan[start_step:]:
            ex = [self.ds[int(i)] for i in idx]
            src_w = bucket_len(max(len(e.input_ids) for e in ex), self.bucket_multiple,
                               self.max_source_length)
            tgt_w = bucket_len(max(len(e.labels) for e in ex),
                               min(self.bucket_multiple, self.max_target_length),
                               self.max_target_length)
            input_ids = pad_2d([e.input_ids for e in ex], src_w, pad_id)
            attention_mask = np.zeros_like(input_ids)
            for i, e in enumerate(ex):
                attention_mask[i, : min(len(e.input_ids), src_w)] = 1
            labels = pad_2d([e.labels for e in ex], tgt_w, LABEL_PAD)
            yield {"input_ids": input_ids, "attention_mask": attention_mask, "labels": labels}
