"""JSON summarization data (the port's own copy of the JAX package's
``data/dataset.py``, single process).

- ``load_json_records``: a JSON array, JSONL, or a ``{"data": [...]}``
  wrapper; malformed JSONL lines are skipped and counted in one
  ``data_skipped_records`` event;
- ``resolve_columns`` / ``SummarizationDataset``: the dual column schema
  (``dialogue``/``summary`` first, then ``article``/``highlights``),
  tokenized lazily with truncation and memoized;
- ``epoch_order`` / ``iter_global_batches``: the deterministic shuffled
  per-epoch example order and its full batches, the same index stream as
  the JAX package's training stream for the same seed.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Iterator, Sequence

import numpy as np

from distributed_llms_example_tpu_torch.data.tokenizer import Tokenizer
from distributed_llms_example_tpu_torch.utils.jsonlog import log_json

SOURCE_COLUMNS = ("dialogue", "article", "document", "text")
TARGET_COLUMNS = ("summary", "highlights", "target")


def load_json_records(path: str) -> list:
    with open(path, "r", encoding="utf-8") as f:
        text = f.read().lstrip()
    if text.startswith("["):
        return json.loads(text)
    try:
        doc = json.loads(text)
    except json.JSONDecodeError:
        doc = None  # more than one document: JSONL
    if isinstance(doc, dict):
        return doc["data"] if isinstance(doc.get("data"), list) else [doc]
    records, skipped = [], 0
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        try:
            rec = json.loads(line)
        except json.JSONDecodeError:
            skipped += 1
            continue
        if isinstance(rec, (dict, str)):
            records.append(rec)
        else:
            skipped += 1
    if skipped:
        log_json({"event": "data_skipped_records", "path": path, "skipped": skipped})
    return records


def resolve_columns(record: dict, source_column: str = "", target_column: str = "") -> tuple[str, str]:
    """Pick (source, target) column names, honoring explicit config first."""
    src = source_column if source_column in record else next(
        (c for c in SOURCE_COLUMNS if c in record), None)
    tgt = target_column if target_column in record else next(
        (c for c in TARGET_COLUMNS if c in record), None)
    if src is None or tgt is None:
        raise ValueError(
            f"cannot find source/target columns in record keys {sorted(record)}; "
            f"expected one of {SOURCE_COLUMNS} and {TARGET_COLUMNS}"
        )
    return src, tgt


@dataclasses.dataclass
class Example:
    input_ids: list[int]
    labels: list[int]


class SummarizationDataset:
    """Summarization examples, tokenized on first access with truncation
    (no padding: that is the batcher's job, so shapes can be bucketed)."""

    def __init__(self, records: Sequence[dict], tokenizer: Tokenizer, *,
                 max_source_length: int = 1024, max_target_length: int = 128,
                 source_column: str = "", target_column: str = ""):
        self.tokenizer = tokenizer
        self._records = records
        self._max_source_length = max_source_length
        self._max_target_length = max_target_length
        self._cache: list[Example | None] = [None] * len(records)
        if records:
            self._src_col, self._tgt_col = resolve_columns(
                dict(records[0]), source_column, target_column)

    def __len__(self) -> int:
        return len(self._records)

    def __getitem__(self, i: int) -> Example:
        ex = self._cache[i]
        if ex is None:
            r = self._records[i]
            src = self.tokenizer.encode_source(str(r[self._src_col]), self._max_source_length)
            tgt = self.tokenizer.encode_target(str(r[self._tgt_col]), self._max_target_length)
            ex = self._cache[i] = Example(src, tgt)
        return ex


def epoch_order(n: int, *, seed: int, epoch: int, shuffle: bool = True) -> np.ndarray:
    """Deterministic example order for an epoch: a permutation, or
    ``0..n-1`` without ``shuffle`` (the eval order)."""
    if not shuffle:
        return np.arange(n)
    return np.random.RandomState(seed + epoch).permutation(n)


def iter_global_batches(n: int, global_batch: int, *, seed: int, epoch: int,
                        shuffle: bool = True, drop_last: bool = True) -> Iterator[np.ndarray]:
    """Index arrays of exactly ``global_batch`` per step.  The last partial
    batch is dropped, or with ``drop_last=False`` wraps around to the
    epoch start, so that every batch keeps its shape even for a corpus
    smaller than one batch (``np.resize`` cycles the order)."""
    order = epoch_order(n, seed=seed, epoch=epoch, shuffle=shuffle)
    steps, rem = divmod(n, global_batch)
    for s in range(steps):
        yield order[s * global_batch : (s + 1) * global_batch]
    if rem and not drop_last:
        tail = order[steps * global_batch :]
        yield np.concatenate([tail, np.resize(order, global_batch - rem)])
