"""JSON summarization data (the port's own copy of the JAX package's
``data/dataset.py``, single process).

- ``load_json_records``: a JSON array, JSONL, or a ``{"data": [...]}``
  wrapper; malformed JSONL lines are skipped and counted in one
  ``data_skipped_records`` event;
- ``resolve_columns`` / ``SummarizationDataset``: the dual column schema
  (``dialogue``/``summary`` first, then ``article``/``highlights``),
  tokenized lazily with truncation and memoized;
- ``CausalLMDataset``: decoder-only instruction tuning, prompt and
  continuation concatenated with the loss masked (-100) over the prompt;
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


@dataclasses.dataclass
class CausalExample:
    input_ids: list[int]  # prompt + target (+ eos)
    labels: list[int]  # -100 over the prompt, the target ids over the target
    prompt_ids: list[int]
    target_ids: list[int]


class CausalLMDataset:
    """Instruction-tuning examples for decoder-only models: source and
    target concatenated, the loss masked over the prompt.  The target is
    encoded first (a continuation ending in eos, at most
    ``max_target_length``) and the prompt gets what is left of
    ``max_length`` (at least one token), so the sum never passes
    ``max_length``.  Encoded lazily and memoized, as
    ``SummarizationDataset``."""

    def __init__(self, records: Sequence[dict], tokenizer: Tokenizer, *,
                 max_length: int = 1024, max_target_length: int = 256,
                 source_column: str = "", target_column: str = ""):
        self.tokenizer = tokenizer
        self._records = records
        self._max_length = max_length
        self._max_target_length = max_target_length
        self._cache: list[CausalExample | None] = [None] * len(records)
        if records:
            self._src_col, self._tgt_col = resolve_columns(
                dict(records[0]), source_column, target_column)

    def __len__(self) -> int:
        return len(self._records)

    def ensure_encoded(self, indices: Sequence[int]) -> None:
        """Encode the given examples now (each prompt's budget depends on
        its own target, so this is a loop)."""
        for i in indices:
            self[int(i)]

    def clear_cache(self) -> None:
        """Drop the memoized encodings."""
        self._cache = [None] * len(self._records)

    def __getitem__(self, i: int) -> CausalExample:
        ex = self._cache[i]
        if ex is None:
            r = self._records[i]
            tgt = self.tokenizer.encode_continuation(str(r[self._tgt_col]),
                                                     self._max_target_length)
            max_prompt = max(1, self._max_length - len(tgt))
            src = self.tokenizer.encode_prompt(str(r[self._src_col]), max_prompt)
            ex = self._cache[i] = CausalExample(src + tgt, [-100] * len(src) + tgt, src, tgt)
        return ex


def epoch_order(n: int, *, seed: int, epoch: int, shuffle: bool = True) -> np.ndarray:
    """Deterministic example order for an epoch: a permutation, or
    ``0..n-1`` without ``shuffle`` (the eval order)."""
    if not shuffle:
        return np.arange(n)
    return np.random.RandomState(seed + epoch).permutation(n)


def host_batch_slices(global_batch: int, process_count: int, process_index: int) -> slice:
    """The contiguous rows of each global batch this process materializes."""
    if global_batch % process_count != 0:
        raise ValueError(f"global batch {global_batch} not divisible by {process_count} processes")
    per = global_batch // process_count
    return slice(process_index * per, (process_index + 1) * per)


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
