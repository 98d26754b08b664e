"""The eval pass (port of the JAX package's ``evaluation/evaluate.py``):
generation → decode → ROUGE → the mean over processes.

The reference's eval loop, per batch: ``generate`` with beam search, label
-100 replaced by pad, decode, ROUGE with the stemmer.  Here the batches
come in corpus order with the last one wrapped around to the start (the
JAX package's fixed shapes), and the wrapped rows are trimmed before
scoring.  A decoder-only model generates continuations of its
``CausalLMDataset`` prompts, scored against the targets
(``_run_causal``).  Over a process group each rank generates and scores
its own rows of every batch (the batch's widths from the whole batch),
and the ROUGE means are the mean of the ranks' means, as in the JAX
package.  The model runs on its own device in eval mode under
``torch.no_grad()`` (its mode restored after): no dropout, and no seed
drawn from any dropout stream.  On CUDA the encoder or the causal prompt
prefill runs through the flash-attention kernel and every cached decoder
step through the flash decode kernel, or the pass raises.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from distributed_llms_example_tpu_torch.core.mesh import process_count, process_index
from distributed_llms_example_tpu_torch.data.batching import (
    LABEL_PAD,
    BatchIterator,
    bucket_len,
    pad_2d,
)
from distributed_llms_example_tpu_torch.data.dataset import CausalLMDataset, SummarizationDataset
from distributed_llms_example_tpu_torch.data.tokenizer import Tokenizer
from distributed_llms_example_tpu_torch.evaluation import rouge as rouge_mod
from distributed_llms_example_tpu_torch.evaluation.generation import (
    CausalGenerator,
    Seq2SeqGenerator,
)
from distributed_llms_example_tpu_torch.evaluation.metrics import aggregate_mean


@dataclasses.dataclass
class Evaluator:
    model: torch.nn.Module
    config: Any
    tokenizer: Tokenizer
    num_beams: int = 2
    max_new_tokens: int = 128
    length_penalty: float = 1.0
    is_seq2seq: bool = True

    def __post_init__(self) -> None:
        cls = Seq2SeqGenerator if self.is_seq2seq else CausalGenerator
        self.generator = cls(self.model, self.config, self.max_new_tokens,
                             num_beams=self.num_beams, length_penalty=self.length_penalty)

    def _decode_batch(self, ids: np.ndarray) -> list[str]:
        """Each row's text: its tokens up to the first eos, pads dropped."""
        eos, pad = self.config.eos_token_id, self.config.pad_token_id
        out = []
        for row in ids:
            toks = []
            for t in row.tolist():
                if t == eos:
                    break
                if t != pad:
                    toks.append(t)
            out.append(self.tokenizer.decode(toks))
        return out

    def run(self, ds: SummarizationDataset | CausalLMDataset, *, global_batch: int,
            bucket_multiple: int = 128, max_source_length: int = 1024) -> dict[str, float]:
        """ROUGE-1/2/L/Lsum means over ``ds``, ``global_batch`` rows a
        generation (a decoder-only model: ``_run_causal``)."""
        if not self.is_seq2seq:
            return self._run_causal(ds, global_batch=global_batch,
                                    bucket_multiple=bucket_multiple,
                                    max_source_length=max_source_length)
        pc, pi = process_count(), process_index()
        it = BatchIterator(ds, global_batch=global_batch, process_count=pc, process_index=pi,
                           seed=0, shuffle=False, drop_last=False,
                           bucket_multiple=bucket_multiple, max_source_length=max_source_length,
                           max_target_length=self.max_new_tokens)
        per_host = global_batch // pc
        lo = pi * per_host
        device = next(self.model.parameters()).device
        preds: list[str] = []
        refs: list[str] = []
        seen = 0
        was_training = self.model.training
        self.model.eval()
        try:
            with torch.no_grad():
                for batch in it.epoch(0):
                    out = self.generator.run(
                        torch.as_tensor(batch["input_ids"], device=device).long(),
                        torch.as_tensor(batch["attention_mask"], device=device).long())
                    labels = np.where(batch["labels"] == LABEL_PAD, self.config.pad_token_id,
                                      batch["labels"])
                    # the last batch wraps around: its rows past the corpus
                    # repeat the epoch's start
                    valid = int(np.clip(min(global_batch, len(ds) - seen) - lo, 0, per_host))
                    preds.extend(self._decode_batch(out.cpu().numpy()[:valid]))
                    refs.extend(self._decode_batch(labels[:valid]))
                    seen += global_batch
        finally:
            self.model.train(was_training)
        return aggregate_mean(rouge_mod.compute(preds, refs, use_stemmer=True))

    def _run_causal(self, ds: CausalLMDataset, *, global_batch: int, bucket_multiple: int,
                    max_source_length: int) -> dict[str, float]:
        """Prompt-continuation eval of a decoder-only model: each batch's
        prompts right-padded to the bucket of its longest prompt (the mask
        from their lengths), generated from, and scored by ROUGE against
        the target ids without eos.  The last batch wraps around to the
        corpus start and its extra rows are trimmed."""
        device = next(self.model.parameters()).device
        pad, eos = self.config.pad_token_id, self.config.eos_token_id
        per_host = global_batch // process_count()
        lo = process_index() * per_host
        n = len(ds)
        preds: list[str] = []
        refs: list[str] = []
        was_training = self.model.training
        self.model.eval()
        try:
            with torch.no_grad():
                for start in range(0, n, global_batch):
                    idx = [(start + i) % n for i in range(global_batch)]
                    # the width from the whole batch: every rank's shape agrees
                    width = bucket_len(max(len(ds[i].prompt_ids) for i in idx), bucket_multiple,
                                       max_source_length)
                    idx = idx[lo:lo + per_host]
                    prompts = [ds[i].prompt_ids for i in idx]
                    input_ids = pad_2d(prompts, width, pad)
                    mask = np.zeros_like(input_ids)
                    for r, p in enumerate(prompts):
                        mask[r, : min(len(p), width)] = 1
                    out = self.generator.run(torch.as_tensor(input_ids, device=device).long(),
                                             torch.as_tensor(mask, device=device).long())
                    valid = int(np.clip(min(global_batch, n - start) - lo, 0, per_host))
                    preds.extend(self._decode_batch(out.cpu().numpy()[:valid]))
                    refs.extend(self.tokenizer.decode([t for t in ds[i].target_ids if t != eos])
                                for i in idx[:valid])
        finally:
            self.model.train(was_training)
        return aggregate_mean(rouge_mod.compute(preds, refs, use_stemmer=True))
