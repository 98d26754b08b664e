"""A minimal trainer (port of the JAX package's ``train/trainer.py``, one
device): dataset → bucketed batches → the epoch loop of ``train_step`` →
the JSON step lines of ``MetricLogger``, an ``eval`` line (ROUGE of the
validation set's generated summaries, ``evaluate``) every
``evaluation_steps`` steps and at each epoch's end → ``save_final``, the
fine-tuned model as an HF checkpoint.

Weights are random-init from ``seed``, or read from a local HF checkpoint
directory (``--model-ckpt <dir>``), with fp32 master copies (the training
build of ``models/registry.py``); activations run in the compute dtype.
Dropout seeds (the residual dropout's and the attention-probs dropout's)
come from a CPU ``torch.Generator`` seeded with ``shuffle_seed``, so a
step draws nothing on the device; the eval pass draws no seed, so a run
with evaluation trains exactly as one without.  Losses stay device
tensors until a logging step converts them.  Mid-run checkpoints and
resume, health/obs/recovery and multi-GPU wait for later slices
(ROADMAP.md).
"""

from __future__ import annotations

import os
import time
from typing import Any, Sequence

import numpy as np
import torch

from distributed_llms_example_tpu_torch.core.config import TrainConfig
from distributed_llms_example_tpu_torch.core.precision import parse_dtype, resolve_device
from distributed_llms_example_tpu_torch.data.batching import LABEL_PAD, BatchIterator
from distributed_llms_example_tpu_torch.data.dataset import SummarizationDataset
from distributed_llms_example_tpu_torch.data.tokenizer import get_tokenizer
from distributed_llms_example_tpu_torch.evaluation.evaluate import Evaluator
from distributed_llms_example_tpu_torch.io.valohai_meta import save_valohai_metadata
from distributed_llms_example_tpu_torch.models.export import save_hf_checkpoint
from distributed_llms_example_tpu_torch.models.registry import LoadedModel, load_model
from distributed_llms_example_tpu_torch.train.optim import (
    AdamWState,
    OptimizerSpec,
    linear_schedule_with_warmup,
)
from distributed_llms_example_tpu_torch.train.step import train_step
from distributed_llms_example_tpu_torch.utils.jsonlog import MetricLogger, log_json


def put_batch(batch: dict[str, np.ndarray], device: torch.device) -> dict[str, torch.Tensor]:
    """Host int32 arrays → device int64 tensors (pinned, asynchronous copy
    on CUDA)."""
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        out[k] = t.long()
    return out


def batch_tokens(batch: dict[str, np.ndarray]) -> int:
    """Non-pad tokens of one seq2seq batch: source plus target."""
    return int(np.sum(batch["attention_mask"])) + int(np.sum(batch["labels"] != LABEL_PAD))


class Trainer:
    def __init__(self, cfg: TrainConfig, train_records: Sequence[dict], *,
                 val_records: Sequence[dict] | None = None, loaded: LoadedModel | None = None):
        """``val_records``: the validation set; without it there is no
        evaluation.  ``loaded``: a model the caller built for training (fp32 master
        weights, the compute dtype, on ``cfg.device``, its attention route
        in its config: ``--attention-impl`` is refused beside it) in place
        of loading ``cfg.model_ckpt``, for a configuration that no registry
        name or HF config expresses, such as T5 with ``attn_dropout_rate``
        > 0."""
        self.cfg = cfg
        self.device = resolve_device(cfg.device)
        if loaded is None:
            loaded = load_model(
                cfg.model_ckpt, dtype=parse_dtype(cfg.compute_dtype), device=self.device,
                attention_impl=cfg.attention_impl or None, seed=cfg.seed, train=True,
            )
        elif not loaded.is_seq2seq or loaded.module.dtype != parse_dtype(cfg.compute_dtype) \
                or loaded.device.type != self.device.type:
            raise ValueError(f"the given {loaded.family} model ({loaded.module.dtype} on "
                             f"{loaded.device}) is not a seq2seq model in {cfg.compute_dtype} "
                             f"on {self.device}")
        elif cfg.attention_impl:
            raise ValueError("--attention-impl applies to a loaded model; a built one takes "
                             "its route from its config")
        loaded.module.train()
        self.loaded = loaded
        self.model = self.loaded.module
        self.tokenizer = get_tokenizer(cfg.tokenizer, cfg.model_ckpt)
        def dataset(records):
            return SummarizationDataset(
                records, self.tokenizer, max_source_length=cfg.max_source_length,
                max_target_length=cfg.max_target_length, source_column=cfg.source_column,
                target_column=cfg.target_column,
            )

        self.train_ds = dataset(train_records)
        self.val_ds = dataset(val_records) if val_records else None
        self.evaluator = None
        if self.val_ds:
            self.evaluator = Evaluator(self.model, self.loaded.config, self.tokenizer,
                                       num_beams=cfg.num_beams,
                                       max_new_tokens=cfg.eval_max_new_tokens,
                                       is_seq2seq=self.loaded.is_seq2seq)
        self.batches = BatchIterator(
            self.train_ds, global_batch=cfg.batch_size, seed=cfg.shuffle_seed,
            bucket_multiple=cfg.pad_to_multiple, max_source_length=cfg.max_source_length,
            max_target_length=cfg.max_target_length,
        )
        steps_per_epoch = self.batches.steps_per_epoch()
        if steps_per_epoch == 0:
            raise ValueError(f"dataset of {len(self.train_ds)} examples is smaller than one "
                             f"global batch ({cfg.batch_size})")
        if cfg.batch_size % cfg.grad_accum_steps:
            raise ValueError(f"global batch {cfg.batch_size} is not divisible by "
                             f"grad_accum_steps={cfg.grad_accum_steps}")
        self.total_steps = steps_per_epoch * cfg.num_epochs
        self.spec = OptimizerSpec(
            learning_rate=cfg.learning_rate, weight_decay=cfg.weight_decay,
            warmup_steps=cfg.warmup_steps, total_steps=self.total_steps,
            max_grad_norm=cfg.max_grad_norm,
        )
        self.schedule = linear_schedule_with_warmup(cfg.learning_rate, cfg.warmup_steps,
                                                    self.total_steps)
        self.named_params = list(self.model.named_parameters())
        self.opt_state = AdamWState.zeros([p for _, p in self.named_params])
        self.generator = torch.Generator().manual_seed(cfg.shuffle_seed)
        self.history: list[dict[str, Any]] = []  # per-step metrics (device tensors)
        self.step_ends: list[float] = []  # host clock after each step's logger call
        log_json({"event": "train_start", "model": cfg.model_ckpt, "device": str(self.device),
                  "params": sum(p.numel() for _, p in self.named_params),
                  "param_tensors": len(self.named_params), "total_steps": self.total_steps,
                  "compute_dtype": cfg.compute_dtype, "grad_accum_steps": cfg.grad_accum_steps})

    def evaluate(self, epoch: int | None = None, step: int | None = None) -> dict[str, float]:
        """ROUGE of the validation set (no validation set: nothing), logged
        as one ``eval`` line with ``step`` and ``epoch``.  The eval batch is
        ``eval_batch_size`` (0: ``batch_size``), at most the set's size.
        The model runs in eval mode under no_grad and is back in training
        mode after (``Evaluator.run``)."""
        if self.val_ds is None:
            return {}
        cfg = self.cfg
        eval_batch = min(cfg.eval_batch_size or cfg.batch_size, len(self.val_ds))
        scores = self.evaluator.run(self.val_ds, global_batch=eval_batch,
                                    bucket_multiple=cfg.pad_to_multiple,
                                    max_source_length=cfg.max_source_length)
        if epoch is not None:
            scores["epoch"] = float(epoch)
        log_json({"event": "eval", **({"step": step} if step is not None else {}), **scores})
        return scores

    def train(self) -> dict[str, Any]:
        cfg = self.cfg
        logger = MetricLogger(every=cfg.log_every_steps)
        step = 0
        last_eval: dict[str, float] = {}
        t0 = time.perf_counter()
        for epoch in range(cfg.num_epochs):
            for batch in self.batches.epoch(epoch):
                metrics = train_step(
                    self.model, self.named_params, self.opt_state, self.spec, self.schedule,
                    put_batch(batch, self.device), grad_accum_steps=cfg.grad_accum_steps,
                    label_smoothing=cfg.label_smoothing, generator=self.generator,
                )
                step += 1
                self.history.append(metrics)
                logger.step(step, metrics["loss"], lr=metrics["learning_rate"],
                            tokens=batch_tokens(batch), epoch=epoch)
                self.step_ends.append(time.perf_counter())
                if cfg.evaluation_steps > 0 and step % cfg.evaluation_steps == 0:
                    last_eval = self.evaluate(epoch, step=step)
            # the epoch's partial metric window first, then its eval
            logger.flush(step, epoch=epoch)
            last_eval = self.evaluate(epoch, step=step)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        wall = time.perf_counter() - t0
        log_json({"event": "done", "steps": step, "wall_seconds": wall})
        return {"steps": step, "wall_seconds": wall, "final_eval": last_eval}

    def save_final(self) -> str:
        """The final artifact, as the JAX trainer writes it (the reference's
        ``model.save_pretrained(output_dir)``): ``<output_dir>/model/``
        holds the fp32 master weights as an HF checkpoint (``config.json``
        + ``model.safetensors``), ``train_config.json`` (this run's
        TrainConfig) and a Valohai metadata sidecar for each file.  Returns
        the directory."""
        t0 = time.perf_counter()
        out = os.path.join(self.cfg.output_dir, "model")
        save_hf_checkpoint(out, self.loaded.family, self.loaded.config, self.model.state_dict())
        with open(os.path.join(out, "train_config.json"), "w") as f:
            f.write(self.cfg.to_json())
        save_valohai_metadata(out)
        log_json({"event": "saved", "path": out, "seconds": time.perf_counter() - t0})
        return out
