"""The trainer (port of the JAX package's ``train/trainer.py``): dataset ->
bucketed batches (assembled ``--prefetch-batches`` ahead on a thread,
``data/prefetch.py``) -> the epoch loop of ``train_step`` -> the
JSON step lines of ``MetricLogger``, an ``eval`` line (ROUGE of the
validation set's generated summaries or continuations, ``evaluate``) every
``evaluation_steps`` steps and at each epoch's end -> a final checkpoint
and ``save_final``, the fine-tuned model as an HF checkpoint.

A seq2seq model (T5, BART) trains on ``SummarizationDataset``; a causal one
(LLaMA) on ``CausalLMDataset`` (prompt + target, the loss masked over the
prompt), its label width capped at ``max_source_length`` like its inputs,
with the next-token loss (``--fused-ce``: vocab-chunked) and ``--remat``
for any family.

Weights are random-init from ``seed``, or read from a local HF checkpoint
directory (``--model-ckpt <dir>``), with fp32 master copies (the training
build of ``models/registry.py``); activations run in the compute dtype.
Dropout seeds (the residual dropout's and the attention-probs dropout's)
come from a CPU ``torch.Generator`` seeded with ``shuffle_seed``, so a
step draws nothing on the device; the eval pass draws no seed, so a run
with evaluation trains exactly as one without.  Losses stay device
tensors until a logging step converts them.

Fault tolerance, as in the JAX package:

- checkpoints (``io/checkpoint.py``) of the whole training state (the
  fp32 parameters, AdamW's moments and count) every
  ``--save-every-steps``, and at the end of every run, each with a
  recovery sidecar (the data cursor and the quarantine set);
- resume: a run whose ``<output_dir>/checkpoints`` holds steps restores
  the newest verified one (copied into the live parameters and moments,
  so the fused AdamW kernel's leaf table stays valid) and its exact data
  cursor; if steps exist but none verifies, it refuses to start;
- SIGTERM/SIGINT finish the step in flight, save and return
  ``preempted``; the handlers are restored when ``train`` returns;
- ``--health on``: the watchdog (``obs/health.py``) over the health
  numerics of fused AdamW's per-leaf sums, with the flight recorder, and
  ``--on-anomaly`` warn / halt / checkpoint / rewind (``train/recovery.py``:
  rewind -> skip_batch -> halt);
- ``--chaos``: the deterministic injections, ``host_loss`` among them;
- host loss (``--on-host-loss``): "reshard" tears the process group down
  and re-creates it on the surviving ranks (``core/mesh.py
  reinitialize_distributed``; at one process the group is kept), builds a
  fresh model on the new mesh (``elastic_mesh_spec``, or the test hook
  ``_next_mesh_override``), restores the newest verified checkpoint
  through the resharding path and resumes from its cursor; "halt" saves
  and stops.

Telemetry (``obs/``, ``TrainerObs``): the ``--obs`` sink, host-clock spans
around the loop's data wait, dispatch, cadenced readback, eval,
checkpoint and fingerprint, the step-time budget (its one device sync at
the log cadence; the cadence step's optimizer tail timed in the step),
the startup gauges (FLOPs a step for the window MFU, the collective byte
account; again after an elastic rebuild), the memory account after each
layout's first step and the ``memory_window`` watermark, the profiler's
windows (the model's module scopes, ``obs/devprof.open_module_scopes``,
opened for a capture's length and read by the device account), the heartbeat, the health watchdog, the
flight recorder, and on an out-of-memory error the memory postmortem
before the error goes on.

The dropout generator is seeded at construction: a resumed run does not
carry the stream of the run it resumes (neither does the JAX package's),
while the in-process rewind restores the generator state of the save it
rewinds to, so the replay draws the same masks.

Over a process group (``core/mesh.py``; one process a GPU) the ``--mesh``
lays the ranks out on ``data`` x ``fsdp``: each rank trains on its rows of
every global batch (``BatchIterator``'s host slice, the widths agreed
once an epoch), with its mesh position folded into every dropout seed;
``fsdp`` > 1 shards the model (``parallel/fsdp.py``; HSDP with ``data`` >
1 too), ``data`` alone replicates it and the step all-reduces the
gradients.  The ranks agree on every branch that runs collectives: the
health verdict (``agree_and_emit``), the preemption flag (an all-gather
every ``log_every_steps`` and at each epoch's end), the checkpoint to
restore (process 0 verifies).  Process 0 alone writes the sidecars, the
chaos corruption and the final model; every rank writes its own shards of
a checkpoint (``io/checkpoint.py``).
"""

from __future__ import annotations

import dataclasses
import json
import os
import signal
import time
from typing import Any, Iterable, Iterator, Sequence

import numpy as np
import torch

from distributed_llms_example_tpu_torch.core.config import TrainConfig
from distributed_llms_example_tpu_torch.core.mesh import (
    MeshSpec,
    build_mesh,
    device_report,
    elastic_mesh_spec,
    local_device,
    mesh_coords,
    process_allgather,
    process_count,
    process_index,
    reinitialize_distributed,
    resolve_mesh_shape,
)
from distributed_llms_example_tpu_torch.core.precision import (
    param_dtype,
    parse_dtype,
    resolve_device,
)
from distributed_llms_example_tpu_torch.data.batching import (
    LABEL_PAD,
    BatchIterator,
    validate_batch_mesh,
)
from distributed_llms_example_tpu_torch.data.dataset import CausalLMDataset, SummarizationDataset
from distributed_llms_example_tpu_torch.data.prefetch import Prefetcher
from distributed_llms_example_tpu_torch.data.tokenizer import get_tokenizer
from distributed_llms_example_tpu_torch.evaluation.evaluate import Evaluator
from distributed_llms_example_tpu_torch.io.checkpoint import (
    Checkpointer,
    ShardLayout,
    write_json_atomic,
)
from distributed_llms_example_tpu_torch.io.valohai_meta import save_valohai_metadata
from distributed_llms_example_tpu_torch.models.export import full_state_dict, save_hf_checkpoint
from distributed_llms_example_tpu_torch.models.registry import LoadedModel, load_model
from distributed_llms_example_tpu_torch.obs import TrainerObs
from distributed_llms_example_tpu_torch.obs.chaos import corrupt_checkpoint, parse_chaos
from distributed_llms_example_tpu_torch.obs.health import health_enabled
from distributed_llms_example_tpu_torch.obs.recorder import batch_fingerprint
from distributed_llms_example_tpu_torch.obs.sink import build_sink, flush, install_sink
from distributed_llms_example_tpu_torch.ops.fused_dropout import set_shard_coords
from distributed_llms_example_tpu_torch.parallel.fsdp import local, shard_model
from distributed_llms_example_tpu_torch.train.optim import (
    AdamWState,
    OptimizerSpec,
    linear_schedule_with_warmup,
)
from distributed_llms_example_tpu_torch.train.recovery import RecoveryController
from distributed_llms_example_tpu_torch.train.step import StepGroups, param_buckets, train_step
from distributed_llms_example_tpu_torch.utils.backoff import sleep_backoff
from distributed_llms_example_tpu_torch.utils.jsonlog import MetricLogger, log_json


def put_batch(batch: dict[str, np.ndarray], device: torch.device) -> dict[str, torch.Tensor]:
    """Host int32 arrays → device int64 tensors (pinned, asynchronous copy
    on CUDA).  Over a process group the arrays are the rank's rows of the
    global batch (``BatchIterator``), and they stay this rank's: the JAX
    package's global arrays are these rows side by side."""
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        out[k] = t.long()
    return out


def batch_tokens(batch: dict[str, np.ndarray], is_seq2seq: bool = True) -> int:
    """Non-pad tokens of one batch: source plus target for seq2seq; for a
    causal batch the attention mask already covers prompt and target, so
    the labels are not counted again."""
    tokens = int(np.sum(batch["attention_mask"]))
    if is_seq2seq:
        tokens += int(np.sum(batch["labels"] != LABEL_PAD))
    return tokens


class Trainer:
    def __init__(self, cfg: TrainConfig, train_records: Sequence[dict], *,
                 val_records: Sequence[dict] | None = None, loaded: LoadedModel | None = None):
        """``val_records``: the validation set; without it there is no
        evaluation.  ``loaded``: a model the caller built for training (fp32 master
        weights, the compute dtype, on ``cfg.device``, its attention route,
        remat policy and loss in its construction: ``--attention-impl``,
        ``--remat`` and ``--fused-ce`` are refused beside it) in place of
        loading ``cfg.model_ckpt``, for a configuration that no registry
        name or HF config expresses, such as T5 with ``attn_dropout_rate``
        > 0 or LLaMA with residual dropout."""
        self.cfg = cfg
        # the sink first: every line below goes through --obs's channel
        install_sink(build_sink(cfg.obs, cfg.output_dir))
        self.device = resolve_device(cfg.device)
        world = process_count()
        if world > 1 and self.device.type == "cuda":
            self.device = local_device("cuda")
        self._set_mesh(resolve_mesh_shape(cfg.mesh, world))
        if loaded is None:
            loaded = load_model(
                cfg.model_ckpt, dtype=parse_dtype(cfg.compute_dtype), device=self.device,
                attention_impl=cfg.attention_impl or None, seed=cfg.seed, train=True,
                remat=cfg.remat, remat_policy=cfg.remat_policy, fused_ce=cfg.fused_ce,
            )
        elif loaded.module.dtype != parse_dtype(cfg.compute_dtype) \
                or loaded.device.type != self.device.type:
            kind = "seq2seq" if loaded.is_seq2seq else "causal"
            raise ValueError(f"the given {loaded.family} model ({loaded.module.dtype} on "
                             f"{loaded.device}) is not a {kind} model in {cfg.compute_dtype} "
                             f"on {self.device}")
        elif cfg.attention_impl or cfg.remat or cfg.fused_ce:
            raise ValueError("--attention-impl, --remat and --fused-ce apply to a loaded model; "
                             "a built one takes its route, remat policy and loss from its "
                             "construction")
        loaded.module.train()
        self.loaded = loaded
        self.tokenizer = get_tokenizer(cfg.tokenizer, cfg.model_ckpt)

        def dataset(records):
            if not self.loaded.is_seq2seq:
                # decoder-only: prompt + target, the loss masked over the prompt
                return CausalLMDataset(
                    records, self.tokenizer, max_length=cfg.max_source_length,
                    max_target_length=cfg.max_target_length, source_column=cfg.source_column,
                    target_column=cfg.target_column,
                )
            return SummarizationDataset(
                records, self.tokenizer, max_source_length=cfg.max_source_length,
                max_target_length=cfg.max_target_length, source_column=cfg.source_column,
                target_column=cfg.target_column,
            )

        self.train_ds = dataset(train_records)
        self.val_ds = dataset(val_records) if val_records else None
        self._lay_out()
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
        self.generator = torch.Generator().manual_seed(cfg.shuffle_seed)
        # per-step metrics (device tensors) of the run's trajectory: a rewind
        # or a reshard drops the steps it undoes
        self.history: list[dict[str, Any]] = []
        self.step_ends: list[float] = []  # host clock after each step's logger call
        self.result: dict[str, Any] | None = None  # what train() returned
        self.chaos = parse_chaos(cfg.chaos)
        self.recovery = RecoveryController(max_rewinds=cfg.max_rewinds)
        self._save_ordinal = 0  # chaos ckpt_corrupt ticks on save ordinals
        self._preempted = False
        self._host_lost = False
        self._prev_handlers: dict = {}
        # test hook: the mesh of the next topology change (a MeshSpec); None
        # re-resolves --mesh against the surviving ranks (elastic_mesh_spec)
        self._next_mesh_override: MeshSpec | None = None
        if self.groups.world > 1:
            log_json({"event": "device_report", **device_report(self.device),
                      "mesh": {"data": self.mesh_spec.data, "fsdp": self.mesh_spec.fsdp}})
        log_json({"event": "train_start", "model": cfg.model_ckpt, "device": str(self.device),
                  "params": sum(p.numel() for _, p in self.named_params),
                  "param_tensors": len(self.named_params), "total_steps": self.total_steps,
                  "compute_dtype": cfg.compute_dtype, "grad_accum_steps": cfg.grad_accum_steps,
                  "remat": self.model.remat_policy, "fused_ce": bool(
                      getattr(self.loaded.config, "fused_ce", False))})
        self.start_step = self._last_step = 0
        # the (epoch, pos) data cursor and the quarantine set of the restored
        # step ride its recovery sidecar: after a quarantine skip the cursor
        # drifts from step % steps_per_epoch
        self._resume_cursor: tuple[int, int] | None = None
        if cfg.checkpoint.resume and self.checkpointer.latest_step() is not None:
            t0 = time.perf_counter()
            restored = self.checkpointer.restore_latest(self.state_tensors(),
                                                        shapes=self.state_shapes())
            if restored is None:
                # steps EXIST but none verified: training from step 0 would
                # let retention delete the possibly salvageable steps
                raise ValueError(
                    f"resume: checkpoints exist under {self.checkpointer.directory} "
                    f"(steps {self.checkpointer.all_steps()}) but none passed "
                    "integrity verification — see the ckpt_verify_failed events "
                    "for per-file detail; inspect/restore the step dirs against "
                    "their integrity-<step>.json manifests, or pass --no-resume "
                    "to train from scratch (which will eventually retention-"
                    "delete the corrupt steps)")
            self.start_step = self._load_state(restored)
            log_json({"event": "resumed", "step": self.start_step})
            saved = self._saved_layout(restored[1])
            if saved != self._live_mesh_layout():
                self._emit_reshard_restore(saved, self.start_step,
                                           reshard_wall_s=round(time.perf_counter() - t0, 4))
            side = self._load_recovery_sidecar(self.start_step)
            if side is not None:
                self._resume_cursor = (int(side["epoch"]), int(side["pos"]))
                for e, st, rec in side.get("quarantined", []):
                    self.recovery.quarantined[(int(e), int(st))] = rec
                log_json({"event": "recovery_cursor_restored", "step": self.start_step,
                          "epoch": self._resume_cursor[0], "pos": self._resume_cursor[1],
                          "quarantined": len(self.recovery.quarantined)})
        # the telemetry bundle (spans, budget, gauges, profiler, memory,
        # heartbeat, health, recorder), last, as in the JAX package: its
        # first window opens here
        self.obs = TrainerObs(cfg, self.device, start_step=self.start_step)
        self._startup_gauges()

    # -- the mesh and what is laid out on it ------------------------------

    def _set_mesh(self, spec: MeshSpec) -> None:
        """The (data, fsdp) layout of the live group: checked against the
        global batch, the DeviceMesh and this rank's dropout seed fold."""
        world = process_count()
        validate_batch_mesh(self.cfg.batch_size, {"data": spec.data, "fsdp": spec.fsdp},
                            process_count=world, grad_accum_steps=self.cfg.grad_accum_steps)
        self.mesh_spec = spec
        self.mesh = build_mesh(spec, self.device.type) if world > 1 else None
        # every rank draws each dropout seed from the shared stream and folds
        # its (data, fsdp, expert) position in, as the JAX package's shards do
        set_shard_coords((*mesh_coords(spec, process_index()), 0) if world > 1 else None)

    def _lay_out(self) -> None:
        """Everything that depends on the mesh and the model: the sharding,
        the step's process groups, the evaluator, the batch plan (the global
        batch is kept; this rank's rows follow the mesh), the named
        parameters, AdamW's moments, the health buckets and the
        checkpointer's shard layout."""
        cfg, world = self.cfg, process_count()
        self.model = self.loaded.module
        sharded = self.mesh_spec.fsdp > 1
        if sharded:
            shard_model(self.model, self.mesh)
        self.groups = StepGroups(world=world,
                                 shard_group=self.mesh.get_group("fsdp") if sharded else None)
        self.evaluator = None
        if self.val_ds:
            self.evaluator = Evaluator(self.model, self.loaded.config, self.tokenizer,
                                       num_beams=cfg.num_beams,
                                       max_new_tokens=cfg.eval_max_new_tokens,
                                       is_seq2seq=self.loaded.is_seq2seq)
        # a causal batch's inputs and labels share one width: both capped at
        # max_source_length, so their buckets agree
        tgt_cap = self._tgt_cap = (cfg.max_target_length if self.loaded.is_seq2seq
                                   else cfg.max_source_length)
        self.batches = BatchIterator(
            self.train_ds, global_batch=cfg.batch_size, process_count=world,
            process_index=process_index(), seed=cfg.shuffle_seed,
            bucket_multiple=cfg.pad_to_multiple, max_source_length=cfg.max_source_length,
            max_target_length=tgt_cap,
        )
        # (name, parameter): a DTensor when sharded; AdamW's moments and the
        # checkpoints hold the rank's shard (``local``)
        self.named_params = list(self.model.named_parameters())
        self.opt_state = AdamWState.zeros([local(p.detach()) for _, p in self.named_params])
        self.health_buckets = param_buckets(self.model) if health_enabled(cfg) else None
        self.checkpointer = Checkpointer(
            os.path.join(cfg.output_dir, "checkpoints"),
            save_every_steps=cfg.checkpoint.save_every_steps, keep=cfg.checkpoint.keep,
            async_save=cfg.checkpoint.async_save,
            layout=ShardLayout.of(self.mesh_spec, process_index()) if world > 1 else None)

    def _startup_gauges(self) -> None:
        """The gauges of the live layout (at startup and after a rebuild),
        and the model whose scopes a capture opens."""
        self.obs.model = self.model
        self.obs.startup_gauges(
            self.model, model_name=self.cfg.model_ckpt, data=self.mesh_spec.data,
            fsdp=self.mesh_spec.fsdp, global_batch=self.cfg.batch_size,
            src_len=self.cfg.max_source_length, tgt_len=self._tgt_cap,
            is_seq2seq=self.loaded.is_seq2seq)

    def _live_mesh_layout(self) -> dict:
        return {"axes": {"data": self.mesh_spec.data, "fsdp": self.mesh_spec.fsdp},
                "processes": self.groups.world}

    @staticmethod
    def _saved_layout(meta: dict) -> dict:
        """The layout a checkpoint was saved under (one process's save
        records none: one rank, data 1 x fsdp 1)."""
        return meta.get("mesh_layout") or {"axes": {"data": 1, "fsdp": 1}, "processes": 1}

    def _emit_reshard_restore(self, saved: dict, step: int, **extra: Any) -> None:
        """The ``reshard_restore`` line: a checkpoint crossed a layout on
        its way back in (what ``obs.report``'s recovery timeline reads)."""
        live = self._live_mesh_layout()
        log_json({"event": "reshard_restore", "step": int(step), "old_mesh": saved["axes"],
                  "old_processes": saved["processes"], "new_mesh": live["axes"],
                  "new_processes": live["processes"], "ef_mode": "none", **extra}, local=True)

    def evaluate(self, epoch: int | None = None, step: int | None = None) -> dict[str, float]:
        """ROUGE of the validation set (no validation set: nothing), logged
        as one ``eval`` line with ``step`` and ``epoch``.  The eval batch is
        ``eval_batch_size`` (0: ``batch_size``), at most the set's size.
        The model runs in eval mode under no_grad and is back in training
        mode after (``Evaluator.run``)."""
        if self.val_ds is None:
            return {}
        cfg = self.cfg
        # at most the set's size, a multiple of the ranks: each generates
        # its rows of every eval batch
        pc = self.groups.world
        eval_batch = min(cfg.eval_batch_size or cfg.batch_size, max(pc, len(self.val_ds)))
        eval_batch = max(pc, eval_batch - eval_batch % pc)
        scores = self.evaluator.run(self.val_ds, global_batch=eval_batch,
                                    bucket_multiple=cfg.pad_to_multiple,
                                    max_source_length=cfg.max_source_length)
        if epoch is not None:
            scores["epoch"] = float(epoch)
        log_json({"event": "eval", **({"step": step} if step is not None else {}), **scores})
        return scores

    # -- state and checkpoints ------------------------------------------

    def state_tensors(self) -> dict[str, torch.Tensor]:
        """The training state a checkpoint holds, by name: each fp32 master
        parameter by its port name, its AdamW moments as ``mu/<name>`` and
        ``nu/<name>`` (the live tensors, not copies; a sharded model's: the
        rank's shards)."""
        out = {n: local(p.detach()) for n, p in self.named_params}
        for (n, _), mu, nu in zip(self.named_params, self.opt_state.mu, self.opt_state.nu):
            out[f"mu/{n}"] = mu
            out[f"nu/{n}"] = nu
        return out

    def state_shapes(self) -> dict[str, tuple[int, ...]]:
        """The global shape of each tensor of ``state_tensors``."""
        out = {}
        for n, p in self.named_params:
            for k in (n, f"mu/{n}", f"nu/{n}"):
                out[k] = tuple(p.shape)
        return out

    @torch.no_grad()
    def _load_state(self, restored) -> int:
        """Copy a restored step into the live parameters and moments (their
        addresses, hence the fused AdamW kernel's leaf table, stay) and set
        AdamW's count; returns the step."""
        tensors, meta, step = restored
        for name, t in self.state_tensors().items():
            t.copy_(tensors[name])
        self.opt_state.count = int(meta["count"])
        return int(step)

    def _save_checkpoint(self, step: int, epoch: int, pos: int) -> bool:
        """Every save (cadence, rewind anchor, anomaly, preemption, final)
        goes through here, so the rewind's snapshot (the dropout
        generator's state and the data cursor), the recovery sidecar and
        the chaos ``ckpt_corrupt`` ordinal miss none."""
        if not self.checkpointer.save(step, self.state_tensors(), {"count": self.opt_state.count},
                                      shapes=self.state_shapes()):
            return False
        self._save_ordinal += 1
        self.recovery.note_save(step, rng=self.generator.get_state(), epoch=epoch, pos=pos)
        self._write_recovery_sidecar(step, epoch, pos)
        if self.chaos.take("ckpt_corrupt", self._save_ordinal):
            # the files AND their manifest first: verification, not a torn
            # write, must catch the corruption
            self.checkpointer.wait()
            if process_index() == 0:  # one writer corrupts one shared file
                corrupt_checkpoint(self.checkpointer.step_dir(step))
        return True

    def _write_recovery_sidecar(self, step: int, epoch: int, pos: int) -> None:
        """The data cursor and the quarantine set beside the checkpoint
        (atomic; process 0 writes it).  The generator's state stays in
        memory: a bit-exact replay is a same-process property, as in the
        JAX package."""
        if process_index() != 0:
            return
        payload = {"step": int(step), "epoch": int(epoch), "pos": int(pos),
                   "quarantined": [[e, s, rec]
                                   for (e, s), rec in self.recovery.quarantined.items()]}
        try:
            write_json_atomic(self.checkpointer.recovery_path(step), payload)
        except OSError as e:
            # best effort: a resume without it takes the arithmetic cursor
            log_json({"event": "recovery_sidecar_write_failed", "step": int(step),
                      "error": str(e)[:200]})

    def _load_recovery_sidecar(self, step: int) -> dict | None:
        try:
            with open(self.checkpointer.recovery_path(step)) as f:
                return json.load(f)
        except (OSError, json.JSONDecodeError):
            return None

    def _with_data_retries(self, batches: Iterable[dict]) -> Iterator[dict]:
        """The epoch's batches with the chaos ``data_error`` injection
        point and its retry (capped backoff, ``data_retry`` lines).  The
        injected error is raised before the iterator is touched, so the
        retry re-fetches cleanly; an error from the iterator itself
        propagates (a generator that raised is finished)."""
        class _Injected(OSError):
            pass

        it = iter(batches)
        while True:
            attempt, delay = 0, 0.05
            while True:
                try:
                    if self.chaos.take("data_error", self._last_step + 1):
                        raise _Injected("chaos: injected transient data-read error")
                    batch = next(it)
                    break
                except StopIteration:
                    return
                except _Injected as e:
                    attempt += 1
                    log_json({"event": "data_retry", "step": self._last_step + 1,
                              "attempt": attempt, "backoff_s": round(delay, 3),
                              "error": str(e)[:200]})
                    delay = sleep_backoff(delay, cap_s=2.0)
            yield batch

    # -- preemption ------------------------------------------------------

    def _install_preemption_handler(self) -> None:
        """SIGTERM/SIGINT -> finish the step in flight, checkpoint, return.
        A second signal gets the previous handler.  No-op outside the main
        thread (the signal module's restriction)."""
        self._preempted = False

        def on_signal(signum, frame):
            self._preempted = True
            log_json({"event": "preemption_signal", "signal": int(signum)})
            prev = self._prev_handlers.get(signum)
            if prev is not None:
                signal.signal(signum, prev)

        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                self._prev_handlers[sig] = signal.signal(sig, on_signal)
            except ValueError:  # not the main thread
                return

    def _restore_signal_handlers(self) -> None:
        for sig, handler in self._prev_handlers.items():
            signal.signal(sig, handler)
        self._prev_handlers = {}

    def _agreed_flags(self) -> tuple[bool, bool]:
        """(preempted, host lost), the same on every rank.  Every rank must
        stop or tear down at the same step, or one saves while the others
        run the next step's collectives: both local flags go through one
        all-gather, and any rank's flag holds for them all.  (The
        ``host_loss@K`` schedule is the same on every rank; the gather is
        the belt the preemption flag wears too.)"""
        flags = (self._preempted, self._host_lost)
        if self.groups.world == 1:
            return flags
        agreed = process_allgather(np.asarray(flags, np.int64)).any(axis=0)
        return bool(agreed[0]), bool(agreed[1])

    def _check_signals(self, step: int) -> tuple[bool, bool]:
        """The step loop's preemption and host-loss checks: one process
        reads its flags every step; a group agrees every ``log_every_steps``
        steps (the step counter is the same on every rank, so all enter the
        gather together), a signal acted on at most that many steps late."""
        if self.groups.world > 1 and step % max(1, self.cfg.log_every_steps):
            return False, False
        return self._agreed_flags()

    # -- recovery --------------------------------------------------------

    def _handle_rewind(self, step: int, epoch: int, pos: int) -> tuple[int, int, int] | None:
        """The ``rewind`` action: the escalation (rewind / skip_batch /
        halt) and its execution.  Returns the (epoch, pos, step) cursor the
        loop resumes at, or None to stop (``_anomaly_action`` set)."""
        t0 = time.perf_counter()
        anomaly = self.obs.last_anomaly or {"step": step, "code": "unknown"}
        a_step = int(anomaly.get("step", step))
        recorder = self.obs.recorder
        fingerprint = recorder.fingerprint_for(a_step) if recorder is not None else None
        decision = self.recovery.decide(anomaly, fingerprint=fingerprint)
        action, reason = decision.action, decision.reason
        if action != "halt" and fingerprint is not None:
            # quarantine first: evidence even if the restore below fails
            self.recovery.quarantine(fingerprint["epoch"], fingerprint["epoch_step"], fingerprint,
                                     reason=f"anomaly:{anomaly.get('code')}@{a_step}")
        if action == "skip_batch":
            log_json({"event": "recovery", "action": "skip_batch", "step": a_step,
                      "detected_at_step": int(step), "code": anomaly.get("code"),
                      "reason": reason})
            return epoch, pos, step
        if action == "rewind":
            restored, rewind_err = None, None
            try:
                restored = self.checkpointer.restore_before(a_step, self.state_tensors(),
                                                            shapes=self.state_shapes())
            except (OSError, ValueError, KeyError) as e:
                rewind_err = e
            if restored is None:
                action = "halt"
                reason = (f"no verified checkpoint older than anomaly step {a_step}"
                          + (f" ({str(rewind_err)[:160]})" if rewind_err else ""))
            else:
                rstep = self._load_state(restored)
                # steps newer than the target may hold the poisoned state
                # with clean checksums: the replay saves them again
                self.checkpointer.delete_after(rstep)
                snap = self.recovery.snapshot_for(rstep)
                if snap is not None:
                    # the dropout generator and the data cursor as they
                    # stood at that save: the replay is bit-identical
                    self.generator.set_state(snap["rng"])
                    r_epoch, r_pos = snap["epoch"], snap["pos"]
                else:
                    # a step of an earlier run (resume, then rewind): its
                    # sidecar's cursor; the dropout stream goes on
                    side = self._load_recovery_sidecar(rstep)
                    if side is not None:
                        r_epoch, r_pos = int(side["epoch"]), int(side["pos"])
                    else:
                        r_epoch, r_pos = divmod(rstep, self.batches.steps_per_epoch())
                kept = max(0, rstep - self.start_step)
                del self.history[kept:], self.step_ends[kept:]
                self.obs.pending_health = []
                log_json({"event": "recovery", "action": "rewind", "step": a_step,
                          "detected_at_step": int(step), "code": anomaly.get("code"),
                          "restored_step": int(rstep), "steps_lost": int(step - rstep),
                          "rewind_index": self.recovery.rewinds_done,
                          "max_rewinds": self.recovery.max_rewinds,
                          "quarantined": fingerprint is not None,
                          "recovery_wall_s": round(time.perf_counter() - t0, 4),
                          "reason": reason})
                return r_epoch, r_pos, int(rstep)
        self._anomaly_action = "halt"
        log_json({"event": "recovery", "action": "halt", "step": a_step,
                  "detected_at_step": int(step), "code": anomaly.get("code"), "reason": reason})
        return None

    def _rebuild_for_mesh(self, spec: MeshSpec) -> None:
        """Lay the run out again on a new mesh: FSDP2's parameters are tied
        to the old DeviceMesh and its groups, so a fresh module of the same
        config (fp32 masters, uninitialised: the restore that must follow
        fills every parameter) is built and sharded on the new mesh, and
        everything derived from the model and the mesh is rebuilt
        (``_lay_out``).  The global batch is kept."""
        old = self.loaded.module
        cls, dtype, remat = type(old), old.dtype, old.remat_policy
        # drop the old model's every reference before its replacement exists
        self.model = self.named_params = self.opt_state = self.evaluator = None
        self.loaded = dataclasses.replace(self.loaded, module=None)
        del old
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        self._set_mesh(spec)
        module = cls(self.loaded.config, dtype=dtype,
                     param_dtype=param_dtype(dtype, self.device, train=True),
                     device=self.device, remat_policy=remat).train()
        self.loaded = dataclasses.replace(self.loaded, module=module)
        self._lay_out()
        self._startup_gauges()  # the new layout's FLOPs and byte account

    def _handle_topology_change(self, step: int) -> tuple[int, int, int] | None:
        """The agreed host-loss action (every rank at the same step, with
        the prefetch thread stopped): under "reshard", the save in flight
        joined and the card drained, the group re-created on the survivors
        when the old layout had several processes (one process keeps its
        group), the run rebuilt on the new mesh, the newest verified
        checkpoint restored through the resharding path, and the cursor,
        quarantine set and dropout stream of that save back.  Returns the
        (epoch, pos, step) the loop resumes at, or None to stop
        (``_anomaly_action``: "checkpoint" under "halt", "halt" when the
        re-init, the rebuild or the restore failed)."""
        t0 = time.perf_counter()
        self._host_lost = False
        old = self._live_mesh_layout()
        halt_reason = None
        if self.cfg.on_host_loss != "reshard":
            halt_reason = "--on-host-loss halt: leaving recovery to a resumed run"
        log_json({"event": "topology_change", "step": int(step), "old_mesh": old["axes"],
                  "old_processes": old["processes"],
                  "policy": "halt" if halt_reason else "reshard",
                  **({"reason": halt_reason} if halt_reason else {})}, local=True)
        flush(fsync=True)
        if halt_reason:
            self._anomaly_action = "checkpoint"
            return None
        # nothing in flight may straddle the teardown
        self.checkpointer.wait()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        try:
            world = process_count()
            if old["processes"] > 1:
                world = reinitialize_distributed(device_type=self.device.type)
            spec = self._next_mesh_override or elastic_mesh_spec(self.cfg.mesh, world)
            self._next_mesh_override = None
            self._rebuild_for_mesh(spec)
            restored = self.checkpointer.restore_latest(self.state_tensors(),
                                                        shapes=self.state_shapes())
        except Exception as e:  # any failure of the recovery halts the run, recorded
            restored, reason = None, f"topology rebuild/restore failed: {e!r}"[:300]
        else:
            reason = "no verified checkpoint to reshard from"
        if restored is None:
            log_json({"event": "recovery", "action": "halt", "step": int(step),
                      "code": "host_loss", "reason": reason}, local=True)
            flush(fsync=True)
            self._anomaly_action = "halt"
            return None
        rstep = self._load_state(restored)
        # the cursor and the quarantine set as at that save: the in-memory
        # snapshot first (the dropout generator too, so the replay draws the
        # same masks), then the sidecar, then arithmetic
        snap = self.recovery.snapshot_for(rstep)
        side = self._load_recovery_sidecar(rstep)
        if side is not None:
            for e, st, rec in side.get("quarantined", []):
                self.recovery.quarantined.setdefault((int(e), int(st)), rec)
        if snap is not None:
            self.generator.set_state(snap["rng"])
            r_epoch, r_pos = snap["epoch"], snap["pos"]
        elif side is not None:
            r_epoch, r_pos = int(side["epoch"]), int(side["pos"])
        else:
            r_epoch, r_pos = divmod(rstep, self.batches.steps_per_epoch())
        kept = max(0, rstep - self.start_step)
        del self.history[kept:], self.step_ends[kept:]
        self.obs.pending_health = []
        self._emit_reshard_restore(self._saved_layout(restored[1]), rstep,
                                   detected_at_step=int(step), steps_lost=int(step - rstep),
                                   reshard_wall_s=round(time.perf_counter() - t0, 4))
        flush(fsync=True)
        return r_epoch, r_pos, rstep

    # -- the loop --------------------------------------------------------

    def train(self) -> dict[str, Any]:
        """Every epoch from the resume point; returns {"steps",
        "wall_seconds", "final_eval"} plus ``"preempted": True`` or
        ``"anomaly": <policy>`` when the run stopped early (also kept as
        ``self.result``).  A run that completes saves its final checkpoint
        and the model (``save_final``); a preempted or anomalous one saves
        only the checkpoint its policy asks for."""
        # handlers restored in a finally: a raising step must not leave the
        # flag-setting handler installed process-wide
        self._install_preemption_handler()
        try:
            self.result = self._train_loop()
            return self.result
        except Exception as e:
            # the evidence before the traceback: the flight recorder, and on
            # an out-of-memory error the memory postmortem
            if self.obs.recorder is not None:
                self.obs.recorder.dump(self.cfg.output_dir, reason="exception",
                                       step=self._last_step)
            if self.obs.memory is not None:
                self.obs.memory.maybe_dump_postmortem(self.cfg.output_dir, step=self._last_step,
                                                      error=e)
            flush(fsync=True)
            raise
        finally:
            self._restore_signal_handlers()

    def _train_loop(self) -> dict[str, Any]:
        cfg, obs = self.cfg, self.obs
        logger = MetricLogger(every=cfg.log_every_steps)
        step = self.start_step
        self._last_step = step
        self._anomaly_action: str | None = None
        last_eval: dict[str, float] = {}
        t0 = time.perf_counter()
        # (epoch, pos) is the DATA cursor: pos counts the batches of the epoch
        # consumed, quarantine-skipped ones included; step counts optimizer
        # steps (checkpoints, the LR schedule)
        if self._resume_cursor is not None:
            epoch, pos = self._resume_cursor
        else:
            epoch, pos = divmod(step, self.batches.steps_per_epoch())
        report_epoch = epoch
        if cfg.on_anomaly == "rewind" and self.checkpointer.latest_step() is None:
            # the rewind anchor: an anomaly before the first periodic save
            # still finds a step to restore
            self._save_checkpoint(step, epoch, pos)
            self.checkpointer.wait()
        while epoch < cfg.num_epochs:
            report_epoch = epoch
            rewind_cursor = None
            host_lost = False
            # host batches assembled prefetch_batches ahead on a thread; a
            # resumed or rewound epoch skips at the index level
            epoch_batches = self.batches.epoch(epoch, start_step=pos)
            if cfg.prefetch_batches > 0:
                epoch_batches = Prefetcher(epoch_batches, depth=cfg.prefetch_batches)
            try:
                for batch in obs.wrap_batches(self._with_data_retries(epoch_batches)):
                    pos += 1
                    if self.recovery.should_skip(epoch, pos - 1, batch):
                        continue
                    obs.profiler.before_step(step + 1)
                    if self.chaos.take("oom", step + 1):
                        raise RuntimeError("RESOURCE_EXHAUSTED: chaos-injected out of memory "
                                           f"before step {step + 1}")
                    if self.chaos.take("nan_grad", step + 1):
                        with torch.no_grad():
                            p0 = local(self.named_params[0][1])
                            if p0.numel():
                                p0.view(-1)[0] = float("nan")
                    with obs.host_span():  # the budget's host_overhead
                        fingerprint = (batch_fingerprint(batch, epoch=epoch, epoch_step=pos - 1)
                                       if obs.recorder is not None else None)
                    opt_timer = obs.optimizer_timer(step + 1)
                    first_of_layout = obs.memory_account_pending()
                    if first_of_layout:
                        obs.before_first_step()
                    with obs.step_span():
                        metrics = train_step(
                            self.model, self.named_params, self.opt_state, self.spec,
                            self.schedule, put_batch(batch, self.device),
                            grad_accum_steps=cfg.grad_accum_steps,
                            label_smoothing=cfg.label_smoothing, generator=self.generator,
                            health_buckets=self.health_buckets,
                            is_seq2seq=self.loaded.is_seq2seq, groups=self.groups,
                            opt_timer=opt_timer,
                        )
                    if first_of_layout:
                        with obs.host_span():
                            obs.after_first_step(
                                self.named_params,
                                [*self.opt_state.mu, *self.opt_state.nu, self.opt_state.stats],
                                [p.grad for _, p in self.named_params],
                                model_name=cfg.model_ckpt,
                                mesh={"data": self.mesh_spec.data, "fsdp": self.mesh_spec.fsdp})
                    step += 1
                    self._last_step = step
                    self.history.append(metrics)
                    # the rank's tokens times the ranks: the global batch's, as
                    # the JAX package counts them
                    tokens = batch_tokens(batch, self.loaded.is_seq2seq) * self.groups.world
                    # at the log cadence only: the queue drain, timed before
                    # the logger reads the loss
                    obs.budget_probe(step, metrics["loss"])
                    with obs.sync_span():
                        logger.step(step, metrics["loss"], lr=metrics["learning_rate"],
                                    tokens=tokens, epoch=epoch)
                    self.step_ends.append(time.perf_counter())
                    action = obs.on_step(step, epoch, metrics, fingerprint)
                    if action in ("halt", "checkpoint"):
                        self._anomaly_action = action
                        break
                    if action == "rewind":
                        rewind_cursor = self._handle_rewind(step, epoch, pos)
                        break
                    # the cadence step's optimizer time, past the window's
                    # drain: the next window's optimizer_apply_ms
                    obs.optimizer_probe(opt_timer)
                    if self.checkpointer.should_save(step):
                        with obs.checkpoint_span():
                            self._save_checkpoint(step, epoch, pos)
                    if cfg.evaluation_steps > 0 and step % cfg.evaluation_steps == 0:
                        with obs.eval_span():
                            last_eval = self.evaluate(epoch, step=step)
                    # their time is on their own spans, not the next step's
                    obs.spans.mark_step_start()
                    if self.chaos.take("sigterm", step):
                        # a real signal through the real handler
                        os.kill(os.getpid(), signal.SIGTERM)
                    if self.chaos.take("host_loss", step):
                        # the agreed topology-change signal: the schedule is
                        # the same on every rank
                        self._host_lost = True
                    preempted, host_lost = self._check_signals(step)
                    if host_lost:
                        break  # handled once the prefetch thread has stopped
                    if preempted:
                        self._preempted = True
                        break
            finally:
                # the producer thread stops even when the loop body raises
                if isinstance(epoch_batches, Prefetcher):
                    epoch_batches.close()
                    # is the input pipeline on the critical path? (the
                    # consumer's blocked time, once an epoch)
                    st = epoch_batches.stats()
                    log_json({"event": "prefetch_stats", "epoch": epoch,
                              "depth": cfg.prefetch_batches, "items": st["items"],
                              "consumer_wait_s": round(st["consumer_wait_s"], 4)})
            if rewind_cursor is not None:
                # same process: no reload, the replay skips the quarantined batch
                epoch, pos, step = rewind_cursor
                self._last_step = step
                obs.spans.mark_step_start()
                continue
            if host_lost:
                cursor = self._handle_topology_change(step)
                if cursor is None:
                    break  # _anomaly_action set
                # the epoch re-enters with the rebuilt batch plan at the
                # restored step's cursor
                epoch, pos, step = cursor
                self._last_step = step
                obs.spans.mark_step_start()
                continue
            # a signal that landed between two agreement steps set only the
            # local flag: every rank reaches the epoch's end at the same
            # step, so agree here before eval's collectives
            self._preempted = self._agreed_flags()[0]
            if self._preempted or self._anomaly_action is not None:
                break
            # the epoch's partial metric window first, then its eval
            logger.flush(step, epoch=epoch)
            with obs.eval_span():
                last_eval = self.evaluate(epoch, step=step)
            obs.spans.mark_step_start()
            epoch += 1
            pos = 0
        logger.flush(step, epoch=report_epoch)
        # the final partial window's budget, health check (a NaN in the last
        # steps still fires) and span summary; the file channel to disk
        final_action = obs.finalize(step, report_epoch,
                                    sync_on=self.history[-1]["loss"] if self.history else None)
        if self._anomaly_action is None and final_action in ("halt", "checkpoint", "rewind"):
            # a rewind agreed in the final window has no loop left to replay:
            # keep the evidence and stop, never export possibly poisoned
            # weights as a finished run
            self._anomaly_action = "checkpoint" if final_action == "rewind" else final_action
        if self._anomaly_action is not None:
            if self._anomaly_action == "checkpoint":
                self._save_checkpoint(step, epoch, pos)
                self.checkpointer.wait()
            wall = time.perf_counter() - t0
            log_json({"event": "anomaly_stop", "step": step, "policy": self._anomaly_action,
                      "wall_seconds": wall})
            return {"steps": step, "wall_seconds": wall, "final_eval": last_eval,
                    "anomaly": self._anomaly_action}
        if self._preempted:
            if obs.recorder is not None:
                obs.recorder.dump(cfg.output_dir, reason="preemption", step=step)
            self._save_checkpoint(step, epoch, pos)
            self.checkpointer.wait()
            wall = time.perf_counter() - t0
            log_json({"event": "preempted", "step": step, "wall_seconds": wall})
            return {"steps": step, "wall_seconds": wall, "final_eval": last_eval,
                    "preempted": True}
        self._save_checkpoint(self.total_steps, epoch, pos)
        self.checkpointer.wait()
        self.save_final()
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
        TrainConfig) and a Valohai metadata sidecar for each file.  A
        sharded model is gathered leaf by leaf to process 0's host (every
        rank joins every gather) and process 0 writes.  Returns the
        directory."""
        t0 = time.perf_counter()
        out = os.path.join(self.cfg.output_dir, "model")
        state = full_state_dict(self.model)
        if process_index() != 0:
            return out
        save_hf_checkpoint(out, self.loaded.family, self.loaded.config, state)
        with open(os.path.join(out, "train_config.json"), "w") as f:
            f.write(self.cfg.to_json())
        save_valohai_metadata(out)
        log_json({"event": "saved", "path": out, "seconds": time.perf_counter() - t0})
        return out
