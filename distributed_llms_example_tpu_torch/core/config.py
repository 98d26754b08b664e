"""Training configuration: the slice of the JAX package's ``TrainConfig``
and ``add_reference_args`` that the port implements (flag names and
defaults as there), plus ``--device`` and ``--seed``.  A flag the port does
not implement is not accepted: argparse rejects it.  ``config_from_args``
also checks, as the JAX package's does, what can be checked before the
run: the rewind's prerequisites, the ``--chaos`` grammar (and the
checkpoint cadence a ``host_loss`` reshard restores from) and the
``--mesh`` axes (``data`` and ``fsdp`` only: the model-parallel axes are a
later slice, ROADMAP.md item 6)."""

from __future__ import annotations

import argparse
import dataclasses
import difflib
import json
import os
import tempfile

from distributed_llms_example_tpu_torch.utils.remat import REMAT_POLICIES


# The mesh axis names of the JAX package, in its order (``core/config.py``).
AXES: tuple[str, ...] = ("stage", "data", "fsdp", "expert", "sequence", "tensor")
# the axes the port lays out over a torch.distributed process group
PORTED_AXES = ("data", "fsdp")

# Speculative-decode draft cap: the verify step scores spec_tokens + 1
# positions in one decode-kernel call, and the kernel's q block holds at
# most 8 rows (ops/flash_attention.py MAX_DECODE_Q_ROWS), so at most 7
# drafts ride each round.  Kept here, free of the ops stack, so the CLI
# validates --spec-tokens at parse time.
SPEC_MAX_DRAFT_TOKENS = 7


def unknown_axis_error(name: str) -> ValueError:
    hint = difflib.get_close_matches(name, AXES, n=1)
    did_you_mean = f" (did you mean {hint[0]!r}?)" if hint else ""
    return ValueError(
        f"unknown mesh axis {name!r}{did_you_mean}; valid axes: {', '.join(AXES)}")


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Logical device mesh shape (the JAX package's): ``data`` replicates
    the parameters, ``fsdp`` shards them (ZeRO-3); the batch is split over
    both.  -1 absorbs the devices the other axes leave (at most one axis).
    The port runs ``data`` and ``fsdp``; the others stay 1."""

    data: int = -1
    fsdp: int = 1
    sequence: int = 1
    tensor: int = 1
    stage: int = 1
    expert: int = 1

    def axis_sizes(self) -> dict[str, int]:
        return {"stage": self.stage, "data": self.data, "fsdp": self.fsdp,
                "expert": self.expert, "sequence": self.sequence, "tensor": self.tensor}


def parse_mesh_arg(spec: str) -> MeshConfig:
    """``"data=2,fsdp=4"`` -> MeshConfig (the JAX package's parser: the
    wildcard stays on ``data`` unless another axis takes it).  An axis the
    port does not lay out must be 1: anything else raises ValueError."""
    kw: dict[str, int] = {}
    if spec.strip():
        for part in spec.split(","):
            k, _, v = part.partition("=")
            k = k.strip()
            if k not in AXES:
                raise unknown_axis_error(k)
            kw[k] = int(v)
    if "data" not in kw:
        kw["data"] = 1 if -1 in kw.values() else -1
    unported = {k: v for k, v in kw.items() if k not in PORTED_AXES and v != 1}
    if unported:
        raise ValueError(f"--mesh {spec!r}: the port lays out data and fsdp only; "
                         f"{unported} needs tensor, sequence, pipeline or expert "
                         "parallelism, a later slice (ROADMAP.md item 6)")
    return MeshConfig(**kw)


@dataclasses.dataclass(frozen=True)
class CheckpointConfig:
    """Checkpoint/resume policy (``io/checkpoint.py``)."""

    save_every_steps: int = 0  # 0 = only at the end of training
    keep: int = 3
    resume: bool = True  # resume from the newest verified step in output_dir/checkpoints
    async_save: bool = True


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    model_ckpt: str = "t5-small"
    # <output_dir>/model/: the final HF checkpoint; the JAX default
    # /tmp/dllm-tpu-out, under the process's temporary directory ($TMPDIR)
    output_dir: str = os.path.join(tempfile.gettempdir(), "dllm-tpu-out")
    train_file: str = ""
    val_file: str = ""  # "" or a missing file = no evaluation
    tokenizer: str = ""
    source_column: str = ""
    target_column: str = ""
    batch_size: int = 8  # global batch: one optimizer step
    num_epochs: int = 1
    warmup_steps: int = 500
    learning_rate: float = 5e-5
    weight_decay: float = 0.01
    max_grad_norm: float = 1.0
    label_smoothing: float = 0.0
    grad_accum_steps: int = 1
    shuffle_seed: int = 1234  # data order and the dropout seed stream
    pad_to_multiple: int = 128
    max_source_length: int = 1024
    max_target_length: int = 128
    compute_dtype: str = "bfloat16"
    log_every_steps: int = 100
    evaluation_steps: int = 500  # eval every N steps (0 = only at each epoch's end)
    num_beams: int = 2
    eval_max_new_tokens: int = 128
    eval_batch_size: int = 0  # 0 = batch_size
    attention_impl: str = ""  # "" = model default (auto)
    remat: bool = False  # activation checkpointing of the transformer blocks
    remat_policy: str = "full"  # "full" | "dots" (utils/remat.py)
    fused_ce: bool = False  # vocab-chunked LM head + loss (causal families)
    prefetch_batches: int = 2  # host batches assembled ahead of the device; 0 = off
    device: str = "cuda"
    seed: int = 0  # random-init seed for the weights
    checkpoint: CheckpointConfig = dataclasses.field(default_factory=CheckpointConfig)
    # telemetry (obs/): "stdout" prints every line (process 0); "jsonl" also
    # writes them, schema-stamped, to <output_dir>/obs/metrics-p{rank}.jsonl;
    # "off" turns the obs instrumentation off (the stdout lines stay)
    obs: str = "stdout"
    # heartbeat cadence in steps (0 = off): every rank probes at the same step
    obs_heartbeat_steps: int = 0
    # a rank named laggard this many heartbeats in a row: host_loss_suspect
    # (detection only; 0 = off)
    obs_heartbeat_suspect_beats: int = 3
    # the step-time budget (obs/budget.py): "auto" = on unless --obs off
    obs_budget: str = "auto"
    # training health (obs/health.py): "on" adds the health numerics to every
    # step and runs the watchdog at the log cadence; "auto" = on under --obs
    # jsonl
    health: str = "auto"
    # an anomaly's policy: "warn" logs and continues; "halt" stops; "checkpoint"
    # saves a resumable checkpoint, dumps the flight recorder and stops;
    # "rewind" restores the last verified checkpoint in-process, quarantines
    # the batch and retries (rewind -> skip_batch -> halt, train/recovery.py;
    # needs --save-every-steps and the flight recorder)
    on_anomaly: str = "warn"
    max_rewinds: int = 2
    # an agreed host loss: "reshard" tears the process group down, re-creates
    # it on the surviving ranks, rebuilds the model on the new mesh and
    # restores the newest verified checkpoint through the resharding path;
    # "halt" saves a checkpoint and stops
    on_host_loss: str = "reshard"
    # flight-recorder ring in steps (0 = off), dumped on anomaly/SIGTERM/crash
    recorder_steps: int = 256
    health_loss_spike_factor: float = 4.0
    health_grad_norm_factor: float = 10.0
    health_warmup_steps: int = 20
    # deterministic fault injection (obs/chaos.py), e.g. "nan_grad@3,sigterm@5"
    chaos: str = ""
    # the startup gauges (obs/gauges.py: FLOPs a step, the collective byte
    # account) and the memory account: "auto" = on under --obs jsonl
    obs_gauges: str = "auto"
    # the MFU denominator per card: the H100 SXM's dense bf16 TFLOP/s
    obs_peak_tflops: float = 989.0
    # the device-memory ceiling of the memory account's fit verdict (H100)
    hbm_budget_gib: float = 80.0
    # torch.profiler capture (obs/profile.py): "" = no --profile-dir; the
    # count form ("3": 3 steps after the first, needs profile_dir) or an
    # inclusive step window ("100:105", under output_dir unless profile_dir)
    profile_dir: str = ""
    profile_steps: int | str = 3
    # the trigger file polled every step ("" = <output_dir>/obs/profile.trigger
    # when obs is on)
    profile_trigger: str = ""
    # an agreed anomaly arms the trigger: the next steps are captured
    profile_on_anomaly: bool = False
    # the device mesh over the process group (core/mesh.py), and the
    # rendezvous triple (empty: Valohai, then VH_* / torchrun env)
    mesh: MeshConfig = dataclasses.field(default_factory=MeshConfig)
    coordinator_address: str = ""
    num_processes: int = 0
    process_id: int = -1

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, sort_keys=True)


def add_model_args(p: argparse.ArgumentParser) -> argparse.ArgumentParser:
    """The flags that training and ``serve`` share: which model, how its
    text is read, where it runs and how its weights are drawn."""
    d = TrainConfig()
    p.add_argument("--model-ckpt", type=str, default=d.model_ckpt)
    p.add_argument("--tokenizer", type=str, default=d.tokenizer)
    p.add_argument("--source-column", type=str, default=d.source_column)
    p.add_argument("--max-source-length", type=int, default=d.max_source_length)
    p.add_argument("--attention-impl", type=str, default=d.attention_impl,
                   choices=("", "auto", "flash", "ring", "xla"))
    p.add_argument("--device", type=str, default=d.device, choices=("cuda", "cpu"))
    p.add_argument("--seed", type=int, default=d.seed, help="random-init seed for the weights")
    return p


def add_train_args(p: argparse.ArgumentParser) -> argparse.ArgumentParser:
    d = TrainConfig()
    add_model_args(p)
    p.add_argument("--output-dir", type=str, default=d.output_dir,
                   help="the final HF checkpoint goes to <output-dir>/model/")
    p.add_argument("--train-file", type=str, default=d.train_file,
                   help="path to train.json (JSON array, JSONL or {\"data\": [...]}); "
                        "without it, train.json beside the Valohai 'dataset' input")
    p.add_argument("--val-file", type=str, default=d.val_file,
                   help="path to val.json: ROUGE of the generated summaries every "
                        "--evaluation-steps and at each epoch's end")
    p.add_argument("--target-column", type=str, default=d.target_column)
    p.add_argument("--batch-size", type=int, default=d.batch_size)
    p.add_argument("--num-epochs", type=int, default=d.num_epochs)
    p.add_argument("--warmup-steps", type=int, default=d.warmup_steps)
    p.add_argument("--learning-rate", type=float, default=d.learning_rate)
    p.add_argument("--weight-decay", type=float, default=d.weight_decay)
    p.add_argument("--max-grad-norm", type=float, default=d.max_grad_norm)
    p.add_argument("--label-smoothing", type=float, default=d.label_smoothing)
    # the reference's name for it, as valohai.yaml passes it, in both
    # spellings (the JAX CLI's aliases)
    p.add_argument("--grad-accum-steps", "--gradient-accumulation-steps",
                   "--gradient_accumulation_steps", dest="grad_accum_steps", type=int,
                   default=d.grad_accum_steps,
                   help="microbatches a step: --batch-size stays the optimizer batch")
    p.add_argument("--shuffle-seed", type=int, default=d.shuffle_seed)
    p.add_argument("--pad-to-multiple", type=int, default=d.pad_to_multiple)
    p.add_argument("--max-target-length", type=int, default=d.max_target_length)
    p.add_argument("--compute-dtype", type=str, default=d.compute_dtype,
                   choices=("float32", "bfloat16"))
    p.add_argument("--remat", action="store_true",
                   help="checkpoint every transformer block: activations recomputed in the "
                        "backward")
    p.add_argument("--remat-policy", type=str, default=d.remat_policy, choices=REMAT_POLICIES,
                   help="full: save nothing; dots: save the matmul outputs, recompute the rest")
    p.add_argument("--fused-ce", action="store_true",
                   help="vocab-chunked fused LM-head + cross-entropy (causal families; the "
                        "logits never materialize)")
    p.add_argument("--prefetch-batches", type=int, default=d.prefetch_batches,
                   help="host batches assembled ahead on a thread (0 = off)")
    p.add_argument("--log-every-steps", type=int, default=d.log_every_steps)
    p.add_argument("--evaluation-steps", type=int, default=d.evaluation_steps)
    p.add_argument("--num-beams", type=int, default=d.num_beams)
    p.add_argument("--eval-max-new-tokens", type=int, default=d.eval_max_new_tokens)
    p.add_argument("--eval-batch-size", type=int, default=d.eval_batch_size)
    p.add_argument("--save-every-steps", type=int, default=d.checkpoint.save_every_steps,
                   help="checkpoint the whole training state every N steps to "
                        "<output-dir>/checkpoints/<step>/ (0 = only at the end)")
    p.add_argument("--no-resume", action="store_true",
                   help="train from step 0 even where <output-dir>/checkpoints holds steps")
    p.add_argument("--obs", type=str, default=d.obs, choices=("off", "stdout", "jsonl"),
                   help="telemetry (obs/): stdout-only events, + JSONL file under the "
                        "output dir, or off (metric stdout always stays on)")
    p.add_argument("--obs-heartbeat-steps", type=int, default=d.obs_heartbeat_steps)
    p.add_argument("--obs-heartbeat-suspect-beats", type=int,
                   default=d.obs_heartbeat_suspect_beats,
                   help="consecutive heartbeats a rank must be named laggard before "
                        "the pod-agreed host_loss_suspect event fires (detection + "
                        "report row only; --on-host-loss policy unchanged; 0 = off)")
    p.add_argument("--obs-budget", type=str, default=d.obs_budget,
                   choices=("auto", "on", "off"),
                   help="step-time budget accounting: per-window wall time decomposed "
                        "into data_wait/dispatch/device_busy/sync_block/host_overhead "
                        "with a dispatch_efficiency gauge and the off-cadence "
                        "host-transfer tripwire (step_budget events).  auto = on "
                        "whenever --obs is not off")
    p.add_argument("--obs-gauges", type=str, default=d.obs_gauges, choices=("auto", "on", "off"),
                   help="the startup gauges (FLOPs a step from one meta-device pass, the "
                        "collective byte account) and the memory account (auto = only under "
                        "--obs jsonl)")
    p.add_argument("--obs-peak-tflops", type=float, default=d.obs_peak_tflops,
                   help="peak TFLOP/s a card, the MFU denominator (H100 SXM dense bf16 = 989)")
    p.add_argument("--hbm-budget-gib", type=float, default=d.hbm_budget_gib,
                   help="device-memory ceiling in GiB of the memory account's fit verdict and "
                        "the report's memory gates (H100 = 80)")
    p.add_argument("--profile-dir", type=str, default=d.profile_dir)
    p.add_argument("--profile-steps", type=str, default=str(d.profile_steps),
                   help="torch.profiler capture: a step count ('3', needs --profile-dir) or "
                        "an inclusive step window ('100:105')")
    p.add_argument("--profile-trigger", type=str, default=d.profile_trigger,
                   help="trigger file polled every step for an on-demand capture (default: "
                        "<output-dir>/obs/profile.trigger when --obs is on)")
    p.add_argument("--profile-on-anomaly", action="store_true", default=d.profile_on_anomaly,
                   help="arm the profile trigger when the health watchdog agrees an anomaly: "
                        "the following steps are captured and parsed into a device_account")
    p.add_argument("--health", type=str, default=d.health, choices=("auto", "on", "off"),
                   help="health numerics (param norm, per-bucket update ratios, "
                        "non-finite gradient count) and the anomaly watchdog at the log "
                        "cadence (auto = on under --obs jsonl)")
    p.add_argument("--on-anomaly", type=str, default=d.on_anomaly,
                   choices=("warn", "halt", "checkpoint", "rewind"),
                   help="anomaly policy: warn and continue, halt, save a resumable "
                        "checkpoint and stop, or rewind in-process to the last verified "
                        "checkpoint, quarantine the batch and retry (rewind -> skip-batch "
                        "-> halt; needs --save-every-steps and the flight recorder)")
    p.add_argument("--max-rewinds", type=int, default=d.max_rewinds,
                   help="in-process rewind budget for --on-anomaly rewind")
    p.add_argument("--on-host-loss", type=str, default=d.on_host_loss,
                   choices=("reshard", "halt"),
                   help="agreed topology-change policy: reshard — tear the process "
                        "group down, re-create it on the surviving ranks, rebuild the "
                        "model on the new mesh and restore the newest verified "
                        "checkpoint through the resharding path (needs "
                        "--save-every-steps); halt — checkpoint the evidence and stop, "
                        "leaving recovery to a resumed run (the resume reshards either "
                        "way)")
    p.add_argument("--recorder-steps", type=int, default=d.recorder_steps,
                   help="flight-recorder ring in steps (0 = off); dumped to "
                        "<output-dir>/obs/flight-recorder-p<rank>.json on anomaly/SIGTERM/crash")
    p.add_argument("--chaos", type=str, default=d.chaos,
                   help="deterministic fault injection: comma list of kind@tick with kind "
                        "in nan_grad/ckpt_corrupt/data_error/sigterm/host_loss/oom (tick = "
                        "global step; for ckpt_corrupt the Nth checkpoint save)")
    p.add_argument("--health-loss-spike-factor", type=float, default=d.health_loss_spike_factor)
    p.add_argument("--health-grad-norm-factor", type=float, default=d.health_grad_norm_factor)
    p.add_argument("--health-warmup-steps", type=int, default=d.health_warmup_steps)
    p.add_argument("--mesh", type=str, default="data=-1",
                   help="comma list axis=size over the process group: data=N (replicated "
                        "parameters), fsdp=N (sharded), or both (HSDP)")
    # the multi-process rendezvous triple (else Valohai, VH_* or torchrun env)
    p.add_argument("--coordinator-address", type=str, default=d.coordinator_address)
    p.add_argument("--num-processes", type=int, default=d.num_processes)
    p.add_argument("--process-id", type=int, default=d.process_id)
    return p


def config_from_args(args: argparse.Namespace) -> TrainConfig:
    """The TrainConfig of parsed train flags; raises ValueError for what
    would only fail mid-run: a negative --max-rewinds, --on-anomaly rewind
    without periodic checkpoints or the flight recorder, a --chaos
    grammar error, ``--chaos host_loss@K`` under ``--on-host-loss reshard``
    without periodic checkpoints, a --mesh axis the port does not lay
    out, a malformed --profile-steps."""
    kw = {f.name: getattr(args, f.name) for f in dataclasses.fields(TrainConfig)
          if f.name not in ("checkpoint", "mesh")}
    cfg = TrainConfig(**kw, mesh=parse_mesh_arg(args.mesh), checkpoint=CheckpointConfig(
        save_every_steps=args.save_every_steps, resume=not args.no_resume))
    if cfg.max_rewinds < 0:
        raise ValueError(f"--max-rewinds must be >= 0, got {cfg.max_rewinds}")
    if cfg.prefetch_batches < 0:
        raise ValueError(f"--prefetch-batches must be >= 0, got {cfg.prefetch_batches}")
    from distributed_llms_example_tpu_torch.obs.profile import parse_profile_steps

    parse_profile_steps(cfg.profile_steps)  # a malformed window raises here
    if cfg.on_anomaly == "rewind":
        if cfg.checkpoint.save_every_steps <= 0:
            raise ValueError("--on-anomaly rewind needs periodic checkpointing to rewind TO: "
                             "set --save-every-steps N (N bounds the optimizer steps one "
                             "recovery can lose)")
        if cfg.recorder_steps <= 0:
            raise ValueError("--on-anomaly rewind quarantines the poison batch via the flight "
                             "recorder's fingerprints: set --recorder-steps N (default 256) "
                             "instead of 0")
    from distributed_llms_example_tpu_torch.obs.chaos import parse_chaos  # obs imports core

    schedule = parse_chaos(cfg.chaos)
    if (schedule.armed_at("host_loss") and cfg.on_host_loss == "reshard"
            and cfg.checkpoint.save_every_steps <= 0):
        raise ValueError("--chaos host_loss@K with --on-host-loss reshard needs a checkpoint to "
                         "reshard FROM: set --save-every-steps N (a lost host's state is gone — "
                         "topology recovery is a restore, not a migration)")
    return cfg
