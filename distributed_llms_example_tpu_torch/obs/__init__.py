"""Layered telemetry of the trainer (port of the JAX package's ``obs/``):

- ``sink``      every JSON line: stdout (the Valohai channel, process 0)
                and, under ``--obs jsonl``, each rank's
                ``<output_dir>/obs/metrics-p{rank}.jsonl``
- ``spans``     host-clock span tracing (data_wait / step_dispatch /
                device_sync / eval / checkpoint) with per-window step-time
                percentiles; no device sync
- ``budget``    each log window's wall time as an additive account and the
                off-cadence sync tripwire; its one device interaction is
                the cadenced queue drain (``sync_device``, counted); the
                optimizer-apply gauge and the device account ride it
- ``gauges``    FLOPs a step (``FlopCounterMode`` on the meta device) for
                the window MFU, and the per-step collective byte account
- ``profile``   ``torch.profiler`` captures of a step window
                (``--profile-steps 100:105``), a trigger file polled at
                step cadence, or an agreed anomaly (``--profile-on-anomaly``)
- ``devprof``   a capture reduced to the ``device_account``: device time
                per module bucket, each collective's bandwidth, overlap
- ``memprof``   the memory account of the run's state and first step, the
                ``memory_window`` watermark, OOM postmortem bundles
- ``trace``     span instances and the merged Perfetto export
- ``heartbeat`` the cross-rank liveness and step-skew probe, and the
                laggard streaks that name a ``host_loss_suspect``
- ``health``    the training-signal watchdog at the log cadence
- ``recorder``  the flight recorder, dumped on anomaly, SIGTERM or crash
- ``chaos``     deterministic fault injection
- ``report``    the offline reader of a run's JSONL:
                ``python -m distributed_llms_example_tpu_torch.obs.report <output_dir>``

``TrainerObs`` is the one object the trainer holds.
"""

from __future__ import annotations

import math
import os
from typing import Any, Iterable, Iterator

import torch

from distributed_llms_example_tpu_torch.obs.budget import (
    BudgetAccountant,
    OptimizerTimer,
    budget_enabled,
)
from distributed_llms_example_tpu_torch.obs.health import (
    HealthWatchdog,
    agree_and_emit,
    health_enabled,
    to_host,
)
from distributed_llms_example_tpu_torch.obs.heartbeat import Heartbeat
from distributed_llms_example_tpu_torch.obs.memprof import MemoryMonitor, state_memory_account
from distributed_llms_example_tpu_torch.obs.profile import (
    DEFAULT_TRIGGER_STEPS,
    ProfileController,
    TorchProfilerBackend,
)
from distributed_llms_example_tpu_torch.obs.recorder import FlightRecorder
from distributed_llms_example_tpu_torch.obs.sink import emit, flush
from distributed_llms_example_tpu_torch.obs.spans import SpanRecorder
from distributed_llms_example_tpu_torch.utils.jsonlog import log_json

__all__ = ["TrainerObs"]


class TrainerObs:
    """The trainer's telemetry bundle: the span recorder, the budget, the
    startup gauges, the profiler, the memory monitor, the trace collector,
    the heartbeat, the health watchdog and the flight recorder.  Everything
    is host bookkeeping except, at the log cadence only, the budget's queue
    drain, the health window's one transfer, and the heartbeat's gather at
    its own cadence; and the profiler's stop sync on a capture's last step."""

    def __init__(self, cfg: Any, device: torch.device, *, start_step: int = 0):
        self.cfg = cfg
        self.device = device
        self.enabled = cfg.obs != "off"
        self.spans = SpanRecorder()
        self.every = max(1, int(cfg.log_every_steps))
        self.flops_per_step: float | None = None
        self.peak_flops_per_chip = float(cfg.obs_peak_tflops) * 1e12
        self.heartbeat = (Heartbeat(cfg.obs_heartbeat_steps,
                                    suspect_beats=cfg.obs_heartbeat_suspect_beats)
                          if self.enabled and cfg.obs_heartbeat_steps > 0 else None)
        self.health_on = health_enabled(cfg)
        self.watchdog = HealthWatchdog(
            loss_spike_factor=cfg.health_loss_spike_factor,
            grad_norm_factor=cfg.health_grad_norm_factor,
            warmup_steps=cfg.health_warmup_steps) if self.health_on else None
        # on with obs or health: --obs off --health on --on-anomaly checkpoint
        # still promises a bundle beside the checkpoint
        self.recorder = (FlightRecorder(cfg.recorder_steps)
                         if cfg.recorder_steps > 0 and (self.enabled or self.health_on) else None)
        self.pending_health: list[tuple[int, dict]] = []
        self._last_health: dict[str, Any] | None = None
        # the last agreed obs_anomaly record: what the rewind consumes
        self.last_anomaly: dict[str, Any] | None = None
        self._trigger = cfg.profile_trigger or (
            os.path.join(cfg.output_dir, "obs", "profile.trigger") if self.enabled else "")
        # the startup gauges' collective byte account (the device account's
        # bandwidth join)
        self._comm_account: dict | None = None
        self.gauges_on = self.enabled and (
            cfg.obs_gauges == "on" or (cfg.obs_gauges == "auto" and cfg.obs == "jsonl"))
        # the memory account and watermark; the account is built once the
        # first step of a layout has run (``memory_account_pending``)
        self.memory = MemoryMonitor(device) if self.enabled else None
        self._memory_before: dict | None = None
        self.profile_on_anomaly = bool(cfg.profile_on_anomaly)
        # the trained model (the trainer's, set again after a rebuild): a
        # capture opens its module scopes
        self.model: torch.nn.Module | None = None
        self.profiler = self._build_profiler(start_step)
        # on the CPU every op runs in the dispatching thread: a blocked
        # dispatch is that backend's normal mode, so the tripwire stands down
        self.budget = (BudgetAccountant(self.spans, async_dispatch=device.type == "cuda")
                       if budget_enabled(cfg) else None)
        # span instances for the Perfetto export: file-channel records, so
        # only under a JSONL channel
        self.trace = None
        if self.budget is not None and cfg.obs == "jsonl":
            from distributed_llms_example_tpu_torch.obs.trace import TraceCollector

            self.trace = TraceCollector(self.spans.clock)
            self.spans.listener = self.trace

    def _build_profiler(self, start_step: int) -> ProfileController:
        ctl = ProfileController(profile_dir=self.cfg.profile_dir,
                                steps_spec=self.cfg.profile_steps, trigger_path=self._trigger,
                                start_step=start_step, output_dir=self.cfg.output_dir,
                                backend=TorchProfilerBackend(self.device.type,
                                                             lambda: self.model))
        ctl.on_capture = self._on_profile_captured
        return ctl

    # -- startup ---------------------------------------------------------

    def startup_gauges(self, model: torch.nn.Module, *, model_name: str, data: int, fsdp: int,
                       global_batch: int, src_len: int, tgt_len: int, is_seq2seq: bool) -> None:
        """The ``obs_gauges`` line (``obs/gauges.py``): FLOPs a step, the MFU
        numerator, and the collective byte account; and a memory account due
        at the next step.  Run at startup and after every elastic rebuild.  A
        gauge that cannot be had gives one ``obs_gauges_skipped``."""
        if not self.gauges_on:
            return
        self._memory_before = None
        if self.memory is not None:
            self.memory.attach_account(None)
        from distributed_llms_example_tpu_torch.obs import gauges

        try:
            with self.spans.span("obs_gauge_count"):
                report = gauges.train_step_static_gauges(
                    model, model_name=model_name, data=data, fsdp=fsdp,
                    global_batch=global_batch, src_len=src_len, tgt_len=tgt_len,
                    is_seq2seq=is_seq2seq, grad_accum_steps=self.cfg.grad_accum_steps,
                    health=self.health_on)
        except Exception as e:  # noqa: BLE001 - telemetry never fails the run
            log_json({"event": "obs_gauges_skipped", "reason": str(e)[:300]})
            return
        self.flops_per_step = report["flops_per_step"]
        self._comm_account = report.get("comm")
        log_json({"event": "obs_gauges", "peak_flops_per_chip": self.peak_flops_per_chip,
                  **report})

    # -- the memory account ----------------------------------------------

    def memory_account_pending(self) -> bool:
        """Whether the next step is the first of a layout whose memory
        account is due (gauges on, none built yet)."""
        return self.gauges_on and self.memory is not None and self.memory.account is None

    def before_first_step(self) -> None:
        """The bytes in use before the first step (None on the CPU)."""
        self._memory_before = self.memory.watermark.read()

    def after_first_step(self, named_params, opt_tensors, grads, *, model_name: str,
                         mesh: dict) -> None:
        """The ``memory_account`` line of the run's state and its first step
        (``obs/memprof.py``), kept for the OOM postmortem."""
        before, after = self._memory_before, self.memory.watermark.read()
        measured = before is not None and after is not None
        account = state_memory_account(
            named_params, opt_tensors, grads,
            before_step_bytes=before["bytes_in_use"] if measured else None,
            step_peak_bytes=after["peak_bytes_in_use"] if measured else None,
            step_set_peak=measured and after["peak_bytes_in_use"] > before["peak_bytes_in_use"],
            hbm_budget_gib=self.cfg.hbm_budget_gib, model=model_name, mesh=mesh,
            backend=self.device.type)
        self.memory.attach_account(account)
        log_json({"event": "memory_account", **account})

    # -- the step loop ---------------------------------------------------

    def wrap_batches(self, batches: Iterable[dict]) -> Iterator[dict]:
        """The batches, each wait for the next one a ``data_wait`` span."""
        it = iter(batches)
        while True:
            with self.spans.span("data_wait"):
                try:
                    batch = next(it)
                except StopIteration:
                    return
            yield batch

    def step_span(self):
        return self.spans.span("step_dispatch")

    def sync_span(self):
        return self.spans.span("device_sync")

    def host_span(self):
        """Host bookkeeping inside the step (the batch fingerprint): the
        budget's ``host_overhead``."""
        return self.spans.span("host_overhead")

    def eval_span(self):
        return self.spans.span("eval")

    def checkpoint_span(self):
        return self.spans.span("checkpoint")

    def budget_probe(self, step: int, sync_on: torch.Tensor | None) -> None:
        """At the log cadence only, time the queue drain on the step's loss
        before the logger reads it; any other step returns after two
        comparisons, with no device sync."""
        if self.budget is None or sync_on is None or step % self.every != 0:
            return
        self.budget.probe(sync_on)

    def optimizer_timer(self, step: int) -> OptimizerTimer | None:
        """A timer for ``step``'s ``optimizer_apply_block`` when ``step`` is a
        cadence step under the budget, else None."""
        if self.budget is None or step % self.every != 0:
            return None
        return OptimizerTimer(self.device)

    def optimizer_probe(self, timer: OptimizerTimer | None) -> None:
        """After the cadence step's window closed: its optimizer-apply time,
        read from the timer past the window's drain, for the next window's
        account."""
        if self.budget is not None and timer is not None:
            self.budget.probe_optimizer(timer)

    def _on_profile_captured(self, trace_dir: str, window: tuple[int, int],
                             truncated: bool = False) -> None:
        """A capture landed: its device account (``obs/devprof.py``), joined
        with the byte account, through the budget.  A gauge: a capture that
        cannot be read gives one ``device_account_skipped``."""
        if self.budget is None:
            return
        try:
            from distributed_llms_example_tpu_torch.obs.devprof import (
                device_account_from_dir,
                join_collective_bandwidth,
            )

            acct = device_account_from_dir(trace_dir)
            if acct is None:
                log_json({"event": "device_account_skipped",
                          "reason": f"no device op events under {trace_dir}"}, local=True)
                return
            steps = int(window[1] - window[0] + 1)
            acct["step"] = int(window[1])
            acct["window"] = [int(window[0]), int(window[1])]
            acct["window_steps"] = steps
            if truncated:
                acct["truncated"] = True
            join_collective_bandwidth(acct, self._comm_account, steps)
            self.budget.attach_device_account(acct)
        except Exception as e:  # noqa: BLE001 - telemetry never fails the run
            log_json({"event": "device_account_skipped", "reason": str(e)[:300]}, local=True)

    def on_step(self, step: int, epoch: int, metrics: dict,
                fingerprint: dict | None = None) -> str:
        """Per-step bookkeeping (host clocks and references), and at the
        cadences the heartbeat's gather, the budget and span windows and
        the health check; the profiler's stop (and its sync) on a capture's
        last step.  Returns the anomaly policy's action ("ok" or
        ``--on-anomaly``), the same on every rank."""
        self.profiler.after_step(step, metrics.get("loss"))
        self.spans.step_complete()
        if self.trace is not None:
            self.trace.note_step(step)  # the anchor the cross-rank merge aligns on
        if self.recorder is not None:
            self.recorder.record(step, epoch, metrics, fingerprint)
        if self.watchdog is not None:
            self.pending_health.append((step, dict(metrics)))
        if self.heartbeat is not None and step % self.heartbeat.every == 0:
            self.heartbeat.beat(step)
        action = "ok"
        if step % self.every == 0:
            # the budget first: it reads the window's records, which the
            # span summary resets
            if self.budget is not None:
                self.budget.close_window(step, epoch)
            if self.trace is not None:
                self.trace.flush(step)
            if self.watchdog is not None:
                action = self._health_cadence(step)
            if self.enabled:
                self.emit_window(step, epoch)
            elif self.budget is not None:
                self.spans.summary()  # --obs off --obs-budget on: consume the window
        return action

    def _health_cadence(self, step: int) -> str:
        """The window's health numerics to the host in one transfer, the
        detectors, the agreed verdict and, on an anomaly, the recorder's
        dump (and with ``--profile-on-anomaly`` the profile trigger armed).
        Every rank runs this at the same step."""
        if not self.pending_health:
            return "ok"
        entries = to_host(self.pending_health)
        self.pending_health = []
        if self.recorder is not None:
            for s, vals in entries:
                self.recorder.annotate(s, vals)
        # non-finite values as strings: a NaN literal is not valid JSON
        self._last_health = {
            k: (float(f"{v:.6g}") if math.isfinite(v) else repr(v))
            for k, v in entries[-1][1].items()
            if k in ("param_norm", "grad_norm", "nonfinite_count") or k.startswith("update_ratio_")}
        anomalies = self.watchdog.check(entries)
        event = agree_and_emit(anomalies, step=step, policy=self.cfg.on_anomaly)
        if event is None:
            return "ok"
        self.last_anomaly = event
        if self.profile_on_anomaly and self._trigger and not self.profiler.active:
            # the profiler's own trigger file: the next steps are captured,
            # exactly as an operator's touch would start them
            try:
                os.makedirs(os.path.dirname(self._trigger), exist_ok=True)
                with open(self._trigger, "w") as f:
                    f.write(str(DEFAULT_TRIGGER_STEPS))
                log_json({"event": "profile_trigger_armed", "step": step,
                          "reason": f"anomaly:{event['code']}"}, local=True)
            except OSError:
                pass  # a failed arm must not change the policy's action
        if self.recorder is not None:
            self.recorder.dump(self.cfg.output_dir, reason=f"anomaly:{event['code']}", step=step,
                               anomalies=anomalies)
        flush(fsync=True)  # the last window survives whatever the policy does next
        return self.cfg.on_anomaly

    def emit_window(self, step: int, epoch: int | None = None) -> None:
        """The ``obs_window`` line: the span window's summary (every rank's
        own file), with the window MFU, the last health numerics and the
        memory reading (a ``memory_window`` line of its own)."""
        summary = self.spans.summary()
        if summary is None:
            return
        record: dict[str, Any] = {"event": "obs_window", "step": step}
        if epoch is not None:
            record["epoch"] = epoch
        record.update(summary)
        mfu = self.window_mfu(summary)
        if mfu is not None:
            record["mfu"] = float(f"{mfu:.4g}")
        if self._last_health is not None:
            record["health"] = self._last_health
        if self.memory is not None:
            hbm = self.memory.sample(step)
            if hbm is not None:
                record["hbm"] = {k: hbm[k] for k in ("bytes_in_use", "peak_bytes_in_use",
                                                     "bytes_limit")}
        # through the sink itself: log_json's six decimals would flatten a
        # small MFU to 0.0
        emit(record, local=True)

    def window_mfu(self, summary: dict) -> float | None:
        """MFU over the closed window: FLOPs a step x steps over its wall
        seconds, the world size and ``--obs-peak-tflops``; None until the
        startup gauges gave the numerator."""
        if not self.flops_per_step or not summary.get("window_seconds"):
            return None
        from distributed_llms_example_tpu_torch.core.mesh import process_count
        from distributed_llms_example_tpu_torch.obs.gauges import mfu

        return mfu(self.flops_per_step,
                   summary["window_seconds"] / max(1, summary["window_steps"]),
                   process_count(), self.peak_flops_per_chip)

    def finalize(self, step: int, epoch: int | None = None, sync_on: Any = None) -> str:
        """The run's end: the profiler closed (a window still open is written,
        clamped to ``step``), the final partial window's budget account,
        health check (a NaN in the last steps still fires) and span window,
        then the file channel to disk.  Returns the final health action."""
        self.profiler.finalize(sync_on, last_step=step)
        action = "ok"
        if self.budget is not None:
            self.budget.close_window(step, epoch)
        if self.trace is not None:
            self.trace.flush(step)
        if self.watchdog is not None and self.pending_health:
            action = self._health_cadence(step)
        if self.enabled:
            self.emit_window(step, epoch)
        elif self.budget is not None:
            self.spans.summary()
        flush(fsync=True)
        return action
