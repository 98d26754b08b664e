"""Layered telemetry of the trainer (port of the JAX package's ``obs/``):

- ``sink``      every JSON line: stdout (the Valohai channel, process 0)
                and, under ``--obs jsonl``, each rank's
                ``<output_dir>/obs/metrics-p{rank}.jsonl``
- ``spans``     host-clock span tracing (data_wait / step_dispatch /
                device_sync / eval / checkpoint) with per-window step-time
                percentiles; no device sync
- ``budget``    each log window's wall time as an additive account and the
                off-cadence sync tripwire; its one device interaction is
                the cadenced queue drain (``sync_device``, counted)
- ``heartbeat`` the cross-rank liveness and step-skew probe, and the
                laggard streaks that name a ``host_loss_suspect``
- ``health``    the training-signal watchdog at the log cadence
- ``recorder``  the flight recorder, dumped on anomaly, SIGTERM or crash
- ``chaos``     deterministic fault injection
- ``report``    the offline reader of a run's JSONL:
                ``python -m distributed_llms_example_tpu_torch.obs.report <output_dir>``

``TrainerObs`` is the one object the trainer holds.  The JAX package's
startup gauges (HLO FLOPs), profiler, memory monitor and trace export are
a later slice of the port.
"""

from __future__ import annotations

import math
from typing import Any, Iterable, Iterator

import torch

from distributed_llms_example_tpu_torch.obs.budget import BudgetAccountant, budget_enabled
from distributed_llms_example_tpu_torch.obs.health import (
    HealthWatchdog,
    agree_and_emit,
    health_enabled,
    to_host,
)
from distributed_llms_example_tpu_torch.obs.heartbeat import Heartbeat
from distributed_llms_example_tpu_torch.obs.recorder import FlightRecorder
from distributed_llms_example_tpu_torch.obs.sink import flush
from distributed_llms_example_tpu_torch.obs.spans import SpanRecorder
from distributed_llms_example_tpu_torch.utils.jsonlog import log_json

__all__ = ["TrainerObs"]


class TrainerObs:
    """The trainer's telemetry bundle: the span recorder, the budget, the
    heartbeat, the health watchdog and the flight recorder.  Everything is
    host bookkeeping except, at the log cadence only, the budget's queue
    drain, the health window's one transfer, and the heartbeat's gather at
    its own cadence."""

    def __init__(self, cfg: Any, device: torch.device):
        self.cfg = cfg
        self.enabled = cfg.obs != "off"
        self.spans = SpanRecorder()
        self.every = max(1, int(cfg.log_every_steps))
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
        # on the CPU every op runs in the dispatching thread: a blocked
        # dispatch is that backend's normal mode, so the tripwire stands down
        self.budget = (BudgetAccountant(self.spans, async_dispatch=device.type == "cuda")
                       if budget_enabled(cfg) else None)

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

    def on_step(self, step: int, epoch: int, metrics: dict,
                fingerprint: dict | None = None) -> str:
        """Per-step bookkeeping (host clocks and references), and at the
        cadences the heartbeat's gather, the budget and span windows and
        the health check.  Returns the anomaly policy's action ("ok" or
        ``--on-anomaly``), the same on every rank."""
        self.spans.step_complete()
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
        dump.  Every rank runs this at the same step."""
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
        if self.recorder is not None:
            self.recorder.dump(self.cfg.output_dir, reason=f"anomaly:{event['code']}", step=step,
                               anomalies=anomalies)
        flush(fsync=True)  # the last window survives whatever the policy does next
        return self.cfg.on_anomaly

    def emit_window(self, step: int, epoch: int | None = None) -> None:
        """The ``obs_window`` line: the span window's summary (every rank's
        own file), with the last health numerics."""
        summary = self.spans.summary()
        if summary is None:
            return
        record: dict[str, Any] = {"event": "obs_window", "step": step}
        if epoch is not None:
            record["epoch"] = epoch
        record.update(summary)
        if self._last_health is not None:
            record["health"] = self._last_health
        log_json(record, local=True)

    def finalize(self, step: int, epoch: int | None = None) -> str:
        """The run's end: the final partial window's budget account, health
        check (a NaN in the last steps still fires) and span window, then
        the file channel to disk.  Returns the final health action."""
        action = "ok"
        if self.budget is not None:
            self.budget.close_window(step, epoch)
        if self.watchdog is not None and self.pending_health:
            action = self._health_cadence(step)
        if self.enabled:
            self.emit_window(step, epoch)
        elif self.budget is not None:
            self.spans.summary()
        flush(fsync=True)
        return action
