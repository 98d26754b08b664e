"""Step-time budget accounting (port of the JAX package's
``obs/budget.py``): where every step's milliseconds go.

Each logging window's step wall time is closed into an additive account:

    wall = data_wait + dispatch + device_busy + sync_block
         + host_overhead + unattributed

- ``data_wait``      blocked on the input pipeline (tokenize, pad, prefetch)
- ``dispatch``       host time issuing the step (``put_batch`` + the train
                     step's launches): milliseconds while the host runs
                     ahead of the card, a whole device step when something
                     in the step waits on the card
- ``device_busy``    the cadenced queue drain: at the log cadence, and only
                     there, the budget times ``sync_device`` on the step's
                     loss before the metric logger reads it: the device
                     tail the host really waits on
- ``sync_block``     the ``device_sync`` spans (the logger's cadenced
                     device-to-host read and its line)
- ``host_overhead``  every other span inside a step (the batch fingerprint,
                     the recorder's bookkeeping); checkpoint and eval time
                     between steps is left out of the partition (the trainer
                     re-anchors the step clock after it,
                     ``SpanRecorder.mark_step_start``) and is read from the
                     ``obs_window`` span aggregates
- ``unattributed``   the remainder: loop bookkeeping in no span; the
                     account is ``additivity_ok`` while it stays under
                     ``ADDITIVITY_TOLERANCE`` of wall

Two derived signals ride each ``step_budget`` event: ``dispatch_efficiency``
= 1 - (data_wait + host_overhead + unattributed) / wall, the share of wall
in which the card was being fed or drained; and the off-cadence tripwire:
a step other than the window's last (the cadence step) whose dispatch ate
more than ``SUSPECT_FRAC`` of the window's mean step wall (and
``MIN_BLOCK_S``) was blocked on the card inside the step body:
``offcadence_sync_steps`` counts them, and ``offcadence_sync_suspect``
flags them where dispatch is asynchronous (CUDA; on the CPU every op runs
in the dispatching thread).
The first window stands down (``"warmup": true``): it holds the first
launches and the kernels' loading.

Everything here is host-clock arithmetic over the span recorder's step
records; the one device interaction is ``sync_device``, through which every
device sync of the telemetry goes, counted in ``sync_device.syncs`` as the
kernel wrappers count their launches (the profiler's stop sync apart, in
``sync_device.profile_syncs``).

Two gauges ride the account besides its components:

- ``optimizer_apply_ms`` (``probe_optimizer``), under the JAX package's key
  and with its placement (sampled after the window closes, on the next
  window's account with ``optimizer_share_of_step``).  The JAX package times
  a stand-alone jitted apply, since XLA fuses the apply into its step.  The
  port's apply is its own pair of kernel-8 launches updating the state in
  place, so a stand-alone apply would need a copy of the whole optimizer
  state; instead ``OptimizerTimer`` brackets the cadence step's own
  ``optimizer_apply_block`` with CUDA events (the host clock on the CPU),
  read once the window's drain has run: no sync of its own;
- ``attach_device_account``: a parsed profile capture (``obs/devprof.py``)
  as a bulk, local ``device_account`` event.
"""

from __future__ import annotations

import time
from typing import Any

import torch

from distributed_llms_example_tpu_torch.obs.spans import SpanRecorder
from distributed_llms_example_tpu_torch.utils.jsonlog import log_json

# the additive components, in emission order: "<name>_ms" on every
# step_budget event (obs/report.py iterates them)
COMPONENTS: tuple[str, ...] = ("data_wait", "dispatch", "device_busy", "sync_block",
                               "host_overhead", "unattributed")

# span name -> component; any other span is host_overhead
_SPAN_COMPONENT = {"data_wait": "data_wait", "step_dispatch": "dispatch",
                   "device_busy": "device_busy", "device_sync": "sync_block"}

# the unattributed share of wall under which an account is additivity_ok
ADDITIVITY_TOLERANCE = 0.05
# an off-cadence dispatch longer than this share of the window's mean step
# wall, and than MIN_BLOCK_S seconds, was blocked on the card
SUSPECT_FRAC = 0.5
MIN_BLOCK_S = 0.005


def sync_device(x: torch.Tensor | torch.device, *, purpose: str = "budget") -> None:
    """Wait until the card has finished everything queued on ``x``'s device
    (a tensor's, or a device): the telemetry's one way to wait on the card.
    Every call counts, on the CPU too (where it waits for nothing), so a
    test can count the telemetry's syncs: the budget's in
    ``sync_device.syncs``, the profiler's stop (``purpose="profile"``) in
    ``sync_device.profile_syncs``."""
    if purpose == "profile":
        sync_device.profile_syncs += 1
    else:
        sync_device.syncs += 1
    dev = x.device if isinstance(x, torch.Tensor) else torch.device(x)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


sync_device.syncs = 0
sync_device.profile_syncs = 0


class OptimizerTimer:
    """Brackets one ``optimizer_apply_block`` (a context manager): CUDA
    events on the card, the host clock on the CPU.  ``elapsed_ms`` is read
    after a drain has passed the end event."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self._t = [0.0, 0.0]
        if self.cuda:
            self._ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]

    def _mark(self, i: int) -> None:
        if self.cuda:
            self._ev[i].record()
        else:
            self._t[i] = time.perf_counter()

    def __enter__(self):
        self._mark(0)
        return self

    def __exit__(self, *exc) -> None:
        self._mark(1)

    def elapsed_ms(self) -> float:
        if self.cuda:
            return float(self._ev[0].elapsed_time(self._ev[1]))
        return (self._t[1] - self._t[0]) * 1e3


def _ms(seconds: float) -> float:
    return round(seconds * 1e3, 3)


class BudgetAccountant:
    """Closes the span recorder's window into one ``step_budget`` event.

    ``probe(x)`` is the cadenced device timing (at the log cadence, before
    the metric logger's own read, so the measured block is the real queue
    drain); ``close_window(step)`` computes the account from the per-step
    span records and emits it."""

    def __init__(self, spans: SpanRecorder, *, warmup_windows: int = 1,
                 async_dispatch: bool = True):
        self.spans = spans
        self.async_dispatch = bool(async_dispatch)
        self.warmup_windows = int(warmup_windows)
        self._closed = 0
        # the newest parsed profile capture (attach_device_account)
        self.last_device_account: dict | None = None
        # the gauges riding the account: the optimizer-apply sample
        self._gauges: dict[str, float] = {}
        self._opt_probe_dead = False

    def probe(self, x: torch.Tensor | torch.device) -> None:
        """The queue drain as a ``device_busy`` span.  The caller gates this
        to the log cadence, where the logger would wait for the same drain
        one line later."""
        with self.spans.span("device_busy"):
            sync_device(x)

    def probe_optimizer(self, timer: OptimizerTimer) -> None:
        """The cadence step's ``optimizer_apply_block`` time, read from its
        timer after the window's drain, as ``optimizer_apply_ms`` of the next
        window's account.  A gauge: a failure to read it turns the probe off
        for the run with one ``optimizer_probe_disabled`` event."""
        if self._opt_probe_dead:
            return
        try:
            self._gauges["optimizer_apply_ms"] = _ms(timer.elapsed_ms() / 1e3)
        except RuntimeError as e:  # an event never recorded or not yet reached
            self._opt_probe_dead = True
            self._gauges.pop("optimizer_apply_ms", None)
            log_json({"event": "optimizer_probe_disabled", "reason": str(e)[:300]}, local=True)

    def attach_device_account(self, account: dict) -> dict:
        """One parsed profile capture (``obs/devprof.py``) as a
        ``device_account`` event: bulk (the file channel only: its lanes
        have no place on stdout) and local (every capturing rank's file).
        Kept as ``last_device_account``."""
        record = {"event": "device_account",
                  **{k: v for k, v in account.items() if k != "event"}}
        self.last_device_account = record
        log_json(record, local=True, bulk=True)
        return record

    def close_window(self, step: int, epoch: int | None = None, *,
                     emit: bool = True) -> dict | None:
        """Fold the window's per-step records into the additive account.
        Call BEFORE ``spans.summary()`` (which resets the window).  Emits a
        ``step_budget`` event (``local``: every rank's file carries its own)
        and returns it; None when no step completed."""
        recs = self.spans.window_step_records()
        if not recs:
            return None
        wall = sum(r["dur"] for r in recs)
        if wall <= 0:
            return None
        comp = {c: 0.0 for c in COMPONENTS[:-1]}
        for r in recs:
            for name, s in r["spans"].items():
                comp[_SPAN_COMPONENT.get(name, "host_overhead")] += s
        # clock rounding can push the sum a hair past wall: never negative
        unattributed = max(0.0, wall - sum(comp.values()))
        # the window's last record is the cadence step (the probe and the
        # logger's read block there); an earlier step whose dispatch ate half
        # a mean step was blocked inside the step body
        mean_step = wall / len(recs)
        threshold = max(SUSPECT_FRAC * mean_step, MIN_BLOCK_S)
        self._closed += 1
        warmup = self._closed <= self.warmup_windows
        offcadence = 0 if warmup else sum(
            1 for r in recs[:-1] if r["spans"].get("step_dispatch", 0.0) > threshold)
        stalled = comp["data_wait"] + comp["host_overhead"] + unattributed
        acct: dict[str, Any] = {"event": "step_budget", "step": int(step),
                                "window_steps": len(recs), "wall_ms": _ms(wall)}
        if epoch is not None:
            acct["epoch"] = int(epoch)
        for c in COMPONENTS[:-1]:
            acct[f"{c}_ms"] = _ms(comp[c])
        acct["unattributed_ms"] = _ms(unattributed)
        acct["accounted_frac"] = round((wall - unattributed) / wall, 4)
        acct["additivity_ok"] = bool(unattributed <= ADDITIVITY_TOLERANCE * wall)
        acct["dispatch_efficiency"] = round(max(0.0, 1.0 - stalled / wall), 4)
        acct["offcadence_sync_steps"] = int(offcadence)
        acct["offcadence_sync_suspect"] = bool(offcadence > 0 and self.async_dispatch)
        opt_ms = self._gauges.get("optimizer_apply_ms")
        if opt_ms is not None:
            acct["optimizer_apply_ms"] = opt_ms
            acct["optimizer_share_of_step"] = round(opt_ms / max(_ms(mean_step), 1e-9), 4)
        if not self.async_dispatch:
            acct["sync_dispatch_backend"] = True
        if warmup:
            acct["warmup"] = True
        if emit:
            log_json(acct, local=True)
        return acct


def aggregate_accounts(accounts: list[dict]) -> dict | None:
    """``step_budget`` accounts folded into per-component totals and the
    wall-weighted dispatch efficiency (obs/report.py's per-rank rollup)."""
    accounts = [a for a in accounts if a.get("wall_ms")]
    if not accounts:
        return None
    wall = sum(float(a["wall_ms"]) for a in accounts)
    out: dict[str, Any] = {"windows": len(accounts),
                           "steps": sum(int(a.get("window_steps", 0)) for a in accounts),
                           "wall_ms": round(wall, 3)}
    for c in COMPONENTS:
        out[f"{c}_ms"] = round(sum(float(a.get(f"{c}_ms", 0.0) or 0.0) for a in accounts), 3)
    out["dispatch_efficiency"] = round(
        sum(float(a.get("dispatch_efficiency", 0.0) or 0.0) * float(a["wall_ms"])
            for a in accounts) / wall, 4)
    out["accounted_frac"] = round((wall - out["unattributed_ms"]) / wall, 4) if wall else None
    out["offcadence_sync_steps"] = sum(int(a.get("offcadence_sync_steps", 0) or 0)
                                       for a in accounts)
    opt = [float(a["optimizer_apply_ms"]) for a in accounts
           if a.get("optimizer_apply_ms") is not None]
    if opt:
        out["optimizer_apply_ms"] = round(sum(opt) / len(opt), 3)
        share = [float(a["optimizer_share_of_step"]) for a in accounts
                 if a.get("optimizer_share_of_step") is not None]
        if share:
            out["optimizer_share_of_step"] = round(sum(share) / len(share), 4)
    return out


def budget_enabled(cfg: Any) -> bool:
    """``--obs-budget``: "on" forces, "off" disables, "auto" follows the obs
    instrumentation (any ``--obs`` but "off")."""
    if cfg.obs_budget == "on":
        return True
    if cfg.obs_budget == "off":
        return False
    return cfg.obs != "off"
