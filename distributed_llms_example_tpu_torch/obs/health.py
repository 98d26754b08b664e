"""The training-health watchdog (port of the JAX package's
``obs/health.py``).

The train step's health numerics (``train/step.py``
``health_metrics_from_stats``: param norm, per-bucket update ratios and
the non-finite gradient count, from fused AdamW's per-leaf sums) stay
device tensors.  The trainer appends each step's metrics to a pending
list, and at the logging cadence ``to_host`` turns the whole window into
host floats in ONE transfer; the detectors then run per step, so an
anomaly is attributed to the step where the signal broke:

- the non-finite tripwire: a non-finite loss or grad norm, or any
  non-finite gradient element (no warmup);
- the EWMA loss spike: loss above its running mean by ``spike_factor``
  mean absolute deviations;
- the grad-norm explosion: ``grad_factor`` times the EWMA grad norm.

``agree_and_emit`` agrees on the verdict across the process group (an
all-gather of each rank's first anomaly) and logs the ``obs_anomaly``
line (process 0 on stdout, every rank in its own file); with one process
the local verdict is the agreed one.  ``LaggardStreaks`` turns a rank the
heartbeat names laggard beat after beat into a ``host_loss_suspect``
event: detection only.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Sequence

import numpy as np
import torch

from distributed_llms_example_tpu_torch.utils.jsonlog import log_json

EWMA_ALPHA = 0.05  # the weight of each new sample in the running means
CODE_IDS = {"nonfinite": 1, "loss_spike": 2, "grad_explosion": 3}
ID_CODES = {v: k for k, v in CODE_IDS.items()}


def health_enabled(cfg: Any) -> bool:
    """The ``--health`` tri-state: "on"/"off" are literal, "auto" follows
    ``--obs jsonl``."""
    if cfg.health == "on":
        return True
    if cfg.health == "off":
        return False
    return cfg.obs == "jsonl"


@dataclasses.dataclass(frozen=True)
class Anomaly:
    step: int
    code: str  # "nonfinite" | "loss_spike" | "grad_explosion"
    value: float
    detail: str


def to_host(pending: Sequence[tuple[int, Mapping[str, Any]]]) -> list[tuple[int, dict]]:
    """A window of per-step metric dicts as host floats, every tensor of
    it in ONE device-to-host transfer (one ``torch.stack(...).cpu()``):
    the only place the health path waits on the device."""
    tensors = [v for _, m in pending for v in m.values() if isinstance(v, torch.Tensor)]
    host = iter(torch.stack([t.detach().reshape(()).double() for t in tensors]).cpu().tolist()
                if tensors else [])
    return [(step, {k: next(host) if isinstance(v, torch.Tensor) else float(v)
                    for k, v in m.items()}) for step, m in pending]


class HealthWatchdog:
    """EWMA-based per-step anomaly detection over host-float metrics.  The
    EWMAs persist across windows; the detectors run per step."""

    def __init__(self, *, loss_spike_factor: float = 4.0, grad_norm_factor: float = 10.0,
                 warmup_steps: int = 20):
        self.loss_spike_factor = float(loss_spike_factor)
        self.grad_norm_factor = float(grad_norm_factor)
        self.warmup_steps = int(warmup_steps)
        self.n = 0  # finite samples absorbed
        self.loss_ewma = 0.0
        self.loss_dev_ewma = 0.0  # EWMA of |loss - mean|
        self.grad_ewma = 0.0

    def _check_one(self, step: int, m: Mapping[str, float]) -> Anomaly | None:
        loss = float(m.get("loss", 0.0))
        grad = float(m.get("grad_norm", 0.0))
        nonfinite = float(m.get("nonfinite_count", 0.0))
        if not np.isfinite(loss) or not np.isfinite(grad) or nonfinite > 0:
            return Anomaly(step=step, code="nonfinite",
                           value=nonfinite if nonfinite > 0 else loss,
                           detail=(f"loss={loss!r}, grad_norm={grad!r}, "
                                   f"{nonfinite:.0f} non-finite grad elements"))
        if self.n >= self.warmup_steps:
            if grad > self.grad_norm_factor * max(self.grad_ewma, 1e-12):
                return Anomaly(step=step, code="grad_explosion", value=grad,
                               detail=(f"grad_norm {grad:.4g} > {self.grad_norm_factor:g}× "
                                       f"EWMA {self.grad_ewma:.4g}"))
            # deviation floor: a flat loss stream must not turn epsilon
            # wiggles into spikes
            floor = max(self.loss_dev_ewma, 1e-3 * max(abs(self.loss_ewma), 1.0))
            if loss - self.loss_ewma > self.loss_spike_factor * floor:
                return Anomaly(step=step, code="loss_spike", value=loss,
                               detail=(f"loss {loss:.4g} > EWMA {self.loss_ewma:.4g} + "
                                       f"{self.loss_spike_factor:g}× deviation {floor:.4g}"))
        return None

    def _absorb(self, m: Mapping[str, float]) -> None:
        loss = float(m.get("loss", 0.0))
        grad = float(m.get("grad_norm", 0.0))
        if not (np.isfinite(loss) and np.isfinite(grad)):
            return  # never learn from garbage
        if self.n == 0:
            self.loss_ewma, self.grad_ewma = loss, grad
        else:
            a = EWMA_ALPHA
            self.loss_dev_ewma = (1 - a) * self.loss_dev_ewma + a * abs(loss - self.loss_ewma)
            self.loss_ewma = (1 - a) * self.loss_ewma + a * loss
            self.grad_ewma = (1 - a) * self.grad_ewma + a * grad
        self.n += 1

    def check(self, entries: Sequence[tuple[int, Mapping[str, float]]]) -> list[Anomaly]:
        """The detectors over one window of (step, host metrics), in step
        order; a non-finite step ends the scan.  Flagged finite samples are
        still absorbed, so a lasting level shift re-baselines the EWMAs
        instead of firing on every window."""
        out: list[Anomaly] = []
        for step, m in entries:
            a = self._check_one(step, m)
            if a is not None:
                out.append(a)
                if a.code == "nonfinite":
                    break
            self._absorb(m)
        return out


class LaggardStreaks:
    """Persistent heartbeat laggards: a rank named laggard in one heartbeat
    is a wobble; in ``suspect_beats`` consecutive heartbeats it is a
    ``host_loss_suspect`` ("go look at rank N before the next collective
    hangs").  Every rank feeds this the same gathered probe, so every rank
    computes the same suspects.  Detection and a report row only: the
    ``--on-host-loss`` policy acts on the agreed signal, never on this."""

    def __init__(self, *, suspect_beats: int = 3):
        self.suspect_beats = max(1, int(suspect_beats))
        self.streaks: dict[int, int] = {}
        self._suspected: set[int] = set()

    def update(self, laggards: Sequence[int], step: int) -> list[dict]:
        """Fold one heartbeat's laggard set; returns the suspects that cross
        the threshold this beat, as event records.  One clean beat resets a
        rank's streak and re-arms it."""
        lag = {int(r) for r in laggards}
        out: list[dict] = []
        for r in list(self.streaks):
            if r not in lag:
                self.streaks.pop(r)
                self._suspected.discard(r)
        for r in sorted(lag):
            self.streaks[r] = self.streaks.get(r, 0) + 1
            if self.streaks[r] >= self.suspect_beats and r not in self._suspected:
                self._suspected.add(r)
                out.append({"event": "host_loss_suspect", "rank": r, "step": int(step),
                            "consecutive_beats": self.streaks[r]})
        return out


def agree_and_emit(anomalies: Sequence[Anomaly], *, step: int, policy: str) -> dict | None:
    """The agreed ``obs_anomaly`` record of one window, or None when no
    rank flagged anything.  Every process calls this at the same cadence
    step with its local verdict; ``(flag, step, code)`` of each rank's
    first anomaly is all-gathered, so every rank returns the same record
    (and takes the same policy action), attributed to the earliest
    flagged step.  Process 0 prints it, every rank writes it to its own
    file; ``value``, ``detail`` and
    ``detail_rank`` are the emitting rank's own view when it flagged."""
    from distributed_llms_example_tpu_torch.core.mesh import process_allgather, process_index

    first = anomalies[0] if anomalies else None
    local = np.asarray([1 if first is not None else 0,
                        first.step if first is not None else 0,
                        CODE_IDS.get(first.code, 0) if first is not None else 0], np.int64)
    gathered = process_allgather(local)
    ranks = [i for i in range(gathered.shape[0]) if int(gathered[i, 0])]
    if not ranks:
        return None
    steps = [int(gathered[r, 1]) for r in ranks]
    r0 = ranks[int(np.argmin(steps))]
    record: dict[str, Any] = {
        "event": "obs_anomaly", "code": ID_CODES.get(int(gathered[r0, 2]), "unknown"),
        "step": int(gathered[r0, 1]), "detected_at_step": int(step), "ranks": ranks,
        "policy": policy, "process_count": int(gathered.shape[0]),
    }
    if first is not None:
        # non-finite values go as strings: "NaN" is not valid JSON
        v = float(first.value)
        record["value"] = round(v, 6) if np.isfinite(v) else repr(v)
        record["detail"] = first.detail
        record["detail_rank"] = process_index()
    log_json(record, local=True)
    return record
