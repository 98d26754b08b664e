"""Host-side span tracing for the train loop (port of the JAX package's
``obs/spans.py``).

Monotonic-clock spans (``data_wait``, ``step_dispatch``, ``device_sync``,
``eval``, ``checkpoint``, nested freely) plus a per-step ring buffer from
which each logging window reports step-time percentiles (p50/p95/max) and
a straggler flag.  Everything is ``time.perf_counter`` arithmetic on the
host: recording a span costs two clock reads and a dict update, and nothing
here touches a device, so the steps between two log windows keep running
ahead of the card.

The clock is injectable, so tests drive the recorder with a fake one.
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable, Sequence

# step-time max > STRAGGLER_FACTOR x p50 within a window flags the window: a
# fat max means the host stalled (GC, page cache, a slow read)
STRAGGLER_FACTOR = 2.0
# the steps the ring keeps
RING_SIZE = 512


def percentiles(values: Sequence[float], qs: Sequence[float]) -> list[float]:
    """Nearest-rank percentiles of ``values``."""
    if not values:
        return [0.0 for _ in qs]
    s = sorted(values)
    return [s[min(len(s) - 1, max(0, int(round(q * (len(s) - 1)))))] for q in qs]


class SpanRecorder:
    """Ring-buffered span and step-time recorder with window summaries.

    ``span(name)`` times a (possibly nested) region; ``step_complete()``
    closes one loop iteration and records its wall duration in the ring.
    ``summary()`` reports the window since the previous summary (per-step
    percentiles and per-span aggregates) and resets it; the ring keeps
    ``RING_SIZE`` steps.
    """

    def __init__(self, clock: Callable[[], float] = time.perf_counter):
        self.clock = clock
        self._ring: list[float] = []  # per-step wall seconds, newest last
        self._depth = 0
        self._window_spans: dict[str, list[float]] = {}  # name -> [total_s, count, max_s]
        self._window_steps = 0
        self._window_t0 = clock()
        self._step_t0: float | None = None
        # the OUTERMOST spans closed since the step's anchor, by name: a
        # partition of the step's duration for the budget (obs/budget.py)
        self._step_spans: dict[str, float] = {}
        self._step_records: list[dict] = []  # rings with _ring
        # a span-instance listener (obs/trace.py ``TraceCollector``), called
        # with (name, t0, dur) at every outermost span's exit: one None check
        # a span when there is none
        self.listener = None

    @contextlib.contextmanager
    def span(self, name: str):
        self._depth += 1
        t0 = self.clock()
        try:
            yield
        finally:
            dt = self.clock() - t0
            self._depth -= 1
            agg = self._window_spans.get(name)
            if agg is None:
                self._window_spans[name] = [dt, 1, dt]
            else:
                agg[0] += dt
                agg[1] += 1
                if dt > agg[2]:
                    agg[2] = dt
            if self._depth == 0:
                self._step_spans[name] = self._step_spans.get(name, 0.0) + dt
                if self.listener is not None:
                    self.listener.on_span(name, t0, dt)

    def step_complete(self) -> None:
        """One train-loop iteration finished: record its wall duration (the
        time since the previous ``step_complete`` or anchor)."""
        now = self.clock()
        t0 = self._step_t0 if self._step_t0 is not None else self._window_t0
        dur = now - t0
        self._ring.append(dur)
        self._step_records.append({"dur": dur, "spans": self._step_spans})
        self._step_spans = {}
        if len(self._ring) > RING_SIZE:
            del self._ring[: len(self._ring) - RING_SIZE]
            del self._step_records[: len(self._step_records) - RING_SIZE]
        self._step_t0 = now
        self._window_steps += 1

    def mark_step_start(self) -> None:
        """Re-anchor the per-step clock after cadenced work between steps
        (a checkpoint, an eval): that time is on its own span and is not
        charged to the next step's duration, nor to its budget partition."""
        self._step_t0 = self.clock()
        self._step_spans = {}

    def window_step_times(self) -> list[float]:
        if self._window_steps == 0:
            return []
        return self._ring[-min(self._window_steps, len(self._ring)):]

    def window_step_records(self) -> list[dict]:
        """The window's per-step ``{"dur": s, "spans": {name: s}}`` records
        (the budget's input).  Read BEFORE ``summary()``, which resets the
        window."""
        if self._window_steps == 0:
            return []
        return self._step_records[-min(self._window_steps, len(self._step_records)):]

    def summary(self) -> dict | None:
        """Close the window: step-time percentiles and span aggregates; None
        when no step completed since the last summary."""
        times = self.window_step_times()
        if not times:
            return None
        now = self.clock()
        p50, p95 = percentiles(times, (0.50, 0.95))
        mx = max(times)
        out = {
            "window_steps": self._window_steps,
            "window_seconds": round(now - self._window_t0, 6),
            "step_ms_p50": round(p50 * 1e3, 3),
            "step_ms_p95": round(p95 * 1e3, 3),
            "step_ms_max": round(mx * 1e3, 3),
            "straggler": bool(p50 > 0 and mx > STRAGGLER_FACTOR * p50),
            "spans": {name: {"total_ms": round(total * 1e3, 3), "count": count,
                             "max_ms": round(peak * 1e3, 3)}
                      for name, (total, count, peak) in sorted(self._window_spans.items())},
        }
        self._window_spans = {}
        self._window_steps = 0
        self._window_t0 = now
        return out
