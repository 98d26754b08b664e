"""One Perfetto timeline per run (port of the JAX package's
``obs/trace.py``; its records, track layout and alignment).

- **TraceCollector** (at run time, held by ``TrainerObs`` under ``--obs
  jsonl`` with the budget on): the span recorder's listener
  (``SpanRecorder.listener``) hands it every outermost span instance,
  ``(name, t0, dur)`` on the host clock, and the trainer every step's end;
  at the log cadence it flushes them as one ``trace_spans`` event (bulk:
  the JSONL file only) a window.  The buffer is bounded; overflow is
  counted (``dropped_spans``).
- **the exporter** (offline, a pure file reader):
  ``python -m distributed_llms_example_tpu_torch.obs.report <dir> --trace
  out.json`` merges every rank's spans, step-budget
  gauges, heartbeats, anomalies, chaos injections, recoveries, memory
  windows, serving request lifecycles and the device lanes of every
  profiled window (``device_account`` events, end-aligned on the window's
  closing step) into one Chrome-trace JSON for https://ui.perfetto.dev.

Ranks are aligned on rank 0's clock by the median, over shared steps, of
the step-end differences (every rank runs step S between the same
collectives); ranks with no shared step fall back to their wall-clock
epochs.
"""

from __future__ import annotations

import json
import os
import statistics
import time
from typing import Any

from distributed_llms_example_tpu_torch.obs import sink as sink_mod

# cap on buffered span instances between cadence flushes: at 4 spans/step
# this covers a 2k-step logging window; beyond it we count drops
MAX_SPANS_PER_WINDOW = 8192

# Perfetto track (tid) layout per rank-process
TID_SPANS = 0      # the train-loop spans (data_wait / dispatch / ...)
TID_STEPS = 1      # step-boundary slices + instant events
TID_COUNTERS = 2   # dispatch_efficiency counter track
TID_DEVICE = 3     # device lanes: per-bucket slices from device_account
TID_REQUESTS = 10  # serving: request lifecycles, one track per slot offset


class TraceCollector:
    """Buffers span instances + step marks; flushed per logging window.
    ``clock`` is the span recorder's, whose times ``on_span`` receives."""

    def __init__(self, clock):
        self.clock = clock
        self.clock0 = clock()
        self.wall0 = time.time()
        self._spans: list[list] = []   # [name, t0_rel_s, dur_s]
        self._steps: list[list] = []   # [step, t_end_rel_s]
        self.dropped = 0

    # SpanRecorder listener protocol ------------------------------------
    def on_span(self, name: str, t0: float, dur: float) -> None:
        if len(self._spans) >= MAX_SPANS_PER_WINDOW:
            self.dropped += 1
            return
        self._spans.append([name, round(t0 - self.clock0, 6), round(dur, 6)])

    def note_step(self, step: int) -> None:
        """Record the step's completion time on this rank's clock — the
        synchronization anchor the exporter aligns ranks on."""
        self._steps.append([int(step), round(self.clock() - self.clock0, 6)])

    def flush(self, step: int) -> None:
        """Emit the window's buffered spans as ONE ``trace_spans`` event
        (bulk: file channel only) and reset the buffer."""
        if not self._spans and not self._steps:
            return
        rec: dict[str, Any] = {
            "event": "trace_spans",
            "step": int(step),
            "wall0": round(self.wall0, 6),
            "spans": self._spans,
            "steps": self._steps,
        }
        if self.dropped:
            rec["dropped_spans"] = self.dropped
        sink_mod.emit(rec, local=True, bulk=True)
        self._spans, self._steps, self.dropped = [], [], 0


# ---------------------------------------------------------------------------
# offline exporter
# ---------------------------------------------------------------------------


def rank_offsets(
    step_marks: dict[int, dict[int, float]],
    wall0: dict[int, float],
) -> dict[int, float]:
    """Per-rank clock shift onto the base (lowest) rank's axis.

    ``step_marks[rank]`` maps global step → that rank's relative
    completion time.  Shared steps give the alignment (median of the
    per-step differences — robust to one straggler window); ranks with
    no shared step fall back to the wall-clock epoch difference."""
    if not step_marks:
        return {}
    base = min(step_marks)
    base_marks = step_marks[base]
    offsets = {base: 0.0}
    for rank, marks in step_marks.items():
        if rank == base:
            continue
        shared = sorted(set(base_marks) & set(marks))
        if shared:
            offsets[rank] = statistics.median(
                base_marks[s] - marks[s] for s in shared
            )
        elif wall0.get(rank) and wall0.get(base):
            # no shared step marks: NTP-bounded wall-clock fallback.
            # wall0[r] + t_rel is the absolute time, so on the base axis
            # t_base = t_rel + (wall0[rank] - wall0[base])
            offsets[rank] = wall0[rank] - wall0[base]
        else:
            offsets[rank] = 0.0
    return offsets


def _us(seconds: float) -> float:
    return round(seconds * 1e6, 1)


def build_trace(output_dir: str) -> dict[str, Any]:
    """Read ``<output_dir>/obs`` (via obs/report.py's loader) and build
    the merged Chrome-trace object."""
    from distributed_llms_example_tpu_torch.obs.report import load_run

    run = load_run(output_dir)
    processes: dict[int, list[dict]] = run["processes"]
    events: list[dict] = []
    # collect per-rank span streams + step marks
    step_marks: dict[int, dict[int, float]] = {}
    wall0: dict[int, float] = {}
    spans_by_rank: dict[int, list[list]] = {}
    for rank, records in sorted(processes.items()):
        spans: list[list] = []
        marks: dict[int, float] = {}
        for r in records:
            if r.get("event") != "trace_spans":
                continue
            wall0.setdefault(rank, float(r.get("wall0", 0.0) or 0.0))
            spans.extend(r.get("spans", []))
            for step, t_end in r.get("steps", []):
                marks[int(step)] = float(t_end)
        if spans or marks:
            spans_by_rank[rank] = spans
            step_marks[rank] = marks
    offsets = rank_offsets(step_marks, wall0)
    for rank in sorted(set(processes) | set(spans_by_rank)):
        events.append({
            "ph": "M", "name": "process_name", "pid": rank,
            "args": {"name": f"rank {rank}"},
        })
        for tid, label in (
            (TID_SPANS, "loop spans"), (TID_STEPS, "steps"),
            (TID_COUNTERS, "gauges"), (TID_DEVICE, "device (profiled)"),
        ):
            events.append({
                "ph": "M", "name": "thread_name", "pid": rank, "tid": tid,
                "args": {"name": label},
            })
    for rank, spans in sorted(spans_by_rank.items()):
        off = offsets.get(rank, 0.0)
        for name, t0, dur in spans:
            events.append({
                "name": str(name), "ph": "X", "pid": rank, "tid": TID_SPANS,
                "ts": _us(float(t0) + off), "dur": _us(float(dur)),
            })
        # step-boundary slices: consecutive marks bound each step
        marks = sorted(step_marks.get(rank, {}).items(), key=lambda kv: kv[1])
        for (s_prev, t_prev), (s, t_end) in zip(marks, marks[1:]):
            events.append({
                "name": f"step {s}", "ph": "X", "pid": rank, "tid": TID_STEPS,
                "ts": _us(t_prev + off), "dur": _us(t_end - t_prev),
            })
        if marks:
            s0, t0_end = marks[0]
            events.append({
                "name": f"step {s0}", "ph": "i", "s": "t",
                "pid": rank, "tid": TID_STEPS, "ts": _us(t0_end + off),
            })
    # step-anchored records from every rank: budget counters + instants
    for rank, records in sorted(processes.items()):
        off = offsets.get(rank, 0.0)
        marks = step_marks.get(rank, {})

        def at_step(rec: dict) -> float | None:
            s = rec.get("step")
            if isinstance(s, (int, float)) and int(s) in marks:
                return marks[int(s)] + off
            return None

        for r in records:
            ev = r.get("event")
            if ev == "step_budget":
                t = at_step(r)
                if t is not None and "dispatch_efficiency" in r:
                    events.append({
                        "name": "dispatch_efficiency", "ph": "C",
                        "pid": rank, "tid": TID_COUNTERS, "ts": _us(t),
                        "args": {"dispatch_efficiency": r["dispatch_efficiency"]},
                    })
            elif ev in (
                "heartbeat", "obs_anomaly", "chaos_injection", "recovery",
                "ckpt_verify_failed", "topology_change", "reshard_restore",
            ):
                t = at_step(r)
                if t is None:
                    continue
                detail = r.get("code") or r.get("kind") or r.get("action") or ""
                events.append({
                    "name": f"{ev}{':' + str(detail) if detail else ''}",
                    "ph": "i", "s": "p", "pid": rank, "tid": TID_STEPS,
                    "ts": _us(t),
                })
            elif ev == "memory_window":
                # the per-rank memory counter track: live bytes + the
                # process peak as stacked counters on the gauges lane,
                # anchored like every other step-cadence record
                t = at_step(r)
                if t is not None and "bytes_in_use" in r:
                    events.append({
                        "name": "hbm_bytes", "ph": "C",
                        "pid": rank, "tid": TID_COUNTERS, "ts": _us(t),
                        "args": {
                            "bytes_in_use": r.get("bytes_in_use", 0),
                            "peak_bytes_in_use": r.get(
                                "peak_bytes_in_use", 0
                            ),
                        },
                    })
            elif ev == "device_account":
                events.extend(_device_lane_events(rank, r, marks, off))
            elif ev == "serve_request":
                events.extend(_request_events(rank, r))
    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": {
            "source": "distributed_llms_example_tpu_torch.obs.trace",
            "output_dir": output_dir,
            "ranks": sorted(spans_by_rank) or sorted(processes),
        },
    }


def _device_lane_events(
    rank: int, r: dict, marks: dict[int, float], off: float
) -> list[dict]:
    """One ``device_account``'s bounded per-bucket lane slices →
    device-track slices BESIDE the host spans, aligned on the shared step
    ordinals: the capture's device span ends when its window's closing
    step completes on the host clock, so the device lane sits under
    exactly the host steps it profiled."""
    window = r.get("window") or []
    lanes = r.get("lanes") or []
    if len(window) != 2 or not lanes:
        return []
    stop = int(window[1])
    # anchor: prefer the window's closing step mark; fall back to any
    # recorded mark at/after it (a truncated capture may stop early)
    t_end = marks.get(stop)
    if t_end is None:
        later = [t for s, t in marks.items() if s >= stop]
        if not later:
            return []
        t_end = min(later)
    span_s = float(r.get("span_ms", 0.0) or 0.0) / 1e3
    t0 = t_end - span_s + off
    out: list[dict] = []
    for bucket, rel_ms, dur_ms in lanes:
        out.append({
            "name": f"dev:{bucket}", "ph": "X", "pid": rank,
            "tid": TID_DEVICE,
            "ts": _us(t0 + float(rel_ms) / 1e3),
            "dur": _us(float(dur_ms) / 1e3),
        })
    return out


def _request_events(rank: int, r: dict) -> list[dict]:
    """One serving request's lifecycle → queue/prefill/decode slices on a
    per-slot track (times are relative to the engine's submit instant —
    serving runs own their timeline)."""
    out: list[dict] = []
    slot = int(r.get("slot", 0) or 0)
    tid = TID_REQUESTS + slot
    req = r.get("request")
    t_admit = float(r.get("t_admit_s", 0.0) or 0.0)
    t_done = float(r.get("t_done_s", t_admit) or t_admit)
    queue_s = float(r.get("queue_wait_ms", 0.0) or 0.0) / 1e3
    prefill_s = float(r.get("prefill_ms", 0.0) or 0.0) / 1e3
    label = f"req {req}"
    out.append({
        "ph": "M", "name": "thread_name", "pid": rank, "tid": tid,
        "args": {"name": f"slot {slot}"},
    })
    if queue_s > 0:
        out.append({
            "name": f"{label} queue", "ph": "X", "pid": rank, "tid": tid,
            "ts": _us(t_admit - queue_s), "dur": _us(queue_s),
        })
    out.append({
        "name": f"{label} prefill", "ph": "X", "pid": rank, "tid": tid,
        "ts": _us(t_admit), "dur": _us(prefill_s),
    })
    decode_start = t_admit + prefill_s
    if t_done > decode_start:
        out.append({
            "name": f"{label} decode ({r.get('tokens', '?')} tok)",
            "ph": "X", "pid": rank, "tid": tid,
            "ts": _us(decode_start), "dur": _us(t_done - decode_start),
        })
    return out


def export_chrome_trace(output_dir: str, out_path: str) -> dict[str, Any]:
    """Build the merged trace and write it to ``out_path``.  Returns a
    small summary (event count, ranks) for the caller to surface."""
    trace = build_trace(output_dir)
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(trace, f)
    summary = {
        "event": "trace_export",
        "path": out_path,
        "events": len(trace["traceEvents"]),
        "ranks": trace["otherData"]["ranks"],
    }
    return summary
