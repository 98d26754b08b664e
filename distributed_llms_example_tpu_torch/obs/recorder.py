"""The flight recorder (port of the JAX package's ``obs/recorder.py``): a
bounded ring of the last N steps' evidence, dumped as one JSON bundle on
an anomaly, a SIGTERM or a crash.

Each entry holds the step's metrics (device tensors until the health
cadence resolves them; never a per-step sync) and a fingerprint of the
host batch.  The dump is atomic (tmp file + fsync + rename), to
``<output_dir>/obs/flight-recorder-p<process index>.json`` (``p000`` for
one process): every rank of a group dumps its own.
"""

from __future__ import annotations

import collections
import os
import zlib
from typing import Any, Mapping, Sequence

import numpy as np

from distributed_llms_example_tpu_torch.core.mesh import process_index
from distributed_llms_example_tpu_torch.io.checkpoint import write_json_atomic
from distributed_llms_example_tpu_torch.utils.jsonlog import log_json

SCHEMA_VERSION = 1  # the JAX package's obs schema version


def batch_fingerprint(batch: Mapping[str, Any], *, epoch: int, epoch_step: int) -> dict:
    """Identity of one host batch: array shapes, the crc32 of the token ids
    and of the labels, and the batch plan position (epoch, epoch_step).
    Replaying the deterministic plan at that position reproduces the
    hashes."""
    fp: dict[str, Any] = {
        "epoch": int(epoch),
        "epoch_step": int(epoch_step),
        "shapes": {k: list(np.asarray(v).shape) for k, v in batch.items()},
    }
    for key in ("input_ids", "labels"):
        v = batch.get(key)
        if v is not None:
            fp[f"{key}_crc32"] = zlib.crc32(np.ascontiguousarray(v).tobytes()) & 0xFFFFFFFF
    return fp


class FlightRecorder:
    """Bounded ring of per-step records.  ``record`` keeps references to
    the step's device metrics; ``annotate`` swaps in the host floats the
    health cadence fetched; ``dump`` converts whatever is left."""

    def __init__(self, capacity: int):
        self.capacity = max(1, int(capacity))
        self._ring: collections.deque = collections.deque(maxlen=self.capacity)
        self._by_step: dict[int, dict] = {}

    def __len__(self) -> int:
        return len(self._ring)

    def record(self, step: int, epoch: int, metrics: Mapping[str, Any],
               fingerprint: Mapping[str, Any] | None = None) -> None:
        if len(self._ring) == self.capacity:
            self._by_step.pop(self._ring[0]["step"], None)
        entry: dict[str, Any] = {"step": int(step), "epoch": int(epoch),
                                 "metrics": dict(metrics), "resolved": False}
        if fingerprint is not None:
            entry["fingerprint"] = dict(fingerprint)
        self._ring.append(entry)
        self._by_step[int(step)] = entry

    def fingerprint_for(self, step: int) -> dict | None:
        """The batch fingerprint recorded for one step (None once evicted
        or never recorded): what the rewind quarantines by."""
        entry = self._by_step.get(int(step))
        return None if entry is None else entry.get("fingerprint")

    def annotate(self, step: int, host_metrics: Mapping[str, float]) -> None:
        entry = self._by_step.get(int(step))
        if entry is not None:
            entry["metrics"] = dict(host_metrics)
            entry["resolved"] = True

    @staticmethod
    def _to_jsonable(v: Any) -> Any:
        # broad except: dump runs on the crash path, where a device value
        # may no longer convert; losing one value must not lose the bundle
        try:
            f = float(v)
        except Exception:
            return str(v)[:80]
        if not np.isfinite(f):
            return repr(f)  # "nan"/"inf": NaN literals are not valid JSON
        return round(f, 6)

    @staticmethod
    def bundle_path(output_dir: str) -> str:
        return os.path.join(output_dir, "obs", f"flight-recorder-p{process_index():03d}.json")

    def dump(self, output_dir: str, *, reason: str, step: int,
             anomalies: Sequence[Any] = ()) -> str | None:
        """Write the ring as one bundle, atomically, and log a
        ``recorder_dump`` line.  An I/O error is reported, not raised."""
        path = self.bundle_path(output_dir)
        entries = []
        for e in self._ring:
            out = {"step": e["step"], "epoch": e["epoch"],
                   "metrics": {k: self._to_jsonable(v) for k, v in e["metrics"].items()}}
            if "fingerprint" in e:
                out["fingerprint"] = e["fingerprint"]
            entries.append(out)
        bundle = {
            "schema_version": SCHEMA_VERSION, "event": "flight_recorder", "reason": reason,
            "step": int(step), "process_index": process_index(), "capacity": self.capacity,
            "entries": entries,
            "anomalies": [{"step": int(a.step), "code": a.code,
                           "value": self._to_jsonable(a.value), "detail": a.detail}
                          for a in anomalies],
        }
        try:
            os.makedirs(os.path.dirname(path), exist_ok=True)
            write_json_atomic(path, bundle)
        except OSError as e:
            log_json({"event": "recorder_dump_failed", "reason": str(e)[:200]})
            return None
        log_json({"event": "recorder_dump", "path": path, "reason": reason, "step": int(step),
                  "steps_recorded": len(entries)}, all_processes=True)
        return path
