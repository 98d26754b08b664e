"""Device-memory attribution (port of the JAX package's ``obs/memprof.py``):
the bucketed byte account, the log-cadence watermark and OOM forensics.

- **the static account** (``state_memory_account``): the JAX package walks
  the compiled step's ``memory_analysis()``; the port has no compiled
  program and builds the account from the run's own state instead, over
  the same taxonomy ``BUCKETS``: ``params``, ``optimizer_state`` and
  ``grad_accum`` are the byte counts of the actual tensors on this rank
  (fp32 masters, AdamW's moments and table sums, the fp32 gradients the
  microbatches accumulate into; FSDP shards where sharded);
  ``activations`` is the first step's measured peak less the bytes in use
  before it and less the gradients; ``other`` what was in use before the
  step beyond the state (the batch, the leaf table, workspaces).  The
  buckets sum to the peak up to ``additivity_gap_bytes``, stamped as in the
  JAX package, and the fit verdict is against ``--hbm-budget-gib``
  (default 80: an H100).  The peak is the allocator's, never reset here:
  where the first step set no new high-water mark (an earlier allocation
  of the process peaked higher; ``measured.step_set_peak`` false) the
  activations bucket is an upper bound.  Without a device peak (the CPU)
  the peak is the state's own sum.
- **the runtime side** (``Watermark`` / ``MemoryMonitor``):
  ``torch.cuda.memory_stats`` (allocated bytes now and at peak, reserved
  bytes) sampled at the log cadence into ``memory_window`` events.  torch
  can reset its peak, but the JAX package's mark/delta form is kept, so
  that no other reader's peak is reset from under it: ``mark()`` snapshots
  the peak, a reading reports ``watermark_delta_bytes`` since the mark.  On
  the CPU the monitor emits one ``memory_window_skipped`` and then stays
  silent.
- **OOM forensics** (``is_resource_exhausted`` / ``dump_postmortem``): an
  out-of-memory error escaping the trainer leaves a schema-stamped
  ``memory-postmortem-p*.json`` (tmp + fsync + rename: a kill mid-dump
  leaves nothing or a whole bundle) with the last static account, the
  watermark history and the largest live blocks of
  ``torch.cuda.memory_snapshot()``; then the error goes on.  Telemetry
  never raises out of an I/O failure (``memory_postmortem_failed``).
- **the serving account** (``serving_account``): the engine's weights and
  KV cache over the same taxonomy.
"""

from __future__ import annotations

import json
import os
from collections import deque
from typing import Any, Iterable, Mapping

import torch

from distributed_llms_example_tpu_torch.obs.sink import SCHEMA_VERSION
from distributed_llms_example_tpu_torch.utils.jsonlog import log_json

# the one bucket taxonomy of the training and serving accounts (the JAX
# package's)
BUCKETS = ("params", "optimizer_state", "grad_accum", "activations", "kv_cache", "other")

GIB = 1024**3

# the readings a monitor keeps for the postmortem, the parameters an
# account lists, the live blocks a postmortem lists
MEMORY_HISTORY = 64
TOP_BUFFERS = 8
TOP_LIVE_BLOCKS = 10


# ---------------------------------------------------------------------------
# runtime readings
# ---------------------------------------------------------------------------


def hbm_stats(device: torch.device | str | None = None) -> list[dict] | None:
    """The card's memory: allocated bytes now and at peak, reserved bytes
    and the card's size (a list of one, the JAX package's shape).  None
    where there is no CUDA device to read: absent beats zero."""
    device = torch.device(device) if device is not None else None
    if device is not None and device.type != "cuda":
        return None
    if not torch.cuda.is_available():
        return None
    dev = device if device is not None else torch.device("cuda", torch.cuda.current_device())
    stats = torch.cuda.memory_stats(dev)
    return [{
        "device": dev.index if dev.index is not None else torch.cuda.current_device(),
        "bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
        "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak", 0)),
        "reserved_bytes": int(stats.get("reserved_bytes.all.current", 0)),
        "bytes_limit": int(torch.cuda.get_device_properties(dev).total_memory),
    }]


class Watermark:
    """Mark/delta semantics over the allocator's peak (never reset here):
    ``mark()`` snapshots the peak; a reading reports the bytes newly
    claimed since (0 when the phase stayed under the old high-water mark)."""

    def __init__(self, device: torch.device | str | None = None):
        self.device = device
        self._marked: dict[int, int] = {}

    def mark(self) -> None:
        stats = hbm_stats(self.device)
        if stats:
            self._marked = {s["device"]: s["peak_bytes_in_use"] for s in stats}

    def read(self) -> dict | None:
        """One reading (``bytes_in_use``, ``peak_bytes_in_use``,
        ``watermark_delta_bytes``, ``reserved_bytes``, ``bytes_limit``);
        None where nothing reports."""
        stats = hbm_stats(self.device)
        if not stats:
            return None
        return {
            "bytes_in_use": max(s["bytes_in_use"] for s in stats),
            "peak_bytes_in_use": max(s["peak_bytes_in_use"] for s in stats),
            "watermark_delta_bytes": max(s["peak_bytes_in_use"] - self._marked.get(s["device"], 0)
                                         for s in stats),
            "reserved_bytes": max(s["reserved_bytes"] for s in stats),
            "bytes_limit": max(s["bytes_limit"] for s in stats),
            "devices": len(stats),
        }


def is_resource_exhausted(e: BaseException) -> bool:
    """Does this exception look like a device or host out-of-memory?
    ``torch.cuda.OutOfMemoryError`` ("CUDA out of memory"), the JAX
    package's shapes (RESOURCE_EXHAUSTED, "out of memory", "allocation
    failure"), the port's chaos injection and ``MemoryError``."""
    oom = getattr(torch.cuda, "OutOfMemoryError", None)
    if isinstance(e, MemoryError) or (oom is not None and isinstance(e, oom)):
        return True
    text = f"{type(e).__name__}: {e}".lower()
    return ("resource_exhausted" in text or "resource exhausted" in text
            or "out of memory" in text or "allocation failure" in text)


# ---------------------------------------------------------------------------
# the static account
# ---------------------------------------------------------------------------


def _local(t: torch.Tensor) -> torch.Tensor:
    """A sharded (DTensor) parameter's shard on this rank; a plain tensor
    itself."""
    return t.to_local() if hasattr(t, "to_local") else t


def _nbytes(tensors: Iterable[torch.Tensor | None]) -> int:
    return sum(int(_local(t).numel()) * t.element_size() for t in tensors if t is not None)


def _fit(peak: int, hbm_budget_gib: float) -> dict:
    budget_bytes = int(float(hbm_budget_gib) * GIB)
    return {
        "hbm_budget_gib": float(hbm_budget_gib),
        "hbm_budget_bytes": budget_bytes,
        "peak_frac_of_budget": round(peak / budget_bytes, 4) if budget_bytes else None,
        "hbm_headroom_gib": round((budget_bytes - peak) / GIB, 3),
        "fits_budget": peak < budget_bytes,
    }


def state_memory_account(named_params: list[tuple[str, torch.Tensor]], opt_tensors: list,
                         grads: list, *, before_step_bytes: int | None = None,
                         step_peak_bytes: int | None = None, step_set_peak: bool = True,
                         hbm_budget_gib: float, model: str = "", mesh: Mapping[str, int] | None = None,
                         backend: str = "cuda") -> dict:
    """The bucketed account of this rank's training state (``named_params``
    the parameters, counted by their shards on this rank, ``opt_tensors`` AdamW's moments and sums,
    ``grads`` the gradients), with the first step's measured bytes where
    the device reports them: ``before_step_bytes`` in use before it,
    ``step_peak_bytes`` the allocator's peak after it, ``step_set_peak``
    whether the step raised that peak."""
    buckets = {b: 0 for b in BUCKETS}
    buckets["params"] = _nbytes(p for _, p in named_params)
    buckets["optimizer_state"] = _nbytes(opt_tensors)
    buckets["grad_accum"] = _nbytes(grads)
    measured = before_step_bytes is not None and step_peak_bytes is not None
    if measured:
        state = buckets["params"] + buckets["optimizer_state"]
        buckets["other"] = max(0, int(before_step_bytes) - state)
        buckets["activations"] = max(0, int(step_peak_bytes) - int(before_step_bytes)
                                     - buckets["grad_accum"])
    total = sum(buckets.values())
    peak = int(step_peak_bytes) if measured else total
    return {
        "model": model,
        "mesh": dict(mesh) if mesh is not None else None,
        "backend": backend,
        "buckets_bytes": buckets,
        "bucket_total_bytes": total,
        "peak_bytes": peak,
        "peak_gib": round(peak / GIB, 3),
        "additivity_gap_bytes": peak - total,
        "measured": ({"before_step_bytes": int(before_step_bytes),
                      "step_peak_bytes": int(step_peak_bytes),
                      "step_set_peak": bool(step_set_peak)} if measured else None),
        "largest_buffers": largest_state_buffers(named_params),
        **_fit(peak, hbm_budget_gib),
    }


def largest_state_buffers(named_params: list[tuple[str, torch.Tensor]]) -> list:
    """The ``TOP_BUFFERS`` largest parameters by their bytes on this rank (their global
    and shard shapes), by name, tagged with the module bucket their name
    carries."""
    from distributed_llms_example_tpu_torch.obs.devprof import module_bucket_of

    rows = []
    for name, p in named_params:
        shard = _local(p)
        row = {"name": name, "shape": list(p.shape), "shard_shape": list(shard.shape),
               "dtype": str(p.dtype).replace("torch.", ""),
               "bytes": int(shard.numel()) * p.element_size()}
        module = module_bucket_of(name)
        if module is not None:
            row["module"] = module
        rows.append(row)
    rows.sort(key=lambda r: (-r["bytes"], r["name"]))
    return rows[:TOP_BUFFERS]


def serving_account(*, params_bytes: int, kv_cache_bytes: int, hbm_budget_gib: float) -> dict:
    """The serving engine's account over the same taxonomy: the weights in
    ``params``, the KV cache in ``kv_cache``, with the training account's
    fit fields."""
    buckets = {b: 0 for b in BUCKETS}
    buckets["params"] = int(params_bytes)
    buckets["kv_cache"] = int(kv_cache_bytes)
    total = sum(buckets.values())
    return {"buckets_bytes": buckets, "bucket_total_bytes": total, "peak_bytes": total,
            "peak_gib": round(total / GIB, 3), **_fit(total, hbm_budget_gib)}


# ---------------------------------------------------------------------------
# the runtime monitor
# ---------------------------------------------------------------------------


class MemoryMonitor:
    """Log-cadence memory telemetry and the OOM postmortem's state: one
    ``Watermark``, marked after every window (each ``memory_window``
    carries the delta since the last), a bounded history of readings and
    the last static account."""

    def __init__(self, device: torch.device | str | None):
        self.device = device
        self.account: dict | None = None
        self.watermark = Watermark(device)
        self.history: deque = deque(maxlen=MEMORY_HISTORY)
        self._skip_emitted = False

    def attach_account(self, account: dict | None) -> None:
        self.account = account

    def sample(self, step: int) -> dict | None:
        """One reading -> a ``memory_window`` event (local); None where the
        device reports nothing (then one ``memory_window_skipped``)."""
        reading = self.watermark.read()
        if reading is None:
            if not self._skip_emitted:
                self._skip_emitted = True
                log_json({"event": "memory_window_skipped", "step": int(step),
                          "reason": "the device reports no memory_stats (no CUDA device): "
                                    "the memory account is the state's alone"}, local=True)
            return None
        record = {"event": "memory_window", "step": int(step), **reading}
        self.history.append({k: record[k] for k in ("step", "bytes_in_use", "peak_bytes_in_use",
                                                    "watermark_delta_bytes")})
        self.watermark.mark()
        log_json(record, local=True)
        return record

    def maybe_dump_postmortem(self, output_dir: str, *, step: int,
                              error: BaseException) -> str | None:
        """On an out-of-memory ``error``: the postmortem bundle (its path);
        otherwise nothing.  The caller re-raises either way."""
        if not is_resource_exhausted(error):
            return None
        return dump_postmortem(output_dir, reason=f"{type(error).__name__}: {str(error)[:300]}",
                               step=step, account=self.account,
                               watermark_history=list(self.history), device=self.device)


# ---------------------------------------------------------------------------
# OOM postmortem bundles
# ---------------------------------------------------------------------------


def postmortem_path(output_dir: str) -> str:
    from distributed_llms_example_tpu_torch.core.mesh import process_index

    return os.path.join(output_dir, "obs", f"memory-postmortem-p{process_index():03d}.json")


def _live_block_top(device) -> list[dict] | None:
    """The ``TOP_LIVE_BLOCKS`` largest live blocks of the caching allocator at dump time.  Any
    failure gives None: this runs on the crash path of an allocator that
    may have just run out, and losing the top-N must not lose the bundle."""
    try:
        if hbm_stats(device) is None:
            return None
        rows = [{"bytes": int(b["size"]), "requested_bytes": int(b.get("requested_size", 0)),
                 "segment_type": seg.get("segment_type")}
                for seg in torch.cuda.memory_snapshot()
                for b in seg.get("blocks", []) if b.get("state") == "active_allocated"]
        rows.sort(key=lambda r: -r["bytes"])
        return rows[:TOP_LIVE_BLOCKS] or None
    except Exception:  # noqa: BLE001 - forensics on a failing allocator
        return None


def dump_postmortem(output_dir: str, *, reason: str, step: int, account: dict | None = None,
                    watermark_history: Iterable[Mapping] = (), device=None) -> str | None:
    """Write the ``memory-postmortem-p*.json`` bundle atomically and announce
    it; an I/O failure is reported (``memory_postmortem_failed``), never
    raised."""
    from distributed_llms_example_tpu_torch.core.mesh import process_index

    path = postmortem_path(output_dir)
    bundle: dict[str, Any] = {
        "schema_version": SCHEMA_VERSION,
        "event": "memory_postmortem",
        "reason": str(reason)[:400],
        "step": int(step),
        "process_index": int(process_index()),
        "account": account,
        "watermark_history": [dict(w) for w in watermark_history],
        "final_reading": Watermark(device).read(),
    }
    top = _live_block_top(device)
    if top is not None:
        bundle["live_buffers_top"] = top
    try:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(bundle, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except OSError as e:
        log_json({"event": "memory_postmortem_failed", "reason": str(e)[:200]}, local=True)
        return None
    log_json({"event": "memory_postmortem", "path": path, "reason": str(reason)[:200],
              "step": int(step)}, local=True)
    return path
