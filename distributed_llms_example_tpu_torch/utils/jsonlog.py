"""JSON-lines metric emission: one JSON object per line on stdout.

The port's own copy of the JAX package's ``utils/jsonlog.log_json``
contract (the platform parses each stdout line as execution metadata).
Every line goes through the installed sink (``obs/sink.py``): stdout, and
under ``--obs jsonl`` the same records in the run's JSONL file.  Only
process 0 of a process group prints, unless the caller asks for every
process (``all_processes``), as in the JAX package; a ``local`` record
also reaches every rank's own file.  Floats are rounded to six places and
0-d tensors / numpy scalars become plain Python numbers.
``MetricLogger`` is the JAX package's step-cadence logger.
"""

from __future__ import annotations

import time
from typing import Any, Mapping


def _to_scalar(v: Any) -> Any:
    """0-d tensors / numpy scalars → plain Python for json.dumps."""
    if hasattr(v, "item") and getattr(v, "ndim", 1) == 0:
        v = v.item()
    if isinstance(v, float):
        return round(v, 6)
    return v


def log_json(metrics: Mapping[str, Any], *, all_processes: bool = False,
             local: bool = False, bulk: bool = False) -> None:
    """Emit ``metrics`` as a single JSON line through the installed sink, on
    process 0 only unless ``all_processes`` (``local``: every rank's file
    too; ``bulk``: the file channel only).  The gate comes before any
    conversion, so a silent rank never waits on its device values."""
    from distributed_llms_example_tpu_torch.obs import sink

    if not sink.wants(all_processes=all_processes, local=local, bulk=bulk):
        return
    sink.emit({k: _to_scalar(v) for k, v in metrics.items()}, all_processes=all_processes,
              local=local, bulk=bulk)


class MetricLogger:
    """Step-cadence metric logger with tokens/sec accounting.  The first
    report lands at step ``every`` (never at step 0, whose window would be
    empty), and ``flush()`` emits the final partial window."""

    def __init__(self, every: int = 100):
        self.every = max(1, int(every))
        self._t0 = time.perf_counter()
        self._tokens_since = 0
        self._steps_since = 0
        self._last: tuple[Any, Any] | None = None  # (loss, lr) of the newest step

    def step(self, step: int, loss: Any, lr: Any = None, tokens: int = 0, **extra: Any) -> None:
        """``loss``/``lr`` may be 0-d device tensors: they become host
        floats ONLY on emitting steps, so other steps cost no device sync."""
        self._tokens_since += tokens
        self._steps_since += 1
        self._last = (loss, lr)
        if step == 0 or step % self.every != 0:
            return
        self._emit(step, loss, lr, extra)

    def flush(self, step: int, **extra: Any) -> None:
        """Emit the pending partial window (no-op when the last report
        already covered every step)."""
        if self._steps_since == 0 or self._last is None:
            return
        loss, lr = self._last
        self._emit(step, loss, lr, extra)

    def _emit(self, step: int, loss: Any, lr: Any, extra: Mapping[str, Any]) -> None:
        dt = time.perf_counter() - self._t0
        m: dict[str, Any] = {"step": step, "loss": loss}
        if lr is not None:
            m["learning_rate"] = lr
        if dt > 0 and self._tokens_since:
            m["tokens_per_sec"] = self._tokens_since / dt
            m["steps_per_sec"] = self._steps_since / dt
        m.update(extra)
        log_json(m)
        self._t0 = time.perf_counter()
        self._tokens_since = 0
        self._steps_since = 0
