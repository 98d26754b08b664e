"""JSON-lines metric emission: one JSON object per line on stdout.

The port's own copy of the JAX package's ``utils/jsonlog.log_json``
contract (the platform parses each stdout line as execution metadata).
The port is single-process, so every call emits; floats are rounded to
six places and 0-d tensors / numpy scalars become plain Python numbers.
"""

from __future__ import annotations

import json
import sys
from typing import Any, Mapping


def _to_scalar(v: Any) -> Any:
    """0-d tensors / numpy scalars → plain Python for json.dumps."""
    if hasattr(v, "item") and getattr(v, "ndim", 1) == 0:
        v = v.item()
    if isinstance(v, float):
        return round(v, 6)
    return v


def log_json(metrics: Mapping[str, Any], *, file=None) -> None:
    """Emit ``metrics`` as a single JSON line on ``file`` (stdout)."""
    out = {k: _to_scalar(v) for k, v in metrics.items()}
    print(json.dumps(out), file=file or sys.stdout, flush=True)
