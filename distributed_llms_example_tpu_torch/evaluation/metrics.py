"""Metric aggregation across processes (port of the JAX package's
``evaluation/metrics.py``): the mean of each metric over the process group
(one process: its own values), from one all-gather of float32 values, as
the JAX package averages them."""

from __future__ import annotations

from typing import Mapping

import numpy as np

from distributed_llms_example_tpu_torch.core.mesh import process_allgather, process_count

PASSTHROUGH_KEYS = ("epoch", "step")  # never averaged


def aggregate_mean(metrics: Mapping[str, float]) -> dict[str, float]:
    """Each metric as a float, averaged over the processes (``epoch`` and
    ``step`` passed through)."""
    out = {k: float(v) for k, v in metrics.items()}
    if process_count() == 1:
        return out
    keys = sorted(k for k in out if k not in PASSTHROUGH_KEYS)
    if keys:
        vec = np.asarray([out[k] for k in keys], np.float32)
        mean = np.mean(process_allgather(vec), axis=0)
        for k, v in zip(keys, mean):
            out[k] = float(v)
    return out
