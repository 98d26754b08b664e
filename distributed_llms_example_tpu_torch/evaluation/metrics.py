"""Metric aggregation across processes (port of the JAX package's
``evaluation/metrics.py``), for one process: the mean over one process is
its own value.  The cross-process mean comes with data-parallel training
over GPUs (ROADMAP.md); until then a multi-process group is refused."""

from __future__ import annotations

from typing import Mapping

import torch

PASSTHROUGH_KEYS = ("epoch", "step")  # never averaged


def aggregate_mean(metrics: Mapping[str, float]) -> dict[str, float]:
    """Each metric as a float, averaged over processes (one, so far)."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1:
        raise NotImplementedError(
            "the multi-process metric mean waits for data-parallel training (ROADMAP.md)")
    return {k: float(v) for k, v in metrics.items()}
