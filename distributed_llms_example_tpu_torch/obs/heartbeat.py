"""Multi-process liveness and step-skew heartbeat (port of the JAX
package's ``obs/heartbeat.py``).

A group training in lockstep fails by hanging: when one rank stalls, every
other rank blocks in the next collective with no diagnostic.  At a step
cadence every rank contributes ``(step, wall-clock arrival)`` to a small
all-gather (``core/mesh.process_allgather``: NCCL on CUDA, gloo on the
CPU; a gather that completes is itself a liveness proof of the fabric),
and process 0 publishes the spread:

- ``skew_steps``        max - min step across ranks: nonzero means a rank
                        runs a different loop (a wrong resume step);
- ``arrival_spread_s``  latest - earliest arrival: the gather is a
                        barrier, so this is how long the fast ranks waited;
- ``laggards``          ranks that arrived ``LAGGARD_THRESHOLD_S`` after
                        the earliest.

Every rank must call ``beat`` at the same global step (the trainer's step
cadence): a heartbeat on one rank alone would deadlock the group.  Every
rank folds the same gathered probe into ``LaggardStreaks``
(``obs/health.py``), so a persistent laggard becomes the same
``host_loss_suspect`` event everywhere without a second collective.
Wall clocks ride as integers (seconds, microseconds).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from distributed_llms_example_tpu_torch.core.mesh import (
    is_distributed,
    local_device,
    process_allgather,
    process_index,
)
from distributed_llms_example_tpu_torch.obs.budget import sync_device
from distributed_llms_example_tpu_torch.obs.health import LaggardStreaks
from distributed_llms_example_tpu_torch.utils.jsonlog import log_json

LAGGARD_THRESHOLD_S = 5.0


def gather_probe(local: np.ndarray) -> np.ndarray:
    """Every rank's int64 probe vector stacked as (P, n) on every rank; one
    process: its own row.  Over NCCL the gather's copy to the host waits on
    the card, so it goes through ``sync_device`` (counted) first."""
    local = np.asarray(local, dtype=np.int64)
    if is_distributed() and torch.distributed.get_backend() == "nccl":
        sync_device(local_device("cuda"))
    return process_allgather(local)


def detect_laggards(steps: np.ndarray, arrivals_s: np.ndarray, *,
                    laggard_threshold_s: float = LAGGARD_THRESHOLD_S) -> dict:
    """Skew analysis over per-rank ``(step, arrival time)`` vectors."""
    steps = np.asarray(steps)
    arrivals_s = np.asarray(arrivals_s, dtype=np.float64)
    earliest = float(arrivals_s.min())
    return {
        "min_step": int(steps.min()),
        "max_step": int(steps.max()),
        "skew_steps": int(steps.max() - steps.min()),
        "arrival_spread_s": round(float(arrivals_s.max() - earliest), 3),
        "laggards": [int(i) for i in range(len(arrivals_s))
                     if float(arrivals_s[i] - earliest) > laggard_threshold_s],
    }


class Heartbeat:
    def __init__(self, every_steps: int, *, suspect_beats: int = 3):
        self.every = max(1, int(every_steps))
        # 0 = classification off, the cadence's own convention
        self.streaks = (LaggardStreaks(suspect_beats=suspect_beats)
                        if int(suspect_beats) > 0 else None)

    def beat(self, step: int) -> dict | None:
        """Contribute this rank's probe and, on process 0, log the
        ``heartbeat`` record (returned there; None elsewhere).  Every rank
        calls it at the same global step."""
        t = time.time()
        gathered = gather_probe(np.asarray([int(step), int(t), int((t % 1.0) * 1e6)]))
        arrivals = gathered[:, 1].astype(np.float64) + gathered[:, 2] / 1e6
        analysis = detect_laggards(gathered[:, 0], arrivals)
        if self.streaks is not None:
            for suspect in self.streaks.update(analysis["laggards"], step):
                # every rank's file carries the agreed verdict
                log_json(suspect, local=True)
        if process_index() != 0:
            return None
        record = {"event": "heartbeat", "step": int(step),
                  "process_count": int(gathered.shape[0]), **analysis}
        log_json(record)
        return record
