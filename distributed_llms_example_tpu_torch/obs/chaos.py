"""Deterministic fault injection (port of the JAX package's
``obs/chaos.py``): every recovery mechanism gets a switch.

    --chaos nan_grad@120,ckpt_corrupt@2,data_error@300,sigterm@240

Grammar: a comma list of ``kind@tick``.  Ticks are global optimizer
steps, except ``ckpt_corrupt``'s, the Nth checkpoint save of the run.
Training kinds:

- ``nan_grad@K``      NaN into one parameter element right before step K
- ``ckpt_corrupt@N``  flip bytes in the Nth checkpoint after its checksum
                      manifest is written: verification must catch it
- ``data_error@K``    one transient ``OSError`` from the batch fetch
                      before step K (the loader's retry)
- ``sigterm@K``       SIGTERM to this process after step K (the graceful
                      preemption path, through the real handler)
- ``oom@K``           a RESOURCE_EXHAUSTED-shaped error before step K
- ``host_loss@K``     the agreed topology-change signal after step K: the
                      trainer's ``--on-host-loss`` policy (reshard onto the
                      surviving ranks, or save and stop), in one process as
                      in many (the schedule is the same on every rank)

Serving kinds, ticks the replica router's scheduler ticks
(``serving/router.py``):

- ``replica_crash@K``  the busiest replica fails at tick K (its requests
                       re-prefill on the survivors)
- ``replica_stall@K``  the busiest replica stops stepping at tick K (only
                       the heartbeat detector sees it)
- ``request_storm@K``  a synthetic burst through admission control

Every injection is one-shot (armed, then fired): a rewind replaying the
same steps does not re-inject.  Each firing logs a ``chaos_injection``
line.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Iterable

from distributed_llms_example_tpu_torch.utils.jsonlog import log_json

# the last three are serving kinds, ticked by the replica router's
# scheduler: a training run leaves them armed and unfired
KINDS = (
    "nan_grad", "ckpt_corrupt", "data_error", "sigterm", "host_loss", "oom",
    "replica_crash", "replica_stall", "request_storm",
)

GRAMMAR_HELP = (
    "expected a comma list of kind@tick with kind in "
    f"{'/'.join(KINDS)} and tick a positive integer "
    "(global step; for ckpt_corrupt the Nth checkpoint save; for the "
    "replica_*/request_storm serving kinds a router scheduler tick), "
    "e.g. 'nan_grad@120,ckpt_corrupt@2,sigterm@240' or "
    "'replica_crash@40,request_storm@10'"
)


@dataclasses.dataclass
class Injection:
    kind: str
    at: int  # global step, or save ordinal for ckpt_corrupt
    fired: bool = False


class ChaosSchedule:
    """The armed injections, consumed one-shot via ``take``."""

    def __init__(self, injections: Iterable[Injection] = ()):
        self.injections = list(injections)

    def __bool__(self) -> bool:
        return bool(self.injections)

    def arm(self, kind: str, at: int) -> None:
        if kind not in KINDS:
            raise ValueError(f"unknown chaos kind {kind!r}; {GRAMMAR_HELP}")
        self.injections.append(Injection(kind, int(at)))

    def armed_at(self, kind: str) -> list[int]:
        """Unfired ticks for one kind."""
        return [i.at for i in self.injections if i.kind == kind and not i.fired]

    def disarm(self, kind: str) -> None:
        """Drop every unfired injection of one kind (fired ones stay)."""
        self.injections = [i for i in self.injections if i.kind != kind or i.fired]

    def take(self, kind: str, tick: int) -> bool:
        """True, exactly once, when an unfired ``kind@tick`` injection is
        armed; marks it fired and logs the ``chaos_injection`` line."""
        for inj in self.injections:
            if inj.kind == kind and inj.at == tick and not inj.fired:
                inj.fired = True
                log_json({"event": "chaos_injection", "kind": kind, "step": int(tick)})
                return True
        return False


def parse_chaos(spec: str) -> ChaosSchedule:
    """Parse the ``--chaos`` grammar; raises ValueError (with the grammar
    help) on anything malformed, so a chaos config fails at parse time and
    not at injection time."""
    schedule = ChaosSchedule()
    spec = (spec or "").strip()
    if not spec:
        return schedule
    for part in spec.split(","):
        part = part.strip()
        kind, sep, tick = part.partition("@")
        if not sep or kind not in KINDS or not tick.isdigit() or int(tick) < 1:
            raise ValueError(f"bad --chaos entry {part!r}: {GRAMMAR_HELP}")
        schedule.arm(kind, int(tick))
    return schedule


def corrupt_checkpoint(step_dir: str, *, nbytes: int = 64) -> str | None:
    """Flip ``nbytes`` in the middle of the largest file under a checkpoint
    step directory (size descending, then path): the torn-storage
    simulation the integrity manifest must catch.  Returns the file's
    path, or None if the directory holds no files."""
    candidates: list[tuple[int, str]] = []
    for dirpath, _, files in os.walk(step_dir):
        for name in sorted(files):
            path = os.path.join(dirpath, name)
            candidates.append((-os.path.getsize(path), path))
    if not candidates:
        return None
    candidates.sort()
    path = candidates[0][1]
    size = os.path.getsize(path)
    with open(path, "r+b") as f:
        off = max(0, size // 2 - nbytes // 2)
        f.seek(off)
        chunk = f.read(min(nbytes, max(1, size - off)))
        f.seek(off)
        f.write(bytes(b ^ 0xFF for b in chunk))
        f.flush()
        os.fsync(f.fileno())
    record = {"event": "chaos_ckpt_corrupted", "path": path, "bytes_flipped": len(chunk)}
    base = os.path.basename(os.path.normpath(step_dir))
    if base.isdigit():
        record["step"] = int(base)
    log_json(record)
    return path
