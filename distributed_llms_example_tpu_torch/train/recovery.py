"""In-run rewind-and-retry recovery (port of the JAX package's
``train/recovery.py``, one process): ``--on-anomaly rewind``.

1. Rewind: restore the newest verified checkpoint strictly older than the
   anomaly step (``io/checkpoint.py`` ``restore_before``), reset the data
   cursor (the index-level epoch fast-forward) and the dropout generator
   to their state at that save, so the replay draws the same masks.
2. Quarantine: the watchdog attributes the anomaly to one step, the
   flight recorder holds that step's batch fingerprint, and the batch is
   quarantined by its plan position (epoch, epoch_step); the replay skips
   it (crc-checked on the way past).
3. Escalation: rewind -> skip_batch -> halt.  Rewinds are bounded by
   ``--max-rewinds``; then, while the state is still finite (a loss spike
   or grad explosion, never a non-finite step), one ``skip_batch``
   quarantines the batch and continues without restoring; anything past
   that, or an anomaly on a batch already quarantined, halts.
"""

from __future__ import annotations

import dataclasses
import zlib
from typing import Any, Mapping

import numpy as np

from distributed_llms_example_tpu_torch.utils.jsonlog import log_json

@dataclasses.dataclass(frozen=True)
class Decision:
    action: str  # "rewind" | "skip_batch" | "halt", in escalation order
    reason: str


class RecoveryController:
    """The rewind state machine: budget, quarantine set, save snapshots."""

    def __init__(self, *, max_rewinds: int = 2):
        self.max_rewinds = int(max_rewinds)
        self.rewinds_done = 0
        self.skips_done = 0
        # (epoch, epoch_step) -> quarantine record (crc32s for verification)
        self.quarantined: dict[tuple[int, int], dict[str, Any]] = {}
        # checkpoint step -> host state the checkpoint does not hold: the
        # dropout generator's state and the (epoch, pos) data cursor
        self._snapshots: dict[int, dict[str, Any]] = {}

    def note_save(self, step: int, *, rng: Any, epoch: int, pos: int) -> None:
        """What a bit-exact in-process rewind to the checkpoint at ``step``
        needs beside it: the dropout generator's state (``get_state()``)
        and the data cursor (epoch, batches consumed including skipped
        ones, which is not the global step once a batch was skipped)."""
        self._snapshots[int(step)] = {"rng": rng, "epoch": int(epoch), "pos": int(pos)}

    def snapshot_for(self, step: int) -> dict[str, Any] | None:
        return self._snapshots.get(int(step))

    def quarantine(self, epoch: int, epoch_step: int, fingerprint: Mapping[str, Any], *,
                   reason: str) -> None:
        """Quarantine one batch plan position; logs ``quarantine`` once
        (the replay's skips are ``quarantine_skip`` lines)."""
        key = (int(epoch), int(epoch_step))
        record = {"input_ids_crc32": fingerprint.get("input_ids_crc32"),
                  "labels_crc32": fingerprint.get("labels_crc32"), "reason": reason}
        self.quarantined[key] = record
        log_json({"event": "quarantine", "epoch": key[0], "epoch_step": key[1],
                  **{k: v for k, v in record.items() if v is not None}})

    def should_skip(self, epoch: int, epoch_step: int, batch: Mapping[str, Any]) -> bool:
        """Is this plan position quarantined?  The batch's crc is checked
        against the record: a mismatch (the plan did not reproduce the
        batch) logs ``quarantine_crc_mismatch``; the position is skipped
        either way."""
        record = self.quarantined.get((int(epoch), int(epoch_step)))
        if record is None:
            return False
        expected = record.get("input_ids_crc32")
        if expected is not None:
            v = batch.get("input_ids")
            got = (zlib.crc32(np.ascontiguousarray(v).tobytes()) & 0xFFFFFFFF
                   if v is not None else None)
            if got != expected:
                log_json({"event": "quarantine_crc_mismatch", "epoch": int(epoch),
                          "epoch_step": int(epoch_step), "expected_crc32": expected,
                          "got_crc32": got})
        log_json({"event": "quarantine_skip", "epoch": int(epoch), "epoch_step": int(epoch_step)})
        return True

    def decide(self, anomaly: Mapping[str, Any], *,
               fingerprint: Mapping[str, Any] | None) -> Decision:
        """The escalation stage for one anomaly."""
        key = None
        if fingerprint is not None:
            key = (int(fingerprint["epoch"]), int(fingerprint["epoch_step"]))
        if key is not None and key in self.quarantined:
            return Decision("halt", f"anomaly recurred at already-quarantined batch {key} — "
                                    "not the data; rewinding again cannot help")
        if self.rewinds_done < self.max_rewinds:
            self.rewinds_done += 1
            return Decision("rewind", f"rewind {self.rewinds_done}/{self.max_rewinds}")
        if anomaly.get("code") != "nonfinite" and key is not None and self.skips_done == 0:
            # the state is still finite: dropping the suspect batch loses
            # nothing more; one try
            self.skips_done += 1
            return Decision("skip_batch", "rewind budget exhausted; state finite — "
                                          "quarantining the batch and continuing without restore")
        return Decision("halt",
                        f"rewind budget exhausted ({self.rewinds_done}/{self.max_rewinds})")
