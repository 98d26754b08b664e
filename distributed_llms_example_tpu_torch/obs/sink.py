"""The pluggable metric sink (port of the JAX package's ``obs/sink.py``):
every JSON line of the port funnels here (``utils/jsonlog.log_json``).

Channels:

- ``StdoutSink``: the Valohai metadata contract, one ``json.dumps`` line per
  record on stdout, flushed; process 0 only.
- ``JsonlFileSink``: the same records appended to a per-process JSONL file
  under the output dir, each stamped with ``schema_version``.  Best effort:
  a full disk or a vanished output dir never kills a training step.
- ``TeeSink``: fan-out.

``install_sink`` swaps the process-wide sink (the trainer installs the
one of its ``--obs`` mode before its first line).  The process gate lives
in ``wants`` and is checked BEFORE the caller converts device scalars to
host numbers: on a silent rank a record nobody emits costs no device sync.

A record may be ``local`` (per-process telemetry: span windows, budget
accounts, recorder events, agreed verdicts): it goes to every rank's own
file, while stdout stays process 0's.  A ``bulk`` record (span instances,
a device account's lanes) goes to the file channel only, never to stdout.  ``ProductJsonlWriter`` (the serving
router's and load generator's output) waits for their slice.
"""

from __future__ import annotations

import json
import os
import sys
from typing import Any, Mapping

SCHEMA_VERSION = 1


def _process_index() -> int:
    # imported here: core.mesh imports core.config, which imports the chaos
    # module, which logs through this one
    from distributed_llms_example_tpu_torch.core.mesh import process_index

    return process_index()


class StdoutSink:
    """The Valohai stdout channel: process 0 only, unless a record is for
    every process (``all_processes``); ``local`` does not widen it."""

    def wants(self, *, all_processes: bool = False, local: bool = False,
              bulk: bool = False) -> bool:
        return not bulk and (all_processes or _process_index() == 0)

    def emit(self, record: Mapping[str, Any], *, all_processes: bool = False,
             local: bool = False, bulk: bool = False) -> None:
        if self.wants(all_processes=all_processes, local=local, bulk=bulk):
            print(json.dumps(record), file=sys.stdout, flush=True)

    def flush(self, *, fsync: bool = False) -> None:
        pass  # print() flushes every line

    def close(self) -> None:
        pass


class JsonlFileSink:
    """Records appended to a JSONL file, one ``schema_version``-stamped
    object per line.  Opened on the first record, so a sink for an output
    dir that does not exist yet costs nothing; an I/O error turns the sink
    off (telemetry never takes the run down)."""

    def __init__(self, path: str):
        self.path = path
        self._f = None
        self._dead = False

    def wants(self, *, all_processes: bool = False, local: bool = False,
              bulk: bool = False) -> bool:
        # the file is per process by its path: a local or bulk record lands
        # in every rank's own file
        return not self._dead and (all_processes or local or bulk or _process_index() == 0)

    def emit(self, record: Mapping[str, Any], *, all_processes: bool = False,
             local: bool = False, bulk: bool = False) -> None:
        if not self.wants(all_processes=all_processes, local=local, bulk=bulk):
            return
        try:
            if self._f is None:
                os.makedirs(os.path.dirname(self.path), exist_ok=True)
                self._f = open(self.path, "a", buffering=1)
            # one write() a record: a kill can tear only the last line
            self._f.write(json.dumps({"schema_version": SCHEMA_VERSION, **record}) + "\n")
        except OSError:
            self._dead = True

    def flush(self, *, fsync: bool = False) -> None:
        """Push buffered lines to the OS and, with ``fsync``, to disk (on an
        anomaly and at the run's end, so the last window survives a kill)."""
        if self._f is None:
            return
        try:
            self._f.flush()
            if fsync:
                os.fsync(self._f.fileno())
        except OSError:
            self._dead = True

    def close(self) -> None:
        if self._f is not None:
            try:
                self.flush(fsync=True)
                self._f.close()
            except OSError:
                pass
            self._f = None


class TeeSink:
    def __init__(self, sinks: list):
        self.sinks = list(sinks)

    def wants(self, *, all_processes: bool = False, local: bool = False,
              bulk: bool = False) -> bool:
        return any(s.wants(all_processes=all_processes, local=local, bulk=bulk)
                   for s in self.sinks)

    def emit(self, record: Mapping[str, Any], *, all_processes: bool = False,
             local: bool = False, bulk: bool = False) -> None:
        for s in self.sinks:
            s.emit(record, all_processes=all_processes, local=local, bulk=bulk)

    def flush(self, *, fsync: bool = False) -> None:
        for s in self.sinks:
            s.flush(fsync=fsync)

    def close(self) -> None:
        for s in self.sinks:
            s.close()


_DEFAULT = StdoutSink()
_SINK = _DEFAULT


def current_sink():
    return _SINK


def install_sink(sink) -> None:
    """Swap the process-wide sink, closing the old one unless it is the
    shared stdout sink."""
    global _SINK
    if _SINK is not _DEFAULT and _SINK is not sink:
        _SINK.close()
    _SINK = sink


def build_sink(mode: str, output_dir: str):
    """``--obs`` mode -> sink.  "off" and "stdout" keep the stdout channel
    alone ("off" turns the obs instrumentation off, never the platform's
    lines); "jsonl" tees it into ``<output_dir>/obs/metrics-p{rank:03d}.jsonl``
    (the rank in the name: the processes of a group share the output dir)."""
    if mode != "jsonl":
        return _DEFAULT
    path = os.path.join(output_dir, "obs", f"metrics-p{_process_index():03d}.jsonl")
    return TeeSink([_DEFAULT, JsonlFileSink(path)])


def wants(*, all_processes: bool = False, local: bool = False, bulk: bool = False) -> bool:
    return _SINK.wants(all_processes=all_processes, local=local, bulk=bulk)


def emit(record: Mapping[str, Any], *, all_processes: bool = False, local: bool = False,
         bulk: bool = False) -> None:
    _SINK.emit(record, all_processes=all_processes, local=local, bulk=bulk)


def flush(*, fsync: bool = False) -> None:
    """Flush the installed sink's file channels (``fsync``: to disk)."""
    _SINK.flush(fsync=fsync)
