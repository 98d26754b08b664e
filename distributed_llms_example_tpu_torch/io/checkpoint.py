"""Mid-run checkpoints with integrity verification (port of the JAX
package's ``io/checkpoint.py``).

The JAX package writes its TrainState with Orbax; the port has its own
format.  One directory per step, ``<directory>/<step>/``, holds
``state.safetensors`` (the caller's named fp32 tensors: for the trainer
each master parameter by its port name, and its AdamW moments as
``mu/<name>`` and ``nu/<name>``) and ``meta.json`` (host scalars: the
step, AdamW's count).  A step is written into ``<step>.tmp/`` and renamed
into place whole, so a listed step is never half written.

Sidecars live next to the step directories, never inside them:
``integrity-<step>.json`` is the crc32 + size manifest of every file of
the step, written (tmp + fsync + rename) only for steps this instance
saved; ``recovery-<step>.json`` is the trainer's (data cursor and
quarantine set).  Both go when their step goes.

- ``save`` copies every tensor to the host before it returns (the fused
  AdamW kernel updates parameters and moments in place at the next step),
  then writes the files and the manifest, on one background thread with
  ``async_save``; the write retries with capped backoff
  (``ckpt_save_retry`` lines).  The thread is joined before the next save,
  before any restore and in ``wait``/``close``, which then apply the
  retention (the newest ``keep`` steps stay).
- ``restore_latest`` verifies newest first and walks back past a step
  whose manifest does not match (``ckpt_verify_failed``) or whose read
  fails (``ckpt_restore_failed``); ``restore_before`` and ``delete_after``
  serve the in-run rewind.

Over a process group (``layout``, a ``ShardLayout``) each rank holds shards
of the tensors (dim-0 row blocks over the ``fsdp`` axis, replicas over
``data``), and a step is ``state-r<rank>.safetensors`` from every rank of
the first ``data`` row (the other rows hold copies) plus ``meta.json``,
which gains ``mesh_layout`` (``{axes, processes}``), each tensor's global
shape (``shapes``) and the rows of each tensor each file holds
(``files``).  The save runs on the calling thread, since its gather of the
ranks' crc32s is a collective: the writers write and checksum their
files, process 0 gathers the sums, writes ``meta.json``, renames the step
into place and authors the manifest over every file; an error on any rank
is raised on every rank, the half-written step removed.  Process 0 verifies
on restore and broadcasts the verdict, so the walk-back is agreed; each
rank then reads its rows of every tensor from the files that hold them,
whatever layout saved the step (a resharding restore: another world size,
``fsdp=2`` saved and ``data=2`` restored, one process and a group either
way).  A saved global shape unlike the model's raises ``ReshardError``.
One process writes the one-file format above, unchanged.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import struct
import threading
import time
import zlib
from typing import Any, Mapping

import torch

from distributed_llms_example_tpu_torch.io.safetensors import (
    load_file,
    read_header,
    read_rows,
    save_file,
)
from distributed_llms_example_tpu_torch.parallel.fsdp import shard_rows
from distributed_llms_example_tpu_torch.utils.backoff import sleep_backoff
from distributed_llms_example_tpu_torch.utils.jsonlog import log_json

_MANIFEST_PREFIX = "integrity-"
_RECOVERY_PREFIX = "recovery-"
_SIDECAR_PREFIXES = (_MANIFEST_PREFIX, _RECOVERY_PREFIX)
STATE_FILE = "state.safetensors"
META_FILE = "meta.json"
SAVE_RETRIES = 3  # retries of a step's write after an I/O error
SAVE_RETRY_BACKOFF_S = 0.5  # the first retry's wait; it doubles, up to 8 s


class ReshardError(ValueError):
    """A saved tensor's global shape is not the model's: no layout change
    can restore it."""


@dataclasses.dataclass(frozen=True)
class ShardLayout:
    """This process's place on the (data, fsdp) mesh of a process group."""

    rank: int
    processes: int
    data: int
    fsdp: int

    @classmethod
    def of(cls, spec, rank: int) -> "ShardLayout":
        return cls(rank=rank, processes=spec.data * spec.fsdp, data=spec.data, fsdp=spec.fsdp)

    @property
    def writer(self) -> bool:
        """The first ``data`` row writes; the other rows hold copies."""
        return self.rank < self.fsdp

    @property
    def file(self) -> str:
        return f"state-r{self.rank}.safetensors"

    def rows(self, shape) -> tuple[int, int]:
        """The dim-0 rows of a tensor of global ``shape`` this rank holds
        (a 0-d tensor: its one value)."""
        return shard_rows(shape[0], self.fsdp, self.rank % self.fsdp) if len(shape) else (0, 1)

    def mesh_layout(self) -> dict:
        return {"axes": {"data": self.data, "fsdp": self.fsdp}, "processes": self.processes}


def _crc32_file(path: str, chunk: int = 1 << 24) -> tuple[int, int]:
    """(crc32, size) of one file, streamed."""
    crc = 0
    size = 0
    with open(path, "rb") as f:
        while True:
            buf = f.read(chunk)
            if not buf:
                break
            crc = zlib.crc32(buf, crc)
            size += len(buf)
    return crc & 0xFFFFFFFF, size


def compute_file_manifest(step_dir: str) -> dict[str, dict[str, int]]:
    """Relative path -> {crc32, size} for every file under a step
    directory."""
    out: dict[str, dict[str, int]] = {}
    for dirpath, _, files in os.walk(step_dir):
        for name in sorted(files):
            path = os.path.join(dirpath, name)
            crc, size = _crc32_file(path)
            out[os.path.relpath(path, step_dir)] = {"crc32": crc, "size": size}
    return out


def _fsync_path(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def write_json_atomic(path: str, obj: Any) -> None:
    """``obj`` as JSON at ``path``: tmp file + fsync + rename, so a reader
    sees the old file or the whole new one."""
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(obj, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def _broadcast(obj):
    """Process 0's ``obj`` on every rank."""
    box = [obj]
    torch.distributed.broadcast_object_list(box, src=0)
    return box[0]


def _describe(error: BaseException | None):
    """An error as (type name, message), which every rank can unpickle."""
    return None if error is None else (type(error).__name__, str(error)[:500])


def _all_gather(obj) -> list:
    out = [None] * torch.distributed.get_world_size()
    torch.distributed.all_gather_object(out, obj)
    return out


class Checkpointer:
    def __init__(self, directory: str, *, save_every_steps: int = 0, keep: int = 3,
                 async_save: bool = True, layout: ShardLayout | None = None):
        """``layout``: this process's place on the mesh of a process group
        (None: one process, the one-file format)."""
        self.directory = os.path.abspath(directory)
        self.layout = layout
        if self._leader:
            os.makedirs(self.directory, exist_ok=True)
        if layout is not None:
            torch.distributed.barrier()
        self.save_every_steps = save_every_steps
        self.keep = max(1, int(keep))
        self.async_save = async_save and layout is None
        self._writer: threading.Thread | None = None
        self._writer_error: BaseException | None = None

    @property
    def _leader(self) -> bool:
        """The process that lists, deletes and verifies steps."""
        return self.layout is None or self.layout.rank == 0

    # -- paths -----------------------------------------------------------

    def step_dir(self, step: int) -> str:
        return os.path.join(self.directory, str(step))

    def manifest_path(self, step: int) -> str:
        return os.path.join(self.directory, f"{_MANIFEST_PREFIX}{step}.json")

    def recovery_path(self, step: int) -> str:
        return os.path.join(self.directory, f"{_RECOVERY_PREFIX}{step}.json")

    def all_steps(self) -> list[int]:
        return sorted(int(n) for n in os.listdir(self.directory)
                      if n.isdigit() and os.path.isdir(os.path.join(self.directory, n)))

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    # -- saving ----------------------------------------------------------

    def should_save(self, step: int) -> bool:
        return self.save_every_steps > 0 and step % self.save_every_steps == 0

    def save(self, step: int, tensors: Mapping[str, torch.Tensor],
             meta: Mapping[str, Any], *, shapes: Mapping[str, tuple] | None = None) -> bool:
        """Save ``tensors`` (any device) and ``meta`` as step ``step``;
        False (nothing written) when the step is already on disk.  Every
        tensor is on the host when this returns; with ``async_save`` the
        files and the manifest are written on a background thread.  Under
        a ``layout``, ``tensors`` are this rank's shards and ``shapes``
        their global shapes, and the save is collective (every rank calls
        it; the step is on disk for all when it returns)."""
        self._finalize_manifests()  # the step in flight, too, is on disk after it
        if self.layout is not None:
            return self._save_sharded(int(step), tensors, dict(meta), shapes)
        if step in self.all_steps():
            return False  # e.g. the final step after a resume that trained nothing
        t0 = time.perf_counter()
        host = {k: t.detach().to("cpu", copy=True) for k, t in tensors.items()}
        copy_s = time.perf_counter() - t0
        args = (int(step), host, {**meta, "step": int(step)}, copy_s)
        if self.async_save:
            self._writer = threading.Thread(target=self._write_in_background, args=args,
                                            name=f"checkpoint-{step}", daemon=True)
            self._writer.start()
        else:
            self._write_with_retries(*args)
        return True

    def _write_in_background(self, *args) -> None:
        try:
            self._write_with_retries(*args)
        except BaseException as e:  # re-raised where the thread is joined
            self._writer_error = e

    def _write_with_retries(self, step: int, host: dict, meta: dict, copy_s: float) -> None:
        """The step's files (retried on an I/O error with capped backoff:
        the write starts over in a fresh ``<step>.tmp/``), then its
        manifest, then one ``ckpt_saved`` line.  Only the writer authors a
        manifest: one made at restore time for a step already on disk
        would checksum possibly corrupt files and call them verified."""
        delay = SAVE_RETRY_BACKOFF_S
        t0 = time.perf_counter()
        for attempt in range(SAVE_RETRIES + 1):
            try:
                nbytes = self._write(step, host, meta)
                break
            except OSError as e:
                if attempt == SAVE_RETRIES:
                    raise
                log_json({"event": "ckpt_save_retry", "step": step, "attempt": attempt + 1,
                          "backoff_s": round(delay, 3), "error": str(e)[:200]})
                delay = sleep_backoff(delay, cap_s=8.0)
        t1 = time.perf_counter()
        try:
            write_json_atomic(self.manifest_path(step),
                               {"step": step, "files": compute_file_manifest(self.step_dir(step))})
        except OSError as e:
            # the verify side reads a missing manifest as an unverifiable
            # (legacy) step; a sidecar write never takes the save down
            log_json({"event": "ckpt_manifest_write_failed", "step": step,
                      "error": str(e)[:200]})
        log_json({"event": "ckpt_saved", "step": step, "bytes": nbytes, "copy_s": copy_s,
                  "write_s": t1 - t0, "manifest_s": time.perf_counter() - t1})

    def _write(self, step: int, host: dict, meta: dict) -> int:
        """Write one step into ``<step>.tmp/``, fsync it and rename it into
        place; returns the bytes written."""
        final = self.step_dir(step)
        tmp = final + ".tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        state = os.path.join(tmp, STATE_FILE)
        save_file(host, state)
        _fsync_path(state)
        with open(os.path.join(tmp, META_FILE), "w") as f:
            json.dump(meta, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, final)
        _fsync_path(self.directory)
        return self._step_bytes(step)

    def _save_sharded(self, step: int, tensors, meta: dict, shapes) -> bool:
        """The sharded save (see the module docstring).  A rank's error
        (its write after the retries, its checksum, process 0's meta.json
        or rename) reaches every rank through the gathers that follow it:
        process 0 removes ``<step>.tmp/`` and every rank raises the first
        error, so none waits in a collective for a rank that is gone."""
        lay = self.layout
        if _broadcast(step in self.all_steps() if lay.rank == 0 else None):
            return False
        t0 = time.perf_counter()
        host = {k: t.detach().to("cpu", copy=True) for k, t in tensors.items()}
        copy_s = time.perf_counter() - t0
        final = self.step_dir(step)
        tmp = final + ".tmp"
        if lay.rank == 0:
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp)
        torch.distributed.barrier()
        t1 = time.perf_counter()
        entry = error = None
        if lay.writer:
            try:
                entry = self._write_shard(step, os.path.join(tmp, lay.file), host, shapes)
            except Exception as e:
                error = e
        gathered = _all_gather((entry, _describe(error)))
        self._raise_agreed(step, tmp, [e for _, e in gathered], error)
        entries = [e for e, _ in gathered if e is not None]
        error = None
        if lay.rank == 0:
            try:
                self._finish_sharded(step, tmp, meta, shapes, entries, copy_s, t1)
            except Exception as e:
                error = e
        self._raise_agreed(step, tmp, [_broadcast(_describe(error))], error)
        return True

    def _write_shard(self, step: int, path: str, host: dict, shapes) -> tuple:
        """Write and checksum this rank's file (retried on an I/O error);
        returns its manifest entry and the rows of each tensor it holds."""
        delay = SAVE_RETRY_BACKOFF_S
        for attempt in range(SAVE_RETRIES + 1):
            try:
                save_file(host, path)
                _fsync_path(path)
                break
            except OSError as e:
                if attempt == SAVE_RETRIES:
                    raise
                log_json({"event": "ckpt_save_retry", "step": step, "attempt": attempt + 1,
                          "backoff_s": round(delay, 3), "error": str(e)[:200]},
                         all_processes=True)
                delay = sleep_backoff(delay, cap_s=8.0)
        crc, size = _crc32_file(path)
        rows = {k: list(self.layout.rows(shapes[k])) for k in host}
        return os.path.basename(path), {"crc32": crc, "size": size}, rows

    def _finish_sharded(self, step: int, tmp: str, meta: dict, shapes, entries,
                        copy_s: float, t1: float) -> None:
        """Process 0: ``meta.json``, the rename into place, the manifest
        over every file and the ``ckpt_saved`` line."""
        meta = {**meta, "step": step, "mesh_layout": self.layout.mesh_layout(),
                "shapes": {k: list(v) for k, v in shapes.items()},
                "files": {name: rows for name, _, rows in entries}}
        with open(os.path.join(tmp, META_FILE), "w") as f:
            json.dump(meta, f)
            f.flush()
            os.fsync(f.fileno())
        crc, size = _crc32_file(os.path.join(tmp, META_FILE))
        os.replace(tmp, self.step_dir(step))
        _fsync_path(self.directory)
        t2 = time.perf_counter()
        files = {name: sums for name, sums, _ in entries}
        files[META_FILE] = {"crc32": crc, "size": size}
        try:
            write_json_atomic(self.manifest_path(step), {"step": step, "files": files})
        except OSError as e:
            log_json({"event": "ckpt_manifest_write_failed", "step": step,
                      "error": str(e)[:200]})
        log_json({"event": "ckpt_saved", "step": step, "bytes": self._step_bytes(step),
                  "copy_s": copy_s, "write_s": t2 - t1,
                  "manifest_s": time.perf_counter() - t2, "files": len(files)})

    def _raise_agreed(self, step: int, tmp: str, errors: list, own) -> None:
        """Raise on every rank when any rank's part of a sharded save
        failed (``errors``: each rank's ``_describe``), after process 0 has
        removed the half-written ``tmp``: the rank's own error as it was,
        another rank's as an OSError that names it."""
        failed = [(r, e) for r, e in enumerate(errors) if e is not None]
        if not failed:
            return
        if self.layout.rank == 0:
            shutil.rmtree(tmp, ignore_errors=True)
        if own is not None:
            raise own
        rank, (kind, msg) = failed[0]
        raise OSError(f"checkpoint step {step}: rank {rank} failed to save: {kind}: {msg}")

    def _step_bytes(self, step: int) -> int:
        d = self.step_dir(step)
        return sum(os.path.getsize(os.path.join(d, n)) for n in os.listdir(d))

    def _join(self) -> None:
        if self._writer is not None:
            self._writer.join()
            self._writer = None
        err, self._writer_error = self._writer_error, None
        if err is not None:
            raise err

    def _finalize_manifests(self) -> None:
        """Join the pending write, apply the retention (the newest ``keep``
        steps stay) and drop the sidecars of steps that are gone."""
        self._join()
        if not self._leader:
            return
        steps = self.all_steps()
        for s in steps[:-self.keep]:
            shutil.rmtree(self.step_dir(s), ignore_errors=True)
        kept = set(steps[-self.keep:])
        for name in os.listdir(self.directory):
            for prefix in _SIDECAR_PREFIXES:
                if not (name.startswith(prefix) and name.endswith(".json")):
                    continue
                stem = name[len(prefix):-len(".json")]
                if stem.isdigit() and int(stem) not in kept:
                    try:
                        os.remove(os.path.join(self.directory, name))
                    except OSError:
                        pass

    # -- verification ----------------------------------------------------

    def verify(self, step: int) -> str | None:
        """The step directory against its manifest: None when it verifies
        (or has no manifest: a legacy step, not corruption), else what
        does not match."""
        path = self.manifest_path(step)
        if not os.path.exists(path):
            return None
        try:
            with open(path) as f:
                manifest = json.load(f)
        except (OSError, json.JSONDecodeError) as e:
            return f"unreadable manifest {path}: {e}"
        expected = manifest.get("files", {})
        actual = compute_file_manifest(self.step_dir(step))
        problems = []
        for rel, meta in expected.items():
            got = actual.get(rel)
            if got is None:
                problems.append(f"missing file {rel}")
            elif got != meta:
                problems.append(f"{rel}: crc32/size {got['crc32']}/{got['size']} != "
                                f"manifest {meta['crc32']}/{meta['size']}")
        problems += [f"unexpected file {rel}" for rel in actual if rel not in expected]
        return "; ".join(problems[:5]) if problems else None

    # -- restoring -------------------------------------------------------

    def _read(self, step: int, like: Mapping[str, torch.Tensor] | None, shapes=None):
        with open(os.path.join(self.step_dir(step), META_FILE)) as f:
            meta = json.load(f)
        if self.layout is not None or "files" in meta:
            return self._read_rows(step, meta, like, shapes), meta
        tensors = load_file(os.path.join(self.step_dir(step), STATE_FILE))
        if like is not None:
            if set(tensors) != set(like):
                missing = sorted(set(like) - set(tensors))[:3]
                extra = sorted(set(tensors) - set(like))[:3]
                raise ValueError(f"step {step} holds other tensors than the live state "
                                 f"(missing {missing}, unexpected {extra})")
            for k, t in like.items():
                if tensors[k].shape != t.shape or tensors[k].dtype != t.dtype:
                    raise ValueError(f"step {step}: {k} is {tensors[k].dtype} "
                                     f"{tuple(tensors[k].shape)}, the live state's "
                                     f"{t.dtype} {tuple(t.shape)}")
        return tensors, meta

    def _read_rows(self, step: int, meta: dict, like: Mapping[str, torch.Tensor],
                   shapes: Mapping[str, tuple] | None) -> dict[str, torch.Tensor]:
        """This rank's rows of every tensor of ``like`` (global shapes
        ``shapes``; without them, ``like``'s own) from the files of the
        step that hold them: one file holding every row (one process's
        save) or the ranks' row blocks."""
        d = self.step_dir(step)
        files = meta.get("files") or {STATE_FILE: None}
        headers = {f: read_header(os.path.join(d, f)) for f in files}
        saved = {k: list(v) for k, v in meta["shapes"].items()} if "shapes" in meta else {
            k: info["shape"] for k, info in headers[STATE_FILE][0].items()}
        if set(saved) != set(like):
            missing = sorted(set(like) - set(saved))[:3]
            extra = sorted(set(saved) - set(like))[:3]
            raise ValueError(f"step {step} holds other tensors than the live state "
                             f"(missing {missing}, unexpected {extra})")
        out = {}
        for name, t in like.items():
            gshape = list(shapes[name] if shapes is not None else t.shape)
            if saved[name] != gshape:
                raise ReshardError(f"step {step}: {name} was saved with global shape "
                                   f"{saved[name]}, the model's is {gshape}")
            lo, hi = (self.layout.rows(gshape) if self.layout is not None
                      else (0, gshape[0] if gshape else 1))
            buf = torch.empty((hi - lo, *gshape[1:]) if gshape else (), dtype=t.dtype)
            covered = 0
            for f, rows in files.items():
                flo, fhi = rows[name] if rows is not None else (0, gshape[0] if gshape else 1)
                a, b = max(lo, flo), min(hi, fhi)
                if a >= b:
                    continue
                header, start = headers[f]
                part = read_rows(os.path.join(d, f), header, start, name, a - flo, b - flo)
                if part.dtype != t.dtype:
                    raise ValueError(f"step {step}: {name} in {f} is {part.dtype}, the live "
                                     f"state's {t.dtype}")
                if gshape:
                    buf[a - lo:b - lo] = part
                else:
                    buf.copy_(part.reshape(()))
                covered += b - a
            if covered != hi - lo:
                raise ValueError(f"step {step}: the files hold {covered} of rows {lo}..{hi} "
                                 f"of {name}")
            out[name] = buf.reshape(t.shape)
        return out

    def restore_latest(self, like: Mapping[str, torch.Tensor] | None = None, *,
                       max_step: int | None = None, shapes: Mapping[str, tuple] | None = None):
        """The newest VERIFIED step (at most ``max_step``) as (tensors on
        the host, meta, step), or None when no step verifies.  ``like``:
        the live tensors, whose names, shapes and dtypes the step must
        hold.  A step whose verified files fail to read is reported and
        skipped; one without a manifest whose read fails re-raises.  Under
        a ``layout`` this is collective: ``like`` are the rank's shards,
        ``shapes`` their global shapes, process 0 verifies and every rank
        reads the same step."""
        self._finalize_manifests()
        if self.layout is not None:
            return self._restore_agreed(like, max_step, shapes)
        remaining = [s for s in reversed(self.all_steps()) if max_step is None or s <= max_step]
        while True:
            chosen = None
            for step in remaining:
                t0 = time.perf_counter()
                problem = self.verify(step)
                verify_s = time.perf_counter() - t0
                if problem is not None:
                    log_json({"event": "ckpt_verify_failed", "step": int(step),
                              "detail": problem[:300]})
                    continue
                chosen = step
                break
            if chosen is None:
                return None
            t1 = time.perf_counter()
            try:
                tensors, meta = self._read(chosen, like, shapes)
            except (OSError, ValueError, KeyError, struct.error) as e:
                err = e
            else:
                log_json({"event": "ckpt_restored", "step": int(chosen),
                          "bytes": self._step_bytes(chosen),
                          "verify_s": verify_s, "read_s": time.perf_counter() - t1,
                          "verified": os.path.exists(self.manifest_path(chosen))})
                return tensors, meta, chosen
            if not os.path.exists(self.manifest_path(chosen)):
                raise err
            log_json({"event": "ckpt_restore_failed", "step": int(chosen),
                      "error": str(err)[:300]})
            remaining = [s for s in remaining if s < chosen]
            if not remaining:
                raise err

    def _verified(self, remaining: list[int]) -> int | None:
        """The newest step of ``remaining`` that verifies (each failure
        logged), or None."""
        for step in remaining:
            problem = self.verify(step)
            if problem is None:
                return step
            log_json({"event": "ckpt_verify_failed", "step": int(step), "detail": problem[:300]})
        return None

    def _restore_agreed(self, like, max_step, shapes):
        """``restore_latest`` over a process group: process 0 verifies
        newest first and broadcasts its choice; every rank reads its rows;
        a read failing on any rank walks every rank back past that step."""
        remaining = [s for s in reversed(self.all_steps()) if max_step is None or s <= max_step]
        while True:
            t0 = time.perf_counter()
            chosen = _broadcast(self._verified(remaining) if self.layout.rank == 0 else None)
            if chosen is None:
                return None
            verify_s = time.perf_counter() - t0
            t1 = time.perf_counter()
            err = None
            try:
                tensors, meta = self._read(chosen, like, shapes)
            except (OSError, ValueError, KeyError, struct.error) as e:
                err = e
            errors = [e for e in _all_gather(None if err is None else repr(err)[:300]) if e]
            if not errors:
                log_json({"event": "ckpt_restored", "step": int(chosen),
                          "bytes": self._step_bytes(chosen), "verify_s": verify_s,
                          "read_s": time.perf_counter() - t1,
                          "verified": os.path.exists(self.manifest_path(chosen)),
                          "saved_layout": meta.get("mesh_layout"),
                          "layout": self.layout.mesh_layout()})
                return tensors, meta, chosen
            if isinstance(err, ReshardError):
                raise err
            log_json({"event": "ckpt_restore_failed", "step": int(chosen), "error": errors[0]})
            remaining = [s for s in remaining if s < chosen]
            if not remaining:
                raise err if err is not None else ValueError(errors[0])

    def restore_before(self, step: int, like: Mapping[str, torch.Tensor] | None = None, *,
                       shapes: Mapping[str, tuple] | None = None):
        """The newest verified step STRICTLY OLDER than ``step``: the
        rewind target (a step saved at or after the anomaly may hold the
        poisoned state)."""
        return self.restore_latest(like, max_step=step - 1, shapes=shapes)

    def delete_after(self, step: int) -> list[int]:
        """Drop every step newer than ``step`` with its sidecars: after a
        rewind they may hold poisoned state that checksums clean, and
        ``save`` refuses a step on disk, so the replay could not refresh
        them."""
        self._join()
        doomed = [s for s in self.all_steps() if s > step]
        if self.layout is not None:
            torch.distributed.barrier()  # every rank listed before any deletes
            if self.layout.rank != 0:
                torch.distributed.barrier()
                return doomed
        for s in doomed:
            shutil.rmtree(self.step_dir(s), ignore_errors=True)
            for prefix in _SIDECAR_PREFIXES:
                try:
                    os.remove(os.path.join(self.directory, f"{prefix}{s}.json"))
                except OSError:
                    pass
        if doomed:
            log_json({"event": "ckpt_deleted_after_rewind", "steps": doomed})
        if self.layout is not None:
            torch.distributed.barrier()
        return doomed

    def wait(self) -> None:
        self._finalize_manifests()

    def close(self) -> None:
        self.wait()
