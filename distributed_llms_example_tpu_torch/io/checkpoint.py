"""Mid-run checkpoints with integrity verification (port of the JAX
package's ``io/checkpoint.py``, one process).

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
"""

from __future__ import annotations

import json
import os
import shutil
import struct
import threading
import time
import zlib
from typing import Any, Mapping

import torch

from distributed_llms_example_tpu_torch.io.safetensors import load_file, save_file
from distributed_llms_example_tpu_torch.utils.backoff import sleep_backoff
from distributed_llms_example_tpu_torch.utils.jsonlog import log_json

_MANIFEST_PREFIX = "integrity-"
_RECOVERY_PREFIX = "recovery-"
_SIDECAR_PREFIXES = (_MANIFEST_PREFIX, _RECOVERY_PREFIX)
STATE_FILE = "state.safetensors"
META_FILE = "meta.json"
SAVE_RETRIES = 3  # retries of a step's write after an I/O error
SAVE_RETRY_BACKOFF_S = 0.5  # the first retry's wait; it doubles, up to 8 s


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


class Checkpointer:
    def __init__(self, directory: str, *, save_every_steps: int = 0, keep: int = 3,
                 async_save: bool = True):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.save_every_steps = save_every_steps
        self.keep = max(1, int(keep))
        self.async_save = async_save
        self._writer: threading.Thread | None = None
        self._writer_error: BaseException | None = None

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
             meta: Mapping[str, Any]) -> bool:
        """Save ``tensors`` (any device) and ``meta`` as step ``step``;
        False (nothing written) when the step is already on disk.  Every
        tensor is on the host when this returns; with ``async_save`` the
        files and the manifest are written on a background thread."""
        self._finalize_manifests()  # the step in flight, too, is on disk after it
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

    def _read(self, step: int, like: Mapping[str, torch.Tensor] | None):
        tensors = load_file(os.path.join(self.step_dir(step), STATE_FILE))
        with open(os.path.join(self.step_dir(step), META_FILE)) as f:
            meta = json.load(f)
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

    def restore_latest(self, like: Mapping[str, torch.Tensor] | None = None, *,
                       max_step: int | None = None):
        """The newest VERIFIED step (at most ``max_step``) as (tensors on
        the host, meta, step), or None when no step verifies.  ``like``:
        the live tensors, whose names, shapes and dtypes the step must
        hold.  A step whose verified files fail to read is reported and
        skipped; one without a manifest whose read fails re-raises."""
        self._finalize_manifests()
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
                tensors, meta = self._read(chosen, like)
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

    def restore_before(self, step: int, like: Mapping[str, torch.Tensor] | None = None):
        """The newest verified step STRICTLY OLDER than ``step``: the
        rewind target (a step saved at or after the anomaly may hold the
        poisoned state)."""
        return self.restore_latest(like, max_step=step - 1)

    def delete_after(self, step: int) -> list[int]:
        """Drop every step newer than ``step`` with its sidecars: after a
        rewind they may hold poisoned state that checksums clean, and
        ``save`` refuses a step on disk, so the replay could not refresh
        them."""
        self._join()
        doomed = [s for s in self.all_steps() if s > step]
        for s in doomed:
            shutil.rmtree(self.step_dir(s), ignore_errors=True)
            for prefix in _SIDECAR_PREFIXES:
                try:
                    os.remove(os.path.join(self.directory, f"{prefix}{s}.json"))
                except OSError:
                    pass
        if doomed:
            log_json({"event": "ckpt_deleted_after_rewind", "steps": doomed})
        return doomed

    def wait(self) -> None:
        self._finalize_manifests()

    def close(self) -> None:
        self.wait()
