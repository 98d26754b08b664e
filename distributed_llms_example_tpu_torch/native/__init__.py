"""Native (C++) host code of the port: the JSONL record loader (the port's
own copy of the JAX package's ``native/``).

``jsonl_loader.cc`` parses line-delimited JSON records outside the
interpreter.  It is compiled at first use with ``g++ -std=c++17 -O2
-shared -fPIC`` into ``build/native/`` at the repository root (gitignored),
under a name that hashes the source, and read through a zero-copy ctypes
view.  ``data/dataset.py`` routes JSONL files through it.

Record values that are JSON strings are unescaped in C++; anything else
(numbers, bools, null, nested values) arrives as raw JSON text and is
parsed by ``json.loads`` only when that field is read.

A failed build is an error that names g++'s message (``load_jsonl``
raises it; ``available()`` is False and ``build_error()`` holds it): the
loader never falls back quietly.  ``DLLM_NATIVE_JSONL=0`` opts out of it.
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import os
import subprocess
import threading
from pathlib import Path
from typing import Iterator, Sequence

SRC = Path(__file__).resolve().parent / "jsonl_loader.cc"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "native"

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_build_error: str | None = None


class _DllmJsonl(ctypes.Structure):
    _fields_ = [
        ("parsed", ctypes.c_void_p),
        ("n_records", ctypes.c_int64),
        ("n_fields", ctypes.c_int64),
        ("arena", ctypes.c_void_p),
        ("arena_len", ctypes.c_int64),
        ("rec_start", ctypes.POINTER(ctypes.c_int64)),
        ("key_off", ctypes.POINTER(ctypes.c_int64)),
        ("key_len", ctypes.POINTER(ctypes.c_int64)),
        ("val_off", ctypes.POINTER(ctypes.c_int64)),
        ("val_len", ctypes.POINTER(ctypes.c_int64)),
        ("kind", ctypes.POINTER(ctypes.c_int8)),
        ("error", ctypes.c_char_p),
    ]


def library_path() -> Path:
    """Where the library of this source lives (its name hashes the source,
    so an edited source builds anew)."""
    digest = hashlib.sha256(SRC.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"_jsonl-{digest}.so"


def _build(so: Path) -> str | None:
    """Compile the library if it is not there; returns g++'s error or None.
    Each build writes its own temporary name and renames it into place:
    the rename is atomic, so racing builds are harmless and a cut build
    never leaves a truncated library under the final name."""
    if so.exists():
        return None
    so.parent.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    cmd = ["g++", "-std=c++17", "-O2", "-shared", "-fPIC", str(SRC), "-o", str(tmp)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"g++ unavailable: {e}"
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        return f"g++ failed (exit {proc.returncode}): {proc.stderr[-2000:]}"
    os.replace(tmp, so)
    return None


def _load_lib() -> ctypes.CDLL | None:
    global _lib, _build_error
    with _lock:
        if _lib is not None or _build_error is not None:
            return _lib
        so = library_path()
        err = _build(so)
        if err is not None:
            _build_error = err
            return None
        try:
            lib = ctypes.CDLL(str(so))
        except OSError as e:
            _build_error = f"{so}: {e}"
            return None
        lib.dllm_jsonl_load.argtypes = [ctypes.c_char_p]
        lib.dllm_jsonl_load.restype = ctypes.POINTER(_DllmJsonl)
        lib.dllm_jsonl_parse.argtypes = [ctypes.c_char_p, ctypes.c_int64]
        lib.dllm_jsonl_parse.restype = ctypes.POINTER(_DllmJsonl)
        lib.dllm_jsonl_free.argtypes = [ctypes.POINTER(_DllmJsonl)]
        lib.dllm_jsonl_free.restype = None
        _lib = lib
        return _lib


def available() -> bool:
    """True when the loader built and loaded on this machine (building it
    on the first call)."""
    return _load_lib() is not None


def build_error() -> str | None:
    """Why ``available()`` is False (None while it is True or untried)."""
    return _build_error


class JsonlRecords(Sequence):
    """Zero-copy lazy view over a parsed JSONL file.

    ``records[i]`` materializes one dict: string fields are decoded straight
    out of the C++ arena, other fields through ``json.loads`` of their raw
    text.  Nothing is materialized until it is read."""

    def __init__(self, handle, lib: ctypes.CDLL):
        self._h = handle
        self._lib = lib
        c = handle.contents
        self._n = int(c.n_records)
        self._arena = (ctypes.c_char * c.arena_len).from_address(c.arena) if c.arena_len else b""

    def __len__(self) -> int:
        return self._n

    def _field(self, j: int) -> tuple[str, object]:
        c = self._h.contents
        key = self._arena[c.key_off[j]: c.key_off[j] + c.key_len[j]].decode("utf-8")
        raw = self._arena[c.val_off[j]: c.val_off[j] + c.val_len[j]]
        if c.kind[j] == 0:
            return key, raw.decode("utf-8")
        return key, json.loads(raw)

    def __getitem__(self, i):
        if isinstance(i, slice):
            return [self[j] for j in range(*i.indices(self._n))]
        if i < 0:
            i += self._n  # a list's negative indexing
        if not 0 <= i < self._n:
            raise IndexError(i)
        c = self._h.contents
        return dict(self._field(j) for j in range(c.rec_start[i], c.rec_start[i + 1]))

    def __iter__(self) -> Iterator[dict]:
        for i in range(self._n):
            yield self[i]

    def __del__(self) -> None:
        h, self._h = getattr(self, "_h", None), None
        if h is not None:
            self._lib.dllm_jsonl_free(h)


def load_jsonl(path: str) -> JsonlRecords:
    """Parse a JSONL file with the native loader.  Raises ``RuntimeError``
    naming g++'s message when the loader did not build, and ``ValueError``
    (with the parser's line number) on a line it rejects."""
    lib = _load_lib()
    if lib is None:
        raise RuntimeError(f"the native JSONL loader did not build: {_build_error} "
                           "(DLLM_NATIVE_JSONL=0 reads JSONL in Python)")
    handle = lib.dllm_jsonl_load(os.fspath(path).encode())
    if handle.contents.error:
        msg = handle.contents.error.decode()
        lib.dllm_jsonl_free(handle)
        raise ValueError(f"{path}: {msg}")
    return JsonlRecords(handle, lib)
