"""Build the port's CUDA kernels with ``nvcc`` and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C function and is compiled on its
own into ``build/kernels/lib<name>-<hash>.so`` at the repository root (the
hash is of the source and of every shared ``csrc/*.cuh`` header, so an
edited kernel or header rebuilds and a stale library is never loaded).
Nothing outside the repository's sources goes into a build: no PyTorch
headers, no CUTLASS — a kernel builds in seconds.

``build(names)`` starts one ``nvcc`` per source, all at once, and waits
for every one; ``load(name, argtypes[, symbol])`` builds if needed and
returns the C function (a source may export several) with its
``argtypes`` set (``c_void_p`` for pointers and the
stream, so no pointer is cut to 32 bits) and ``restype`` int: the kernel's
``cudaGetLastError()`` after launch, which the caller turns into an error.
Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

_LOADED: dict[str, ctypes._CFuncPtr] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError(
            "nvcc not found (looked on PATH and in /usr/local/cuda/bin): the "
            "port's CUDA kernels are built from csrc/ at first use"
        )
    return found


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` builds to: named by a hash of the source and
    of every header under ``csrc/`` (any of which it may include)."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: list[str] | tuple[str, ...], *, verbose: bool = False) -> dict[str, float]:
    """Compile every named kernel that has no up-to-date library, one
    ``nvcc`` process per source, all running together.  Returns each
    built kernel's compile seconds; raises with the compiler's output if
    any build fails.  ``verbose`` adds ptxas's per-kernel report (registers,
    spills) and prints it."""
    import time

    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
               "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True), tmp, out)
    seconds, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"--- nvcc {name}.cu (exit {proc.returncode})\n{log}")
            continue
        if verbose and log:
            print(log, flush=True)
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return seconds


def load(name: str, argtypes: list, symbol: str | None = None) -> ctypes._CFuncPtr:
    """The C entry ``symbol`` (default ``name``) of ``csrc/<name>.cu``,
    built on first use."""
    symbol = symbol or name
    fn = _LOADED.get(symbol)
    if fn is None:
        build([name])
        fn = getattr(ctypes.CDLL(str(library_path(name))), symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _LOADED[symbol] = fn
    return fn


def check(err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def check_inputs(what: str, tensors: dict):
    """The device of ``tensors`` (name → tensor), after checking that every
    one is a contiguous tensor on one CUDA device; raises ValueError
    naming ``what`` and the offending tensor otherwise."""
    dev = None
    for name, t in tensors.items():
        if t.device.type != "cuda":
            raise ValueError(f"{what}: {name} is on {t.device}, expected a CUDA device")
        if dev is not None and t.device != dev:
            raise ValueError(f"{what}: {name} is on {t.device}, others on {dev}")
        dev = t.device
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
    return dev
