"""The ``.safetensors`` file format, read and written with torch alone (the
port imports no ``safetensors`` package; the JAX package uses the
library, and the tests hold the two byte-compatible both ways).

A file is an 8-byte little-endian header length N, N bytes of JSON, then
the tensors' raw little-endian bytes.  The header maps each tensor's name
to ``{"dtype", "shape", "data_offsets": [begin, end]}`` (offsets into the
bytes after the header) and may hold ``"__metadata__"``, a dict of
strings.  Writing pads the header with spaces to a multiple of 8 bytes and
lays the tensors out back to back in the order given, as the library
accepts.
"""

from __future__ import annotations

import json
import os
import struct

import torch

_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
    "I64": torch.int64, "I32": torch.int32, "I16": torch.int16, "I8": torch.int8,
    "U8": torch.uint8, "BOOL": torch.bool,
}
_NAMES = {v: k for k, v in _DTYPES.items()}


def load_file(path: str | os.PathLike) -> dict[str, torch.Tensor]:
    """Every tensor of a ``.safetensors`` file, as CPU tensors in the
    file's dtypes and in its header's order."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        data = bytearray(os.fstat(f.fileno()).st_size - 8 - n)
        if f.readinto(data) != len(data):
            raise ValueError(f"{path}: truncated safetensors file")
    header.pop("__metadata__", None)
    out = {}
    for name, info in header.items():
        if info["dtype"] not in _DTYPES:
            raise ValueError(f"{path}: {name} has dtype {info['dtype']}, which the port does "
                             f"not read (one of {sorted(_DTYPES)})")
        dtype = _DTYPES[info["dtype"]]
        begin, end = info["data_offsets"]
        shape = info["shape"]
        count = 1
        for d in shape:
            count *= d
        size = torch.empty((), dtype=dtype).element_size()
        if end - begin != count * size or end > len(data):
            raise ValueError(f"{path}: {name}'s offsets {begin}..{end} do not hold {shape} "
                             f"{info['dtype']}")
        if not count:
            t = torch.empty(0, dtype=dtype)
        elif begin % size == 0:
            t = torch.frombuffer(data, dtype=dtype, count=count, offset=begin)
        else:  # an unaligned tensor (the library's writer never makes one) gets its own copy
            t = torch.frombuffer(bytearray(data[begin:end]), dtype=dtype)
        out[name] = t.reshape(shape)
    return out


def save_file(tensors: dict[str, torch.Tensor], path: str | os.PathLike,
              metadata: dict[str, str] | None = None) -> None:
    """Write ``tensors`` (any device; each is copied to the CPU in turn) as
    one ``.safetensors`` file, with ``metadata`` under ``__metadata__``."""
    header: dict = {} if metadata is None else {"__metadata__": dict(metadata)}
    offset = 0
    for name, t in tensors.items():
        if t.dtype not in _NAMES:
            raise ValueError(f"{name}: dtype {t.dtype} has no safetensors name")
        nbytes = t.numel() * t.element_size()
        header[name] = {"dtype": _NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + nbytes]}
        offset += nbytes
    raw = json.dumps(header, separators=(",", ":")).encode()
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for t in tensors.values():
            if t.numel():
                f.write(t.detach().to("cpu").contiguous().reshape(-1).view(torch.uint8).numpy())


def read_header(path: str | os.PathLike) -> tuple[dict, int]:
    """A file's header (without ``__metadata__``) and the offset of its
    tensor bytes."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
    header.pop("__metadata__", None)
    return header, 8 + n


def read_rows(path: str | os.PathLike, header: dict, data_start: int, name: str, lo: int,
              hi: int) -> torch.Tensor:
    """Rows ``[lo, hi)`` along dim 0 of tensor ``name`` (a 0-d tensor: the
    whole of it), read alone from the file: a CPU tensor of the file's
    dtype."""
    info = header[name]
    dtype = _DTYPES[info["dtype"]]
    shape = list(info["shape"])
    size = torch.empty((), dtype=dtype).element_size()
    if not shape:
        lo, hi, row, out_shape = 0, 1, size, []
    else:
        row = size
        for d in shape[1:]:
            row *= d
        if not 0 <= lo <= hi <= shape[0]:
            raise ValueError(f"{path}: rows {lo}..{hi} of {name} {shape}")
        out_shape = [hi - lo, *shape[1:]]
    nbytes = (hi - lo) * row
    buf = bytearray(nbytes)
    with open(path, "rb") as f:
        f.seek(data_start + info["data_offsets"][0] + lo * row)
        if f.readinto(buf) != nbytes:
            raise ValueError(f"{path}: truncated safetensors file")
    if not nbytes:
        return torch.empty(out_shape, dtype=dtype)
    return torch.frombuffer(buf, dtype=dtype).reshape(out_shape)
