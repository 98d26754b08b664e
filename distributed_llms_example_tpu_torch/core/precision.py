"""Mixed-precision policy and device resolution.

The policy mirrors the JAX package's ``core/precision.py``: matmuls and
activations run in the compute dtype (bf16 by default), softmax and
LayerNorm statistics in fp32.  Parameter storage differs by device: on
the CPU parameters stay fp32 (the JAX package's master-weight dtype, and
what the parity tests compare); on CUDA the matmul weights are stored in
the compute dtype so no per-call cast moves them again.  LayerNorm
parameters and ``final_logits_bias`` stay fp32 everywhere.
"""

from __future__ import annotations

import torch

_DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
}


def parse_dtype(name: str) -> torch.dtype:
    try:
        return _DTYPES[name]
    except KeyError:
        raise ValueError(f"unknown dtype {name!r}; choose from {sorted(_DTYPES)}") from None


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    the CPU.  Without a GPU and without an explicit ``"cpu"`` this raises:
    an entry point never carries on quietly on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; the port runs on an NVIDIA GPU "
            "unless asked for the CPU explicitly (device='cpu' / --device cpu)"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}: use 'cuda' or 'cpu'")
    return dev


def param_dtype(compute_dtype: torch.dtype, device: torch.device) -> torch.dtype:
    """Storage dtype of matmul weights and embeddings: fp32 on the CPU, the
    compute dtype on CUDA."""
    return torch.float32 if device.type == "cpu" else compute_dtype
