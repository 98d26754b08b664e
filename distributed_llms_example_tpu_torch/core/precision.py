"""Mixed-precision policy and device resolution.

The policy mirrors the JAX package's ``core/precision.py``: matmuls and
activations run in the compute dtype (bf16 by default), softmax and
LayerNorm statistics in fp32.  Parameter storage differs by use: a
training build keeps fp32 master weights on every device (the JAX
package's ``param_dtype``, and what the fused AdamW kernel updates), each
``Dense`` casting its weight to the compute dtype per call; a serving
build stores matmul weights on CUDA in the compute dtype so no per-call
cast moves them again (on the CPU they stay fp32, what the parity tests
compare).  LayerNorm parameters and ``final_logits_bias`` stay fp32
everywhere.
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


def param_dtype(compute_dtype: torch.dtype, device: torch.device, *,
                train: bool = False) -> torch.dtype:
    """Storage dtype of matmul weights and embeddings: fp32 master weights
    for training and on the CPU, the compute dtype for serving on CUDA."""
    return torch.float32 if train or device.type == "cpu" else compute_dtype
