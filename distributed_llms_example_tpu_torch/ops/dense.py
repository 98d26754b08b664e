"""Dense (linear) layer with flax ``nn.Dense(dtype=...)`` semantics.

Inputs, weight and bias are cast to the compute dtype and the product runs
there — what the JAX package's ``nn.Dense(dtype=bf16)`` does with fp32
parameters.  A serving build on CUDA stores the weights in the compute
dtype already (``core/precision.param_dtype``), so the casts are no-ops; a
training build keeps fp32 master weights and casts them here, per call,
with the cast's gradient flowing back to the fp32 copy.  The weight layout is
PyTorch's (out, in); ``models/from_jax.py`` transposes flax kernels.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class Dense(nn.Module):
    def __init__(self, in_features: int, out_features: int, *, use_bias: bool = True,
                 dtype: torch.dtype = torch.float32, param_dtype: torch.dtype = torch.float32,
                 device=None):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(out_features, in_features, dtype=param_dtype,
                                               device=device))
        self.bias = (
            nn.Parameter(torch.zeros(out_features, dtype=param_dtype, device=device))
            if use_bias else None
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = None if self.bias is None else self.bias.to(self.dtype)
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype), b)
