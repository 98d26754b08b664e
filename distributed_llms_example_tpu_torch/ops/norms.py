"""Normalization layers (port of the JAX package's ``ops/norms.py``).

Statistics are accumulated in fp32 even when activations are bf16, then
the result is cast back to the compute dtype.
"""

from __future__ import annotations

import torch
from torch import nn


class RMSNorm(nn.Module):
    """T5/LLaMA-style RMS normalization: no mean subtraction, no bias; an
    fp32 scale and fp32 statistics."""

    def __init__(self, dim: int, epsilon: float = 1e-6,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.epsilon = epsilon
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(dim, dtype=torch.float32, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        var = x32.square().mean(dim=-1, keepdim=True)
        y = x32 * torch.reciprocal(torch.sqrt(var + self.epsilon))
        return (y * self.weight).to(self.dtype)


class LayerNorm(nn.Module):
    """BART-style layernorm with bias; fp32 parameters and statistics."""

    def __init__(self, dim: int, epsilon: float = 1e-5,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.epsilon = epsilon
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(dim, dtype=torch.float32, device=device))
        self.bias = nn.Parameter(torch.zeros(dim, dtype=torch.float32, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        mean = x32.mean(dim=-1, keepdim=True)
        var = (x32 - mean).square().mean(dim=-1, keepdim=True)
        y = (x32 - mean) * torch.reciprocal(torch.sqrt(var + self.epsilon))
        return (y * self.weight + self.bias).to(self.dtype)
