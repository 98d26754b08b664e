"""Weight bridge: the JAX package's BART param tree → this port's state_dict.

The tree is given as nested dicts of numpy arrays (``jax.device_get`` of
the flax params), so this module needs neither JAX nor the JAX package.
Renames: ``encoder_block_{i}`` → ``encoder_blocks.{i}`` (likewise the
decoder), embedding tables ``embedding`` → ``weight``, LayerNorm ``scale``
→ ``weight``; a flax ``Dense`` kernel (in, out) becomes ``Linear.weight``
(out, in).  ``final_logits_bias`` is carried across, and the LM head needs
no entry: it is tied to ``shared`` in both packages.
"""

from __future__ import annotations

import re
from typing import Any, Mapping

import numpy as np
import torch


def _flatten(tree: Mapping[str, Any], prefix: tuple = ()) -> dict[tuple, np.ndarray]:
    out: dict[tuple, np.ndarray] = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


def bart_state_dict_from_jax(params: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """Port-named fp32 tensors for every leaf of a JAX BART param tree."""
    sd: dict[str, torch.Tensor] = {}
    for path, arr in _flatten(params).items():
        parts = []
        for p in path:
            m = re.fullmatch(r"(encoder|decoder)_block_(\d+)", p)
            parts.append(f"{m.group(1)}_blocks.{m.group(2)}" if m else p)
        leaf = parts[-1]
        if leaf == "kernel":
            arr = arr.T
        if leaf in ("kernel", "embedding", "scale"):
            parts[-1] = "weight"
        sd[".".join(parts)] = torch.tensor(np.asarray(arr, dtype=np.float32))
    return sd


def load_jax_params(module: torch.nn.Module, params: Mapping[str, Any]) -> None:
    """Copy a JAX BART param tree into ``module`` (strict: every port
    parameter must be covered and every JAX leaf used), casting each leaf
    to its parameter's dtype and device."""
    sd = bart_state_dict_from_jax(params)
    own = module.state_dict()
    missing = sorted(set(own) - set(sd))
    extra = sorted(set(sd) - set(own))
    if missing or extra:
        raise KeyError(f"JAX tree does not match the port: missing {missing}, unexpected {extra}")
    for name, t in sd.items():
        if tuple(t.shape) != tuple(own[name].shape):
            raise ValueError(f"{name}: JAX shape {tuple(t.shape)} != port {tuple(own[name].shape)}")
    module.load_state_dict({n: t.to(own[n].dtype) for n, t in sd.items()}, strict=True)
