"""Weight bridge: the JAX package's T5, BART and LLaMA (Mixtral included)
param trees → this port's state_dicts.

The tree is given as nested dicts of numpy arrays (``jax.device_get`` of
the flax params), so this module needs neither JAX nor the JAX package.
Renames: BART's ``encoder_block_{i}`` → ``encoder_blocks.{i}`` (likewise
the decoder), LLaMA's ``block_{i}`` and T5's ``encoder``/``decoder``
``block_{i}`` → ``blocks.{i}``, embedding tables (T5's
``relative_attention_bias`` included) ``embedding`` → ``weight``,
LayerNorm/RMSNorm ``scale`` → ``weight``; a flax ``Dense`` kernel (in,
out) becomes ``Linear.weight`` (out, in).  BART's ``final_logits_bias`` is
carried across and its LM head needs no entry (tied to ``shared`` in both
packages), as a tied T5's; LLaMA's and flan-T5's untied ``lm_head`` is an
ordinary Dense.  A Mixtral block's ``mlp/router/kernel`` is a Dense kernel
like any other; its stacked ``mlp/gate_proj``, ``up_proj`` and
``down_proj`` leaves are no kernels and keep their (E, in, out) layout,
which ``ops/moe.MoEMLP`` shares.  A tensor-parallel LLaMA takes its
rank's shards of the tree (``tensor_shard_state``).
"""

from __future__ import annotations

import re
from typing import Any, Mapping

import numpy as np
import torch

from distributed_llms_example_tpu_torch.models.bart import BartForConditionalGeneration
from distributed_llms_example_tpu_torch.models.convert import load_state


def _flatten(tree: Mapping[str, Any], prefix: tuple = ()) -> dict[tuple, np.ndarray]:
    out: dict[tuple, np.ndarray] = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


def _state_dict_from_jax(params: Mapping[str, Any], block: str) -> dict[str, torch.Tensor]:
    sd: dict[str, torch.Tensor] = {}
    for path, arr in _flatten(params).items():
        parts = []
        for p in path:
            m = re.fullmatch(block, p)
            parts.append(f"{m.group(1)}blocks.{m.group(2)}" if m else p)
        leaf = parts[-1]
        if leaf == "kernel":
            arr = arr.T
        if leaf in ("kernel", "embedding", "scale"):
            parts[-1] = "weight"
        sd[".".join(parts)] = torch.tensor(np.asarray(arr, dtype=np.float32))
    return sd


def bart_state_dict_from_jax(params: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """Port-named fp32 tensors for every leaf of a JAX BART param tree."""
    return _state_dict_from_jax(params, r"((?:encoder|decoder)_)block_(\d+)")


def blocks_state_dict_from_jax(params: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """Port-named fp32 tensors for every leaf of a JAX LLaMA or T5 param
    tree (both number their layers ``block_{i}``)."""
    return _state_dict_from_jax(params, r"()block_(\d+)")


def tensor_shard_state(sd: Mapping[str, torch.Tensor], tensor: int,
                       index: int) -> dict[str, torch.Tensor]:
    """Tensor rank ``index``'s shards of a whole port state dict (the plan
    of ``parallel/sharding.py``; replicated leaves as they are)."""
    from distributed_llms_example_tpu_torch.parallel.sharding import shard_leaf, tensor_dim

    return {k: shard_leaf(v, tensor_dim(k), tensor, index) for k, v in sd.items()}


def load_jax_params(module: torch.nn.Module, params: Mapping[str, Any]) -> None:
    """Copy a JAX T5, BART or LLaMA param tree (by ``module``'s family) into
    ``module`` (strict: every port parameter must be covered and every JAX
    leaf used), casting each leaf to its parameter's dtype and device."""
    convert = (bart_state_dict_from_jax if isinstance(module, BartForConditionalGeneration)
               else blocks_state_dict_from_jax)
    load_state(module, convert(params), source="JAX tree")
