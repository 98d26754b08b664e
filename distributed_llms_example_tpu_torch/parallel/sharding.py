"""The tensor plan: which leaves of the port's LLaMA split over the
``tensor`` axis, and on which dimension (the port's counterpart of the
JAX package's ``parallel/sharding.py DEFAULT_RULES``).

The port's weights are PyTorch's (out, in), so:

- q/k/v_proj, gate_proj and up_proj are column-parallel: each tensor rank
  holds a dim-0 block (its heads, its slice of the MLP's width);
- o_proj and down_proj are row-parallel: a dim-1 block;
- everything else is replicated: the norms, and in this slice the
  embedding and the LM head (a vocab-parallel head needs a vocab-parallel
  loss, ROADMAP.md).

The JAX package replicates a dimension the axis does not divide
(``divisible_spec``) and then runs attention without its per-shard path;
the port refuses such a model instead (``check_tensor_plan``): the q
heads, the kv heads and the MLP's width must divide by ``tensor``.

``shard_tensor_parallel`` cuts a whole model in place into its rank's
shards and gives its attention modules their local head counts;
``shard_leaf`` and ``gather_leaf`` cut one whole leaf and join it back
(the checkpoint, the export and the weight bridge use them).  A serving
model takes the same cut, so its cache holds the rank's kv heads
(``serving/engine.py``).
"""

from __future__ import annotations

import re

import torch
from torch import nn

# (pattern over the port's parameter names, the dimension split over tensor)
TENSOR_RULES: tuple[tuple[str, int], ...] = (
    (r"self_attn\.(q|k|v)_proj\.weight$", 0),
    (r"self_attn\.o_proj\.weight$", 1),
    (r"mlp\.(gate_proj|up_proj)\.weight$", 0),
    (r"mlp\.down_proj\.weight$", 1),
)


def tensor_dim(name: str) -> int | None:
    """The dimension ``name`` splits on over ``tensor``, None for a
    replicated leaf."""
    for pattern, dim in TENSOR_RULES:
        if re.search(pattern, name):
            return dim
    return None


def check_tensor_plan(config, tensor: int) -> None:
    """Raise ValueError unless the LLaMA ``config``'s q heads, kv heads
    and MLP width all divide by ``tensor``."""
    heads = config.num_attention_heads
    kv = config.num_key_value_heads or heads
    sizes = {"attention heads": heads, "kv heads": kv,
             "intermediate_size": config.intermediate_size}
    bad = {k: v for k, v in sizes.items() if v % tensor}
    if bad:
        raise ValueError(f"tensor={tensor} does not divide {bad}: the port splits heads and "
                         "the MLP width evenly over the tensor axis (the JAX package "
                         "replicates a ragged dimension instead; ROADMAP.md item 6)")


def shard_leaf(t: torch.Tensor, dim: int | None, parts: int, index: int) -> torch.Tensor:
    """Block ``index`` of ``parts`` of whole leaf ``t`` along ``dim``
    (contiguous); a replicated leaf (``dim`` None) is ``t``."""
    if dim is None or parts == 1:
        return t
    if t.shape[dim] % parts:
        raise ValueError(f"a dimension of {t.shape[dim]} does not split into {parts}")
    return t.chunk(parts, dim=dim)[index].contiguous()


def gather_leaf(t: torch.Tensor, dim: int | None, group, parts: int) -> torch.Tensor:
    """The whole leaf from every tensor rank's block ``t`` (an all-gather
    over ``group``); a replicated leaf is ``t``."""
    if dim is None or group is None:
        return t
    blocks = [torch.empty_like(t) for _ in range(parts)]
    torch.distributed.all_gather(blocks, t.detach().contiguous(), group=group)
    return torch.cat(blocks, dim=dim)


@torch.no_grad()
def shard_tensor_parallel(model: nn.Module, tensor: int, index: int, *,
                          config=None) -> nn.Module:
    """Cut the whole LLaMA ``model`` (or one block of it, with its
    ``config``) in place into tensor rank ``index``'s shards of
    ``tensor``: each planned leaf becomes a new parameter holding its block
    (the whole one is freed), and every attention module counts its local
    heads.  Returns ``model``."""
    check_tensor_plan(config or model.config, tensor)
    for name, module in model.named_modules():
        for leaf, p in list(module.named_parameters(recurse=False)):
            dim = tensor_dim(f"{name}.{leaf}")
            if dim is not None:
                setattr(module, leaf, nn.Parameter(shard_leaf(p.detach(), dim, tensor, index),
                                                   requires_grad=p.requires_grad))
        if hasattr(module, "kv_heads") and hasattr(module, "num_heads"):
            module.num_heads //= tensor
            module.kv_heads //= tensor
    return model
