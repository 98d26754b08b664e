"""Sharded parameters over the ``fsdp`` mesh axis: FSDP2 (``fully_shard``)
on the port's models (the port's counterpart of the JAX package's
``parallel/sharding.py`` and its trainer's ``shard_params``).

``shard_model(model, mesh)`` makes every transformer block (LLaMA's
decoder layers, BART's and T5's encoder and decoder layers) one FSDP unit
and the model the root unit over what is left (embeddings, position
tables, final norms, the LM head).  Each parameter is cut along dim 0,
FSDP2's default, into as many row blocks as the ``fsdp`` axis has ranks
(``torch.chunk``'s blocks: the last ones may be short or empty).  The JAX
package's rule table picks other dimensions for some leaves; that is a
layout, not a result, and the math is the same.  With ``data`` > 1 too
the 2-D mesh makes it HSDP: shards within a ``data`` row, replicas across.

- No mixed-precision policy: the parameters stay fp32 sharded and
  gathered, and each ``Dense`` casts its gathered fp32 master to the
  compute dtype per call, as without sharding (and as the JAX package).
- Gradients are reduced as a SUM (divide factor 1): the train step's loss
  is a token-weighted sum, divided by the global token count in kernel 8's
  gradient pass, so FSDP's default mean would scale every gradient by one
  over the world.
- FSDP2 gathers a unit's parameters around its ``forward``.  The model
  methods that run instead of ``forward`` (``encode``, ``decode``,
  ``cross_kv``, ``hidden_states``, ``head_inputs``: the eval's generation,
  the serving engine, the vocab-chunked loss) are registered as forward
  methods, so the root's parameters are gathered around them too, and so
  is a decoder layer's ``project_kv`` (its cross-attention K/V, which
  ``cross_kv`` asks of every layer).
- Parameter names do not change (``named_parameters`` yields the same
  names, now of DTensors), so the decay mask, the health buckets and the
  checkpoint names stay as they are.
"""

from __future__ import annotations

from torch import nn

FORWARD_METHODS = ("encode", "decode", "cross_kv", "hidden_states", "head_inputs")
BLOCK_FORWARD_METHODS = ("project_kv",)  # a decoder layer's cross-attention K/V


def transformer_blocks(model: nn.Module) -> list[nn.Module]:
    """The model's transformer blocks: every entry of its ``ModuleList``s."""
    return [blk for m in model.modules() if isinstance(m, nn.ModuleList) for blk in m]


def shard_model(model: nn.Module, mesh) -> nn.Module:
    """Shard ``model`` in place over ``mesh``'s ``fsdp`` axis (HSDP on the
    2-D mesh when its ``data`` axis is above 1) and return it.  Any mesh
    is taken, one rank included; the trainer calls this only when
    ``fsdp`` > 1."""
    from torch.distributed.fsdp import fully_shard, register_fsdp_forward_method

    shard_mesh = mesh if mesh["data"].size() > 1 else mesh["fsdp"]
    blocks = transformer_blocks(model)
    for unit in [*blocks, model]:  # the blocks first: the root holds what they leave
        fully_shard(unit, mesh=shard_mesh)
        unit.set_gradient_divide_factor(1.0)
        unit.set_force_sum_reduction_for_comms(True)
    for unit, names in [*((b, BLOCK_FORWARD_METHODS) for b in blocks), (model, FORWARD_METHODS)]:
        for name in names:
            if hasattr(unit, name):
                register_fsdp_forward_method(unit, name)
    return model


def shard_rows(n: int, parts: int, index: int) -> tuple[int, int]:
    """Rows [lo, hi) of block ``index`` when ``n`` rows are cut into
    ``parts``: the dim-0 layout ``shard_model`` gives every parameter
    (``torch.chunk``'s blocks, as FSDP2 cuts: ceil(n / parts) rows each,
    the last ones short or empty)."""
    per = -(-n // parts) if n else 0
    lo = min(index * per, n)
    return lo, min(lo + per, n)


def local(t):
    """The rank's shard of a sharded (DTensor) tensor; a plain tensor
    itself."""
    return t.to_local() if hasattr(t, "to_local") else t
