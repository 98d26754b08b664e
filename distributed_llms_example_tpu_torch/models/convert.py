"""HF checkpoint state dict → this port's state dict (the counterpart of
the JAX package's ``models/convert.py``, without its flax tree in between).

HF and the port both store a linear layer's weight as (out, in), so a
tensor keeps its layout and only its name changes; every value is widened
to fp32, as the JAX package's converter does.  Tied duplicates are dropped:
BART's ``lm_head`` and both stacks' ``embed_tokens`` (all ``shared``), T5's
``embed_tokens``.  A tied T5 has no ``lm_head`` of its own (its head is
``shared`` scaled by d_model^-½, ``models/t5.py``), so an ``lm_head.weight``
in a tied T5 checkpoint is the tied copy ``load_state`` drops; an untied
one (flan-T5, LLaMA) is an ordinary
parameter.  BART's ``final_logits_bias`` (1, V) becomes (V,).  The names
are those ``models/from_jax.py`` gives the JAX package's tree, so a
checkpoint loads to the same state dict through either package.
"""

from __future__ import annotations

import re
from typing import Callable, Mapping

import torch

_T5_PROJ = {"q": "q_proj", "k": "k_proj", "v": "v_proj", "o": "o_proj"}


def _t5_name(name: str) -> str | None:
    if name in ("shared.weight", "lm_head.weight"):
        return name
    m = re.fullmatch(r"(encoder|decoder)\.final_layer_norm\.weight", name)
    if m:
        return f"{m.group(1)}.final_norm.weight"
    if re.fullmatch(r"(encoder|decoder)\.embed_tokens\.weight", name):
        return None  # a duplicate of shared.weight
    m = re.fullmatch(r"(encoder|decoder)\.block\.(\d+)\.layer\.(\d)\.(SelfAttention|EncDecAttention|"
                     r"DenseReluDense|layer_norm)\.?(.*)", name)
    if not m:
        raise ValueError(f"unrecognized T5 parameter: {name}")
    stack, i, layer, kind, rest = m.groups()
    if kind == "SelfAttention" and rest == "relative_attention_bias.weight":
        return f"{stack}.relative_attention_bias.weight"
    base = f"{stack}.blocks.{i}"
    if kind in ("SelfAttention", "EncDecAttention"):
        sub = "self_attn" if kind == "SelfAttention" else "cross_attn"
        proj = rest.partition(".")[0]
        return f"{base}.{sub}.{_T5_PROJ[proj]}.weight"
    if kind == "DenseReluDense":
        return f"{base}.mlp.{rest.partition('.')[0]}.weight"
    # layer_norm: its sublayer follows from the stack's layout (encoder:
    # [self_attn, mlp]; decoder: [self_attn, cross_attn, mlp])
    sub = {"0": "self_attn_norm", "2": "mlp_norm"}.get(
        layer, "cross_attn_norm" if stack == "decoder" else "mlp_norm")
    return f"{base}.{sub}.weight"


_BART_SUB = {"self_attn": "self_attn", "encoder_attn": "cross_attn"}
_BART_PROJ = {"q_proj": "q_proj", "k_proj": "k_proj", "v_proj": "v_proj", "out_proj": "o_proj"}
_BART_NORM = {"self_attn_layer_norm": "self_attn_layer_norm",
              "encoder_attn_layer_norm": "cross_attn_layer_norm",
              "final_layer_norm": "final_layer_norm"}


def _bart_name(name: str) -> str | None:
    name = name.removeprefix("model.")
    if name in ("shared.weight", "final_logits_bias"):
        return name
    if name in ("encoder.embed_tokens.weight", "decoder.embed_tokens.weight", "lm_head.weight"):
        return None  # tied duplicates of shared.weight
    m = re.fullmatch(r"(encoder|decoder)\.(embed_positions|layernorm_embedding)\.(weight|bias)",
                     name)
    if m:
        return f"{m.group(1)}_{m.group(2)}.{m.group(3)}"
    m = re.fullmatch(r"(encoder|decoder)\.layers\.(\d+)\.(.+)", name)
    if not m:
        raise ValueError(f"unrecognized BART parameter: {name}")
    stack, i, rest = m.groups()
    base = f"{stack}_blocks.{i}"
    m = re.fullmatch(r"(self_attn|encoder_attn)\.(q_proj|k_proj|v_proj|out_proj)\.(weight|bias)",
                     rest)
    if m:
        return f"{base}.{_BART_SUB[m.group(1)]}.{_BART_PROJ[m.group(2)]}.{m.group(3)}"
    m = re.fullmatch(r"(fc1|fc2)\.(weight|bias)", rest)
    if m:
        return f"{base}.mlp.{m.group(1)}.{m.group(2)}"
    m = re.fullmatch(r"(self_attn_layer_norm|encoder_attn_layer_norm|final_layer_norm)\."
                     r"(weight|bias)", rest)
    if m:
        return f"{base}.{_BART_NORM[m.group(1)]}.{m.group(2)}"
    raise ValueError(f"unrecognized BART layer parameter: {name}")


def _llama_name(name: str) -> str | None:
    if name.endswith("rotary_emb.inv_freq"):
        return None  # a derived buffer
    fixed = {"model.embed_tokens.weight": "embed_tokens.weight",
             "model.norm.weight": "final_norm.weight", "lm_head.weight": "lm_head.weight"}
    if name in fixed:
        return fixed[name]
    m = re.fullmatch(r"model\.layers\.(\d+)\.(.+)", name)
    if not m:
        raise ValueError(f"unrecognized LLaMA parameter: {name}")
    i, rest = m.groups()
    m = re.fullmatch(r"(self_attn\.[qkvo]_proj|mlp\.(?:gate|up|down)_proj)\.weight", rest)
    if m:
        return f"blocks.{i}.{m.group(1)}.weight"
    norms = {"input_layernorm.weight": "attn_norm.weight",
             "post_attention_layernorm.weight": "mlp_norm.weight"}
    if rest in norms:
        return f"blocks.{i}.{norms[rest]}"
    if rest.startswith("block_sparse_moe."):
        raise NotImplementedError("Mixtral (routed MoE experts) is a later slice of the port "
                                  "(ROADMAP.md)")
    raise ValueError(f"unrecognized LLaMA layer parameter: {name}")


NAMERS: dict[str, Callable[[str], str | None]] = {
    "t5": _t5_name, "bart": _bart_name, "llama": _llama_name,
}


def convert_state_dict(family: str, state_dict: Mapping[str, torch.Tensor]
                       ) -> dict[str, torch.Tensor]:
    """HF ``{T5,Bart}ForConditionalGeneration`` / ``LlamaForCausalLM``
    state dict → the port's names, fp32, tied duplicates dropped."""
    if family not in NAMERS:
        raise ValueError(f"no converter for model family {family!r}; have {sorted(NAMERS)}")
    out: dict[str, torch.Tensor] = {}
    for name, t in state_dict.items():
        port = NAMERS[family](name)
        if port is None:
            continue
        t = t.detach().to("cpu", torch.float32)
        out[port] = t.reshape(-1) if port == "final_logits_bias" else t
    return out


def load_state(module: torch.nn.Module, state: Mapping[str, torch.Tensor], *, source: str) -> None:
    """Copy ``state`` (port names) into ``module``, strictly: every
    parameter covered and every tensor used, shapes equal, each tensor cast
    to its parameter's dtype and moved to its device.  A tied T5's
    checkpoint may carry ``lm_head.weight``, the tied copy of ``shared``:
    it is dropped when the module has no head of its own."""
    own = module.state_dict()
    state = {n: t for n, t in state.items() if n in own or n != "lm_head.weight"}
    missing = sorted(set(own) - set(state))
    extra = sorted(set(state) - set(own))
    if missing or extra:
        raise KeyError(f"{source} does not match the port: missing {missing}, unexpected {extra}")
    for name, t in state.items():
        if tuple(t.shape) != tuple(own[name].shape):
            raise ValueError(f"{name}: {source} shape {tuple(t.shape)} != port "
                             f"{tuple(own[name].shape)}")
    module.load_state_dict({n: t.to(own[n].dtype) for n, t in state.items()}, strict=True)
