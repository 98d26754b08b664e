"""This port's modules → an HF checkpoint (the port's counterpart of the JAX
package's ``models/export.py``, the reverse of ``models/convert.py``).

The reference recipe ends with ``model.save_pretrained(output_dir)``;
``save_hf_checkpoint`` writes the same kind of directory: ``config.json``
(sorted keys) and ``model.safetensors``, or shards of at most
``MAX_SHARD_BYTES`` plus ``model.safetensors.index.json`` above that, the
file layout of the JAX package's export.  Tensors are fp32 under their HF
names, each tied embedding once under its canonical name (transformers
re-ties on load).  Files are written by ``io/safetensors.py`` (no
``safetensors`` package).  A sharded model (``parallel/fsdp.py``) is
gathered first, leaf by leaf, to process 0's host (``full_state_dict``).
"""

from __future__ import annotations

import json
import os
import re
from typing import Any, Mapping

import torch

from distributed_llms_example_tpu_torch.io.safetensors import save_file
from distributed_llms_example_tpu_torch.parallel.fsdp import shard_rows

# HF's default shard size, as in the JAX package's export
MAX_SHARD_BYTES = 5 * 1024**3

_T5_MLP_LAYER = {"encoder": 1, "decoder": 2}


def _t5_name(name: str) -> str:
    if name in ("shared.weight", "lm_head.weight"):  # lm_head only when untied
        return name
    m = re.fullmatch(r"(encoder|decoder)\.(final_norm|relative_attention_bias)\.weight", name)
    if m:
        stack, what = m.groups()
        if what == "final_norm":
            return f"{stack}.final_layer_norm.weight"
        return f"{stack}.block.0.layer.0.SelfAttention.relative_attention_bias.weight"
    m = re.fullmatch(r"(encoder|decoder)\.blocks\.(\d+)\.(.+)\.weight", name)
    if not m:
        raise ValueError(f"unrecognized T5 parameter: {name}")
    stack, i, rest = m.groups()
    base = f"{stack}.block.{i}.layer"
    m = re.fullmatch(r"(self_attn|cross_attn)\.([qkvo])_proj", rest)
    if m:
        sub = "0.SelfAttention" if m.group(1) == "self_attn" else "1.EncDecAttention"
        return f"{base}.{sub}.{m.group(2)}.weight"
    mlp = _T5_MLP_LAYER[stack]
    m = re.fullmatch(r"mlp\.(wi|wo|wi_0|wi_1)", rest)
    if m:
        return f"{base}.{mlp}.DenseReluDense.{m.group(1)}.weight"
    norms = {"self_attn_norm": 0, "cross_attn_norm": 1, "mlp_norm": mlp}
    if rest in norms:
        return f"{base}.{norms[rest]}.layer_norm.weight"
    raise ValueError(f"unrecognized T5 parameter: {name}")


_BART_SUB = {"self_attn": "self_attn", "cross_attn": "encoder_attn"}
_BART_PROJ = {"q_proj": "q_proj", "k_proj": "k_proj", "v_proj": "v_proj", "o_proj": "out_proj"}
_BART_NORM = {"self_attn_layer_norm": "self_attn_layer_norm",
              "cross_attn_layer_norm": "encoder_attn_layer_norm",
              "final_layer_norm": "final_layer_norm"}


def _bart_name(name: str) -> str:
    if name == "shared.weight":
        return "model.shared.weight"
    if name == "final_logits_bias":
        return name
    m = re.fullmatch(r"(encoder|decoder)_(embed_positions|layernorm_embedding)\.(weight|bias)",
                     name)
    if m:
        return f"model.{m.group(1)}.{m.group(2)}.{m.group(3)}"
    m = re.fullmatch(r"(encoder|decoder)_blocks\.(\d+)\.(.+)\.(weight|bias)", name)
    if not m:
        raise ValueError(f"unrecognized BART parameter: {name}")
    stack, i, rest, leaf = m.groups()
    base = f"model.{stack}.layers.{i}"
    m = re.fullmatch(r"(self_attn|cross_attn)\.([qkvo]_proj)", rest)
    if m:
        return f"{base}.{_BART_SUB[m.group(1)]}.{_BART_PROJ[m.group(2)]}.{leaf}"
    if rest in ("mlp.fc1", "mlp.fc2"):
        return f"{base}.{rest[4:]}.{leaf}"
    if rest in _BART_NORM:
        return f"{base}.{_BART_NORM[rest]}.{leaf}"
    raise ValueError(f"unrecognized BART parameter: {name}")


def _llama_name(name: str) -> str:
    fixed = {"embed_tokens.weight": "model.embed_tokens.weight",
             "final_norm.weight": "model.norm.weight", "lm_head.weight": "lm_head.weight"}
    if name in fixed:
        return fixed[name]
    m = re.fullmatch(r"blocks\.(\d+)\.(.+)", name)
    if not m:
        raise ValueError(f"unrecognized LLaMA parameter: {name}")
    i, rest = m.groups()
    norms = {"attn_norm.weight": "input_layernorm.weight",
             "mlp_norm.weight": "post_attention_layernorm.weight"}
    if rest in norms:
        return f"model.layers.{i}.{norms[rest]}"
    if re.fullmatch(r"(self_attn\.[qkvo]_proj|mlp\.(?:gate|up|down)_proj)\.weight", rest):
        return f"model.layers.{i}.{rest}"
    raise ValueError(f"unrecognized LLaMA parameter: {name}")


_NAMERS = {"t5": _t5_name, "bart": _bart_name, "llama": _llama_name}


def export_state_dict(family: str, state: Mapping[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """The port's state dict (a module's ``state_dict()``) of a T5, BART
    or LLaMA model → HF names (the JAX package's
    ``export_{t5,bart,llama}_state_dict`` in one), fp32 CPU tensors;
    BART's ``final_logits_bias`` as HF's (1, V)."""
    out = {}
    for name, t in state.items():
        hf = _NAMERS[family](name)
        t = t.detach().to("cpu", torch.float32)
        out[hf] = t.reshape(1, -1) if hf == "final_logits_bias" else t
    return out


def hf_config_dict(family: str, cfg: Any) -> dict:
    """The port's config dataclass → the HF ``config.json`` fields that
    ``transformers`` needs to rebuild the architecture (the fields
    ``models/registry.py`` reads back, so the round trip is exact); the
    JAX package's export writes the same dict."""
    if family == "t5":
        return {
            "model_type": "t5", "architectures": ["T5ForConditionalGeneration"],
            "is_encoder_decoder": True, "vocab_size": cfg.vocab_size, "d_model": cfg.d_model,
            "d_kv": cfg.d_kv, "d_ff": cfg.d_ff, "num_layers": cfg.num_layers,
            "num_decoder_layers": cfg.num_decoder_layers or cfg.num_layers,
            "num_heads": cfg.num_heads,
            "relative_attention_num_buckets": cfg.relative_attention_num_buckets,
            "relative_attention_max_distance": cfg.relative_attention_max_distance,
            "dropout_rate": cfg.dropout_rate, "layer_norm_epsilon": cfg.layer_norm_epsilon,
            "feed_forward_proj": cfg.feed_forward_proj,
            "tie_word_embeddings": cfg.tie_word_embeddings, "pad_token_id": cfg.pad_token_id,
            "eos_token_id": cfg.eos_token_id,
            "decoder_start_token_id": cfg.decoder_start_token_id,
        }
    if family == "bart":
        return {
            "model_type": "bart", "architectures": ["BartForConditionalGeneration"],
            "is_encoder_decoder": True, "vocab_size": cfg.vocab_size, "d_model": cfg.d_model,
            "encoder_layers": cfg.encoder_layers, "decoder_layers": cfg.decoder_layers,
            "encoder_attention_heads": cfg.encoder_attention_heads,
            "decoder_attention_heads": cfg.decoder_attention_heads,
            "encoder_ffn_dim": cfg.encoder_ffn_dim, "decoder_ffn_dim": cfg.decoder_ffn_dim,
            "max_position_embeddings": cfg.max_position_embeddings,
            "dropout": cfg.dropout_rate, "attention_dropout": cfg.attn_dropout_rate,
            "scale_embedding": cfg.scale_embedding, "pad_token_id": cfg.pad_token_id,
            "bos_token_id": cfg.bos_token_id, "eos_token_id": cfg.eos_token_id,
            "decoder_start_token_id": cfg.decoder_start_token_id,
            "forced_bos_token_id": cfg.forced_bos_token_id,
            "forced_eos_token_id": cfg.forced_eos_token_id,
        }
    if family == "llama":
        return {
            "model_type": "llama", "architectures": ["LlamaForCausalLM"],
            "vocab_size": cfg.vocab_size, "hidden_size": cfg.hidden_size,
            "intermediate_size": cfg.intermediate_size,
            "num_hidden_layers": cfg.num_hidden_layers,
            "num_attention_heads": cfg.num_attention_heads,
            "num_key_value_heads": cfg.num_key_value_heads or cfg.num_attention_heads,
            "max_position_embeddings": cfg.max_position_embeddings,
            "attention_dropout": cfg.attn_dropout_rate, "rms_norm_eps": cfg.rms_norm_eps,
            "rope_theta": cfg.rope_theta, "tie_word_embeddings": False,
            "pad_token_id": cfg.pad_token_id, "bos_token_id": cfg.bos_token_id,
            "eos_token_id": cfg.eos_token_id,
        }
    raise ValueError(f"no HF config export for family {family!r}")


def _gather_rows(t) -> torch.Tensor:
    """The whole of a DTensor sharded along dim 0 (FSDP2's placement; HSDP
    replicates it over the mesh's other dimension): every rank's block,
    padded to the first block's rows, all-gathered over the shard group
    into one tensor, the padding cut off.  The collective FSDP2 gathers
    with itself, on whatever backend the group has."""
    dim = next(i for i, p in enumerate(t.placements) if p.is_shard())
    group = t.device_mesh.get_group(dim)
    world, rows = group.size(), t.shape[0]
    local = t.to_local()
    per = shard_rows(rows, world, 0)[1]
    padded = local.new_zeros((per, *t.shape[1:]))
    padded[: local.shape[0]] = local
    out = local.new_empty((per * world, *t.shape[1:]))
    torch.distributed.all_gather_into_tensor(out, padded, group=group)
    return out[:rows]


def full_state_dict(model: torch.nn.Module) -> dict[str, torch.Tensor]:
    """``model.state_dict()`` with every sharded (DTensor) entry gathered
    whole, one at a time (every rank joins every gather), and kept on
    process 0's host only: the other ranks get no entry for it, so no rank
    but the writer ever holds the whole model."""
    from distributed_llms_example_tpu_torch.core.mesh import process_index

    out = {}
    for name, t in model.state_dict().items():
        if hasattr(t, "device_mesh"):
            full = _gather_rows(t.detach())
            if process_index() == 0:
                out[name] = full.cpu()
            del full
        else:
            out[name] = t
    return out


def save_hf_checkpoint(out_dir: str, family: str, cfg: Any,
                       state: Mapping[str, torch.Tensor]) -> None:
    """Write ``config.json`` and ``model.safetensors`` (sharded, with an
    index, above MAX_SHARD_BYTES) for the port's ``state`` to ``out_dir``.
    Tensors are exported one at a time, so the host holds at most one
    shard's fp32 copy beside the module."""
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "config.json"), "w") as f:
        json.dump(hf_config_dict(family, cfg), f, indent=2, sort_keys=True)
    names = {n: _NAMERS[family](n) for n in state}
    sizes = {n: state[n].numel() * 4 for n in state}
    total = sum(sizes.values())
    # size-based shards, in the state dict's order
    shards: list[list[str]] = [[]]
    size = 0
    for n in state:
        if size + sizes[n] > MAX_SHARD_BYTES and shards[-1]:
            shards.append([])
            size = 0
        shards[-1].append(n)
        size += sizes[n]
    meta = {"format": "pt"}
    if len(shards) == 1:
        save_file(export_state_dict(family, state), os.path.join(out_dir, "model.safetensors"),
                  metadata=meta)
        return
    weight_map: dict[str, str] = {}
    for k, shard in enumerate(shards, start=1):
        fname = f"model-{k:05d}-of-{len(shards):05d}.safetensors"
        save_file(export_state_dict(family, {n: state[n] for n in shard}),
                  os.path.join(out_dir, fname), metadata=meta)
        weight_map.update({names[n]: fname for n in shard})
    with open(os.path.join(out_dir, "model.safetensors.index.json"), "w") as f:
        json.dump({"metadata": {"total_size": total}, "weight_map": weight_map}, f, indent=2)
