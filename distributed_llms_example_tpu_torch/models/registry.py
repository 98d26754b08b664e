"""Model registry: named configs + random init, and local HF checkpoints
(port of the JAX package's ``models/registry.py`` for the T5, BART and
dense LLaMA families).

A registry name resolves to a built-in config sized like the public
checkpoint, built on the target device and initialized there from a seeded
``torch.Generator`` (no weights ship with the repository; a 7B model never
passes through the CPU).  A local directory holding an HF ``config.json``
(``model_type`` t5, bart or llama) and its weights (sharded
``model.safetensors.index.json`` or ``pytorch_model.bin.index.json`` first,
then one ``model.safetensors``, then ``pytorch_model.bin``) is read by the
port's own safetensors reader or ``torch.load``, converted
(``models/convert.py``) and copied into the module.  Every family serves
and trains (LLaMA as a causal LM, with the vocab-chunked loss under
``fused_ce``; every family with its blocks checkpointed under ``remat``).
Mixtral waits for a later slice (ROADMAP.md).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any

import torch

from distributed_llms_example_tpu_torch.core.precision import param_dtype, resolve_device
from distributed_llms_example_tpu_torch.io.safetensors import load_file
from distributed_llms_example_tpu_torch.models.bart import BartConfig, BartForConditionalGeneration
from distributed_llms_example_tpu_torch.models.convert import convert_state_dict, load_state
from distributed_llms_example_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from distributed_llms_example_tpu_torch.models.t5 import T5Config, T5ForConditionalGeneration
from distributed_llms_example_tpu_torch.utils.remat import REMAT_POLICIES

# Built-in configs sized like the public checkpoints (dims from the public
# HF config.json files, as in the JAX package; no weights are bundled).
T5_CONFIGS: dict[str, T5Config] = {
    "t5-test": T5Config(vocab_size=256, d_model=64, d_kv=16, d_ff=128, num_layers=2, num_heads=4),
    "t5-small": T5Config(d_model=512, d_kv=64, d_ff=2048, num_layers=6, num_heads=8),
    "t5-base": T5Config(d_model=768, d_kv=64, d_ff=3072, num_layers=12, num_heads=12),
    "t5-large": T5Config(d_model=1024, d_kv=64, d_ff=4096, num_layers=24, num_heads=16),
    "flan-t5-xl": T5Config(
        d_model=2048, d_kv=64, d_ff=5120, num_layers=24, num_heads=32,
        feed_forward_proj="gated-gelu", tie_word_embeddings=False,
    ),
}

BART_CONFIGS: dict[str, BartConfig] = {
    "bart-test": BartConfig(
        vocab_size=256, d_model=64, encoder_layers=2, decoder_layers=2,
        encoder_attention_heads=4, decoder_attention_heads=4,
        encoder_ffn_dim=128, decoder_ffn_dim=128, max_position_embeddings=128,
        forced_bos_token_id=0,
    ),
    "bart-base": BartConfig(
        d_model=768, encoder_layers=6, decoder_layers=6,
        encoder_attention_heads=12, decoder_attention_heads=12,
        encoder_ffn_dim=3072, decoder_ffn_dim=3072,
    ),
    # the reference's default model
    "bart-large-cnn": BartConfig(forced_bos_token_id=0),
    "bart-large": BartConfig(),
}

LLAMA_CONFIGS: dict[str, LlamaConfig] = {
    "llama-test": LlamaConfig(
        vocab_size=256, hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=128,
    ),
    "llama-test-4l": LlamaConfig(
        vocab_size=256, hidden_size=64, intermediate_size=128,
        num_hidden_layers=4, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=128,
    ),
    "llama-2-7b": LlamaConfig(),
    "llama-2-13b": LlamaConfig(
        hidden_size=5120, intermediate_size=13824, num_hidden_layers=40, num_attention_heads=40
    ),
}

_LATER = {
    "mixtral": "Mixtral (routed MoE experts)",
}
SEQ2SEQ = ("t5", "bart")


# ------------------------------------------------------- local HF checkpoints
# (the JAX package's registry.py:130-229, field for field)


def _t5_from_hf_config(cfg: dict) -> T5Config:
    return T5Config(
        vocab_size=cfg["vocab_size"],
        d_model=cfg["d_model"],
        d_kv=cfg["d_kv"],
        d_ff=cfg["d_ff"],
        num_layers=cfg["num_layers"],
        num_decoder_layers=cfg.get("num_decoder_layers"),
        num_heads=cfg["num_heads"],
        relative_attention_num_buckets=cfg.get("relative_attention_num_buckets", 32),
        relative_attention_max_distance=cfg.get("relative_attention_max_distance", 128),
        dropout_rate=cfg.get("dropout_rate", 0.1),
        layer_norm_epsilon=cfg.get("layer_norm_epsilon", 1e-6),
        feed_forward_proj=cfg.get("feed_forward_proj", "relu").replace("gated-gelu_new",
                                                                       "gated-gelu"),
        tie_word_embeddings=cfg.get("tie_word_embeddings", True),
        pad_token_id=cfg.get("pad_token_id", 0),
        eos_token_id=cfg.get("eos_token_id", 1),
        decoder_start_token_id=cfg.get("decoder_start_token_id", 0),
    )


def _bart_from_hf_config(cfg: dict) -> BartConfig:
    return BartConfig(
        vocab_size=cfg["vocab_size"],
        d_model=cfg["d_model"],
        encoder_layers=cfg["encoder_layers"],
        decoder_layers=cfg["decoder_layers"],
        encoder_attention_heads=cfg["encoder_attention_heads"],
        decoder_attention_heads=cfg["decoder_attention_heads"],
        encoder_ffn_dim=cfg["encoder_ffn_dim"],
        decoder_ffn_dim=cfg["decoder_ffn_dim"],
        max_position_embeddings=cfg.get("max_position_embeddings", 1024),
        dropout_rate=cfg.get("dropout", 0.1),
        # HF's attention-probs dropout (bart-large ships 0.0): the flash
        # kernels' in-kernel mask when a checkpoint sets it
        attn_dropout_rate=cfg.get("attention_dropout", 0.0),
        scale_embedding=cfg.get("scale_embedding", False),
        pad_token_id=cfg.get("pad_token_id", 1),
        bos_token_id=cfg.get("bos_token_id", 0),
        eos_token_id=cfg.get("eos_token_id", 2),
        decoder_start_token_id=cfg.get("decoder_start_token_id", 2),
        forced_bos_token_id=cfg.get("forced_bos_token_id"),
        forced_eos_token_id=cfg.get("forced_eos_token_id"),
    )


def _llama_from_hf_config(cfg: dict) -> LlamaConfig:
    return LlamaConfig(
        vocab_size=cfg["vocab_size"],
        hidden_size=cfg["hidden_size"],
        intermediate_size=cfg["intermediate_size"],
        num_hidden_layers=cfg["num_hidden_layers"],
        num_attention_heads=cfg["num_attention_heads"],
        num_key_value_heads=cfg.get("num_key_value_heads"),
        max_position_embeddings=cfg.get("max_position_embeddings", 4096),
        attn_dropout_rate=cfg.get("attention_dropout", 0.0),
        rms_norm_eps=cfg.get("rms_norm_eps", 1e-5),
        rope_theta=cfg.get("rope_theta", 10000.0),
        pad_token_id=cfg.get("pad_token_id") or 0,
        bos_token_id=cfg.get("bos_token_id", 1),
        eos_token_id=cfg.get("eos_token_id", 2),
    )


_HF_CONFIG_PARSERS = {
    "t5": _t5_from_hf_config,
    "bart": _bart_from_hf_config,
    "llama": _llama_from_hf_config,
}


def load_local_state_dict(path: str) -> dict[str, torch.Tensor]:
    """The HF state dict of a checkpoint directory, as CPU tensors in the
    files' dtypes: sharded layouts first (``model.safetensors.index.json``,
    then ``pytorch_model.bin.index.json``), then one ``model.safetensors``,
    then ``pytorch_model.bin`` (``torch.load(weights_only=True)``)."""
    for index_name, read in (("model.safetensors.index.json", load_file),
                             ("pytorch_model.bin.index.json", _load_bin)):
        index_path = os.path.join(path, index_name)
        if not os.path.exists(index_path):
            continue
        with open(index_path) as f:
            weight_map = json.load(f)["weight_map"]
        out: dict[str, torch.Tensor] = {}
        for shard in sorted(set(weight_map.values())):
            out.update(read(os.path.join(path, shard)))
        return out
    for name, read in (("model.safetensors", load_file), ("pytorch_model.bin", _load_bin)):
        if os.path.exists(os.path.join(path, name)):
            return dict(read(os.path.join(path, name)))
    raise FileNotFoundError(
        f"no model.safetensors(.index.json) or pytorch_model.bin(.index.json) under {path}"
    )


def _load_bin(path: str) -> dict[str, torch.Tensor]:
    return torch.load(path, map_location="cpu", weights_only=True)


def _local_config(path: str) -> tuple[str, Any]:
    """(family, config) of a checkpoint directory's ``config.json``."""
    with open(os.path.join(path, "config.json")) as f:
        hf_cfg = json.load(f)
    model_type = hf_cfg.get("model_type", "t5")
    for prefix, what in _LATER.items():
        if model_type.startswith(prefix):
            raise NotImplementedError(f"{path}: {what} is a later slice of the port (ROADMAP.md)")
    if model_type not in _HF_CONFIG_PARSERS:
        raise ValueError(f"unsupported model_type {model_type!r} at {path}")
    return model_type, _HF_CONFIG_PARSERS[model_type](hf_cfg)


_CLASSES = {"t5": T5ForConditionalGeneration, "bart": BartForConditionalGeneration,
            "llama": LlamaForCausalLM}


@dataclasses.dataclass
class LoadedModel:
    family: str
    config: Any
    module: T5ForConditionalGeneration | BartForConditionalGeneration | LlamaForCausalLM
    is_seq2seq: bool = True

    @property
    def device(self) -> torch.device:
        return next(self.module.parameters()).device

    def init_params(self, seed: int = 0) -> None:
        """(Re-)initialize the weights from ``seed`` on the module's device."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed(int(seed))
        self.module.init_weights(gen)


def load_model(
    name_or_path: str,
    *,
    dtype: torch.dtype = torch.float32,
    device: str | torch.device | None = None,
    attention_impl: str | None = None,
    seed: int = 0,
    train: bool = False,
    remat: bool = False,
    remat_policy: str = "full",
    fused_ce: bool = False,
) -> LoadedModel:
    """Resolve a registry name or a local HF checkpoint directory into a
    LoadedModel on ``device`` (CUDA unless ``"cpu"`` is asked for): a
    name's weights are drawn from ``seed``, a directory's are read from its
    files.  ``train`` builds it for training: fp32 master weights on every
    device, whatever dtype the files hold, and the module in training mode
    (dropout on); otherwise it is in eval mode.  ``remat`` checkpoints the
    blocks under ``remat_policy`` (``utils/remat.py``, any family);
    ``fused_ce`` sets a causal config's vocab-chunked loss and is refused
    for a seq2seq family, as the JAX trainer refuses it."""
    if attention_impl not in (None, "auto", "flash", "ring", "xla"):
        raise ValueError(
            f"attention_impl={attention_impl!r}: must be 'auto', 'flash', 'ring', or 'xla'"
        )
    if remat_policy not in REMAT_POLICIES:
        raise ValueError(f"remat_policy={remat_policy!r}: must be one of {list(REMAT_POLICIES)}")
    short = name_or_path.rsplit("/", 1)[-1]
    local = os.path.isdir(name_or_path)
    if local:
        family, cfg = _local_config(name_or_path)
    elif short in T5_CONFIGS:
        family, cfg = "t5", T5_CONFIGS[short]
    elif short in BART_CONFIGS:
        family, cfg = "bart", BART_CONFIGS[short]
    elif short in LLAMA_CONFIGS:
        family, cfg = "llama", LLAMA_CONFIGS[short]
    else:
        for prefix, what in _LATER.items():
            if short.startswith(prefix):
                raise NotImplementedError(f"{short!r}: {what} is a later slice of the port (ROADMAP.md)")
        raise ValueError(f"unknown model {name_or_path!r}: not one of "
                         f"{sorted(T5_CONFIGS) + sorted(BART_CONFIGS) + sorted(LLAMA_CONFIGS)}")
    if fused_ce:
        if family in SEQ2SEQ:
            raise ValueError("--fused-ce supports causal (decoder-only) families; seq2seq "
                             f"models ({short!r} is {family}) compute their loss from decoder "
                             "logits directly")
        cfg = dataclasses.replace(cfg, fused_ce=True)
    if attention_impl is not None:
        cfg = dataclasses.replace(cfg, attention_impl=attention_impl)
    dev = resolve_device(device)
    module = _CLASSES[family](cfg, dtype=dtype, param_dtype=param_dtype(dtype, dev, train=train),
                              device=dev, remat_policy=remat_policy if remat else None)
    module.train(train)
    lm = LoadedModel(family, cfg, module, is_seq2seq=family in SEQ2SEQ)
    if local:
        load_state(module, convert_state_dict(family, load_local_state_dict(name_or_path)),
                   source=name_or_path)
    else:
        lm.init_params(seed)
    return lm
