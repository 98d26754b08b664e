"""Model registry: named configs + random init (port of the JAX package's
``models/registry.py`` for the T5, BART and dense LLaMA families).

A registry name resolves to a built-in config sized like the public
checkpoint, built on the target device and initialized there from a seeded
``torch.Generator`` (no weights ship with the repository; a 7B model never
passes through the CPU).  The seq2seq families (T5, BART) serve and train;
LLaMA serves.  Loading a local HF checkpoint directory and Mixtral wait for
later slices (ROADMAP.md).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any

import torch

from distributed_llms_example_tpu_torch.core.precision import param_dtype, resolve_device
from distributed_llms_example_tpu_torch.models.bart import BartConfig, BartForConditionalGeneration
from distributed_llms_example_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from distributed_llms_example_tpu_torch.models.t5 import T5Config, T5ForConditionalGeneration

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
) -> LoadedModel:
    """Resolve a registry name into a LoadedModel on ``device`` (CUDA unless
    ``"cpu"`` is asked for), with weights drawn from ``seed``.  ``train``
    builds it for training: fp32 master weights on every device and the
    module in training mode (dropout on); otherwise it is in eval mode.
    The seq2seq families (T5, BART) train; LLaMA serves only."""
    if attention_impl not in (None, "auto", "flash", "ring", "xla"):
        raise ValueError(
            f"attention_impl={attention_impl!r}: must be 'auto', 'flash', 'ring', or 'xla'"
        )
    if os.path.isdir(name_or_path):
        raise NotImplementedError(
            f"{name_or_path!r} is a local checkpoint directory: loading HF weights waits "
            "until a checkpoint directory is in the repository (ROADMAP.md)"
        )
    short = name_or_path.rsplit("/", 1)[-1]
    if short in T5_CONFIGS:
        family, cfg, cls = "t5", T5_CONFIGS[short], T5ForConditionalGeneration
    elif short in BART_CONFIGS:
        family, cfg, cls = "bart", BART_CONFIGS[short], BartForConditionalGeneration
    elif short in LLAMA_CONFIGS:
        family, cfg, cls = "llama", LLAMA_CONFIGS[short], LlamaForCausalLM
    else:
        for prefix, what in _LATER.items():
            if short.startswith(prefix):
                raise NotImplementedError(f"{short!r}: {what} is a later slice of the port (ROADMAP.md)")
        raise ValueError(f"unknown model {name_or_path!r}: not one of "
                         f"{sorted(T5_CONFIGS) + sorted(BART_CONFIGS) + sorted(LLAMA_CONFIGS)}")
    if train and family not in SEQ2SEQ:
        raise NotImplementedError(
            f"{short!r}: training a causal ({family}) model is a later slice of the port "
            "(ROADMAP.md)"
        )
    if attention_impl is not None:
        cfg = dataclasses.replace(cfg, attention_impl=attention_impl)
    dev = resolve_device(device)
    module = cls(cfg, dtype=dtype, param_dtype=param_dtype(dtype, dev, train=train), device=dev)
    module.train(train)
    lm = LoadedModel(family, cfg, module, is_seq2seq=family in SEQ2SEQ)
    lm.init_params(seed)
    return lm
