"""BART seq2seq in PyTorch (port of the JAX package's ``models/bart.py``).

Post-layernorm residual blocks, learned positional embeddings with the +2
offset, optional sqrt(d) embedding scale, exact-GELU FFN, biased
projections, LM head tied to ``shared`` plus ``final_logits_bias``.  The
compute dtype follows the JAX module: embeddings, projections and the
logits run in ``dtype``; LayerNorm statistics and softmax in fp32.

Dropout sits where the JAX module puts it: after the embedding LayerNorm,
after the FFN activation, and on every sublayer output with the residual
add fused in (``ops/fused_dropout.Dropout(h, residual=r)`` == ``r +
dropout(h)``).  Each call site owns its ``Dropout`` module, so counting the
modules counts the calls.  In eval mode every one is ``residual + h``, the
expression serving always computed.  ``remat_policy`` checkpoints every
encoder and decoder layer of a pass that records gradients
(``utils/remat.py``).  The pipelined training adapter waits for the
multi-GPU slice.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from distributed_llms_example_tpu_torch.ops.attention import mask_to_bias
from distributed_llms_example_tpu_torch.ops.dense import Dense
from distributed_llms_example_tpu_torch.ops.fused_dropout import Dropout
from distributed_llms_example_tpu_torch.ops.mha import KVCache, MultiHeadAttention
from distributed_llms_example_tpu_torch.ops.norms import LayerNorm
from distributed_llms_example_tpu_torch.utils.remat import maybe_checkpointed


@dataclasses.dataclass(frozen=True)
class BartConfig:
    vocab_size: int = 50265
    d_model: int = 1024
    encoder_layers: int = 12
    decoder_layers: int = 12
    encoder_attention_heads: int = 16
    decoder_attention_heads: int = 16
    encoder_ffn_dim: int = 4096
    decoder_ffn_dim: int = 4096
    max_position_embeddings: int = 1024
    dropout_rate: float = 0.1
    attn_dropout_rate: float = 0.0
    scale_embedding: bool = False
    pad_token_id: int = 1
    bos_token_id: int = 0
    eos_token_id: int = 2
    decoder_start_token_id: int = 2
    forced_bos_token_id: Optional[int] = None
    forced_eos_token_id: Optional[int] = 2
    layer_norm_epsilon: float = 1e-5
    attention_impl: str = "auto"  # "auto" | "flash" | "xla" (see ops/mha.py)

    POSITION_OFFSET = 2  # HF BartLearnedPositionalEmbedding quirk

    @property
    def head_dim(self) -> int:
        return self.d_model // self.encoder_attention_heads

    @property
    def embed_scale(self) -> float:
        return self.d_model**0.5 if self.scale_embedding else 1.0


class _Embed(nn.Module):
    """flax ``nn.Embed(dtype=...)``: the table is cast to the compute dtype
    at lookup."""

    def __init__(self, num: int, dim: int, *, dtype, param_dtype, device=None):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(num, dim, dtype=param_dtype, device=device))

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return F.embedding(ids, self.weight).to(self.dtype)


class BartMLP(nn.Module):
    def __init__(self, ffn_dim: int, model_dim: int, dropout_rate: float, **kw):
        super().__init__()
        self.fc1 = Dense(model_dim, ffn_dim, **kw)
        self.dropout = Dropout(dropout_rate)
        self.fc2 = Dense(ffn_dim, model_dim, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(self.dropout(F.gelu(self.fc1(x), approximate="none")))


def _attn(cfg: BartConfig, heads: int, causal: bool, **kw) -> MultiHeadAttention:
    return MultiHeadAttention(heads, cfg.d_model // heads, cfg.d_model, use_bias=True,
                              causal=causal, attention_impl=cfg.attention_impl,
                              probs_dropout_rate=cfg.attn_dropout_rate, **kw)


class BartEncoderLayer(nn.Module):
    def __init__(self, cfg: BartConfig, **kw):
        super().__init__()
        dtype, device = kw["dtype"], kw.get("device")
        self.self_attn = _attn(cfg, cfg.encoder_attention_heads, False, **kw)
        self.self_attn_dropout = Dropout(cfg.dropout_rate)
        self.self_attn_layer_norm = LayerNorm(cfg.d_model, cfg.layer_norm_epsilon, dtype, device)
        self.mlp = BartMLP(cfg.encoder_ffn_dim, cfg.d_model, cfg.dropout_rate, **kw)
        self.mlp_dropout = Dropout(cfg.dropout_rate)
        self.final_layer_norm = LayerNorm(cfg.d_model, cfg.layer_norm_epsilon, dtype, device)

    def forward(self, hidden: torch.Tensor, bias: torch.Tensor | None) -> torch.Tensor:
        h = self.self_attn(hidden, bias=bias)
        hidden = self.self_attn_layer_norm(self.self_attn_dropout(h, residual=hidden))
        h = self.mlp(hidden)
        return self.final_layer_norm(self.mlp_dropout(h, residual=hidden))


class BartDecoderLayer(nn.Module):
    def __init__(self, cfg: BartConfig, **kw):
        super().__init__()
        dtype, device = kw["dtype"], kw.get("device")
        self.self_attn = _attn(cfg, cfg.decoder_attention_heads, True, **kw)
        self.self_attn_dropout = Dropout(cfg.dropout_rate)
        self.self_attn_layer_norm = LayerNorm(cfg.d_model, cfg.layer_norm_epsilon, dtype, device)
        self.cross_attn = _attn(cfg, cfg.decoder_attention_heads, False, **kw)
        self.cross_attn_dropout = Dropout(cfg.dropout_rate)
        self.cross_attn_layer_norm = LayerNorm(cfg.d_model, cfg.layer_norm_epsilon, dtype, device)
        self.mlp = BartMLP(cfg.decoder_ffn_dim, cfg.d_model, cfg.dropout_rate, **kw)
        self.mlp_dropout = Dropout(cfg.dropout_rate)
        self.final_layer_norm = LayerNorm(cfg.d_model, cfg.layer_norm_epsilon, dtype, device)

    def forward(self, hidden, self_bias, encoder_hidden, cross_bias, *,
                cache: KVCache | None = None, cache_positions=None, cross_kv=None):
        h = self.self_attn(hidden, bias=self_bias, cache=cache, cache_positions=cache_positions)
        hidden = self.self_attn_layer_norm(self.self_attn_dropout(h, residual=hidden))
        h = self.cross_attn(hidden, kv_hidden=encoder_hidden, bias=cross_bias, cross_kv=cross_kv)
        hidden = self.cross_attn_layer_norm(self.cross_attn_dropout(h, residual=hidden))
        h = self.mlp(hidden)
        return self.final_layer_norm(self.mlp_dropout(h, residual=hidden))

    def project_kv(self, encoder_hidden: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """This layer's cross-attention K/V of the encoder output (a method of
        the layer, so a sharded layer gathers its weights around it)."""
        return self.cross_attn.project_kv(encoder_hidden)


class BartForConditionalGeneration(nn.Module):
    """``dtype`` is the compute dtype; ``param_dtype`` the storage dtype of
    matmul weights and embeddings (``core/precision.param_dtype``).  Weights are
    uninitialized until ``init_weights`` or a ``load_state_dict``."""

    def __init__(self, config: BartConfig, *, dtype: torch.dtype = torch.float32,
                 param_dtype: torch.dtype = torch.float32, device=None,
                 remat_policy: str | None = None):
        super().__init__()
        cfg = self.config = config
        self.dtype = dtype
        self.remat_policy = remat_policy
        kw = dict(dtype=dtype, param_dtype=param_dtype, device=device)
        n_pos = cfg.max_position_embeddings + cfg.POSITION_OFFSET
        self.shared = _Embed(cfg.vocab_size, cfg.d_model, **kw)
        self.encoder_embed_positions = _Embed(n_pos, cfg.d_model, **kw)
        self.decoder_embed_positions = _Embed(n_pos, cfg.d_model, **kw)
        self.encoder_layernorm_embedding = LayerNorm(cfg.d_model, cfg.layer_norm_epsilon, dtype, device)
        self.decoder_layernorm_embedding = LayerNorm(cfg.d_model, cfg.layer_norm_epsilon, dtype, device)
        self.encoder_embed_dropout = Dropout(cfg.dropout_rate)
        self.decoder_embed_dropout = Dropout(cfg.dropout_rate)
        self.encoder_blocks = nn.ModuleList(BartEncoderLayer(cfg, **kw) for _ in range(cfg.encoder_layers))
        self.decoder_blocks = nn.ModuleList(BartDecoderLayer(cfg, **kw) for _ in range(cfg.decoder_layers))
        self.final_logits_bias = nn.Parameter(
            torch.zeros(cfg.vocab_size, dtype=torch.float32, device=device)
        )

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator, std: float = 0.02) -> None:
        """Random init from ``generator`` (HF BART's scheme: N(0, std)
        matmul weights and embeddings, zero biases, unit LayerNorms); the
        generator must live on the parameters' device."""
        for name, p in self.named_parameters():
            if name.endswith(".weight") and p.dim() == 2:
                p.normal_(0.0, std, generator=generator)
            elif name.endswith(".weight"):
                p.fill_(1.0)
            else:
                p.zero_()

    def encode(self, input_ids: torch.Tensor, attention_mask: torch.Tensor | None = None):
        cfg = self.config
        pos = torch.arange(input_ids.shape[1], device=input_ids.device) + cfg.POSITION_OFFSET
        hidden = self.shared(input_ids) * cfg.embed_scale + self.encoder_embed_positions(pos)[None]
        hidden = self.encoder_embed_dropout(self.encoder_layernorm_embedding(hidden))
        bias = mask_to_bias(attention_mask) if attention_mask is not None else None
        for blk in self.encoder_blocks:
            hidden = maybe_checkpointed(self.remat_policy, blk, hidden, bias)
        return hidden

    def cross_kv(self, encoder_hidden: torch.Tensor) -> list[tuple[torch.Tensor, torch.Tensor]]:
        """Per-decoder-layer cross-attention K/V, projected once from the
        encoder output and threaded through every decode step."""
        return [blk.project_kv(encoder_hidden) for blk in self.decoder_blocks]

    def decode(
        self,
        decoder_input_ids: torch.Tensor,
        encoder_hidden: torch.Tensor | None,
        encoder_mask: torch.Tensor | None = None,
        decoder_attention_mask: torch.Tensor | None = None,
        *,
        cache: list[KVCache] | None = None,
        cache_offset: int | torch.Tensor = 0,
        cross_kv=None,
    ) -> torch.Tensor:
        """Decoder logits.  With ``cache`` (one ``KVCache`` per layer) this is
        a cached step: a (B,) ``cache_offset`` puts each row at its own
        position (per-row position embeddings and cache writes — the
        continuous-batching form); an int offset is shared by all rows."""
        cfg = self.config
        B, q_len = decoder_input_ids.shape
        dev = decoder_input_ids.device
        ar = torch.arange(q_len, device=dev)
        off = torch.as_tensor(cache_offset, device=dev)
        if off.dim() == 1:
            pos_embed = self.decoder_embed_positions(off.long()[:, None] + ar[None, :] + cfg.POSITION_OFFSET)
        else:
            pos_embed = self.decoder_embed_positions(ar + off.long() + cfg.POSITION_OFFSET)[None]
        cache_positions = None
        if cache is not None:
            cache_positions = (off if off.dim() == 1 else off.expand(B)).to(torch.int32)
        hidden = self.shared(decoder_input_ids) * cfg.embed_scale + pos_embed
        hidden = self.decoder_embed_dropout(self.decoder_layernorm_embedding(hidden))
        # cached steps mask validity/causality inside attention; uncached
        # passes get causality inside attention and only the padding mask here
        self_bias = None
        if cache is None and decoder_attention_mask is not None:
            self_bias = mask_to_bias(decoder_attention_mask)
        cross_bias = mask_to_bias(encoder_mask) if encoder_mask is not None else None
        for i, blk in enumerate(self.decoder_blocks):
            hidden = maybe_checkpointed(
                self.remat_policy if cache is None else None, blk,
                hidden, self_bias, encoder_hidden, cross_bias,
                cache=None if cache is None else cache[i],
                cache_positions=cache_positions,
                cross_kv=None if cross_kv is None else cross_kv[i],
            )
        logits = hidden @ self.shared.weight.to(self.dtype).T
        return logits + self.final_logits_bias.to(logits.dtype)

    def forward(self, input_ids, attention_mask=None, decoder_input_ids=None,
                decoder_attention_mask=None):
        enc = self.encode(input_ids, attention_mask)
        return self.decode(decoder_input_ids, enc, encoder_mask=attention_mask,
                           decoder_attention_mask=decoder_attention_mask)

