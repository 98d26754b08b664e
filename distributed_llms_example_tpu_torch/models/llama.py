"""LLaMA-family causal LM in PyTorch (port of the JAX package's
``models/llama.py``, the dense decoder stack).

Pre-RMSNorm residual blocks, rotary position embeddings in the HF
half-rotation layout, SwiGLU MLP, bias-free projections, optional
grouped-query attention, untied LM head.  The compute dtype follows the
JAX module: embeddings, projections and logits in ``dtype``; RMSNorm
statistics and softmax in fp32.  The causal mask lives inside attention;
the model passes only the padding mask as a bias.

LLaMA's dropout rates default to 0 (HF configs carry none), so the
residual adds are plain; a ``dropout_rate`` above 0 puts the fused
residual dropout (``ops/fused_dropout.Dropout``, kernel 7 on CUDA) at the
JAX module's two sites, after attention and after the MLP.
``hidden_states`` is the final norm's output without the LM head, the
input of the vocab-chunked loss (``ops/blockwise_ce.py``);
``remat_policy`` checkpoints every block in training (``utils/remat.py``).

With ``num_experts > 0`` (Mixtral) each block's MLP is the routed
``ops/moe.MoEMLP``: a cached pass (prefill, decode, verify, a warm chunk)
routes with no capacity limit, an uncached one (training, teacher-forced
scoring) keeps the capacity-factor trade, as in the JAX module.  Each MoE
layer's load-balancing loss is a return value: ``forward``,
``hidden_states`` and ``head_inputs`` hand the mean over layers to a
caller that asks with ``return_aux=True`` (the train step), and everyone
else never sees it, as the JAX package's generation discards its sown
losses.  The pipelined training adapter is a later slice (ROADMAP.md).

Tensor and sequence parallelism (the dense family; ``parallel/
sharding.py`` and ``parallel/activation.py``): the blocks take the tensor
plan (q/k/v, gate and up column-parallel, o and down row-parallel, norms,
the embedding and the LM head replicated), and a sequence-sharded pass
gets its shard's global ``positions`` (RoPE; ring attention's causal mask
derives them from the ring) and its K/V block's padding mask.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from distributed_llms_example_tpu_torch.models.bart import _Embed
from distributed_llms_example_tpu_torch.ops.attention import mask_to_bias
from distributed_llms_example_tpu_torch.ops.dense import Dense
from distributed_llms_example_tpu_torch.ops.fused_dropout import Dropout
from distributed_llms_example_tpu_torch.ops.mha import MultiHeadAttention
from distributed_llms_example_tpu_torch.ops.moe import MoEMLP
from distributed_llms_example_tpu_torch.ops.norms import RMSNorm
from distributed_llms_example_tpu_torch.parallel.activation import (
    copy_to_tensor,
    reduce_from_tensor,
)
from distributed_llms_example_tpu_torch.utils.remat import maybe_checkpointed


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: Optional[int] = None  # None → MHA
    max_position_embeddings: int = 4096
    rms_norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    pad_token_id: int = 0
    bos_token_id: int = 1
    eos_token_id: int = 2
    attention_impl: str = "auto"  # "auto" | "flash" | "ring" | "xla" (see ops/mha.py)
    fused_ce: bool = False
    num_experts: int = 0  # Mixture-of-experts (Mixtral-class): 0 = dense MLP
    num_experts_per_tok: int = 2
    moe_capacity_factor: float = 1.25
    moe_aux_weight: float = 0.0
    dropout_rate: float = 0.0
    attn_dropout_rate: float = 0.0

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def decoder_start_token_id(self) -> int:
        return self.bos_token_id


class LlamaMLP(nn.Module):
    """SwiGLU: down(silu(gate(x)) * up(x)).  Under ``tensor``
    (``parallel``) gate and up are column-parallel and down row-parallel:
    the input crosses the tensor group by ``copy_to_tensor``, the partial
    output by ``reduce_from_tensor``."""

    def __init__(self, cfg: LlamaConfig, **kw):
        super().__init__()
        self.gate_proj = Dense(cfg.hidden_size, cfg.intermediate_size, use_bias=False, **kw)
        self.up_proj = Dense(cfg.hidden_size, cfg.intermediate_size, use_bias=False, **kw)
        self.down_proj = Dense(cfg.intermediate_size, cfg.hidden_size, use_bias=False, **kw)
        self.parallel = None  # parallel/activation.attach

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        group = self.parallel.tensor_group if self.parallel is not None else None
        x = copy_to_tensor(x, group)
        return reduce_from_tensor(self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x)),
                                  group)


class LlamaBlock(nn.Module):
    def __init__(self, cfg: LlamaConfig, **kw):
        super().__init__()
        dtype, device = kw["dtype"], kw.get("device")
        self.attn_norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, dtype, device)
        self.self_attn = MultiHeadAttention(
            cfg.num_attention_heads, cfg.head_dim, cfg.hidden_size,
            num_kv_heads=cfg.num_key_value_heads, use_bias=False, causal=True,
            use_rope=True, rope_theta=cfg.rope_theta, attention_impl=cfg.attention_impl,
            probs_dropout_rate=cfg.attn_dropout_rate, **kw,
        )
        self.attn_dropout = Dropout(cfg.dropout_rate)
        self.mlp_norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, dtype, device)
        self.moe = cfg.num_experts > 0
        if self.moe:
            self.mlp = MoEMLP(cfg.hidden_size, cfg.intermediate_size, cfg.num_experts,
                              top_k=cfg.num_experts_per_tok,
                              capacity_factor=cfg.moe_capacity_factor, **kw)
        else:
            self.mlp = LlamaMLP(cfg, **kw)
        self.mlp_dropout = Dropout(cfg.dropout_rate)

    def forward(self, hidden, bias=None, *, positions=None, cache=None, cache_positions=None):
        """The block's output; a MoE block's as (output, its aux loss)."""
        h = self.self_attn(
            self.attn_norm(hidden), bias=bias, cache=cache, cache_positions=cache_positions,
            positions=positions,
        )
        hidden = self.attn_dropout(h, residual=hidden)
        if self.moe:
            # a cached pass is inference: no token drops (exact HF behavior)
            m, aux = self.mlp(self.mlp_norm(hidden), no_drop=cache is not None)
            return self.mlp_dropout(m, residual=hidden), aux
        return self.mlp_dropout(self.mlp(self.mlp_norm(hidden)), residual=hidden)


class LlamaForCausalLM(nn.Module):
    """``dtype`` is the compute dtype; ``param_dtype`` the storage dtype of
    matmul weights and embeddings (``core/precision.param_dtype``).  Weights
    are uninitialized until ``init_weights`` or a ``load_state_dict``.
    ``remat_policy`` (``"full"`` or ``"dots"``; None: off) checkpoints
    every block of a pass that records gradients."""

    def __init__(self, config: LlamaConfig, *, dtype: torch.dtype = torch.float32,
                 param_dtype: torch.dtype = torch.float32, device=None,
                 remat_policy: str | None = None):
        super().__init__()
        cfg = self.config = config
        self.dtype = dtype
        self.remat_policy = remat_policy
        kw = dict(dtype=dtype, param_dtype=param_dtype, device=device)
        self.embed_tokens = _Embed(cfg.vocab_size, cfg.hidden_size, **kw)
        self.blocks = nn.ModuleList(LlamaBlock(cfg, **kw) for _ in range(cfg.num_hidden_layers))
        self.final_norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, dtype, device)
        self.lm_head = Dense(cfg.hidden_size, cfg.vocab_size, use_bias=False, **kw)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator, std: float = 0.02) -> None:
        """Random init from ``generator`` (N(0, std) matmul weights, stacked
        expert weights and embeddings, unit RMSNorm scales); the generator
        must live on the parameters' device."""
        for name, p in self.named_parameters():
            if p.dim() >= 2:
                p.normal_(0.0, std, generator=generator)
            else:
                p.fill_(1.0)

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor | None = None, *,
                positions: torch.Tensor | None = None, cache=None,
                cache_positions: torch.Tensor | None = None, return_aux: bool = False):
        """Logits (B, S, vocab), and with ``return_aux`` the mean of the MoE
        layers' aux losses beside them (0 for a dense model).  ``cache``
        (one ``KVCache`` or ``PagedKVCache`` per block) makes this a cached
        pass: a prompt prefill (no ``cache_positions``: every row writes at
        the cache's shared index) or a decode step (per-row
        ``cache_positions``).  ``positions`` are the RoPE positions;
        ``attention_mask`` covers every key the pass attends (the whole
        cache width when cached)."""
        if cache is not None:
            hidden = self.embed_tokens(input_ids)
            bias = mask_to_bias(attention_mask) if attention_mask is not None else None
            auxes = []
            for blk, c in zip(self.blocks, cache):
                hidden = blk(hidden, bias, positions=positions, cache=c,
                             cache_positions=cache_positions)
                if blk.moe:
                    hidden, aux = hidden
                    auxes.append(aux)
            logits = self.lm_head(self.final_norm(hidden))
            return (logits, _mean_aux(auxes, logits)) if return_aux else logits
        h, aux = self._hidden_states(input_ids, attention_mask, positions)
        logits = self.lm_head(h)
        return (logits, aux) if return_aux else logits

    def hidden_states(self, input_ids: torch.Tensor, attention_mask: torch.Tensor | None = None,
                      *, positions: torch.Tensor | None = None, return_aux: bool = False):
        """The final norm's output of an uncached pass, without the LM head
        (and the mean aux loss with ``return_aux``).  Each block is
        checkpointed under ``remat_policy`` when autograd records."""
        h, aux = self._hidden_states(input_ids, attention_mask, positions)
        return (h, aux) if return_aux else h

    def head_inputs(self, input_ids: torch.Tensor, attention_mask: torch.Tensor | None = None,
                    *, return_aux: bool = False) -> tuple[torch.Tensor, ...]:
        """(the final hidden states, the LM head's weight cast to their
        dtype as the head casts it), and the mean aux loss with
        ``return_aux``: what the vocab-chunked loss
        (``ops/blockwise_ce.py``) consumes, from one method, so a sharded
        model (``parallel/fsdp.py``) gathers the head around it."""
        h, aux = self._hidden_states(input_ids, attention_mask, None)
        w = self.lm_head.weight.to(h.dtype)
        return (h, w, aux) if return_aux else (h, w)

    def _hidden_states(self, input_ids, attention_mask, positions):
        hidden = self.embed_tokens(input_ids)
        bias = mask_to_bias(attention_mask) if attention_mask is not None else None
        auxes = []
        for blk in self.blocks:
            hidden = maybe_checkpointed(self.remat_policy, blk, hidden, bias, positions=positions)
            if blk.moe:
                hidden, aux = hidden
                auxes.append(aux)
        h = self.final_norm(hidden)
        return h, _mean_aux(auxes, h)


def _mean_aux(auxes: list, like: torch.Tensor) -> torch.Tensor:
    """The mean over the MoE layers of their aux losses (the JAX train
    step's mean of the sown values, which keeps the coefficient comparable
    to HF Mixtral's one all-layer loss); an fp32 0 without MoE layers."""
    if not auxes:
        return torch.zeros((), dtype=torch.float32, device=like.device)
    return torch.stack(auxes).sum() / len(auxes)
