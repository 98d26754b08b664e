"""T5 encoder-decoder in PyTorch (port of the JAX package's ``models/t5.py``,
everything but the pipelined training adapter, which waits for the
multi-GPU slice).

T5 v1.0 (relu FFN, LM head tied to ``shared`` and scaled by
``d_model**-0.5``) and v1.1 / flan (gated-gelu FFN, untied ``lm_head``):

- RMSNorm, pre-norm residual blocks, a final norm per stack;
- attention scores are **not** scaled (``scale=1`` on every path: T5
  folds 1/sqrt(d_kv) into its init);
- a learned relative-position bias, one bucket table per stack, computed
  once per stack and kept apart from the padding mask: uncached passes
  hand it to attention as ``learned_bias``, so the flash kernels take it
  through their learned-bias branch and kernel 4 computes its gradient;
  a cached decode step builds it per row from each slot's own offset and
  passes it as the constant ``bias`` of the decode kernel.

The compute dtype follows the JAX module: embeddings, projections and
logits in ``dtype``, RMSNorm statistics and softmax in fp32, the bucket
tables in fp32 with the bias rounded to ``dtype`` where the JAX module
rounds it.  Dropout sits at the JAX module's call sites: the stack input,
each sublayer's residual add (fused), the MLP's inner activation and
after the final norm; each call site owns its ``Dropout`` module.
``remat_policy`` checkpoints every block of both stacks in a pass that
records gradients (``utils/remat.py``).
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from distributed_llms_example_tpu_torch.models.bart import _Embed
from distributed_llms_example_tpu_torch.ops.attention import mask_to_bias
from distributed_llms_example_tpu_torch.ops.dense import Dense
from distributed_llms_example_tpu_torch.ops.fused_dropout import Dropout
from distributed_llms_example_tpu_torch.ops.mha import KVCache, MultiHeadAttention
from distributed_llms_example_tpu_torch.ops.norms import RMSNorm
from distributed_llms_example_tpu_torch.utils.remat import maybe_checkpointed


@dataclasses.dataclass(frozen=True)
class T5Config:
    vocab_size: int = 32128
    d_model: int = 512
    d_kv: int = 64
    d_ff: int = 2048
    num_layers: int = 6
    num_decoder_layers: Optional[int] = None
    num_heads: int = 8
    relative_attention_num_buckets: int = 32
    relative_attention_max_distance: int = 128
    dropout_rate: float = 0.1
    # attention-probs dropout in training: HF's T5 config has no field for
    # it, so only an explicit config sets it (the flash kernels' in-kernel
    # mask, kernel 4's branch included)
    attn_dropout_rate: float = 0.0
    layer_norm_epsilon: float = 1e-6
    feed_forward_proj: str = "relu"  # or "gated-gelu"
    tie_word_embeddings: bool = True
    pad_token_id: int = 0
    eos_token_id: int = 1
    decoder_start_token_id: int = 0
    attention_impl: str = "auto"  # "auto" | "flash" | "ring" | "xla" (see ops/mha.py)

    @property
    def decoder_layers(self) -> int:
        return self.num_decoder_layers if self.num_decoder_layers is not None else self.num_layers

    @property
    def is_gated(self) -> bool:
        return self.feed_forward_proj.startswith("gated")


@functools.lru_cache(maxsize=None)
def _distance_buckets(num_buckets: int, max_distance: int) -> torch.Tensor:
    """Bucket of each distance 0..max_distance within one direction's
    ``num_buckets``: exact below half of them, log-spaced above, computed
    in fp32 exactly as the JAX package's ``relative_position_bucket`` (the
    log of an fp32 ratio over the fp32 log of max_distance / max_exact,
    truncated).  Every distance past max_distance falls in the last
    bucket, so this table answers for all of them."""
    rel = torch.arange(max_distance + 1)
    max_exact = num_buckets // 2
    rel_f = torch.clamp(rel.float(), min=1.0)
    log_span = torch.log(torch.tensor(max_distance / max_exact, dtype=torch.float32))
    if_large = max_exact + (
        torch.log(rel_f / max_exact) / log_span * (num_buckets - max_exact)
    ).to(torch.int64)
    if_large = torch.clamp(if_large, max=num_buckets - 1)
    return torch.where(rel < max_exact, rel, if_large)


def relative_position_bucket(relative_position: torch.Tensor, *, bidirectional: bool,
                             num_buckets: int, max_distance: int) -> torch.Tensor:
    """T5's log-bucketed relative position (kv_pos − q_pos) → bucket id.

    The log-spaced buckets come from a table built once on the CPU in fp32
    (``_distance_buckets``), so every device gives the JAX package's ids:
    a one-ulp difference in a device's ``log`` would move a bucket
    boundary, and with it the parameter that gets a gradient."""
    rp = relative_position.long()
    if bidirectional:
        num_buckets //= 2
        ret = (rp > 0).long() * num_buckets
        rel = rp.abs()
    else:
        ret = torch.zeros_like(rp)
        rel = -torch.clamp(rp, max=0)
    table = _distance_buckets(num_buckets, max_distance).to(rp.device)
    return ret + table[torch.clamp(rel, max=max_distance)]


class _BucketLookup(torch.autograd.Function):
    """A bucket table's (q, kv, H) fp32 lookup by relative position, with a
    deterministic backward.  ``F.embedding``'s CUDA backward scatters the
    q·kv positions into the table's rows by atomics, so the table's
    gradient changes in its last bits from run to run.  Here the upstream
    gradient is summed along each diagonal of the (q, kv) grid first (one
    relative position, so one bucket), by a skewed view and a plain
    reduction, and the q + kv − 1 diagonal sums then go through a one-hot
    (diagonals × buckets) product: the same sums in a fixed order."""

    @staticmethod
    def forward(ctx, weight, buckets, diag_buckets):
        ctx.save_for_backward(diag_buckets)
        ctx.num_buckets = weight.shape[0]
        return F.embedding(buckets, weight)

    @staticmethod
    def backward(ctx, g):
        (diag_buckets,) = ctx.saved_tensors
        q, kv, h = g.shape
        # rows reversed and padded by q, then read with a row length one
        # shorter: row i lands shifted right by q - 1 - i, so column c holds
        # diagonal c (relative position c - (q - 1)) of every row
        x = F.pad(g.flip(0), (0, 0, 0, q))
        x = x.reshape(q * (kv + q), h)[: q * (kv + q - 1)].reshape(q, kv + q - 1, h)
        onehot = F.one_hot(diag_buckets, ctx.num_buckets).to(g.dtype)
        return onehot.t() @ x.sum(0), None, None


class T5Attention(MultiHeadAttention):
    """T5 attention: bias-free projections and unscaled scores (scale 1 on
    the kernel, decode and plain paths alike)."""

    def __init__(self, cfg: T5Config, *, causal: bool, **kw):
        super().__init__(cfg.num_heads, cfg.d_kv, cfg.d_model, use_bias=False, causal=causal,
                         attention_impl=cfg.attention_impl,
                         probs_dropout_rate=cfg.attn_dropout_rate, scale=1.0, **kw)


class T5MLP(nn.Module):
    """relu: wo(drop(relu(wi x))); gated-gelu: wo(drop(gelu_tanh(wi_0 x) ·
    wi_1 x))."""

    def __init__(self, cfg: T5Config, **kw):
        super().__init__()
        self.gated = cfg.is_gated
        if self.gated:
            self.wi_0 = Dense(cfg.d_model, cfg.d_ff, use_bias=False, **kw)
            self.wi_1 = Dense(cfg.d_model, cfg.d_ff, use_bias=False, **kw)
        else:
            self.wi = Dense(cfg.d_model, cfg.d_ff, use_bias=False, **kw)
        self.dropout = Dropout(cfg.dropout_rate)
        self.wo = Dense(cfg.d_ff, cfg.d_model, use_bias=False, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.gated:
            h = F.gelu(self.wi_0(x), approximate="tanh") * self.wi_1(x)
        else:
            h = F.relu(self.wi(x))
        return self.wo(self.dropout(h))


class T5Block(nn.Module):
    """Pre-norm self-attention (+ cross-attention in the decoder) + MLP,
    each added to the residual through its own fused dropout."""

    def __init__(self, cfg: T5Config, *, causal: bool, **kw):
        super().__init__()
        dtype, device = kw["dtype"], kw.get("device")
        eps = cfg.layer_norm_epsilon
        self.has_cross = causal
        self.self_attn_norm = RMSNorm(cfg.d_model, eps, dtype, device)
        self.self_attn = T5Attention(cfg, causal=causal, **kw)
        self.self_attn_dropout = Dropout(cfg.dropout_rate)
        if self.has_cross:
            self.cross_attn_norm = RMSNorm(cfg.d_model, eps, dtype, device)
            self.cross_attn = T5Attention(cfg, causal=False, **kw)
            self.cross_attn_dropout = Dropout(cfg.dropout_rate)
        self.mlp_norm = RMSNorm(cfg.d_model, eps, dtype, device)
        self.mlp = T5MLP(cfg, **kw)
        self.mlp_dropout = Dropout(cfg.dropout_rate)

    def forward(self, hidden, self_bias, encoder_hidden=None, cross_bias=None, *, pos_bias=None,
                cache: KVCache | None = None, cache_positions=None, cross_kv=None):
        h = self.self_attn(self.self_attn_norm(hidden), bias=self_bias, learned_bias=pos_bias,
                           cache=cache, cache_positions=cache_positions)
        hidden = self.self_attn_dropout(h, residual=hidden)
        if self.has_cross:
            h = self.cross_attn(self.cross_attn_norm(hidden), kv_hidden=encoder_hidden,
                                bias=cross_bias, cross_kv=cross_kv)
            hidden = self.cross_attn_dropout(h, residual=hidden)
        h = self.mlp(self.mlp_norm(hidden))
        return self.mlp_dropout(h, residual=hidden)

    def project_kv(self, encoder_hidden: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """This block's cross-attention K/V of the encoder output (a method of
        the block, so a sharded block gathers its weights around it)."""
        return self.cross_attn.project_kv(encoder_hidden)


class T5Stack(nn.Module):
    """The encoder (``causal=False``) or the decoder (causal self-attention
    + cross-attention), with its own bucket table."""

    def __init__(self, cfg: T5Config, *, causal: bool, remat_policy: str | None = None, **kw):
        super().__init__()
        dtype, device = kw["dtype"], kw.get("device")
        self.config, self.causal, self.dtype = cfg, causal, dtype
        self.remat_policy = remat_policy
        n = cfg.decoder_layers if causal else cfg.num_layers
        # fp32 table and lookup (flax nn.Embed(dtype=float32)); the bias is
        # rounded to the compute dtype after the lookup
        self.relative_attention_bias = _Embed(
            cfg.relative_attention_num_buckets, cfg.num_heads, dtype=torch.float32,
            param_dtype=torch.float32, device=device)
        self.input_dropout = Dropout(cfg.dropout_rate)
        self.blocks = nn.ModuleList(T5Block(cfg, causal=causal, **kw) for _ in range(n))
        self.final_norm = RMSNorm(cfg.d_model, cfg.layer_norm_epsilon, dtype, device)
        self.final_dropout = Dropout(cfg.dropout_rate)

    def position_bias(self, q_len: int, kv_len: int,
                      offset: int | torch.Tensor = 0) -> torch.Tensor:
        """(1, H, q_len, kv_len) relative-position bias in the compute
        dtype, contiguous; a (B,) ``offset`` gives the per-row (B, H, q_len,
        kv_len) form of a continuous-batching decode step, each slot's
        positions counted from its own offset."""
        cfg = self.config
        table = self.relative_attention_bias
        dev = table.weight.device
        off = torch.as_tensor(offset, device=dev).long()
        ar_q = torch.arange(q_len, device=dev)
        ar_k = torch.arange(kv_len, device=dev)
        bucket = functools.partial(
            relative_position_bucket, bidirectional=not self.causal,
            num_buckets=cfg.relative_attention_num_buckets,
            max_distance=cfg.relative_attention_max_distance)
        if off.dim() == 1:
            rel = ar_k[None, None, :] - (off[:, None, None] + ar_q[None, :, None])  # (B, q, kv)
            bias = table(bucket(rel)).permute(0, 3, 1, 2)  # (B, H, q, kv) fp32
        else:
            rel = ar_k[None, :] - (ar_q[:, None] + off)  # (q, kv)
            # the relative position of diagonal c of the (q, kv) grid
            diag = torch.arange(-(q_len - 1), kv_len, device=dev) - off
            bias = _BucketLookup.apply(table.weight, bucket(rel), bucket(diag))
            bias = bias.permute(2, 0, 1)[None]  # (1, H, q, kv) fp32
        return bias.to(self.dtype).contiguous()

    def forward(self, hidden, attention_mask=None, encoder_hidden=None, encoder_mask=None, *,
                cache: list[KVCache] | None = None, cache_offset: int | torch.Tensor = 0,
                cross_kv=None):
        """Uncached: the learned bias rides ``learned_bias`` beside the
        padding mask (causality is attention's job).  Cached (decoder
        only): one step against the full cache, the position bias of each
        row at its offset as the constant bias."""
        q_len = hidden.shape[1]
        pos_bias, cache_positions = None, None
        if cache is not None:
            if not self.causal:
                raise ValueError("only the decoder stack decodes with a cache")
            off = torch.as_tensor(cache_offset, device=hidden.device)
            cache_positions = (off if off.dim() == 1 else off.expand(hidden.shape[0]))
            cache_positions = cache_positions.to(torch.int32)
            self_bias = self.position_bias(q_len, cache[0].k.shape[2], offset=off)
        else:
            pos_bias = self.position_bias(q_len, q_len)
            self_bias = mask_to_bias(attention_mask) if attention_mask is not None else None
        cross_bias = mask_to_bias(encoder_mask) if encoder_mask is not None else None
        hidden = self.input_dropout(hidden)
        for i, blk in enumerate(self.blocks):
            hidden = maybe_checkpointed(
                self.remat_policy if cache is None else None, blk,
                hidden, self_bias, encoder_hidden, cross_bias, pos_bias=pos_bias,
                         cache=None if cache is None else cache[i],
                         cache_positions=cache_positions,
                         cross_kv=None if cross_kv is None else cross_kv[i])
        return self.final_dropout(self.final_norm(hidden))


class T5ForConditionalGeneration(nn.Module):
    """``dtype`` is the compute dtype; ``param_dtype`` the storage dtype of
    matmul weights and the shared embedding (``core/precision.param_dtype``);
    bucket tables and RMSNorm scales stay fp32.  Weights are uninitialized
    until ``init_weights`` or a ``load_state_dict``."""

    def __init__(self, config: T5Config, *, dtype: torch.dtype = torch.float32,
                 param_dtype: torch.dtype = torch.float32, device=None,
                 remat_policy: str | None = None):
        super().__init__()
        cfg = self.config = config
        self.dtype = dtype
        self.remat_policy = remat_policy
        kw = dict(dtype=dtype, param_dtype=param_dtype, device=device)
        self.shared = _Embed(cfg.vocab_size, cfg.d_model, **kw)
        self.encoder = T5Stack(cfg, causal=False, remat_policy=self.remat_policy, **kw)
        self.decoder = T5Stack(cfg, causal=True, remat_policy=self.remat_policy, **kw)
        if not cfg.tie_word_embeddings:
            self.lm_head = Dense(cfg.d_model, cfg.vocab_size, use_bias=False, **kw)

    @property
    def decoder_blocks(self) -> nn.ModuleList:
        """The decoder's blocks, named as BART's are: the serving engine and
        ``init_cache`` read the self- and cross-attention modules here."""
        return self.decoder.blocks

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """Random init from ``generator`` with the flax initializers'
        distributions: ``shared`` N(0, 1); each bucket table N(0, 1/H) (flax
        ``nn.Embed``'s default, fan-in = its H columns); every Dense kernel
        lecun-normal (a normal truncated at ±2σ of the underlying normal,
        scaled to std 1/sqrt(fan_in)); unit RMSNorm scales.  The generator
        must live on the parameters' device."""
        for name, p in self.named_parameters():
            if name == "shared.weight":
                p.normal_(0.0, 1.0, generator=generator)
            elif name.endswith("relative_attention_bias.weight"):
                p.normal_(0.0, p.shape[1] ** -0.5, generator=generator)
            elif p.dim() == 2:
                # inverse-CDF truncated normal in fp32, as jax.random.truncated_normal
                std = p.shape[1] ** -0.5 / 0.87962566103423978
                edge = math.erf(2.0 / math.sqrt(2.0))
                z = torch.empty(p.shape, dtype=torch.float32, device=p.device)
                z.uniform_(-edge, edge, generator=generator).erfinv_()
                p.copy_(z.mul_(std * math.sqrt(2.0)))
            else:
                p.fill_(1.0)

    def encode(self, input_ids: torch.Tensor, attention_mask: torch.Tensor | None = None):
        return self.encoder(self.shared(input_ids), attention_mask=attention_mask)

    def cross_kv(self, encoder_hidden: torch.Tensor) -> list[tuple[torch.Tensor, torch.Tensor]]:
        """Per-decoder-layer cross-attention K/V, projected once from the
        encoder output and threaded through every decode step."""
        return [blk.project_kv(encoder_hidden) for blk in self.decoder.blocks]

    def _logits(self, hidden: torch.Tensor) -> torch.Tensor:
        if self.config.tie_word_embeddings:
            hidden = hidden * (self.config.d_model ** -0.5)
            return hidden @ self.shared.weight.to(self.dtype).T
        return self.lm_head(hidden)

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
        """Decoder logits, with the signature of the BART port's ``decode``:
        with ``cache`` (one ``KVCache`` per layer) a cached step, a (B,)
        ``cache_offset`` putting each row at its own position."""
        hidden = self.shared(decoder_input_ids)
        hidden = self.decoder(
            hidden, None if cache is not None else decoder_attention_mask, encoder_hidden,
            encoder_mask, cache=cache, cache_offset=cache_offset, cross_kv=cross_kv,
        )
        return self._logits(hidden)

    def forward(self, input_ids, attention_mask=None, decoder_input_ids=None,
                decoder_attention_mask=None):
        enc = self.encode(input_ids, attention_mask)
        return self.decode(decoder_input_ids, enc, encoder_mask=attention_mask,
                           decoder_attention_mask=decoder_attention_mask)


def shift_right(labels: torch.Tensor, decoder_start_token_id: int, pad_token_id: int) -> torch.Tensor:
    """Teacher-forcing decoder inputs from labels (HF shift_tokens_right:
    -100 label positions become pad); the JAX package's ``shift_right``,
    which both seq2seq families use."""
    shifted = torch.roll(labels, 1, dims=-1)
    shifted[:, 0] = decoder_start_token_id
    return torch.where(shifted == -100, torch.full_like(shifted, pad_token_id), shifted)
