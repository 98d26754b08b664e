"""Decode-cache allocation and the causal prompt prefill (port of the parts
of the JAX package's ``evaluation/generation.py`` the serving engine needs).

The JAX package derives its cache tree from the decode program's shapes;
here the cache is explicit: one ``KVCache`` of zeroed (batch, kv heads,
max_len, head_dim) K and V buffers per self-attention layer, in the compute
dtype.  Static-batch greedy and beam search wait for the eval slice.
"""

from __future__ import annotations

import torch

from distributed_llms_example_tpu_torch.ops.mha import KVCache


def _zero_caches(attns, batch: int, max_len: int, device) -> list[KVCache]:
    out = []
    for attn in attns:
        shape = (batch, attn.kv_heads, max_len, attn.head_dim)
        out.append(KVCache(
            torch.zeros(shape, dtype=attn.dtype, device=device),
            torch.zeros(shape, dtype=attn.dtype, device=device),
        ))
    return out


def init_cache(model, batch: int, max_len: int, *, device: torch.device | str) -> list[KVCache]:
    """Zero decoder self-attention caches of a seq2seq model (BART or T5:
    both name their decoder layers ``decoder_blocks``) for a (batch,
    max_len) decode; the serving engine's max_len is the decode budget, as
    in the JAX package."""
    return _zero_caches((blk.self_attn for blk in model.decoder_blocks), batch, max_len, device)


def init_causal_cache(model, batch: int, max_len: int, *,
                      device: torch.device | str) -> list[KVCache]:
    """Zero self-attention caches of a decoder-only model, one per block."""
    return _zero_caches((blk.self_attn for blk in model.blocks), batch, max_len, device)


def causal_prefill(model, input_ids: torch.Tensor, attention_mask: torch.Tensor,
                   new_tokens: int):
    """One-pass prompt prefill for decoder-only decode (the JAX package's
    ``_causal_prefill``).

    Allocates caches for prompt + generation (width P + ``new_tokens``),
    runs the right-padded prompt through once (every row writes at cache
    slot 0 on), and returns ``(cache, full_mask, lengths, first_logits)``
    where ``first_logits`` are each row's logits at its last valid prompt
    position.  RoPE positions follow the true sequence (``cumsum(mask) −
    1`` clipped at 0), not the cache slot, and pad slots stay masked."""
    B, P = input_ids.shape
    dev = input_ids.device
    cache = init_causal_cache(model, B, P + new_tokens, device=dev)
    mask = attention_mask.to(torch.int32)
    full_mask = torch.cat([mask, torch.zeros((B, new_tokens), dtype=torch.int32, device=dev)], 1)
    lengths = mask.sum(dim=1, dtype=torch.int32)
    positions = (torch.cumsum(mask, dim=1) - 1).clamp(min=0)
    logits = model(input_ids, full_mask, positions=positions, cache=cache)
    last = (lengths.long() - 1).clamp(min=0)
    first = logits[torch.arange(B, device=dev), last]
    return cache, full_mask, lengths, first
