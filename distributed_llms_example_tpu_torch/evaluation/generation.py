"""Decode-cache allocation for seq2seq generation (port of the part of the
JAX package's ``evaluation/generation.py`` the serving engine needs).

The JAX package derives its cache tree from the decode program's shapes;
here the cache is explicit: one ``KVCache`` of zeroed (batch, heads,
max_len, head_dim) K and V buffers per decoder layer, in the compute
dtype.  Static-batch greedy and beam search wait for the eval slice.
"""

from __future__ import annotations

import torch

from distributed_llms_example_tpu_torch.ops.mha import KVCache


def init_cache(model, batch: int, max_len: int, *, device: torch.device | str) -> list[KVCache]:
    """Zero decoder self-attention caches for a (batch, max_len) decode."""
    out = []
    for blk in model.decoder_blocks:
        attn = blk.self_attn
        shape = (batch, attn.num_heads, max_len, attn.head_dim)
        out.append(KVCache(
            torch.zeros(shape, dtype=attn.dtype, device=device),
            torch.zeros(shape, dtype=attn.dtype, device=device),
        ))
    return out
