"""Kernel 5 (flash decode against a flat cache), checked without a GPU.

On the card kernel 5 is the flat instance of the decode template that it
shares with kernel 6 (``csrc/flash_decode.cuh``): a flat (B, H, L, d) cache
is read as a block pool with one block of L slots a batch row (N = B,
H_kv = H, block size L) behind the identity block table, which is what
keeps kernel 6 over the gathered view of the same blocks bit-equal to
kernel 5.  Here the plain versions, which the wrappers run for CPU tensors,
are held to that identity bit for bit.  ``flash_decode`` against the JAX
package's Pallas decode kernel is ``test_torch_flash_attention.py``'s."""

import numpy as np
import pytest
import torch

from distributed_llms_example_tpu.ops.attention import NEG_INF
from distributed_llms_example_tpu_torch.ops import flash_attention as tfa


def _inputs(rng, B, H, Q, L, d, *, bias: bool):
    q, k, v = (rng.randn(B, H, n, d).astype(np.float32) for n in (Q, L, L))
    offsets = np.array([0, L // 2 + 3, L - Q], np.int32)[:B]  # fresh, mid-decode, full
    pad = None
    if bias:
        pad = np.where(rng.rand(B, 1, 1, L) > 0.2, 0.0, NEG_INF).astype(np.float32)
    return q, k, v, offsets, pad


@pytest.mark.parametrize("kv", ["fp32", "bf16", "int8"])
@pytest.mark.parametrize("q_len", [1, 8])
@pytest.mark.parametrize("L", [128, 200])
@pytest.mark.parametrize("bias", [False, True])
def test_paged_over_the_identity_table_is_flat_decode(kv, q_len, L, bias):
    """A flat cache seen as a pool of B blocks of L slots through the
    identity block table: the gathered view is the cache itself, and paged
    decode equals flat decode bit for bit (bf16 and fp32 caches, an int8
    cache with its per-slot scales; Q = 1 and 8; L = 128, and 200, which no
    64-slot tile divides; with and without a padding bias)."""
    rng = np.random.RandomState(7 * q_len + L + bias)
    B, H, d = 3, 2, 32
    q, k, v, offsets, pad = _inputs(rng, B, H, q_len, L, d, bias=bias)
    dtype = torch.bfloat16 if kv == "bf16" else torch.float32
    q, k, v = (torch.from_numpy(x).to(dtype) for x in (q, k, v))
    scales = {}
    if kv == "int8":
        k, ks = tfa.quantize_kv(k)
        v, vs = tfa.quantize_kv(v)
        scales = dict(k_scale=ks, v_scale=vs)
    offsets = torch.from_numpy(offsets)
    pad = None if pad is None else torch.from_numpy(pad)
    table = torch.arange(B, dtype=torch.int32)[:, None]  # row b -> block b, one tile of L slots

    for pool in (k, v, *scales.values()):
        assert torch.equal(tfa.gather_blocks(pool, table), pool)
    flat = tfa.flash_decode(q, k, v, pad, offsets=offsets, **scales)
    paged = tfa.flash_decode_paged(q, k, v, pad, block_tables=table, offsets=offsets,
                                   k_scale_pool=scales.get("k_scale"),
                                   v_scale_pool=scales.get("v_scale"))
    assert paged.dtype == flat.dtype == dtype
    assert torch.equal(paged, flat)
    assert torch.isfinite(flat.float()).all()
