"""The port's paged-pool allocator and device-side moves against the JAX
package's ``serving/cache_pool.py``: the same alloc/free sequence hands
out the same block ids; ``blocks_needed`` and ``build_block_row`` agree
over a grid; ``gather_cache``, ``scatter_step`` and ``scatter_admit`` give
the same pools on the same numpy inputs.  All exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llms_example_tpu.serving import cache_pool as jcp
from distributed_llms_example_tpu_torch.serving import cache_pool as tcp


def test_alloc_free_sequence_matches_jax():
    rng = np.random.RandomState(0)
    jp, tp = jcp.CachePool(37, 8), tcp.CachePool(37, 8)
    held: list[list[int]] = []
    for _ in range(400):
        if held and rng.rand() < 0.45:
            grant = held.pop(rng.randint(len(held)))
            jp.free(grant)
            tp.free(grant)
        else:
            n = int(rng.randint(1, 9))
            assert jp.can_alloc(n) == tp.can_alloc(n)
            g_j, g_t = jp.alloc(n), tp.alloc(n)
            assert g_j == g_t
            if g_t is not None:
                held.append(g_t)
        assert (tp.blocks_free, tp.blocks_in_use) == (jp.blocks_free, jp.blocks_in_use)
        assert tp.blocks_free + tp.blocks_in_use == tp.num_blocks == 37
    with pytest.raises(ValueError, match="not allocated"):
        tp.free([held[0][0], held[0][0]] if held else [99])


def test_blocks_needed_and_block_row_match_jax():
    for bs in (8, 16, 128):
        for bucket in (bs, 2 * bs, 4 * bs):
            for plen in (1, bs - 1, bs, bs + 1, bucket):
                if plen > bucket:
                    continue
                for budget in (1, bs, 2 * bs + 3):
                    n = jcp.blocks_needed(plen, budget, bs)
                    assert tcp.blocks_needed(plen, budget, bs) == n
                    n_tiles = bucket // bs + -(-budget // bs) + 1
                    blocks = list(range(100, 100 + n))
                    kw = dict(prompt_len=plen, bucket_width=bucket, budget=budget,
                              block_size=bs, sentinel=999)
                    np.testing.assert_array_equal(
                        tcp.build_block_row(n_tiles, blocks, **kw),
                        jcp.build_block_row(n_tiles, blocks, **kw))
    with pytest.raises(ValueError, match="multiple of the block size"):
        tcp.build_block_row(6, [1, 2], prompt_len=3, bucket_width=20, budget=4, block_size=8,
                            sentinel=99)


def _trees(rng, N=7, H=2, bs=4, D=3):
    """A K leaf and an int8-scale-like 3-D leaf, as numpy, JAX and torch."""
    k = rng.randn(N, H, bs, D).astype(np.float32)
    s = rng.rand(N, H, bs).astype(np.float32)
    j = {"k": jnp.asarray(k), "s": jnp.asarray(s)}
    t = {"k": torch.from_numpy(k.copy()), "s": torch.from_numpy(s.copy())}
    return j, t


def _same(t_tree, j_tree):
    for name in j_tree:
        np.testing.assert_array_equal(t_tree[name].numpy(), np.asarray(j_tree[name]))


def test_gather_scatter_step_scatter_admit_match_jax():
    rng = np.random.RandomState(1)
    N, H, bs, D, nt, S = 7, 2, 4, 3, 3, 3
    j_pool, t_pool = _trees(rng, N, H, bs, D)
    # row 0: tiles 0, 1 → blocks 4, 0; row 1: tile 0 → block 2, rest
    # sentinel; row 2: all sentinel (an idle slot)
    bt = np.array([[4, 0, N], [2, N, N], [N, N, N]], np.int32)
    _same(tcp.gather_cache(t_pool, torch.from_numpy(bt)), jcp.gather_cache(j_pool, jnp.asarray(bt)))

    # admission of a 2-row chunk of width 2 tiles: row 0's tiles → 5, 1;
    # row 1's second tile stays a sentinel (the prompt gap)
    chunk_k = rng.randn(2, H, 2 * bs, D).astype(np.float32)
    chunk_s = rng.rand(2, H, 2 * bs).astype(np.float32)
    admit = np.array([5, 1, 3, N], np.int32)
    j_pool = jcp.scatter_admit(j_pool, {"k": jnp.asarray(chunk_k), "s": jnp.asarray(chunk_s)},
                               jnp.asarray(admit), bs)
    tcp.scatter_admit(t_pool, {"k": torch.from_numpy(chunk_k), "s": torch.from_numpy(chunk_s)},
                      admit, bs)
    _same(t_pool, j_pool)

    # one decode step: row 0 writes at slot 5 (tile 1, in-block 1), row 1
    # is parked (offset = width), row 2 falls in a sentinel tile
    view_k = rng.randn(S, H, nt * bs, D).astype(np.float32)
    view_s = rng.rand(S, H, nt * bs).astype(np.float32)
    offs = np.array([5, nt * bs, 1], np.int32)
    j_pool = jcp.scatter_step(j_pool, {"k": jnp.asarray(view_k), "s": jnp.asarray(view_s)},
                              jnp.asarray(bt), jnp.asarray(offs), num_blocks=N, block_size=bs)
    safe = np.clip(offs, 0, nt * bs - 1)
    rows = {"k": torch.from_numpy(view_k[np.arange(S), :, safe]),
            "s": torch.from_numpy(view_s[np.arange(S), :, safe])}
    plan = tcp.step_write_plan(bt, offs, num_blocks=N, block_size=bs, device="cpu")
    tcp.scatter_step(t_pool, rows, plan)
    _same(t_pool, j_pool)


def test_paged_layer_step_write_matches_jax_scatter_step():
    """A paged decode layer's own write (``PagedKVCache.write_rows``) lands
    each row where the JAX ``scatter_step`` puts it."""
    from distributed_llms_example_tpu_torch.ops.mha import PagedKVCache

    rng = np.random.RandomState(2)
    N, H, bs, D, nt = 6, 2, 4, 3, 2
    k = rng.randn(N, H, bs, D).astype(np.float32)
    v = rng.randn(N, H, bs, D).astype(np.float32)
    bt = np.array([[3, 1], [N, 5], [0, N]], np.int32)
    offs = np.array([6, 2, nt * bs], np.int32)  # row 1: sentinel tile; row 2: parked
    new_k = rng.randn(3, H, 1, D).astype(np.float32)
    new_v = rng.randn(3, H, 1, D).astype(np.float32)
    plan = tcp.step_write_plan(bt, offs, num_blocks=N, block_size=bs, device="cpu")
    cache = PagedKVCache(torch.from_numpy(k.copy()), torch.from_numpy(v.copy()),
                         torch.from_numpy(bt), plan)
    cache.write_rows(torch.from_numpy(new_k), torch.from_numpy(new_v))
    view = {n: np.broadcast_to(x, (3, H, nt * bs, D)).copy() for n, x in
            (("k", new_k), ("v", new_v))}
    want = jcp.scatter_step({"k": jnp.asarray(k), "v": jnp.asarray(v)},
                            {n: jnp.asarray(x) for n, x in view.items()}, jnp.asarray(bt),
                            jnp.asarray(offs), num_blocks=N, block_size=bs)
    _same({"k": cache.k, "v": cache.v}, want)


def test_tree_and_block_bytes():
    tree = [(torch.zeros(4, 2, 8, 4, dtype=torch.int8), torch.zeros(4, 2, 8))]
    assert tcp.tree_bytes(tree) == 4 * 2 * 8 * 4 + 4 * 2 * 8 * 4
    assert tcp.block_bytes(tree, 4) == 2 * 8 * 4 + 2 * 8 * 4
    # the flat path's per-layer caches are dataclasses with an int index
    from distributed_llms_example_tpu_torch.ops.mha import KVCache

    flat = [KVCache(torch.zeros(2, 2, 4, 4), torch.zeros(2, 2, 4, 4, dtype=torch.bfloat16), 3)]
    assert tcp.tree_bytes(flat) == 2 * 2 * 4 * 4 * 4 + 2 * 2 * 4 * 4 * 2
    pool = tcp.pool_cache_tree([(torch.zeros(2, 3, 5, 16), torch.zeros(2, 3, 5))], 6, 8)
    assert [tuple(x.shape) for x in pool[0]] == [(6, 3, 8, 16), (6, 3, 8)]
