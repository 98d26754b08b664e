"""The port's prefix cache (``serving/cache_pool.py``'s prefix half and the
engine's warm admission) on the CPU against the JAX package's.

Pool level, against the JAX pool on the same operations: the chain
hashes, first writer wins, the warm LRU's eviction order, a churn of
match-acquire-alloc-register-free with the refcount invariant walked after
every operation, and the speculative span write plan against JAX
``scatter_span``.  Engine level, on ``llama-test`` weights carried across
by ``models/from_jax.py`` (W = 16, L = 8, 2 slots, blocks of 8): requests
sharing an 8-token system prefix give the JAX engine's tokens (and the
cold flat engine's) with its prefix ledger, warm hits for all but the
first, a drained pool holding the one shared block warm, and a second
session that drops the stale warm set; a stepwise run through divergence
and slot reuse holds the refcount invariant after every step."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llms_example_tpu.models.registry import load_model as jax_load_model
from distributed_llms_example_tpu.serving import cache_pool as jcp
from distributed_llms_example_tpu.serving.engine import (
    ServeConfig as JaxServeConfig,
    ServingEngine as JaxServingEngine,
)
from distributed_llms_example_tpu_torch.models.from_jax import load_jax_params
from distributed_llms_example_tpu_torch.models.registry import load_model
from distributed_llms_example_tpu_torch.serving import cache_pool as tcp
from distributed_llms_example_tpu_torch.serving.engine import ServeConfig, ServingEngine

W, L = 16, 8
KW = dict(max_slots=2, prefill_batch=2, max_new_tokens=L, max_source_length=W,
          log_every_steps=0, request_spans=False)
PREFIX = dict(paged_kv=True, kv_block_size=8, pool_blocks=24, prefix_cache=True,
              prefix_cache_budget_gib=0.25)
LEDGER = ("prefix_lookups", "prefix_hits", "prefill_tokens_total", "prefill_tokens_saved",
          "decode_steps", "decode_tokens", "admit_deferrals")


# ------------------------------------------------------------- pool level


def test_chain_hashes_equal_jax_and_commit_to_the_prefix():
    rng = np.random.RandomState(5)
    for n, bs in ((0, 4), (3, 4), (8, 4), (9, 4), (37, 8), (64, 16)):
        toks = [int(t) for t in rng.randint(0, 300, n)]
        assert tcp.chain_hashes(toks, bs) == jcp.chain_hashes(toks, bs)
    a = tcp.chain_hashes([1, 2, 3, 4, 5, 6, 7, 8], 4)
    b = tcp.chain_hashes([9, 9, 9, 9, 5, 6, 7, 8], 4)
    assert a[0] != b[0] and a[1] != b[1]  # same block tokens, another predecessor
    assert tcp.chain_hashes([1, 2, 3, 4, 5, 6, 7, 8, 9], 4) == a  # the tail has no identity
    assert tcp.block_hash(None, [1, 23]) != tcp.block_hash(None, [12, 3])


def test_register_first_writer_wins_and_acquire_errors():
    pool = tcp.CachePool(num_blocks=8, block_size=4)
    pool.warm_capacity = 8
    h = tcp.chain_hashes([1, 2, 3, 4], 4)
    b1, b2 = pool.alloc(1), pool.alloc(1)
    pool.register(b1, h)
    pool.register(b2, h)
    assert pool.lookup(h[0]) == b1[0] and pool.match_chain(h) == b1
    pool.free(b2)  # the anonymous duplicate goes to the free list
    assert pool.blocks_warm == 0
    pool.free(b1)  # the registered block parks warm at refcount 0
    assert pool.blocks_warm == 1 and pool.match_chain(h) == b1
    pool.acquire(b1)
    assert pool.blocks_in_use == 1 and pool.blocks_warm == 0
    pool.free(b1)
    pool.drop_warm()
    with pytest.raises(ValueError, match="neither live nor warm"):
        pool.acquire(b1)
    with pytest.raises(ValueError, match="not allocated"):
        pool.register(b1, h)


def test_warm_lru_evicts_oldest_first_like_jax():
    """Both pools through the same operations: retention evicts strictly
    oldest first, a re-acquire refreshes recency, alloc pressure reclaims
    warm blocks before refusing, drop_warm clears the set."""
    def run(mod):
        pool = mod.CachePool(num_blocks=4, block_size=4)
        pool.warm_capacity = 2
        chains = [mod.chain_hashes([i] * 4, 4) for i in (1, 2, 3)]
        blocks = []
        for h in chains:
            (b,) = pool.alloc(1)
            pool.register([b], h)
            blocks.append(b)
        for b in blocks:
            pool.free([b])
        seen = [pool.blocks_warm, [pool.match_chain(h) for h in chains]]
        pool.acquire([blocks[1]])
        pool.free([blocks[1]])
        grant = pool.alloc(3)
        seen += [grant, [pool.match_chain(h) for h in chains]]
        pool.free(grant)
        seen += [pool.drop_warm(), pool.blocks_warm, pool.blocks_free]
        return seen

    got = run(tcp)
    assert got == run(jcp)
    assert got[1] == [[], [1], [2]] and got[3] == [[], [1], []] and got[-1] == 4


def test_prefix_refcount_churn_invariant_like_jax():
    """300 random admissions (match, acquire, alloc the tail, register) and
    frees over a small alphabet, on both pools: the same grants, the walked
    refcount invariant clean after every operation, the pool drained."""
    rng = np.random.RandomState(17)
    pools = [tcp.CachePool(30, 4), jcp.CachePool(30, 4)]
    for p in pools:
        p.warm_capacity = 8
    live: list[list[int]] = []
    for _ in range(300):
        if live and rng.rand() < 0.45:
            chain = live.pop(rng.randint(len(live)))
            for p in pools:
                p.free(chain[::-1])
        else:
            toks = [int(t) for t in rng.randint(0, 3, int(rng.randint(4, 17)))]
            hashes = tcp.chain_hashes(toks, 4)
            n = len(toks)
            grants = []
            for p in pools:
                chain = p.match_chain(hashes[: (n - 1) // 4])
                if chain:
                    p.acquire(chain)
                fresh = p.alloc(max(1, -(-n // 4)) - len(chain) + 1)
                if fresh is None:
                    if chain:
                        p.free(chain[::-1])
                    grants.append(None)
                    continue
                blocks = chain + fresh
                if n // 4:
                    p.register(blocks[: n // 4], hashes[: n // 4])
                grants.append(blocks)
            assert grants[0] == grants[1]
            if grants[0] is not None:
                live.append(grants[0])
        assert pools[0].ref_invariant_violations(live) == []
        assert pools[0].blocks_free + pools[0].blocks_in_use == 30
        assert (pools[0].blocks_free, pools[0].blocks_warm) == (pools[1].blocks_free,
                                                                pools[1].blocks_warm)
    for chain in live:
        pools[0].free(chain[::-1])
    assert pools[0].ref_invariant_violations([]) == [] and pools[0].blocks_in_use == 0


def test_ref_invariant_names_a_wrong_refcount():
    pool = tcp.CachePool(4, 4)
    b = pool.alloc(2)
    pool.acquire(b[:1])
    assert pool.ref_invariant_violations([b]) == ["block 0: refcount 2 != 1 live references"]


@pytest.mark.parametrize("span", [1, 4])
def test_span_write_plan_matches_jax_scatter_span(span):
    """A pass of ``span`` rows a slot through ``step_write_plan(span=)``
    lands where JAX ``scatter_span`` puts it (a parked slot, a sentinel
    tile and a span running off the view included), int8 scale leaves
    too."""
    rng = np.random.RandomState(span)
    N, H, bs, D, S, nt = 10, 2, 4, 8, 4, 4
    pool_k = rng.randn(N, H, bs, D).astype(np.float32)
    pool_s = rng.rand(N, H, bs).astype(np.float32)
    bt = np.array([[0, 1, 2, 3], [4, 5, N, 6], [7, 8, 9, N], [1, 2, 3, 4]], np.int32)
    offs = np.array([2, 6, 14, nt * bs], np.int32)  # the last slot parked
    new_k = rng.randn(S, H, span, D).astype(np.float32)
    new_s = rng.rand(S, H, span).astype(np.float32)
    # JAX writes from a slot view whose positions offs + j hold the new rows
    view_k = np.zeros((S, H, nt * bs, D), np.float32)
    view_s = np.zeros((S, H, nt * bs), np.float32)
    for s in range(S):
        for j in range(span):
            if offs[s] + j < nt * bs:
                view_k[s, :, offs[s] + j] = new_k[s, :, j]
                view_s[s, :, offs[s] + j] = new_s[s, :, j]
    want = jcp.scatter_span({"k": jnp.asarray(pool_k), "s": jnp.asarray(pool_s)},
                            {"k": jnp.asarray(view_k), "s": jnp.asarray(view_s)},
                            jnp.asarray(bt), jnp.asarray(offs), span, num_blocks=N, block_size=bs)
    plan = tcp.step_write_plan(bt, offs, num_blocks=N, block_size=bs, device="cpu", span=span)
    got_k, got_s = torch.from_numpy(pool_k.copy()), torch.from_numpy(pool_s.copy())
    flat = lambda x: torch.from_numpy(x).transpose(1, 2).reshape(S * span, H, *x.shape[3:])  # noqa: E731
    tcp.scatter_step((got_k, got_s), (flat(new_k), flat(new_s)), plan)
    np.testing.assert_array_equal(got_k.numpy(), np.asarray(want["k"]))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want["s"]))


# ----------------------------------------------------------- engine level


@pytest.fixture(scope="module")
def llama():
    lm = jax_load_model("llama-test")
    params = jax.device_get(lm.init_params(0))
    tlm = load_model("llama-test", device="cpu")
    load_jax_params(tlm.module, params)
    return lm, params, tlm


def _engine(tlm, **kw):
    return ServingEngine(tlm.module, tlm.config, ServeConfig(**{**KW, **kw}), is_seq2seq=False,
                         device="cpu")


def _chat_requests(rng, n=8, sys_len=8):
    sys_toks = [int(t) for t in rng.randint(4, 120, sys_len)]
    return [sys_toks + [int(t) for t in rng.randint(4, 120, rng.randint(2, 8))]
            for _ in range(n)]


def test_prefix_warm_matches_jax_and_cold(llama):
    lm, params, tlm = llama
    reqs = _chat_requests(np.random.RandomState(23))
    jeng = JaxServingEngine(lm.module, lm.config, None, JaxServeConfig(**KW, **PREFIX),
                            is_seq2seq=False)
    want = jeng.generate(params, reqs)
    cold = _engine(tlm).generate(reqs)
    eng = _engine(tlm, **PREFIX)
    got = eng.generate(reqs)
    assert got == want == cold
    st = eng.last_stats
    assert {f: getattr(st, f) for f in LEDGER} == {f: getattr(jeng.last_stats, f)
                                                  for f in LEDGER}
    assert st.prefix_lookups == len(reqs) and st.prefix_hits == len(reqs) - 1
    assert st.prefill_tokens_saved == (len(reqs) - 1) * 8
    assert st.prefill_tokens_total == sum(len(r) for r in reqs)
    assert st.warm_admit_calls > 0 and st.prefill_calls > 0
    assert eng.pool.blocks_in_use == 0 and eng.pool.blocks_warm == jeng.pool.blocks_warm == 1
    # a second session drops the warm set its fresh pool tensors no longer hold
    assert eng.generate(reqs) == cold
    assert eng.last_stats.prefix_hits == len(reqs) - 1


def test_prefix_divergence_and_slot_reuse_stepwise(llama):
    """A and B share the system block and diverge (B holds the shared
    block and allocates only its tail); C repeats A and re-acquires A's
    chain from the warm set through a reused slot.  Tokens equal the cold
    engine's and the JAX engine's, the invariant holds after every step."""
    lm, params, tlm = llama
    rng = np.random.RandomState(29)
    sys_toks = [int(t) for t in rng.randint(4, 120, 8)]
    a = sys_toks + [int(t) for t in rng.randint(4, 120, 5)]
    b = sys_toks + [int(t) for t in rng.randint(4, 120, 5)]
    reqs = [a, b, list(a)]
    jeng = JaxServingEngine(lm.module, lm.config, None, JaxServeConfig(**KW, **PREFIX),
                            is_seq2seq=False)
    want = jeng.generate(params, reqs)
    eng = _engine(tlm, **PREFIX)
    sess = eng.open()
    for r in reqs:
        sess.submit(r)
    shared_in_use = None
    while sess.has_work():
        sess.step()
        assert sess.prefix_ref_violations() == []
        if shared_in_use is None and sess.active.all():
            shared_in_use = eng.pool.blocks_in_use
    sess.finalize()
    assert shared_in_use == 5  # 3 blocks each, one shared
    assert list(sess.outputs) == want == _engine(tlm).generate(reqs)
    assert (eng.last_stats.prefix_hits, eng.last_stats.prefix_lookups) == (2, 3)
    assert eng.pool.blocks_in_use == 0 and eng.pool.ref_invariant_violations([]) == []
