"""The port's speculative decode (``serving/spec.py`` and the engine's
verify rounds) on the CPU against the JAX package's, on ``llama-test``
weights carried across by ``models/from_jax.py``, under the JAX tests'
fixture (8 requests of 3-13 tokens, W = 16, L = 8, 2 slots).

The drafters and the acceptance rule equal JAX's on the JAX tests' own
cases.  n-gram speculation flat, paged with int8 K/V and over warm prefix
hits, and a draft model (the target's own weights, injected as the JAX
draft's ``init_params(0)``) give the JAX engine's tokens and its
speculative ledger exactly, and plain greedy's tokens.  Steady decode and
verify rounds run no op that reads a value back.  A storm of drafts
that are always wrong leaves the pool drained, its refcounts exact and no
speculative block in the hash index.  The verify block's rows equal
single-row steps, and the serve events carry the JAX engine's keys."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llms_example_tpu.models.registry import load_model as jax_load_model
from distributed_llms_example_tpu.serving import spec as jax_spec
from distributed_llms_example_tpu.serving.engine import (
    ServeConfig as JaxServeConfig,
    ServingEngine as JaxServingEngine,
)
from distributed_llms_example_tpu_torch.models.from_jax import load_jax_params
from distributed_llms_example_tpu_torch.models.registry import load_model
from distributed_llms_example_tpu_torch.serving import cache_pool, spec
from distributed_llms_example_tpu_torch.serving.engine import ServeConfig, ServingEngine

W, L = 16, 8
KW = dict(max_slots=2, prefill_batch=2, max_new_tokens=L, max_source_length=W,
          log_every_steps=0, request_spans=False)
PREFIX = dict(paged_kv=True, kv_block_size=8, pool_blocks=24, prefix_cache=True,
              prefix_cache_budget_gib=0.25)
SPEC_FIELDS = ("spec_steps", "spec_slot_rounds", "spec_drafted", "spec_accepted",
               "spec_emitted", "decode_steps", "decode_tokens", "prefix_lookups", "prefix_hits",
               "prefill_tokens_total", "prefill_tokens_saved")


def _requests(rng, n=8, lo=3, hi=14):
    return [list(rng.randint(4, 120, rng.randint(lo, hi))) for _ in range(n)]


def _chat_requests(rng, n=8):
    sys_toks = [int(t) for t in rng.randint(4, 120, 8)]
    return [sys_toks + [int(t) for t in rng.randint(4, 120, rng.randint(2, 8))]
            for _ in range(n)]


@pytest.fixture(scope="module")
def llama():
    lm = jax_load_model("llama-test")
    params = jax.device_get(lm.init_params(0))
    tlm = load_model("llama-test", device="cpu")
    load_jax_params(tlm.module, params)
    reqs = _requests(np.random.RandomState(7))
    plain = _engine(tlm).generate(reqs)
    return lm, params, tlm, reqs, plain


def _engine(tlm, draft=None, **kw):
    return ServingEngine(tlm.module, tlm.config, ServeConfig(**{**KW, **kw}), is_seq2seq=False,
                         device="cpu", draft=draft)


def _jax_run(lm, params, reqs, **kw):
    eng = JaxServingEngine(lm.module, lm.config, None, JaxServeConfig(**{**KW, **kw}),
                           is_seq2seq=False)
    return eng.generate(params, reqs), eng.last_stats


def _ledger(stats):
    return {f: getattr(stats, f) for f in SPEC_FIELDS}


# ------------------------------------------------------------ pure drafting


@pytest.mark.parametrize("history, k", [
    ([5, 6, 7, 5, 6, 7, 5, 6], 4), ([1, 2, 3], 3), ([], 2), ([9, 9], 4),
    ([2, 7, 0, 2, 8, 1, 2], 1), ([4, 5], 1), ([4, 5], 7), ([3, 1, 3, 1, 3], 6),
])
def test_ngram_draft_matches_jax(history, k):
    assert spec.ngram_draft(history, k) == jax_spec.ngram_draft(history, k)


def test_ngram_drafts_batched_pads_idle():
    hist = [[5, 6, 5], None, [], [1, 2, 1, 2]]
    got = spec.ngram_drafts(hist, 3, pad=0)
    assert got.dtype == np.int32 and got.tolist() == jax_spec.ngram_drafts(hist, 3, 0).tolist()
    assert got[0].tolist() == [6, 5, 5] and got[1].tolist() == [0, 0, 0]


def test_acceptance_lengths_match_jax():
    """The JAX tests' cases (all match, one wrong draft, a wrong first
    draft, the room clamp) and a random sweep."""
    x = np.array([[10, 7, 8, 9]] * 4, np.int32)
    x[2, 1] = 5
    target = np.array([[7, 8, 9, 1], [7, 2, 9, 1], [7, 8, 9, 1], [7, 8, 9, 1]], np.int32)
    room = np.array([3, 3, 3, 2], np.int32)
    rng = np.random.RandomState(3)
    for xs, ts, rs in [(x, target, room)] + [
            (rng.randint(0, 3, (16, 5)).astype(np.int32), rng.randint(0, 3, (16, 5)).astype(np.int32),
             rng.randint(0, 5, 16).astype(np.int32)) for _ in range(4)]:
        got = spec.acceptance_lengths(torch.from_numpy(xs), torch.from_numpy(ts),
                                      torch.from_numpy(rs))
        want = np.asarray(jax_spec.acceptance_lengths(jnp.asarray(xs), jnp.asarray(ts),
                                                      jnp.asarray(rs)))
        assert got.tolist() == want.tolist()
    assert spec.acceptance_lengths(torch.from_numpy(x), torch.from_numpy(target),
                                   torch.from_numpy(room)).tolist() == [3, 1, 0, 2]


# ------------------------------------------------------- engine vs JAX


@pytest.mark.parametrize("extra", [
    {}, {"paged_kv": True, "kv_block_size": 8, "kv_cache_dtype": "int8"},
], ids=["flat", "paged_int8"])
def test_spec_engine_matches_jax_engine(llama, extra):
    """n-gram speculation: the JAX engine's tokens and ledger; flat f32 is
    plain greedy's tokens, paged int8 the plain paged int8 engine's."""
    lm, params, tlm, reqs, plain = llama
    want, jstats = _jax_run(lm, params, reqs, spec_tokens=3, **extra)
    eng = _engine(tlm, spec_tokens=3, **extra)
    got = eng.generate(reqs)
    assert got == want
    assert got == (plain if not extra else _engine(tlm, **extra).generate(reqs))
    st = eng.last_stats
    assert _ledger(st) == _ledger(jstats)
    assert st.spec_emitted == st.decode_tokens == sum(len(o) for o in got) - len(reqs)
    assert st.spec_drafted == 3 * st.spec_slot_rounds and st.spec_steps > 0
    if eng.paged:
        assert eng.pool.blocks_in_use == 0


# ops that read a value back to the host: on a card each is a device sync
SYNCING_OPS = ("aten::_local_scalar_dense", "aten::item", "aten::nonzero", "aten::is_nonzero",
               "aten::masked_select")


PAGED = {"paged_kv": True, "kv_block_size": 8}


@pytest.mark.parametrize("extra, draft", [
    ({"spec_tokens": 3}, False), ({**PAGED, "spec_tokens": 3, "kv_cache_dtype": "int8"}, False),
    ({**PAGED, "spec_tokens": 3}, True), (PAGED, False), ({"kv_cache_dtype": "int8"}, False),
], ids=["spec_flat", "spec_paged_int8", "spec_paged_draft", "plain_paged", "plain_int8_flat"])
def test_rounds_read_back_only_their_tokens(llama, extra, draft):
    """Steady decode and verify rounds, drafting included, run no op that
    reads a value back: on a card each would be a sync beside the round's
    one read of its tokens (and emit counts), which chip_smoke counts in a
    trace."""
    from torch.profiler import ProfilerActivity, profile

    _, _, tlm, reqs, _ = llama
    eng = _engine(tlm, draft=tlm if draft else None, **{**extra, "max_new_tokens": 24})
    sess = eng.open()
    for r in reqs[:2]:
        sess.submit(r)
    for _ in range(2):  # the admission and two rounds, outside the window
        sess.step()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(2):
            sess.step()
    ops = {e.key: e.count for e in prof.key_averages()}
    assert sess.stats.decode_steps == 4 and any(k.startswith("aten::") for k in ops)
    assert not {k: ops[k] for k in SYNCING_OPS if k in ops}


def test_spec_over_warm_prefix_hits_matches_jax(llama):
    """Speculation over warm prefix hits: JAX's tokens and ledgers, plain
    greedy's tokens, real hits, and only prompt-chain hashes indexed."""
    lm, params, tlm, _, _ = llama
    reqs = _chat_requests(np.random.RandomState(23))
    want, jstats = _jax_run(lm, params, reqs, spec_tokens=3, **PREFIX)
    eng = _engine(tlm, spec_tokens=3, **PREFIX)
    got = eng.generate(reqs)
    assert got == want == _engine(tlm).generate(reqs)
    assert _ledger(eng.last_stats) == _ledger(jstats)
    assert eng.last_stats.prefix_hits == len(reqs) - 1
    assert eng.pool.blocks_in_use == 0
    hashes = {h for r in reqs for h in cache_pool.chain_hashes(r[:W], 8)}
    assert set(eng.pool._index) <= hashes


def test_draft_model_matches_jax_and_yields_multi_token(llama):
    """A draft model sharing the target's weights (the JAX draft's
    ``init_params(0)``, injected): its proposals are the target's argmax,
    so acceptance is high and the yield per round well above 1, while
    the tokens stay the JAX engine's and the ledger equals JAX's."""
    lm, params, tlm, _, _ = llama
    reqs = _requests(np.random.RandomState(11), n=6)
    draft = load_model("llama-test", device="cpu")
    load_jax_params(draft.module, params)
    kw = dict(max_new_tokens=16, spec_tokens=3, spec_draft_model="llama-test", paged_kv=True,
              kv_block_size=8)
    want, jstats = _jax_run(lm, params, reqs, **kw)
    eng = _engine(tlm, draft=draft, **kw)
    got = eng.generate(reqs)
    assert got == want
    st = eng.last_stats
    assert _ledger(st) == _ledger(jstats)
    assert st.spec_emitted / st.spec_slot_rounds > 1.0
    assert st.spec_accepted / st.spec_drafted > 0.5
    assert eng.drafter.prefill_calls > 0 and eng.drafter.rounds == st.spec_steps
    assert eng.pool.blocks_in_use == 0


def test_spec_pool_storm_of_wrong_drafts_leaks_nothing(llama, monkeypatch):
    """Drafts forced wrong every round (id 3, outside the prompts' 4..120):
    nothing accepted, one token a slot a round, plain greedy's tokens, the
    pool back to its full free count with exact refcounts, and no
    speculative block in the hash index."""
    _, _, tlm, _, _ = llama
    reqs = _requests(np.random.RandomState(31), n=12)
    plain = _engine(tlm).generate(reqs)
    monkeypatch.setattr(spec, "ngram_drafts",
                        lambda hist, k, pad: np.full((len(hist), k), 3, np.int32))
    eng = _engine(tlm, spec_tokens=3, **PREFIX)
    free0 = eng.pool.blocks_free
    sess = eng.open()
    for r in reqs:
        sess.submit(r)
    while sess.has_work():
        sess.step()
        assert sess.prefix_ref_violations() == []
    sess.finalize()
    assert list(sess.outputs) == plain
    st = eng.last_stats
    assert st.spec_accepted == 0 and st.spec_emitted == st.spec_slot_rounds
    assert eng.pool.blocks_in_use == 0 and eng.pool.blocks_free == free0
    assert eng.pool.ref_invariant_violations([]) == []
    hashes = {h for r in reqs for h in cache_pool.chain_hashes(r[:W], 8)}
    assert set(eng.pool._index) <= hashes


def test_verify_rows_equal_single_row_steps(llama):
    """The verify pass's k + 1 rows at offset o are the single-row decode
    steps at o .. o + k over the same cache (the plain path): each row's
    logits equal, and the rollback leaves the mask at the accepted span."""
    _, _, tlm, _, _ = llama
    from distributed_llms_example_tpu_torch.evaluation.generation import causal_prefill

    model = tlm.module
    ids = torch.tensor([[5, 9, 11, 7, 0, 0, 0, 0], [8, 8, 3, 4, 6, 2, 9, 0]])
    mask = (ids != 0).to(torch.int32)
    x = torch.tensor([[21, 22, 23, 24], [31, 32, 33, 34]], dtype=torch.int32)
    with torch.inference_mode():
        cache, full_mask, lengths, _ = causal_prefill(model, ids, mask, 8)
        offs = torch.tensor([8, 8], dtype=torch.int32)
        fm = full_mask.clone()
        fm[:, 8:12] = 1
        block = model(x, fm, positions=lengths.long()[:, None] + torch.arange(4),
                      cache=[type(c)(c.k.clone(), c.v.clone()) for c in cache],
                      cache_positions=offs)
        singles = []
        for j in range(4):
            m = full_mask.clone()
            m[:, 8:9 + j] = 1
            singles.append(model(x[:, j:j + 1], m, positions=(lengths.long() + j)[:, None],
                                 cache=cache, cache_positions=offs + j)[:, 0])
    torch.testing.assert_close(block, torch.stack(singles, 1), rtol=0, atol=1e-5)


def test_spec_and_prefix_events_carry_the_jax_keys(llama, capsys):
    """``serve_window`` and ``serve_summary`` of a speculative run over the
    prefix cache carry the JAX engine's keys (``spec_decode``,
    ``accepted_tokens_per_step``, ``prefix_hit_rate``, ...)."""
    import json

    lm, params, tlm, _, _ = llama
    reqs = _chat_requests(np.random.RandomState(5), n=4)
    kw = dict(spec_tokens=2, log_every_steps=2, **PREFIX)
    capsys.readouterr()
    _jax_run(lm, params, reqs, **kw)
    want = [json.loads(x) for x in capsys.readouterr().out.splitlines() if x.startswith("{")]
    _engine(tlm, **kw).generate(reqs)
    got = [json.loads(x) for x in capsys.readouterr().out.splitlines() if x.startswith("{")]
    for name in ("serve_window", "serve_summary"):
        jk = [set(e) for e in want if e.get("event") == name]
        tk = [set(e) for e in got if e.get("event") == name]
        assert jk and len(tk) == len(jk) and tk[0] == jk[0], (name, tk[0] ^ jk[0])
    summary = next(e for e in got if e.get("event") == "serve_summary")
    assert summary["spec_decode"] and summary["prefix_cache"] and summary["spec_tokens"] == 2
