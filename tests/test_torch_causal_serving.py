"""The port's causal engine on the CPU against the JAX package's engine on
the same ``llama-test`` weights (GQA 4/2), under the JAX paged-pool tests'
fixture: 8 requests of 3-13 tokens, W = 16, L = 8, 2 slots.  Flat, paged
with 8-slot blocks and an 8-wide bucket, and paged with the derived block
size all give the JAX engine's tokens exactly; a pool too small for the
concurrency defers admissions and still gives them; the pool drains to 0;
a pool poisoned with NaN at init changes nothing (every read is masked to
what its owner wrote).  The int8 K/V cache, flat and paged, gives the
JAX engine's int8 tokens exactly, holds 4d/(d + 4) fewer bytes than the
fp32 cache, and keeps the JAX tests' floor of 0.85 greedy-token agreement
with the fp32 engine (``llama-test``'s random logits are near ties)."""

import json

import jax
import numpy as np
import pytest

from distributed_llms_example_tpu.models.registry import load_model as jax_load_model
from distributed_llms_example_tpu.serving.engine import (
    ServeConfig as JaxServeConfig,
    ServingEngine as JaxServingEngine,
)
from distributed_llms_example_tpu_torch.models.from_jax import load_jax_params
from distributed_llms_example_tpu_torch.models.registry import load_model
from distributed_llms_example_tpu_torch.serving import cache_pool
from distributed_llms_example_tpu_torch.serving.engine import ServeConfig, ServingEngine

W, L = 16, 8
KW = dict(max_slots=2, prefill_batch=2, max_new_tokens=L, max_source_length=W,
          log_every_steps=0, request_spans=False)


@pytest.fixture(scope="module")
def llama_runs():
    lm = jax_load_model("llama-test")
    params = jax.device_get(lm.init_params(0))
    rng = np.random.RandomState(7)
    reqs = [list(rng.randint(4, 120, rng.randint(3, 14))) for _ in range(8)]
    flat = JaxServingEngine(lm.module, lm.config, None, JaxServeConfig(**KW),
                            is_seq2seq=False).generate(params, reqs)
    tlm = load_model("llama-test", device="cpu")
    load_jax_params(tlm.module, params)
    return lm, params, tlm, reqs, flat


def _engine(tlm, **kw):
    return ServingEngine(tlm.module, tlm.config, ServeConfig(**{**KW, **kw}), is_seq2seq=False,
                         device="cpu")


@pytest.mark.parametrize("extra", [
    {}, {"paged_kv": True, "kv_block_size": 8, "prefill_buckets": (8,)}, {"paged_kv": True},
], ids=["flat", "paged_bs8_bucketed", "paged_default_block"])
def test_engine_tokens_match_jax_engine(llama_runs, extra):
    _, _, tlm, reqs, flat = llama_runs
    eng = _engine(tlm, **extra)
    assert eng.generate(reqs) == flat
    if eng.paged:
        assert eng.pool.blocks_in_use == 0
        assert (W + L) % eng.block_size == 0
        assert all(b % eng.block_size == 0 for b in eng.buckets)


def test_paged_bytes_per_token_below_flat(llama_runs):
    _, _, tlm, reqs, _ = llama_runs
    flat = _engine(tlm)
    flat.generate(reqs)
    paged = _engine(tlm, paged_kv=True, kv_block_size=8, prefill_buckets=(8,))
    paged.generate(reqs)
    assert paged.last_stats.bytes_per_live_token < flat.last_stats.bytes_per_live_token


def test_small_pool_defers_admission(llama_runs):
    _, _, tlm, reqs, flat = llama_runs
    worst = cache_pool.blocks_needed(W, L, 8)
    eng = _engine(tlm, paged_kv=True, kv_block_size=8, pool_blocks=worst)
    assert eng.generate(reqs) == flat
    assert eng.last_stats.admit_deferrals > 0
    assert eng.pool.blocks_in_use == 0
    with pytest.raises(ValueError, match="worst-case request"):
        _engine(tlm, paged_kv=True, kv_block_size=8, pool_blocks=worst - 1)


def test_pool_poisoned_with_nan_gives_same_tokens(llama_runs):
    _, _, tlm, reqs, flat = llama_runs
    eng = _engine(tlm, paged_kv=True, kv_block_size=8)
    orig = eng._init_state

    def poisoned():
        st = orig()
        for k, v in st["pool"]:
            k.fill_(float("nan"))
            v.fill_(float("nan"))
        return st

    eng._init_state = poisoned
    assert eng.generate(reqs) == flat


def test_paged_events_carry_the_jax_keys(llama_runs, capsys):
    lm, params, tlm, reqs, _ = llama_runs
    kw = {**KW, "log_every_steps": 5, "request_spans": True, "paged_kv": True,
          "kv_block_size": 8}
    capsys.readouterr()
    JaxServingEngine(lm.module, lm.config, None, JaxServeConfig(**kw),
                     is_seq2seq=False).generate(params, reqs)
    jax_events = [json.loads(x) for x in capsys.readouterr().out.splitlines() if x.startswith("{")]
    ServingEngine(tlm.module, tlm.config, ServeConfig(**kw), is_seq2seq=False,
                  device="cpu").generate(reqs)
    events = [json.loads(x) for x in capsys.readouterr().out.splitlines() if x.startswith("{")]
    for name in ("serve_request", "serve_summary", "serve_window"):
        jk = [set(e) for e in jax_events if e.get("event") == name]
        tk = [set(e) for e in events if e.get("event") == name]
        assert jk and len(tk) == len(jk), name
        assert tk[0] == jk[0], (name, tk[0] ^ jk[0])


def test_paged_kv_on_seq2seq_raises():
    tlm = load_model("bart-test", device="cpu")
    with pytest.raises(ValueError, match="seq2seq"):
        ServingEngine(tlm.module, tlm.config, ServeConfig(paged_kv=True), device="cpu")


def test_paged_step_never_gathers_on_the_kernel_route(llama_runs, monkeypatch):
    """With ``flash`` forced (L = 16, so the 32-slot cache tiles by the JAX
    package's rule), every paged decode step goes through
    ``flash_decode_paged`` (its plain version on the CPU), the layer never
    builds the slot view, and the tokens equal the flat engine's on its
    kernel route (``flash_decode``)."""
    from distributed_llms_example_tpu_torch.ops import mha

    _, _, tlm, reqs, _ = llama_runs
    for blk in tlm.module.blocks:
        blk.self_attn.attention_impl = "flash"
    try:
        want = _engine(tlm, max_new_tokens=16).generate(reqs)
        calls = {"paged": 0}
        real_paged = mha.flash_decode_paged

        def paged(*a, **k):
            calls["paged"] += 1
            return real_paged(*a, **k)

        def gather(*a, **k):
            raise AssertionError("the slot view was built on the kernel route")

        monkeypatch.setattr(mha, "flash_decode_paged", paged)
        monkeypatch.setattr(mha, "gather_cache", gather)
        eng = _engine(tlm, max_new_tokens=16, paged_kv=True, kv_block_size=8)
        got = eng.generate(reqs)
    finally:
        for blk in tlm.module.blocks:
            blk.self_attn.attention_impl = "auto"
    assert calls["paged"] == len(tlm.module.blocks) * eng.last_stats.decode_steps > 0
    assert got == want


@pytest.mark.parametrize("extra", [
    {}, {"paged_kv": True, "kv_block_size": 8, "prefill_buckets": (8,)},
], ids=["flat", "paged_bs8_bucketed"])
def test_int8_engine_tokens_match_jax_engine(llama_runs, extra):
    lm, params, tlm, reqs, flat = llama_runs
    kw = {**KW, **extra, "kv_cache_dtype": "int8"}
    want = JaxServingEngine(lm.module, lm.config, None, JaxServeConfig(**kw),
                            is_seq2seq=False).generate(params, reqs)
    eng = _engine(tlm, kv_cache_dtype="int8", **extra)
    got = eng.generate(reqs)
    assert got == want
    same = sum(x == y for a, b in zip(got, flat) for x, y in zip(a, b))
    assert same / sum(max(len(a), len(b)) for a, b in zip(got, flat)) >= 0.85
    if eng.paged:
        assert eng.pool.blocks_in_use == 0
        # int8 K/V pools beside their fp32 scale pools, in every layer
        assert all([str(x.dtype) for x in layer] == ["torch.int8"] * 2 + ["torch.float32"] * 2
                   for layer in eng.open().state["pool"])
    else:
        d = tlm.config.hidden_size // tlm.config.num_attention_heads
        ratio = _engine(tlm).open().stats.cache_bytes_resident / eng.last_stats.cache_bytes_resident
        assert ratio == pytest.approx(4 * d / (d + 4))
