"""The port's continuous-batching engine on the CPU against the JAX
package's engine on the same ``bart-test`` and ``t5-test`` weights (the
seq2seq slot state sized from each model's own layers): 10 requests through 4
slots (slot reuse really happens), W = 32, L = 12, per-request budgets.
Tokens must be identical, and the serve_request / serve_summary events
must carry the same keys."""

import json

import jax
import numpy as np
import pytest
import torch

from distributed_llms_example_tpu.models.registry import load_model as jax_load_model
from distributed_llms_example_tpu.serving.engine import (
    ServeConfig as JaxServeConfig,
    ServingEngine as JaxServingEngine,
)
from distributed_llms_example_tpu_torch.models.from_jax import load_jax_params
from distributed_llms_example_tpu_torch.models.registry import load_model
from distributed_llms_example_tpu_torch.serving.engine import (
    ServeConfig,
    ServingEngine,
    compute_goodput,
    trim_eos,
)

L, W = 12, 32


@pytest.fixture(autouse=True)
def _no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _events(text):
    return [json.loads(line) for line in text.splitlines() if line.startswith("{")]


@pytest.mark.parametrize("impl", ["auto", "flash"])
@pytest.mark.parametrize("name", ["bart-test", "t5-test"])
def test_engine_tokens_match_jax_engine(capsys, name, impl):
    lm = jax_load_model(name)
    params = jax.device_get(lm.init_params(0))
    rng = np.random.RandomState(7)
    reqs = [list(rng.randint(4, 200, rng.randint(3, 20))) for _ in range(10)]
    budgets = [int(b) for b in rng.randint(4, L + 1, len(reqs))]
    kw = dict(max_slots=4, prefill_batch=4, max_new_tokens=L, max_source_length=W,
              log_every_steps=5)
    jeng = JaxServingEngine(lm.module, lm.config, None, JaxServeConfig(**kw), is_seq2seq=True)
    capsys.readouterr()
    want = jeng.generate(params, reqs, max_new=budgets)
    jax_events = _events(capsys.readouterr().out)

    tlm = load_model(name, device="cpu", attention_impl=impl)
    load_jax_params(tlm.module, params)
    teng = ServingEngine(tlm.module, tlm.config, ServeConfig(**kw), device="cpu")
    got = teng.generate(reqs, max_new=budgets)
    events = _events(capsys.readouterr().out)

    assert got == want
    assert teng.last_stats.sequences > teng.S  # slot reuse
    assert teng.last_stats.decode_steps == jeng.last_stats.decode_steps
    eos, pad = lm.config.eos_token_id, lm.config.pad_token_id
    for g, budget in zip(got, budgets):
        assert len(trim_eos(g, eos, pad)) <= budget
    for name in ("serve_request", "serve_summary", "serve_window"):
        jk = [set(e) for e in jax_events if e.get("event") == name]
        tk = [set(e) for e in events if e.get("event") == name]
        assert jk and len(tk) == len(jk), name
        assert tk[0] == jk[0], (name, tk[0] ^ jk[0])
    summary = next(e for e in events if e.get("event") == "serve_summary")
    assert summary["decode_tokens"] == sum(len(o) for o in got)
    assert set(summary["memory_account"]) == set(
        next(e for e in jax_events if e.get("event") == "serve_summary")["memory_account"]
    )


def test_goodput_matches_jax_arithmetic():
    from distributed_llms_example_tpu.serving.engine import compute_goodput as jax_goodput

    ttft = [0.1, None, 0.5, 0.02]
    toks = [10, 3, 7, 4]
    for slo in (0.0, 200.0):
        assert compute_goodput(ttft, toks, wall_s=2.0, ttft_slo_ms=slo, n_chips=1) == \
            jax_goodput(ttft, toks, wall_s=2.0, ttft_slo_ms=slo, n_chips=1)


def _other_vocab_draft():
    """A causal draft whose vocabulary is not the target's."""
    import dataclasses

    from distributed_llms_example_tpu_torch.models.llama import LlamaForCausalLM
    from distributed_llms_example_tpu_torch.models.registry import LoadedModel

    cfg = dataclasses.replace(load_model("llama-test", device="cpu").config, vocab_size=77)
    return LoadedModel("llama", cfg, LlamaForCausalLM(cfg, device="cpu"), is_seq2seq=False)


# the JAX engine's composition rules (serving/engine.py), each a ValueError
# at construction: (model, ServeConfig fields, message, the JAX engine too)
COMPOSITION_ERRORS = {
    "prefix_without_paged": ("llama-test", {"prefix_cache": True}, "requires paged_kv", True),
    "spec_on_seq2seq": ("t5-test", {"spec_tokens": 2}, "causal decode", True),
    "spec_tokens_8": ("llama-test", {"spec_tokens": 8}, "spec_tokens=8", True),
    "spec_tokens_minus_1": ("llama-test", {"spec_tokens": -1}, "spec_tokens=-1", True),
    "seq2seq_draft": ("llama-test", {"spec_tokens": 2, "spec_draft_model": "t5-test"},
                      "seq2seq", True),
    "draft_other_vocab": ("llama-test", {"spec_tokens": 2}, "vocab 77", False),
}


@pytest.mark.parametrize("case", sorted(COMPOSITION_ERRORS))
def test_serve_composition_errors(case):
    name, fields, match, on_jax = COMPOSITION_ERRORS[case]
    kw = dict(max_slots=2, prefill_batch=2, **fields)
    tlm = load_model(name, device="cpu")
    draft = _other_vocab_draft() if case == "draft_other_vocab" else None
    with pytest.raises(ValueError, match=match):
        ServingEngine(tlm.module, tlm.config, ServeConfig(**kw), is_seq2seq=tlm.is_seq2seq,
                      device="cpu", draft=draft)
    if on_jax:
        lm = jax_load_model(name)
        with pytest.raises(ValueError, match=match):
            JaxServingEngine(lm.module, lm.config, None, JaxServeConfig(**kw),
                             is_seq2seq=lm.is_seq2seq)


def test_causal_engine_raises():
    """Causal serving runs since the LLaMA slice; what still raises is the
    paged pool on a seq2seq model (as in the JAX engine) and Mixtral."""
    tlm = load_model("bart-test", device="cpu")
    with pytest.raises(ValueError, match="seq2seq"):
        ServingEngine(tlm.module, tlm.config, ServeConfig(paged_kv=True), device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        load_model("mixtral-8x7b", device="cpu")
