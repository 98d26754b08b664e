"""The port's LLaMA against the JAX package's on the same weights (moved
across with ``models/from_jax.py``): RMSNorm, RoPE, one block, whole-model
logits on ``llama-test`` (GQA: 4 q heads over 2 kv heads), and the cached
path — the prompt prefill of right-padded prompts followed by 3 decode
steps with per-row RoPE positions and cache positions.  fp32; atol 1e-5.
The port runs its plain path ("xla") and its kernel path ("flash", whose
wrappers run their plain versions on the CPU)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llms_example_tpu.evaluation.generation import _causal_prefill
from distributed_llms_example_tpu.models.llama import LlamaBlock as JaxBlock
from distributed_llms_example_tpu.models.registry import load_model as jax_load_model
from distributed_llms_example_tpu.ops import mha as jmha
from distributed_llms_example_tpu.ops.norms import RMSNorm as JaxRMSNorm
from distributed_llms_example_tpu_torch.evaluation.generation import causal_prefill
from distributed_llms_example_tpu_torch.models.from_jax import (
    _state_dict_from_jax,
    blocks_state_dict_from_jax,
    load_jax_params,
)
from distributed_llms_example_tpu_torch.models.llama import (
    LlamaBlock,
    LlamaConfig,
    LlamaForCausalLM,
)
from distributed_llms_example_tpu_torch.models.registry import load_model
from distributed_llms_example_tpu_torch.ops import mha as tmha
from distributed_llms_example_tpu_torch.ops.norms import RMSNorm

ATOL = 1e-5


@pytest.fixture(autouse=True)
def _no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@pytest.fixture(scope="module")
def jax_llama():
    lm = jax_load_model("llama-test")
    return lm, jax.device_get(lm.init_params(0))


def _port(params, impl="auto"):
    tlm = load_model("llama-test", device="cpu", attention_impl=impl)
    load_jax_params(tlm.module, params)
    return tlm


def _prompts(B=4, P=12, seed=0):
    rng = np.random.RandomState(seed)
    ids = rng.randint(4, 256, (B, P)).astype(np.int32)
    lens = np.array([P, 9, 4, 1])[:B]
    mask = (np.arange(P)[None, :] < lens[:, None]).astype(np.int32)
    return ids, mask


def test_rmsnorm_matches_jax():
    rng = np.random.RandomState(1)
    x = rng.randn(3, 5, 64).astype(np.float32) * 3.0
    scale = rng.rand(64).astype(np.float32) + 0.5
    want = JaxRMSNorm(1e-5).apply({"params": {"scale": jnp.asarray(scale)}}, jnp.asarray(x))
    norm = RMSNorm(64, 1e-5)
    with torch.no_grad():
        norm.weight.copy_(torch.from_numpy(scale))
        got = norm(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_rope_matches_jax():
    rng = np.random.RandomState(2)
    pos = rng.randint(0, 300, (3, 7))
    x = rng.randn(3, 4, 7, 32).astype(np.float32)
    cj, sj = jmha.rope_cos_sin(jnp.asarray(pos), 32, 10000.0)
    ct, st = tmha.rope_cos_sin(torch.from_numpy(pos), 32, 10000.0)
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), atol=ATOL)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), atol=ATOL)
    want = jmha.apply_rope(jnp.asarray(x), cj[:, None], sj[:, None])
    got = tmha.apply_rope(torch.from_numpy(x), ct[:, None], st[:, None])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_one_block_matches_jax(jax_llama):
    lm, _ = jax_llama
    cfg = lm.config
    rng = np.random.RandomState(3)
    x = rng.randn(2, 10, cfg.hidden_size).astype(np.float32)
    mask = np.ones((2, 10), np.int32)
    mask[1, 6:] = 0
    jb = JaxBlock(cfg)
    bias = jnp.where(jnp.asarray(mask)[:, None, None, :] > 0, 0.0, -1e9)
    params = jax.device_get(jb.init(jax.random.PRNGKey(4), jnp.asarray(x), bias)["params"])
    want = jb.apply({"params": params}, jnp.asarray(x), bias)
    blk = LlamaBlock(cfg, dtype=torch.float32, param_dtype=torch.float32).eval()
    blk.load_state_dict(_state_dict_from_jax(params, r"()block_(\d+)"))
    with torch.no_grad():
        got = blk(torch.from_numpy(x), torch.from_numpy(np.array(bias)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_from_jax_covers_every_parameter(jax_llama):
    _, params = jax_llama
    sd = blocks_state_dict_from_jax(params)
    own = load_model("llama-test", device="cpu").module.state_dict()
    assert set(sd) == set(own)
    k = params["block_1"]["self_attn"]["k_proj"]["kernel"]
    np.testing.assert_array_equal(sd["blocks.1.self_attn.k_proj.weight"].numpy(), k.T)
    assert tuple(sd["blocks.0.self_attn.k_proj.weight"].shape) == (2 * 16, 64)  # GQA


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_logits_match_jax(jax_llama, impl):
    lm, params = jax_llama
    tlm = _port(params, impl)
    ids, mask = _prompts()
    want = lm.module.apply({"params": params}, jnp.asarray(ids), jnp.asarray(mask))
    with torch.no_grad():
        got = tlm.module(torch.from_numpy(ids).long(), torch.from_numpy(mask))
    live = mask.astype(bool)
    np.testing.assert_allclose(got.numpy()[live], np.asarray(want)[live], atol=ATOL)


@pytest.mark.parametrize("impl", ["auto", "flash"])
def test_cached_prefill_and_decode_match_jax(jax_llama, impl):
    """Prefill of right-padded prompts into a (P + L)-wide cache, then 3
    greedy decode steps: rows write at P + t with RoPE position len + t;
    the last row is parked (its writes drop)."""
    lm, params = jax_llama
    tlm = _port(params, impl)
    ids, mask = _prompts()
    B, P = ids.shape
    L = 4
    cache_j, mask_j, lens_j, first_j = _causal_prefill(
        lm.module, params, jnp.asarray(ids), jnp.asarray(mask), L)
    with torch.no_grad():
        cache_t, mask_t, lens_t, first_t = causal_prefill(
            tlm.module, torch.from_numpy(ids).long(), torch.from_numpy(mask), L)
    np.testing.assert_array_equal(lens_t.numpy(), np.asarray(lens_j))
    np.testing.assert_array_equal(mask_t.numpy(), np.asarray(mask_j))
    np.testing.assert_allclose(first_t.numpy(), np.asarray(first_j), atol=ATOL)
    for c, jc in zip(cache_t, (cache_j[f"block_{i}"]["self_attn"] for i in range(len(cache_t)))):
        np.testing.assert_allclose(c.k.numpy(), np.asarray(jc["cached_key"]), atol=ATOL)
        np.testing.assert_allclose(c.v.numpy(), np.asarray(jc["cached_value"]), atol=ATOL)
    last = np.asarray(jnp.argmax(first_j, axis=-1)).astype(np.int32)
    full = np.asarray(mask_j).copy()
    active = np.array([True, True, True, False])
    for t in range(3):
        offs = np.where(active, P + t, P + L).astype(np.int32)
        rope = (np.asarray(lens_j) + t).astype(np.int32)
        rows = np.nonzero(active)[0]
        full[rows, offs[rows]] = 1
        logits_j, mut = lm.module.apply(
            {"params": params, "cache": cache_j}, jnp.asarray(last)[:, None], jnp.asarray(full),
            use_cache=True, positions=jnp.asarray(rope)[:, None],
            cache_positions=jnp.asarray(offs), mutable=["cache"])
        cache_j = mut["cache"]
        with torch.no_grad():
            logits_t = tlm.module(
                torch.from_numpy(last).long()[:, None], torch.from_numpy(full),
                positions=torch.from_numpy(rope).long()[:, None], cache=cache_t,
                cache_positions=torch.from_numpy(offs))
        np.testing.assert_allclose(logits_t.numpy()[active], np.asarray(logits_j)[active],
                                   atol=ATOL)
        last = np.asarray(jnp.argmax(logits_j[:, -1], axis=-1)).astype(np.int32)


def test_training_a_causal_model_raises_before_building_it():
    """A causal model trains now; what it refuses, it refuses before a
    7B model is built: an unknown remat policy, and the fused loss for a
    seq2seq family."""
    with pytest.raises(ValueError, match="remat_policy"):
        load_model("llama-2-7b", device="cpu", train=True, remat=True, remat_policy="all")
    with pytest.raises(ValueError, match="seq2seq"):
        load_model("bart-large-cnn", device="cpu", train=True, fused_ce=True)
    lm = load_model("llama-test", device="cpu", train=True, remat=True, fused_ce=True)
    assert lm.module.training and lm.module.remat_policy == "full" and lm.config.fused_ce
    assert all(p.dtype == torch.float32 for p in lm.module.parameters())


def test_mixtral_and_training_dropout_raise():
    """Mixtral still raises; residual dropout in training now runs the fused
    dropout at both residual adds (eval mode: a plain residual add)."""
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        load_model("mixtral-test", device="cpu")
    cfg = dataclasses.replace(LlamaConfig(vocab_size=32, hidden_size=16, intermediate_size=32,
                                          num_hidden_layers=1, num_attention_heads=2),
                              dropout_rate=0.1)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        LlamaForCausalLM(dataclasses.replace(cfg, num_experts=4))
    model = LlamaForCausalLM(cfg).eval()
    model.init_weights(torch.Generator().manual_seed(0))
    ids = torch.arange(8).reshape(1, 8) % 32
    plain = model(ids)  # eval mode: a plain residual add
    from distributed_llms_example_tpu_torch.ops.fused_dropout import (
        count_dropout_sites,
        dropout_seeds,
    )

    assert count_dropout_sites(model) == 2
    with dropout_seeds(torch.Generator().manual_seed(0)):
        dropped = model.train()(ids)
    assert dropped.shape == plain.shape and not torch.equal(dropped, plain)
