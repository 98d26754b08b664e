"""The port's T5 against the JAX package's on the same weights (moved across
with ``models/from_jax.py``), for ``t5-test`` (relu FFN, tied head) and a
gated-gelu, untied variant of it (flan-T5's branches): every parameter is
covered; encoder hidden states, cross-attention K/V and teacher-forced
logits; cached decode steps at per-row offsets (slots at different
positions, one idle slot parked at L), which carry a per-row relative
bias; the gradients of both bucket tables and of every other parameter.
fp32; activations and logits at atol 1e-4 (as the BART port's test),
gradients at atol 1e-6.  The port runs its plain path ("xla") and its
kernel path ("flash", whose wrappers run their plain versions on the CPU).
Also: the bucket ids equal the JAX function's at every relative position
in [-2048, 2048], both directions."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llms_example_tpu.evaluation.generation import _init_cache
from distributed_llms_example_tpu.models.registry import LoadedModel as JaxLoadedModel
from distributed_llms_example_tpu.models.registry import T5_CONFIGS as JAX_T5_CONFIGS
from distributed_llms_example_tpu.models.t5 import T5ForConditionalGeneration as JaxT5
from distributed_llms_example_tpu.models.t5 import relative_position_bucket as jax_bucket
from distributed_llms_example_tpu_torch.evaluation.generation import init_cache
from distributed_llms_example_tpu_torch.models.from_jax import blocks_state_dict_from_jax, load_jax_params
from distributed_llms_example_tpu_torch.models.registry import T5_CONFIGS
from distributed_llms_example_tpu_torch.models.t5 import (
    T5ForConditionalGeneration,
    relative_position_bucket,
)

ATOL = 1e-4
B, S, T, L = 4, 32, 16, 16
VARIANTS = {"t5-test": {},
            "t5-test-gated": dict(feed_forward_proj="gated-gelu", tie_word_embeddings=False)}


@pytest.fixture(autouse=True)
def _no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@pytest.fixture(scope="module", params=list(VARIANTS))
def jax_t5(request):
    cfg = dataclasses.replace(JAX_T5_CONFIGS["t5-test"], **VARIANTS[request.param])
    lm = JaxLoadedModel("t5", cfg, JaxT5(cfg), None)
    return request.param, lm, jax.device_get(lm.init_params(0))


def _port(variant, params, impl):
    cfg = dataclasses.replace(T5_CONFIGS["t5-test"], attention_impl=impl, **VARIANTS[variant])
    model = T5ForConditionalGeneration(cfg).eval()
    load_jax_params(model, params)
    return model


def _inputs():
    rng = np.random.RandomState(0)
    ids = rng.randint(2, 256, (B, S)).astype(np.int32)
    lens = np.array([S, 20, 7, 1])
    mask = (np.arange(S)[None, :] < lens[:, None]).astype(np.int32)
    dec_ids = rng.randint(2, 256, (B, T)).astype(np.int32)
    return ids, mask, dec_ids


def test_from_jax_covers_every_parameter(jax_t5):
    variant, _, params = jax_t5
    sd = blocks_state_dict_from_jax(params)
    own = _port(variant, params, "xla").state_dict()
    assert set(sd) == set(own)
    k = params["encoder"]["block_1"]["self_attn"]["q_proj"]["kernel"]
    np.testing.assert_array_equal(sd["encoder.blocks.1.self_attn.q_proj.weight"].numpy(), k.T)
    table = params["decoder"]["relative_attention_bias"]["embedding"]
    np.testing.assert_array_equal(sd["decoder.relative_attention_bias.weight"].numpy(), table)
    gated = variant == "t5-test-gated"
    assert ("lm_head.weight" in sd) == gated
    assert ("decoder.blocks.0.mlp.wi_0.weight" in sd) == gated


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_encode_cross_kv_and_logits_match_jax(jax_t5, impl):
    variant, lm, params = jax_t5
    model = _port(variant, params, impl)
    ids, mask, dec_ids = _inputs()
    v = {"params": params}
    enc_j = lm.module.apply(v, jnp.asarray(ids), jnp.asarray(mask), method="encode")
    ckv_j = lm.module.apply(v, enc_j, method="cross_kv")
    logits_j = lm.module.apply(v, jnp.asarray(ids), jnp.asarray(mask), jnp.asarray(dec_ids))
    with torch.no_grad():
        enc_t = model.encode(torch.from_numpy(ids), torch.from_numpy(mask))
        ckv_t = model.cross_kv(enc_t)
        logits_t = model(torch.from_numpy(ids), torch.from_numpy(mask), torch.from_numpy(dec_ids))
    np.testing.assert_allclose(enc_t.numpy(), np.asarray(enc_j), atol=ATOL)
    assert len(ckv_t) == len(ckv_j)
    for (kt, vt), (kj, vj) in zip(ckv_t, ckv_j):
        np.testing.assert_allclose(kt.numpy(), np.asarray(kj), atol=ATOL)
        np.testing.assert_allclose(vt.numpy(), np.asarray(vj), atol=ATOL)
    np.testing.assert_allclose(logits_t.numpy(), np.asarray(logits_j), atol=ATOL)


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_cached_decode_per_row_offsets_match_jax(jax_t5, impl):
    variant, lm, params = jax_t5
    model = _port(variant, params, impl)
    ids, mask, _ = _inputs()
    v = {"params": params}
    enc_j = lm.module.apply(v, jnp.asarray(ids), jnp.asarray(mask), method="encode")
    ckv_j = lm.module.apply(v, enc_j, method="cross_kv")
    cache_j = _init_cache(lm.module, params, B, L, enc_j, jnp.asarray(mask))
    with torch.no_grad():
        enc_t = model.encode(torch.from_numpy(ids), torch.from_numpy(mask))
        ckv_t = model.cross_kv(enc_t)
    cache_t = init_cache(model, B, L, device="cpu")
    # slots at different positions; the last slot idles parked at L
    base = np.array([0, 3, 9, L])
    rng = np.random.RandomState(2)
    for t in range(5):
        offs = np.where(base < L, base + t, L).astype(np.int32)
        tok = rng.randint(2, 256, (B, 1)).astype(np.int32)
        logits_j, mut = lm.module.apply(
            {"params": params, "cache": cache_j}, jnp.asarray(tok), enc_j, jnp.asarray(mask),
            use_cache=True, cache_offset=jnp.asarray(offs), max_kv_len=L, cross_kv=ckv_j,
            method="decode", mutable=["cache"],
        )
        cache_j = mut["cache"]
        with torch.no_grad():
            logits_t = model.decode(
                torch.from_numpy(tok), None, torch.from_numpy(mask), cache=cache_t,
                cache_offset=torch.from_numpy(offs), cross_kv=ckv_t,
            )
        np.testing.assert_allclose(logits_t.numpy(), np.asarray(logits_j), atol=ATOL)
    # the caches hold the same K/V, and the parked slot wrote nothing
    for i, c in enumerate(cache_t):
        kj = np.asarray(cache_j["decoder"][f"block_{i}"]["self_attn"]["cached_key"])
        np.testing.assert_allclose(c.k.numpy(), kj, atol=ATOL)
        assert not c.k[B - 1].any()


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_gradients_incl_bucket_tables_match_jax_grad(jax_t5, impl):
    variant, lm, params = jax_t5
    model = _port(variant, params, impl)
    ids, mask, dec_ids = _inputs()

    def f(p):
        logits = lm.module.apply({"params": p}, jnp.asarray(ids), jnp.asarray(mask),
                                 jnp.asarray(dec_ids))
        return jnp.mean(logits.astype(jnp.float32) ** 2)

    loss_j, grads_j = jax.value_and_grad(f)(params)
    want = blocks_state_dict_from_jax(jax.device_get(grads_j))
    loss = (model(torch.from_numpy(ids), torch.from_numpy(mask),
                  torch.from_numpy(dec_ids)).float() ** 2).mean()
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(loss_j), rtol=1e-5)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), rtol=0, atol=1e-6,
                                   err_msg=name)
    for stack in ("encoder", "decoder"):
        g = dict(model.named_parameters())[f"{stack}.relative_attention_bias.weight"].grad
        assert g.abs().sum() > 0, f"{stack}: zero bucket-table gradient"


@pytest.mark.parametrize("bidirectional", [True, False])
def test_relative_position_bucket_ids_equal_jax(bidirectional):
    rel = np.arange(-2048, 2049)
    want = np.asarray(jax_bucket(jnp.asarray(rel, jnp.int32), bidirectional=bidirectional,
                                 num_buckets=32, max_distance=128))
    got = relative_position_bucket(torch.from_numpy(rel), bidirectional=bidirectional,
                                   num_buckets=32, max_distance=128)
    # distances 16, 32, 64 and 128 make the log ratio an integer in exact
    # arithmetic: there a one-ulp log would move an id
    np.testing.assert_array_equal(got.numpy(), want)


def test_t5_attention_is_unscaled_and_probs_dropout_refuses_to_train():
    """T5's attention is unscaled on every path.  Its probs dropout, which
    training once refused, now trains: serving (eval mode) ignores it, a
    training forward applies it (and differs from eval) the same way for
    the same seed stream."""
    from distributed_llms_example_tpu_torch.ops.fused_dropout import dropout_seeds

    cfg = dataclasses.replace(T5_CONFIGS["t5-test"], attn_dropout_rate=0.1, dropout_rate=0.0)
    model = T5ForConditionalGeneration(cfg)
    model.init_weights(torch.Generator().manual_seed(0))
    assert {m.scale for m in model.modules() if hasattr(m, "scale")} == {1.0}
    ids = torch.randint(2, 256, (2, 16))
    served = model.eval()(ids, None, ids)  # serving ignores it, as eval mode does
    assert torch.equal(served, model(ids, None, ids))
    runs = []
    for _ in range(2):
        with dropout_seeds(torch.Generator().manual_seed(1)):
            runs.append(model.train()(ids, None, ids))
    assert torch.equal(runs[0], runs[1]) and not torch.equal(runs[0], served)
