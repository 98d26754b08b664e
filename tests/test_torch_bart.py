"""The port's BART against the JAX package's on the same ``bart-test``
weights (moved across with ``models/from_jax.py``): encoder hidden states,
cross-attention K/V, teacher-forced logits, and the logits of cached decode
steps at per-row offsets (slots at different positions, one idle slot
parked at L).  fp32; atol 1e-4.  The port runs both its plain path
("xla") and its kernel path ("flash", whose wrappers run their plain
versions on the CPU)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llms_example_tpu.evaluation.generation import _init_cache
from distributed_llms_example_tpu.models.registry import load_model as jax_load_model
from distributed_llms_example_tpu_torch.evaluation.generation import init_cache
from distributed_llms_example_tpu_torch.models.from_jax import (
    bart_state_dict_from_jax,
    load_jax_params,
)
from distributed_llms_example_tpu_torch.models.registry import load_model

ATOL = 1e-4
B, S, L = 4, 32, 16


@pytest.fixture(autouse=True)
def _no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@pytest.fixture(scope="module")
def jax_bart():
    lm = jax_load_model("bart-test")
    return lm, jax.device_get(lm.init_params(0))


def _port(params, impl):
    tlm = load_model("bart-test", device="cpu", attention_impl=impl)
    load_jax_params(tlm.module, params)
    return tlm


def _inputs():
    rng = np.random.RandomState(0)
    ids = rng.randint(4, 256, (B, S)).astype(np.int32)
    lens = np.array([S, 20, 7, 1])
    mask = (np.arange(S)[None, :] < lens[:, None]).astype(np.int32)
    return ids, mask


def test_from_jax_covers_every_parameter(jax_bart):
    _, params = jax_bart
    sd = bart_state_dict_from_jax(params)
    own = load_model("bart-test", device="cpu").module.state_dict()
    assert set(sd) == set(own)
    k = params["encoder_block_0"]["self_attn"]["q_proj"]["kernel"]
    np.testing.assert_array_equal(sd["encoder_blocks.0.self_attn.q_proj.weight"].numpy(), k.T)


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_encode_cross_kv_and_logits_match_jax(jax_bart, impl):
    lm, params = jax_bart
    tlm = _port(params, impl)
    ids, mask = _inputs()
    v = {"params": params}
    enc_j = lm.module.apply(v, jnp.asarray(ids), jnp.asarray(mask), method="encode")
    ckv_j = lm.module.apply(v, enc_j, method="cross_kv")
    dec_ids = np.random.RandomState(1).randint(4, 256, (B, 8)).astype(np.int32)
    logits_j = lm.module.apply(v, jnp.asarray(ids), jnp.asarray(mask), jnp.asarray(dec_ids))
    with torch.no_grad():
        enc_t = tlm.module.encode(torch.from_numpy(ids), torch.from_numpy(mask))
        ckv_t = tlm.module.cross_kv(enc_t)
        logits_t = tlm.module(torch.from_numpy(ids), torch.from_numpy(mask),
                              torch.from_numpy(dec_ids))
    np.testing.assert_allclose(enc_t.numpy(), np.asarray(enc_j), atol=ATOL)
    assert len(ckv_t) == len(ckv_j)
    for (kt, vt), (kj, vj) in zip(ckv_t, ckv_j):
        np.testing.assert_allclose(kt.numpy(), np.asarray(kj), atol=ATOL)
        np.testing.assert_allclose(vt.numpy(), np.asarray(vj), atol=ATOL)
    np.testing.assert_allclose(logits_t.numpy(), np.asarray(logits_j), atol=ATOL)


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_cached_decode_per_row_offsets_match_jax(jax_bart, impl):
    lm, params = jax_bart
    tlm = _port(params, impl)
    ids, mask = _inputs()
    v = {"params": params}
    enc_j = lm.module.apply(v, jnp.asarray(ids), jnp.asarray(mask), method="encode")
    ckv_j = lm.module.apply(v, enc_j, method="cross_kv")
    cache_j = _init_cache(lm.module, params, B, L, enc_j, jnp.asarray(mask))
    with torch.no_grad():
        enc_t = tlm.module.encode(torch.from_numpy(ids), torch.from_numpy(mask))
        ckv_t = tlm.module.cross_kv(enc_t)
    cache_t = init_cache(tlm.module, B, L, device="cpu")
    # slots at different positions; the last slot idles parked at L
    base = np.array([0, 3, 9, L])
    rng = np.random.RandomState(2)
    for t in range(5):
        offs = np.where(base < L, base + t, L).astype(np.int32)
        tok = rng.randint(4, 256, (B, 1)).astype(np.int32)
        logits_j, mut = lm.module.apply(
            {"params": params, "cache": cache_j}, jnp.asarray(tok), enc_j, jnp.asarray(mask),
            use_cache=True, cache_offset=jnp.asarray(offs), max_kv_len=L, cross_kv=ckv_j,
            method="decode", mutable=["cache"],
        )
        cache_j = mut["cache"]
        with torch.no_grad():
            logits_t = tlm.module.decode(
                torch.from_numpy(tok), None, torch.from_numpy(mask), cache=cache_t,
                cache_offset=torch.from_numpy(offs), cross_kv=ckv_t,
            )
        np.testing.assert_allclose(logits_t.numpy(), np.asarray(logits_j), atol=ATOL)
    # the caches hold the same K/V, and the parked slot wrote nothing
    for i, c in enumerate(cache_t):
        kj = np.asarray(cache_j[f"decoder_block_{i}"]["self_attn"]["cached_key"])
        np.testing.assert_allclose(c.k.numpy(), kj, atol=ATOL)
        assert not c.k[B - 1].any()
