"""The port's static generation (``evaluation/generation.py``) against the
JAX package's on the same weights (moved across with
``models/from_jax.py``), fp32 on the CPU, the JAX generators run as
``tests/test_generation.py`` runs them: greedy and beam-2 tokens equal on
``bart-test``, ``t5-test`` and ``llama-test`` (right-padded rows, the
port's plain path and its kernel path, whose wrappers run their plain
versions for CPU tensors); BART's forced BOS/EOS; ``_beam_step_select``
bit-equal to JAX's in its whole state, chosen tokens and parents when fed
the same log-probs, exact ties and -1e7 rows included;
``beam_grouped_attention`` within 1e-6 of JAX's, with and without a bias
and a learned bias, and the GQA cross-attention that repeats K/V per beam
within 1e-6 of the JAX module."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llms_example_tpu.evaluation import generation as jgen
from distributed_llms_example_tpu.models.registry import load_model as jax_load_model
from distributed_llms_example_tpu.ops.attention import beam_grouped_attention as jax_bga
from distributed_llms_example_tpu.ops.mha import MultiHeadAttention as JaxMHA
from distributed_llms_example_tpu_torch.evaluation import generation as gen
from distributed_llms_example_tpu_torch.models.from_jax import (
    blocks_state_dict_from_jax,
    load_jax_params,
)
from distributed_llms_example_tpu_torch.models.registry import load_model
from distributed_llms_example_tpu_torch.ops.attention import beam_grouped_attention
from distributed_llms_example_tpu_torch.ops.mha import MultiHeadAttention

L = 12
MODELS = ["bart-test", "t5-test", "llama-test"]


@pytest.fixture(autouse=True)
def _no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@pytest.fixture(scope="module", params=MODELS)
def pair(request):
    lm = jax_load_model(request.param)
    params = jax.device_get(lm.init_params(0))
    return request.param, lm, params


def _port(name, params, impl):
    tlm = load_model(name, device="cpu", attention_impl=impl)
    load_jax_params(tlm.module, params)
    return tlm


def _inputs(b=3, s=10, seed=3):
    rng = np.random.RandomState(seed)
    ids = rng.randint(3, 250, (b, s)).astype(np.int32)
    mask = np.ones((b, s), np.int32)
    mask[1, -4:] = 0  # right padding: a ragged row
    mask[2, -7:] = 0
    ids = np.where(mask > 0, ids, 0).astype(np.int32)
    return ids, mask


def _jax_generate(lm, params, ids, mask, beams):
    if lm.is_seq2seq:
        fn = (jgen.make_greedy_generate(lm.module, lm.config, L) if beams == 1
              else jgen.make_beam_search(lm.module, lm.config, L, num_beams=beams))
    else:
        fn = (jgen.make_causal_greedy(lm.module, lm.config, L) if beams == 1
              else jgen.make_causal_beam_search(lm.module, lm.config, L, num_beams=beams))
    return np.asarray(fn(params, jnp.asarray(ids), jnp.asarray(mask)))


def _port_generate(tlm, ids, mask, beams):
    cls = gen.Seq2SeqGenerator if tlm.is_seq2seq else gen.CausalGenerator
    out = cls(tlm.module, tlm.config, L, num_beams=beams).run(
        torch.from_numpy(ids).long(), torch.from_numpy(mask).long())
    return out.numpy()


@pytest.mark.parametrize("impl", ["auto", "flash"])
@pytest.mark.parametrize("beams", [1, 2])
def test_tokens_equal_jax(pair, beams, impl):
    name, lm, params = pair
    ids, mask = _inputs()
    want = _jax_generate(lm, params, ids, mask, beams)
    got = _port_generate(_port(name, params, impl), ids, mask, beams)
    assert got.shape == want.shape == (3, L)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("beams", [1, 2])
def test_bart_forced_bos_and_eos(beams):
    """bart-test sets forced_bos_token_id 0 and forced_eos_token_id 2: the
    first token is BOS in every row, and a row that has not stopped ends in
    EOS at the last step; both as in JAX."""
    lm = jax_load_model("bart-test")
    params = jax.device_get(lm.init_params(1))
    assert (lm.config.forced_bos_token_id, lm.config.forced_eos_token_id) == (0, 2)
    ids, mask = _inputs(seed=5)
    want = _jax_generate(lm, params, ids, mask, beams)
    got = _port_generate(_port("bart-test", params, "auto"), ids, mask, beams)
    np.testing.assert_array_equal(got, want)
    assert (got[:, 0] == 0).all()
    for row in got:
        toks = row.tolist()
        assert 2 in toks  # the forced eos at the last step, or an earlier stop
        assert all(t == lm.config.pad_token_id for t in toks[toks.index(2) + 1:])


def _state_np(state):
    return [np.asarray(x) for x in state]


def _check_state(a, b):
    for x, y in zip(_state_np(a), _state_np(b)):
        assert x.shape == y.shape
        if x.dtype.kind == "f":
            np.testing.assert_array_equal(x.view(np.int32), y.astype(np.float32).view(np.int32))
        else:
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("len_offset", [0, 5])
def test_beam_step_select_bit_equal(len_offset):
    """Five chained selections fed the same log-probs: quantized so that
    candidates tie exactly, eos among the leaders (banking, a done row),
    and a row whose log-probs sit near -1e7; every step's state, chosen
    tokens and parents equal JAX's bit for bit."""
    B, K, V, steps, eos, pad = 4, 2, 16, 5, 1, 0
    rng = np.random.RandomState(11)
    jstate = jgen._beam_init(B, K, steps, pad)
    tstate = gen._beam_init(B, K, steps, pad)
    _check_state(tstate, jstate)
    for t in range(steps):
        x = rng.randn(B * K, V).astype(np.float32)
        x = np.round(x * 2) / 2  # ties inside and across beams
        x[(t % B) * K : (t % B) * K + K, eos] = 8.0  # eos leads one row
        logp = np.array(jax.nn.log_softmax(jnp.asarray(x), axis=-1))
        logp[-K:] += np.float32(gen.NEG_INF)  # the last row's sums round to whole numbers
        jstate, jtok, jpar = jgen._beam_step_select(
            jnp.asarray(logp), t, jstate, eos=eos, K=K, length_penalty=1.0,
            len_offset=len_offset)
        tstate, ttok, tpar = gen._beam_step_select(
            torch.from_numpy(logp), t, tstate, eos=eos, K=K, length_penalty=1.0,
            len_offset=len_offset)
        _check_state(tstate, jstate)
        np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
        np.testing.assert_array_equal(tpar.numpy(), np.asarray(jpar))
    assert np.asarray(jstate[4]).any()  # some row finished: the banking path ran
    np.testing.assert_array_equal(gen._beam_finalize(tstate, steps + 1 + len_offset, 1.0).numpy(),
                                  np.asarray(jgen._beam_finalize(jstate, steps + 1 + len_offset,
                                                                 1.0)))


def test_top_k_ranks_ties_lower_index_first():
    x = torch.tensor([[1.0, 3.0, 3.0, 2.0, 3.0, -1e7, -1e7]])
    values, idx = gen._top_k(x, 5)
    jv, ji = jax.lax.top_k(jnp.asarray(x.numpy()), 5)
    assert idx.tolist() == [[1, 2, 4, 3, 0]] == np.asarray(ji).tolist()
    assert values.tolist() == np.asarray(jv).tolist()


@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("with_lbias", [False, True])
@pytest.mark.parametrize("scale", [None, 1.0])
def test_beam_grouped_attention_matches_jax(with_bias, with_lbias, scale):
    B, G, H, Q, Kl, d = 3, 2, 4, 1, 9, 8
    rng = np.random.RandomState(2)
    q = rng.randn(B * G, H, Q, d).astype(np.float32)
    k = rng.randn(B, H, Kl, d).astype(np.float32)
    v = rng.randn(B, H, Kl, d).astype(np.float32)
    bias = lbias = None
    if with_bias:  # a per-beam padding mask, as the decoder repeats it
        m = np.ones((B, Kl), np.float32)
        m[1, -3:] = 0
        bias = np.repeat(np.where(m > 0, 0.0, -1e9).astype(np.float32)[:, None, None, :], G, 0)
    if with_lbias:
        lbias = rng.randn(1, H, Q, Kl).astype(np.float32)

    def j(x):
        return None if x is None else jnp.asarray(x)

    def t(x):
        return None if x is None else torch.from_numpy(x)

    want = np.asarray(jax_bga(j(q), j(k), j(v), j(bias), scale=scale, learned_bias=j(lbias)))
    got = beam_grouped_attention(t(q), t(k), t(v), t(bias), scale=scale,
                                 learned_bias=t(lbias)).numpy()
    assert got.shape == (B * G, H, Q, d)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("kv_heads", [4, 2])
def test_beam_cross_attention_module_matches_jax(kv_heads):
    """The attention module's beam branch: B·G query rows against cross
    K/V of B rows, folded next to the heads (kv_heads == heads) or with
    K/V repeated per beam (GQA), within 1e-6 of the JAX module."""
    B, G, H, d, D, S = 2, 2, 4, 8, 32, 7
    jm = JaxMHA(num_heads=H, head_dim=d, model_dim=D, num_kv_heads=kv_heads)
    rng = np.random.RandomState(4)
    hid = rng.randn(B * G, 1, D).astype(np.float32)
    enc = rng.randn(B, S, D).astype(np.float32)
    params = jax.device_get(jm.init(jax.random.PRNGKey(0), jnp.asarray(hid[:B]),
                                    jnp.asarray(enc))["params"])
    m = np.ones((B, S), np.int32)
    m[1, -2:] = 0
    bias = np.repeat(np.where(m > 0, 0.0, -1e9).astype(np.float32)[:, None, None, :], G, 0)
    ckv = jm.apply({"params": params}, jnp.asarray(enc), method="project_kv")
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(hid), bias=jnp.asarray(bias),
                               cross_kv=ckv))
    tm = MultiHeadAttention(H, d, D, num_kv_heads=kv_heads)
    tm.load_state_dict(blocks_state_dict_from_jax(params))
    with torch.no_grad():
        tckv = tm.project_kv(torch.from_numpy(enc))
        got = tm(torch.from_numpy(hid), bias=torch.from_numpy(bias), cross_kv=tckv).numpy()
        # the same as the un-grouped path over K/V repeated per beam
        rep = tuple(x.repeat_interleave(G, dim=0) for x in tckv)
        full = tm(torch.from_numpy(hid), bias=torch.from_numpy(bias), cross_kv=rep).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    np.testing.assert_allclose(got, full, atol=1e-6, rtol=0)


def test_gather_beams_reorders_rows_and_keeps_the_index():
    from distributed_llms_example_tpu_torch.ops.mha import KVCache

    k = torch.arange(4 * 2 * 3 * 1, dtype=torch.float32).reshape(4, 2, 3, 1)
    c = KVCache(k.clone(), -k.clone(), index=2)
    gen._gather_beams([c], torch.tensor([[1, 1], [0, 1]]), 2, 2)
    assert c.index == 2
    assert torch.equal(c.k, k[[1, 1, 2, 3]]) and torch.equal(c.v, -k[[1, 1, 2, 3]])
