"""The attention-probs dropout branch of the port's flash attention (the
plain versions its kernel 1-4 wrappers run for CPU tensors, through the
autograd Function) against the JAX package's ``flash_attention(...,
dropout_rate, dropout_seed)`` with its Pallas kernels in interpret mode
(the counter-hash stream, ``hw_rng=False``), on the same numpy inputs: the
forward's o and lse, and ``jax.vjp`` for dq, dk, dv and the learned bias's
gradient.  Cases: a ragged padding mask, causal, 16 x 40
cross-attention, a learned bias (T5: scale 1) with padding and with
causal, ``-inf`` rows, rates 0.15 and 0.5, and negative int32 seeds.
fp32 at atol 2e-5, the JAX package's own dropout tests' limit (the JAX
side sums blockwise, the port in one pass).

Also: the keep-mask equals the JAX ``hash_keep_mask`` of each (b, h)
plane bit for bit; rate 0 gives the no-dropout result exactly; a missing
seed or a rate outside [0, 1) raises; the plain route keeps 1 - rate of
the probs, within 1e-2, as the JAX package's plain route does (its bits
come from ``jax.random``, so only the fraction and the scaling compare)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llms_example_tpu.ops import attention as jatt
from distributed_llms_example_tpu.ops import flash_attention as jfa
from distributed_llms_example_tpu.ops.attention import NEG_INF
from distributed_llms_example_tpu.ops.fused_dropout import hash_keep_mask
from distributed_llms_example_tpu_torch.ops import attention as tatt
from distributed_llms_example_tpu_torch.ops import flash_attention as tfa
from distributed_llms_example_tpu_torch.ops.fused_dropout import attention_keep_mask

B, H, D = 2, 2, 16
SEED = 1234
DEAD = [0, 5, 47]
ATOL = 2e-5


@pytest.fixture(autouse=True)
def _no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _pad(K, lens):
    bias = np.where(np.arange(K)[None, :] < np.asarray(lens)[:, None], 0.0, NEG_INF)
    return bias.astype(np.float32)[:, None, None, :]


def _case(name, rng):
    """(q, k, v, do, bias, lbias, causal, scale, blocks) of one case."""
    Q = K = 64
    causal, bias, lbias, scale = False, None, None, None
    if name == "padding":
        bias = _pad(K, [K, 29])
    elif name == "causal":
        causal = True
    elif name == "cross":
        Q, K = 16, 40
        bias = _pad(K, [40, 17])
    elif name == "learned_bias":
        bias, scale = _pad(K, [50, K]), 1.0
        lbias = rng.randn(1, H, Q, K).astype(np.float32)
    elif name == "learned_bias_causal":
        causal, scale = True, 1.0
        lbias = rng.randn(1, H, Q, K).astype(np.float32)
    elif name == "dead_rows":
        bias = np.zeros((B, 1, Q, K), np.float32)
        bias[:, :, DEAD, :] = -np.inf
    qs = D ** -0.5 if scale == 1.0 else 1.0  # T5 carries 1/sqrt(d) in q
    q = (rng.randn(B, H, Q, D) * qs).astype(np.float32)
    k, v = (rng.randn(B, H, K, D).astype(np.float32) for _ in range(2))
    do = rng.randn(B, H, Q, D).astype(np.float32)
    # 8-aligned tiles that divide each length, smaller than it where they
    # can be, so the JAX kernels draw the mask tile by tile
    blocks = (16 if Q == 16 else 32, 40 if K == 40 else 32)
    return q, k, v, do, bias, lbias, causal, scale, blocks


def _jax(q, k, v, do, bias, lbias, causal, scale, blocks, rate, seed):
    """(o, lse, dq, dk, dv, dlbias) of the JAX kernels in interpret mode."""
    jb = None if bias is None else jnp.asarray(bias)
    s = scale if scale is not None else D ** -0.5
    kw = dict(causal=causal, block_q=blocks[0], block_k=blocks[1], interpret=True)

    def f(q, k, v, lb):
        return jfa.flash_attention(q, k, v, jb, learned_bias=lb, scale=s, dropout_rate=rate,
                                   dropout_seed=seed, **kw)

    args = [jnp.asarray(x) for x in (q, k, v)]
    lb = None if lbias is None else jnp.asarray(lbias)
    o, vjp = jax.vjp(f, *args, lb)
    grads = vjp(jnp.asarray(do))
    _, lse = jfa._fwd(*args, jb, lb, scale=s, causal=causal, block_q=blocks[0],
                      block_k=blocks[1], interpret=True, dropout_rate=rate,
                      dropout_seed=None if rate == 0 else jnp.asarray(seed, jnp.int32).reshape(1))
    return [np.asarray(o), np.asarray(lse)[..., 0]] + [
        None if g is None else np.asarray(g) for g in grads]


def _port(q, k, v, do, bias, lbias, causal, scale, rate, seed):
    """(o, lse, dq, dk, dv, dlbias) through the port's autograd Function."""
    ts = [torch.tensor(x, requires_grad=True) for x in (q, k, v)]
    tlb = None if lbias is None else torch.tensor(lbias, requires_grad=True)
    tb = None if bias is None else torch.tensor(bias)
    o, lse = tfa.flash_attention(*ts, tb, learned_bias=tlb, causal=causal, scale=scale,
                                 return_lse=True, dropout_rate=rate, dropout_seed=seed)
    o.backward(torch.tensor(do))
    return [o.detach().numpy(), lse.numpy()] + [
        None if t is None else t.grad.numpy() for t in (*ts, tlb)]


CASES = [("padding", 0.15, SEED), ("causal", 0.15, SEED), ("cross", 0.15, SEED),
         ("learned_bias", 0.15, SEED), ("learned_bias_causal", 0.5, SEED),
         ("dead_rows", 0.15, SEED), ("padding", 0.5, -123456789), ("causal", 0.5, -7),
         ("learned_bias", 0.5, -(2**31))]


@pytest.mark.parametrize("name,rate,seed", CASES)
def test_port_dropout_matches_jax_kernels(name, rate, seed):
    case = _case(name, np.random.RandomState(sum(map(ord, name))))
    want = _jax(*case, rate, seed)
    got = _port(*case[:8], rate, seed)
    for what, g, w in zip(("o", "lse", "dq", "dk", "dv", "dlbias"), got, want):
        if w is None:
            assert g is None, what
            continue
        np.testing.assert_allclose(g, w, atol=ATOL, rtol=0, err_msg=f"{name} {what}")
    o, lse, dq = got[:3]
    if name == "dead_rows":
        # rows with no live key: o = 0, lse = MASK_VALUE, no gradient
        assert (o[:, :, DEAD] == 0).all() and (dq[:, :, DEAD] == 0).all()
        assert (lse[:, :, DEAD] == tfa.MASK_VALUE).all()
    if got[5] is not None and case[6]:
        # the learned bias's gradient is exactly 0 above the causal diagonal
        assert (np.triu(got[5][0], k=1) == 0).all()


@pytest.mark.parametrize("seed,shape,rate", [(SEED, (2, 3, 40, 72), 0.1),
                                             (-5, (1, 2, 17, 33), 0.5),
                                             (2**31 - 1, (3, 1, 8, 8), 0.9)])
def test_keep_mask_is_the_jax_hash_per_plane(seed, shape, rate):
    got = attention_keep_mask(seed, shape, rate).numpy()
    jseed = jnp.asarray(seed, jnp.int32)  # as the kernels hold it
    want = np.stack([np.stack([np.asarray(hash_keep_mask(jseed, shape[2:], rate, tag_a=b,
                                                         tag_b=h))
                               for h in range(shape[1])]) for b in range(shape[0])])
    assert got.dtype == np.bool_ and (got == want).all()


def test_rate_zero_is_the_no_dropout_result_exactly():
    q, k, v, do, bias, lbias, causal, scale, _ = _case("learned_bias", np.random.RandomState(3))
    base = _port(q, k, v, do, bias, lbias, causal, scale, 0.0, None)
    zero = _port(q, k, v, do, bias, lbias, causal, scale, 0.0, SEED)
    for a, b in zip(base, zero):
        assert np.array_equal(a, b)


def test_dropout_changes_the_result_and_is_deterministic():
    case = _case("padding", np.random.RandomState(4))[:8]
    a = _port(*case, 0.15, SEED)
    b = _port(*case, 0.15, SEED)
    c = _port(*case, 0.15, SEED + 1)
    assert all(np.array_equal(x, y) for x, y in zip(a, b) if x is not None)
    assert not np.array_equal(a[0], c[0]) and not np.array_equal(a[2], c[2])


@pytest.mark.parametrize("rate,seed", [(0.1, None), (1.0, SEED), (-0.1, SEED), (0.1, 2**31)])
def test_bad_dropout_arguments_raise(rate, seed):
    q = torch.zeros(1, 1, 16, 16)
    for fn in (lambda: tfa.flash_attention(q, q, q, dropout_rate=rate, dropout_seed=seed),
               lambda: tfa.flash_attention_plain(q, q, q, dropout_rate=rate, dropout_seed=seed),
               lambda: tatt.dot_product_attention(q, q, q, dropout_rate=rate,
                                                  dropout_seed=seed)):
        with pytest.raises(ValueError):
            fn()


def test_jax_refuses_a_missing_seed_too():
    q = jnp.zeros((1, 1, 16, 16))
    with pytest.raises(ValueError):
        jfa.flash_attention(q, q, q, dropout_rate=0.1, interpret=True)


@pytest.mark.parametrize("rate", [0.1, 0.3])
def test_plain_route_keeps_one_minus_rate(rate):
    """With V the identity (K = d), o is the dropped probs themselves: the
    kept fraction is within 1e-2 of 1 - rate on both packages' plain
    routes, and every kept entry is the undropped prob times 1 / (1 - rate)
    (to fp32 rounding)."""
    rng = np.random.RandomState(5)
    Bq, Hq, S = 4, 4, 64
    q, k = (rng.randn(Bq, Hq, S, S).astype(np.float32) * 0.3 for _ in range(2))
    v = np.broadcast_to(np.eye(S, dtype=np.float32), (Bq, Hq, S, S)).copy()
    probs = np.asarray(jatt.dot_product_attention(jnp.asarray(q), jnp.asarray(k),
                                                  jnp.asarray(v)))
    port = tatt.dot_product_attention(torch.tensor(q), torch.tensor(k), torch.tensor(v),
                                      dropout_rate=rate, dropout_seed=SEED).numpy()
    ref = np.asarray(jatt.dot_product_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                                dropout_rate=rate,
                                                dropout_rng=jax.random.PRNGKey(0)))
    for out in (port, ref):
        kept = out != 0
        assert abs(kept.mean() - (1 - rate)) < 1e-2
        np.testing.assert_allclose(out[kept], probs[kept] / (1 - rate), rtol=1e-5)
    keep = attention_keep_mask(SEED, (Bq, Hq, S, S), rate).numpy()
    assert np.array_equal(port != 0, keep)
