"""The learned-bias branch of the port's flash attention (the plain versions
its kernel 1-4 wrappers run for CPU tensors, through the autograd
Function) against the JAX package's ``flash_attention(...,
learned_bias=...)`` with its Pallas kernels in interpret mode, on the same
numpy inputs: the forward, and ``jax.vjp`` for dq, dk, dv and the learned
bias's gradient.  Cases: a ragged padding mask beside the learned bias,
causal, cross-attention without a learned bias, a length no 64-row tile
divides, and ``-inf`` rows whose learned-bias gradient must be exactly 0
(as must the causal upper triangle).  T5 attention is unscaled, so every
case runs at scale 1 with q drawn at T5's initial size.  fp32 at atol 1e-5 (the JAX side sums
blockwise, the port in one pass); bf16 at the chip check's bf16 limit,
2e-2.  The Function must also equal torch autograd through
``flash_attention_plain``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llms_example_tpu.ops import flash_attention as jfa
from distributed_llms_example_tpu.ops.attention import NEG_INF
from distributed_llms_example_tpu_torch.ops import flash_attention as tfa

B, H, D = 2, 2, 16
DEAD = [0, 5, 77]


@pytest.fixture(autouse=True)
def _no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _pad(K, lens):
    bias = np.where(np.arange(K)[None, :] < np.asarray(lens)[:, None], 0.0, NEG_INF)
    return bias.astype(np.float32)[:, None, None, :]


def _case(name, rng):
    """(q, k, v, do, bias, lbias, causal, block) of one case."""
    Q, K, causal, bias, with_lb, block = 128, 128, False, None, True, 64
    if name == "padding":
        bias = _pad(K, [K, 45])
    elif name == "causal":
        causal = True
    elif name == "cross":
        Q, with_lb = 32, False
        bias = _pad(K, [100, K])
    elif name == "ragged":
        Q = K = 80
        block = 16
        bias = _pad(K, [80, 33])
    elif name == "dead_rows":
        bias = np.zeros((B, 1, Q, K), np.float32)
        bias[:, :, DEAD, :] = -np.inf
    # T5 folds the 1/sqrt(d) of scaled attention into its q projection's
    # init: q carries it here, so the scores have their usual size
    q = (rng.randn(B, H, Q, D) * D ** -0.5).astype(np.float32)
    k, v = (rng.randn(B, H, K, D).astype(np.float32) for _ in range(2))
    do = rng.randn(B, H, Q, D).astype(np.float32)
    lbias = rng.randn(1, H, Q, K).astype(np.float32) if with_lb else None
    return q, k, v, do, bias, lbias, causal, block


CASES = ["padding", "causal", "cross", "ragged", "dead_rows"]


def _jax_run(q, k, v, do, bias, lbias, causal, block, dtype):
    jb = None if bias is None else jnp.asarray(bias)

    def f(q, k, v, lb):
        return jfa.flash_attention(q, k, v, jb, learned_bias=lb, causal=causal, scale=1.0,
                                   interpret=True, block_q=min(block, q.shape[2]),
                                   block_k=block)

    args = [jnp.asarray(x).astype(dtype) for x in (q, k, v)]
    lb = None if lbias is None else jnp.asarray(lbias).astype(dtype)
    o, vjp = jax.vjp(f, *args, lb)
    grads = vjp(jnp.asarray(do).astype(dtype))
    return [np.asarray(x.astype(jnp.float32)) if x is not None else None for x in (o, *grads)]


def _port_run(q, k, v, do, bias, lbias, causal, dtype):
    ts = [torch.from_numpy(x).to(dtype).requires_grad_(True) for x in (q, k, v)]
    lb = None if lbias is None else torch.from_numpy(lbias).to(dtype).requires_grad_(True)
    out = tfa.flash_attention(*ts, None if bias is None else torch.from_numpy(bias),
                              learned_bias=lb, causal=causal, scale=1.0)
    out.backward(torch.from_numpy(do).to(dtype))
    grads = [t.grad for t in (*ts, lb)] if lb is not None else [t.grad for t in ts] + [None]
    if lb is not None:
        assert lb.grad.dtype == dtype
    return [out.detach().float().numpy()] + [None if g is None else g.float().numpy()
                                             for g in grads]


NAMES = ("o", "dq", "dk", "dv", "dlbias")


@pytest.mark.parametrize("case", CASES)
def test_forward_and_vjp_fp32_match_jax(case):
    q, k, v, do, bias, lbias, causal, block = _case(case, np.random.RandomState(0))
    want = _jax_run(q, k, v, do, bias, lbias, causal, block, jnp.float32)
    got = _port_run(q, k, v, do, bias, lbias, causal, torch.float32)
    for name, g, w in zip(NAMES, got, want):
        if w is None:
            assert g is None, name
            continue
        np.testing.assert_allclose(g, w, atol=1e-5, err_msg=name)
    if case == "dead_rows":
        assert (got[4][:, :, DEAD] == 0).all() and (want[4][:, :, DEAD] == 0).all()
    if case == "causal":
        upper = np.triu(np.ones(q.shape[2], bool), 1)
        assert (got[4][:, :, upper] == 0).all()


@pytest.mark.parametrize("case", ["padding", "causal", "ragged"])
def test_forward_and_vjp_bf16_match_jax(case):
    q, k, v, do, bias, lbias, causal, block = _case(case, np.random.RandomState(1))
    want = _jax_run(q, k, v, do, bias, lbias, causal, block, jnp.bfloat16)
    got = _port_run(q, k, v, do, bias, lbias, causal, torch.bfloat16)
    for name, g, w in zip(NAMES, got, want):
        np.testing.assert_allclose(g, w, atol=2e-2, rtol=2e-2, err_msg=name)


@pytest.mark.parametrize("case", ["padding", "causal", "ragged", "dead_rows"])
def test_function_equals_autograd_through_the_plain_forward(case):
    q, k, v, do, bias, lbias, causal, _ = _case(case, np.random.RandomState(2))
    tb = None if bias is None else torch.from_numpy(bias)
    got = _port_run(q, k, v, do, bias, lbias, causal, torch.float32)
    ts = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v, lbias)]
    o, _ = tfa.flash_attention_plain(*ts[:3], tb, lbias=ts[3], causal=causal, scale=1.0)
    o.backward(torch.from_numpy(do))
    live = np.ones(q.shape[2], bool)
    if case == "dead_rows":
        # autograd through the plain softmax divides 0/1 on a dead row; the
        # kernels' sentinel gives exactly 0 (checked against JAX above)
        live[DEAD] = False
    for name, g, t in zip(NAMES[1:], got[1:], ts):
        w = t.grad.numpy()
        if name in ("dq", "dlbias"):
            g, w = g[:, :, live], w[:, :, live]
        np.testing.assert_allclose(g, w, atol=1e-5, err_msg=name)


def test_dlbias_wrapper_equals_its_plain_version_and_keeps_the_dtype():
    q, k, v, do, bias, lbias, _, _ = _case("padding", np.random.RandomState(3))
    q, k, v, do = (torch.from_numpy(x) for x in (q, k, v, do))
    tb, lb = torch.from_numpy(bias), torch.from_numpy(lbias)
    o, lse = tfa.flash_attention(q, k, v, tb, learned_bias=lb, scale=1.0, return_lse=True)
    delta = tfa.attention_delta(do, o)
    kw = dict(causal=False, scale=1.0)
    got = tfa.flash_bwd_dlbias(q, k, v, tb, lb, do, lse, delta, **kw)
    assert torch.equal(got, tfa._dlbias_plain(q, k, v, tb, lb, do, lse, delta, **kw))
    assert got.shape == lb.shape and got.dtype == torch.float32
    lb16 = lb.to(torch.bfloat16)
    half = tfa.flash_bwd_dlbias(q, k, v, tb, lb16, do, lse, delta, **kw)
    assert half.dtype == torch.bfloat16
    np.testing.assert_allclose(half.float().numpy(), got.numpy(), atol=2e-2, rtol=2e-2)
    # no learned bias asks for no gradient: serving never reaches kernel 4
    tfa.flash_bwd_dlbias.launches = 0
    with torch.no_grad():
        tfa.flash_attention(q, k, v, tb, learned_bias=lb, scale=1.0)
    assert tfa.flash_bwd_dlbias.launches == 0


def test_learned_bias_shape_is_checked():
    x = torch.zeros(2, 2, 32, 16)
    with pytest.raises(ValueError, match="exactly"):
        tfa.flash_attention(x, x, x, learned_bias=torch.zeros(2, 2, 32, 32))
    lse = torch.zeros(2, 2, 32)
    with pytest.raises(ValueError, match="expected a CUDA device"):
        tfa._bwd_cuda("flash_bwd_dlbias", x, x, x, None, x, lse, lse, (x,), causal=False,
                      scale=1.0, lbias=torch.zeros(1, 2, 32, 32))


def test_kernel_biases_pass_the_learned_bias_uncopied():
    """The kernels read the learned bias in its own dtype: a bf16 one goes
    to them as the same tensor with its flag set, an fp32 one likewise;
    the constant bias is widened to fp32; other learned-bias dtypes raise."""
    dev = torch.device("cpu")
    bias = torch.zeros(2, 1, 1, 32, dtype=torch.bfloat16)
    for dtype, flag in ((torch.bfloat16, 1), (torch.float32, 0)):
        lb = torch.zeros(1, 2, 32, 32, dtype=dtype)
        got_bias, got_lb, got_flag = tfa._kernel_biases("k", dev, bias, lb)
        assert got_lb is lb and got_flag == flag
        assert got_bias.dtype == torch.float32 and torch.equal(got_bias, bias.float())
    assert tfa._kernel_biases("k", dev, None, None) == (None, None, 0)
    with pytest.raises(ValueError, match="fp32 or bf16"):
        tfa._kernel_biases("k", dev, None, torch.zeros(1, 2, 32, 32, dtype=torch.float16))
