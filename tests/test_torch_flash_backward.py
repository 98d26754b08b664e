"""The port's flash-attention backward (the plain versions its dq and dk/dv
wrappers run for CPU tensors, reached through the autograd Function)
against ``jax.vjp`` of the JAX package's ``flash_attention`` with its
Pallas kernels in interpret mode, on the same numpy inputs: square with a
ragged padding bias, causal, non-square cross-attention, and ``-inf``
rows whose gradients must be exactly zero.  fp32 at atol 1e-5 (summation
order differs: blockwise on the JAX side, one pass here); bf16 at the
bf16 limit of the chip check, 2e-2.  On the CPU the Function must also
equal torch autograd through ``flash_attention_plain``."""

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


def _case(name, rng):
    Q, K, causal, bias = 128, 128, False, None
    if name == "padding":
        lens = np.array([K, 45])
        bias = np.where(np.arange(K)[None, :] < lens[:, None], 0.0, NEG_INF)
        bias = bias.astype(np.float32)[:, None, None, :]
    elif name == "causal":
        causal = True
    elif name == "cross":
        Q, K = 32, 128
        lens = np.array([100, K])
        bias = np.where(np.arange(K)[None, :] < lens[:, None], 0.0, NEG_INF)
        bias = bias.astype(np.float32)[:, None, None, :]
    elif name == "dead_rows":
        bias = np.zeros((B, 1, Q, K), np.float32)
        bias[:, :, DEAD, :] = -np.inf
    q = rng.randn(B, H, Q, D).astype(np.float32)
    k, v = (rng.randn(B, H, K, D).astype(np.float32) for _ in range(2))
    do = rng.randn(B, H, Q, D).astype(np.float32)
    return q, k, v, do, bias, causal


def _jax_grads(q, k, v, do, bias, causal, dtype):
    def f(q, k, v):
        return jfa.flash_attention(q, k, v, None if bias is None else jnp.asarray(bias),
                                   causal=causal, interpret=True,
                                   block_q=min(64, q.shape[2]), block_k=64)

    args = [jnp.asarray(x).astype(dtype) for x in (q, k, v)]
    _, vjp = jax.vjp(f, *args)
    return [np.asarray(g.astype(jnp.float32)) for g in vjp(jnp.asarray(do).astype(dtype))]


def _port_grads(q, k, v, do, bias, causal, dtype):
    ts = [torch.from_numpy(x).to(dtype).requires_grad_(True) for x in (q, k, v)]
    out = tfa.flash_attention(*ts, None if bias is None else torch.from_numpy(bias),
                              causal=causal)
    out.backward(torch.from_numpy(do).to(dtype))
    return [t.grad.float().numpy() for t in ts]


@pytest.mark.parametrize("case", ["padding", "causal", "cross", "dead_rows"])
def test_backward_fp32_matches_jax_vjp(case):
    q, k, v, do, bias, causal = _case(case, np.random.RandomState(0))
    want = _jax_grads(q, k, v, do, bias, causal, jnp.float32)
    got = _port_grads(q, k, v, do, bias, causal, torch.float32)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g, w, atol=1e-5, err_msg=name)
    if case == "dead_rows":
        assert (got[0][:, :, DEAD] == 0).all() and (want[0][:, :, DEAD] == 0).all()


@pytest.mark.parametrize("case", ["padding", "causal", "cross"])
def test_backward_bf16_matches_jax_vjp(case):
    q, k, v, do, bias, causal = _case(case, np.random.RandomState(1))
    want = _jax_grads(q, k, v, do, bias, causal, jnp.bfloat16)
    got = _port_grads(q, k, v, do, bias, causal, torch.bfloat16)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g, w, atol=2e-2, rtol=2e-2, err_msg=name)


@pytest.mark.parametrize("case", ["padding", "causal", "cross", "dead_rows"])
def test_function_equals_autograd_through_the_plain_forward(case):
    q, k, v, do, bias, causal = _case(case, np.random.RandomState(2))
    tb = None if bias is None else torch.from_numpy(bias)
    got = _port_grads(q, k, v, do, bias, causal, torch.float32)
    ts = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    o, _ = tfa.flash_attention_plain(*ts, tb, causal=causal)
    o.backward(torch.from_numpy(do))
    live = np.ones(q.shape[2], bool)
    if case == "dead_rows":
        # autograd through the plain softmax divides 0/1 on a dead row; the
        # kernels' sentinel gives exactly 0, which is what dq shows above
        live[DEAD] = False
    for name, g, t in zip(("dq", "dk", "dv"), got, ts):
        w = t.grad.numpy()
        if name == "dq":
            g, w = g[:, :, live], w[:, :, live]
        np.testing.assert_allclose(g, w, atol=1e-5, err_msg=name)


def test_bwd_plain_matches_the_wrappers():
    q, k, v, do, bias, causal = _case("padding", np.random.RandomState(3))
    q, k, v, do = (torch.from_numpy(x) for x in (q, k, v, do))
    tb = torch.from_numpy(bias)
    o, lse = tfa.flash_attention(q, k, v, tb, return_lse=True)
    delta = tfa.attention_delta(do, o)
    kw = dict(causal=False, scale=D ** -0.5)
    dq = tfa.flash_bwd_dq(q, k, v, tb, do, lse, delta, **kw)
    dk, dv = tfa.flash_bwd_dkv(q, k, v, tb, do, lse, delta, **kw)
    want = tfa.flash_attention_bwd_plain(q, k, v, tb, o, lse, do, **kw)
    for g, w in zip((dq, dk, dv), want):
        assert torch.equal(g, w)


def test_cuda_wrappers_refuse_cpu_tensors():
    x = torch.zeros(1, 1, 8, 16)
    lse = torch.zeros(1, 1, 8)
    with pytest.raises(ValueError, match="expected a CUDA device"):
        tfa._bwd_cuda("flash_bwd_dq", x, x, x, None, x, lse, lse, (x,), causal=False, scale=1.0)
