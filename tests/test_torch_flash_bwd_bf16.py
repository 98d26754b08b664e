"""bf16 parity of kernels 2 and 3's function: the port's
``flash_attention_bwd_plain`` (what the bf16 wrappers run for CPU tensors,
and what the chip check holds the tensor-core kernels of
``csrc/flash_bwd_tc.cu`` against) against the JAX package's ``_bwd`` with
its Pallas kernels in interpret mode.  Both sides get the same bf16 q, k,
v, dO (and learned bias) made from one numpy seed, and the same o and lse
(the JAX forward's), so the comparison is of the backward alone.  Every
head dim the kernels are built for, with a ragged padding mask, causal,
the learned bias beside the padding mask (scale 1, as T5 runs it), and
-inf rows, whose dq must be exactly 0 on both sides.  Both round ds to
bf16 before the dq and dk products and p before the dv product, and sum
in fp32; what differs is the fp32 summation order (blockwise on the JAX
side), which can move a bf16 rounding of ds, p or the output by one ulp.
The gradients here reach |g| ~ 10, where one bf16 ulp is 0.0625: atol 0.07
plus rtol 1e-2 holds one ulp anywhere; the largest difference read is
0.0625."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llms_example_tpu.ops import flash_attention as jfa
from distributed_llms_example_tpu.ops.attention import NEG_INF
from distributed_llms_example_tpu_torch.ops import flash_attention as tfa

B, H, S, BLOCK = 2, 2, 128, 64
ATOL, RTOL = 0.07, 1e-2
DEAD = [0, 5, 77]
CASES = ("padding", "causal", "learned_bias", "dead_rows")


@pytest.fixture(autouse=True)
def _no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False


def _inputs(case, head_dim):
    rng = np.random.RandomState(100 + head_dim)
    lbias = case == "learned_bias"
    # T5 folds 1/sqrt(d) into q's init and runs at scale 1
    q = (rng.randn(B, H, S, head_dim) * (head_dim ** -0.5 if lbias else 1.0)).astype(np.float32)
    k, v, do = (rng.randn(B, H, S, head_dim).astype(np.float32) for _ in range(3))
    bias = None
    if case in ("padding", "learned_bias"):
        lens = np.array([S, 45])
        bias = np.where(np.arange(S)[None, :] < lens[:, None], 0.0, NEG_INF)
        bias = bias.astype(np.float32)[:, None, None, :]
    elif case == "dead_rows":
        bias = np.zeros((B, 1, S, S), np.float32)
        bias[:, :, DEAD, :] = -np.inf
    lb = rng.randn(1, H, S, S).astype(np.float32) * 0.5 if lbias else None
    bf = lambda x: None if x is None else x.astype(jnp.bfloat16)  # noqa: E731
    return (bf(q), bf(k), bf(v), bf(do), bias, bf(lb), case == "causal",
            1.0 if lbias else head_dim ** -0.5)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("head_dim", tfa.KERNEL_HEAD_DIMS)
def test_bf16_backward_matches_jax(head_dim, case):
    q, k, v, do, bias, lb, causal, scale = _inputs(case, head_dim)
    j = lambda x: None if x is None else jnp.asarray(x)  # noqa: E731
    kw = dict(scale=scale, causal=causal, block_q=BLOCK, block_k=BLOCK, interpret=True)
    o, lse = jfa._fwd(j(q), j(k), j(v), j(bias), j(lb), **kw)
    want = jfa._bwd(j(q), j(k), j(v), j(bias), j(lb), o, lse, j(do), **kw)[:3]

    t = lambda x: None if x is None else torch.from_numpy(  # noqa: E731
        np.asarray(x, dtype=np.float32)).to(torch.bfloat16)
    got = tfa.flash_attention_bwd_plain(
        t(q), t(k), t(v), None if bias is None else torch.from_numpy(bias), t(o),
        torch.from_numpy(np.array(lse, dtype=np.float32)[..., 0]), t(do), lbias=t(lb),
        causal=causal, scale=scale)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == torch.bfloat16 and np.asarray(w).dtype == jnp.bfloat16
        np.testing.assert_allclose(g.float().numpy(), np.asarray(w, dtype=np.float32),
                                   atol=ATOL, rtol=RTOL, err_msg=name)
    if case == "dead_rows":
        assert (got[0][:, :, DEAD] == 0).all()
        assert (np.asarray(want[0], dtype=np.float32)[:, :, DEAD] == 0).all()
