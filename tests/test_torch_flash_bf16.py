"""bf16 parity of kernel 1's function: the port's ``flash_attention_plain``
(what the bf16 wrapper runs for CPU tensors, and what the chip check holds
the tensor-core kernel against) against the JAX package's ``_fwd`` with its
Pallas kernel in interpret mode, on the same bf16 values made from one
numpy seed.  Every head dim the kernel is built for, with a ragged padding
mask, causal, the learned bias, and the learned bias with causal (scale 1,
as T5 runs it).  Both round p to bf16 before the value product and keep
the row sum in fp32: o agrees to 0.0039 here (one bf16 ulp at |o| in
[0.5, 1), half of one at the largest |o|, about 3.7), so atol 8e-3 leaves
2x; lse agrees to 4.8e-7 (fp32 summation order), held at 1e-5."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llms_example_tpu.ops import flash_attention as jfa
from distributed_llms_example_tpu.ops.attention import NEG_INF
from distributed_llms_example_tpu_torch.ops import flash_attention as tfa

B, H, S, BLOCK = 2, 2, 128, 64
O_ATOL, LSE_ATOL = 8e-3, 1e-5
CASES = ("padding", "causal", "learned_bias", "learned_bias_causal")


def _inputs(case, head_dim):
    rng = np.random.RandomState(head_dim)
    lbias = "learned_bias" in case
    # T5 folds 1/sqrt(d) into q's init and runs at scale 1
    qs = head_dim ** -0.5 if lbias else 1.0
    q = (rng.randn(B, H, S, head_dim) * qs).astype(np.float32)
    k, v = (rng.randn(B, H, S, head_dim).astype(np.float32) for _ in range(2))
    bias = None
    if case in ("padding", "learned_bias"):
        lens = np.array([S, 45])
        bias = np.where(np.arange(S)[None, :] < lens[:, None], 0.0, NEG_INF)
        bias = bias.astype(np.float32)[:, None, None, :]
    lb = rng.randn(1, H, S, S).astype(np.float32) * 0.5 if lbias else None
    # the bf16 values both sides see
    rnd = lambda x: None if x is None else x.astype(jnp.bfloat16)  # noqa: E731
    return (rnd(q), rnd(k), rnd(v), bias, rnd(lb), case.endswith("causal"),
            1.0 if lbias else head_dim ** -0.5)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("head_dim", tfa.KERNEL_HEAD_DIMS)
def test_bf16_forward_matches_jax(head_dim, case):
    q, k, v, bias, lb, causal, scale = _inputs(case, head_dim)
    o_j, lse_j = jfa._fwd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        None if bias is None else jnp.asarray(bias), None if lb is None else jnp.asarray(lb),
        scale=scale, causal=causal, block_q=BLOCK, block_k=BLOCK, interpret=True,
    )
    t = lambda x: None if x is None else torch.from_numpy(  # noqa: E731
        np.asarray(x, dtype=np.float32)).to(torch.bfloat16)
    o_t, lse_t = tfa.flash_attention_plain(
        t(q), t(k), t(v), None if bias is None else torch.from_numpy(bias), lbias=t(lb),
        causal=causal, scale=scale,
    )
    assert o_t.dtype == torch.bfloat16 and np.asarray(o_j).dtype == jnp.bfloat16
    np.testing.assert_allclose(o_t.float().numpy(), np.asarray(o_j, dtype=np.float32),
                               atol=O_ATOL)
    np.testing.assert_allclose(lse_t.numpy(), np.asarray(lse_j)[..., 0], atol=LSE_ATOL)
