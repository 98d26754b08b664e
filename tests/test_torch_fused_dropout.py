"""The port's fused dropout (its plain PyTorch version, which the wrapper
runs for CPU tensors) against the JAX package's counter-hash stream: the
keep mask bit-equal to ``hash_keep_mask`` and to the Pallas kernel in
interpret mode (``hw_rng=False``) over negative and positive seeds, rates
0.1 and 0.5 and a 1M-element view; the fused residual add and the
recomputed backward bit-equal too; the module's rate-0 / rate-1 / eval
edges."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llms_example_tpu.ops import fused_dropout as jfd
from distributed_llms_example_tpu_torch.ops import fused_dropout as tfd

SEEDS = [0, 1, 12345, -1, -987654321, 2**31 - 1, -(2**31)]


@pytest.mark.parametrize("rate", [0.1, 0.5])
@pytest.mark.parametrize("seed", SEEDS)
def test_keep_mask_bit_equal_to_jax_hash(seed, rate):
    shape = (48, 200)
    want = np.asarray(jfd.hash_keep_mask(jnp.int32(seed), shape, rate, row0=64, col0=3))
    got = tfd.hash_keep_mask(seed, shape, rate, row0=64, col0=3).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", [-7, 424242])
def test_keep_mask_bit_equal_at_1m_elements(seed):
    shape = (1024, 1024)
    want = np.asarray(jfd.hash_keep_mask(jnp.int32(seed), shape, 0.1))
    got = tfd.hash_keep_mask(seed, shape, 0.1).numpy()
    np.testing.assert_array_equal(got, want)
    assert abs(got.mean() - 0.9) < 1e-3


def test_keep_threshold_exact():
    for rate in (0.0, 0.1, 0.25, 0.5, 0.9, 1e-3, 0.3333):
        assert tfd.keep_threshold(rate) == jfd.keep_threshold(rate)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("seed,rate", [(3, 0.1), (-11, 0.5)])
def test_fused_dropout_bit_equal_to_interpret_kernel(dtype, residual, seed, rate):
    rng = np.random.RandomState(0)
    x = rng.randn(4, 32, 256).astype(np.float32)
    r = rng.randn(4, 32, 256).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = getattr(torch, dtype)
    want = jfd.fused_dropout(jnp.asarray(x).astype(jdt), jnp.int32(seed), rate,
                             residual=jnp.asarray(r).astype(jdt) if residual else None,
                             interpret=True, hw_rng=False)
    got = tfd.fused_dropout(torch.from_numpy(x).to(tdt), seed, rate,
                            residual=torch.from_numpy(r).to(tdt) if residual else None)
    assert got.dtype == tdt
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want.astype(jnp.float32)))


@pytest.mark.parametrize("residual", [False, True])
def test_backward_recomputes_the_mask_and_passes_the_residual_gradient(residual):
    rng = np.random.RandomState(1)
    x, r, g = (rng.randn(2, 16, 128).astype(np.float32) for _ in range(3))
    seed, rate = -12345, 0.2

    def jf(x, r):
        return jfd.fused_dropout(x, jnp.int32(seed), rate, residual=r if residual else None,
                                 interpret=True, hw_rng=False)

    _, vjp = jax.vjp(jf, jnp.asarray(x), jnp.asarray(r))
    jdx, jdr = vjp(jnp.asarray(g))
    tx = torch.tensor(x, requires_grad=True)
    tr = torch.tensor(r, requires_grad=True)
    out = tfd.fused_dropout(tx, seed, rate, residual=tr if residual else None)
    out.backward(torch.from_numpy(g))
    np.testing.assert_array_equal(tx.grad.numpy(), np.asarray(jdx))
    # the backward is the forward's mask on g, no residual
    np.testing.assert_array_equal(tx.grad.numpy(),
                                  tfd.dropout_plain(torch.from_numpy(g), seed, rate).numpy())
    if residual:
        np.testing.assert_array_equal(tr.grad.numpy(), g)
        np.testing.assert_array_equal(tr.grad.numpy(), np.asarray(jdr))


def test_module_rates_zero_one_and_eval():
    x = torch.randn(2, 8, 16)
    r = torch.randn(2, 8, 16)
    for rate in (0.0, 0.1, 1.0):
        m = tfd.Dropout(rate).eval()
        assert torch.equal(m(x, residual=r), r + x)
    assert torch.equal(tfd.Dropout(0.0).train()(x, residual=r), r + x)
    assert torch.equal(tfd.Dropout(1.0).train()(x), torch.zeros_like(x))
    assert torch.equal(tfd.Dropout(1.0).train()(x, residual=r), r)
    with pytest.raises(ValueError, match="0 < rate < 1"):
        tfd.fused_dropout(x, 0, 1.0)


def test_seed_stream_is_deterministic_and_needs_no_device():
    m = tfd.Dropout(0.3).train()
    x = torch.randn(4, 64)
    with tfd.dropout_seeds(torch.Generator().manual_seed(5)):
        a = m(x)
    with tfd.dropout_seeds(torch.Generator().manual_seed(5)):
        b = m(x)
    with tfd.dropout_seeds(torch.Generator().manual_seed(6)):
        c = m(x)
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_cuda_wrapper_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="expected a CUDA device"):
        tfd._dropout_cuda(torch.zeros(4, 4), None, 0, 0.1)
