"""The port's fused dropout (its plain PyTorch version, which the wrapper
runs for CPU tensors) against the JAX package's counter-hash stream: the
keep mask bit-equal to ``hash_keep_mask`` and to the Pallas kernel in
interpret mode (``hw_rng=False``) over negative and positive seeds, rates
0.1 and 0.5 and a 1M-element view; the fused residual add and the
recomputed backward bit-equal too; the module's rate-0 / rate-1 / eval
edges; the kernel's launch plan (``dropout_plan``: a scalar head, 16-byte
vectors, a scalar tail) covering every element once at aligned and offset
addresses, and its (row, col) stepping without division."""

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


# x, residual and out addresses: aligned; x and the residual at one offset
# (out follows x); the residual at another offset; no residual
ADDRESSES = {"aligned": (4096, 8192, 12288), "offset": (4102, 8198, 12294),
             "residual_elsewhere": (4102, 8192, 12294), "no_residual": (4100, None, 12292)}


@pytest.mark.parametrize("where", list(ADDRESSES))
@pytest.mark.parametrize("cols", [1, 7, 1000, 1001, 4096])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_dropout_plan_covers_every_element_once(dtype, cols, where):
    size = torch.finfo(dtype).bits // 8
    x_ptr, res_ptr, out_ptr = (None if p is None else p - p % size for p in ADDRESSES[where])
    numel = 37 * cols
    plan = tfd.dropout_plan(numel, cols, dtype, x_ptr, res_ptr, out_ptr, sms=132)
    assert plan.width * size == 16
    count = np.zeros(numel, np.int64)
    count[:plan.head] += 1
    count[plan.head:plan.head + plan.vector_elements] += 1
    count[numel - plan.tail:] += 1
    assert plan.head + plan.vector_elements + plan.tail == numel
    assert (count == 1).all()
    ptrs = [p for p in (x_ptr, res_ptr, out_ptr) if p is not None]
    if len({p % 16 for p in ptrs}) == 1:  # one alignment: vectors from the first aligned element
        assert plan.head < plan.width and plan.tail < plan.width
        assert all((p + plan.head * size) % 16 == 0 for p in ptrs)
    else:
        assert plan.vectors == 0 and plan.head == numel
    # each CTA does the same number of rounds, at most CTAS_PER_SM CTAs a SM
    unroll = tfd.UNROLL if res_ptr is None else tfd.UNROLL // 2
    work = max(-(-plan.vectors // (unroll * tfd.NT)), -(-(plan.head + plan.tail) // tfd.NT), 1)
    assert 1 <= plan.grid <= tfd.CTAS_PER_SM * 132
    rounds = -(-work // plan.grid)
    assert (rounds - 1) * plan.grid < work <= rounds * plan.grid


def test_dropout_plan_main_path_shape_is_all_vectors():
    """The widest call of the train paths, (8, 1024, 4096) bf16 at aligned
    addresses: every element in a 16-byte access, 4 CTAs on each of 128
    SMs doing 8 rounds."""
    plan = tfd.dropout_plan(8 * 1024 * 4096, 4096, torch.bfloat16, 1 << 20, None, 1 << 24)
    assert (plan.head, plan.tail, plan.vectors, plan.grid) == (0, 0, 8 * 1024 * 4096 // 8, 512)
    with pytest.raises(ValueError, match="rows of"):
        tfd.dropout_plan(1000, 7, torch.float32, 0, None, 0)


def _pos_of(e, cols):
    return e // cols, e % cols


def _advance(pos, by, cols):
    """The kernel's stepping: add (whole rows, remaining cols), one carry."""
    r, c = pos[0] + by[0], pos[1] + by[1]
    return (r + 1, c - cols) if c >= cols else (r, c)


@pytest.mark.parametrize("cols", [1, 7, 8, 1000, 1001, 4096])
def test_row_col_stepping_matches_division(cols):
    """A thread's (row, col) from one division and then fixed strides (the
    access stride inside a round and the grid stride between rounds) with
    one carry each, as in csrc/fused_dropout.cu, equals divmod of every
    element index it visits."""
    width, nt, unroll, grid = 8, 256, 4, 3
    for first in (0, 5, 1023, 2047):
        pos = _pos_of(first * width, cols)
        in_round = _pos_of(nt * width, cols)
        next_round = _pos_of(grid * unroll * nt * width, cols)
        for k in range(6):
            pu = pos
            for u in range(unroll):
                e = (first + k * grid * unroll * nt + u * nt) * width
                assert pu == _pos_of(e, cols)
                pu = _advance(pu, in_round, cols)
            pos = _advance(pos, next_round, cols)
