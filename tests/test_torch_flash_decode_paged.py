"""The port's paged flash decode (its plain version, which the wrapper runs
for CPU tensors) against the JAX package's Pallas ``flash_decode_paged``
in interpret mode, on the same numpy inputs: a scrambled block order,
sentinel tiles in the prompt gap (under the padding bias) and past the
offsets, q blocks of 1 and 8 rows, a padding bias, int8 pools, and a GQA
pool (against the JAX kernel on the ``jnp.repeat``-ed pool).  fp32; atol
1e-6 covers the summation order of the online softmax (tile by tile on the
JAX side, one pass here)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llms_example_tpu.ops import flash_attention as jfa
from distributed_llms_example_tpu.ops.attention import NEG_INF
from distributed_llms_example_tpu_torch.ops import flash_attention as tfa

ATOL = 1e-6
B, H, D, BS, NT = 3, 4, 16, 16, 4  # L = 64 logical slots per row


def _pool_case(rng, q_len, *, heads_kv=H, gap=True):
    """Scrambled pool, block tables with sentinels, offsets, padding bias.
    Row 0 has a 20-token prompt in a 48-wide bucket: tile 2 is the prompt
    gap (a sentinel under the padding bias) and tile 3 its decode tile;
    row 1 fills every tile; row 2 has one prompt tile and nothing past it."""
    N = B * NT + 3
    k_pool = rng.randn(N, heads_kv, BS, D).astype(np.float32)
    v_pool = rng.randn(N, heads_kv, BS, D).astype(np.float32)
    perm = rng.permutation(N)
    bt = perm[: B * NT].reshape(B, NT).astype(np.int32)
    bias = np.zeros((B, 1, 1, NT * BS), np.float32)
    if gap:
        bt[0, 2] = N
        bias[0, ..., 20:48] = NEG_INF
    bt[2, 1:] = N
    offsets = np.array([48 + 5, NT * BS - q_len, BS - q_len], np.int32)
    q = rng.randn(B, H, q_len, D).astype(np.float32)
    return q, k_pool, v_pool, bt, offsets, bias


def _jax(q, kp, vp, bt, offsets, bias, ks=None, vs=None):
    return np.asarray(jfa.flash_decode_paged(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
        None if bias is None else jnp.asarray(bias),
        block_tables=jnp.asarray(bt), offsets=jnp.asarray(offsets),
        k_scale_pool=None if ks is None else jnp.asarray(ks),
        v_scale_pool=None if vs is None else jnp.asarray(vs), interpret=True,
    ))


def _port(q, kp, vp, bt, offsets, bias, ks=None, vs=None, fn=tfa.flash_decode_paged):
    t = lambda x: None if x is None else torch.from_numpy(np.array(x))  # noqa: E731
    return fn(t(q), t(kp), t(vp), t(bias), block_tables=t(bt), offsets=t(offsets),
              k_scale_pool=t(ks), v_scale_pool=t(vs)).numpy()


@pytest.mark.parametrize("q_len", [1, 8])
@pytest.mark.parametrize("with_bias", [False, True])
def test_paged_decode_matches_jax(q_len, with_bias):
    rng = np.random.RandomState(q_len + 10 * with_bias)
    q, kp, vp, bt, offsets, bias = _pool_case(rng, q_len, gap=with_bias)
    bias = bias if with_bias else None
    np.testing.assert_allclose(_port(q, kp, vp, bt, offsets, bias),
                               _jax(q, kp, vp, bt, offsets, bias), atol=ATOL)


@pytest.mark.parametrize("q_len", [1, 8])
def test_paged_decode_int8_matches_jax(q_len):
    rng = np.random.RandomState(20 + q_len)
    q, kp, vp, bt, offsets, bias = _pool_case(rng, q_len)
    kq, ks = jfa.quantize_kv(jnp.asarray(kp))
    vq, vs = jfa.quantize_kv(jnp.asarray(vp))
    args = (q, np.asarray(kq), np.asarray(vq), bt, offsets, bias, np.asarray(ks), np.asarray(vs))
    np.testing.assert_allclose(_port(*args), _jax(*args), atol=ATOL)


def test_paged_decode_gqa_matches_jax_on_repeated_pool():
    """A pool of 2 kv heads for 4 q heads: q head h reads pool head h // 2,
    the function the JAX package computes after ``jnp.repeat``."""
    rng = np.random.RandomState(30)
    q, kp, vp, bt, offsets, bias = _pool_case(rng, 1, heads_kv=2)
    rep = lambda x: np.repeat(x, H // 2, axis=1)  # noqa: E731
    np.testing.assert_allclose(_port(q, kp, vp, bt, offsets, bias),
                               _jax(q, rep(kp), rep(vp), bt, offsets, bias), atol=ATOL)


def test_paged_plain_equals_flat_plain_on_gathered_view():
    """The plain version is the flat plain version over the gathered view:
    the same function kernel 6 and kernel 5 must agree on."""
    rng = np.random.RandomState(31)
    q, kp, vp, bt, offsets, bias = _pool_case(rng, 8)
    t = torch.from_numpy
    view_k = tfa.gather_blocks(t(kp), t(bt))
    view_v = tfa.gather_blocks(t(vp), t(bt))
    want = tfa.flash_decode_plain(t(q), view_k, view_v, t(bias), offsets=t(offsets))
    got = _port(q, kp, vp, bt, offsets, bias, fn=tfa.flash_decode_paged_plain)
    np.testing.assert_array_equal(got, want.numpy())
    assert bool((view_k[0, :, 32:48] == 0).all())  # the gap's sentinel tile reads zeros


def test_paged_wrapper_cpu_runs_plain_and_kernel_path_refuses_cpu():
    """For CPU tensors the wrapper runs the plain version and counts no
    launch; the kernel path itself refuses a CPU tensor (no fallback)."""
    rng = np.random.RandomState(32)
    q, kp, vp, bt, offsets, bias = (torch.from_numpy(x) for x in _pool_case(rng, 1))
    before = tfa.flash_decode_paged.launches
    out = tfa.flash_decode_paged(q, kp, vp, bias, block_tables=bt, offsets=offsets)
    assert out.shape == q.shape and tfa.flash_decode_paged.launches == before
    with pytest.raises(ValueError, match="expected a CUDA device"):
        tfa._flash_decode_paged_cuda(q, kp, vp, bias, block_tables=bt, offsets=offsets,
                                     k_scale_pool=None, v_scale_pool=None, scale=D ** -0.5)


def test_paged_wrapper_rejects_bad_shapes():
    q = torch.zeros(1, 4, 1, 16)
    pool = torch.zeros(3, 3, 16, 16)
    bt = torch.zeros(1, 2, dtype=torch.int32)
    off = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="pool heads must divide"):
        tfa.flash_decode_paged(q, pool, pool, block_tables=bt, offsets=off)
    with pytest.raises(ValueError, match="8-aligned"):
        tfa.flash_decode_paged(q, torch.zeros(3, 2, 12, 16), torch.zeros(3, 2, 12, 16),
                               block_tables=bt, offsets=off)
    with pytest.raises(ValueError, match="1..8"):
        tfa.flash_decode_paged(torch.zeros(1, 4, 9, 16), pool[:, :2], pool[:, :2],
                               block_tables=bt, offsets=off)
    with pytest.raises(ValueError, match="bias dim"):
        tfa.flash_decode_paged(q, pool[:, :2], pool[:, :2], torch.zeros(1, 1, 1, 16),
                               block_tables=bt, offsets=off)
