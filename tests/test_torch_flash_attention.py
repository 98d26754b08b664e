"""The port's flash-attention and flash-decode wrappers (their plain PyTorch
versions, which the wrappers run for CPU tensors) against the JAX package's
Pallas kernels in interpret mode, on the same numpy inputs.  fp32
throughout; atol 1e-5 covers the different summation order of the online
softmax (blockwise on the JAX side, one pass here)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llms_example_tpu.ops import flash_attention as jfa
from distributed_llms_example_tpu.ops.attention import NEG_INF
from distributed_llms_example_tpu_torch.ops import flash_attention as tfa

ATOL = 1e-5


@pytest.fixture(autouse=True)
def _no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _qkv(rng, B, H, Q, K, d):
    mk = lambda *s: rng.randn(*s).astype(np.float32)  # noqa: E731
    return mk(B, H, Q, d), mk(B, H, K, d), mk(B, H, K, d)


def _jax_fwd(q, k, v, bias, causal):
    scale = q.shape[-1] ** -0.5
    bq = jfa.auto_block(q.shape[2], 128)
    bk = jfa.auto_block(k.shape[2], 128)
    o, lse = jfa._fwd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        None if bias is None else jnp.asarray(bias), None,
        scale=scale, causal=causal, block_q=bq, block_k=bk, interpret=True,
    )
    return np.asarray(o), np.asarray(lse)[..., 0]


def _torch_fwd(q, k, v, bias, causal):
    o, lse = tfa.flash_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        None if bias is None else torch.from_numpy(bias), causal=causal, return_lse=True,
    )
    return o.numpy(), lse.numpy()


@pytest.mark.parametrize("case", ["padding", "causal", "full_bias"])
def test_flash_forward_matches_jax(case):
    rng = np.random.RandomState(0)
    B, H, S, d = 2, 2, 256, 16
    q, k, v = _qkv(rng, B, H, S, S, d)
    causal = case == "causal"
    bias = None
    if case == "padding":
        # ragged padding: row b keeps its first lens[b] keys
        lens = np.array([S, 100])
        bias = np.where(np.arange(S)[None, :] < lens[:, None], 0.0, NEG_INF)
        bias = bias.astype(np.float32)[:, None, None, :]
    elif case == "full_bias":
        bias = (rng.randn(B, H, S, S) * 2.0).astype(np.float32)
    o_j, lse_j = _jax_fwd(q, k, v, bias, causal)
    o_t, lse_t = _torch_fwd(q, k, v, bias, causal)
    np.testing.assert_allclose(o_t, o_j, atol=ATOL)
    np.testing.assert_allclose(lse_t, lse_j, atol=ATOL)


def test_flash_forward_fully_masked_rows():
    """Rows whose every key carries a -inf bias give o = 0 and lse =
    MASK_VALUE in both packages; the other rows still agree."""
    rng = np.random.RandomState(1)
    B, H, S, d = 2, 2, 128, 16
    q, k, v = _qkv(rng, B, H, S, S, d)
    bias = np.zeros((B, 1, S, S), np.float32)
    dead = [0, 5, 77]
    bias[:, :, dead, :] = -np.inf
    o_j, lse_j = _jax_fwd(q, k, v, bias, False)
    o_t, lse_t = _torch_fwd(q, k, v, bias, False)
    assert np.all(o_t[:, :, dead] == 0.0)
    assert np.all(lse_t[:, :, dead] == tfa.MASK_VALUE)
    assert tfa.MASK_VALUE == jfa.MASK_VALUE
    np.testing.assert_allclose(o_t, o_j, atol=ATOL)
    np.testing.assert_allclose(lse_t, lse_j, atol=ATOL)


def test_flash_forward_public_api_matches_jax():
    rng = np.random.RandomState(2)
    q, k, v = _qkv(rng, 2, 2, 128, 128, 16)
    want = np.asarray(jfa.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                          causal=True, interpret=True))
    got = tfa.flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                              causal=True).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_flash_gates_match_jax():
    for args in [(128, 128, 64), (1024, 1024, 64), (1, 1024, 64), (592, 592, 64),
                 (48, 48, 16), (12, 12, 64), (128, 128, 12)]:
        for causal in (False, True):
            assert tfa.flash_supported(*args, causal=causal) == jfa.flash_supported(*args, causal=causal)
    for n in (1, 16, 48, 128, 592, 1024, 1030):
        assert tfa.auto_block(n) == jfa.auto_block(n)
    for args in [(1, 128, 64), (8, 64, 16), (9, 128, 64), (1, 12, 64), (1, 128, 12)]:
        assert tfa.flash_decode_supported(*args) == jfa.flash_decode_supported(*args)
    assert tfa.MAX_DECODE_Q_ROWS == jfa.MAX_DECODE_Q_ROWS


_SELECT_SHAPES = [  # (q_len, kv_len, head_dim, causal)
    (1024, 1024, 64, False), (1000, 1000, 64, False), (200, 200, 64, True),
    (1, 1024, 64, False), (48, 48, 16, False), (128, 128, 12, False),
]
_DECODE_SHAPES = [(1, 128, 64), (1, 64, 64), (8, 200, 64), (1, 40, 16), (9, 128, 64),
                  (1, 128, 12)]


@pytest.mark.parametrize("impl", ["auto", "flash", "xla", "ring"])
def test_cpu_selection_matches_jax(impl):
    """For CPU tensors the port picks the path the JAX package picks."""
    from distributed_llms_example_tpu.ops import mha as jmha
    from distributed_llms_example_tpu_torch.ops import mha as tmha

    for q_len, kv_len, d, causal in _SELECT_SHAPES:
        got, _ = tmha.select_attention_impl(impl, head_dim=d, q_len=q_len, kv_len=kv_len,
                                            use_cache=False, backend="cpu", causal=causal)
        want, _ = jmha.select_attention_impl(
            impl, batch=2, heads=2, head_dim=d, q_len=q_len, kv_len=kv_len, use_cache=False,
            mesh=None, backend="cpu", device_count=1, causal=causal,
        )
        assert got == want, (impl, q_len, kv_len, d, causal)
    for q_len, kv_len, d in _DECODE_SHAPES:
        got, _ = tmha.select_decode_impl(impl, head_dim=d, q_len=q_len, kv_len=kv_len,
                                         backend="cpu")
        want, _ = jmha.select_decode_impl(impl, batch=2, heads=2, head_dim=d, q_len=q_len,
                                          kv_len=kv_len, mesh=None, backend="cpu",
                                          device_count=1)
        assert got == want, (impl, q_len, kv_len, d)


@pytest.mark.parametrize("impl", ["auto", "flash"])
def test_cuda_selection_takes_the_kernel_at_any_length(impl):
    """On CUDA the kernels run for every shape they have an instance for:
    a source length that is no multiple of 16 (1000), a causal 200, a
    64-slot or 200-slot decode cache.  Only a head_dim without an instance,
    a q block over 8 rows, and (for ``auto``) the one-row cross-attention
    of a decode step stay plain."""
    from distributed_llms_example_tpu_torch.ops import mha as tmha

    def fwd(q_len, kv_len, d, causal=False):
        return tmha.select_attention_impl(impl, head_dim=d, q_len=q_len, kv_len=kv_len,
                                          use_cache=False, backend="cuda", causal=causal)[0]

    def dec(q_len, kv_len, d):
        return tmha.select_decode_impl(impl, head_dim=d, q_len=q_len, kv_len=kv_len,
                                       backend="cuda")[0]

    for q_len, kv_len, d, causal in [(1000, 1000, 64, False), (200, 200, 64, True),
                                     (1024, 1024, 64, False), (48, 48, 16, False),
                                     (37, 53, 128, False)]:
        assert fwd(q_len, kv_len, d, causal) == "flash", (q_len, kv_len, d, causal)
    assert fwd(128, 128, 12) == "xla"
    assert fwd(1, 1024, 64) == ("flash" if impl == "flash" else "xla")
    for q_len, kv_len in [(1, 64), (1, 128), (8, 200), (1, 1000), (4, 17)]:
        assert dec(q_len, kv_len, 64) == "flash_decode", (q_len, kv_len)
    assert dec(9, 128, 64) == "xla"
    assert dec(1, 128, 12) == "xla"
    # ring follows the JAX package's selection: outside a mesh plain
    # attention (as at module init), on a mesh that cannot ring a
    # ValueError, ring where the sequence axis splits the lengths, and a
    # decode step plain attention
    assert tmha.select_attention_impl("ring", head_dim=64, q_len=128, kv_len=128,
                                      use_cache=False, backend="cuda") == \
        ("xla", "ring requested but no mesh context")
    with pytest.raises(ValueError, match="mesh has no sequence axis > 1"):
        tmha.select_attention_impl("ring", head_dim=64, q_len=128, kv_len=128,
                                   use_cache=False, backend="cuda",
                                   mesh={"data": 1, "fsdp": 1, "sequence": 1, "tensor": 2})
    assert tmha.select_attention_impl(
        impl if impl == "auto" else "ring", head_dim=64, q_len=128, kv_len=128,
        use_cache=False, backend="cuda", causal=True,
        mesh={"data": 1, "fsdp": 1, "sequence": 2, "tensor": 1})[0] == "ring"
    assert tmha.select_decode_impl("ring", head_dim=64, q_len=1, kv_len=128, backend="cuda") == \
        ("xla", "ring attention has no KV-cache decode path")


@pytest.mark.parametrize("causal", [False, True])
def test_flash_forward_untileable_length_matches_plain_jax(causal):
    """A length the TPU kernel cannot tile (100) runs in the port: the
    wrapper's plain version against the JAX package's plain attention."""
    from distributed_llms_example_tpu.ops.attention import dot_product_attention, make_causal_bias

    rng = np.random.RandomState(4)
    B, H, S, d = 2, 2, 100, 16
    q, k, v = _qkv(rng, B, H, S, S, d)
    bias = np.where(np.arange(S)[None, :] < np.array([S, 61])[:, None], 0.0, NEG_INF)
    bias = bias.astype(np.float32)[:, None, None, :]
    jbias = jnp.asarray(bias) + (make_causal_bias(S, S) if causal else 0.0)
    want = np.asarray(dot_product_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jbias))
    o_t, _ = _torch_fwd(q, k, v, bias, causal)
    np.testing.assert_allclose(o_t, want, atol=ATOL)


def test_flash_decode_untileable_cache_matches_plain_jax():
    """A 40-slot cache (not tileable on the TPU) runs in the port: the
    wrapper's plain version against the JAX package's per-row masked plain
    attention."""
    from distributed_llms_example_tpu.ops.attention import dot_product_attention
    from distributed_llms_example_tpu.ops.mha import decode_step_bias

    rng = np.random.RandomState(6)
    B, H, Q, L, d = 3, 2, 4, 40, 16
    q, k, v = _decode_inputs(rng, B, H, Q, L, d)
    offsets = np.array([0, 17, L - Q], np.int32)
    step = decode_step_bias(jnp.asarray(offsets), Q, L)
    want = np.asarray(dot_product_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), step))
    got = tfa.flash_decode(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                           offsets=torch.from_numpy(offsets)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_flash_forward_rejects_bad_shapes():
    x = torch.zeros(1, 1, 128, 16)
    with pytest.raises(ValueError, match="causal"):
        tfa.flash_attention(x, torch.zeros(1, 1, 256, 16), torch.zeros(1, 1, 256, 16), causal=True)
    with pytest.raises(ValueError, match="bias dim"):
        tfa.flash_attention(x, x, x, torch.zeros(1, 1, 2, 128))
    with pytest.raises(ValueError, match="1..8"):
        tfa.flash_decode(torch.zeros(1, 1, 9, 16), x, x, offsets=torch.zeros(1, dtype=torch.int32))


def _decode_inputs(rng, B, H, Q, L, d):
    q = rng.randn(B, H, Q, d).astype(np.float32)
    k = rng.randn(B, H, L, d).astype(np.float32)
    v = rng.randn(B, H, L, d).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("q_len", [1, 4, 8])
@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("L, d", [(64, 16), (128, 32), (256, 32)])
def test_flash_decode_matches_jax(q_len, with_bias, L, d):
    """Against the Pallas decode kernel in interpret mode, at cache lengths
    of one and of several of its tiles."""
    rng = np.random.RandomState(3 + q_len + L - 64)
    B, H = 3, 2
    q, k, v = _decode_inputs(rng, B, H, q_len, L, d)
    offsets = np.array([0, L // 2 - 3, L - q_len], np.int32)  # fresh slot, mid-decode, cache full
    bias = None
    if with_bias:
        bias = np.where(rng.rand(B, 1, 1, L) > 0.2, 0.0, NEG_INF).astype(np.float32)
    want = np.asarray(jfa.flash_decode(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        None if bias is None else jnp.asarray(bias), offsets=jnp.asarray(offsets), interpret=True,
    ))
    got = tfa.flash_decode(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        None if bias is None else torch.from_numpy(bias), offsets=torch.from_numpy(offsets),
    ).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("q_len", [1, 8])
def test_flash_decode_int8_matches_jax(q_len):
    rng = np.random.RandomState(11)
    B, H, L, d = 2, 2, 64, 16
    q, k, v = _decode_inputs(rng, B, H, q_len, L, d)
    kq, ks = jfa.quantize_kv(jnp.asarray(k))
    vq, vs = jfa.quantize_kv(jnp.asarray(v))
    offsets = np.array([5, L - q_len], np.int32)
    want = np.asarray(jfa.flash_decode(
        jnp.asarray(q), kq, vq, offsets=jnp.asarray(offsets), k_scale=ks, v_scale=vs,
        interpret=True,
    ))
    got = tfa.flash_decode(
        torch.from_numpy(q), torch.from_numpy(np.array(kq)), torch.from_numpy(np.array(vq)),
        offsets=torch.from_numpy(offsets), k_scale=torch.from_numpy(np.array(ks)),
        v_scale=torch.from_numpy(np.array(vs)),
    ).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_flash_decode_stale_cache_unreachable():
    """Whatever sits beyond a row's offset (a previous occupant's K/V) must
    not change the output by a single bit."""
    rng = np.random.RandomState(1)
    B, H, L, d = 2, 2, 32, 16
    q, k, v = _decode_inputs(rng, B, H, 1, L, d)
    offsets = torch.tensor([3, 9], dtype=torch.int32)
    out = tfa.flash_decode(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                           offsets=offsets)
    beyond = torch.arange(L)[None, None, :, None] > offsets[:, None, None, None]
    out_poisoned = tfa.flash_decode(
        torch.from_numpy(q),
        torch.where(beyond, 1e6, torch.from_numpy(k)),
        torch.where(beyond, -1e6, torch.from_numpy(v)),
        offsets=offsets,
    )
    assert torch.equal(out, out_poisoned)


def test_quantize_kv_bit_exact():
    rng = np.random.RandomState(5)
    x = (rng.randn(2, 3, 40, 16) * 3.0).astype(np.float32)
    x[0, 0, 7] = 0.0  # an all-zero row takes scale 1
    qj, sj = jfa.quantize_kv(jnp.asarray(x))
    qt, st = tfa.quantize_kv(torch.from_numpy(x))
    assert qt.dtype == torch.int8 and st.dtype == torch.float32
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    np.testing.assert_array_equal(
        tfa.dequantize_kv(qt, st).numpy(), np.asarray(jfa.dequantize_kv(qj, sj))
    )


def test_wrappers_count_no_cpu_launches():
    """The launch counters move only where a CUDA kernel launches: the CPU
    runs the plain version and leaves them alone."""
    before = (tfa.flash_attention.launches, tfa.flash_decode.launches)
    x = torch.zeros(1, 1, 128, 16)
    tfa.flash_attention(x, x, x)
    tfa.flash_decode(x[:, :, :1], x, x, offsets=torch.zeros(1, dtype=torch.int32))
    assert (tfa.flash_attention.launches, tfa.flash_decode.launches) == before
