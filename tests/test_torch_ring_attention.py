"""The port's ring attention (``ops/ring_attention.py``) against the JAX
package's ``ring_attention_sharded`` on a CPU mesh of the same sequence
axis: rings of 2 and 4 gloo ranks on the CPU (one subprocess a rank,
``tests/torch_dist_worker.py``), causal and not, with a K-only padding
bias and without, and the cross-attention lengths (32 keys for 16
queries): the output and the q, k and v gradients, the ring's blocks
merged in order, within 1e-5 in fp32.  Every hop sent the wrong way round
a ring of 4 (the planted fault) must miss it by orders of magnitude.  And
the cross-shard label shift (``parallel/activation.seq_shift_labels``)
equal to the JAX package's ``_seq_shift_labels`` in a ``shard_map``.

In bf16 (the default compute dtype), at 1x and 2x unit-normal inputs: one
causal (2, 4, 256, 128) tile through the port's ``_block_update`` and a
ring of 2 through ``ring_attention`` must each lie within 1.5x the JAX
package's bf16 result's own distance from fp32 (max |out - fp32 out|):
Q·Kᵀ and P·V are fp32 accumulations of bf16 operands, as JAX's products
on the MXU; the pre-repair rounding (bf16 products widened afterwards)
must miss that bound at 2x."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

from distributed_llms_example_tpu.ops.attention import NEG_INF
from distributed_llms_example_tpu.ops.ring_attention import ring_attention_sharded
from torch_dist_helpers import jax_mesh, spawn

TOL = 1e-5  # fp32, the forward and every gradient
B, H, D = 2, 2, 8
# (name, q length, kv length, causal, K-only bias)
CASES = [("causal_bias", 16, 16, True, True), ("causal", 16, 16, True, False),
         ("full_bias", 16, 16, False, True), ("cross_bias", 16, 32, False, True),
         ("cross", 16, 32, False, False)]
RINGS = [2, 4]
# bf16 ring cases: (name, input scale), causal, no bias, on the ring of 2
BF16_CASES = [("bf16_x1", 1.0), ("bf16_x2", 2.0)]
BF16_SHAPE = (2, 2, 64, 64)
BF16_FACTOR = 1.5  # the port's bf16 distance from fp32 over JAX's bf16 distance


def _bf16_values(x):
    """``x`` rounded to bf16 and back: the fp32 reference and both bf16
    runs see the same inputs."""
    import torch

    return torch.from_numpy(x).bfloat16().float().numpy()


def _arrays():
    rng = np.random.RandomState(7)
    out = {}
    for name, sq, sk, _, _ in CASES:
        for a, s in (("q", sq), ("k", sk), ("v", sk), ("dout", sq)):
            out[f"{name}/{a}"] = rng.normal(size=(B, H, s, D)).astype(np.float32)
        # row 1 pads its last quarter of keys
        keep = np.arange(sk)[None, :] < np.array([sk, 3 * sk // 4])[:, None]
        out[f"{name}/bias"] = np.where(keep, 0.0, NEG_INF).astype(np.float32)[:, None, None, :]
    for name, scale in BF16_CASES:
        for a in ("q", "k", "v", "dout"):
            out[f"{name}/{a}"] = _bf16_values(
                (rng.normal(size=BF16_SHAPE) * scale).astype(np.float32))
    return out


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    path = tmp_path_factory.mktemp("ring") / "inputs.npz"
    arrays = _arrays()
    np.savez(path, **arrays)
    return str(path), arrays


def _jax(arrays, name, causal, with_bias, n):
    mesh, _ = jax_mesh(f"sequence={n}")
    q, k, v, dout = (jnp.asarray(arrays[f"{name}/{a}"]) for a in ("q", "k", "v", "dout"))
    bias = jnp.asarray(arrays[f"{name}/bias"]) if with_bias else None

    @jax.jit
    def run(q, k, v, dout):
        out, vjp = jax.vjp(lambda q, k, v: ring_attention_sharded(
            q, k, v, bias, mesh=mesh, causal=causal), q, k, v)
        return (out, *vjp(dout))

    out, dq, dk, dv = run(q, k, v, dout)
    return {"out": out, "dq": dq, "dk": dk, "dv": dv}


# the planted fault's case, run again on the ring of 4 with every hop sent
# the wrong way round
PLANTED = "causal_bias"


@pytest.fixture(scope="module")
def port_runs(inputs, tmp_path_factory):
    path, _ = inputs
    cases = [{"name": c[0], "causal": c[3], "bias": c[4]} for c in CASES]
    out = {}
    bf16 = [{"name": name, "causal": True, "bias": False, "dtype": "bfloat16"}
            for name, _ in BF16_CASES]
    for n in RINGS:
        spec = {"ops": {"kind": "ring", "inputs": path,
                        "cases": cases + (bf16 if n == 2 else []),
                        "planted": [PLANTED] if n == 4 else []}}
        out[n] = spawn(spec, n, tmp_path_factory.mktemp(f"ring{n}"), name=f"ring{n}")[2]
    return out


@pytest.mark.parametrize("n", RINGS)
@pytest.mark.parametrize("case", range(len(CASES)), ids=[c[0] for c in CASES])
def test_ring_matches_jax_forward_and_gradient(inputs, port_runs, n, case):
    name, _, _, causal, with_bias = CASES[case]
    want = _jax(inputs[1], name, causal, with_bias, n)
    got = port_runs[n]["cases"][case]
    for key in ("out", "dq", "dk", "dv"):
        err = float(np.abs(got[key].numpy() - np.asarray(want[key])).max())
        assert err <= TOL, (name, n, key, err)


def test_a_hop_the_wrong_way_breaks_the_limit(inputs, port_runs):
    """Every hop sent to the right neighbour instead of the left: a ring of
    4 then folds the blocks of ranks i - t in place of i + t, and the
    causal outputs and gradients miss JAX's by far more than the limit."""
    (planted,) = port_runs[4]["planted"]
    want = _jax(inputs[1], PLANTED, True, True, 4)
    err = max(float(np.abs(planted[k].numpy() - np.asarray(want[k])).max())
              for k in ("out", "dq", "dk", "dv"))
    assert err > 1e3 * TOL, err


@pytest.mark.parametrize("n", [2, 4])
def test_seq_shift_labels_matches_jax(n):
    """Each shard's next-token targets from the whole rows equal the JAX
    package's one-column ppermute in a manual sequence region."""
    import torch

    from distributed_llms_example_tpu.models.llama import _seq_shift_labels
    from distributed_llms_example_tpu.parallel.activation import compat_shard_map
    from distributed_llms_example_tpu_torch.parallel.activation import seq_shift_labels

    rng = np.random.RandomState(n)
    labels = rng.randint(-100, 50, size=(3, 8 * n)).astype(np.int32)
    mesh, _ = jax_mesh(f"sequence={n}")
    want = compat_shard_map(lambda x: _seq_shift_labels(x, "sequence", n), mesh=mesh,
                            in_specs=(P(None, "sequence"),), out_specs=P(None, "sequence"),
                            check_vma=False)(jnp.asarray(labels))
    got = torch.cat([seq_shift_labels(torch.from_numpy(labels), i, n) for i in range(n)], dim=1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _jax_bf16_ring(arrays, name):
    """JAX's ``ring_attention_sharded`` on a sequence=2 mesh with bf16
    q/k/v (the output as fp32)."""
    mesh, _ = jax_mesh("sequence=2")
    q, k, v = (jnp.asarray(arrays[f"{name}/{a}"], jnp.bfloat16) for a in ("q", "k", "v"))
    out = jax.jit(lambda q, k, v: ring_attention_sharded(q, k, v, None, mesh=mesh,
                                                         causal=True))(q, k, v)
    return np.asarray(out.astype(jnp.float32))


@pytest.mark.parametrize("case", range(len(BF16_CASES)), ids=[c[0] for c in BF16_CASES])
def test_bf16_ring_within_jax_bf16_distance_from_fp32(inputs, port_runs, case):
    """The bf16 ring of 2 (its scores fp32 accumulations) within 1.5x the
    JAX package's bf16 ring's own distance from the fp32 ring."""
    name, _ = BF16_CASES[case]
    arrays = inputs[1]
    ref = np.asarray(_jax(arrays, name, True, False, 2)["out"])
    jax_err = float(np.abs(_jax_bf16_ring(arrays, name) - ref).max())
    got = port_runs[2]["cases"][len(CASES) + case]["out"].numpy()
    err = float(np.abs(got - ref).max())
    assert 0.0 < jax_err and err <= BF16_FACTOR * jax_err, (name, err, jax_err)


def _tile_out(update, q, k, v, causal=True):
    """One tile folded into the initial state and normalized: acc / l."""
    import torch

    b, h, s, d = q.shape
    m = torch.full((b, h, s, 1), -torch.inf)
    l = torch.zeros((b, h, s, 1))
    acc = torch.zeros((b, h, s, d))
    pos = torch.arange(s)
    _, l, acc = update(m, l, acc, q, k, v, None, pos, pos, scale=d ** -0.5, causal=causal)
    return (acc / l).numpy()


@pytest.mark.parametrize("scale", [1.0, 2.0], ids=["x1", "x2"])
def test_bf16_block_update_within_jax_bf16_distance_from_fp32(scale, monkeypatch):
    """One causal (2, 4, 256, 128) tile, seed 0: the port's bf16
    ``_block_update`` within 1.5x JAX's bf16 ``_block_update``'s distance
    from the fp32 tile; at 2x scale the pre-repair scores (the bf16
    product rounded, then widened) miss that bound."""
    import torch

    from distributed_llms_example_tpu.ops.ring_attention import _block_update as jax_update
    from distributed_llms_example_tpu_torch.ops import ring_attention as ra

    rng = np.random.RandomState(0)
    q, k, v = (_bf16_values((rng.normal(size=(2, 4, 256, 128)) * scale).astype(np.float32))
               for _ in range(3))
    t32 = [torch.from_numpy(x) for x in (q, k, v)]
    ref = _tile_out(ra._block_update, *t32)
    port = _tile_out(ra._block_update, *(x.bfloat16() for x in t32))
    pos = jnp.arange(256)
    carry = (jnp.full((2, 4, 256, 1), -jnp.inf), jnp.zeros((2, 4, 256, 1)),
             jnp.zeros((2, 4, 256, 128)))
    _, jl, jacc = jax_update(carry, *(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)), None,
                             pos, pos, scale=128 ** -0.5, causal=True)
    jax_err = float(np.abs(np.asarray(jacc / jl) - ref).max())
    err = float(np.abs(port - ref).max())
    assert err <= BF16_FACTOR * jax_err, (scale, err, jax_err)
    # the pre-repair products: bf16 results, widened afterwards
    monkeypatch.setattr(ra, "mm32", lambda a, b, dtype: torch.matmul(
        a.to(dtype), b.to(dtype)).float())
    rounded = float(np.abs(_tile_out(ra._block_update, *(x.bfloat16() for x in t32))
                           - ref).max())
    if scale == 2.0:
        assert rounded > BF16_FACTOR * jax_err, (rounded, jax_err)
