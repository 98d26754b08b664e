"""The port's fused clip+AdamW (its plain PyTorch version, which the
wrapper runs for CPU tensors) against the JAX package: per leaf against
``adamw_leaf_reference`` and ``fused_adamw_leaf(interpret=True)`` within
2 fp32 ulps (the port does one op at a time; XLA may contract a
multiply-add of either JAX version into an FMA), with the clip trigger and
weight decay on and off and a NaN counted once; the schedule step by step;
and three tree-apply steps against the optax chain on ``bart-test``
parameters, params within 1e-4 of the learning rate (Adam's g/sqrt(v)
turns an fp32 rounding of a tiny gradient into at most that).  The
multi-tensor launch's leaf table covering every element of every leaf
once (bart-test's and t5-test's real leaves, forced small limits, an empty
leaf, a leaf no float4 takes); the multi-leaf plain path bit-equal to
per-leaf ``adamw_leaf_plain``; the gradient pass against the JAX
package's ``g / tokens`` and ``optax.global_norm``."""

import bisect

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from distributed_llms_example_tpu.models.registry import load_model as jax_load_model
from distributed_llms_example_tpu.ops import fused_optim as jfo
from distributed_llms_example_tpu.train import optim as joptim
from distributed_llms_example_tpu_torch.models.from_jax import bart_state_dict_from_jax, load_jax_params
from distributed_llms_example_tpu_torch.models.registry import load_model
from distributed_llms_example_tpu_torch.ops import fused_optim as tfo
from distributed_llms_example_tpu_torch.train import optim as toptim

HYPER = dict(b1=0.9, b2=0.999, eps=1e-8, max_norm=1.0)
ULP2 = 2.4e-7


def _leaf(seed, n=4096, nan=False):
    rng = np.random.RandomState(seed)
    p, mu, g = (rng.randn(n).astype(np.float32) for _ in range(3))
    nu = (rng.rand(n) * 1e-2).astype(np.float32)
    if nan:
        g[17] = np.nan
    return p, mu, nu, g


@pytest.mark.parametrize("nan", [False, True])
@pytest.mark.parametrize("wd", [0.0, 0.01])
@pytest.mark.parametrize("trigger", [0.0, 1.0])
def test_leaf_matches_jax_reference_and_interpret_kernel(trigger, wd, nan):
    p, mu, nu, g = _leaf(int(trigger * 10 + wd * 100 + nan), nan=nan)
    scal = np.array([3.5, trigger, 0.1, 0.001, -1e-3, 0, 0, 0], np.float32)
    jargs = [jnp.asarray(a) for a in (p, mu, nu, g, scal)]
    ref = [np.asarray(x) for x in jfo.adamw_leaf_reference(*jargs, wd=wd, **HYPER)]
    ker = [np.asarray(x) for x in jfo.fused_adamw_leaf(*jargs, wd=wd, interpret=True, **HYPER)]
    tp, tmu, tnu = (torch.from_numpy(a.copy()) for a in (p, mu, nu))
    stats = tfo.fused_adamw_leaf(tp, tmu, tnu, torch.from_numpy(g), torch.from_numpy(scal),
                                 wd=wd, **HYPER)
    for name, got, r, k in zip(("p", "mu", "nu"), (tp, tmu, tnu), ref, ker):
        np.testing.assert_allclose(got.numpy(), r, rtol=ULP2, atol=ULP2, err_msg=name)
        np.testing.assert_allclose(got.numpy(), k, rtol=ULP2, atol=ULP2, err_msg=name)
    st = stats.float().numpy()
    np.testing.assert_allclose(st[:2], ref[3][:2], rtol=1e-5)
    assert st[tfo.STAT_NONFINITE] == ref[3][jfo.STAT_NONFINITE] == float(nan)
    assert np.isnan(tp.numpy()).sum() == int(nan)  # the NaN stays in its own element
    # the plain version itself returns the same values out of place
    p2, mu2, nu2, _ = tfo.adamw_leaf_plain(*(torch.from_numpy(a) for a in (p, mu, nu, g, scal)),
                                           wd=wd, **HYPER)
    np.testing.assert_array_equal(p2.numpy(), tp.numpy())


def test_scalar_and_stats_layout_match_jax():
    assert (tfo._S_GNORM, tfo._S_TRIGGER, tfo._S_BC1, tfo._S_BC2, tfo._S_NEG_LR) == (
        jfo._S_GNORM, jfo._S_TRIGGER, jfo._S_BC1, jfo._S_BC2, jfo._S_NEG_LR)
    assert (tfo.SCALARS, tfo.STATS) == (jfo.SCALARS, jfo.STATS)
    assert (tfo.STAT_P_SUMSQ, tfo.STAT_U_SUMSQ, tfo.STAT_NONFINITE) == (
        jfo.STAT_P_SUMSQ, jfo.STAT_U_SUMSQ, jfo.STAT_NONFINITE)


@pytest.mark.parametrize("warmup,total", [(0, 20), (5, 20), (7, 7), (3, 1000)])
def test_schedule_equals_jax_at_every_step(warmup, total):
    js = joptim.linear_schedule_with_warmup(1e-4, warmup, total)
    ts = toptim.linear_schedule_with_warmup(1e-4, warmup, total)
    for step in range(total + 3):
        assert np.float32(ts(step)) == np.asarray(js(jnp.int32(step)), np.float32), step


def test_decay_mask_matches_jax_on_bart():
    lm = jax_load_model("bart-test")
    params = jax.device_get(lm.init_params(0))
    jmask = bart_state_dict_from_jax(jax.tree.map(lambda m: np.float32(m),
                                                  joptim.decay_mask(params)))
    tlm = load_model("bart-test", device="cpu", train=True)
    for name, p in tlm.module.named_parameters():
        assert toptim.decay_mask(name, p) == bool(jmask[name].item()), name


@pytest.fixture(scope="module")
def bart_params():
    lm = jax_load_model("bart-test")
    return jax.device_get(lm.init_params(0))


def test_three_tree_steps_match_the_optax_chain(bart_params):
    params = bart_params
    lr = 1e-3
    tx, schedule, spec = joptim.make_optimizer_bundle(
        learning_rate=lr, weight_decay=0.01, warmup_steps=1, total_steps=10, max_grad_norm=1.0)
    opt_state = tx.init(params)
    tlm = load_model("bart-test", device="cpu", train=True)
    load_jax_params(tlm.module, params)
    named = list(tlm.module.named_parameters())
    tspec = toptim.OptimizerSpec(learning_rate=lr, weight_decay=0.01, warmup_steps=1,
                                 total_steps=10, max_grad_norm=1.0)
    tsched = toptim.linear_schedule_with_warmup(lr, 1, 10)
    state = toptim.AdamWState.zeros([p for _, p in named])
    rng = np.random.RandomState(0)
    jparams = params
    for step, scale in enumerate((0.01, 3.0, 0.05)):  # the middle step clips
        grads = jax.tree.map(lambda x: (rng.randn(*x.shape) * scale).astype(np.float32), params)
        updates, opt_state = tx.update(grads, opt_state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        tgrads = bart_state_dict_from_jax(grads)
        psq = torch.stack([torch.sum(p.detach().double() ** 2) for _, p in named])
        gnorm = toptim.fused_optimizer_apply(tspec, tsched, named, state,
                                             [tgrads[n].clone() for n, _ in named],
                                             torch.ones(()))
        np.testing.assert_allclose(float(gnorm), float(optax.global_norm(grads)), rtol=1e-5)
        # the state's health table is refilled each step, not accumulated
        np.testing.assert_allclose(state.stats[:, tfo.STAT_P_SUMSQ].numpy(), psq.numpy(),
                                   rtol=1e-5)
        assert not state.stats[:, tfo.STAT_NONFINITE].any()
        want = bart_state_dict_from_jax(jax.device_get(jparams))
        for n, p in named:
            np.testing.assert_allclose(p.detach().numpy(), want[n].numpy(), rtol=0,
                                       atol=1e-4 * lr, err_msg=f"step {step} {n}")
    assert state.count == 3


def test_cuda_wrapper_refuses_cpu_tensors():
    z = torch.zeros(8)
    table = tfo.leaf_table([z], [z], [z], [z])
    with pytest.raises(ValueError, match="expected a CUDA device"):
        tfo._adamw_cuda(table, z, torch.zeros(4, dtype=torch.float64), wd=0.0, **HYPER)
    with pytest.raises(ValueError, match="expected a CUDA device"):
        tfo._grad_prep_cuda(table, torch.ones(()))


def _leaves(name):
    """The real parameter tensors of a test model, an empty leaf and a
    leaf one float off 16-byte alignment appended."""
    params = [p.detach() for p in load_model(name, device="cpu", train=True).module.parameters()]
    return params + [torch.zeros(0), torch.zeros(1001)[1:]]


@pytest.mark.parametrize("chunk,max_leaves", [(4, 3), (64, 7), (tfo.CHUNK, tfo.MAX_LEAVES)])
@pytest.mark.parametrize("name", ["bart-test", "t5-test"])
def test_leaf_table_covers_every_element_once(name, chunk, max_leaves):
    """Each launch's leaves, and each work item mapped to its (leaf, chunk)
    as the kernels map it (the last leaf whose first item is at most the
    item's index), cover every element of every leaf exactly once."""
    leaves = _leaves(name)
    decay = [i % 3 == 0 for i in range(len(leaves))]
    table = tfo.leaf_table(leaves, leaves, leaves, leaves, decay, chunk=chunk,
                           max_leaves=max_leaves)
    seen = [np.zeros(t.numel(), np.int64) for t in leaves]
    covered = []
    for lo, hi, first in table.groups:
        assert 1 <= hi - lo <= max_leaves and first[0] == 0 and first.dtype == np.int32
        covered += range(lo, hi)
        for item in range(int(first[-1])):
            leaf = bisect.bisect_right(first, item) - 1
            start = (item - int(first[leaf])) * chunk
            n = int(table.numel[lo + leaf])
            assert 0 <= start < n
            seen[lo + leaf][start:min(n, start + chunk)] += 1
    assert covered == list(range(len(leaves)))
    assert all((s == 1).all() for s in seen)
    assert table.ptrs[:, 3].tolist() == [t.data_ptr() for t in leaves]
    vec = (table.flags & tfo.FLAG_VEC) != 0
    assert vec.tolist() == [t.data_ptr() % 16 == 0 for t in leaves] and not vec[-1]
    assert ((table.flags & tfo.FLAG_DECAY) != 0).tolist() == decay


def test_with_grads_equals_a_fresh_table():
    """A step's table from the cached one (the parameters and moments
    checked once, new gradients each step) equals the table built from
    scratch, an unaligned gradient included; a bad gradient is refused."""
    params = _leaves("t5-test")
    decay = [i % 2 == 0 for i in range(len(params))]
    base = tfo.leaf_table(params, params, params, params, decay)
    grads = [torch.zeros(t.numel() + 1)[1:].view(t.shape) if i == 3 else torch.zeros_like(t)
             for i, t in enumerate(params)]
    got, want = base.with_grads(grads), tfo.leaf_table(grads, params, params, params, decay)
    np.testing.assert_array_equal(got.ptrs, want.ptrs)
    np.testing.assert_array_equal(got.flags, want.flags)
    assert not got.flags[3] & tfo.FLAG_VEC and base.flags[3] & tfo.FLAG_VEC
    with pytest.raises(ValueError, match="g of leaf 0"):
        base.with_grads([grads[0].double()] + grads[1:])


def test_leaf_table_refuses_what_the_kernel_cannot_take():
    g = torch.zeros(8)
    for bad in (torch.zeros(8, dtype=torch.float64), torch.zeros(9), torch.zeros(4, 4).t()):
        with pytest.raises(ValueError, match="leaf table"):
            tfo.leaf_table([g], [bad])
    with pytest.raises(ValueError, match="multiple of 4"):
        tfo.leaf_table([g], chunk=6)


def test_multi_leaf_plain_path_equals_per_leaf_plain():
    """adamw_tree_apply on the CPU (the multi-leaf path's plain version),
    mixed decay flags, one NaN: bit-equal to adamw_leaf_plain leaf by leaf,
    and the NaN counted once, in its own leaf's row."""
    rng = np.random.RandomState(7)
    shapes = [(64, 32), (32,), (1001,), (16, 16), (0,), (50265,)]
    leaves = [[torch.from_numpy(rng.randn(*s).astype(np.float32)) for s in shapes]
              for _ in range(4)]
    leaves[2] = [v.abs() * 1e-2 for v in leaves[2]]
    leaves[3][2][500] = float("nan")
    decay = [True, False, False, True, False, True]
    scal = torch.tensor([3.5, 0.0, 0.1, 0.001, -1e-3, 0, 0, 0])
    want = [tfo.adamw_leaf_plain(p, m, v, g, scal, wd=0.01 if d else 0.0, **HYPER)
            for p, m, v, g, d in zip(*leaves, decay)]
    p, mu, nu, g = ([t.clone() for t in col] for col in leaves)
    stats = torch.full((len(shapes), tfo.STATS), 7.0, dtype=torch.float64)
    tfo.adamw_tree_apply(p, mu, nu, g, scal, stats, weight_decay=0.01, decay=decay, **HYPER)
    for i, (wp, wmu, wnu, wst) in enumerate(want):
        for got, w in ((p[i], wp), (mu[i], wmu), (nu[i], wnu)):
            np.testing.assert_array_equal(got.numpy(), w.numpy())
        np.testing.assert_array_equal(stats[i].numpy(), wst.double().numpy())
    assert stats[:, tfo.STAT_NONFINITE].tolist() == [0, 0, 1, 0, 0, 0]


@pytest.mark.parametrize("name", ["bart-test", "t5-test"])
def test_grad_prep_matches_jax_division_and_global_norm(name):
    """grad_prep_plain (the CPU path of fused_grad_prep) on a model's leaf
    shapes: the divided gradients bit-equal to ``div_``'s and to the JAX
    package's ``g / tokens``; the norm within 1e-6 of ``optax.global_norm``
    of them (float64 sums here, fp32 in optax)."""
    rng = np.random.RandomState(3)
    shapes = [tuple(t.shape) for t in _leaves(name)]
    grads = [(rng.randn(*s) * 10.0 ** rng.uniform(-3, 3)).astype(np.float32) for s in shapes]
    tokens = np.float32(977.0)
    jgrads = [jnp.asarray(g) / jnp.float32(tokens) for g in grads]
    got = [torch.from_numpy(g.copy()) for g in grads]
    gnorm = tfo.fused_grad_prep(got, torch.tensor(tokens))
    assert gnorm.dtype == torch.float32 and gnorm.shape == ()
    for g, t, j in zip(grads, got, jgrads):
        np.testing.assert_array_equal(t.numpy(), torch.from_numpy(g).div_(torch.tensor(tokens)))
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    np.testing.assert_allclose(float(gnorm), float(optax.global_norm(jgrads)), rtol=1e-6)
    want = np.sqrt(sum(np.sum(np.asarray(j, np.float64) ** 2) for j in jgrads))
    assert float(gnorm) == np.float32(want)


def test_step_scalars_take_host_values_by_fill_not_copy(monkeypatch):
    """Building the kernel's scalar vector waits on nothing: every value set
    into it is a tensor on its device (the gradient norm, and -lr and the
    bias corrections made there by fills), never a Python number, which
    PyTorch copies into a CUDA tensor from a host tensor, a copy that syncs
    the stream.  On the CPU the vector is the one the plain expressions
    give, bit for bit."""
    spec = toptim.OptimizerSpec(learning_rate=3e-4, warmup_steps=2, total_steps=10)
    sched = toptim.linear_schedule_with_warmup(spec.learning_rate, spec.warmup_steps,
                                               spec.total_steps)
    assigned = []
    setitem = torch.Tensor.__setitem__

    def recording(self, idx, value):
        assigned.append(type(value))
        return setitem(self, idx, value)

    monkeypatch.setattr(torch.Tensor, "__setitem__", recording)
    for count in (0, 1, 5, 9):
        gnorm = torch.tensor(0.75)
        got = toptim.step_scalars(spec, sched, count, gnorm)
        c = torch.tensor(count + 1, dtype=torch.float32)
        want = {toptim._S_GNORM: gnorm, toptim._S_TRIGGER: torch.tensor(1.0),
                toptim._S_BC1: 1 - torch.tensor(spec.b1) ** c,
                toptim._S_BC2: 1 - torch.tensor(spec.b2) ** c,
                toptim._S_NEG_LR: torch.tensor(-1 * sched(count))}
        for i, v in want.items():
            assert got[i].item() == v.float().item(), (count, i)
    assert assigned and set(assigned) == {torch.Tensor}
