"""The port's mesh, process-group facts and batch plan against the JAX
package's, on the CPU, in one process: ``core/mesh.py`` (``MeshConfig``
parsing, ``resolve_mesh_shape``, the Valohai / ``VH_*`` / torchrun facts,
the local fallback, partial facts refused, NCCL for CUDA and gloo for the
CPU and never one for the other), ``host_batch_slices``,
``microbatch_size`` / ``validate_batch_mesh`` and ``BatchIterator`` with
``process_count=2`` (each process's rows and widths), the dropout seed
fold of every rank against JAX's ``_shard_seed`` on a 2 x 2 mesh; kernel
8's split norm in its plain version (world 1 bit-equal to the one-pass
norm, two halves' float64 partials within one fp32 ulp, leaves of no
element in the tables and the passes); remat replaying a rank's folded
dropout seeds bit for bit; and, over ``torch.testing``'s fake
process group at world 4, ``parallel/fsdp.shard_model`` on a meta-device
llama-2-7b (32 layers) holding a quarter of its 6.74 B parameters a rank
and keeping every parameter name."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llms_example_tpu.core import config as jconfig
from distributed_llms_example_tpu.core import mesh as jmesh
from distributed_llms_example_tpu.data import batching as jbatching
from distributed_llms_example_tpu.data import dataset as jdataset
from distributed_llms_example_tpu.data.tokenizer import ByteTokenizer as JaxByteTokenizer
from distributed_llms_example_tpu_torch.core import config as tconfig
from distributed_llms_example_tpu_torch.core import mesh as tmesh
from distributed_llms_example_tpu_torch.data import batching as tbatching
from distributed_llms_example_tpu_torch.data import dataset as tdataset
from distributed_llms_example_tpu_torch.data.tokenizer import ByteTokenizer
from distributed_llms_example_tpu_torch.ops import fused_dropout as tfd
from distributed_llms_example_tpu_torch.ops import fused_optim as fo

FACT_ENV = ("VH_MASTER_IP", "VH_WORLD_SIZE", "VH_RANK", "MASTER_ADDR", "WORLD_SIZE", "RANK",
            "MASTER_PORT")


def _outcome(fn):
    try:
        out = fn()
    except ValueError as e:
        return ("ValueError", str(e))
    return ("ok", out)


def _resolve(mod, cfg_mod, sizes, n):
    spec = mod.resolve_mesh_shape(cfg_mod.MeshConfig(**sizes), n)
    return spec.data, spec.fsdp, spec.size


# the cases of the JAX package's tests/test_mesh.py, each run through both
CASES = {
    "resolve_wildcard": lambda mod, cfg: _resolve(mod, cfg, dict(data=-1, fsdp=2), 8),
    "resolve_exact": lambda mod, cfg: _resolve(mod, cfg, dict(data=8, fsdp=1), 8),
    "resolve_fsdp_wildcard": lambda mod, cfg: _resolve(mod, cfg, dict(data=2, fsdp=-1), 4),
    "resolve_product_mismatch": lambda mod, cfg: _resolve(mod, cfg, dict(data=3, fsdp=2), 8),
    "resolve_not_divisible": lambda mod, cfg: _resolve(mod, cfg, dict(data=-1, fsdp=3), 8),
    "resolve_zero_axis": lambda mod, cfg: _resolve(mod, cfg, dict(data=-1, fsdp=0), 8),
    "resolve_two_wildcards": lambda mod, cfg: _resolve(mod, cfg, dict(data=-1, fsdp=-1), 8),
    "parse_data_fsdp": lambda mod, cfg: cfg.parse_mesh_arg("data=2,fsdp=4").axis_sizes(),
    "parse_empty": lambda mod, cfg: cfg.parse_mesh_arg("").axis_sizes(),
    "parse_fsdp_wildcard": lambda mod, cfg: cfg.parse_mesh_arg("fsdp=-1").axis_sizes(),
    "parse_unknown_axis": lambda mod, cfg: cfg.parse_mesh_arg("fsdpp=2").axis_sizes(),
}

ENVS = {
    "valohai_env": {"VH_MASTER_IP": "10.0.0.7", "VH_WORLD_SIZE": "4", "VH_RANK": "2"},
    "torchrun_env": {"MASTER_ADDR": "10.0.0.9", "WORLD_SIZE": "2", "RANK": "1"},
    "valohai_over_torchrun": {"VH_MASTER_IP": "10.0.0.7", "VH_WORLD_SIZE": "4",
                              "VH_RANK": "3", "MASTER_ADDR": "10.0.0.9", "WORLD_SIZE": "2",
                              "RANK": "1"},
    "local_fallback": {},
    "world_without_rank": {"MASTER_ADDR": "10.0.0.9", "WORLD_SIZE": "2"},
}

PARTIAL = {
    "no_coordinator": dict(num_processes=4, process_id=1),
    "no_process_id": dict(coordinator_address="10.0.0.1", num_processes=4),
    "world_of_one": dict(num_processes=1),
}

ALL = ([("case", k) for k in CASES] + [("env", k) for k in ENVS]
       + [("partial", k) for k in PARTIAL])


@pytest.mark.parametrize("kind,name", ALL, ids=[f"{k}-{n}" for k, n in ALL])
def test_mesh_and_facts_match_jax(monkeypatch, kind, name):
    """Every case of the JAX package's mesh tests, through both packages:
    the same resolved shape or the same ValueError message; the same
    rendezvous facts from each environment; partial facts refused with
    the JAX messages, a world of one creating no group."""
    for k in FACT_ENV:
        monkeypatch.delenv(k, raising=False)
    if kind == "case":
        got = _outcome(lambda: CASES[name](tmesh, tconfig))
        want = _outcome(lambda: CASES[name](jmesh, jconfig))
        assert got == want
    elif kind == "env":
        for k, v in ENVS[name].items():
            monkeypatch.setenv(k, v)
        assert tmesh._valohai_facts() == jmesh._valohai_facts()
    else:
        monkeypatch.setattr(torch.distributed, "init_process_group",
                            lambda *a, **k: pytest.fail("a group was created"))
        monkeypatch.setattr(jax.distributed, "initialize",
                            lambda *a, **k: pytest.fail("a group was created"))
        got = _outcome(lambda: tmesh.initialize_distributed(**PARTIAL[name],
                                                             device_type="cpu"))
        want = _outcome(lambda: jmesh.initialize_distributed(**PARTIAL[name]))
        assert got[0] == want[0] and (got[0] == "ok" or got[1] == want[1])
        assert not tmesh.is_distributed()


@pytest.mark.parametrize("device,backend", [("cpu", "gloo"), ("cuda", "nccl")])
def test_backend_follows_the_device_and_never_falls_back(monkeypatch, device, backend):
    """The group's rendezvous store is the coordinator's TCPStore (rank 0
    serves it; here an in-memory stand-in), each generation of the group
    under its own prefix."""
    seen, stores = [], []
    monkeypatch.setattr(torch.distributed, "init_process_group",
                        lambda b, **k: seen.append((b, k)))
    monkeypatch.setattr(torch.distributed, "TCPStore",
                        lambda *a, **k: stores.append((a, k)) or torch.distributed.HashStore())
    monkeypatch.setattr(tmesh, "_STORES", {})
    monkeypatch.setattr(tmesh, "_GROUP_FACTS", {})
    monkeypatch.setattr(torch.cuda, "set_device", lambda d: seen.append(("device", str(d))))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setenv("LOCAL_RANK", "3")
    for k in FACT_ENV:
        monkeypatch.delenv(k, raising=False)
    assert tmesh.initialize_distributed("10.0.0.1", 4, 3, device_type=device) == 4
    b, kw = seen[-1]
    assert b == backend and {k: kw[k] for k in ("world_size", "rank")} == {"world_size": 4,
                                                                          "rank": 3}
    assert isinstance(kw["store"], torch.distributed.PrefixStore)
    assert [(a, k["is_master"]) for a, k in stores] == [(("10.0.0.1", 1234, 4), False)]
    if device == "cuda":
        assert seen[0] == ("device", "cuda:3")

    def nccl_fails(b, **k):
        raise RuntimeError(f"{b} unavailable")

    monkeypatch.setattr(torch.distributed, "init_process_group", nccl_fails)
    with pytest.raises(RuntimeError, match=backend):
        tmesh.initialize_distributed("10.0.0.1", 4, 3, device_type=device)


# (spec, whether the port lays it out): tensor and sequence parse as in the
# JAX package since the model-parallel slice; stage and expert, and fsdp
# beside tensor or sequence, stay refused
PARSE_CASES = [("tensor=2", True), ("sequence=2", True), ("stage=2", False),
               ("expert=2", False), ("tensor=-1", True), ("data=2,tensor=2", True),
               ("data=2,sequence=2,tensor=2", True), ("fsdp=2,tensor=2", False)]


@pytest.mark.parametrize("spec,ported", PARSE_CASES)
def test_model_parallel_axes_are_refused_at_parse_time(spec, ported):
    """The axes the port does not lay out (stage, expert, fsdp composed
    with tensor or sequence) raise at parse time; tensor and sequence
    parse to the JAX package's sizes."""
    assert jconfig.parse_mesh_arg(spec)  # the JAX package lays them out
    if ported:
        assert tconfig.parse_mesh_arg(spec).axis_sizes() == \
            jconfig.parse_mesh_arg(spec).axis_sizes()
    else:
        with pytest.raises(ValueError, match="ROADMAP.md item 6"):
            tconfig.parse_mesh_arg(spec)


@pytest.mark.parametrize("axis", ["tensor", "sequence", "stage", "expert"])
def test_resolve_refuses_an_axis_the_port_does_not_lay_out(axis):
    """A ``MeshConfig`` built past the parser: the JAX package resolves it;
    the port resolves tensor and sequence to the same sizes and refuses
    stage and expert rather than drop the axis."""
    cfg = dict(data=2, fsdp=1, **{axis: 2})
    want = jmesh.resolve_mesh_shape(jconfig.MeshConfig(**cfg), 4)
    assert want.size == 4
    if axis in ("tensor", "sequence"):
        got = tmesh.resolve_mesh_shape(tconfig.MeshConfig(**cfg), 4)
        assert got.axes() == {k: getattr(want, k) for k in got.axes()} and got.size == 4
    else:
        with pytest.raises(ValueError, match="ROADMAP.md item 6"):
            tmesh.resolve_mesh_shape(tconfig.MeshConfig(**cfg), 4)


def test_single_process_helpers():
    assert tmesh.process_count() == 1 and tmesh.process_index() == 0
    np.testing.assert_array_equal(tmesh.process_allgather(np.arange(3)), [[0, 1, 2]])
    report = tmesh.device_report(torch.device("cpu"))
    assert report["process_count"] == 1 and report["backend"] is None
    assert tmesh.mesh_coords(tmesh.MeshSpec(data=2, fsdp=2), 3) == (1, 1, 0, 0)
    # row-major in the JAX package's axis order: tensor fastest
    spec = tmesh.MeshSpec(data=2, fsdp=1, sequence=2, tensor=2)
    assert [tmesh.mesh_coords(spec, r) for r in (0, 1, 2, 5, 7)] == \
        [(0, 0, 0, 0), (0, 0, 0, 1), (0, 0, 1, 0), (1, 0, 0, 1), (1, 0, 1, 1)]
    assert all(tmesh.mesh_rank(spec, tmesh.mesh_coords(spec, r)) == r for r in range(8))


@pytest.mark.parametrize("gb,pc,pi", [(8, 2, 0), (8, 2, 1), (8, 4, 3), (6, 4, 0), (12, 3, 2)])
def test_host_batch_slices_match_jax(gb, pc, pi):
    assert _outcome(lambda: tdataset.host_batch_slices(gb, pc, pi)) == \
        _outcome(lambda: jdataset.host_batch_slices(gb, pc, pi))


@pytest.mark.parametrize("gb,accum,shards,pc", [(8, 1, 2, 2), (8, 2, 4, 4), (8, 3, 1, 1),
                                                 (8, 2, 8, 1), (6, 1, 2, 4), (0, 0, 1, 1)])
def test_microbatch_size_and_validate_batch_mesh_match_jax(gb, accum, shards, pc):
    assert _outcome(lambda: tbatching.microbatch_size(gb, accum, batch_shards=shards,
                                                       process_count=pc)) == \
        _outcome(lambda: jbatching.microbatch_size(gb, accum, batch_shards=shards,
                                                   process_count=pc))
    axes = {"data": shards, "fsdp": 1}
    assert _outcome(lambda: tbatching.validate_batch_mesh(gb, axes, process_count=pc,
                                                          grad_accum_steps=accum)) == \
        _outcome(lambda: jbatching.validate_batch_mesh(gb, axes, process_count=pc,
                                                       grad_accum_steps=accum))


def _records(n=40, seed=0):
    rng = np.random.RandomState(seed)
    alphabet = np.array(list("abcdefghijklmnopqrstuvwxyz   .,"))
    return [{"dialogue": "".join(rng.choice(alphabet, rng.randint(5, 200))),
             "summary": "".join(rng.choice(alphabet, rng.randint(2, 60)))} for _ in range(n)]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("pi", [0, 1])
def test_batch_iterator_rows_and_widths_per_process_match_jax(pi, causal):
    """``BatchIterator(process_count=2, process_index=k)`` in one process
    (the in-process P-iterator case): each process's rows, at the global
    batch's widths, equal the JAX iterator's, training and eval plans, and
    the two processes' rows side by side are the one-process batch."""
    recs = _records()
    kw = dict(max_source_length=128, max_target_length=32)
    if causal:
        port_ds = tdataset.CausalLMDataset(recs, ByteTokenizer(), max_length=128,
                                           max_target_length=32)
        jax_ds = jdataset.CausalLMDataset(recs, JaxByteTokenizer(), max_length=128,
                                          max_target_length=32)
        kw["max_target_length"] = 128
    else:
        port_ds = tdataset.SummarizationDataset(recs, ByteTokenizer(), max_source_length=128,
                                                max_target_length=32)
        jax_ds = jdataset.SummarizationDataset(recs, JaxByteTokenizer(), max_source_length=128,
                                               max_target_length=32)
    for plan in (dict(), dict(shuffle=False, drop_last=False)):
        common = dict(global_batch=8, seed=3, bucket_multiple=32, **kw, **plan)
        mine = list(tbatching.BatchIterator(port_ds, process_count=2, process_index=pi,
                                            **common).epoch(1))
        theirs = list(jbatching.BatchIterator(jax_ds, process_count=2, process_index=pi,
                                              **common).epoch(1))
        whole = list(tbatching.BatchIterator(port_ds, **common).epoch(1))
        assert len(mine) == len(theirs) == len(whole) > 0
        for a, b, w in zip(mine, theirs, whole):
            assert a.keys() == b.keys()
            for k in a:
                np.testing.assert_array_equal(a[k], b[k])
                np.testing.assert_array_equal(a[k], w[k][pi * 4:(pi + 1) * 4])


def test_dropout_seed_fold_matches_jax_shard_seed_on_a_2x2_mesh():
    """Each rank's fold of its (data, fsdp, expert) position into a seed
    (and the tensor axis's 0 for the probs dropout) equals the seed the JAX
    package's shard at that mesh position computes (``_shard_seed`` under
    ``shard_map``), wrapping int32 arithmetic included; one device: no
    fold."""
    from jax.sharding import PartitionSpec as P

    from distributed_llms_example_tpu.core.config import MeshConfig
    from distributed_llms_example_tpu.ops.fused_dropout import _shard_seed
    from distributed_llms_example_tpu.parallel.activation import compat_shard_map

    mesh = jmesh.build_mesh(MeshConfig(data=2, fsdp=2), devices=jax.devices()[:4])
    seeds = [0, 7, -5, 2**31 - 1, -(2**31), 123456789]
    for axes, heads in ((("data", "fsdp", "expert"), False),
                        (("data", "fsdp", "expert", "tensor"), True)):
        def run(s):
            return _shard_seed(s[0], axes)[None]

        fn = compat_shard_map(run, mesh=mesh, in_specs=(P(),),
                              out_specs=P(("data", "fsdp")), check_vma=False)
        for seed in seeds:
            want = np.asarray(fn(jnp.asarray([seed], jnp.int32)))
            got = []
            for rank in range(4):
                tfd.set_shard_coords((rank // 2, rank % 2, 0))
                got.append(tfd.shard_seed(seed, heads_axis=heads))
            tfd.set_shard_coords(None)
            assert got == want.tolist(), (seed, axes)
    assert tfd.shard_seed(99) == 99 and tfd.shard_seed(99, heads_axis=True) == 99


def _leaves(seed=0):
    g = torch.Generator().manual_seed(seed)
    shapes = [(33, 7), (1000,), (0, 3), (5, 5, 5), (0,), (257,)]
    return [torch.randn(s, generator=g) for s in shapes]


def test_kernel8_split_norm_plain():
    """World 1: the partial pass finished is the one-pass norm bit for
    bit.  Each leaf cut in two (two ranks' shards), the two float64
    partial sums added and finished: within one fp32 ulp of it.  Leaves of
    no element pass through the table, the passes and the division."""
    tokens = torch.tensor([3.0])
    one = fo.fused_grad_prep(_leaves(), tokens)
    partial = fo.fused_grad_prep(_leaves(), tokens, partial=True)
    assert partial.dtype == torch.float64 and partial.dim() == 0
    assert torch.equal(fo.grad_norm_finish(partial), one)
    halves = [[], []]
    for g in _leaves():
        flat = g.reshape(-1)
        halves[0].append(flat[: flat.numel() // 2])
        halves[1].append(flat[flat.numel() // 2:])
    total = sum(fo.fused_grad_prep(h, tokens, partial=True) for h in halves)
    split = fo.grad_norm_finish(total)
    ulp = float(np.spacing(np.float32(one)))
    assert abs(float(split) - float(one)) <= ulp
    leaves = _leaves()
    fo.fused_grad_prep(leaves, tokens)
    for got, raw in zip(leaves, _leaves()):
        assert got.shape == raw.shape and torch.equal(got, raw / tokens)
    assert float(fo.fused_grad_prep([], tokens)) == 0.0
    assert float(fo.fused_grad_prep([], tokens, partial=True)) == 0.0


def test_kernel8_leaf_table_takes_empty_leaves():
    """An uneven dim-0 shard may hold no element (a (1, 3) weight over 4
    ranks leaves ranks 1-3 a (0, 3) one): the table takes it, its address
    whatever it is (an empty tensor's may be 0), it gets no work item, and
    the table of each column accepts it."""
    grads = [torch.zeros(0, 3), torch.ones(1000), torch.zeros(0), torch.ones(5)]
    params = [torch.zeros_like(g) for g in grads]
    table = fo.leaf_table(grads, params, [torch.zeros_like(g) for g in grads],
                          [torch.zeros_like(g) for g in grads], [True, False, False, False],
                          chunk=256)
    ((lo, hi, first),) = table.groups
    assert (lo, hi) == (0, 4) and first.tolist() == [0, 0, 4, 4, 5]
    assert table.numel.tolist() == [0, 1000, 0, 5]
    assert table.with_grads(grads).ptrs.shape == (4, 4)
    groups = fo.leaf_groups(np.asarray([0, 0, 0]), chunk=4, max_leaves=2)
    assert [(lo, hi, f.tolist()) for lo, hi, f in groups] == [(0, 2, [0, 0, 0]),
                                                              (2, 3, [0, 0])]


@pytest.fixture
def fake_world4():
    from torch.testing._internal.distributed.fake_pg import FakeStore

    torch.distributed.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
    try:
        yield
    finally:
        torch.distributed.destroy_process_group()


def test_fsdp_shards_llama_2_7b_a_quarter_a_rank(fake_world4):
    """``shard_model`` over ``fsdp=4`` of llama-2-7b on the meta device (the
    registry config, 32 layers): rank 0 holds each parameter's first
    ceil(rows / 4) rows, a quarter of the 6,738,415,616 parameters within
    the dim-0 padding; the names are the model's."""
    from torch.distributed.device_mesh import init_device_mesh

    from distributed_llms_example_tpu_torch.models.llama import LlamaForCausalLM
    from distributed_llms_example_tpu_torch.models.registry import LLAMA_CONFIGS
    from distributed_llms_example_tpu_torch.parallel.fsdp import local, shard_model

    model = LlamaForCausalLM(LLAMA_CONFIGS["llama-2-7b"], device="meta")
    names = [(n, tuple(p.shape)) for n, p in model.named_parameters()]
    total = sum(math.prod(s) for _, s in names)
    assert total == 6_738_415_616
    shard_model(model, init_device_mesh("cpu", (1, 4), mesh_dim_names=("data", "fsdp")))
    assert [(n, tuple(p.shape)) for n, p in model.named_parameters()] == names
    held = [local(p).numel() for _, p in model.named_parameters()]
    assert held == [math.ceil(s[0] / 4) * math.prod(s[1:]) for _, s in names]
    assert total / 4 <= sum(held) <= total / 4 + sum(math.prod(s[1:]) for _, s in names)
    # fp32 weights, gradients and AdamW's two moments: 16 bytes a parameter
    assert 26.9e9 < 16 * sum(held) < 27.0e9


@pytest.mark.parametrize("name", ["llama-test", "bart-test", "t5-test"])
def test_fsdp_keeps_every_parameter_name(fake_world4, name):
    """FSDP2 keeps the parameter names, so the decay mask, the health
    buckets and the checkpoint names do not change; each block and the
    root are FSDP units, and the methods the eval and the loss call in
    place of ``forward`` are registered."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.fsdp import FSDPModule

    from distributed_llms_example_tpu_torch.models.registry import load_model
    from distributed_llms_example_tpu_torch.parallel.fsdp import shard_model, transformer_blocks
    from distributed_llms_example_tpu_torch.train.optim import decay_mask
    from distributed_llms_example_tpu_torch.train.step import param_buckets

    model = load_model(name, device="cpu", train=True).module
    before = [(n, tuple(p.shape), decay_mask(n, p)) for n, p in model.named_parameters()]
    buckets = param_buckets(model)
    blocks = transformer_blocks(model)
    shard_model(model, init_device_mesh("cpu", (1, 4), mesh_dim_names=("data", "fsdp")))
    assert [(n, tuple(p.shape), decay_mask(n, p)) for n, p in model.named_parameters()] == before
    assert torch.equal(param_buckets(model), buckets)
    assert len(blocks) >= 2 and all(isinstance(b, FSDPModule) for b in [*blocks, model])


def test_remat_replays_the_folded_seeds():
    """A rank's folded seeds under ``--remat``: the recompute replays the
    block's drawn seeds and folds them again, so the loss and every
    gradient are bit-equal to the run without remat at the same mesh
    position; another position draws other masks."""
    import dataclasses

    from distributed_llms_example_tpu_torch.models.llama import LlamaForCausalLM
    from distributed_llms_example_tpu_torch.models.registry import LLAMA_CONFIGS
    from distributed_llms_example_tpu_torch.ops.fused_dropout import dropout_seeds
    from distributed_llms_example_tpu_torch.train.step import causal_loss_sums

    cfg = dataclasses.replace(LLAMA_CONFIGS["llama-test"], dropout_rate=0.1,
                              attn_dropout_rate=0.1)
    g = torch.Generator().manual_seed(0)
    ids = torch.randint(3, 250, (4, 32), generator=g)
    batch = {"input_ids": ids, "attention_mask": torch.ones_like(ids), "labels": ids.clone()}

    def run(policy, coords):
        model = LlamaForCausalLM(cfg, remat_policy=policy)
        model.init_weights(torch.Generator().manual_seed(1))
        tfd.set_shard_coords(coords)
        try:
            with dropout_seeds(torch.Generator().manual_seed(5)):
                loss, _ = causal_loss_sums(model.train(), batch)
                loss.backward()
        finally:
            tfd.set_shard_coords(None)
        return loss.detach(), [p.grad for p in model.parameters()]

    off_l, off_g = run(None, (1, 0, 0))
    for policy in ("full", "dots"):
        on_l, on_g = run(policy, (1, 0, 0))
        assert torch.equal(on_l, off_l) and all(torch.equal(a, b) for a, b in zip(on_g, off_g))
    other_l, _ = run(None, (0, 1, 0))
    assert not torch.equal(other_l, off_l)
