"""One rank of a multi-process run of the port, for the tests (no JAX).

    RANK=r WORLD_SIZE=n MASTER_ADDR=127.0.0.1 MASTER_PORT=p \\
        python tests/torch_dist_worker.py spec.json

``spec.json``: ``argv`` (the train CLI's), ``rank_argv`` (extra flags of
one rank, by rank), ``out`` (where rank 0 saves its result with
``torch.save``), and optionally ``llama_dropout`` (an HF LLaMA directory
trained with residual dropout at this rate, a model the CLI's flags do not
express), ``seed_cycle`` (every dropout seed drawn from this list in
order, cycling, in place of the host stream), ``no_fold`` (ranks draw
unfolded seeds), ``next_mesh`` ([data, fsdp]: the layout a host loss
rebuilds onto, the trainer's ``_next_mesh_override``), ``count_collectives``
(each train step's collectives counted by op, with the bytes of the tensor
each call defines: an all-reduce's, an all-gather's or reduce-scatter's
output), ``record_eval`` (each eval's generated ids and scores); or
``ckpt``, a checkpoint scenario (``_ckpt``) in place of a run; or ``serve``,
the serve CLI over the group (``_serve``).
The result: each step's loss and grad norm (and health numerics, when on),
the final parameters by port name (gathered whole), what
``Trainer.train`` returned and the (data, fsdp) layout it ended on."""

import dataclasses
import itertools
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402


def _patch_seeds(spec) -> None:
    from distributed_llms_example_tpu_torch.ops import fused_dropout as fd

    if spec.get("seed_cycle"):
        stream = itertools.cycle(spec["seed_cycle"])
        fd._draw = lambda gen: next(stream)
    if spec.get("no_fold"):
        fd.set_shard_coords = lambda coords, **kw: None


def _patch_next_mesh(spec) -> None:
    from distributed_llms_example_tpu_torch.core.mesh import MeshSpec
    from distributed_llms_example_tpu_torch.train.trainer import Trainer

    if not spec.get("next_mesh"):
        return
    data, fsdp = spec["next_mesh"]
    train = Trainer.train

    def with_override(self):
        self._next_mesh_override = MeshSpec(data=data, fsdp=fsdp)
        return train(self)

    Trainer.train = with_override


# torch.distributed call -> the collective opcode of the byte account
_COUNTED = {"all_reduce": "all-reduce", "all_gather_single": "all-gather",
            "all_gather_into_tensor": "all-gather", "reduce_scatter_single": "reduce-scatter",
            "reduce_scatter_tensor": "reduce-scatter",
            "all_to_all_single": "collective-permute"}


def _count_collectives(spec) -> list | None:
    """With ``count_collectives``: every train step's collectives, as
    ``{op: [calls, bytes]}`` a step (a call made inside another counted
    call is that call's own business, not counted again)."""
    if not spec.get("count_collectives"):
        return None
    import torch.distributed as dist

    from distributed_llms_example_tpu_torch.train import trainer as trainer_mod

    steps: list[dict] = []
    state = {"step": None, "depth": 0}

    def counting(real, op):
        def call(*args, **kwargs):
            if state["step"] is not None and state["depth"] == 0:
                out = (args[0] if args else kwargs.get("output_tensor", kwargs.get(
                    "output", kwargs.get("tensor"))))
                slot = state["step"].setdefault(op, [0, 0])
                slot[0] += 1
                slot[1] += out.numel() * out.element_size()
            state["depth"] += 1
            try:
                return real(*args, **kwargs)
            finally:
                state["depth"] -= 1
        return call

    for name, op in _COUNTED.items():
        if hasattr(dist, name):
            setattr(dist, name, counting(getattr(dist, name), op))
    real_step = trainer_mod.train_step

    def step(*args, **kwargs):
        state["step"] = {}
        try:
            return real_step(*args, **kwargs)
        finally:
            steps.append(state["step"])
            state["step"] = None

    trainer_mod.train_step = step
    return steps


def _record_eval(spec) -> dict | None:
    """With ``record_eval``: the ids each eval generated (as this rank
    decodes them, in order) and what each ``Evaluator.run`` returned."""
    if not spec.get("record_eval"):
        return None
    from distributed_llms_example_tpu_torch.evaluation.evaluate import Evaluator

    seen: dict = {"ids": [], "scores": []}
    decode, run = Evaluator._decode_batch, Evaluator.run

    def recording_decode(self, ids):
        seen["ids"].append(ids.copy())
        return decode(self, ids)

    def recording_run(self, *args, **kwargs):
        out = run(self, *args, **kwargs)
        seen["scores"].append(dict(out))
        return out

    Evaluator._decode_batch, Evaluator.run = recording_decode, recording_run
    return seen


def _loaded(spec):
    from distributed_llms_example_tpu_torch.models.llama import LlamaForCausalLM
    from distributed_llms_example_tpu_torch.models.registry import LoadedModel, load_model

    if not spec.get("llama_dropout"):
        return None
    d = spec["llama_dropout"]
    lm = load_model(d["dir"], device="cpu", train=True, attention_impl=d["attention_impl"],
                    fused_ce=d.get("fused_ce", False))
    cfg = dataclasses.replace(lm.config, dropout_rate=d["rate"])
    model = LlamaForCausalLM(cfg, device="cpu")
    model.load_state_dict(lm.module.state_dict())
    return LoadedModel("llama", cfg, model.train(), is_seq2seq=False)


def global_tensors(shapes: dict, seed: int) -> dict:
    """The checkpoint scenario's whole tensors: fp32 from ``seed``."""
    g = torch.Generator().manual_seed(seed)
    return {k: torch.randn(tuple(v), generator=g) for k, v in sorted(shapes.items())}


def _ckpt(spec: dict, rank: int, out: str) -> None:
    """A checkpoint scenario over the group (or one process): ``layout``
    [data, fsdp] of this run, ``op`` "save" (each step of ``steps`` saved
    from the rank's rows of ``global_tensors(shapes, seed + step)``) or
    "restore" (the newest verified step restored under this layout, with
    the global ``shapes``: each rank's rows compared bit for bit with the
    step's tensors); ``fail_rank``: that rank's file writes raise OSError,
    and each rank reports the error its save raised.  Rank 0 saves every rank's report."""
    from distributed_llms_example_tpu_torch.core.mesh import initialize_distributed
    from distributed_llms_example_tpu_torch.io.checkpoint import Checkpointer, ShardLayout

    world = initialize_distributed(device_type="cpu")
    data, fsdp = spec["layout"]
    layout = ShardLayout(rank, world, data, fsdp) if world > 1 else None
    ck = Checkpointer(spec["dir"], async_save=False, layout=layout)
    shapes = {k: tuple(v) for k, v in spec["shapes"].items()}

    def rows(t):
        if layout is None:
            return t
        lo, hi = layout.rows(t.shape)
        return t[lo:hi]

    report = {"rank": rank}
    if spec["op"] == "save":
        if spec.get("fail_rank") == rank:
            from distributed_llms_example_tpu_torch.io import checkpoint

            def refuse(*args, **kwargs):
                raise OSError(28, "No space left on device (planted)")

            checkpoint.save_file = refuse
        try:
            for step in spec["steps"]:
                full = global_tensors(shapes, spec["seed"] + step)
                report[step] = ck.save(step, {k: rows(t).clone() for k, t in full.items()},
                                       {"count": step}, shapes=shapes if layout else None)
            ck.wait()
        except OSError as e:
            report.update(error=type(e).__name__, message=str(e))
    else:
        like_shapes = {k: tuple(v) for k, v in spec.get("like_shapes", spec["shapes"]).items()}
        like = {k: rows(torch.zeros(v)) for k, v in like_shapes.items()}
        try:
            tensors, meta, step = ck.restore_latest(like, shapes=like_shapes if layout else None)
        except ValueError as e:
            report["error"] = type(e).__name__
        else:
            full = global_tensors(shapes, spec["seed"] + step)
            report.update(step=step, count=meta["count"],
                          equal={k: bool(torch.equal(tensors[k], rows(full[k])))
                                 for k in full},
                          local_shapes={k: list(t.shape) for k, t in tensors.items()})
    reports = [report]
    if world > 1:
        reports = [None] * world
        torch.distributed.all_gather_object(reports, report)
    if rank == 0:
        torch.save(reports, out)


def _ring_cases(spec: dict, rank: int, world: int) -> dict:
    """``ring``: each case of ``spec["cases"]`` (arrays in the ``.npz``
    ``inputs``, named ``<case>/<array>``) through ``ops/ring_attention.py``
    over a ring of the whole group, this rank holding block ``rank`` of
    every length (a case's ``dtype``, default float32, is q/k/v's); then
    the cases named in ``planted`` again with every hop sent the wrong way
    round.  Returns each case's output and its q/k/v
    gradients, the blocks merged in ring order (``cases``, ``planted``)."""
    import numpy as np

    from distributed_llms_example_tpu_torch.ops import ring_attention as ra
    from distributed_llms_example_tpu_torch.parallel import activation as act

    arrays = np.load(spec["inputs"])
    ring = ra.Ring(None, world, rank)
    group = None if world == 1 else torch.distributed.group.WORLD

    def run(case):
        def block(name):
            a = torch.from_numpy(arrays[f"{case['name']}/{name}"])
            return a.chunk(world, dim=2 if a.dim() == 4 and name != "bias" else -1)[rank]

        dt = getattr(torch, case.get("dtype", "float32"))
        q, k, v = (block(x).to(dt).clone().requires_grad_(True) for x in ("q", "k", "v"))
        bias = block("bias").contiguous() if case["bias"] else None
        o = ra.ring_attention(q, k, v, bias, ring=ring, causal=case["causal"])
        o.backward(block("dout").to(dt))
        got = {"out": o.detach(), "dq": q.grad, "dk": k.grad, "dv": v.grad}
        return {k2: act.merge_sequence(t.float().contiguous(), group, world, dim=2)
                for k2, t in got.items()}

    out = {"cases": [run(case) for case in spec["cases"]], "planted": []}
    real = act.hop
    ra.hop = lambda x, group, n, index, *, reverse=False: real(x, group, n, index,
                                                               reverse=not reverse)
    try:
        out["planted"] = [run(case) for case in spec["cases"]
                          if case["name"] in spec.get("planted", ())]
    finally:
        ra.hop = real
    return out


def _block_case(spec: dict, rank: int, world: int) -> dict:
    """``block``: one LLaMA block (``config``, the JAX params in the
    pickle ``params``) cut over a tensor group of the whole world, its
    input ``x`` and output gradient ``dout`` from the ``.npz`` ``inputs``:
    the output, the input's gradient and every parameter's gradient, the
    tensor shards gathered whole."""
    import pickle

    import numpy as np

    from distributed_llms_example_tpu_torch.models.from_jax import tensor_shard_state
    from distributed_llms_example_tpu_torch.models.from_jax import _state_dict_from_jax
    from distributed_llms_example_tpu_torch.models.llama import LlamaBlock, LlamaConfig
    from distributed_llms_example_tpu_torch.parallel.activation import ModelParallel, attach
    from distributed_llms_example_tpu_torch.parallel.sharding import (
        gather_leaf,
        shard_tensor_parallel,
        tensor_dim,
    )

    cfg = LlamaConfig(**spec["config"])
    blk = LlamaBlock(cfg, dtype=torch.float32, param_dtype=torch.float32, device="cpu")
    group = torch.distributed.group.WORLD
    shard_tensor_parallel(blk, world, rank, config=cfg)
    with open(spec["params"], "rb") as f:
        params = pickle.load(f)
    sd = tensor_shard_state(_state_dict_from_jax(params, r"()block_(\d+)"), world, rank)
    blk.load_state_dict(sd)
    attach(blk, ModelParallel(mesh={"data": 1, "fsdp": 1, "sequence": 1, "tensor": world},
                              tensor_group=group, tensor_index=rank))
    arrays = np.load(spec["inputs"])
    x = torch.from_numpy(arrays["x"]).requires_grad_(True)
    bias = torch.from_numpy(arrays["bias"])
    o = blk(x, bias)
    o.backward(torch.from_numpy(arrays["dout"]))
    grads = {n: gather_leaf(p.grad, tensor_dim(n), group, world)
             for n, p in blk.named_parameters()}
    return {"out": o.detach(), "dx": x.grad, "grads": grads}


def _moe_cases(spec: dict, rank: int, world: int) -> dict:
    """``moe``: one ``MoEMLP`` (its config and state in the ``torch.save``
    file ``state``) over batch shards of the whole group, this rank holding
    row block ``rank`` of each case's ``x`` (the ``.npz`` ``inputs``,
    ``<case>/x`` and ``<case>/dout``): the output and the input's gradient
    gathered in row order, the aux summed over the ranks, every weight's
    gradient summed (the step's all-reduce) of ``(out * dout).sum() +
    aux_weight * aux``, and the dropped (token, choice) pairs counted; then
    ``unsharded``, each rank routing its rows alone (the layer before the
    exchange): its gathered output."""
    import numpy as np

    from distributed_llms_example_tpu_torch.ops import moe

    saved = torch.load(spec["state"], weights_only=False)
    arrays = np.load(spec["inputs"])
    dist = torch.distributed
    drops: list[torch.Tensor] = []
    route = moe.MoEMLP.route

    def counting(self, tokens, valid, capacity, exchange):
        index, combine, aux = route(self, tokens, valid, capacity, exchange)
        drops.append(((combine == 0).float() * valid[..., None]).sum())
        return index, combine, aux

    moe.MoEMLP.route = counting

    def gather(t):
        parts = [torch.empty_like(t) for _ in range(world)]
        dist.all_gather(parts, t.contiguous())
        return torch.cat(parts)

    def run(case, shards):
        layer = moe.MoEMLP(**saved["config"], group_size=case["group_size"])
        layer.load_state_dict(saved["state"])
        moe.attach_batch_shards(layer, shards)
        x = torch.from_numpy(arrays[f"{case['name']}/x"]).chunk(world)[rank]
        x = x.clone().requires_grad_(True)
        drops.clear()
        out, aux = layer(x)
        dout = torch.from_numpy(arrays[f"{case['name']}/dout"]).chunk(world)[rank]
        ((out * dout).sum() + spec["aux_weight"] * aux).backward()
        totals = torch.stack([aux.detach(), drops[0]])
        dist.all_reduce(totals)
        grads = {}
        for name, p in layer.named_parameters():
            dist.all_reduce(p.grad)
            grads[name] = p.grad
        return {"out": gather(out.detach()), "dx": gather(x.grad), "aux": float(totals[0]),
                "drops": int(totals[1]), "grads": grads}

    shards = moe.BatchShards(None, world, rank)
    return {"cases": [run(case, shards) for case in spec["cases"]],
            "unsharded": [run(case, None)["out"] for case in spec["cases"]]}


def _ops(spec: dict, rank: int, out: str) -> None:
    """A ring-attention, tensor-parallel block or MoE scenario
    (``_ring_cases``, ``_block_case``, ``_moe_cases``) over a gloo group of
    every rank; rank 0 saves it."""
    from distributed_llms_example_tpu_torch.core.mesh import initialize_distributed

    world = initialize_distributed(device_type="cpu")
    torch.manual_seed(0)
    kinds = {"ring": _ring_cases, "block": _block_case, "moe": _moe_cases}
    result = kinds[spec["kind"]](spec, rank, world)
    if rank == 0:
        torch.save(result, out)


# ops that read a value back to the host (a device sync on a card)
SYNCING_OPS = ("aten::_local_scalar_dense", "aten::item", "aten::nonzero", "aten::is_nonzero",
               "aten::masked_select")


def _serve(spec: dict, rank: int, out: str) -> None:
    """``serve``: each run's argv through the serve CLI in turn, every rank
    in one group (gloo, ``--device cpu``).  Rank 0 saves each run's
    outputs on every rank (all-gathered), the serve summary's fields, the
    shapes of a fresh slot state of rank 0's engine, and the ops of
    ``SYNCING_OPS`` that two steady rounds of a fresh session on that
    engine ran (on a card each would be a sync beside the round's one read
    of its gathered tokens)."""
    from torch.profiler import ProfilerActivity, profile

    from distributed_llms_example_tpu_torch.launch import cli
    from distributed_llms_example_tpu_torch.ops.mha import kv_leaves
    from distributed_llms_example_tpu_torch.serving import cache_pool

    runs = []
    for argv in spec["runs"]:
        engine, outputs = cli.serve(argv)
        sess = engine.open()
        for req in ([5, 6, 7, 8], [9, 10, 11]):
            sess.submit(req)
        for _ in range(2):  # the admission and a round, outside the window
            sess.step()
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            for _ in range(2):
                sess.step()
        ops = {e.key: e.count for e in prof.key_averages() if e.key in SYNCING_OPS}
        every = [None] * torch.distributed.get_world_size()
        torch.distributed.all_gather_object(every, outputs)
        state = engine._init_state()
        trees = state["pool"] if engine.paged else [kv_leaves(c) for c in state["cache"]]
        stats = engine.last_stats
        runs.append({"outputs": every, "kv_shapes": [[tuple(x.shape) for x in leaves]
                                                      for leaves in trees],
                     "syncing_ops": ops, "steady_rounds": sess.stats.decode_steps,
                     "bytes_per_live_token": stats.bytes_per_live_token,
                     "resident": stats.cache_bytes_resident,
                     "pool_bytes": cache_pool.tree_bytes(state["pool"]) if engine.paged else 0})
    if rank == 0:
        torch.save({"runs": runs}, out)


def main(path: str) -> None:
    with open(path) as f:
        spec = json.load(f)
    rank = int(os.environ["RANK"])
    if "serve" in spec:
        _serve(spec["serve"], rank, spec["out"])
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()
        return
    if "ops" in spec:
        _ops(spec["ops"], rank, spec["out"])
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()
        return
    if "ckpt" in spec:
        _ckpt(spec["ckpt"], rank, spec["out"])
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()
        return
    _patch_seeds(spec)
    _patch_next_mesh(spec)
    from distributed_llms_example_tpu_torch.launch.cli import train
    from distributed_llms_example_tpu_torch.models.export import full_state_dict

    argv = spec["argv"] + spec.get("rank_argv", {}).get(str(rank), [])
    collectives = _count_collectives(spec)
    evals = _record_eval(spec)
    trainer = train(argv, loaded=_loaded(spec))
    history = [{k: float(m[k]) for k in ("loss", "grad_norm", "target_tokens", "param_norm",
                                         "nonfinite_count") if k in m}
               for m in trainer.history]
    params = full_state_dict(trainer.model, tensor_group=trainer.groups.tensor_group,
                             tensor=trainer.mesh_spec.tensor)
    if rank == 0:
        torch.save({"history": history, "params": params, "result": trainer.result,
                    "mesh": [trainer.mesh_spec.data, trainer.mesh_spec.fsdp],
                    "collectives": collectives, "evals": evals,
                    "comm": trainer.obs._comm_account}, spec["out"])
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1])
