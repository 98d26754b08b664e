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
output); or ``ckpt``, a checkpoint scenario (``_ckpt``) in place of a run.
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
        fd.set_shard_coords = lambda coords: None


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
            "reduce_scatter_tensor": "reduce-scatter"}


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


def main(path: str) -> None:
    with open(path) as f:
        spec = json.load(f)
    rank = int(os.environ["RANK"])
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
    trainer = train(argv, loaded=_loaded(spec))
    history = [{k: float(m[k]) for k in ("loss", "grad_norm", "target_tokens", "param_norm",
                                         "nonfinite_count") if k in m}
               for m in trainer.history]
    params = full_state_dict(trainer.model)
    if rank == 0:
        torch.save({"history": history, "params": params, "result": trainer.result,
                    "mesh": [trainer.mesh_spec.data, trainer.mesh_spec.fsdp],
                    "collectives": collectives,
                    "comm": trainer.obs._comm_account}, spec["out"])
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1])
