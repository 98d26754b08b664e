"""Elastic training of the port on the CPU, against the JAX package: the
``--chaos host_loss@K`` grammar and the ``--on-host-loss`` validation as
JAX ``config_from_args`` takes them; ``elastic_mesh_spec`` over a grid of
meshes and device counts (the same shape, or a refusal where JAX
refuses); ``reinitialize_distributed`` destroying a live group and
creating the next generation (the same backend, the rendezvous store
kept, an all-reduce right after), and a failing NCCL never turning into
gloo.

End to end from one HF directory of the JAX init (bart-test, fp32, dropout
0), 2 epochs of 3 steps, ``--save-every-steps 2 --chaos host_loss@3``:
in one process, the topology change and the reshard restore of step 2,
6 steps, the replay bit-equal to a clean run resumed from step 2; on two
gloo ranks, ``data=2`` rebuilt onto ``fsdp=2`` (``_next_mesh_override``)
over a re-created group, ending on that layout within 1e-4 of the
one-process run, with its heartbeats.  Each against one JAX ``Trainer``
run with the same flags (one CPU device; two devices with the override):
the ``chaos_injection`` and ``topology_change`` events and the losses up
to the host loss within 1e-4.  The JAX run's restore of its own step-2
checkpoint fails with the installed Orbax (ROADMAP queue 3's caveat), so
it halts there; the port's restore target is the newest step of the JAX
run's checkpoint directory.  With dropout 0 and the optimizer state and
cursor restored, a right replay is the uninterrupted trajectory: each
run's 6 losses and grad norms and its final parameters are held within
1e-4 of one JAX ``Trainer`` run of the same flags without ``--chaos``.  Also ``--on-host-loss halt`` (save and stop,
then a resume) and a rebuild that fails (``recovery`` halt, no export)."""

import argparse
import json
import os
import shutil
import socket

import numpy as np
import pytest
import torch

from distributed_llms_example_tpu.core.config import CheckpointConfig as JaxCheckpointConfig
from distributed_llms_example_tpu.core.config import MeshConfig as JaxMeshConfig
from distributed_llms_example_tpu.core.config import TrainConfig as JaxTrainConfig
from distributed_llms_example_tpu.core.config import add_tpu_args
from distributed_llms_example_tpu.core.config import config_from_args as jax_config_from_args
from distributed_llms_example_tpu.core.mesh import MeshSpec as JaxMeshSpec
from distributed_llms_example_tpu.core.mesh import elastic_mesh_spec as jax_elastic
from distributed_llms_example_tpu.obs import sink as jax_sink
from distributed_llms_example_tpu_torch.core import mesh as tmesh
from distributed_llms_example_tpu_torch.core.config import MeshConfig, config_from_args
from distributed_llms_example_tpu_torch.launch.cli import build_train_parser, train
from distributed_llms_example_tpu_torch.models.export import full_state_dict
from distributed_llms_example_tpu_torch.obs import sink
from distributed_llms_example_tpu_torch.train import trainer as trainer_mod
from torch_dist_helpers import (
    COMMON,
    assert_matches,
    cli_argv,
    hf_dir,
    jax_mesh,
    jax_train,
    json_lines,
    records,
    spawn,
)

FLAGS = dict(num_epochs=2)
CHAOS = ["--save-every-steps", "2", "--chaos", "host_loss@3", "--obs", "jsonl"]


@pytest.fixture(autouse=True)
def _stdout_sinks():
    jax_sink.install_sink(jax_sink.build_sink("stdout", ""))
    sink.install_sink(sink.build_sink("stdout", ""))
    yield
    jax_sink.install_sink(jax_sink.build_sink("stdout", ""))
    sink.install_sink(sink.build_sink("stdout", ""))


def _events(out_dir, rank=0):
    path = os.path.join(str(out_dir), "obs", f"metrics-p{rank:03d}.jsonl")
    return [json.loads(x) for x in open(path)]


def _named(events, name):
    return [e for e in events if e.get("event") == name]


# ---------------------------------------------------------------------------
# grammar, validation, the elastic mesh, the re-created group
# ---------------------------------------------------------------------------

HOST_LOSS_ARGS = [[], ["--chaos", "host_loss@3"], ["--chaos", "host_loss@3", "--save-every-steps",
                                                   "2"],
                  ["--chaos", "host_loss@3", "--on-host-loss", "halt"],
                  ["--chaos", "sigterm@2,host_loss@7", "--save-every-steps", "3"],
                  ["--chaos", "host_loss@"], ["--chaos", "host_loss@0"],
                  ["--on-host-loss", "halt"]]


@pytest.mark.parametrize("argv", HOST_LOSS_ARGS, ids=[" ".join(a) or "none" for a in HOST_LOSS_ARGS])
def test_host_loss_config_matches_jax(argv):
    """Accepted or refused as JAX's ``config_from_args`` (a host_loss
    reshard needs a checkpoint cadence to restore from), with the same
    policy and armed ticks."""
    def jax_cfg():
        p = argparse.ArgumentParser()
        add_tpu_args(p)
        return jax_config_from_args(p.parse_args(argv))

    def outcome(fn):
        try:
            cfg = fn()
        except ValueError as e:
            return "refused", str(e).split(":")[0]
        return "ok", cfg.on_host_loss, cfg.chaos, cfg.checkpoint.save_every_steps

    got = outcome(lambda: config_from_args(build_train_parser().parse_args(argv)))
    assert got == outcome(jax_cfg)


GRID = [dict(data=-1), dict(data=-1, fsdp=2), dict(data=2, fsdp=4), dict(data=2, fsdp=8),
        dict(data=4), dict(data=1, fsdp=2), dict(data=2, fsdp=-1), dict(fsdp=4, data=1),
        dict(data=3, fsdp=1)]


@pytest.mark.parametrize("axes", GRID, ids=[str(g) for g in GRID])
def test_elastic_mesh_spec_matches_jax(axes):
    for n in (1, 2, 3, 4, 6, 8):
        try:
            want = jax_elastic(JaxMeshConfig(**axes), n)
        except ValueError:
            with pytest.raises(ValueError):
                tmesh.elastic_mesh_spec(MeshConfig(**axes), n)
            continue
        got = tmesh.elastic_mesh_spec(MeshConfig(**axes), n)
        assert (got.data, got.fsdp) == (want.data, want.fsdp)
        assert (want.sequence, want.tensor, want.stage, want.expert) == (1, 1, 1, 1)


def _port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture()
def fresh_rendezvous(monkeypatch):
    """No rendezvous facts in the env, and the module's stores and group
    facts this test's own."""
    for k in ("VH_MASTER_IP", "VH_WORLD_SIZE", "VH_RANK", "MASTER_ADDR", "MASTER_PORT",
              "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setattr(tmesh, "_STORES", {})
    monkeypatch.setattr(tmesh, "_GROUP_FACTS", {})


def test_reinitialize_destroys_and_recreates_the_group(fresh_rendezvous):
    """A world-1 gloo group made outside the module, torn down and
    re-created twice on one address (its store kept: no second bind), the
    backend kept, an all-reduce right after each; then the group goes."""
    torch.distributed.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{_port()}",
                                         world_size=1, rank=0)
    try:
        address = f"127.0.0.1:{_port()}"
        first = tmesh.generation()
        for n in (1, 2):
            assert tmesh.reinitialize_distributed(address, 1, 0, device_type="cuda") == 1
            assert tmesh.generation() == first + n
            assert torch.distributed.get_backend() == "gloo"  # the torn-down group's
            t = torch.tensor([2.5])
            torch.distributed.all_reduce(t)
            assert t.item() == 2.5
        # no facts given: the re-created group's own
        assert tmesh.reinitialize_distributed(device_type="cpu") == 1
        assert tmesh.generation() == first + 3 and tmesh.process_count() == 1
    finally:
        torch.distributed.destroy_process_group()
    # no group and a world of one: nothing to create
    assert tmesh.reinitialize_distributed("", 1, 0, device_type="cpu") == 1
    assert not tmesh.is_distributed()


def test_reinitialize_never_falls_back_to_gloo(monkeypatch, fresh_rendezvous):
    """A failing NCCL raises; no group is left, none on gloo, and the
    generation stays."""
    def nccl_fails(backend, **kw):
        raise RuntimeError(f"{backend} unavailable")

    monkeypatch.setattr(torch.distributed, "init_process_group", nccl_fails)
    monkeypatch.setattr(torch.cuda, "set_device", lambda d: None)
    before = tmesh.generation()
    with pytest.raises(RuntimeError, match="nccl unavailable"):
        tmesh.reinitialize_distributed(f"127.0.0.1:{_port()}", 2, 0, device_type="cuda")
    assert not tmesh.is_distributed()
    # a failed attempt counts no generation: the prefix stays the other ranks'
    assert tmesh.generation() == before


# ---------------------------------------------------------------------------
# end to end
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def data(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("elastic")
    recs = records(24, seed=5)
    path = tmp / "train.json"
    path.write_text(json.dumps(recs))
    return tmp, hf_dir(tmp / "bart", "bart-test", dropout_rate=0.0), recs, path


def _jax_run(ckpt, recs, layout, out, override=None):
    """The JAX ``Trainer`` with the same flags: (its losses, its events)."""
    from distributed_llms_example_tpu.train.trainer import Trainer as JaxTrainer

    jmesh, mcfg = jax_mesh(layout)
    cfg = JaxTrainConfig(model_ckpt=str(ckpt), output_dir=str(out), mesh=mcfg,
                         checkpoint=JaxCheckpointConfig(save_every_steps=2, resume=False,
                                                        async_save=False),
                         chaos="host_loss@3", obs="jsonl", obs_gauges="off",
                         **{**COMMON, **FLAGS})
    jt = JaxTrainer(cfg, train_records=recs, mesh=jmesh)
    jt._next_mesh_override = override
    seen, step = [], jt.train_step

    def recording(*args):
        state, metrics = step(*args)
        seen.append(float(metrics["loss"]))
        return state, metrics

    jt.train_step = recording
    jt.save_final = lambda: None
    jt.train()
    jax_sink.install_sink(jax_sink.build_sink("stdout", ""))
    return seen, _events(out), jt


def _same_pre_restore_events(port, jevents, *, processes):
    """chaos_injection and topology_change as the JAX run's (its mesh has
    every axis of the JAX package; the others are 1)."""
    assert [(e["kind"], e["step"]) for e in _named(port, "chaos_injection")] \
        == [(e["kind"], e["step"]) for e in _named(jevents, "chaos_injection")] \
        == [("host_loss", 3)]
    (tc,), (jtc,) = _named(port, "topology_change"), _named(jevents, "topology_change")
    assert (tc["step"], tc["policy"]) == (jtc["step"], jtc["policy"]) == (3, "reshard")
    assert tc["old_mesh"] == {k: jtc["old_mesh"][k] for k in ("data", "fsdp")}
    assert {v for k, v in jtc["old_mesh"].items() if k not in ("data", "fsdp")} == {1}
    assert tc["old_processes"] == processes


@pytest.fixture(scope="module")
def jax_clean(data):
    """The JAX ``Trainer`` with the same flags and no host loss, on one CPU
    device: the trajectory a replay must reproduce.  (each step's loss and
    grad norm, the final parameters by port name)"""
    tmp, ckpt, recs, _ = data
    history, params, _ = jax_train(ckpt, recs, "data=1", tmp / "jax-clean", **FLAGS)
    return history, params


def _history(t) -> list[dict]:
    return [{"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"])} for m in t.history]


@pytest.fixture(scope="module")
def one_process(data):
    """The port's run in this process, its events, and the JAX run's."""
    tmp, ckpt, recs, path = data
    out = tmp / "port-one"
    t = train(cli_argv(ckpt, path, out, *CHAOS, **FLAGS))
    events = _events(out)
    jlosses, jevents, jt = _jax_run(ckpt, recs, "data=1", tmp / "jax-one")
    return t, events, jlosses, jevents, jt


def test_host_loss_in_one_process_matches_jax(one_process, jax_clean, data):
    t, events, jlosses, jevents, jt = one_process
    tmp, ckpt, _, path = data
    assert t.result["steps"] == 6 and "anomaly" not in t.result and len(t.history) == 6
    _same_pre_restore_events(events, jevents, processes=1)
    # the JAX run saved step 2 and halted at its own restore (the Orbax caveat)
    assert len(jlosses) == 3 and _named(jevents, "recovery")[0]["action"] == "halt"
    target = max(s for s in jt.checkpointer.all_steps() if s <= 3)
    (rr,) = _named(events, "reshard_restore")
    assert (rr["step"], rr["detected_at_step"], rr["steps_lost"]) == (target, 3, 1) == (2, 3, 1)
    assert rr["new_mesh"] == rr["old_mesh"] == {"data": 1, "fsdp": 1} and rr["reshard_wall_s"] > 0
    losses = [float(m["loss"]) for m in t.history]
    np.testing.assert_allclose(losses[:3], jlosses, rtol=0, atol=1e-4)
    # the replay is the JAX package's uninterrupted run: 6 steps, the final
    # parameters
    assert_matches({"history": _history(t), "params": full_state_dict(t.model)}, *jax_clean)
    # the replay from step 2 is a clean resume from step 2, bit for bit
    resumed_dir = tmp / "port-resumed"
    shutil.copytree(tmp / "port-one" / "checkpoints", resumed_dir / "checkpoints",
                    ignore=lambda d, names: [n for n in names if os.path.basename(d) == "checkpoints"
                                             and n not in ("2", "integrity-2.json",
                                                           "recovery-2.json")])
    r = train(cli_argv(ckpt, path, resumed_dir, resume=True, **FLAGS))
    assert r.start_step == 2 and [float(m["loss"]) for m in r.history] == losses[2:]
    st, sr = t.state_tensors(), r.state_tensors()
    assert set(st) == set(sr) and all(torch.equal(st[k], sr[k]) for k in st)


def test_host_loss_on_two_ranks_matches_jax(one_process, jax_clean, data):
    """``data=2`` over two gloo ranks; the host loss at step 3 re-creates
    the group and rebuilds the run on ``fsdp=2``: the JAX package's
    uninterrupted trajectory, and the port's one-process run."""
    tmp, ckpt, recs, path = data
    t = one_process[0]
    out = tmp / "port-two"
    argv = cli_argv(ckpt, path, out, "--mesh", "data=2", *CHAOS, "--obs-heartbeat-steps", "1",
                    **FLAGS)
    _, logs, result = spawn({"argv": argv, "next_mesh": [1, 2]}, 2, tmp, name="two")
    assert result["mesh"] == [1, 2] and result["result"]["steps"] == 6
    assert_matches(result, *jax_clean)
    losses = [h["loss"] for h in result["history"]]
    np.testing.assert_allclose(losses, [float(m["loss"]) for m in t.history], rtol=0, atol=1e-4)
    port = {k: v.numpy() for k, v in t.state_tensors().items() if "/" not in k}
    worst = max(float(np.abs(result["params"][k].numpy() - v).max()) for k, v in port.items())
    assert worst <= 1e-4
    events = _events(out)
    _same_pre_restore_events(events, _jax_two(tmp, ckpt, recs)[1], processes=2)
    (rr,) = _named(events, "reshard_restore")
    assert (rr["step"], rr["detected_at_step"], rr["steps_lost"]) == (2, 3, 1)
    assert (rr["old_mesh"], rr["old_processes"]) == ({"data": 2, "fsdp": 1}, 2)
    assert (rr["new_mesh"], rr["new_processes"]) == ({"data": 1, "fsdp": 2}, 2)
    assert _named(_events(out, 1), "reshard_restore")  # every rank's file
    beats = [e for e in json_lines(logs[0]) if e.get("event") == "heartbeat"]
    assert [b["step"] for b in beats] == [1, 2, 3, 3, 4, 5, 6]
    assert {(b["skew_steps"], b["process_count"]) for b in beats} == {(0, 2)}


def _jax_two(tmp, ckpt, recs):
    jlosses, jevents, _ = _jax_run(ckpt, recs, "data=2", tmp / "jax-two",
                                   override=JaxMeshSpec(data=1, fsdp=2, sequence=1, tensor=1))
    return jlosses, jevents


def test_host_loss_halt_saves_and_stops(data, tmp_path):
    """``--on-host-loss halt`` (no checkpoint cadence needed): the
    topology change with its reason, a resumable checkpoint of step 3, the
    run ended with the anomaly marker and no export; a later run resumes
    from it."""
    _, ckpt, _, path = data
    t = train(cli_argv(ckpt, path, tmp_path, "--chaos", "host_loss@3", "--on-host-loss", "halt",
                       "--obs", "jsonl", **FLAGS))
    assert t.result["anomaly"] == "checkpoint" and t.result["steps"] == 3
    (tc,) = _named(_events(tmp_path), "topology_change")
    assert tc["policy"] == "halt" and "--on-host-loss halt" in tc["reason"]
    assert t.checkpointer.all_steps() == [3] and not (tmp_path / "model").exists()
    resumed = train(cli_argv(ckpt, path, tmp_path, resume=True, **FLAGS))
    assert resumed.start_step == 3 and resumed.result["steps"] == 6


def test_a_failed_rebuild_halts_the_run(data, tmp_path, monkeypatch):
    _, ckpt, _, path = data

    def refuse(cfg, n):
        raise ValueError("no layout fits the survivors")

    monkeypatch.setattr(trainer_mod, "elastic_mesh_spec", refuse)
    t = train(cli_argv(ckpt, path, tmp_path, *CHAOS, **FLAGS))
    assert t.result["anomaly"] == "halt" and t.result["steps"] == 3
    (rec,) = _named(_events(tmp_path), "recovery")
    assert (rec["action"], rec["code"], rec["step"]) == ("halt", "host_loss", 3)
    assert "no layout fits the survivors" in rec["reason"]
    assert not _named(_events(tmp_path), "reshard_restore") and not (tmp_path / "model").exists()
