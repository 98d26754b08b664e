"""The port's checkpointer (``io/checkpoint.py``) on the CPU, mirroring the
JAX package's checkpoint-integrity tests (``tests/test_recovery.py``):
a save restores bit for bit, synchronous or on the background writer;
retention keeps the newest ``keep`` steps and drops their sidecars; every
saved step gets a crc32 + size manifest that verifies, and a manifest is
authored only by the instance that saved the step; a flipped byte makes
the restore fall back to the previous verified step; ``restore_before``
and ``delete_after`` serve the rewind; the write retries with capped
backoff on an I/O error; a step whose verified files do not hold the
live state's tensors is reported and walked past.  The manifest and the
chaos corruption agree with the JAX package's on the same directory."""

import json
import os
import shutil

import numpy as np
import pytest
import torch

from distributed_llms_example_tpu.io import checkpoint as jax_checkpoint
from distributed_llms_example_tpu.obs import chaos as jax_chaos
from distributed_llms_example_tpu.obs import sink as jax_sink
from distributed_llms_example_tpu_torch.io import checkpoint
from distributed_llms_example_tpu_torch.io.checkpoint import (
    META_FILE,
    STATE_FILE,
    Checkpointer,
    compute_file_manifest,
)
from distributed_llms_example_tpu_torch.obs.chaos import corrupt_checkpoint


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """Small tensors, and the suite runs in parallel workers: one intra-op
    thread each, not one per core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _lines(capsys):
    return [json.loads(x) for x in capsys.readouterr().out.splitlines() if x.startswith("{")]


def _state(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"w": torch.randn(8, 8, generator=g), "b": torch.randn(8, generator=g),
            "mu/w": torch.randn(8, 8, generator=g), "e": torch.zeros(0),
            "ids": torch.arange(5, dtype=torch.int64)}


@pytest.mark.parametrize("async_save", [False, True])
def test_round_trip_bit_equal(tmp_path, async_save, capsys):
    ck = Checkpointer(str(tmp_path), save_every_steps=2, async_save=async_save)
    assert [ck.should_save(s) for s in (1, 2, 3, 4)] == [False, True, False, True]
    state = _state()
    assert ck.save(2, state, {"count": 7})
    # every tensor is on the host when save returns: changing the live
    # state now must not reach the checkpoint
    saved = {k: v.clone() for k, v in state.items()}
    state["w"].fill_(float("nan"))
    ck.wait()
    assert sorted(os.listdir(ck.step_dir(2))) == [META_FILE, STATE_FILE]
    tensors, meta, step = ck.restore_latest(saved)
    assert step == 2 and meta == {"count": 7, "step": 2}
    assert set(tensors) == set(saved)
    for k, v in saved.items():
        assert tensors[k].dtype == v.dtype and torch.equal(tensors[k], v), k
    saved_line = next(x for x in _lines(capsys) if x.get("event") == "ckpt_saved")
    assert saved_line["step"] == 2 and saved_line["bytes"] > 8 * 8 * 4
    # a step on disk is never written again
    assert not ck.save(2, saved, {"count": 8})
    assert ck.restore_latest()[1]["count"] == 7
    ck.close()


def test_retention_keeps_the_newest_steps_and_their_sidecars(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=2, async_save=True)
    for step in (1, 2, 3, 4):
        ck.save(step, _state(step), {"count": step})
        with open(os.path.join(str(tmp_path), f"recovery-{step}.json"), "w") as f:
            json.dump({"step": step}, f)
    ck.wait()
    assert ck.all_steps() == [3, 4] and ck.latest_step() == 4
    names = sorted(os.listdir(str(tmp_path)))
    assert names == ["3", "4", "integrity-3.json", "integrity-4.json", "recovery-3.json",
                     "recovery-4.json"]
    ck.close()


def test_manifest_written_and_verifies(tmp_path):
    ck = Checkpointer(str(tmp_path), async_save=False)
    ck.save(1, _state(), {"count": 1})
    manifest = json.load(open(ck.manifest_path(1)))
    assert manifest["step"] == 1 and set(manifest["files"]) == {STATE_FILE, META_FILE}
    assert all(set(m) == {"crc32", "size"} for m in manifest["files"].values())
    assert ck.verify(1) is None
    corrupt_checkpoint(ck.step_dir(1))
    problem = ck.verify(1)
    assert problem is not None and "crc32" in problem and STATE_FILE in problem
    ck.close()


def test_manifest_and_corruption_match_the_jax_package(tmp_path):
    """The same files give the same crc32 + size manifest in both
    packages, and the chaos corruption flips the same bytes of the same
    (largest) file."""
    ck = Checkpointer(str(tmp_path / "ck"), async_save=False)
    ck.save(3, _state(), {"count": 3})
    step_dir = ck.step_dir(3)
    assert compute_file_manifest(step_dir) == jax_checkpoint.compute_file_manifest(step_dir)
    twin = str(tmp_path / "twin")
    shutil.copytree(step_dir, twin)
    jax_sink.install_sink(jax_sink.build_sink("stdout", ""))
    got = corrupt_checkpoint(step_dir)
    want = jax_chaos.corrupt_checkpoint(twin)
    assert os.path.basename(got) == os.path.basename(want) == STATE_FILE
    assert open(got, "rb").read() == open(want, "rb").read()


def test_restore_falls_back_to_the_previous_verified_step(tmp_path, capsys):
    ck = Checkpointer(str(tmp_path), keep=3, async_save=False)
    for step in (1, 2):
        ck.save(step, _state(step), {"count": step})
    corrupt_checkpoint(ck.step_dir(2))  # the NEWEST step is torn
    capsys.readouterr()
    tensors, meta, step = ck.restore_latest(_state())
    assert step == 1 and meta["count"] == 1
    assert all(torch.equal(tensors[k], v) for k, v in _state(1).items())
    bad = [e for e in _lines(capsys) if e.get("event") == "ckpt_verify_failed"]
    assert [e["step"] for e in bad] == [2]
    # restore_before excludes the anomaly step itself even when clean
    ck2 = Checkpointer(str(tmp_path / "clean"), async_save=False)
    for step in (1, 2):
        ck2.save(step, _state(step), {"count": step})
    assert ck2.restore_before(2, _state())[2] == 1
    assert ck2.restore_before(1, _state()) is None
    # every retained step corrupt: None, not an exception
    corrupt_checkpoint(ck.step_dir(1))
    assert ck.restore_latest(_state()) is None


def test_a_verified_step_that_does_not_hold_the_state_is_walked_past(tmp_path, capsys):
    """A step whose files verify but do not hold the live state's tensors
    (corruption the checksums cannot see) logs ``ckpt_restore_failed`` and
    the restore takes the step before; with no step before it, or for a
    step without a manifest (legacy), the error is raised."""
    ck = Checkpointer(str(tmp_path), async_save=False)
    ck.save(1, _state(1), {"count": 1})
    ck.save(2, {**_state(2), "w": torch.zeros(4)}, {"count": 2})
    capsys.readouterr()
    assert ck.restore_latest(_state())[2] == 1
    failed = [e for e in _lines(capsys) if e.get("event") == "ckpt_restore_failed"]
    assert [e["step"] for e in failed] == [2] and "w" in failed[0]["error"]
    ck.delete_after(0)
    ck.save(2, {**_state(2), "w": torch.zeros(4)}, {"count": 2})
    with pytest.raises(ValueError, match="live state"):
        ck.restore_latest(_state())
    os.remove(ck.manifest_path(2))
    ck.save(3, _state(3), {"count": 3})
    with pytest.raises(ValueError, match="other tensors"):
        ck.restore_latest({"w": torch.zeros(8, 8)}, max_step=2)


def test_delete_after_drops_newer_steps_and_sidecars(tmp_path, capsys):
    ck = Checkpointer(str(tmp_path), keep=5, async_save=True)
    for step in (1, 2, 3):
        ck.save(step, _state(step), {"count": step})
    ck.wait()
    capsys.readouterr()
    assert ck.delete_after(1) == [2, 3]
    assert ck.all_steps() == [1]
    assert not os.path.exists(ck.manifest_path(2)) and not os.path.exists(ck.manifest_path(3))
    assert os.path.exists(ck.manifest_path(1))
    assert [e["steps"] for e in _lines(capsys)
            if e.get("event") == "ckpt_deleted_after_rewind"] == [[2, 3]]
    # the replay can save the dropped steps again
    assert ck.save(2, _state(), {"count": 2})
    ck.wait()
    assert ck.verify(2) is None
    assert ck.delete_after(10) == []
    ck.close()


def test_manifest_never_authored_for_foreign_steps(tmp_path):
    ck1 = Checkpointer(str(tmp_path), async_save=False)
    ck1.save(1, _state(), {"count": 1})
    ck1.close()
    os.remove(ck1.manifest_path(1))  # a legacy step, saved before manifests
    ck2 = Checkpointer(str(tmp_path), async_save=False)
    restored = ck2.restore_latest(_state())
    assert restored is not None and restored[2] == 1  # accepted...
    assert not os.path.exists(ck2.manifest_path(1))  # ...never baptized
    assert ck2.verify(1) is None
    ck2.close()


@pytest.mark.parametrize("async_save", [False, True])
def test_save_retries_with_backoff_on_transient_io(tmp_path, capsys, monkeypatch, async_save):
    # the backoff's schedule without its waits
    monkeypatch.setattr(checkpoint, "sleep_backoff", lambda d, *, cap_s: min(2 * d, cap_s))
    ck = Checkpointer(str(tmp_path), async_save=async_save)
    real = ck._write
    calls = {"n": 0}

    def flaky(*a):
        calls["n"] += 1
        if calls["n"] <= 2:
            raise OSError("transient: storage mount flapped")
        return real(*a)

    monkeypatch.setattr(ck, "_write", flaky)
    assert ck.save(1, _state(), {"count": 1})
    ck.wait()
    assert calls["n"] == 3 and ck.verify(1) is None
    retries = [e for e in _lines(capsys) if e.get("event") == "ckpt_save_retry"]
    assert [r["attempt"] for r in retries] == [1, 2]
    assert retries[1]["backoff_s"] > retries[0]["backoff_s"]
    # a persistent failure propagates once the budget is spent: at the
    # save on the synchronous path, where the writer is joined otherwise
    monkeypatch.setattr(ck, "_write", lambda *a: (_ for _ in ()).throw(OSError("dead mount")))
    with pytest.raises(OSError, match="dead mount"):
        ck.save(2, _state(), {"count": 2})
        ck.wait()
    assert ck.all_steps() == [1]
    ck.close()


def test_save_copies_device_tensors_to_the_host_and_restores_dtypes(tmp_path):
    """bf16 and fp64 tensors and a non-contiguous view round-trip with
    their dtypes and values."""
    ck = Checkpointer(str(tmp_path), async_save=True)
    base = torch.arange(24, dtype=torch.float32).reshape(4, 6)
    state = {"bf": base.to(torch.bfloat16), "f64": base.double(), "view": base.t()}
    ck.save(5, state, {"count": 0})
    tensors, _, _ = ck.restore_latest()
    assert tensors["bf"].dtype == torch.bfloat16 and torch.equal(tensors["bf"], state["bf"])
    assert torch.equal(tensors["f64"], state["f64"])
    np.testing.assert_array_equal(tensors["view"].numpy(), base.t().numpy())
    ck.close()
