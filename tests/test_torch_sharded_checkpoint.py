"""Checkpoints over a process group (``io/checkpoint.py`` with a
``ShardLayout``), gloo ranks on the CPU: each rank of the first ``data``
row writes ``state-r<rank>.safetensors`` (its dim-0 row blocks, uneven
ones and empty ones included), process 0 ``meta.json`` with the mesh
layout, the global shapes and the rows each file holds, and the crc32
manifest over every file; a restore under every other layout (one
process, ``data=2``, ``fsdp=2``, four ranks) reads each rank's rows
bit-equal; a corrupted rank file walks every rank back to the step before;
a saved global shape unlike the model's raises ``ReshardError`` on every
rank; a rank whose file write fails raises its error on every rank and
leaves no half-written step; one process keeps the one-file format."""

import json
import os
import shutil

import pytest
import torch

from torch_dist_helpers import spawn
from torch_dist_worker import global_tensors

# uneven dim-0 blocks: a (1, 3) weight and its (1,) bias leave ranks 1-3 of
# four no rows; BART's 1026-row position table; an even matrix
SHAPES = {"w": [1, 3], "b": [1], "pos": [1026, 4], "m": [8, 8], "odd": [5, 2]}
SEED = 100
LAYOUTS = {"one": ((1, 1), 1), "data=2": ((2, 1), 2), "fsdp=2": ((1, 2), 2),
           "data=2,fsdp=2": ((2, 2), 4), "fsdp=4": ((1, 4), 4)}


def _run(tmp, ckpt, layout, op, name, **extra):
    (data_fsdp, n) = LAYOUTS[layout]
    spec = {"ckpt": {"dir": str(ckpt), "layout": list(data_fsdp), "op": op,
                     "shapes": SHAPES, "seed": SEED, "steps": [1, 2], **extra}, "argv": []}
    _, _, reports = spawn(spec, n, tmp, name=name, timeout=120)
    return reports


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """Steps 1 and 2 saved under each layout, once: {layout: the directory}."""
    out = {}

    def get(layout):
        if layout not in out:
            tmp = tmp_path_factory.mktemp("save")
            _run(tmp, tmp / "ckpt", layout, "save", "save")
            out[layout] = tmp / "ckpt"
        return out[layout]

    return get


@pytest.mark.parametrize("saved_layout,restored", [
    ("fsdp=2", "one"), ("fsdp=2", "data=2"), ("fsdp=2", "fsdp=2"), ("one", "fsdp=2"),
    ("one", "data=2"), ("data=2", "fsdp=2"), ("data=2,fsdp=2", "fsdp=2"), ("fsdp=4", "one"),
    ("fsdp=2", "fsdp=4")])
def test_restore_under_another_layout_is_bit_equal(saved, tmp_path, saved_layout, restored):
    ckpt = saved(saved_layout)
    data, fsdp = LAYOUTS[saved_layout][0]
    files = sorted(os.listdir(ckpt / "2"))
    meta = json.loads((ckpt / "2" / "meta.json").read_text())
    if saved_layout == "one":
        assert files == ["meta.json", "state.safetensors"]
        assert meta == {"count": 2, "step": 2}
    else:
        assert files == ["meta.json"] + [f"state-r{r}.safetensors" for r in range(fsdp)]
        assert meta["mesh_layout"] == {"axes": {"data": data, "fsdp": fsdp},
                                       "processes": data * fsdp}
        assert meta["shapes"] == SHAPES and len(meta["files"]) == fsdp
    manifest = json.loads((ckpt / "integrity-2.json").read_text())
    assert sorted(manifest["files"]) == files
    reports = _run(tmp_path, ckpt, restored, "restore", "restore")
    n = LAYOUTS[restored][1]
    assert [r["rank"] for r in reports] == list(range(n))
    for r in reports:
        assert r["step"] == 2 and r["count"] == 2 and all(r["equal"].values()), r
    if restored == "fsdp=4":  # ranks 1-3 hold none of the (1, 3) weight's one row
        assert [r["local_shapes"]["w"] for r in reports] == [[1, 3], [0, 3], [0, 3], [0, 3]]
        assert [r["local_shapes"]["pos"] for r in reports] == [[257, 4]] * 3 + [[255, 4]]


def test_a_corrupted_rank_file_walks_both_ranks_back(saved, tmp_path):
    ckpt = tmp_path / "ckpt"
    shutil.copytree(saved("fsdp=2"), ckpt)
    path = ckpt / "2" / "state-r1.safetensors"
    raw = bytearray(path.read_bytes())
    raw[-1] ^= 0xFF
    path.write_bytes(bytes(raw))
    reports = _run(tmp_path, ckpt, "fsdp=2", "restore", "restore")
    assert [r["step"] for r in reports] == [1, 1]
    assert all(all(r["equal"].values()) for r in reports)
    log = (tmp_path / "restore-rank0.log").read_text()
    events = [json.loads(x) for x in log.splitlines() if x.startswith("{")]
    (bad,) = [e for e in events if e.get("event") == "ckpt_verify_failed"]
    assert bad["step"] == 2 and "state-r1.safetensors" in bad["detail"]
    # rank 1 prints no line: process 0 verifies and logs
    assert not [x for x in (tmp_path / "restore-rank1.log").read_text().splitlines()
                if x.startswith("{")]


@pytest.mark.parametrize("layout", ["fsdp=2", "one"])
def test_a_saved_shape_unlike_the_model_raises_reshard_error(saved, tmp_path, layout):
    reports = _run(tmp_path, saved("fsdp=2"), layout, "restore", "restore",
                   like_shapes={**SHAPES, "pos": [1024, 4]})
    assert [r.get("error") for r in reports] == ["ReshardError"] * len(reports)


@pytest.mark.parametrize("fail_rank", [1, 0])
def test_a_rank_whose_write_fails_takes_every_rank_down_with_its_error(tmp_path, fail_rank):
    """A writer's save_file fails after its retries: every rank raises its
    OSError at once (none waits in a collective until the backend's
    timeout), and the half-written step is gone."""
    ckpt = tmp_path / "ckpt"
    reports = _run(tmp_path, ckpt, "fsdp=2", "save", "save", fail_rank=fail_rank)
    assert [r.get("error") for r in reports] == ["OSError", "OSError"], reports
    assert "(planted)" in reports[fail_rank]["message"]
    other = reports[1 - fail_rank]["message"]
    assert f"rank {fail_rank} failed to save" in other and "(planted)" in other
    assert not any(1 in r or 2 in r for r in reports)
    assert os.listdir(ckpt) == []
    log = (tmp_path / f"save-rank{fail_rank}.log").read_text()
    retries = [json.loads(x) for x in log.splitlines() if x.startswith("{")]
    assert [e["attempt"] for e in retries if e.get("event") == "ckpt_save_retry"] == [1, 2, 3]


def test_the_scenario_tensors_are_the_checkpoint(tmp_path):
    """The restored rows are compared against ``global_tensors``; make sure
    they are not a constant a wrong read could also give."""
    a, b = global_tensors(SHAPES, SEED + 1), global_tensors(SHAPES, SEED + 2)
    assert all(not torch.equal(a[k], b[k]) for k in SHAPES)
    assert all(t.std() > 0.1 for t in a.values() if t.numel() > 1)
