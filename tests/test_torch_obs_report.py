"""The port's ``obs.report`` against the JAX package's on the same run
directories: a CPU run of the port (bart-test, ``--obs jsonl``, the budget,
a heartbeat every step, ``--chaos host_loss@3`` with its reshard restore)
and hand-built streams of two ranks (heartbeat laggards, a
``host_loss_suspect``, off-cadence sync incidents, an injected and an
organic topology change, a rewind, a corrupt checkpoint, schema errors and
a torn line).  The report's sections (timeline, trends, stragglers,
budget, recovery, anomalies, recorders, schema errors) equal JAX
``build_report``'s, the markdown of each of those sections JAX
``render_markdown``'s, and ``main`` with ``--strict`` (and
``--min-dispatch-efficiency``) exits as JAX's."""

import json
import os

import pytest

from distributed_llms_example_tpu.obs import report as jax_report
from distributed_llms_example_tpu.obs import sink as jax_sink
from distributed_llms_example_tpu_torch.launch.cli import train
from distributed_llms_example_tpu_torch.obs import report
from distributed_llms_example_tpu_torch.obs import sink

SECTIONS = ("processes", "records", "schema_errors", "timeline", "trends", "stragglers",
            "budget", "recovery", "anomalies", "recorders")
HEADINGS = ("# obs report", "## Step timeline", "## Trends", "## Straggler attribution",
            "## Where did the time go", "## Recovery timeline", "## Anomalies")


@pytest.fixture(autouse=True)
def _stdout_sinks():
    jax_sink.install_sink(jax_sink.build_sink("stdout", ""))
    sink.install_sink(sink.build_sink("stdout", ""))
    yield
    jax_sink.install_sink(jax_sink.build_sink("stdout", ""))
    sink.install_sink(sink.build_sink("stdout", ""))


def _markdown_sections(text: str) -> dict[str, str]:
    """The markdown by section; the incidents' heading line, whose JAX text
    names a lint rule of the JAX repository, as its first words only."""
    out, key = {}, None
    for line in text.splitlines():
        if line.startswith("**off-cadence host-blocking dispatch incidents**"):
            line = "**off-cadence host-blocking dispatch incidents**"
        if line.startswith("#"):
            key = next((h for h in HEADINGS if line.startswith(h)), None)
        if key is not None:
            out[key] = out.get(key, "") + line + "\n"
    return out


def _same_report(path, *strict_flags):
    got, want = report.build_report(str(path)), jax_report.build_report(str(path))
    for k in SECTIONS:
        assert got[k] == want[k], k
    md = _markdown_sections(report.render_markdown(got))
    assert md and md == {k: v for k, v in _markdown_sections(
        jax_report.render_markdown(want)).items() if k in md}
    assert set(md) == set(HEADINGS)
    rcs = [m.main([str(path), "--strict", *strict_flags]) for m in (report, jax_report)]
    assert rcs[0] == rcs[1]
    return got, rcs[0]


@pytest.fixture(scope="module")
def run_dir(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("report-run")
    path = tmp / "train.json"
    path.write_text(json.dumps([{"dialogue": f"w{i} w{i + 1} w{i + 2} " * 3, "summary": f"w{i}"}
                                for i in range(12)]))
    out = tmp / "out"
    train(["--device", "cpu", "--model-ckpt", "bart-test", "--tokenizer", "byte",
           "--train-file", str(path), "--output-dir", str(out), "--batch-size", "4",
           "--num-epochs", "2", "--max-source-length", "32", "--max-target-length", "16",
           "--pad-to-multiple", "32", "--log-every-steps", "2", "--evaluation-steps", "0",
           "--save-every-steps", "2", "--chaos", "host_loss@3", "--obs", "jsonl",
           "--obs-heartbeat-steps", "1"])
    return out


def test_report_of_a_port_run_is_jaxs(run_dir, capsys):
    got, rc = _same_report(run_dir)
    assert rc == 0
    rec = got["recovery"]
    assert [t["policy"] for t in rec["topology"]] == ["reshard"]
    (rr,) = rec["reshards"]
    assert (rr["step"], rr["detected_at_step"], rr["steps_lost"]) == (2, 3, 1)
    assert rec["mttr_s"] > 0 and rec["organic_faults"] == []
    assert [f["kind"] for f in rec["faults"]] == ["topology_change"]
    assert got["stragglers"]["max_skew_steps"] == 0
    assert got["budget"]["ranks"]["0"]["windows"] == 3
    assert report.main([str(run_dir), "--strict", "--min-dispatch-efficiency", "2.0"]) == 1
    assert report.main([str(run_dir / "missing")]) == 2
    capsys.readouterr()


def _write(path, rank, events, extra_lines=()):
    os.makedirs(path / "obs", exist_ok=True)
    with open(path / "obs" / f"metrics-p{rank:03d}.jsonl", "w") as f:
        for e in events:
            f.write(json.dumps({"schema_version": 1, **e}) + "\n")
        for line in extra_lines:
            f.write(line + "\n")


def _budget(step, dispatch, suspect):
    return {"event": "step_budget", "step": step, "window_steps": 4, "wall_ms": 400.0,
            "data_wait_ms": 10.0, "dispatch_ms": dispatch, "device_busy_ms": 50.0,
            "sync_block_ms": 5.0, "host_overhead_ms": 2.0,
            "unattributed_ms": 333.0 - dispatch, "accounted_frac": 0.5,
            "additivity_ok": False, "dispatch_efficiency": 0.9,
            "offcadence_sync_steps": 3 if suspect else 0, "offcadence_sync_suspect": suspect}


def _two_ranks(path, *, injected: bool, corrupt: bool):
    chaos = [{"event": "chaos_injection", "kind": "host_loss", "step": 6}] if injected else []
    common = [
        *chaos,
        {"event": "topology_change", "step": 6, "old_mesh": {"data": 2, "fsdp": 1},
         "old_processes": 2, "policy": "reshard"},
        {"event": "reshard_restore", "step": 4, "detected_at_step": 6,
         "old_mesh": {"data": 2, "fsdp": 1}, "old_processes": 2,
         "new_mesh": {"data": 1, "fsdp": 2}, "new_processes": 2, "ef_mode": "none",
         "steps_lost": 2, "reshard_wall_s": 1.5},
        {"event": "host_loss_suspect", "rank": 1, "step": 5, "consecutive_beats": 3},
        {"event": "recovery", "action": "rewind", "step": 7, "detected_at_step": 8,
         "code": "nonfinite", "restored_step": 6, "steps_lost": 2, "rewind_index": 1,
         "recovery_wall_s": 0.25, "reason": "rewind 1/2"},
        {"event": "obs_anomaly", "code": "nonfinite", "step": 7, "detected_at_step": 8,
         "ranks": [0, 1], "policy": "rewind", "process_count": 2, "value": "nan",
         "detail": "loss=nan"},
    ]
    if corrupt:
        common.append({"event": "ckpt_verify_failed", "step": 4, "detail": "crc32 mismatch"})
    beats = [{"event": "heartbeat", "step": s, "process_count": 2, "min_step": s,
              "max_step": s, "skew_steps": 0, "arrival_spread_s": 6.5 if s > 2 else 0.2,
              "laggards": [1] if s > 2 else []} for s in range(1, 9)]
    windows = [{"event": "obs_window", "step": s, "epoch": 0, "window_steps": 4,
                "window_seconds": 0.4, "step_ms_p50": 90.0 + s, "step_ms_p95": 150.0 + s,
                "step_ms_max": 300.0 if s == 8 else 160.0, "straggler": s == 8, "spans": {}}
               for s in (4, 8)]
    _write(path, 0, [{"step": 4, "loss": 2.5, "learning_rate": 1e-4}, *beats, *windows,
                     _budget(4, 30.0, False), _budget(8, 280.0, True), *common],
           extra_lines=['{"schema_version": 7, "event": "x"}', '{"torn'])
    _write(path, 1, [*windows, _budget(4, 20.0, False), _budget(8, 250.0, True), *common])


@pytest.mark.parametrize("injected", [True, False])
@pytest.mark.parametrize("corrupt", [True, False])
def test_report_of_two_ranks_is_jaxs(tmp_path, injected, corrupt):
    _two_ranks(tmp_path, injected=injected, corrupt=corrupt)
    got, rc = _same_report(tmp_path, "--min-dispatch-efficiency", "0.5")
    assert rc == 1  # the schema errors alone
    assert len(got["schema_errors"]) == 2
    kinds = {f["kind"]: f["injected"] for f in got["recovery"]["faults"]}
    assert kinds["topology_change"] is injected
    assert got["recovery"]["host_loss_suspects"] == [
        {"rank": 1, "step": 5, "consecutive_beats": 3}]
    assert got["stragglers"]["heartbeat_laggard_counts"] == {"1": 6}
    assert [i["rank"] for i in got["budget"]["incidents"]] == [0, 1]
