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
``--min-dispatch-efficiency``) exits as JAX's.  Two ranks' streams of the
profiler slice's records (startup gauges on an fsdp mesh, optimizer
samples, device accounts, span instances, memory accounts and windows, a
serving account, a postmortem bundle): the comm, device, memory, budget
and trend sections and their markdown equal JAX's, the overlap and memory
gates exit as JAX's (and fail with nothing to read), and the Perfetto
export (``obs/trace.py``, and ``--trace``) equals JAX ``build_trace``'s.
A CPU serving run of the port with the prefix cache and speculative
decode into ``--obs jsonl``'s file: the prefix and speculative-decode
sections and their markdown equal JAX's, and the
``--min-prefix-hit-rate`` / ``--min-acceptance-rate`` gates exit as JAX's
(and fail with nothing to read)."""

import json
import os

import numpy as np
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


def test_the_rebuild_reruns_the_startup_gauges(run_dir):
    """The host-loss rebuild lays the run out anew: the startup gauges and
    the memory account of the new layout are logged again, as the JAX
    trainer re-runs its startup gauges."""
    lines = [json.loads(x) for x in open(run_dir / "obs" / "metrics-p000.jsonl")]
    events = [x.get("event") for x in lines]
    lost, restored = events.index("topology_change"), events.index("reshard_restore")
    gauges = [i for i, e in enumerate(events) if e == "obs_gauges"]
    memory = [i for i, e in enumerate(events) if e == "memory_account"]
    # the new layout's gauges with its model, its memory account after its
    # first step
    assert len(gauges) == 2 and gauges[0] < lost < gauges[1] < restored, events
    assert len(memory) == 2 and memory[0] < lost and memory[1] > restored, events


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


# ---------------------------------------------------------------------------
# the device, comm and memory sections and the Perfetto export
# ---------------------------------------------------------------------------

NEW_SECTIONS = ("comm", "device", "memory", "budget", "trends")
NEW_HEADINGS = ("## Device account", "## Comm account", "## Where did the bytes go",
                "## Where did the time go", "## Trends")


def _new_sections(text: str) -> dict[str, str]:
    out, key = {}, None
    for line in text.splitlines():
        if line.startswith("#"):
            key = next((h for h in NEW_HEADINGS if line.startswith(h)), None)
        if key is not None:
            out[key] = out.get(key, "") + line + "\n"
    return out


def _telemetry_run(path, seed: int, *, postmortem: bool):
    """Two ranks' streams with every record the slice adds: the startup
    gauges (an fsdp mesh whose gradient bytes ride all-reduce: the smell),
    budgets with the optimizer sample, a profile capture and its device
    account (from seeded events, collectives overlapping compute), span
    instances with step marks, the memory account, windows and a skip, a
    serving account, and a postmortem bundle."""
    from distributed_llms_example_tpu_torch.obs import devprof

    rng = np.random.RandomState(seed)
    comm = {"all-reduce": {"count": 3, "gradient_bytes": 64 << 20, "activation_bytes": 8},
            "all-gather": {"count": 5, "gradient_bytes": 8 << 20, "activation_bytes": 0},
            "reduce-scatter": {"count": 3, "gradient_bytes": 4 << 20, "activation_bytes": 0}}
    comm.update(total_bytes=(76 << 20) + 8, gradient_bytes=76 << 20, activation_bytes=8)
    gauges = {"event": "obs_gauges", "peak_flops_per_chip": 989e12, "model": "m",
              "mesh": {"data": 1, "fsdp": 2}, "global_batch": 8, "grad_accum_steps": 1,
              "grad_compression": "off", "params": 1000, "tokens_per_step": 64,
              "flops_per_step": 3.5e9, "flops_source": "flop_counter", "comm": comm}
    for rank in (0, 1):
        events = [{"name": n, "hlo_op": "", "ts": float(rng.randint(0, 3000)),
                   "dur": float(rng.randint(1, 300)), "pid": 1, "tid": int(rng.randint(2))}
                  for n in rng.choice(["jit/blocks_0/self_attn/dot", "jit/mlp/fc1", "all-gather.1",
                                       "all-reduce.2", "jit/lm_head/dot", "infeed.3"], 60)]
        acct = devprof.build_account(events, max_lane_slices=40)
        acct.pop("event")
        rec = []
        if rank == 0:
            rec.append(gauges)
        for s in (2, 4, 6):
            b = _budget(s, 100.0 + s, False)
            if s > 2:
                b.update(optimizer_apply_ms=12.5 + s + rank, optimizer_share_of_step=0.1 + s / 100)
            rec.append(b)
            rec.append({"event": "obs_window", "step": s, "window_steps": 2, "window_seconds": 0.2,
                        "step_ms_p50": 90.0 + s, "step_ms_p95": 99.0, "step_ms_max": 100.0,
                        "straggler": False, "spans": {}, "mfu": 0.123 + s / 1000})
            rec.append({"event": "memory_window", "step": s, "bytes_in_use": (5 + s) << 30,
                        "peak_bytes_in_use": (9 + s) << 30, "watermark_delta_bytes": s << 20,
                        "reserved_bytes": 20 << 30, "bytes_limit": 80 << 30, "devices": 1})
        rec += [
            {"event": "trace_spans", "step": 6, "wall0": 1.7e9 + rank, "spans": [
                ["data_wait", 0.01 * s, 0.001] for s in range(6)] + [
                ["step_dispatch", 0.01 * s + 0.002, 0.005] for s in range(6)],
             "steps": [[s, 0.01 * s + 0.009 + rank * 1e-4] for s in range(1, 7)]},
            {"event": "profile_captured", "path": f"/x/proc{rank:03d}-s000004-000005",
             "window": [4, 5], "steps": 2},
            {"event": "device_account", "step": 5, "window": [4, 5], "window_steps": 2, **acct},
            {"event": "memory_account", "model": "m", "mesh": {"data": 1, "fsdp": 2},
             "backend": "cuda", "buckets_bytes": {"params": 1 << 30, "optimizer_state": 2 << 30,
                                                  "grad_accum": 1 << 30, "activations": 9 << 30,
                                                  "kv_cache": 0, "other": 1 << 20},
             "bucket_total_bytes": (13 << 30) + (1 << 20), "peak_bytes": (13 << 30) + (1 << 20),
             "peak_gib": 13.001, "additivity_gap_bytes": 0, "measured": None,
             "largest_buffers": [{"name": "embed_tokens.weight", "shape": [32000, 4096],
                                  "shard_shape": [16000, 4096], "dtype": "float32",
                                  "bytes": 262144000, "module": "embed"}],
             "hbm_budget_gib": 80.0, "hbm_budget_bytes": 80 << 30, "peak_frac_of_budget": 0.1625,
             "hbm_headroom_gib": 66.999, "fits_budget": True},
            {"event": "serve_summary", "memory_account": {
                "buckets_bytes": {"params": 5 << 30, "kv_cache": 1 << 30}, "peak_bytes": 6 << 30,
                "hbm_budget_gib": 80.0, "hbm_budget_bytes": 80 << 30, "hbm_headroom_gib": 74.0,
                "fits_budget": True}},
        ]
        if rank == 1:
            rec.append({"event": "memory_window_skipped", "step": 2, "reason": "no device"})
        _write(path, rank, rec)
    if postmortem:
        with open(path / "obs" / "memory-postmortem-p001.json", "w") as f:
            json.dump({"schema_version": 1, "event": "memory_postmortem", "step": 7,
                       "reason": "RuntimeError: CUDA out of memory", "account": {"x": 1},
                       "watermark_history": [{"step": 6}], "live_buffers_top": [{"bytes": 9}]},
                      f)


@pytest.mark.parametrize("seed,postmortem", [(0, True), (1, False)])
def test_device_comm_memory_sections_and_trace_are_jaxs(tmp_path, seed, postmortem, capsys):
    from distributed_llms_example_tpu.obs import trace as jax_trace
    from distributed_llms_example_tpu_torch.obs import trace

    _telemetry_run(tmp_path, seed, postmortem=postmortem)
    got, want = report.build_report(str(tmp_path)), jax_report.build_report(str(tmp_path))
    for k in NEW_SECTIONS:
        assert got[k] == want[k], k
    assert got["comm"]["reduce_scatter_smell"]["code"] == "gradient-all-reduce-not-reduce-scatter"
    assert got["device"]["accounts"] == 2 and bool(got["memory"]["postmortems"]) is postmortem
    assert got["budget"]["ranks"]["0"]["optimizer_apply_ms"] > 0
    md = _new_sections(report.render_markdown(got))
    assert set(md) == set(NEW_HEADINGS)
    assert md == {k: v for k, v in _new_sections(jax_report.render_markdown(want)).items()
                  if k in md}
    for flags in (["--min-overlap-frac", "0.99"], ["--min-overlap-frac", "0.01"],
                  ["--max-peak-hbm-frac", "0.1"], ["--max-peak-hbm-frac", "0.5"],
                  ["--min-hbm-headroom-gib", "70"], ["--min-hbm-headroom-gib", "1"]):
        rcs = [m.main([str(tmp_path), "--strict", *flags]) for m in (report, jax_report)]
        assert rcs[0] == rcs[1], flags
    ours, theirs = trace.build_trace(str(tmp_path)), jax_trace.build_trace(str(tmp_path))
    assert ours["traceEvents"] == theirs["traceEvents"]
    assert {k: v for k, v in ours["otherData"].items() if k != "source"} == \
        {k: v for k, v in theirs["otherData"].items() if k != "source"}
    tids = {e.get("tid") for e in ours["traceEvents"] if e.get("ph") == "X"}
    assert {trace.TID_SPANS, trace.TID_STEPS, trace.TID_DEVICE} <= tids
    out = tmp_path / "t.json"
    assert report.main([str(tmp_path), "--trace", str(out)]) == 0
    assert json.loads(out.read_text())["traceEvents"] == ours["traceEvents"]
    capsys.readouterr()


def test_gates_with_nothing_to_read_fail(tmp_path, capsys):
    _write(tmp_path, 0, [_budget(2, 10.0, False)])
    for flags in (["--min-overlap-frac", "0.5"], ["--max-peak-hbm-frac", "0.9"],
                  ["--min-hbm-headroom-gib", "1"]):
        assert report.main([str(tmp_path), "--strict", *flags]) == 1
        assert jax_report.main([str(tmp_path), "--strict", *flags]) == 1
    assert report.main([str(tmp_path), "--strict"]) == 0
    capsys.readouterr()


@pytest.fixture(scope="module")
def serve_run(tmp_path_factory):
    """A CPU serving run of the port (llama-test, the paged prefix cache and
    n-gram speculation, a serve_window every 2 steps) into ``--obs
    jsonl``'s file, as the serving slice emits its ledgers."""
    from distributed_llms_example_tpu_torch.models.registry import load_model
    from distributed_llms_example_tpu_torch.serving.engine import ServeConfig, ServingEngine

    out = tmp_path_factory.mktemp("serve-obs")
    rng = np.random.RandomState(23)
    head = [int(t) for t in rng.randint(4, 120, 8)]
    reqs = [head + [int(t) for t in rng.randint(4, 120, rng.randint(2, 8))] for _ in range(6)]
    tlm = load_model("llama-test", device="cpu")
    sink.install_sink(sink.build_sink("jsonl", str(out)))
    try:
        ServingEngine(tlm.module, tlm.config, ServeConfig(
            max_slots=2, max_new_tokens=8, max_source_length=16, log_every_steps=2,
            paged_kv=True, kv_block_size=8, pool_blocks=24, prefix_cache=True,
            prefix_cache_budget_gib=0.25, spec_tokens=3), is_seq2seq=False,
            device="cpu").generate(reqs)
    finally:
        sink.install_sink(sink.build_sink("stdout", ""))
    return out


@pytest.mark.parametrize("flags", [
    [], ["--min-prefix-hit-rate", "0.5"], ["--min-prefix-hit-rate", "0.99"],
    ["--min-acceptance-rate", "0.005"], ["--min-acceptance-rate", "0.99"],
], ids=["none", "hit_ok", "hit_low", "accept_ok", "accept_low"])
def test_prefix_and_spec_sections_and_gates_are_jaxs(serve_run, flags, capsys):
    got, want = report.build_report(str(serve_run)), jax_report.build_report(str(serve_run))
    for key in ("prefix", "spec"):
        assert got[key] is not None and got[key] == want[key], key
    assert got["prefix"]["windows"] > 0 and got["spec"]["windows"] > 0
    md = _serving_sections(report.render_markdown(got))
    assert len(md) == 2 and md == _serving_sections(jax_report.render_markdown(want))
    rcs = [m.main([str(serve_run), "--strict", *flags]) for m in (report, jax_report)]
    assert rcs[0] == rcs[1] == (1 if flags and flags[1] == "0.99" else 0)
    capsys.readouterr()


def _serving_sections(text: str) -> dict[str, str]:
    out, key = {}, None
    for line in text.splitlines():
        if line.startswith("#"):
            key = line if line in ("## Prefix cache", "## Speculative decode") else None
        if key is not None:
            out[key] = out.get(key, "") + line + "\n"
    return out


def test_serving_gates_with_nothing_to_read_fail(tmp_path, capsys):
    _write(tmp_path, 0, [_budget(2, 10.0, False)])
    for flags in (["--min-prefix-hit-rate", "0.1"], ["--min-acceptance-rate", "0.1"]):
        assert report.main([str(tmp_path), "--strict", *flags]) == 1
        assert jax_report.main([str(tmp_path), "--strict", *flags]) == 1
    assert report.build_report(str(tmp_path))["prefix"] is None
    capsys.readouterr()
