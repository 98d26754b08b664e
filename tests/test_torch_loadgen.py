"""The port's open-loop load generator against the JAX package's.

``arrival_schedule`` bit-equal for ``poisson``, ``bursty`` and ``ramp``
over several seeds and rates; ``LoadgenConfig``'s refusals;
``chatbot_requests`` equal; ``detect_knee``, ``queue_growing`` and
``summarize_point`` equal on the same pinned curves; ``drive_open_loop``
and ``sweep_qps`` on a ``VirtualClock`` fake session (the same rows,
points and knee), the open loop seeing a collapse that the closed loop
cannot, arrival timing moving latency and not tokens; the router target's
shed accounting on fake replicas; the report's load-sweep section from the
JSONL alone and its two strict gates cutting both ways, failing a run with
no measurement; ``serve-loadgen --replicas 0`` through ``cli.main`` on
``llama-test``, every point's tokens equal to the closed-loop run's."""

import json
import os

import numpy as np
import pytest

from distributed_llms_example_tpu.serving import loadgen as jlg
from distributed_llms_example_tpu_torch.launch import cli
from distributed_llms_example_tpu_torch.obs import sink
from distributed_llms_example_tpu_torch.obs.report import build_report, main as report_main
from distributed_llms_example_tpu_torch.obs.report import render_markdown
from distributed_llms_example_tpu_torch.serving import loadgen as lg


@pytest.fixture(autouse=True)
def _stdout_sink():
    sink.install_sink(sink.build_sink("stdout", ""))
    yield
    sink.install_sink(sink.build_sink("stdout", ""))


@pytest.mark.parametrize("seed", [0, 3, 11])
@pytest.mark.parametrize("process", ["poisson", "bursty", "ramp"])
def test_arrival_schedule_bit_equal_jax(process, seed):
    for qps, n, kw in ((4.0, 64, {}), (0.5, 16, {"burst_size": 3, "ramp_start_frac": 0.4})):
        want = jlg.arrival_schedule(process, qps=qps, n=n, seed=seed, **kw)
        got = lg.arrival_schedule(process, qps=qps, n=n, seed=seed, **kw)
        assert got.dtype == want.dtype == np.float64
        assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("bad", [
    dict(process="uniform"), dict(burst_size=0), dict(ramp_start_frac=0.0), dict(qps_grid=()),
    dict(qps_grid=(1.0, -2.0)), dict(qps_grid=(4.0, 2.0)),
])
def test_config_refusals_equal_jax(bad):
    with pytest.raises(ValueError) as want:
        jlg.LoadgenConfig(**bad)
    with pytest.raises(ValueError) as got:
        lg.LoadgenConfig(**bad)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("args", [dict(process="poisson", qps=1.0, n=0, seed=0),
                                  dict(process="poisson", qps=0.0, n=4, seed=0),
                                  dict(process="uniform", qps=1.0, n=4, seed=0)])
def test_schedule_refusals_equal_jax(args):
    with pytest.raises(ValueError) as want:
        jlg.arrival_schedule(**args)
    with pytest.raises(ValueError) as got:
        lg.arrival_schedule(**args)
    assert str(got.value) == str(want.value)


def test_chatbot_requests_equal_jax():
    kw = dict(sessions=5, turns=3, seed=4, vocab=120, shared_frac=0.6, max_len=24,
              with_budgets=True)
    assert lg.chatbot_requests(**kw) == jlg.chatbot_requests(**kw)


def _point(offered, *, achieved=None, growing=False, shed=0, realized=None):
    p = {"offered_qps": offered, "achieved_qps": offered if achieved is None else achieved,
         "queue_growing": growing, "shed": shed}
    if realized is not None:
        p["offered_qps_realized"] = realized
    return p


CURVES = {
    "stops_tracking": [_point(1.0), _point(2.0), _point(4.0, achieved=3.0),
                       _point(8.0, achieved=3.1)],
    "queue_grows_first": [_point(1.0), _point(2.0, growing=True), _point(4.0, achieved=1.0)],
    "sheds": [_point(1.0), _point(2.0, shed=3)],
    "never_saturates": [_point(1.0), _point(2.0), _point(4.0)],
    "near_tol": [_point(2.0, achieved=1.9)],
    "realized_below_nominal": [_point(4.0, achieved=2.9, realized=3.0)],
}


@pytest.mark.parametrize("tol", [0.9, 0.99])
@pytest.mark.parametrize("curve", sorted(CURVES))
def test_detect_knee_equals_jax(curve, tol):
    assert lg.detect_knee(CURVES[curve], track_tol=tol) == \
        jlg.detect_knee(CURVES[curve], track_tol=tol)


def _row(arrival, ttft, finished=True, shed=False, delay=0.0):
    return {"arrival_s": arrival, "ttft_s": ttft, "finished": finished, "shed": shed,
            "queue_delay_s": delay if finished or shed else None}


ROWS = {
    "flat": [_row(i * 1.0, 0.05) for i in range(8)],
    "ramp": [_row(i * 1.0, 0.01 if i < 6 else 0.5) for i in range(8)],
    "unfinished_tail": [_row(i * 1.0, 0.05) for i in range(7)] + [_row(7.0, None, False)],
    "three_rows": [_row(i * 1.0, 0.05) for i in range(3)],
    "collapsed": [_row(float(i), None, False) for i in range(4)],
    "mixed": [_row(0.0, 0.01), _row(1.0, 5.0), _row(2.0, None, False, True),
              _row(3.0, None, False)],
    "tiny_waits": [_row(i * 1.0, 0.001 if i < 6 else 0.004) for i in range(8)],
}


@pytest.mark.parametrize("rows", sorted(ROWS))
def test_queue_growing_and_summarize_point_equal_jax(rows):
    r = ROWS[rows]
    assert lg.queue_growing(r, 8.0) == jlg.queue_growing(r, 8.0)
    kw = dict(offered_qps=2.0, ttft_slo_ms=100.0, wall_s=4.0)
    assert lg.summarize_point(r, **kw) == jlg.summarize_point(r, **kw)


class ClockedFakeSession:
    """The session surface drive_open_loop reads, on a virtual clock: ``slots``
    at once, a token a request a step, each step ``step_s`` of virtual
    time (capacity slots / (step_s x budget) requests a second)."""

    def __init__(self, clock, slots=2, step_s=0.05, default_budget=4):
        self.clock, self.slots, self.step_s = clock, slots, step_s
        self.default_budget = default_budget
        self.submit_t, self.arrival_t, self.budgets, self.outputs = [], [], [], []
        self._first, self.pending, self.active = [], [], []

    def submit(self, tokens, *, max_new=None, attention_mask=None, label=None, arrival=None):
        rid = len(self.submit_t)
        now = self.clock.now()
        self.submit_t.append(now)
        self.arrival_t.append(arrival if arrival is not None else now)
        self.budgets.append(max_new or self.default_budget)
        self.outputs.append([])
        self._first.append(None)
        self.pending.append(rid)
        return rid

    def has_work(self):
        return bool(self.pending or self.active)

    def step(self):
        self.clock.advance(self.step_s)
        while self.pending and len(self.active) < self.slots:
            self.active.append(self.pending.pop(0))
        finished = []
        for rid in list(self.active):
            self.outputs[rid].append(100 + len(self.outputs[rid]))
            if self._first[rid] is None:
                self._first[rid] = self.clock.now()
            if len(self.outputs[rid]) >= self.budgets[rid]:
                self.active.remove(rid)
                finished.append(rid)
        return finished

    def finalize(self):
        return {}

    def first_token_wall(self, rid):
        return self._first[rid]

    def output(self, rid):
        return self.outputs[rid]


def _sweep(mod, cfg, n_req=24, slots=2, step_s=0.05, budgets=None):
    vc = mod.VirtualClock()
    return mod.sweep_qps(
        lambda: mod.EngineTarget(ClockedFakeSession(vc, slots=slots, step_s=step_s)),
        [[1, 2, 3]] * n_req, cfg, budgets=budgets, clock=vc.now, wait=vc.advance, emit=False)


@pytest.mark.parametrize("process", ["poisson", "bursty", "ramp"])
def test_sweep_on_virtual_clock_equals_jax(process):
    """The same points (rows' summaries, verdicts) and knee as the JAX
    sweep; twice the same; the knee where the offer crosses the fake's
    capacity of 10 requests a second."""
    kw = dict(process=process, qps_grid=(1.0, 4.0, 40.0), ttft_slo_ms=400.0)
    budgets = [4, 3, 4, 2] * 6
    want = _sweep(jlg, jlg.LoadgenConfig(**kw), budgets=budgets)
    got = _sweep(lg, lg.LoadgenConfig(**kw), budgets=budgets)
    assert got == want == _sweep(lg, lg.LoadgenConfig(**kw), budgets=budgets)
    assert got["knee_qps"] == 40.0 and got["points"][-1]["queue_growing"]


@pytest.mark.parametrize("cap", [0.0, 2.0])
def test_drive_open_loop_rows_equal_jax(cap):
    rows = []
    for mod in (jlg, lg):
        vc = mod.VirtualClock()
        sess = ClockedFakeSession(vc, slots=1, step_s=0.1 if not cap else 0.5,
                                  default_budget=1 if not cap else 8)
        sched = [i * 0.01 for i in range(12)] if not cap else [0.0, 0.1, 50.0]
        rows.append(mod.drive_open_loop(mod.EngineTarget(sess), [[1]] * len(sched), sched,
                                        clock=vc.now, wait=vc.advance, max_wall_s=cap))
    assert rows[1] == rows[0]
    got, wall = rows[1]
    if cap:
        assert got[2]["submitted"] is False and got[2]["finished"] is False
    else:
        assert got[-1]["ttft_s"] > 5 * got[0]["ttft_s"] and lg.queue_growing(got, wall)
    with pytest.raises(ValueError, match="arrivals for"):
        lg.drive_open_loop(lg.EngineTarget(ClockedFakeSession(lg.VirtualClock())), [[1]] * 2,
                           [0.0])


def test_open_loop_sees_collapse_closed_loop_cannot():
    vc = lg.VirtualClock()
    sess = ClockedFakeSession(vc, slots=2, step_s=0.05)
    for _ in range(16):
        sess.submit([1, 2, 3])
    while sess.has_work():
        sess.step()
    assert 16 / vc.now() > 9.0  # closed loop: healthy, at capacity
    point = _sweep(lg, lg.LoadgenConfig(qps_grid=(40.0,), ttft_slo_ms=400.0), n_req=16)
    point = point["points"][0]
    assert point["queue_growing"] and point["slo_attainment"] < 1.0
    assert point["achieved_qps"] > 9.0


def test_open_loop_tokens_equal_closed_loop():
    vc = lg.VirtualClock()
    oracle = ClockedFakeSession(vc, slots=2, step_s=0.05)
    budgets = [2, 4, 3, 5, 1, 4, 2, 3]
    for b in budgets:
        oracle.submit([1], max_new=b)
    while oracle.has_work():
        oracle.step()
    vc2 = lg.VirtualClock()
    sess = ClockedFakeSession(vc2, slots=2, step_s=0.05)
    lg.drive_open_loop(lg.EngineTarget(sess), [[1]] * 8,
                       lg.arrival_schedule("bursty", qps=30.0, n=8, seed=1), budgets=budgets,
                       clock=vc2.now, wait=vc2.advance)
    assert sess.outputs == oracle.outputs


def test_router_target_counts_sheds_as_jax():
    """A burst into a bounded router queue over fake replicas: the same
    rows (shed flags, tokens) as the JAX router target; the router rows
    carry the arrival's queue delay; the sheds make the point the knee."""
    from distributed_llms_example_tpu.serving.router import (
        ReplicaRouter as JaxReplicaRouter,
        RouterConfig as JaxRouterConfig,
    )
    from distributed_llms_example_tpu_torch.serving.router import ReplicaRouter, RouterConfig
    from tests.test_torch_router import FakeEngine

    shapes = []
    for mod, router in ((jlg, JaxReplicaRouter([FakeEngine(), FakeEngine()], None,
                                               JaxRouterConfig(log_every_ticks=0, max_queue=4,
                                                               shed_policy="shed"))),
                        (lg, ReplicaRouter([FakeEngine(), FakeEngine()],
                                           RouterConfig(log_every_ticks=0, max_queue=4,
                                                        shed_policy="shed")))):
        rows, wall = mod.drive_open_loop(mod.RouterTarget(router), [[1, 2]] * 10, [1e-4] * 10)
        shapes.append([(r["shed"], r["finished"], r["tokens"], r["ttft_s"] is None)
                       for r in rows])
    assert shapes[1] == shapes[0]
    assert any(s[0] for s in shapes[1])
    rrows = [r for r in router.request_rows() if not r["synthetic"]]
    assert all(r["queue_delay_ms"] >= 0 for r in rrows)
    point = lg.summarize_point(rows, offered_qps=1000.0, ttft_slo_ms=500.0, wall_s=wall)
    assert lg.detect_knee([point]) == 1000.0


def _emit_sweep(tmp_path, cfg):
    path = os.path.join(str(tmp_path), "obs", "metrics-p000.jsonl")
    sink.install_sink(sink.JsonlFileSink(path))
    try:
        vc = lg.VirtualClock()
        return lg.sweep_qps(lambda: lg.EngineTarget(ClockedFakeSession(vc)), [[1, 2, 3]] * 16,
                            cfg, clock=vc.now, wait=vc.advance)
    finally:
        sink.current_sink().close()
        sink.install_sink(sink.build_sink("stdout", ""))


def test_report_section_and_gates(tmp_path, capsys):
    """The section from the JSONL alone; ``--min-slo-attainment`` and
    ``--max-p99-ttft-ms`` each pass a bound the sweep meets and fail one it
    misses."""
    summary = _emit_sweep(tmp_path, lg.LoadgenConfig(qps_grid=(1.0, 4.0, 40.0),
                                                     ttft_slo_ms=400.0))
    report = build_report(str(tmp_path))
    rep = report["loadgen"]
    assert rep["knee_qps"] == summary["knee_qps"] == 40.0
    assert [p["offered_qps"] for p in rep["points"]] == [1.0, 4.0, 40.0]
    assert rep["best_slo_attainment"] == 1.0 and rep["best_ttft_p99_ms"] is not None
    md = render_markdown(report)
    assert "## Open-loop load sweep" in md and "**40 QPS** (first saturated offered rate)" in md
    d = str(tmp_path)
    capsys.readouterr()
    assert report_main([d, "--strict", "--json", "--min-slo-attainment", "0.99"]) == 0
    assert report_main([d, "--strict", "--json", "--max-p99-ttft-ms", "5000"]) == 0
    assert report_main([d, "--strict", "--json", "--max-p99-ttft-ms", "1"]) == 1
    assert "exceeds" in capsys.readouterr().err
    worst = min(p["slo_attainment"] for p in rep["points"])
    assert rep["best_slo_attainment"] > worst
    assert report_main([d, "--strict", "--json", "--min-slo-attainment", "1.01"]) == 1
    assert "below" in capsys.readouterr().err


def test_gates_fail_without_a_measurement(tmp_path, capsys):
    """No loadgen run, and a sweep whose every point collapsed: the gates
    fail as a missing measurement; bare points still render."""
    (tmp_path / "obs").mkdir()
    path = tmp_path / "obs" / "metrics-p000.jsonl"
    path.write_text(json.dumps({"schema_version": 1, "step": 1, "loss": 1.0}) + "\n")
    d = str(tmp_path)
    capsys.readouterr()
    assert report_main([d, "--strict", "--json"]) == 0
    assert report_main([d, "--strict", "--json", "--min-slo-attainment", "0.5"]) == 1
    assert "no loadgen measurement" in capsys.readouterr().err
    p = lg.summarize_point([_row(0.0, None, False)], offered_qps=8.0, ttft_slo_ms=100.0,
                           wall_s=1.0)
    path.write_text(json.dumps({"schema_version": 1, "event": "loadgen_point",
                                "process": "poisson", "seed": 0, **p}) + "\n")
    assert report_main([d, "--strict", "--json", "--max-p99-ttft-ms", "500"]) == 1
    assert "no measured p99" in capsys.readouterr().err
    assert "not reached on this grid" in render_markdown(build_report(d))


def test_serve_loadgen_cli_tokens_equal_closed_loop(tmp_path, capsys):
    """``serve-loadgen --replicas 0`` on ``llama-test`` (CPU): a point a
    grid rate, every point's tokens equal to ``serve``'s closed-loop run,
    the summary written through the product writer; the JAX CLI's
    refusals of a bad grid."""
    prompts = tmp_path / "p.json"
    prompts.write_text(json.dumps([f"prompt {i} " * (i + 1) for i in range(6)]))
    base = ["--device", "cpu", "--model-ckpt", "llama-test", "--tokenizer", "byte",
            "--prompts-file", str(prompts), "--max-slots", "2", "--max-new-tokens", "8",
            "--max-source-length", "32", "--log-every-steps", "0", "--paged-kv",
            "--kv-block-size", "8"]
    _, closed = cli.serve(base)
    out = tmp_path / "sweep.json"
    summary, outputs = cli.serve_loadgen([*base, "--qps-grid", "2,20,2000",
                                          "--loadgen-seed", "5", "--output-file", str(out)])
    assert [p["offered_qps"] for p in summary["points"]] == [2.0, 20.0, 2000.0]
    assert outputs == [closed] * 3
    assert json.loads(out.read_text())["points"] == summary["points"]
    assert cli.main(["serve-loadgen", *base, "--qps-grid", "5"]) == 0
    for bad in ("4,2", "0"):
        with pytest.raises(SystemExit):
            cli.main(["serve-loadgen", *base, "--qps-grid", bad])
