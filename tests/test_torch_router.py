"""The port's replica router against the JAX package's.

Pure logic: one fake session class (the ``ServeSession`` surface the
router drives, a token a step) behind both the JAX and the port
``ReplicaRouter``, each scenario run on both: the same health transitions,
retries, sheds, deferrals, deadlines, drains, storms, affinity remaps,
router windows and ``router_summary`` (its wall-clock fields aside), and
the same per-request outcomes.  On ``llama-test`` weights (through
``from_jax``), a module-scoped pool: ``replica_crash`` leaves every
request's tokens equal to the JAX single-engine oracle's and to the JAX
router's; a crash with the prefix cache on drops the dead replica's warm
set and leaks no block; a drained replica loses nothing; the session API
(incremental submits, ``take_pending``, labels, the arrival stamp, a
custom attention mask against the JAX engine's); ``obs.report --strict``
green on an injected crash, red on an organic one, the router gates and
the router scope of the prefix report; ``serve-router`` through
``cli.main``; ``ProductJsonlWriter`` surviving ``kill -9``."""

import json
import os
import signal
import subprocess
import sys
import textwrap
import time

import jax
import numpy as np
import pytest

from distributed_llms_example_tpu.models.registry import load_model as jax_load_model
from distributed_llms_example_tpu.obs import sink as jax_sink
from distributed_llms_example_tpu.obs.chaos import parse_chaos as jax_parse_chaos
from distributed_llms_example_tpu.serving.engine import (
    ServeConfig as JaxServeConfig,
    ServingEngine as JaxServingEngine,
)
from distributed_llms_example_tpu.serving.router import (
    ReplicaRouter as JaxReplicaRouter,
    RouterConfig as JaxRouterConfig,
)
from distributed_llms_example_tpu_torch.launch import cli
from distributed_llms_example_tpu_torch.models.from_jax import load_jax_params
from distributed_llms_example_tpu_torch.models.registry import load_model
from distributed_llms_example_tpu_torch.obs import sink
from distributed_llms_example_tpu_torch.obs.chaos import parse_chaos
from distributed_llms_example_tpu_torch.obs.report import build_report, main as report_main
from distributed_llms_example_tpu_torch.obs.report import render_markdown
from distributed_llms_example_tpu_torch.serving.engine import ServeConfig, ServingEngine, trim_eos
from distributed_llms_example_tpu_torch.serving.router import ReplicaRouter, RouterConfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _stdout_sinks():
    for s in (sink, jax_sink):
        s.install_sink(s.build_sink("stdout", ""))
    yield
    for s in (sink, jax_sink):
        s.install_sink(s.build_sink("stdout", ""))


class FakeSession:
    """The session surface the router drives: a token a step a request
    (``budget`` steps, default 3), ``slots`` at once; ``frozen`` is an
    organic stall (no progress, no exception)."""

    def __init__(self, slots=2, default_budget=3):
        self.slots, self.default_budget = slots, default_budget
        self.requests, self.budgets, self.labels, self.outputs = [], [], [], []
        self.arrivals, self._first, self.pending = [], [], []
        self.active: dict[int, int] = {}
        self.progress = 0
        self.frozen = False

    def submit(self, tokens, *, max_new=None, attention_mask=None, label=None, arrival=None):
        rid = len(self.requests)
        self.requests.append(list(tokens))
        self.arrivals.append(arrival)
        self.budgets.append(max_new or self.default_budget)
        self.labels.append(rid if label is None else label)
        self.outputs.append([])
        self._first.append(None)
        self.pending.append(rid)
        return rid

    @property
    def queue_depth(self):
        return len(self.pending)

    @property
    def active_count(self):
        return len(self.active)

    def has_work(self):
        return bool(self.pending or self.active)

    def output(self, rid):
        return self.outputs[rid]

    def first_token_wall(self, rid):
        return self._first[rid]

    def take_pending(self):
        labels = [self.labels[r] for r in self.pending]
        self.pending.clear()
        return labels

    def finalize(self):
        pass

    def step(self):
        if self.frozen:
            return []
        finished = []
        while self.pending and len(self.active) < self.slots:
            self.active[self.pending.pop(0)] = 0
            self.progress += 1
        if self.active:
            self.progress += 1
            now = time.perf_counter()
            for rid in list(self.active):
                self.outputs[rid].append(100 + len(self.outputs[rid]))
                if self._first[rid] is None:
                    self._first[rid] = now
                self.active[rid] += 1
                if self.active[rid] >= self.budgets[rid]:
                    del self.active[rid]
                    finished.append(rid)
        return finished


class FakeEngine:
    paged = prefix = False
    spec = 0
    prefill_batch = 2
    last_stats = None

    class serve:
        ttft_slo_ms = 0.0

    def open(self, *params, replica=None):  # JAX passes the params first
        return FakeSession()


def _router(side, n=2, chaos="", **cfg):
    cfg = {"log_every_ticks": 0, **cfg}
    engines = [FakeEngine() for _ in range(n)]
    if side == "jax":
        return JaxReplicaRouter(engines, None, JaxRouterConfig(
            **cfg, chaos=jax_parse_chaos(chaos) if chaos else None))
    return ReplicaRouter(engines, RouterConfig(**cfg, chaos=parse_chaos(chaos) if chaos else None))


def sc_stall(side):
    r = _router(side, suspect_after_ticks=2, dead_after_ticks=4)
    for _ in range(6):
        r.submit([1, 2, 3])
    r.tick()
    r.replicas[0].session.frozen = True
    r.run_until_drained()
    return r


def sc_suspect_recovers(side):
    r = _router(side, suspect_after_ticks=1, dead_after_ticks=10)
    r.submit([1], max_new=8)
    r.tick()
    r.replicas[0].session.frozen = True
    for _ in range(3):
        r.tick()
    r.replicas[0].session.frozen = False
    r.run_until_drained()
    return r


def sc_retry_exhaustion(side):
    r = _router(side, n=1, max_retries=1, retry_backoff_ticks=1, suspect_after_ticks=1,
                dead_after_ticks=2)
    r.submit([1, 2])
    r.tick()
    r._fail_replica(r.replicas[0], cause="crash", reason="test")
    r.run_until_drained()
    return r


def sc_backoff(side):
    r = _router(side, retry_backoff_ticks=4, retry_backoff_cap_ticks=8)
    r.submit([1, 2, 3])
    r.tick()
    r._fail_replica(r.replicas[0], cause="crash", reason="test")
    r.submit([9, 9])
    r.tick()
    r.run_until_drained()
    return r


def sc_shed(side):
    r = _router(side, max_queue=2, shed_policy="shed")
    for _ in range(5):
        r.submit([1])
    r.run_until_drained()
    return r


def sc_defer(side):
    r = _router(side, max_queue=2, shed_policy="defer")
    for _ in range(5):
        r.submit([1])
    r.run_until_drained()
    return r


def sc_deadline(side):
    r = _router(side, n=1, max_queue=2, shed_policy="defer")
    r.submit([1])
    r.submit([1])
    r.submit([1], deadline_ticks=1)
    r.submit([1], deadline_ticks=1)
    for _ in range(3):
        r.tick()
    r.run_until_drained()
    return r


def sc_storm(side):
    r = _router(side, max_queue=2, shed_policy="defer", storm_size=12, storm_deadline_ticks=2,
                chaos="request_storm@2")
    for _ in range(4):
        r.submit([1, 2])
    r.run_until_drained()
    return r


def sc_drain_replica(side):
    r = _router(side)
    for _ in range(6):
        r.submit([1, 2, 3], max_new=6)
    r.tick()
    r.drain_replica(0)
    r.run_until_drained()
    return r


def sc_draining_stall(side):
    r = _router(side, suspect_after_ticks=1, dead_after_ticks=3)
    for _ in range(4):
        r.submit([1, 2], max_new=8)
    r.tick()
    r.drain_replica(0)
    r.replicas[0].session.frozen = True
    r.run_until_drained()
    return r


def sc_storm_and_crash(side):
    r = _router(side, storm_size=10, storm_deadline_ticks=30, retry_backoff_ticks=1,
                chaos="request_storm@1,replica_crash@3")
    for _ in range(4):
        r.submit([1, 2])
    r.run_until_drained()
    return r


def sc_router_drain(side):
    r = _router(side)
    r.submit([1])
    r.drain()
    r.submit([2])
    r.run_until_drained()
    return r


def sc_affinity(side):
    r = _router(side)
    for key in ("user-a", "user-a", "user-b", "user-b"):
        r.submit([1], session=key)
    r.run_until_drained()
    r._fail_replica(r.replicas[r.affinity["user-a"]], cause="crash", reason="t")
    r.submit([1], session="user-a")
    r.run_until_drained()
    return r


def sc_chaos_crash(side):
    r = _router(side, log_every_ticks=2, chaos="replica_crash@2")
    for _ in range(8):
        r.submit([1, 2], max_new=5)
    r.run_until_drained()
    return r


def sc_chaos_stall(side):
    r = _router(side, log_every_ticks=3, chaos="replica_stall@2", suspect_after_ticks=1,
                dead_after_ticks=3)
    for _ in range(8):
        r.submit([1, 2], max_new=5)
    r.run_until_drained()
    return r


SCENARIOS = {f.__name__[3:]: f for f in (
    sc_stall, sc_suspect_recovers, sc_retry_exhaustion, sc_backoff, sc_shed, sc_defer,
    sc_deadline, sc_storm, sc_drain_replica, sc_draining_stall, sc_storm_and_crash,
    sc_router_drain, sc_affinity, sc_chaos_crash, sc_chaos_stall)}
# the summary's wall-clock fields: their presence is compared, not values
TIMED = ("wall_s", "request_mttr_s", "ttft_p50_ms", "ttft_p95_ms", "ttft_p99_ms",
         "goodput_tokens_per_sec", "goodput_tokens_per_sec_chip", "t_fail_s", "t_recovered_s")
EVENTS = ("chaos_injection", "replica_health", "serve_retry", "serve_shed", "router_window",
          "router_summary")


def _trace(side, scenario, capsys):
    capsys.readouterr()
    r = SCENARIOS[scenario](side)
    r.finalize()
    events = [json.loads(x) for x in capsys.readouterr().out.splitlines() if x.startswith("{")]
    events = [e for e in events if e.get("event") in EVENTS]
    for e in events:
        for k in TIMED:
            if k in e:
                e[k] = e[k] is not None
    requests = [(q.rid, q.done, q.shed, q.shed_reason, q.retries, q.replica, q.synthetic,
                 list(q.out), q.session_key) for q in r.requests]
    states = [(x.idx, x.state, x.crashes) for x in r.replicas]
    return {"events": events, "requests": requests, "states": states,
            "affinity": dict(r.affinity), "ticks": r.ticks}


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_router_logic_equals_jax(scenario, capsys):
    want = _trace("jax", scenario, capsys)
    got = _trace("port", scenario, capsys)
    assert got == want
    summary = got["events"][-1]
    assert summary["event"] == "router_summary"
    if scenario in ("stall", "chaos_stall", "draining_stall"):
        assert any(e["to"] == "dead" and e["cause"] == "stall" for e in got["events"]
                   if e["event"] == "replica_health")
    if scenario == "drain_replica":
        assert summary["retries_total"] == 0 and summary["completed"] == 6


def test_router_config_validation():
    for bad in (dict(shed_policy="drop"), dict(max_retries=-1),
                dict(suspect_after_ticks=4, dead_after_ticks=4)):
        with pytest.raises(ValueError):
            JaxRouterConfig(**bad)
        with pytest.raises(ValueError):
            RouterConfig(**bad)
    with pytest.raises(ValueError):
        ReplicaRouter([])


# ------------------------------------------------------- on llama-test weights

W, L, SLOTS = 16, 8, 2
KW = dict(max_slots=SLOTS, prefill_batch=SLOTS, max_new_tokens=L, max_source_length=W,
          log_every_steps=0)


def _requests(rng, n, lo=3, hi=14):
    return [[int(t) for t in rng.randint(4, 120, rng.randint(lo, hi))] for _ in range(n)]


@pytest.fixture(scope="module")
def llama_pool():
    """The JAX single-engine oracle and the JAX router (crash at tick 4)
    on llama-test's seed-0 weights; the port's model with those weights."""
    lm = jax_load_model("llama-test")
    params = jax.device_get(lm.init_params(0))
    reqs = _requests(np.random.RandomState(7), 10)
    jax_engines = [JaxServingEngine(lm.module, lm.config, None, JaxServeConfig(**KW),
                                    is_seq2seq=False) for _ in range(2)]
    oracle = jax_engines[0].generate(params, reqs)
    jrouter = JaxReplicaRouter(jax_engines, params, JaxRouterConfig(
        log_every_ticks=0, chaos=jax_parse_chaos("replica_crash@4")))
    jax_router_outs = jrouter.serve(reqs)
    tlm = load_model("llama-test", device="cpu")
    load_jax_params(tlm.module, params)
    return {"lm": lm, "params": params, "reqs": reqs, "oracle": oracle,
            "jax_engine": jax_engines[0], "jax_router": jrouter,
            "jax_router_outs": jax_router_outs, "tlm": tlm}


def _engine(tlm, **kw):
    return ServingEngine(tlm.module, tlm.config, ServeConfig(**{**KW, **kw}), is_seq2seq=False,
                         device="cpu")


def _trim(pool, outs):
    eos, pad = pool["lm"].config.eos_token_id, pool["lm"].config.pad_token_id
    return [trim_eos(o, eos, pad) for o in outs]


@pytest.mark.parametrize("paged", [False, True], ids=["flat", "paged"])
def test_replica_crash_tokens_equal_jax(llama_pool, tmp_path, capsys, paged):
    """replica_crash@4 mid-decode: every request completes on the survivor
    with the JAX oracle's tokens and the JAX router's, the same retries;
    the JSONL holds the fault as injected (``--strict`` 0) with the
    request MTTR, and the router gates cut both ways."""
    pool = llama_pool
    extra = dict(paged_kv=True, kv_block_size=8) if paged else {}
    out = tmp_path / "run"
    sink.install_sink(sink.build_sink("jsonl", str(out)))
    router = ReplicaRouter([_engine(pool["tlm"], **extra) for _ in range(2)],
                           RouterConfig(log_every_ticks=4, chaos=parse_chaos("replica_crash@4")))
    outs = router.serve(pool["reqs"])
    sink.install_sink(sink.build_sink("stdout", ""))
    assert _trim(pool, outs) == _trim(pool, pool["oracle"])
    assert outs == pool["jax_router_outs"]
    summary, jsummary = router.last_stats, pool["jax_router"].last_stats
    for k in ("completed", "shed", "retries", "replica_states", "ticks", "request_retry_rate"):
        assert summary[k] == jsummary[k], k
    assert summary["retries"] > 0 and summary["request_mttr_s"] is not None
    if paged:
        assert all(r.engine.pool.blocks_in_use == 0 for r in router.replicas)
    report = build_report(str(out))
    rec = report["recovery"]
    assert "replica_crash" in {f["kind"] for f in rec["faults"]}
    assert rec["organic_faults"] == []
    assert rec["serving"]["retries"] == summary["retries"]
    assert rec["serving"]["request_mttr_s"] == summary["request_mttr_s"]
    assert "replica 0" in render_markdown(report)
    capsys.readouterr()
    assert report_main([str(out), "--strict", "--json"]) == 0
    assert report_main([str(out), "--strict", "--json", "--max-request-retry-rate", "0.9",
                        "--min-serve-goodput-frac", "0.9"]) == 0
    assert report_main([str(out), "--strict", "--json", "--max-request-retry-rate", "0"]) == 1
    assert report_main([str(out), "--strict", "--json", "--min-serve-goodput-frac", "1.1"]) == 1
    capsys.readouterr()


def test_organic_crash_fails_strict(llama_pool, tmp_path, capsys):
    pool = llama_pool
    out = tmp_path / "run"
    sink.install_sink(sink.build_sink("jsonl", str(out)))
    router = ReplicaRouter([_engine(pool["tlm"]) for _ in range(2)],
                           RouterConfig(log_every_ticks=0))
    for r in pool["reqs"]:
        router.submit(r)
    router.tick()
    router.replicas[0].session.step = lambda: (_ for _ in ()).throw(RuntimeError("device lost"))
    router.run_until_drained()
    router.finalize()
    sink.install_sink(sink.build_sink("stdout", ""))
    assert _trim(pool, [q.out for q in router.requests]) == _trim(pool, pool["oracle"])
    organic = build_report(str(out))["recovery"]["organic_faults"]
    assert [f["kind"] for f in organic] == ["replica_crash"]
    capsys.readouterr()
    assert report_main([str(out), "--strict", "--json"]) == 1
    capsys.readouterr()


def test_serving_gates_fail_without_router_summary(tmp_path, capsys):
    (tmp_path / "obs").mkdir()
    (tmp_path / "obs" / "metrics-p000.jsonl").write_text(json.dumps(
        {"schema_version": sink.SCHEMA_VERSION, "event": "metric", "step": 1}) + "\n")
    capsys.readouterr()
    assert report_main([str(tmp_path), "--strict", "--json"]) == 0
    assert report_main([str(tmp_path), "--strict", "--json",
                        "--max-request-retry-rate", "1"]) == 1
    assert report_main([str(tmp_path), "--strict", "--json",
                        "--min-serve-goodput-frac", "0.5"]) == 1
    capsys.readouterr()


def test_crash_drops_the_dead_replicas_warm_set(llama_pool, tmp_path, capsys):
    """Session-keyed multi-turn traffic over prefix-cache replicas with a
    crash at tick 4: tokens equal the JAX engine's cold run, the dead
    replica's warm set is dropped (its pool content is gone) with no block
    leaked, the survivor keeps a warm set, and the router's tier-wide
    ledger is the report's prefix scope."""
    pool = llama_pool
    rng = np.random.RandomState(41)
    head = [int(t) for t in rng.randint(4, 120, 8)]
    reqs = [head + [int(t) for t in rng.randint(4, 120, rng.randint(2, 8))] for _ in range(10)]
    keys = [f"session-{i % 3}" for i in range(10)]
    oracle = pool["jax_engine"].generate(pool["params"], reqs)
    prefix = dict(paged_kv=True, kv_block_size=8, pool_blocks=24, prefix_cache=True,
                  prefix_cache_budget_gib=0.25)
    out = tmp_path / "run"
    sink.install_sink(sink.build_sink("jsonl", str(out)))
    router = ReplicaRouter([_engine(pool["tlm"], **prefix) for _ in range(2)],
                           RouterConfig(log_every_ticks=0, chaos=parse_chaos("replica_crash@4")))
    outs = router.serve(reqs, sessions=keys)
    sink.install_sink(sink.build_sink("stdout", ""))
    assert _trim(pool, outs) == _trim(pool, oracle)
    s = router.last_stats
    assert s["completed"] == len(reqs) and s["shed"] == 0
    (dead,) = [r for r in router.replicas if r.state == "dead"]
    assert dead.engine.pool.blocks_warm == 0 and dead.engine.pool.blocks_in_use == 0
    survivor = next(r for r in router.replicas if r.state != "dead")
    assert survivor.engine.pool.blocks_warm > 0
    assert s["prefix_lookups"] > 0 and s["prefix_hits"] > 0
    px = build_report(str(out))["prefix"]
    assert px["scope"] == "router" and px["hit_rate"] == s["prefix_hit_rate"]
    capsys.readouterr()
    rate = px["hit_rate"]
    assert report_main([str(out), "--strict", "--json", "--min-prefix-hit-rate",
                        str(rate - 0.01)]) == 0
    assert report_main([str(out), "--strict", "--json", "--min-prefix-hit-rate",
                        str(rate + 0.01)]) == 1
    capsys.readouterr()


def test_drain_loses_nothing_and_leaves_no_file(llama_pool, tmp_path, monkeypatch):
    """A replica drained after the first tick: it retires as drained,
    every request completes with the oracle's tokens, the pool ends empty
    and nothing is written anywhere (serving state is derived)."""
    pool = llama_pool
    monkeypatch.chdir(tmp_path)
    router = ReplicaRouter([_engine(pool["tlm"], paged_kv=True, kv_block_size=8)
                            for _ in range(2)], RouterConfig(log_every_ticks=0))
    for r in pool["reqs"]:
        router.submit(r)
    router.tick()
    router.drain_replica(0)
    router.run_until_drained()
    router.finalize()
    assert os.listdir(tmp_path) == []
    assert router.replicas[0].state == "drained" and router.retries_total == 0
    assert _trim(pool, [q.out for q in router.requests]) == _trim(pool, pool["oracle"])
    for r in router.replicas:
        assert r.engine.pool.blocks_in_use == 0
        assert r.engine.pool.ref_invariant_violations([]) == []


def test_session_api(llama_pool, capsys):
    """Submits in flight equal the batch run; ``take_pending`` returns the
    labels; ``progress`` moves on every admit and step; the serve events
    carry the label, the replica and the arrival's queue delay."""
    pool = llama_pool
    eng = _engine(pool["tlm"])
    sess = eng.open(replica=3)
    first = [sess.submit(r, label=100 + i) for i, r in enumerate(pool["reqs"][:4])]
    progress = []
    for _ in range(3):
        sess.step()
        progress.append(sess.progress)
    assert progress == sorted(set(progress)) and progress[0] >= 2  # admit + step
    t_arrival = time.perf_counter() - 0.25
    late = [sess.submit(r, label=104 + i, arrival=t_arrival)
            for i, r in enumerate(pool["reqs"][4:])]
    capsys.readouterr()
    while sess.has_work():
        sess.step()
    sess.finalize()
    assert [sess.output(r) for r in first + late] == pool["oracle"]
    assert all(sess.first_token_wall(r) is not None for r in first + late)
    events = [json.loads(x) for x in capsys.readouterr().out.splitlines() if x.startswith("{")]
    spans = {e["request"]: e for e in events if e["event"] == "serve_request"}
    assert set(spans) >= {104 + i for i in range(len(late))}
    assert all(e["replica"] == 3 for e in spans.values())
    assert all(spans[104 + i]["queue_delay_ms"] >= 250.0 for i in range(len(late)))
    summary = next(e for e in events if e["event"] == "serve_summary")
    assert summary["replica"] == 3 and summary["queue_delay_p99_ms"] >= 250.0
    sess2 = eng.open()
    sess2.submit(pool["reqs"][0], label=41)
    sess2.submit(pool["reqs"][1], label=42)
    assert sess2.take_pending() == [41, 42] and not sess2.has_work()
    sess2.finalize()


@pytest.mark.parametrize("extra", [{}, {"paged_kv": True, "kv_block_size": 8,
                                        "prefix_cache": True}], ids=["flat", "paged_prefix"])
def test_custom_attention_masks_equal_jax(llama_pool, extra):
    """A request's own prompt mask (a hole in it) gives the JAX engine's
    tokens; such requests neither match nor register a cached prefix."""
    pool = llama_pool
    reqs = pool["reqs"][:4]
    masks = [[1] * len(r) for r in reqs]
    for m in masks:
        m[1] = 0
    want = pool["jax_engine"].generate(pool["params"], reqs, attention_masks=masks)
    eng = _engine(pool["tlm"], **extra)
    assert eng.generate(reqs, attention_masks=masks) == want
    if extra:
        assert eng.last_stats.prefix_lookups == 0 and eng.pool.blocks_in_use == 0


def test_serve_router_cli(llama_pool, tmp_path):
    """``serve-router`` through ``cli.main`` on the CPU: one record a
    prompt, none shed, the output through the product writer."""
    prompts = tmp_path / "p.json"
    prompts.write_text(json.dumps([f"prompt number {i} with words" for i in range(6)]))
    out = tmp_path / "out.jsonl"
    base = ["--device", "cpu", "--model-ckpt", "llama-test", "--tokenizer", "byte",
            "--prompts-file", str(prompts), "--max-slots", "2", "--max-new-tokens", "8",
            "--max-source-length", "32", "--log-every-steps", "0"]
    assert cli.main(["serve-router", *base, "--output-file", str(out), "--replicas", "2",
                     "--paged-kv", "--chaos", "replica_crash@3"]) == 0
    recs = [json.loads(x) for x in out.read_text().splitlines()]
    assert len(recs) == 6 and all("shed" not in r for r in recs)
    with pytest.raises(SystemExit):
        cli.main(["serve-router", *base, "--replicas", "0"])
    with pytest.raises(SystemExit):
        cli.main(["serve-router", *base, "--chaos", "replica_crash@x"])


def test_product_jsonl_writer_survives_kill9(tmp_path):
    """A process killed mid-stream leaves only whole lines: each record of
    20 KB went out in one write."""
    out = tmp_path / "serve-out.jsonl"
    script = textwrap.dedent(f"""
        import os, signal
        from distributed_llms_example_tpu_torch.obs.sink import ProductJsonlWriter

        w = ProductJsonlWriter({str(out)!r})
        for i in range(200):
            w.write({{"prompt": "p" * 64, "output": "o" * 20000, "tokens": i}})
        os.kill(os.getpid(), signal.SIGKILL)
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", script], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == -signal.SIGKILL, proc.stderr[-2000:]
    lines = out.read_text().splitlines()
    assert len(lines) == 200
    for i, line in enumerate(lines):
        rec = json.loads(line)
        assert rec["tokens"] == i and len(rec["output"]) == 20000
