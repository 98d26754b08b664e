"""The port's telemetry layers on the CPU, against the JAX package's: the
sink (the stdout line byte for byte, the JSONL file's stamped lines, the
process gate of ``local`` records, ``log_json`` through the installed
sink); the span recorder and the step-time budget driven by one fake
clock through the same span sequences (additivity, nested spans,
``mark_step_start``, the off-cadence tripwire and its warmup window, the
``--obs off --obs-budget on`` window reset), every ``step_budget`` field
and every window summary equal; ``aggregate_accounts``; the ``--health``
and ``--obs-budget`` tri-states over every ``--obs`` mode;
``detect_laggards`` and ``LaggardStreaks`` over seeded arrivals; the
telemetry's device syncs (``sync_device.syncs``) only at the log cadence,
in ``TrainerObs`` and in a training run.  The gauges (``obs/gauges.py``):
``mfu`` and ``training_flops_estimate`` equal the JAX package's; the meta
FLOP count equals a hand count of a 1-layer LLaMA's matmuls and a real CPU
train step's FlopCounterMode count at 1 and 4 microbatches, and leaves
remat's recompute out; the collective
byte account equals what a counting wrapper around torch.distributed sees
each step carry on two gloo ranks (``data=2``, ``fsdp=2``, and ``fsdp=2``
over 2 microbatches).  A 3-step CPU run with the profiler window 2:2 emits
the slice's events; the new flags' defaults are the JAX package's but for
the card's peak and memory."""

import dataclasses
import json

import numpy as np
import pytest
import torch

from distributed_llms_example_tpu.core.config import TrainConfig as JaxTrainConfig
from distributed_llms_example_tpu.obs import sink as jax_sink
from distributed_llms_example_tpu.obs.budget import BudgetAccountant as JaxBudget
from distributed_llms_example_tpu.obs.budget import aggregate_accounts as jax_aggregate
from distributed_llms_example_tpu.obs.budget import budget_enabled as jax_budget_enabled
from distributed_llms_example_tpu.obs.health import LaggardStreaks as JaxStreaks
from distributed_llms_example_tpu.obs.health import health_enabled as jax_health_enabled
from distributed_llms_example_tpu.obs.heartbeat import detect_laggards as jax_detect
from distributed_llms_example_tpu.obs.spans import SpanRecorder as JaxSpans
from distributed_llms_example_tpu.obs.spans import percentiles as jax_percentiles
from distributed_llms_example_tpu_torch.core.config import TrainConfig
from distributed_llms_example_tpu_torch.launch.cli import train
from distributed_llms_example_tpu_torch.obs import TrainerObs
from distributed_llms_example_tpu_torch.obs import sink
from distributed_llms_example_tpu_torch.obs.budget import (
    COMPONENTS,
    BudgetAccountant,
    aggregate_accounts,
    budget_enabled,
    sync_device,
)
from distributed_llms_example_tpu_torch.obs.health import LaggardStreaks, health_enabled
from distributed_llms_example_tpu_torch.obs.heartbeat import Heartbeat, detect_laggards
from distributed_llms_example_tpu_torch.obs.spans import SpanRecorder, percentiles
from distributed_llms_example_tpu_torch.utils.jsonlog import MetricLogger, log_json


@pytest.fixture(autouse=True)
def _stdout_sinks():
    jax_sink.install_sink(jax_sink.build_sink("stdout", ""))
    sink.install_sink(sink.build_sink("stdout", ""))
    yield
    jax_sink.install_sink(jax_sink.build_sink("stdout", ""))
    sink.install_sink(sink.build_sink("stdout", ""))


# ---------------------------------------------------------------------------
# the sink
# ---------------------------------------------------------------------------

RECORDS = [{"step": 3, "loss": 1.25, "learning_rate": 5e-5},
           {"event": "heartbeat", "step": 4, "laggards": [1], "skew_steps": 0},
           {"event": "x", "text": "ünïcode → ok", "nested": {"a": [1, 2.5, None]}}]


def test_stdout_line_is_the_jax_sinks(capsys):
    for rec in RECORDS:
        jax_sink.StdoutSink().emit(rec)
        want = capsys.readouterr().out
        sink.StdoutSink().emit(rec)
        assert capsys.readouterr().out == want == json.dumps(rec) + "\n"


def test_jsonl_file_is_the_jax_sinks(tmp_path):
    ours, theirs = sink.JsonlFileSink(str(tmp_path / "p" / "m.jsonl")), \
        jax_sink.JsonlFileSink(str(tmp_path / "j" / "m.jsonl"))
    for rec in RECORDS:
        ours.emit(rec)
        theirs.emit(rec)
    ours.close()
    theirs.close()
    got = (tmp_path / "p" / "m.jsonl").read_bytes()
    assert got == (tmp_path / "j" / "m.jsonl").read_bytes()
    assert [json.loads(x)["schema_version"] for x in got.decode().splitlines()] == [1, 1, 1]


@pytest.mark.parametrize("rank", [0, 1])
def test_process_gate_is_the_jax_sinks(monkeypatch, rank):
    """``local`` records reach every rank's file and only process 0's
    stdout; ``all_processes`` both everywhere."""
    monkeypatch.setattr(sink, "_process_index", lambda: rank)
    monkeypatch.setattr(jax_sink, "_process_index", lambda: rank)
    for all_processes in (False, True):
        for local in (False, True):
            kw = dict(all_processes=all_processes, local=local)
            assert sink.StdoutSink().wants(**kw) == jax_sink.StdoutSink().wants(**kw)
            assert sink.JsonlFileSink("f").wants(**kw) == jax_sink.JsonlFileSink("f").wants(**kw)
    monkeypatch.setattr(sink, "_process_index", lambda: 0)
    monkeypatch.setattr(jax_sink, "_process_index", lambda: 0)
    assert sink.build_sink("jsonl", "out").sinks[1].path \
        == jax_sink.build_sink("jsonl", "out").sinks[1].path == "out/obs/metrics-p000.jsonl"
    assert sink.build_sink("stdout", "out") is sink.build_sink("off", "out") is sink.current_sink()


def test_log_json_and_metric_logger_reach_the_file(tmp_path, capsys):
    """Every existing line goes through the installed sink: stdout as
    before, and the same record, stamped, in the file."""
    sink.install_sink(sink.build_sink("jsonl", str(tmp_path)))
    log_json({"event": "a", "value": torch.tensor(0.5), "n": np.int64(3)})
    log_json({"event": "b"}, local=True)
    logger = MetricLogger(every=2)
    logger.step(1, torch.tensor(2.0))
    logger.step(2, torch.tensor(1.0), lr=torch.tensor(1e-3), tokens=10)
    sink.flush(fsync=True)
    out = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    lines = [json.loads(x) for x in open(tmp_path / "obs" / "metrics-p000.jsonl")]
    assert [{k: v for k, v in x.items() if k != "schema_version"} for x in lines] == out
    assert out[0] == {"event": "a", "value": 0.5, "n": 3} and out[1] == {"event": "b"}
    assert out[2]["step"] == 2 and out[2]["loss"] == 1.0
    assert {x["schema_version"] for x in lines} == {1}


# ---------------------------------------------------------------------------
# spans and the budget on one fake clock
# ---------------------------------------------------------------------------

class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


def _step(rec, clock, *, data_wait=0.0, host=0.0, dispatch=0.0, nested=0.0, busy=0.0,
          sync=0.0, untracked=0.0):
    for name, dt in (("data_wait", data_wait), ("host_overhead", host)):
        if dt:
            with rec.span(name):
                clock.advance(dt)
    if dispatch:
        with rec.span("step_dispatch"):
            if nested:
                with rec.span("data_wait"):  # nested: the window aggregate only
                    clock.advance(nested)
            clock.advance(dispatch)
    for name, dt in (("device_busy", busy), ("device_sync", sync)):
        if dt:
            with rec.span(name):
                clock.advance(dt)
    clock.advance(untracked)
    rec.step_complete()


def _scenario(name, spans_cls, budget_cls, seed=0):
    """The outputs (accounts, summaries) of one span sequence through one
    framework's recorder and budget."""
    clock = FakeClock()
    rec = spans_cls(clock=clock)
    out = []

    def close(bud, step):
        out.append(bud.close_window(step=step, epoch=0, emit=False))
        out.append(rec.summary())

    if name == "additivity":
        bud = budget_cls(rec)
        for _ in range(2):
            _step(rec, clock, data_wait=0.02, host=0.01, dispatch=0.005, untracked=0.065)
        _step(rec, clock, data_wait=0.02, host=0.01, dispatch=0.005, busy=0.05, sync=0.01,
              untracked=0.005)
        close(bud, 3)
        out.append(bud.close_window(step=3, emit=False))  # consumed: None
    elif name == "nested":
        bud = budget_cls(rec)
        _step(rec, clock, dispatch=0.1, nested=0.1)
        close(bud, 1)
    elif name == "mark_step_start":
        bud = budget_cls(rec)
        _step(rec, clock, dispatch=0.1)
        with rec.span("checkpoint"):
            clock.advance(5.0)
        rec.mark_step_start()
        _step(rec, clock, dispatch=0.1)
        close(bud, 2)
    elif name == "tripwire":
        bud = budget_cls(rec, warmup_windows=0)
        for _ in range(3):
            _step(rec, clock, dispatch=0.002, untracked=0.002)
        _step(rec, clock, dispatch=0.002, busy=0.27, sync=0.01)
        close(bud, 4)
        for _ in range(3):
            _step(rec, clock, dispatch=0.07, untracked=0.001)
        _step(rec, clock, dispatch=0.07, sync=0.001)
        close(bud, 8)
    elif name == "warmup":
        bud = budget_cls(rec)
        _step(rec, clock, dispatch=15.0)
        _step(rec, clock, dispatch=0.002, busy=0.1)
        close(bud, 2)
        _step(rec, clock, dispatch=0.08, untracked=0.001)
        _step(rec, clock, dispatch=0.002, sync=0.001)
        close(bud, 4)
    else:  # seeded windows of random steps, checkpoint/eval between some
        rng = np.random.RandomState(seed)
        bud = budget_cls(rec, async_dispatch=bool(seed % 2), warmup_windows=seed % 3)
        step = 0
        for _ in range(5):
            for _ in range(rng.randint(1, 6)):
                blocked = rng.rand() < 0.3
                _step(rec, clock, data_wait=rng.choice([0.0, rng.rand() * 0.01]),
                      host=rng.choice([0.0, rng.rand() * 0.003]),
                      dispatch=rng.rand() * (0.2 if blocked else 0.004),
                      nested=rng.choice([0.0, rng.rand() * 0.001]),
                      busy=rng.rand() * 0.05, sync=rng.rand() * 0.002,
                      untracked=rng.rand() * 0.01)
                step += 1
                if rng.rand() < 0.3:
                    with rec.span(rng.choice(["checkpoint", "eval"])):
                        clock.advance(rng.rand())
                    rec.mark_step_start()
            close(bud, step)
    return out


SCENARIOS = ["additivity", "nested", "mark_step_start", "tripwire", "warmup",
             *[f"seeded{s}" for s in range(6)]]


@pytest.mark.parametrize("name", SCENARIOS)
def test_budget_accounts_match_jax_on_a_fake_clock(name):
    seed = int(name[6:]) if name.startswith("seeded") else 0
    got = _scenario(name, SpanRecorder, BudgetAccountant, seed)
    want = _scenario(name, JaxSpans, JaxBudget, seed)
    assert got == want
    accounts = [x for x in got if isinstance(x, dict) and x.get("event") == "step_budget"]
    assert accounts
    for acct in accounts:  # named components plus the remainder: the wall
        assert sum(acct[f"{c}_ms"] for c in COMPONENTS) == pytest.approx(acct["wall_ms"],
                                                                          abs=1e-2)
    if name == "nested":
        assert accounts[0]["dispatch_ms"] == pytest.approx(200.0)
        assert accounts[0]["data_wait_ms"] == 0.0
        assert got[1]["spans"]["data_wait"]["total_ms"] == pytest.approx(100.0)
    if name == "mark_step_start":
        assert accounts[0]["wall_ms"] == pytest.approx(200.0)
        assert accounts[0]["host_overhead_ms"] == 0.0
    if name == "tripwire":
        assert [a["offcadence_sync_steps"] for a in accounts] == [0, 3]
        assert [a["offcadence_sync_suspect"] for a in accounts] == [False, True]
    if name == "warmup":
        assert accounts[0]["warmup"] is True and not accounts[0]["offcadence_sync_suspect"]
        assert "warmup" not in accounts[1] and accounts[1]["offcadence_sync_suspect"]


@pytest.mark.parametrize("seed", range(3))
def test_aggregate_and_percentiles_match_jax(seed):
    rng = np.random.RandomState(seed)
    accounts = []
    for i in range(rng.randint(1, 6)):
        wall = float(rng.rand() * 500 + 1)
        accounts.append({"wall_ms": round(wall, 3), "window_steps": int(rng.randint(1, 9)),
                         "dispatch_efficiency": round(float(rng.rand()), 4),
                         "offcadence_sync_steps": int(rng.randint(0, 3)),
                         **{f"{c}_ms": round(float(rng.rand() * wall / 6), 3)
                            for c in COMPONENTS}})
    assert aggregate_accounts(accounts) == jax_aggregate(accounts)
    assert aggregate_accounts([]) is jax_aggregate([]) is None
    values = list(rng.rand(rng.randint(0, 30)))
    qs = (0.0, 0.5, 0.95, 1.0)
    assert percentiles(values, qs) == jax_percentiles(values, qs)


def _accounts(capsys) -> list[dict]:
    """The ``step_budget`` lines printed since the last read."""
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines() if x.startswith("{")]
    return [x for x in lines if x.get("event") == "step_budget"]


def test_obs_off_budget_on_consumes_each_window(tmp_path, capsys):
    """``--obs off --obs-budget on``: no obs_window resets the span window,
    so the cadence consumes it (each account counts its own steps)."""
    cfg = TrainConfig(output_dir=str(tmp_path), obs="off", obs_budget="on",
                      log_every_steps=2, health="off")
    obs = TrainerObs(cfg, torch.device("cpu"))
    assert obs.budget is not None and not obs.enabled and obs.recorder is None
    for step in range(1, 7):
        with obs.step_span():
            pass
        obs.on_step(step, 0, {})
    assert [a["window_steps"] for a in _accounts(capsys)] == [2, 2, 2]


# ---------------------------------------------------------------------------
# the tri-states
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("obs", ["off", "stdout", "jsonl"])
def test_health_and_budget_tristates_match_jax(obs):
    for mode in ("auto", "on", "off"):
        assert health_enabled(TrainConfig(health=mode, obs=obs)) \
            == jax_health_enabled(JaxTrainConfig(health=mode, obs=obs))
        assert budget_enabled(TrainConfig(obs_budget=mode, obs=obs)) \
            == jax_budget_enabled(JaxTrainConfig(obs_budget=mode, obs=obs))
    # --health auto is on exactly under --obs jsonl
    assert health_enabled(TrainConfig(obs=obs)) == (obs == "jsonl")


def test_obs_config_defaults_are_the_jax_packages():
    got, want = TrainConfig(), JaxTrainConfig()
    for k in ("obs", "obs_heartbeat_steps", "obs_heartbeat_suspect_beats", "obs_budget",
              "on_host_loss", "health"):
        assert getattr(got, k) == getattr(want, k), k


# ---------------------------------------------------------------------------
# heartbeat analysis
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(4))
def test_detect_laggards_matches_jax(seed):
    rng = np.random.RandomState(seed)
    for _ in range(20):
        p = int(rng.randint(1, 9))
        steps = rng.randint(100, 103, size=p)
        arrivals = 1.7e9 + rng.rand(p) * rng.choice([0.5, 12.0])
        threshold = float(rng.choice([0.1, 1.0, 5.0]))
        assert detect_laggards(steps, arrivals, laggard_threshold_s=threshold) \
            == jax_detect(steps, arrivals, laggard_threshold_s=threshold)


@pytest.mark.parametrize("beats", [1, 2, 3, 4])
def test_laggard_streaks_match_jax(beats):
    rng = np.random.RandomState(beats)
    ours, theirs = LaggardStreaks(suspect_beats=beats), JaxStreaks(suspect_beats=beats)
    fired = []
    for step in range(1, 60):
        lag = sorted(int(r) for r in np.flatnonzero(rng.rand(4) < 0.6))
        got = ours.update(lag, step)
        assert got == theirs.update(lag, step)
        fired += got
    assert fired and {e["event"] for e in fired} == {"host_loss_suspect"}
    assert all(e["consecutive_beats"] == beats for e in fired)


def test_heartbeat_in_one_process(capsys):
    record = Heartbeat(1).beat(7)
    assert record["process_count"] == 1 and record["skew_steps"] == 0
    assert record["min_step"] == record["max_step"] == 7 and record["laggards"] == []
    assert json.loads(capsys.readouterr().out) == record


# ---------------------------------------------------------------------------
# the telemetry's device syncs: at the log cadence only
# ---------------------------------------------------------------------------

def test_budget_probe_syncs_only_at_the_cadence(tmp_path, capsys):
    cfg = TrainConfig(output_dir=str(tmp_path), obs="jsonl", log_every_steps=4, health="off")
    obs = TrainerObs(cfg, torch.device("cpu"))
    loss = torch.tensor(1.0)
    before = sync_device.syncs
    for step in range(1, 9):
        with obs.step_span():
            pass
        obs.budget_probe(step, loss)
        obs.on_step(step, 0, {"loss": loss})
        assert sync_device.syncs - before == step // 4
    assert [a["window_steps"] for a in _accounts(capsys)] == [4, 4]


def test_a_training_run_syncs_once_a_log_window(tmp_path, capsys):
    """A CPU run of 6 steps at ``--log-every-steps 2``: three cadenced
    probes, one for each ``step_budget`` line, and no other sync of the
    telemetry."""
    path = tmp_path / "train.json"
    rng = np.random.RandomState(0)
    path.write_text(json.dumps([{"dialogue": " ".join(f"w{rng.randint(40)}" for _ in range(12)),
                                 "summary": f"w{rng.randint(40)}"} for _ in range(12)]))
    before = sync_device.syncs
    train(["--device", "cpu", "--model-ckpt", "bart-test", "--tokenizer", "byte",
           "--train-file", str(path), "--output-dir", str(tmp_path / "out"), "--batch-size", "4",
           "--num-epochs", "2", "--max-source-length", "32", "--max-target-length", "16",
           "--pad-to-multiple", "32", "--log-every-steps", "2", "--evaluation-steps", "0",
           "--obs", "jsonl", "--obs-budget", "on"])
    lines = [json.loads(x) for x in open(tmp_path / "out" / "obs" / "metrics-p000.jsonl")]
    budgets = [x for x in lines if x.get("event") == "step_budget"]
    assert [b["step"] for b in budgets] == [2, 4, 6]
    assert sync_device.syncs - before == len(budgets)
    assert all(b["sync_dispatch_backend"] for b in budgets)
    # --health auto followed --obs jsonl: the windows carry the numerics
    windows = [x for x in lines if x.get("event") == "obs_window"]
    assert len(windows) == 3 and all("health" in w for w in windows)
    capsys.readouterr()


# ---------------------------------------------------------------------------
# the gauges (obs/gauges.py): FLOPs a step, MFU, the collective byte account
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(3))
def test_mfu_and_flops_estimate_match_jax(seed):
    from distributed_llms_example_tpu.obs import gauges as jax_gauges
    from distributed_llms_example_tpu_torch.obs import gauges

    rng = np.random.RandomState(seed)
    for _ in range(20):
        n, tokens = int(rng.randint(1, 1 << 33)), int(rng.randint(1, 1 << 20))
        assert gauges.training_flops_estimate(n, tokens) \
            == jax_gauges.training_flops_estimate(n, tokens)
        args = (float(rng.rand() * 1e16), float(rng.choice([0.0, rng.rand()])),
                int(rng.randint(0, 9)), float(rng.choice([989e12, 197e12])))
        assert gauges.mfu(*args) == jax_gauges.mfu(*args)


def test_flop_counter_against_a_hand_count():
    """One forward and backward of a 1-layer LLaMA at a tiny width: three
    times the forward's matmul FLOPs (each matmul's backward is two of its
    size): q, k, v, o, gate, up, down and the head, and the two attention
    products."""
    from distributed_llms_example_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    from distributed_llms_example_tpu_torch.obs.gauges import count_step_flops

    cfg = LlamaConfig(vocab_size=48, hidden_size=16, intermediate_size=24, num_hidden_layers=1,
                      num_attention_heads=2, max_position_embeddings=64)
    model = LlamaForCausalLM(cfg, device="cpu")
    B, S, h, i, V, H, d = 3, 10, 16, 24, 48, 2, 8
    tokens = B * S
    forward = (2 * tokens * h * h * 4 + 2 * tokens * h * i * 3 + 2 * tokens * h * V
               + 2 * (2 * B * H * S * S * d))
    assert count_step_flops(model, global_batch=B, src_len=S, tgt_len=S,
                            is_seq2seq=False) == 3 * forward


def test_the_flop_gauge_counts_model_flops_not_remat():
    """A model trained under remat or the vocab-chunked loss gives the
    gauge the FLOPs of the same model without them (model FLOPs: the
    recompute is left out), and the ``obs_gauges`` fields say what was
    counted."""
    from distributed_llms_example_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    from distributed_llms_example_tpu_torch.obs.gauges import (
        FLOPS_COUNTED,
        count_step_flops,
        train_step_static_gauges,
    )

    cfg = LlamaConfig(vocab_size=48, hidden_size=16, intermediate_size=24, num_hidden_layers=2,
                      num_attention_heads=2, max_position_embeddings=64)
    fused = dataclasses.replace(cfg, fused_ce=True)
    counts = [count_step_flops(LlamaForCausalLM(c, device="cpu", remat_policy=rp),
                               global_batch=2, src_len=12, tgt_len=12, is_seq2seq=False)
              for c in (cfg, fused) for rp in (None, "full", "dots")]
    assert len(set(counts)) == 1 and counts[0] > 0
    gauge = train_step_static_gauges(LlamaForCausalLM(fused, device="cpu", remat_policy="full"),
                                     model_name="t", data=1, fsdp=1, global_batch=2, src_len=12,
                                     tgt_len=12, is_seq2seq=False)
    assert (gauge["flops_per_step"], gauge["flops_counted"]) == (counts[0], FLOPS_COUNTED)


def test_flops_do_not_change_with_grad_accumulation():
    """The gauge equals the FLOPs FlopCounterMode counts over a real CPU
    train step of the same global batch, at 1 and at 4 microbatches."""
    from torch.utils.flop_counter import FlopCounterMode

    from distributed_llms_example_tpu_torch.models.registry import load_model
    from distributed_llms_example_tpu_torch.obs.gauges import train_step_static_gauges
    from distributed_llms_example_tpu_torch.train.optim import (
        AdamWState,
        OptimizerSpec,
        linear_schedule_with_warmup,
    )
    from distributed_llms_example_tpu_torch.train.step import train_step

    lm = load_model("bart-test", device="cpu", train=True)
    named = list(lm.module.named_parameters())
    rng = np.random.RandomState(0)
    ids = torch.from_numpy(rng.randint(3, 200, (8, 32)))
    batch = {"input_ids": ids, "attention_mask": torch.ones_like(ids),
             "labels": torch.from_numpy(rng.randint(3, 200, (8, 16)))}
    spec = OptimizerSpec(learning_rate=1e-3, weight_decay=0.0, warmup_steps=0, total_steps=2,
                         max_grad_norm=1.0)
    counted = []
    for n in (1, 4):
        state = AdamWState.zeros([p.detach() for _, p in named])
        with FlopCounterMode(display=False) as fc:
            train_step(lm.module, named, state, spec, linear_schedule_with_warmup(1e-3, 0, 2),
                       batch, grad_accum_steps=n, generator=torch.Generator().manual_seed(0))
        gauge = train_step_static_gauges(lm.module, model_name="bart-test", data=1, fsdp=1,
                                         global_batch=8, src_len=32, tgt_len=16,
                                         is_seq2seq=True, grad_accum_steps=n)
        assert gauge["grad_accum_steps"] == n and gauge["flops_source"] == "flop_counter"
        counted.append((fc.get_total_flops(), gauge["flops_per_step"]))
    assert counted[0] == counted[1] and counted[0][0] == counted[0][1] > 0


@pytest.mark.parametrize("layout,extra", [("data=2", []), ("fsdp=2", []),
                                          ("fsdp=2", ["--grad-accum-steps", "2"])])
def test_comm_account_is_what_the_collectives_carry(tmp_path, layout, extra):
    """Two gloo ranks of the CLI: every step's collectives, counted by a
    wrapper around torch.distributed (calls and the bytes of the tensor each
    defines), equal the startup gauges' byte account."""
    from torch_dist_helpers import cli_argv, records, spawn

    path = tmp_path / "train.json"
    path.write_text(json.dumps(records(16)))
    argv = cli_argv("llama-test", path, tmp_path / "out", "--mesh", layout, "--obs-gauges", "on",
                    *extra, num_epochs=1)
    _, _, result = spawn({"argv": argv, "count_collectives": True}, 2, tmp_path)
    comm = result["comm"]
    want = {op: [slot["count"], slot["gradient_bytes"] + slot["activation_bytes"]]
            for op, slot in comm.items() if isinstance(slot, dict)}
    assert len(result["collectives"]) == 2
    assert all(step == want for step in result["collectives"]), (result["collectives"], want)
    grads = sum(s["gradient_bytes"] for s in comm.values() if isinstance(s, dict))
    assert comm["gradient_bytes"] == grads > 0 and comm["activation_bytes"] > 0


def test_a_profiled_cpu_run_emits_the_slices_events(tmp_path, capsys):
    """Three CPU steps under ``--obs jsonl --obs-gauges on --profile-steps
    2:2``: the gauges, one capture of [2, 2] and its device account, one
    memory_window_skipped (the CPU reports no memory), the memory account,
    ``optimizer_apply_ms`` from the second window on, and a window MFU."""
    path = tmp_path / "train.json"
    rng = np.random.RandomState(1)
    path.write_text(json.dumps([{"dialogue": " ".join(f"w{rng.randint(40)}" for _ in range(12)),
                                 "summary": f"w{rng.randint(40)}"} for _ in range(12)]))
    out = tmp_path / "out"
    train(["--device", "cpu", "--model-ckpt", "llama-test", "--tokenizer", "byte",
           "--train-file", str(path), "--output-dir", str(out), "--batch-size", "4",
           "--max-source-length", "32", "--max-target-length", "16", "--pad-to-multiple", "32",
           "--log-every-steps", "1", "--evaluation-steps", "0", "--obs", "jsonl",
           "--obs-gauges", "on", "--profile-steps", "2:2"])
    lines = [json.loads(x) for x in open(out / "obs" / "metrics-p000.jsonl")]

    def named(kind):
        return [x for x in lines if x.get("event") == kind]

    (gauges,) = named("obs_gauges")
    assert gauges["flops_source"] == "flop_counter" and gauges["flops_per_step"] > 0
    assert [c["window"] for c in named("profile_captured")] == [[2, 2]]
    (acct,) = named("device_account")
    assert acct["window"] == [2, 2] and acct["buckets_ms"]["attn"] > 0 and acct["lanes"]
    assert len(named("memory_window_skipped")) == 1 and len(named("memory_account")) == 1
    budgets = named("step_budget")
    assert [("optimizer_apply_ms" in b) for b in budgets] == [False, True, True]
    assert all(w["mfu"] > 0 for w in named("obs_window"))
    assert named("trace_spans")
    # --lint (default warn) says once that there is nothing to lint
    assert capsys.readouterr().out.count('"event": "lint_skipped"') == 1


def test_the_new_obs_defaults_are_the_jax_packages_but_the_cards():
    got, want = TrainConfig(), JaxTrainConfig()
    for k in ("obs_gauges", "profile_dir", "profile_steps", "profile_trigger",
              "profile_on_anomaly"):
        assert getattr(got, k) == getattr(want, k), k
    # an H100's figures where the JAX package has a TPU v5e's
    assert (got.obs_peak_tflops, got.hbm_budget_gib) == (989.0, 80.0)
    assert (want.obs_peak_tflops, want.hbm_budget_gib) == (197.0, 16.0)
