"""The port's memory attribution (``obs/memprof.py``) on the CPU against the
JAX package's: the watermark's mark/delta readings over one fake stats
sequence; ``is_resource_exhausted`` on the JAX package's cases and on
torch's out-of-memory error; the serving account; the postmortem bundle
(its fields, atomic, an I/O failure reported and never raised); the state
account's additivity and fit verdict; the monitor's one named skip where
nothing reports; and ``--chaos oom@2`` on a tiny CPU run, which writes the
bundle (the memory account attached) and re-raises; a serving session's
tripwire (``--postmortem-dir``): an out-of-memory error injected into a
decode round writes the bundle atomically, with the engine's own account,
and re-raises, while another error writes nothing, as the JAX engine's."""

import json
import os

import numpy as np
import pytest
import torch

from distributed_llms_example_tpu.obs import memprof as jax_memprof
from distributed_llms_example_tpu.obs import sink as jax_sink
from distributed_llms_example_tpu_torch.obs import memprof, sink


@pytest.fixture(autouse=True)
def _stdout_sinks():
    jax_sink.install_sink(jax_sink.build_sink("stdout", ""))
    sink.install_sink(sink.build_sink("stdout", ""))
    yield
    jax_sink.install_sink(jax_sink.build_sink("stdout", ""))
    sink.install_sink(sink.build_sink("stdout", ""))


def _stats_sequence(seed: int) -> list[list[dict]]:
    rng = np.random.RandomState(seed)
    peak, seq = 0, []
    for _ in range(12):
        use = int(rng.randint(1 << 20, 1 << 30))
        peak = max(peak, use + int(rng.randint(0, 1 << 28)) * int(rng.rand() < 0.5))
        seq.append([{"device": 0, "bytes_in_use": use, "peak_bytes_in_use": peak,
                     "bytes_limit": 80 << 30, "reserved_bytes": peak}])
    return seq


@pytest.mark.parametrize("seed", range(3))
def test_watermark_deltas_match_jax(seed, monkeypatch):
    seq = _stats_sequence(seed)
    feed = {"ours": iter(seq * 4), "theirs": iter(seq * 4)}
    monkeypatch.setattr(memprof, "hbm_stats", lambda device=None: next(feed["ours"]))
    monkeypatch.setattr(jax_memprof, "hbm_stats", lambda: [
        {k: v for k, v in s.items() if k != "reserved_bytes"} for s in next(feed["theirs"])])
    ours, theirs = memprof.Watermark(), jax_memprof.Watermark()
    for i in range(len(seq)):
        if i % 3 == 0:
            ours.mark()
            theirs.mark()
            continue
        got, want = ours.read(), theirs.read()
        assert {k: got[k] for k in want} == want
        assert got["reserved_bytes"] == got["peak_bytes_in_use"]


@pytest.mark.parametrize("err", [
    MemoryError(), RuntimeError("RESOURCE_EXHAUSTED: Out of memory while trying to allocate"),
    ValueError("resource exhausted on device"), RuntimeError("allocation failure: 12 GiB"),
    RuntimeError("CUDA out of memory. Tried to allocate 2.00 GiB"),
    RuntimeError("RESOURCE_EXHAUSTED: chaos-injected out of memory before step 3"),
    ValueError("shape mismatch"), KeyError("out"), OSError(28, "No space left on device")])
def test_is_resource_exhausted_matches_jax(err):
    assert memprof.is_resource_exhausted(err) == jax_memprof.is_resource_exhausted(err)


def test_torch_out_of_memory_is_resource_exhausted():
    assert memprof.is_resource_exhausted(torch.cuda.OutOfMemoryError("no message"))
    assert not memprof.is_resource_exhausted(RuntimeError("an ordinary failure"))


@pytest.mark.parametrize("budget", [0.5, 16.0, 80.0])
def test_serving_account_matches_jax(budget):
    kw = dict(params_bytes=13_476_839_424, kv_cache_bytes=2_147_483_648, hbm_budget_gib=budget)
    assert memprof.serving_account(**kw) == jax_memprof.serving_account(**kw)
    from distributed_llms_example_tpu_torch.serving import engine

    assert engine.serving_account is memprof.serving_account


def test_postmortem_bundle_matches_jax_and_is_atomic(tmp_path, capsys):
    history = [{"step": s, "bytes_in_use": 10 * s, "peak_bytes_in_use": 20 * s,
                "watermark_delta_bytes": s} for s in (1, 2)]
    account = {"buckets_bytes": {b: 1 for b in memprof.BUCKETS}, "peak_bytes": 6}
    kw = dict(reason="RuntimeError: CUDA out of memory", step=3, account=account,
              watermark_history=history)
    ours = memprof.dump_postmortem(str(tmp_path / "p"), **kw)
    theirs = jax_memprof.dump_postmortem(str(tmp_path / "j"), **kw)
    got, want = (json.load(open(x)) for x in (ours, theirs))
    want.pop("live_buffers_top", None)
    assert got == want and got["final_reading"] is None
    assert os.listdir(os.path.dirname(ours)) == ["memory-postmortem-p000.json"]
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert [x["event"] for x in lines] == ["memory_postmortem"] * 2
    # an output dir that cannot hold obs/: reported, never raised
    (tmp_path / "file").write_text("x")
    assert memprof.dump_postmortem(str(tmp_path / "file"), **kw) is None
    assert json.loads(capsys.readouterr().out)["event"] == "memory_postmortem_failed"


def test_monitor_skips_once_and_dumps_only_for_oom(tmp_path, capsys):
    mon = memprof.MemoryMonitor(torch.device("cpu"))
    assert [mon.sample(s) for s in (1, 2, 3)] == [None] * 3
    (skip,) = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert skip["event"] == "memory_window_skipped" and skip["step"] == 1
    assert mon.maybe_dump_postmortem(str(tmp_path), step=1, error=ValueError("x")) is None
    assert mon.maybe_dump_postmortem(str(tmp_path), step=1,
                                     error=torch.cuda.OutOfMemoryError("y")) is not None


def test_state_account_is_additive_with_a_fit_verdict():
    named = [("blocks.0.self_attn.q.kernel", torch.zeros(64, 32)),
             ("embed_tokens.embedding", torch.zeros(100, 32)), ("final_norm.scale", torch.zeros(32))]
    opt = [torch.zeros_like(p) for _, p in named] * 2
    grads = [torch.zeros_like(p) for _, p in named]
    params = sum(p.numel() * 4 for _, p in named)
    acct = memprof.state_memory_account(named, opt, grads, before_step_bytes=3 * params + 1000,
                                        step_peak_bytes=10 * params, hbm_budget_gib=1e-4)
    b = acct["buckets_bytes"]
    assert (b["params"], b["optimizer_state"], b["grad_accum"], b["other"]) == \
        (params, 2 * params, params, 1000)
    assert b["activations"] == 10 * params - (3 * params + 1000) - params
    assert sum(b.values()) == acct["peak_bytes"] and acct["additivity_gap_bytes"] == 0
    assert not acct["fits_budget"] and acct["peak_frac_of_budget"] > 1
    assert [r["name"] for r in acct["largest_buffers"]][:2] == [
        "embed_tokens.embedding", "blocks.0.self_attn.q.kernel"]
    assert acct["largest_buffers"][0]["module"] == "embed"
    assert acct["measured"]["step_set_peak"]
    below = memprof.state_memory_account(named, opt, grads, before_step_bytes=3 * params,
                                         step_peak_bytes=10 * params, step_set_peak=False,
                                         hbm_budget_gib=80.0)
    assert below["measured"]["step_set_peak"] is False
    static = memprof.state_memory_account(named, opt, grads, hbm_budget_gib=80.0)
    assert static["measured"] is None and static["peak_bytes"] == 4 * params


def test_chaos_oom_writes_the_bundle_and_reraises(tmp_path, capsys):
    from distributed_llms_example_tpu_torch.launch.cli import train

    path = tmp_path / "train.json"
    rng = np.random.RandomState(0)
    path.write_text(json.dumps([{"dialogue": " ".join(f"w{rng.randint(40)}" for _ in range(12)),
                                 "summary": f"w{rng.randint(40)}"} for _ in range(12)]))
    out = tmp_path / "out"
    with pytest.raises(RuntimeError, match="RESOURCE_EXHAUSTED"):
        train(["--device", "cpu", "--model-ckpt", "bart-test", "--tokenizer", "byte",
               "--train-file", str(path), "--output-dir", str(out), "--batch-size", "4",
               "--max-source-length", "32", "--max-target-length", "16",
               "--pad-to-multiple", "32", "--log-every-steps", "1", "--evaluation-steps", "0",
               "--obs", "jsonl", "--chaos", "oom@2"])
    bundle = json.load(open(out / "obs" / "memory-postmortem-p000.json"))
    assert bundle["step"] == 1 and "chaos-injected" in bundle["reason"]
    assert bundle["account"]["buckets_bytes"]["params"] > 0
    events = [json.loads(x).get("event") for x in open(out / "obs" / "metrics-p000.jsonl")]
    assert events.count("memory_postmortem") == 1 and events.count("memory_account") == 1
    capsys.readouterr()


@pytest.mark.parametrize("paged", [False, True], ids=["flat", "paged"])
def test_serving_oom_tripwire_writes_the_bundle_and_reraises(tmp_path, paged, capsys):
    from distributed_llms_example_tpu_torch.models.registry import load_model
    from distributed_llms_example_tpu_torch.serving.engine import ServeConfig, ServingEngine

    tlm = load_model("llama-test", device="cpu")
    kw = dict(max_slots=2, max_new_tokens=8, max_source_length=16, request_spans=False,
              paged_kv=paged, kv_block_size=8 if paged else 0)
    out = tmp_path / "pm"
    eng = ServingEngine(tlm.module, tlm.config, ServeConfig(postmortem_dir=str(out), **kw),
                        is_seq2seq=False, device="cpu")
    sess = eng.open()
    for n in (5, 9, 3):
        sess.submit(list(range(4, 4 + n)))
    sess.step()
    calls = {"n": 0}
    real = eng._step_causal

    def oom_on_second(*a, **k):
        calls["n"] += 1
        if calls["n"] == 2:
            raise RuntimeError("RESOURCE_EXHAUSTED: CUDA out of memory (injected)")
        return real(*a, **k)

    eng._step_causal = oom_on_second
    sess.step()
    with pytest.raises(RuntimeError, match="RESOURCE_EXHAUSTED"):
        sess.step()
    path = out / "obs" / "memory-postmortem-p000.json"
    assert os.path.exists(path) and not os.path.exists(str(path) + ".tmp")
    bundle = json.load(open(path))
    assert bundle["event"] == "memory_postmortem" and "RESOURCE_EXHAUSTED" in bundle["reason"]
    assert bundle["step"] == sess.stats.decode_steps == 2
    acct = bundle["account"]
    assert acct == sess._memory_account()
    assert acct["buckets_bytes"]["kv_cache"] == sess._bytes_in_use() > 0
    assert set(acct) == set(jax_memprof.serving_account(
        params_bytes=1, kv_cache_bytes=1, hbm_budget_gib=80.0))
    # another error re-raises and writes no bundle
    other = tmp_path / "other"
    eng2 = ServingEngine(tlm.module, tlm.config, ServeConfig(postmortem_dir=str(other), **kw),
                         is_seq2seq=False, device="cpu")
    eng2._step_causal = lambda *a, **k: (_ for _ in ()).throw(ValueError("not an oom"))
    sess2 = eng2.open()
    sess2.submit([4, 5, 6])
    with pytest.raises(ValueError, match="not an oom"):
        sess2.step()
    assert not os.path.exists(other)
    capsys.readouterr()
