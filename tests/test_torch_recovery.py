"""The port's fault-tolerant training on the CPU, against the JAX package:
the chaos grammar accepted and refused as by JAX ``parse_chaos``
(``host_loss`` included); the same escalation decisions as
the JAX ``RecoveryController`` and the same anomalies as the JAX
``HealthWatchdog`` on the same inputs; each port parameter in the bucket
of its JAX counterpart; the health numerics of one step from fused
AdamW's sums against the JAX step's (``health=True``), at the tolerance
of ``test_torch_train_step.py``; ``BatchIterator.epoch(e, start_step=k)``
as JAX's.  End to end on ``bart-test`` / ``t5-test``: a ``sigterm``
preemption plus resume is bit-equal to an uninterrupted run (dropout 0);
a ``nan_grad`` rewind is bit-exact to a clean run that quarantines the
same batch from the start (dropout on: the replay redraws the same
masks); a ``ckpt_corrupt`` run resumes from the previous verified step,
and a directory of corrupt steps only is refused; an anomaly in the final
window degrades the rewind to a checkpoint; and the port takes the same
decisions as one JAX ``Trainer`` run of the same config."""

import json
import os
import signal

import jax
import numpy as np
import pytest
import torch

from distributed_llms_example_tpu.core.config import CheckpointConfig as JaxCheckpointConfig
from distributed_llms_example_tpu.core.config import MeshConfig
from distributed_llms_example_tpu.core.config import TrainConfig as JaxTrainConfig
from distributed_llms_example_tpu.data.batching import BatchIterator as JaxBatchIterator
from distributed_llms_example_tpu.data.dataset import SummarizationDataset as JaxDataset
from distributed_llms_example_tpu.data.tokenizer import ByteTokenizer as JaxByteTokenizer
from distributed_llms_example_tpu.models.registry import load_model as jax_load_model
from distributed_llms_example_tpu.obs import sink as jax_sink
from distributed_llms_example_tpu.obs.chaos import parse_chaos as jax_parse_chaos
from distributed_llms_example_tpu.obs.health import HealthWatchdog as JaxWatchdog
from distributed_llms_example_tpu.parallel.sharding import shard_params
from distributed_llms_example_tpu.train import optim as joptim
from distributed_llms_example_tpu.train import step as jstep
from distributed_llms_example_tpu.train.recovery import RecoveryController as JaxRecovery
from distributed_llms_example_tpu_torch.core.config import TrainConfig
from distributed_llms_example_tpu_torch.data.batching import BatchIterator
from distributed_llms_example_tpu_torch.data.dataset import SummarizationDataset
from distributed_llms_example_tpu_torch.data.tokenizer import ByteTokenizer
from distributed_llms_example_tpu_torch.io.safetensors import load_file
from distributed_llms_example_tpu_torch.launch.cli import build_train_parser, train
from distributed_llms_example_tpu_torch.models.from_jax import (
    bart_state_dict_from_jax,
    blocks_state_dict_from_jax,
    load_jax_params,
)
from distributed_llms_example_tpu_torch.models.registry import load_model
from distributed_llms_example_tpu_torch.obs import health
from distributed_llms_example_tpu_torch.obs.chaos import parse_chaos
from distributed_llms_example_tpu_torch.obs.chaos import corrupt_checkpoint
from distributed_llms_example_tpu_torch.obs.health import HealthWatchdog, to_host
from distributed_llms_example_tpu_torch.train import optim as toptim
from distributed_llms_example_tpu_torch.train.recovery import RecoveryController
from distributed_llms_example_tpu_torch.train.step import (
    HEALTH_BUCKETS,
    HEALTH_METRIC_KEYS,
    param_buckets,
    train_step,
)
from distributed_llms_example_tpu_torch.train.trainer import Trainer, put_batch

STATE_DICT = {"bart-test": bart_state_dict_from_jax, "t5-test": blocks_state_dict_from_jax}


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """The models here are tiny and the suite runs in parallel workers: one
    intra-op thread each, not one per core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _jax_stdout_sink():
    jax_sink.install_sink(jax_sink.build_sink("stdout", ""))
    yield
    jax_sink.install_sink(jax_sink.build_sink("stdout", ""))


def _lines(capsys):
    return [json.loads(x) for x in capsys.readouterr().out.splitlines() if x.startswith("{")]


def _events(lines, name):
    return [x for x in lines if x.get("event") == name]


# ---------------------------------------------------------------------------
# chaos grammar, escalation, watchdog: the port's classes against JAX's
# ---------------------------------------------------------------------------

CHAOS_SPECS = [
    "", "   ", "nan_grad@120,ckpt_corrupt@2,data_error@300,sigterm@240", "oom@3",
    "replica_crash@40,request_storm@10,replica_stall@2", " nan_grad@1 , sigterm@2 ",
    "nan_grad", "nan_grad@", "nan_grad@0", "nan_grad@-3", "nan_grad@x", "bogus@5", "@5",
    "nan_grad@5,", "nan_grad@1.5", "host_loss@2", "sigterm@4,host_loss@9",
]


@pytest.mark.parametrize("spec", CHAOS_SPECS)
def test_chaos_grammar_matches_jax(spec, capsys):
    """Accepted and refused as by JAX (``host_loss`` armed like every
    kind), the same ticks armed per kind, and ``take`` one-shot."""
    try:
        want = jax_parse_chaos(spec)
    except ValueError:
        want = None
    if want is None:
        with pytest.raises(ValueError, match="bad --chaos entry"):
            parse_chaos(spec)
        return
    got = parse_chaos(spec)
    assert bool(got) == bool(want)
    assert [(i.kind, i.at) for i in got.injections] == [(i.kind, i.at) for i in want.injections]
    for inj in list(got.injections):
        assert got.take(inj.kind, inj.at) and not got.take(inj.kind, inj.at)
    assert [x["kind"] for x in _events(_lines(capsys), "chaos_injection")] == [
        i.kind for i in got.injections]


def _fp(epoch, epoch_step, crc=1234):
    return {"epoch": epoch, "epoch_step": epoch_step, "input_ids_crc32": crc}


@pytest.mark.parametrize("max_rewinds", [0, 1, 2])
def test_escalation_decisions_match_jax(max_rewinds, capsys):
    """The same sequence of anomalies (codes, batch positions, a missing
    fingerprint, a recurrence on a quarantined batch) through both
    controllers: the same actions, quarantine sets and replay skips."""
    seq = [("loss_spike", _fp(1, 0)), ("nonfinite", _fp(1, 1)), ("grad_explosion", _fp(2, 0)),
           ("loss_spike", None), ("nonfinite", _fp(0, 3)), ("loss_spike", _fp(1, 0)),
           ("grad_explosion", _fp(3, 1)), ("loss_spike", _fp(3, 2))]
    port, ref = RecoveryController(max_rewinds=max_rewinds), JaxRecovery(max_rewinds=max_rewinds)
    for i, (code, fp) in enumerate(seq):
        anomaly = {"step": 10 + i, "code": code}
        got = port.decide(anomaly, fingerprint=fp)
        want = ref.decide(anomaly, fingerprint=fp)
        assert (got.action, got.reason) == (want.action, want.reason), (i, code)
        if got.action != "halt" and fp is not None:
            port.quarantine(fp["epoch"], fp["epoch_step"], fp, reason=f"anomaly:{code}")
            ref.quarantine(fp["epoch"], fp["epoch_step"], fp, reason=f"anomaly:{code}")
    assert port.quarantined == ref.quarantined
    assert (port.rewinds_done, port.skips_done) == (ref.rewinds_done, ref.skips_done)
    batch = {"input_ids": np.arange(6, dtype=np.int32).reshape(2, 3)}
    for key in [(1, 0), (1, 1), (2, 0), (5, 5)]:
        assert port.should_skip(*key, batch) == ref.should_skip(*key, batch)
    port.note_save(4, rng=torch.Generator().manual_seed(3).get_state(), epoch=1, pos=2)
    assert port.snapshot_for(4)["pos"] == 2 and port.snapshot_for(5) is None


def _metric_stream(seed):
    """Per-step host metrics: a noisy decaying loss with spikes, a grad-norm
    explosion, and (for odd seeds) a NaN near the end."""
    rng = np.random.RandomState(seed)
    out = []
    for s in range(1, 61):
        loss = 3.0 * np.exp(-s / 40) + 0.02 * rng.randn()
        grad = 1.0 + 0.1 * rng.randn()
        if s in (27, 41):
            loss += 1.5
        if s == 33:
            grad *= 40
        m = {"loss": float(loss), "grad_norm": float(grad), "nonfinite_count": 0.0}
        if seed % 2 and s == 55:
            m["loss"] = float("nan")
            m["nonfinite_count"] = 12.0
        out.append((s, m))
    return out


@pytest.mark.parametrize("seed,window,warmup", [(0, 1, 20), (1, 5, 20), (2, 7, 5), (3, 10, 30)])
def test_watchdog_matches_jax(seed, window, warmup):
    stream = _metric_stream(seed)
    port = HealthWatchdog(warmup_steps=warmup)
    ref = JaxWatchdog(warmup_steps=warmup)
    got, want = [], []
    for i in range(0, len(stream), window):
        got += port.check(stream[i:i + window])
        want += ref.check(stream[i:i + window])
    assert want and len(got) == len(want)
    for a, b in zip(got, want):
        assert (a.step, a.code, a.detail) == (b.step, b.code, b.detail)
        assert a.value == b.value or (np.isnan(a.value) and np.isnan(b.value))
    assert (port.n, port.loss_ewma, port.grad_ewma) == (ref.n, ref.loss_ewma, ref.grad_ewma)


@pytest.mark.parametrize("retries", [0, 1, 2, 3, 4, 5, 9])
def test_backoff_matches_jax(retries):
    from distributed_llms_example_tpu.utils import backoff as jax_backoff
    from distributed_llms_example_tpu_torch.utils import backoff

    assert backoff.backoff_ticks(retries) == jax_backoff.backoff_ticks(retries)
    assert backoff.backoff_ticks(retries, base=3, cap=20) == jax_backoff.backoff_ticks(
        retries, base=3, cap=20)
    delay = retries * 1e-4
    assert backoff.sleep_backoff(delay, cap_s=5e-4) == jax_backoff.sleep_backoff(delay,
                                                                                  cap_s=5e-4)


def test_to_host_is_one_transfer(monkeypatch):
    """A window of device metrics becomes host floats through ONE stack and
    one copy; host numbers pass through."""
    calls = []
    real_stack = torch.stack
    monkeypatch.setattr(torch, "stack", lambda *a, **k: calls.append(1) or real_stack(*a, **k))
    pending = [(s, {"loss": torch.tensor(float(s)), "grad_norm": torch.tensor(2.0 * s),
                    "learning_rate": 0.5, "n": torch.tensor(3, dtype=torch.int64)})
               for s in (1, 2, 3)]
    out = to_host(pending)
    assert calls == [1]
    assert out == [(s, {"loss": float(s), "grad_norm": 2.0 * s, "learning_rate": 0.5, "n": 3.0})
                   for s in (1, 2, 3)]
    assert to_host([]) == []


# ---------------------------------------------------------------------------
# buckets and health numerics against the JAX step
# ---------------------------------------------------------------------------


def _jax_paths(params):
    """port name -> JAX key path, through from_jax's name map: each JAX
    leaf is replaced by a one-element array holding its index."""
    paths = []

    def number(tree, prefix=()):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = number(v, prefix + (k,))
            else:
                paths.append(prefix + (k,))
                out[k] = np.asarray([len(paths) - 1], np.float32)
        return out

    return number(params), paths


@pytest.mark.parametrize("name", ["bart-test", "t5-test"])
def test_param_buckets_match_jax(name):
    lm = jax_load_model(name)
    numbered, paths = _jax_paths(jax.device_get(lm.init_params(0)))
    port_of = {n: paths[int(t.reshape(-1)[0])] for n, t in STATE_DICT[name](numbered).items()}
    model = load_model(name, device="cpu", train=True).module
    buckets = param_buckets(model).tolist()
    names = [n for n, _ in model.named_parameters()]
    assert set(names) == set(port_of)
    got = {n: HEALTH_BUCKETS[b] for n, b in zip(names, buckets)}
    want = {n: jstep.bucket_of_path(port_of[n]) for n in names}
    assert got == want
    assert set(got.values()) >= {"embed", "attn", "mlp"}


def _records(n=24, seed=0):
    rng = np.random.RandomState(seed)
    alphabet = np.array(list("abcdefghijklmnopqrstuvwxyz   .,"))
    return [{"dialogue": "".join(rng.choice(alphabet, rng.randint(10, 120))),
             "summary": "".join(rng.choice(alphabet, rng.randint(3, 40)))} for _ in range(n)]


def _iterators(records):
    kw = dict(global_batch=8, seed=7, bucket_multiple=32, max_source_length=128,
              max_target_length=32)
    port = BatchIterator(SummarizationDataset(records, ByteTokenizer(), max_source_length=128,
                                              max_target_length=32), **kw)
    ref = JaxBatchIterator(JaxDataset(records, JaxByteTokenizer(), max_source_length=128,
                                      max_target_length=32), **kw)
    return port, ref


@pytest.mark.parametrize("name", ["bart-test", "t5-test"])
def test_health_numerics_match_jax_after_one_step(name, dp_mesh):
    """One step of the JAX ``make_train_step(..., health=True)`` and the
    port's ``train_step`` with ``health_buckets`` on the same weights and
    batch (dropout off): param norm, non-finite count and the four update
    ratios agree to 1e-5 relative."""
    lm = jax_load_model(name)
    params = jax.device_get(lm.init_params(0))
    tx, schedule, _ = joptim.make_optimizer_bundle(
        learning_rate=1e-3, weight_decay=0.01, warmup_steps=1, total_steps=3, max_grad_norm=1.0)
    build = jstep.make_train_step(lm.module, lm.config, tx, schedule, dp_mesh, donate=False,
                                  health=True)
    state = jstep.create_train_state(shard_params(params, dp_mesh), tx)
    sh = jstep.state_shardings(state, dp_mesh)
    state = jax.tree.map(lambda x, s: jax.device_put(x, s), state, sh)
    jax_step, _ = build(state)
    port, _ = _iterators(_records(seed=8 if name == "t5-test" else 0))
    batch = next(iter(port.epoch(0)))
    _, jm = jax_step(state, jstep.put_batch(batch, dp_mesh))

    tlm = load_model(name, device="cpu", train=True, attention_impl="xla")
    load_jax_params(tlm.module, params)
    model = tlm.module.eval()
    named = list(model.named_parameters())
    spec = toptim.OptimizerSpec(learning_rate=1e-3, weight_decay=0.01, warmup_steps=1,
                                total_steps=3, max_grad_norm=1.0)
    opt = toptim.AdamWState.zeros([p for _, p in named])
    m = train_step(model, named, opt, spec, toptim.linear_schedule_with_warmup(1e-3, 1, 3),
                   put_batch(batch, torch.device("cpu")), health_buckets=param_buckets(model))
    assert set(HEALTH_METRIC_KEYS) <= set(m)
    for k in HEALTH_METRIC_KEYS:
        assert isinstance(m[k], torch.Tensor) and m[k].dtype == torch.float32
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-5, err_msg=k)
    assert float(m["nonfinite_count"]) == 0.0
    # health off: the step's metrics are what they were
    m2 = train_step(model, named, opt, spec, toptim.linear_schedule_with_warmup(1e-3, 1, 3),
                    put_batch(batch, torch.device("cpu")))
    assert set(m2) == {"loss", "learning_rate", "grad_norm", "target_tokens"}


@pytest.mark.parametrize("start", [0, 1, 2, 3])
def test_epoch_start_step_matches_jax(start):
    port, ref = _iterators(_records(30))
    for epoch in (0, 1):
        got = list(port.epoch(epoch, start_step=start))
        want = list(ref.epoch(epoch, start_step=start))
        assert len(got) == len(want) == 3 - start
        for g, w in zip(got, want):
            for k in w:
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_skipped_batches_are_not_tokenized(monkeypatch):
    port, _ = _iterators(_records(30))
    seen = []
    real = SummarizationDataset.__getitem__
    monkeypatch.setattr(SummarizationDataset, "__getitem__",
                        lambda self, i: seen.append(i) or real(self, i))
    assert len(list(port.epoch(0, start_step=2))) == 1
    assert len(seen) == 8


# ---------------------------------------------------------------------------
# the trainer end to end (CPU, bart-test / t5-test)
# ---------------------------------------------------------------------------


def _write(tmp_path, n=24, seed=0):
    path = tmp_path / "train.json"
    path.write_text(json.dumps(_records(n, seed)))
    return path


def _args(path, out, *extra, model="bart-test"):
    return ["--device", "cpu", "--model-ckpt", model, "--tokenizer", "byte",
            "--train-file", str(path), "--output-dir", str(out), "--batch-size", "4",
            "--max-source-length", "128", "--max-target-length", "32",
            "--learning-rate", "1e-3", "--warmup-steps", "0", "--log-every-steps", "1",
            *extra]


def _no_dropout_checkpoint(tmp_path):
    """bart-test's seed-0 init as an HF checkpoint with every dropout 0."""
    from distributed_llms_example_tpu_torch.models.export import save_hf_checkpoint

    lm = load_model("bart-test", device="cpu")
    path = tmp_path / "bart-test-no-dropout"
    save_hf_checkpoint(str(path), lm.family, lm.config, lm.module.state_dict())
    cfg = json.loads((path / "config.json").read_text())
    cfg.update(dropout=0.0, attention_dropout=0.0, activation_dropout=0.0)
    (path / "config.json").write_text(json.dumps(cfg))
    return str(path)


def _state_equal(a, b):
    sa, sb = a.state_tensors(), b.state_tensors()
    return set(sa) == set(sb) and all(torch.equal(sa[k], sb[k]) for k in sa)


def test_preempt_and_resume_is_bit_equal_to_an_uninterrupted_run(tmp_path, capsys):
    """``--save-every-steps 3``: an uninterrupted run; a run with
    ``--chaos sigterm@4`` stops preempted at step 4 (a real SIGTERM through
    the trainer's handler, restored afterwards) with a checkpoint there; a
    third run in its output dir resumes at step 4 with cursor (0, 4) and
    takes steps 5-6: losses, parameters, moments, count, the final
    checkpoints' payloads and the model exports equal the uninterrupted
    run's bit for bit.  ``--no-resume`` trains from step 0."""
    ckpt, path = _no_dropout_checkpoint(tmp_path), _write(tmp_path)
    flags = ["--save-every-steps", "3"]
    straight = train(_args(path, tmp_path / "straight", *flags, model=ckpt))
    assert straight.result == {**straight.result, "steps": 6} and "preempted" not in straight.result
    before = signal.getsignal(signal.SIGTERM), signal.getsignal(signal.SIGINT)
    capsys.readouterr()
    stopped = train(_args(path, tmp_path / "resumed", *flags, "--chaos", "sigterm@4", model=ckpt))
    assert (signal.getsignal(signal.SIGTERM), signal.getsignal(signal.SIGINT)) == before
    assert stopped.result["preempted"] and stopped.result["steps"] == 4
    lines = _lines(capsys)
    assert [x["step"] for x in _events(lines, "chaos_injection")] == [4]
    assert _events(lines, "preemption_signal") and _events(lines, "preempted")[0]["step"] == 4
    assert not (tmp_path / "resumed" / "model").exists()  # no export of a preempted run
    (dump,) = _events(lines, "recorder_dump")
    assert (dump["reason"], dump["step"], dump["steps_recorded"]) == ("preemption", 4, 4)
    bundle = json.loads((tmp_path / "resumed" / "obs" / "flight-recorder-p000.json").read_text())
    assert [e["step"] for e in bundle["entries"]] == [1, 2, 3, 4]
    assert [e["fingerprint"]["epoch_step"] for e in bundle["entries"]] == [0, 1, 2, 3]
    assert stopped.checkpointer.all_steps() == [3, 4]

    resumed = train(_args(path, tmp_path / "resumed", *flags, model=ckpt))
    lines = _lines(capsys)
    assert _events(lines, "resumed") == [{"event": "resumed", "step": 4}]
    cursor = _events(lines, "recovery_cursor_restored")[0]
    assert (cursor["epoch"], cursor["pos"]) == (0, 4)
    assert resumed.start_step == 4 and len(resumed.history) == 2
    assert [float(m["loss"]) for m in resumed.history] == [
        float(m["loss"]) for m in straight.history[4:]]
    assert _state_equal(resumed, straight)
    assert resumed.opt_state.count == straight.opt_state.count == 6
    payload = [load_file(tmp_path / d / "checkpoints" / "6" / "state.safetensors")
               for d in ("straight", "resumed")]
    assert set(payload[0]) == set(payload[1])
    assert all(torch.equal(payload[0][k], payload[1][k]) for k in payload[0])
    for d in ("straight", "resumed"):
        meta = json.loads((tmp_path / d / "checkpoints" / "6" / "meta.json").read_text())
        assert meta == {"count": 6, "step": 6}
    assert ((tmp_path / "straight" / "model" / "model.safetensors").read_bytes()
            == (tmp_path / "resumed" / "model" / "model.safetensors").read_bytes())

    fresh = train(_args(path, tmp_path / "resumed", *flags, "--no-resume", model=ckpt))
    assert fresh.start_step == 0 and len(fresh.history) == 6
    assert not _events(_lines(capsys), "resumed")


def test_rewind_is_bit_exact_to_the_quarantine_oracle(tmp_path, capsys):
    """``--health on --on-anomaly rewind --chaos nan_grad@3
    --save-every-steps 2`` on bart-test with dropout 0.1: one injection,
    one non-finite anomaly at step 3, one rewind to step 2, one quarantine
    and one replay skip; 5 steps with a finite final loss, the non-finite
    count 0 on each of them; the parameters' and moments' addresses kept
    (the fused AdamW leaf table stays valid); and the final state bit for
    bit that of a clean run which quarantines the same batch from the
    start (the replay redraws the dropout masks it drew).  A resumed
    trainer over the rewound run's directory gets its cursor and the
    quarantine back from the sidecar."""
    path = _write(tmp_path)
    flags = ["--save-every-steps", "2", "--health", "on"]
    cfg_args = _args(path, tmp_path / "chaos", *flags, "--on-anomaly", "rewind",
                     "--chaos", "nan_grad@3")
    from distributed_llms_example_tpu_torch.core.config import config_from_args
    from distributed_llms_example_tpu_torch.data.dataset import load_json_records

    trainer = Trainer(config_from_args(build_train_parser().parse_args(cfg_args)),
                      load_json_records(str(path)))
    addresses = [t.data_ptr() for t in trainer.state_tensors().values()]
    capsys.readouterr()
    result = trainer.train()
    lines = _lines(capsys)
    assert "anomaly" not in result and result["steps"] == 5 and len(trainer.history) == 5
    assert [(x["kind"], x["step"]) for x in _events(lines, "chaos_injection")] == [("nan_grad", 3)]
    (anomaly,) = _events(lines, "obs_anomaly")
    assert (anomaly["code"], anomaly["step"], anomaly["policy"]) == ("nonfinite", 3, "rewind")
    assert anomaly["value"] > 0  # the non-finite gradient elements, from the AdamW sums
    (rec,) = _events(lines, "recovery")
    assert (rec["action"], rec["restored_step"], rec["steps_lost"]) == ("rewind", 2, 1)
    (q,) = _events(lines, "quarantine")
    assert (q["epoch"], q["epoch_step"]) == (0, 2) and q["reason"] == "anomaly:nonfinite@3"
    assert len(_events(lines, "quarantine_skip")) == 1
    assert _events(lines, "recorder_dump")[0]["reason"] == "anomaly:nonfinite"
    assert os.path.exists(tmp_path / "chaos" / "obs" / "flight-recorder-p000.json")
    assert all(float(m["nonfinite_count"]) == 0.0 for m in trainer.history)
    assert np.isfinite(float(trainer.history[-1]["loss"]))
    assert [t.data_ptr() for t in trainer.state_tensors().values()] == addresses

    oracle = Trainer(config_from_args(build_train_parser().parse_args(
        _args(path, tmp_path / "clean", *flags))), load_json_records(str(path)))
    oracle.recovery.quarantine(0, 2, {}, reason="oracle")
    assert oracle.train()["steps"] == 5
    assert _state_equal(trainer, oracle)
    assert [float(m["loss"]) for m in trainer.history] == [float(m["loss"]) for m in oracle.history]

    again = Trainer(config_from_args(build_train_parser().parse_args(cfg_args)),
                    load_json_records(str(path)))
    assert again.start_step == 6 and again._resume_cursor == (1, 0)
    assert (0, 2) in again.recovery.quarantined


def test_ckpt_corrupt_resumes_from_the_previous_step(tmp_path, capsys):
    """``--chaos ckpt_corrupt@2``: the second save (step 4, the newest) is
    bit-flipped after its manifest; the next run resumes from step 2 and
    finishes; once step 2 is corrupt too, the directory is refused with the
    JAX package's message."""
    path = _write(tmp_path, 16)
    flags = ["--save-every-steps", "2"]
    first = train(_args(path, tmp_path / "run", *flags, "--chaos", "ckpt_corrupt@2"))
    assert first.result["steps"] == 4
    assert _events(_lines(capsys), "chaos_ckpt_corrupted")[0]["step"] == 4
    ck = first.checkpointer
    assert ck.all_steps() == [2, 4] and ck.verify(2) is None and ck.verify(4) is not None
    resumed = train(_args(path, tmp_path / "run", *flags))
    lines = _lines(capsys)
    assert [x["step"] for x in _events(lines, "ckpt_verify_failed")] == [4]
    assert _events(lines, "resumed")[0]["step"] == 2
    assert resumed.result["steps"] == 4 and len(resumed.history) == 2
    corrupt_checkpoint(ck.step_dir(2))
    with pytest.raises(ValueError, match="integrity verification"):
        train(_args(path, tmp_path / "run", *flags))
    assert [x["step"] for x in _events(_lines(capsys), "ckpt_verify_failed")] == [4, 2]


def test_final_window_rewind_degrades_to_checkpoint(tmp_path, capsys):
    """An anomaly found only in the final partial health window has no loop
    left to replay: the rewind becomes the checkpoint policy (a resumable
    save and the anomaly marker), and the model is not exported."""
    path = _write(tmp_path, 12)
    trainer = train(_args(path, tmp_path / "out", "--save-every-steps", "2", "--health", "on",
                          "--on-anomaly", "rewind", "--chaos", "nan_grad@3",
                          "--log-every-steps", "8"))
    assert trainer.result["anomaly"] == "checkpoint" and trainer.result["steps"] == 3
    lines = _lines(capsys)
    (anomaly,) = _events(lines, "obs_anomaly")
    assert (anomaly["step"], anomaly["detected_at_step"]) == (3, 3)
    assert _events(lines, "anomaly_stop")[0]["policy"] == "checkpoint"
    assert not (tmp_path / "out" / "model").exists()
    assert 3 in trainer.checkpointer.all_steps()


@pytest.mark.parametrize("policy", ["halt", "checkpoint", "warn"])
def test_anomaly_policies(tmp_path, capsys, policy):
    path = _write(tmp_path, 12)
    trainer = train(_args(path, tmp_path / "out", "--health", "on", "--on-anomaly", policy,
                          "--chaos", "nan_grad@2"))
    lines = _lines(capsys)
    assert _events(lines, "obs_anomaly")[0]["policy"] == policy
    if policy == "warn":
        assert "anomaly" not in trainer.result and trainer.result["steps"] == 3
    else:
        assert trainer.result["anomaly"] == policy and trainer.result["steps"] == 2
        assert trainer.checkpointer.all_steps() == ([2] if policy == "checkpoint" else [])
        assert not (tmp_path / "out" / "model").exists()


def test_data_error_is_retried_and_oom_dumps_the_recorder(tmp_path, capsys):
    path = _write(tmp_path, 12)
    trainer = train(_args(path, tmp_path / "a", "--chaos", "data_error@2"))
    assert trainer.result["steps"] == 3
    (retry,) = _events(_lines(capsys), "data_retry")
    assert retry["step"] == 2 and retry["attempt"] == 1 and "chaos" in retry["error"]
    with pytest.raises(RuntimeError, match="RESOURCE_EXHAUSTED"):
        train(_args(path, tmp_path / "b", "--health", "on", "--chaos", "oom@3"))
    dump = _events(_lines(capsys), "recorder_dump")
    assert dump and dump[0]["reason"] == "exception" and dump[0]["step"] == 2


@pytest.mark.parametrize("flags,match", [
    (["--on-anomaly", "rewind"], "--save-every-steps"),
    (["--on-anomaly", "rewind", "--save-every-steps", "2", "--recorder-steps", "0"],
     "--recorder-steps"),
    (["--max-rewinds", "-1"], "--max-rewinds"),
    (["--chaos", "nan_grad@0"], "bad --chaos entry"),
])
def test_config_refuses_what_would_fail_mid_run(tmp_path, capsys, flags, match):
    with pytest.raises(SystemExit):
        train(_args(_write(tmp_path, 8), tmp_path / "out", *flags))
    assert match in capsys.readouterr().err


def test_new_config_defaults_are_the_jax_packages():
    got, want = TrainConfig(), JaxTrainConfig()
    for k in ("health", "on_anomaly", "max_rewinds", "recorder_steps", "health_loss_spike_factor",
              "health_grad_norm_factor", "health_warmup_steps", "chaos"):
        assert getattr(got, k) == getattr(want, k), k
    for k in ("save_every_steps", "keep", "resume", "async_save"):
        assert getattr(got.checkpoint, k) == getattr(want.checkpoint, k), k
    assert not health.health_enabled(got)


def _jax_records(n=16, seed=0):
    rng = np.random.RandomState(seed)
    return [{"dialogue": " ".join(f"w{rng.randint(40)}" for _ in range(12)),
             "summary": f"w{rng.randint(40)}"} for _ in range(n)]


def test_port_takes_the_decisions_of_a_jax_trainer_run(tmp_path, capsys):
    """One JAX ``Trainer`` run (t5-test, ``nan_grad@3``, rewind, a save
    every 2 steps, the health check every 2) and the port's run of the
    same config take the same decisions: the anomaly at step 3 found at
    step 4, a rewind (the first of the budget), the quarantine key (1, 0)
    and its reason.  The JAX run's restore of its own step-2 checkpoint
    fails with the installed Orbax (a tree-structure mismatch that fails
    the JAX package's own slow rewind test too), so it halts there; the
    port's restore target and steps lost are held to what the JAX run's
    checkpoint directory dictates (its newest step before the anomaly),
    and the port's 5 steps to the plan's 6 less the quarantined batch."""
    from distributed_llms_example_tpu.train.trainer import Trainer as JaxTrainer

    recs = _jax_records()
    jcfg = JaxTrainConfig(
        model_ckpt="t5-test", output_dir=str(tmp_path / "jax"), batch_size=8, num_epochs=3,
        warmup_steps=1, evaluation_steps=0, max_source_length=32, max_target_length=16,
        pad_to_multiple=32, log_every_steps=2, num_beams=1, tokenizer="byte",
        mesh=MeshConfig(data=-1),
        checkpoint=JaxCheckpointConfig(save_every_steps=2, resume=False, async_save=False),
        obs="jsonl", obs_gauges="off", health="on", recorder_steps=8, on_anomaly="rewind",
        chaos="nan_grad@3", max_rewinds=2)
    jt = JaxTrainer(jcfg, train_records=recs)
    jt.save_final = lambda: None
    jt.train()
    jevents = [json.loads(x) for x in open(tmp_path / "jax" / "obs" / "metrics-p000.jsonl")]
    capsys.readouterr()

    path = tmp_path / "train.json"
    path.write_text(json.dumps(recs))
    pt = train(["--device", "cpu", "--model-ckpt", "t5-test", "--tokenizer", "byte",
                "--train-file", str(path), "--output-dir", str(tmp_path / "port"),
                "--batch-size", "8", "--num-epochs", "3", "--warmup-steps", "1",
                "--evaluation-steps", "0", "--max-source-length", "32",
                "--max-target-length", "16", "--pad-to-multiple", "32", "--log-every-steps", "2",
                "--num-beams", "1", "--save-every-steps", "2", "--no-resume", "--health", "on",
                "--recorder-steps", "8", "--on-anomaly", "rewind", "--chaos", "nan_grad@3",
                "--max-rewinds", "2"])
    pevents = _lines(capsys)

    def decisions(events):
        (a,) = _events(events, "obs_anomaly")
        (q,) = _events(events, "quarantine")
        return ((a["code"], a["step"], a["detected_at_step"], a["policy"]),
                (q["epoch"], q["epoch_step"], q["reason"], q["input_ids_crc32"]))

    assert decisions(pevents) == decisions(jevents)
    assert pt.recovery.rewinds_done == jt.recovery.rewinds_done == 1
    assert list(pt.recovery.quarantined) == list(jt.recovery.quarantined) == [(1, 0)]
    (anomaly,) = _events(jevents, "obs_anomaly")
    target = max(s for s in jt.checkpointer.all_steps() if s < anomaly["step"])
    (rec,) = _events(pevents, "recovery")
    assert (rec["action"], rec["restored_step"], rec["steps_lost"]) == (
        "rewind", target, anomaly["detected_at_step"] - target) == ("rewind", 2, 2)
    assert len(_events(pevents, "quarantine_skip")) == 1
    assert pt.result["steps"] == 3 * jt.batches.steps_per_epoch() - 1 == 5
