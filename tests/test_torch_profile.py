"""The port's profiler controller (``obs/profile.py``) against the JAX
package's: ``parse_profile_steps`` on every form (and its errors), and the
controller's captures, events and syncs over the same step sequences
(the window form, the count form, a resume inside the window, the trigger
file with and without a count, ``finalize`` inside an open window), with
both profiler backends replaced by recorders and the wall clock in the
capture's name fixed."""

import json
import time

import jax
import pytest
import torch

from distributed_llms_example_tpu.obs import profile as jax_profile
from distributed_llms_example_tpu.obs import sink as jax_sink
from distributed_llms_example_tpu_torch.obs import profile, sink
from distributed_llms_example_tpu_torch.obs.budget import sync_device


@pytest.fixture(autouse=True)
def _stdout_sinks():
    jax_sink.install_sink(jax_sink.build_sink("stdout", ""))
    sink.install_sink(sink.build_sink("stdout", ""))
    yield
    jax_sink.install_sink(jax_sink.build_sink("stdout", ""))
    sink.install_sink(sink.build_sink("stdout", ""))


@pytest.mark.parametrize("spec", [None, "", 0, 3, -1, "3", "0", " 7 ", "2:5", "5:5", "1:1"])
def test_parse_profile_steps_matches_jax(spec):
    assert profile.parse_profile_steps(spec) == jax_profile.parse_profile_steps(spec)


@pytest.mark.parametrize("spec", ["5:2", "0:3", "a:b", "x"])
def test_parse_profile_steps_refuses_as_jax(spec):
    for fn in (profile.parse_profile_steps, jax_profile.parse_profile_steps):
        with pytest.raises(ValueError):
            fn(spec)


class Recorder:
    """The port's backend: what the controller started and stopped."""

    def __init__(self, calls):
        self.calls = calls

    def start(self, trace_dir):
        self.calls.append(("start", trace_dir))

    def stop(self):
        self.calls.append(("stop",))


# (name, controller kwargs, steps run, trigger file contents before a step,
# finalize's last step or None)
SCENARIOS = {
    "window": (dict(steps_spec="3:4"), range(1, 7), {}, None),
    "count": (dict(steps_spec="2", profile_dir="PD", start_step=0), range(1, 7), {}, None),
    "resumed_inside": (dict(steps_spec="100:105"), range(103, 108), {}, None),
    "trigger": (dict(steps_spec=0), range(1, 9), {2: "2", 6: ""}, None),
    "finalized": (dict(steps_spec="4:9"), range(1, 7), {}, 6),
    "trigger_finalized": (dict(steps_spec=0), range(1, 5), {3: "5"}, 4),
}


def _run(mod, tmp_path, kwargs, steps, triggers, last, calls):
    trigger = tmp_path / "profile.trigger"
    kw = dict(kwargs, trigger_path=str(trigger), output_dir=str(tmp_path / "out"))
    if "profile_dir" in kw:
        kw["profile_dir"] = str(tmp_path / kw["profile_dir"])
    if mod is profile:
        ctl = profile.ProfileController(**kw, backend=Recorder(calls))
    else:
        ctl = jax_profile.ProfileController(**kw)
    ctl.on_capture = lambda d, w, t: calls.append(("capture", d, list(w), t))
    loss = torch.tensor(1.0)
    for s in steps:
        if s in triggers:
            trigger.write_text(triggers[s])
        ctl.before_step(s)
        ctl.after_step(s, loss)
    if last is not None:
        ctl.finalize(loss, last_step=last)
    return ctl


@pytest.mark.parametrize("name", SCENARIOS)
def test_controller_matches_jax(name, tmp_path, monkeypatch, capsys):
    kwargs, steps, triggers, last = SCENARIOS[name]
    monkeypatch.setattr(time, "strftime", lambda fmt, *a: "20260101-000000")
    theirs: list = []
    monkeypatch.setattr(jax.profiler, "start_trace", lambda d: theirs.append(("start", d)))
    monkeypatch.setattr(jax.profiler, "stop_trace", lambda: theirs.append(("stop",)))
    monkeypatch.setattr(jax, "block_until_ready", lambda x: theirs.append(("sync",)))
    _run(jax_profile, tmp_path, kwargs, steps, triggers, last, theirs)
    want_out = capsys.readouterr().out
    ours: list = []
    syncs = sync_device.profile_syncs
    ctl = _run(profile, tmp_path, kwargs, steps, triggers, last, ours)
    got_out = capsys.readouterr().out
    assert got_out == want_out
    assert [c for c in ours] == [c for c in theirs if c != ("sync",)]
    assert sync_device.profile_syncs - syncs == theirs.count(("sync",)) >= 1
    assert not ctl.active
    events = [json.loads(x) for x in got_out.splitlines()]
    assert {e["event"] for e in events} == {"profile_trace", "profile_captured"}


def test_the_torch_backend_writes_a_trace(tmp_path):
    backend = profile.TorchProfilerBackend("cpu", lambda: None)
    backend.start(str(tmp_path))
    torch.ones(4, 4) @ torch.ones(4, 4)
    backend.stop()
    (path,) = tmp_path.glob("rank0.pt.trace.json")
    assert any(e.get("cat") == "cpu_op" for e in json.loads(path.read_text())["traceEvents"])


def test_an_agreed_anomaly_arms_the_capture(tmp_path, capsys):
    """``--profile-on-anomaly``: the NaN the chaos plants before step 2 is
    an agreed anomaly at step 2, which arms the trigger file; the capture
    of ``DEFAULT_TRIGGER_STEPS`` steps opens at step 3, the run's last, and
    is closed by ``finalize``: window [3, 3], truncated, a device account."""
    from distributed_llms_example_tpu_torch.launch.cli import train

    path = tmp_path / "train.json"
    path.write_text(json.dumps([{"dialogue": f"w{i} w{i + 1} w{i + 2} " * 3, "summary": f"w{i}"}
                                for i in range(12)]))
    out = tmp_path / "out"
    train(["--device", "cpu", "--model-ckpt", "llama-test", "--tokenizer", "byte",
           "--train-file", str(path), "--output-dir", str(out), "--batch-size", "4",
           "--max-source-length", "32", "--max-target-length", "16", "--pad-to-multiple", "32",
           "--log-every-steps", "1", "--evaluation-steps", "0", "--obs", "jsonl",
           "--health", "on", "--on-anomaly", "warn", "--chaos", "nan_grad@2",
           "--profile-on-anomaly"])
    lines = [json.loads(x) for x in open(out / "obs" / "metrics-p000.jsonl")]
    armed = [x for x in lines if x.get("event") == "profile_trigger_armed"]
    assert armed and armed[0]["step"] == 2 and armed[0]["reason"].startswith("anomaly:")
    captured = [x for x in lines if x.get("event") == "profile_captured"]
    assert [(c["window"], c.get("truncated")) for c in captured] == [([3, 3], True)]
    assert any(x.get("event") == "device_account" for x in lines)
    capsys.readouterr()
