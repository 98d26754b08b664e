"""The port's train entry end to end on the CPU (``--device cpu`` at
``bart-test`` and ``t5-test`` size, a temporary JSON file): the JAX CLI's
step lines, the done event, the returned trainer's history; flags this
slice does not implement are refused by argparse."""

import json

import numpy as np
import pytest

from distributed_llms_example_tpu_torch.launch.cli import (
    build_serve_parser,
    build_train_parser,
    main,
    train,
)
from distributed_llms_example_tpu_torch.models.registry import BART_CONFIGS


def _write(tmp_path, n=12):
    rng = np.random.RandomState(0)
    alphabet = np.array(list("abcdefghijklmnopqrstuvwxyz   .,"))
    recs = [{"dialogue": "".join(rng.choice(alphabet, rng.randint(20, 100))),
             "summary": "".join(rng.choice(alphabet, rng.randint(5, 30)))} for _ in range(n)]
    path = tmp_path / "train.json"
    path.write_text(json.dumps(recs))
    return path


def _args(path, *extra, model="bart-test"):
    return ["--device", "cpu", "--model-ckpt", model, "--train-file", str(path),
            "--batch-size", "4", "--max-source-length", "128", "--max-target-length", "32",
            "--learning-rate", "1e-3", "--warmup-steps", "0", *extra]


def test_train_cpu_end_to_end(tmp_path, capsys):
    trainer = train(_args(_write(tmp_path), "--log-every-steps", "2", "--num-epochs", "2"))
    assert len(trainer.history) == 6
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines() if x.startswith("{")]
    steps = [x for x in lines if "step" in x and "loss" in x]
    # every 2 steps, plus the partial window flushed at the end of epoch 0
    assert [x["step"] for x in steps] == [2, 3, 4, 6]
    for x in steps:
        assert {"loss", "learning_rate", "tokens_per_sec", "steps_per_sec", "epoch"} <= set(x)
        assert np.isfinite(x["loss"])
    assert [x["epoch"] for x in steps] == [0, 0, 1, 1]
    start = next(x for x in lines if x.get("event") == "train_start")
    assert start["param_tensors"] == 92 and start["total_steps"] == 6
    done = next(x for x in lines if x.get("event") == "done")
    assert done["steps"] == 6
    # the schedule decays linearly to 0 over the run
    lrs = [m["learning_rate"] for m in trainer.history]
    assert lrs[0] == pytest.approx(1e-3) and all(a > b for a, b in zip(lrs, lrs[1:]))


@pytest.mark.parametrize("model", ["bart-test", "t5-test"])
def test_main_without_subcommand_trains(tmp_path, capsys, model):
    assert main(_args(_write(tmp_path, 4), "--log-every-steps", "1", model=model)) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines() if x.startswith("{")]
    assert next(x for x in lines if x.get("event") == "train_start")["model"] == model
    assert any(x.get("event") == "done" for x in lines)
    assert all(np.isfinite(x["loss"]) for x in lines if "loss" in x)


def test_train_and_serve_share_the_model_flags(tmp_path):
    shared = ("model_ckpt", "tokenizer", "source_column", "max_source_length",
              "attention_impl", "device", "seed")
    targs = build_train_parser().parse_args(["--train-file", "t.json"])
    sargs = build_serve_parser().parse_args(["--prompts-file", "p.json"])
    assert {k: getattr(targs, k) for k in shared} == {k: getattr(sargs, k) for k in shared}
    # the default model is one the port builds
    assert targs.model_ckpt in BART_CONFIGS


@pytest.mark.parametrize("flag", [["--output-dir", "/tmp/x"], ["--optim-impl", "fused"],
                                  ["--mesh", "data=2"], ["--remat"]])
def test_unimplemented_flags_are_refused(tmp_path, flag):
    with pytest.raises(SystemExit):
        train(_args(_write(tmp_path, 4), *flag))
