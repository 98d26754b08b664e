"""The port's train entry end to end on the CPU (``--device cpu`` at
``bart-test`` and ``t5-test`` size, a temporary JSON file): the JAX CLI's
step lines, the done event, the returned trainer's history; flags this
slice does not implement are refused by argparse (``--param-dtype`` parses
its fp32 default as the JAX CLI does and refuses bf16), and ``--chaos
host_loss@K`` without a checkpoint cadence to reshard from at parse time.  Also: training from a
local HF checkpoint directory whose config sets attention_dropout, which
writes <output-dir>/model/ (the reload is bit-equal to the trained
weights); T5's and BART's training attention reaching flash_attention with
the probs-dropout rate and a seed; the train entry taking a T5 built
with attn_dropout_rate; LLaMA serving with attention_dropout
and training with it.  Evaluation: ``--val-file`` with
``--evaluation-steps 2`` over 3 steps logs ``eval`` lines (the four ROUGE
means, step, epoch) at step 2 and at the epoch's end, the losses are bit
for bit those of a run without it, and without a validation file (or with
a missing one) there is no eval line.  The default ``--model-ckpt`` is the
JAX CLI's.  The reference's ``--gradient-accumulation-steps`` (both
spellings) parses as the JAX CLI's; ``--dry-run`` prints the resolved
config and exits 0 without a device or a dataset; ``--lint`` and the
profiler, gauge and memory flags parse."""

import json

import numpy as np
import pytest
import torch

from distributed_llms_example_tpu.core.config import TrainConfig as JaxTrainConfig
from distributed_llms_example_tpu_torch.launch.cli import (
    build_serve_parser,
    build_train_parser,
    main,
    train,
)
from distributed_llms_example_tpu_torch.models.registry import T5_CONFIGS


def _write(tmp_path, n=12, name="train.json", seed=0):
    rng = np.random.RandomState(seed)
    alphabet = np.array(list("abcdefghijklmnopqrstuvwxyz   .,"))
    recs = [{"dialogue": "".join(rng.choice(alphabet, rng.randint(20, 100))),
             "summary": "".join(rng.choice(alphabet, rng.randint(5, 30)))} for _ in range(n)]
    path = tmp_path / name
    path.write_text(json.dumps(recs))
    return path


def _args(path, *extra, model="bart-test"):
    return ["--device", "cpu", "--model-ckpt", model, "--train-file", str(path),
            "--output-dir", str(path.parent / "out"), "--batch-size", "4",
            "--max-source-length", "128", "--max-target-length", "32",
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
    # the default model is the JAX CLI's, and one the port builds
    assert targs.model_ckpt == JaxTrainConfig().model_ckpt
    assert targs.model_ckpt in T5_CONFIGS


@pytest.mark.parametrize("flag", [["--param-dtype", "bfloat16"], ["--optim-impl", "fused"],
                                  ["--mesh", "expert=2"], ["--pipeline-schedule", "1f1b"],
                                  ["--chaos", "host_loss@2"]])
def test_unimplemented_flags_are_refused(tmp_path, capsys, flag):
    with pytest.raises(SystemExit):
        train(_args(_write(tmp_path, 4), *flag))
    if flag[0] == "--chaos":  # parsed, then refused: a reshard needs --save-every-steps
        assert "needs a checkpoint to reshard FROM" in capsys.readouterr().err
    if flag[0] == "--mesh":  # data, fsdp, sequence and tensor are laid out; expert is not
        assert "ROADMAP.md item 6" in capsys.readouterr().err


@pytest.mark.parametrize("argv", [[], ["--param-dtype", "float32"]], ids=["default", "fp32"])
def test_param_dtype_parses_as_the_jax_cli(argv):
    """``--param-dtype`` parses into ``TrainConfig.param_dtype`` as the JAX
    CLI's does, for the fp32 masters the port trains with (bf16 is refused,
    above)."""
    import argparse

    from distributed_llms_example_tpu.core.config import (
        add_reference_args,
        add_tpu_args,
        config_from_args as jax_config_from_args,
    )
    from distributed_llms_example_tpu_torch.core.config import config_from_args

    jp = argparse.ArgumentParser()
    add_reference_args(jp)
    add_tpu_args(jp)
    want = jax_config_from_args(jp.parse_args(argv)).param_dtype
    got = config_from_args(build_train_parser().parse_args(["--train-file", "t.json", *argv]))
    assert got.param_dtype == want == (argv[1] if argv else "float32")


def _hf_dir(tmp_path, name, **config):
    """An HF checkpoint of ``name``'s seed-0 init, written by the port's
    export, with ``config`` fields set in its config.json."""
    from distributed_llms_example_tpu_torch.models.export import save_hf_checkpoint
    from distributed_llms_example_tpu_torch.models.registry import load_model

    lm = load_model(name, device="cpu")
    path = tmp_path / f"{name}-hf"
    save_hf_checkpoint(str(path), lm.family, lm.config, lm.module.state_dict())
    cfg = json.loads((path / "config.json").read_text())
    (path / "config.json").write_text(json.dumps({**cfg, **config}))
    return path


@pytest.mark.parametrize("impl", ["auto", "flash"])
def test_train_from_an_hf_dir_with_probs_dropout_saves_the_model(tmp_path, impl):
    """``train --model-ckpt <HF dir whose config sets attention_dropout>
    --output-dir D``: the model trains with that probs dropout on either
    route, and D/model/ holds the HF checkpoint of the trained fp32
    weights (reloading bit-equal), train_config.json and a Valohai sidecar
    for each file."""
    from distributed_llms_example_tpu_torch.models.registry import load_model
    from distributed_llms_example_tpu_torch.ops import mha

    ckpt = _hf_dir(tmp_path, "bart-test", attention_dropout=0.1)
    seen = []
    real = mha.flash_attention

    def flash(*a, **k):
        seen.append(k.get("dropout_rate", 0.0))
        return real(*a, **k)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(mha, "flash_attention", flash)
        trainer = train(_args(_write(tmp_path, 8), "--attention-impl", impl,
                              model=str(ckpt)))
    assert trainer.loaded.config.attn_dropout_rate == 0.1
    if impl == "flash":  # every training attention call dropped
        assert seen and set(seen) == {0.1}
    out = tmp_path / "out" / "model"
    files = set(p.name for p in out.iterdir())
    base = {"config.json", "model.safetensors", "train_config.json"}
    assert files == base | {f"{f}.metadata.json" for f in base}
    assert json.loads((out / "config.json").read_text())["attention_dropout"] == 0.1
    cfg = json.loads((out / "train_config.json").read_text())
    assert cfg["model_ckpt"] == str(ckpt) and cfg["output_dir"] == str(tmp_path / "out")
    sidecar = json.loads((out / "model.safetensors.metadata.json").read_text())
    assert sidecar["valohai.dataset-versions"][0]["valohai.tags"] == ["dev", "llm"]
    reloaded = load_model(str(out), device="cpu", train=True).module.state_dict()
    trained = trainer.model.state_dict()
    assert set(reloaded) == set(trained)
    assert all(torch.equal(reloaded[k], trained[k]) for k in trained)
    # the model did train: its weights moved from the checkpoint's
    start = load_model(str(ckpt), device="cpu").module.state_dict()
    assert not torch.equal(start["shared.weight"], trained["shared.weight"])


@pytest.mark.parametrize("name", ["bart-test", "t5-test"])
def test_attn_dropout_routes_through_flash_attention_with_a_seed(name):
    """A T5 and a BART module with attn_dropout_rate > 0 (the counterparts
    of the JAX package's test_t5_attn_dropout_routes_through_kernel and
    test_llama_attn_only_dropout_fires): every training attention call
    reaches flash_attention with the rate and its own int32 seed, drawn
    from the dropout_seeds stream, so a forward is deterministic per
    stream and differs across streams and from eval; eval passes no
    dropout; the gradients are finite."""
    import dataclasses

    from distributed_llms_example_tpu_torch.models.registry import load_model
    from distributed_llms_example_tpu_torch.ops import mha
    from distributed_llms_example_tpu_torch.ops.fused_dropout import dropout_seeds

    lm = load_model(name, device="cpu", train=True, attention_impl="flash")
    cfg = dataclasses.replace(lm.config, attn_dropout_rate=0.2, dropout_rate=0.0)
    model = type(lm.module)(cfg)
    model.load_state_dict(lm.module.state_dict())
    ids = torch.randint(3, 250, (2, 32), generator=torch.Generator().manual_seed(0))
    calls = []
    real = mha.flash_attention

    def flash(*a, **k):
        calls.append((k.get("dropout_rate", 0.0), k.get("dropout_seed")))
        return real(*a, **k)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(mha, "flash_attention", flash)

        def run(seed, train=True):
            model.train(train)
            with dropout_seeds(torch.Generator().manual_seed(seed)):
                return model(ids, None, ids)

        a = run(1)
        n_attn = sum(isinstance(m, mha.MultiHeadAttention) for m in model.modules())
        assert len(calls) == n_attn and {r for r, _ in calls} == {0.2}
        seeds = [s for _, s in calls]
        assert all(isinstance(s, int) and -(2**31) <= s < 2**31 for s in seeds)
        assert len(set(seeds)) == len(seeds)
        assert torch.equal(a, run(1)) and not torch.equal(a, run(2))
        calls.clear()
        ev = run(1, train=False)
        assert calls and all(r == 0.0 and s is None for r, s in calls)
        assert not torch.equal(a, ev)
        run(3).float().square().mean().backward()
    assert all(torch.isfinite(p.grad).all() for p in model.parameters() if p.grad is not None)


def test_train_entry_takes_a_built_t5_with_probs_dropout(tmp_path):
    """``train(argv, loaded=...)`` trains a model the caller built, here T5
    with attn_dropout_rate (which no HF T5 config sets): every training
    attention call reaches flash_attention with that rate, the run differs
    from the same weights at rate 0, and the saved model reloads to the
    trained weights.  A model in another dtype than --compute-dtype, or
    beside --attention-impl, is refused."""
    import dataclasses

    from distributed_llms_example_tpu_torch.models.registry import LoadedModel, load_model
    from distributed_llms_example_tpu_torch.ops import mha

    def built(rate):
        lm = load_model("t5-test", device="cpu", train=True, seed=0, attention_impl="flash")
        cfg = dataclasses.replace(lm.config, attn_dropout_rate=rate)
        module = type(lm.module)(cfg)
        module.load_state_dict(lm.module.state_dict())
        return LoadedModel("t5", cfg, module)

    path = _write(tmp_path, 8)
    seen = []
    real = mha.flash_attention

    def flash(*a, **k):
        seen.append(k.get("dropout_rate", 0.0))
        return real(*a, **k)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(mha, "flash_attention", flash)
        dropped = train(_args(path, "--compute-dtype", "float32", model="t5-test"),
                        loaded=built(0.2))
    assert dropped.loaded.config.attn_dropout_rate == 0.2
    assert seen and set(seen) == {0.2}
    plain = train(_args(path, "--compute-dtype", "float32", "--output-dir",
                        str(tmp_path / "plain"), model="t5-test"), loaded=built(0.0))
    losses = [float(m["loss"]) for m in dropped.history]
    assert all(np.isfinite(losses))
    assert losses != [float(m["loss"]) for m in plain.history]
    reloaded = load_model(str(tmp_path / "out" / "model"), device="cpu").module.state_dict()
    trained = dropped.model.state_dict()
    assert all(torch.equal(reloaded[k], trained[k]) for k in trained)
    with pytest.raises(ValueError, match="not a seq2seq model in bfloat16"):
        train(_args(path, "--compute-dtype", "bfloat16", model="t5-test"), loaded=built(0.2))
    with pytest.raises(ValueError, match="--attention-impl"):
        train(_args(path, "--compute-dtype", "float32", "--attention-impl", "flash",
                    model="t5-test"), loaded=built(0.2))


def test_llama_with_attention_dropout_serves_and_refuses_to_train(tmp_path):
    """LLaMA with attention_dropout serves without it (eval mode) and, since
    causal training is ported, trains with it: its training forward draws
    a probs-dropout mask from the seed stream."""
    from distributed_llms_example_tpu_torch.models.registry import load_model
    from distributed_llms_example_tpu_torch.ops.fused_dropout import dropout_seeds

    ckpt = _hf_dir(tmp_path, "llama-test", attention_dropout=0.1)
    lm = load_model(str(ckpt), device="cpu")
    assert lm.config.attn_dropout_rate == 0.1 and not lm.module.training
    ids = torch.randint(3, 250, (1, 16), generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        served = lm.module(ids)
        assert torch.equal(lm.module(ids), served)
    trained = load_model(str(ckpt), device="cpu", train=True)
    assert trained.module.training
    with torch.no_grad(), dropout_seeds(torch.Generator().manual_seed(1)):
        assert not torch.equal(trained.module(ids), served)


def _eval_args(tmp_path, *extra, val=True):
    val_args = ["--val-file", str(_write(tmp_path, 5, "val.json", seed=1))] if val else []
    return _args(_write(tmp_path, 12), *val_args, "--log-every-steps", "1",
                 "--eval-max-new-tokens", "8", "--eval-batch-size", "2", *extra)


def _lines(capsys):
    return [json.loads(x) for x in capsys.readouterr().out.splitlines() if x.startswith("{")]


def test_eval_every_n_steps_and_at_the_epoch_end(tmp_path, capsys):
    """``--val-file v.json --evaluation-steps 2`` over 3 steps (12 records,
    batch 4): an eval line at step 2 and one at the epoch's end (step 3),
    after that epoch's step lines, each with the four ROUGE means in [0, 1],
    step and epoch; the trainer returns the last one."""
    assert main(_eval_args(tmp_path, "--evaluation-steps", "2", "--num-beams", "2")) == 0
    lines = _lines(capsys)
    evals = [x for x in lines if x.get("event") == "eval"]
    assert [x["step"] for x in evals] == [2, 3]
    for x in evals:
        assert set(x) == {"event", "step", "epoch", "rouge1", "rouge2", "rougeL", "rougeLsum"}
        assert x["epoch"] == 0.0
        assert all(0.0 <= x[k] <= 1.0 for k in ("rouge1", "rouge2", "rougeL", "rougeLsum"))
    order = [x.get("event", "step") for x in lines if "loss" in x or x.get("event") == "eval"]
    assert order == ["step", "step", "eval", "step", "eval"]


def test_eval_leaves_training_bit_equal(tmp_path, capsys):
    """A run with evaluation after every step and at each epoch's end (8
    eval passes over 2 epochs of 3 steps) logs the same losses, bit for
    bit, as the same run without a validation file, and ends with the same
    weights: the eval pass draws no dropout seed and leaves the model in
    training mode."""
    with_eval = train(_eval_args(tmp_path, "--evaluation-steps", "1", "--num-epochs", "2",
                                 "--output-dir", str(tmp_path / "a")))
    assert sum(x.get("event") == "eval" for x in _lines(capsys)) == 2 * (3 + 1)
    assert with_eval.model.training
    from distributed_llms_example_tpu_torch.ops import fused_dropout, mha

    drawn = []
    with pytest.MonkeyPatch.context() as mp:
        for mod in (fused_dropout, mha):
            mp.setattr(mod, "next_seed", lambda: drawn.append(1) or 0)
        assert set(with_eval.evaluate(1, step=6)) >= {"rouge1", "epoch"}
    assert drawn == [] and with_eval.model.training
    capsys.readouterr()
    without = train(_eval_args(tmp_path, "--evaluation-steps", "1", "--num-epochs", "2",
                               "--output-dir", str(tmp_path / "b"), val=False))
    assert not any(x.get("event") == "eval" for x in _lines(capsys))
    a = [float(m["loss"]) for m in with_eval.history]
    b = [float(m["loss"]) for m in without.history]
    assert len(a) == 6 and a == b
    sa, sb = with_eval.model.state_dict(), without.model.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)


@pytest.mark.parametrize("how", ["none", "missing"])
def test_no_val_file_means_no_eval(tmp_path, capsys, how):
    extra = [] if how == "none" else ["--val-file", str(tmp_path / "absent.json")]
    trainer = train(_args(_write(tmp_path, 8), "--evaluation-steps", "1", *extra))
    assert trainer.val_ds is None and trainer.evaluate() == {}
    assert not any(x.get("event") == "eval" for x in _lines(capsys))


@pytest.mark.parametrize("flag", ["--grad-accum-steps", "--gradient-accumulation-steps",
                                  "--gradient_accumulation_steps"])
def test_gradient_accumulation_spellings_parse_as_jax(flag):
    """The reference's name, as valohai.yaml passes it, in both spellings:
    each lands on grad_accum_steps, as in the JAX CLI."""
    from distributed_llms_example_tpu.launch.cli import build_parser as jax_parser

    got = build_train_parser().parse_args([flag, "4"])
    want = jax_parser().parse_args([flag, "4"])
    assert got.grad_accum_steps == want.grad_accum_steps == 4


def test_dry_run_prints_the_config_and_touches_nothing(tmp_path, capsys):
    """``--dry-run`` prints the resolved TrainConfig and exits 0 before any
    device or dataset: ``--device cuda`` on a machine without one and a
    train file that does not exist."""
    import dataclasses

    from distributed_llms_example_tpu_torch.core.config import TrainConfig

    assert main(["--dry-run", "--train-file", str(tmp_path / "missing.json"),
                 "--gradient-accumulation-steps", "2", "--profile-steps", "4:5"]) == 0
    printed = json.loads(capsys.readouterr().out)
    assert set(printed) == {f.name for f in dataclasses.fields(TrainConfig)}
    assert (printed["grad_accum_steps"], printed["profile_steps"], printed["device"]) \
        == (2, "4:5", "cuda")
    assert not (tmp_path / "missing.json").exists()


def test_lint_and_the_telemetry_flags_parse(capsys):
    p = build_train_parser()
    for mode in ("off", "warn", "strict"):
        assert p.parse_args(["--lint", mode]).lint == mode
    assert p.parse_args([]).lint == "warn"
    with pytest.raises(SystemExit):
        p.parse_args(["--lint", "loud"])
    args = p.parse_args(["--profile-dir", "pd", "--profile-steps", "3", "--profile-trigger", "t",
                         "--profile-on-anomaly", "--obs-gauges", "on", "--obs-peak-tflops",
                         "197", "--hbm-budget-gib", "16"])
    assert (args.profile_dir, args.profile_steps, args.profile_trigger, args.profile_on_anomaly,
            args.obs_gauges, args.obs_peak_tflops, args.hbm_budget_gib) == (
        "pd", "3", "t", True, "on", 197.0, 16.0)
    with pytest.raises(SystemExit):  # a window that ends before it starts
        train(["--dry-run", "--profile-steps", "5:2"])
    assert "--profile-steps window" in capsys.readouterr().err
