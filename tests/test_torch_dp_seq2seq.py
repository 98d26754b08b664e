"""BART (the reference recipe) and T5 (the learned-bias path: kernel 4's
gradient of the relative-position table, summed over the ranks by the
gradient reduction) trained by the port over a gloo process group on the
CPU, 2 ranks under ``--mesh data=2`` and ``fsdp=2``, against the JAX
``Trainer`` on a 2-device CPU mesh of the same layout: from one HF
directory of the JAX init with dropout off, the same records and flags,
each step's loss and grad norm and every final parameter within 1e-4;
the epoch-end eval runs over both ranks."""

import json

import pytest

from torch_dist_helpers import (
    assert_matches,
    cli_argv,
    hf_dir,
    jax_train,
    json_lines,
    records,
    spawn,
)

MODELS = ("bart-test", "t5-test")
LAYOUTS = ("data=2", "fsdp=2")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Per model: its HF directory, the records file and the JAX run of
    each layout."""
    tmp = tmp_path_factory.mktemp("seq2seq")
    recs = records(24, seed=3)
    path = tmp / "train.json"
    path.write_text(json.dumps(recs))
    out = {}
    for name in MODELS:
        ckpt = hf_dir(tmp / name, name, dropout_rate=0.0)
        for layout in LAYOUTS:
            hist, params, _ = jax_train(ckpt, recs, layout, tmp / f"jax-{name}-{layout}")
            out[name, layout] = (ckpt, path, hist, params)
    return out


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("name", MODELS)
def test_seq2seq_matches_jax_trainer_on_the_same_mesh(runs, tmp_path, name, layout):
    ckpt, path, hist, params = runs[name, layout]
    argv = cli_argv(ckpt, path, tmp_path / "out", "--mesh", layout, "--val-file", str(path),
                    "--eval-batch-size", "4")
    _, logs, result = spawn({"argv": argv}, 2, tmp_path)
    assert_matches(result, hist, params)
    # the eval ran over both ranks (under fsdp=2 the encoder, each layer's
    # cross-attention K/V and every decode step gather their shards)
    (event,) = [x for x in json_lines(logs[0]) if x.get("event") == "eval"]
    assert all(0.0 <= event[k] <= 1.0 for k in ("rouge1", "rouge2", "rougeL", "rougeLsum"))
    if name == "t5-test":  # the relative-position tables trained on every rank's rows
        assert {"encoder.relative_attention_bias.weight",
                "decoder.relative_attention_bias.weight"} <= set(params)
