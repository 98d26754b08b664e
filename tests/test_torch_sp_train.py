"""Sequence parallelism (ring attention, ``ops/ring_attention.py``) and
its composition with data and tensor parallelism in the port's train CLI,
on gloo ranks of the CPU, against the JAX ``Trainer`` on a CPU mesh of the
same layout from the same HF directory of the JAX init: ``llama-test``
under ``--mesh sequence=2`` and ``data=2,sequence=2,tensor=2`` (eight
ranks, with ``--remat``), each step's loss and grad norm and every final
parameter within 1e-4 (as ``test_torch_dp_train.py`` holds FSDP), the attention ring's
choice logged; with bucket widths the axis does not divide (a padding
multiple of 15) the lengths stay whole, plain attention runs, a
``sequence_sharding_disabled`` line says why, and the trajectory is the
sharded one's (padding changes no masked sum) within 1e-4.  With residual
dropout 0.1 (a LLaMA of width 128, whose rows the JAX fused dropout
kernel tiles; both sides fed one seed stream) under ``sequence=2``: each
rank folds its sequence index after the batch axes, as the JAX shards do,
within 1e-4."""

import itertools
import json

import pytest

from torch_dist_helpers import (
    assert_matches,
    cli_argv,
    hf_dir,
    jax_train,
    json_lines,
    llama_dir,
    records,
    spawn,
)

LAYOUTS = [("sequence=2", 2), ("data=2,sequence=2,tensor=2", 8)]
# the eight-rank run also checkpoints every block (--remat): the recompute
# replays its ring hops and tensor all-reduces in the backward
REMAT = {"data=2,sequence=2,tensor=2": True}


@pytest.fixture(scope="module")
def llama(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sp")
    recs = records(24, seed=5)
    path = tmp / "train.json"
    path.write_text(json.dumps(recs))
    return {"tmp": tmp, "ckpt": hf_dir(tmp / "hf", "llama-test"), "records": recs,
            "train_file": path}


@pytest.fixture(scope="module")
def jax_runs(llama):
    out = {}
    for layout, _ in LAYOUTS:
        hist, params, _ = jax_train(llama["ckpt"], llama["records"], layout,
                                    llama["tmp"] / f"jax-{layout}",
                                    remat=REMAT.get(layout, False))
        out[layout] = (hist, params)
    return out


@pytest.mark.parametrize("layout,n", LAYOUTS)
def test_cli_matches_jax_trainer_on_the_same_mesh(llama, jax_runs, tmp_path, layout, n):
    argv = cli_argv(llama["ckpt"], llama["train_file"], tmp_path / "out", "--mesh", layout,
                    *(["--remat"] if REMAT.get(layout) else []))
    _, logs, result = spawn({"argv": argv}, n, tmp_path)
    assert_matches(result, *jax_runs[layout])
    lines = json_lines(logs[0])
    assert {"event": "attention_impl", "impl": "ring",
            "reason": "auto: sequence-parallel mesh"} in lines
    assert not [x for x in lines if x.get("event") == "sequence_sharding_disabled"]


def test_undivided_widths_keep_whole_lengths(llama, jax_runs, tmp_path):
    """``--pad-to-multiple 15``: widths of 15, 30, 45, 60 and 64 do not all
    divide by 2, so both sequence ranks hold whole rows and run plain
    attention; the rows meet over data alone, each token counted once."""
    argv = cli_argv(llama["ckpt"], llama["train_file"], tmp_path / "out", "--mesh",
                    "sequence=2", pad_to_multiple=15)
    _, logs, result = spawn({"argv": argv}, 2, tmp_path)
    assert_matches(result, *jax_runs["sequence=2"])
    lines = json_lines(logs[0])
    (off,) = [x for x in lines if x.get("event") == "sequence_sharding_disabled"]
    assert "not all divisible by sequence=2" in off["reason"]
    assert not [x for x in lines if x.get("impl") == "ring"]


# a LLaMA whose width the JAX fused dropout kernel tiles (128 lanes); no
# probs dropout: neither package's ring draws a mask
DROPOUT_LLAMA = dict(vocab_size=256, hidden_size=128, intermediate_size=256,
                     num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=4,
                     max_position_embeddings=128)
# one seed a dropout call of a step (2 layers x 2 residual sites): each
# step's k-th call takes the k-th seed on both sides
SEEDS = [914237, -120394871, 55501, 2019283746]


def test_residual_dropout_matches_jax_with_folded_seeds(llama, tmp_path):
    import dataclasses

    import jax.numpy as jnp

    from distributed_llms_example_tpu.models import registry as jreg
    from distributed_llms_example_tpu.ops import fused_dropout as jfd

    ckpt = llama_dir(tmp_path / "hf", **DROPOUT_LLAMA)
    mp = pytest.MonkeyPatch()
    parse = jreg._HF_CONFIG_PARSERS["llama"]
    mp.setitem(jreg._HF_CONFIG_PARSERS, "llama",
               lambda c: dataclasses.replace(parse(c), dropout_rate=0.1))
    stream = itertools.cycle(SEEDS)
    mp.setattr(jfd, "seed_from_key", lambda key: jnp.int32(next(stream)))
    try:
        hist, params, _ = jax_train(ckpt, llama["records"], "sequence=2", tmp_path / "jax",
                                    dropout_impl="fused")
    finally:
        mp.undo()
        jfd.set_default_impl("auto")
    argv = cli_argv(ckpt, llama["train_file"], tmp_path / "out", "--mesh", "sequence=2")
    spec = {"argv": argv, "seed_cycle": SEEDS,
            "llama_dropout": {"dir": ckpt, "rate": 0.1, "attention_impl": "auto"}}
    _, _, result = spawn(spec, 2, tmp_path)
    assert_matches(result, hist, params)
