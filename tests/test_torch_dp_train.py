"""Data-parallel and FSDP training of the port over a gloo process group
on the CPU (2 or 4 ranks, one subprocess each, ``--device cpu``) against
the JAX ``Trainer`` on a CPU mesh of the same layout, from the same HF
directory of the JAX init, records and flags: ``llama-test`` (``--remat
--fused-ce``) under ``--mesh data=2``, ``fsdp=2`` and ``data=2,fsdp=2``,
each step's loss and grad norm and every final parameter within 1e-4
(the tolerance of the single-process CLI comparison); with gradient
accumulation and the health numerics under ``fsdp=2`` too.  With residual and
attention-probs dropout 0.1 (a LLaMA of width 128, so the JAX fused
dropout kernel and flash attention serve it, both pinned as the JAX
tests pin them; both sides fed one seed stream), the same within 1e-4,
and a port whose ranks fold no mesh position into the seeds must miss
it.  The eval pass over two ranks (``--val-file``, ``data=2`` and
``fsdp=2``): its ROUGE means
within 1e-9 of the mean over the ranks of JAX ROUGE on each rank's rows,
generated by the JAX package from the port's exported weights.  SIGTERM
to one rank of two: both stop and save at the same step, and the resumed
run's trajectory equals the JAX one.  BART and T5 are in
``test_torch_dp_seq2seq.py``."""

import json

import numpy as np
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

LAYOUTS = [("data=2", 2), ("fsdp=2", 2), ("data=2,fsdp=2", 4)]


@pytest.fixture(scope="module")
def llama(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("llama")
    recs = records(24, seed=5)
    path = tmp / "train.json"
    path.write_text(json.dumps(recs))
    return {"tmp": tmp, "ckpt": hf_dir(tmp / "hf", "llama-test"), "records": recs,
            "train_file": path}


@pytest.fixture(scope="module")
def jax_llama_runs(llama):
    """The JAX runs, one a layout (``--remat --fused-ce``)."""
    out = {}
    for layout, _ in LAYOUTS:
        hist, params, _ = jax_train(llama["ckpt"], llama["records"], layout,
                                    llama["tmp"] / f"jax-{layout}", remat=True, fused_ce=True)
        out[layout] = (hist, params)
    return out


@pytest.mark.parametrize("layout,n", LAYOUTS)
def test_llama_matches_jax_trainer_on_the_same_mesh(llama, jax_llama_runs, tmp_path, layout, n):
    argv = cli_argv(llama["ckpt"], llama["train_file"], tmp_path / "out", "--remat",
                    "--fused-ce", "--mesh", layout)
    _, logs, result = spawn({"argv": argv}, n, tmp_path)
    hist, params = jax_llama_runs[layout]
    assert_matches(result, hist, params)
    lines = json_lines(logs[0])
    (report,) = [x for x in lines if x.get("event") == "device_report"]
    assert report["process_count"] == n and report["backend"] == "gloo"
    # only process 0 prints
    assert not json_lines(logs[1])


def test_accumulation_and_health_over_fsdp(llama, jax_llama_runs, tmp_path):
    """``--grad-accum-steps 2`` under ``fsdp=2``: the earlier microbatch's
    backward skips the gradient sync, and the sums being additive over
    rows, the trajectory is the JAX run's without accumulation within
    1e-4.  ``--health on``: kernel 8's per-leaf sums are all-reduced over
    the shards, so step 1's param norm is the whole init's (one rank's
    shards alone would read about 1/sqrt(2) of it), and the verdict is
    agreed without an anomaly."""
    import torch

    from distributed_llms_example_tpu_torch.models.registry import load_model

    argv = cli_argv(llama["ckpt"], llama["train_file"], tmp_path / "out", "--remat",
                    "--fused-ce", "--mesh", "fsdp=2", "--grad-accum-steps", "2",
                    "--health", "on")
    _, logs, result = spawn({"argv": argv}, 2, tmp_path)
    hist, params = jax_llama_runs["fsdp=2"]
    assert_matches(result, hist, params)
    init = load_model(llama["ckpt"], device="cpu", train=True).module
    want = float(torch.sqrt(sum(torch.sum(p.detach().double() ** 2) for p in init.parameters())))
    got = result["history"][0]["param_norm"]
    assert abs(got - want) <= 1e-6 * want, (got, want)
    assert all(h["nonfinite_count"] == 0 for h in result["history"])
    assert not [x for x in json_lines(logs[0]) if x.get("event") == "obs_anomaly"]


# a LLaMA whose width the JAX fused dropout kernel tiles (128 lanes)
DROPOUT_LLAMA = dict(vocab_size=256, hidden_size=128, intermediate_size=256,
                     num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=4,
                     max_position_embeddings=128, attn_dropout_rate=0.1)
# one seed a dropout call of a step (2 layers x (probs + 2 residual)): the
# cycle restarts every step, so each step's k-th call takes the k-th seed on
# both sides, however often the JAX step is traced
SEEDS = [914237, -120394871, 55501, 2019283746, -7, 31337]


@pytest.fixture(scope="module")
def dropout_runs(llama, tmp_path_factory):
    """The JAX runs with residual and probs dropout 0.1, one a 2-rank
    layout: flash attention and the fused dropout kernel (interpret mode),
    every ``seed_from_key`` of a traced step taking the next of ``SEEDS``
    in trace order, as every port rank draws them."""
    import dataclasses
    import itertools

    import jax.numpy as jnp

    from distributed_llms_example_tpu.models import registry as jreg
    from distributed_llms_example_tpu.ops import fused_dropout as jfd

    from torch_dist_helpers import llama_dir

    tmp = tmp_path_factory.mktemp("dropout")
    ckpt = llama_dir(tmp / "hf", **DROPOUT_LLAMA)
    mp = pytest.MonkeyPatch()
    parse = jreg._HF_CONFIG_PARSERS["llama"]
    mp.setitem(jreg._HF_CONFIG_PARSERS, "llama",
               lambda c: dataclasses.replace(parse(c), dropout_rate=0.1))
    stream = itertools.cycle(SEEDS)
    mp.setattr(jfd, "seed_from_key", lambda key: jnp.int32(next(stream)))
    out = {}
    try:
        for layout in ("data=2", "fsdp=2"):
            hist, params, _ = jax_train(ckpt, llama["records"], layout, tmp / f"jax-{layout}",
                                        fused_ce=True, attention_impl="flash",
                                        dropout_impl="fused")
            out[layout] = (hist, params)
    finally:
        mp.undo()
        jfd.set_default_impl("auto")
    return ckpt, out


def _dropout_spec(llama, ckpt, out_dir, layout, **extra):
    argv = cli_argv(ckpt, llama["train_file"], out_dir, "--mesh", layout)
    return {"argv": argv, "seed_cycle": SEEDS,
            "llama_dropout": {"dir": ckpt, "rate": 0.1, "attention_impl": "flash",
                              "fused_ce": True}, **extra}


@pytest.mark.parametrize("layout", ["data=2", "fsdp=2"])
def test_dropout_matches_jax_with_folded_seeds(llama, dropout_runs, tmp_path, layout):
    ckpt, runs = dropout_runs
    _, _, result = spawn(_dropout_spec(llama, ckpt, tmp_path / "out", layout), 2, tmp_path)
    hist, params = runs[layout]
    assert_matches(result, hist, params)


def test_unfolded_seeds_miss_the_jax_run(llama, dropout_runs, tmp_path):
    """The negative control: ranks that use the drawn seeds as they are
    drop the same positions of their rows, not the JAX shards' masks."""
    ckpt, runs = dropout_runs
    _, _, result = spawn(_dropout_spec(llama, ckpt, tmp_path / "out", "data=2", no_fold=True),
                         2, tmp_path)
    hist, params = runs["data=2"]
    with pytest.raises(AssertionError):
        assert_matches(result, hist, params)


def _jax_eval_rows(ckpt, val, gb):
    """The JAX package's greedy continuation of every eval row (the eval's
    batches: ``gb`` rows in corpus order, the last wrapped around, each
    padded to its batch's bucket) from the weights in ``ckpt``, as text."""
    import jax

    from distributed_llms_example_tpu.core.config import MeshConfig
    from distributed_llms_example_tpu.core.mesh import build_mesh
    from distributed_llms_example_tpu.data.batching import bucket_len, pad_2d
    from distributed_llms_example_tpu.data.dataset import CausalLMDataset
    from distributed_llms_example_tpu.data.tokenizer import ByteTokenizer
    from distributed_llms_example_tpu.evaluation.evaluate import Evaluator
    from distributed_llms_example_tpu.models.registry import load_model as jax_load_model

    from torch_dist_helpers import COMMON

    jlm = jax_load_model(str(ckpt))
    ev = Evaluator(jlm.module, jlm.config, ByteTokenizer(),
                   build_mesh(MeshConfig(data=1), devices=jax.devices()[:1]), num_beams=1,
                   max_new_tokens=COMMON["eval_max_new_tokens"], is_seq2seq=False)
    ds = CausalLMDataset(val, ByteTokenizer(), max_length=COMMON["max_source_length"],
                         max_target_length=COMMON["max_target_length"])
    n, preds, refs = len(ds), [], []
    for start in range(0, n, gb):
        idx = [(start + i) % n for i in range(gb)]
        width = bucket_len(max(len(ds[i].prompt_ids) for i in idx), COMMON["pad_to_multiple"],
                           COMMON["max_source_length"])
        ids = pad_2d([ds[i].prompt_ids for i in idx], width, jlm.config.pad_token_id)
        mask = np.zeros_like(ids)
        for r, i in enumerate(idx):
            mask[r, : min(len(ds[i].prompt_ids), width)] = 1
        preds.append(ev._decode_batch(np.asarray(ev._generate(jlm.params, ids, mask))))
        refs.append([ByteTokenizer().decode([t for t in ds[i].target_ids
                                             if t != jlm.config.eos_token_id]) for i in idx])
    return preds, refs


@pytest.mark.parametrize("layout", ["data=2", "fsdp=2"])
def test_eval_is_the_mean_of_the_ranks_rouge(llama, tmp_path, layout):
    """Two ranks (``data=2``, or ``fsdp=2``: the generation's forwards
    gather the shards) each generate and score their rows of every
    eval batch (the last one wrapped and trimmed); the epoch-end eval's
    means equal, within 1e-9, the float32 mean over the ranks of JAX ROUGE
    on each rank's rows, generated by the JAX package from the port's
    exported weights.  The run's learning rate is 0, so those are the
    init's, from which the JAX package first continues every prompt: half
    the references are those continuations, so each rank's ROUGE is its
    own and its ROUGE-1 above 0."""
    from distributed_llms_example_tpu.evaluation import rouge

    gb, per, ranks = 4, 2, 2
    val = [{"dialogue": r["dialogue"][:30], "summary": r["summary"]} for r in records(10, 9)]
    first, _ = _jax_eval_rows(llama["ckpt"], val, gb)
    flat = [p for batch in first for p in batch]
    for i in range(0, len(val), 2):
        val[i]["summary"] = flat[i]
    (tmp_path / "val.json").write_text(json.dumps(val))
    argv = cli_argv(llama["ckpt"], llama["train_file"], tmp_path / "out", "--mesh", layout,
                    "--val-file", str(tmp_path / "val.json"), "--eval-batch-size", str(gb),
                    learning_rate=0.0)
    _, logs, result = spawn({"argv": argv}, ranks, tmp_path)
    (event,) = [x for x in json_lines(logs[0]) if x.get("event") == "eval"]
    got = result["result"]["final_eval"]

    preds, refs = _jax_eval_rows(tmp_path / "out" / "model", val, gb)
    mine = [([], []) for _ in range(ranks)]
    for b, (p, r) in enumerate(zip(preds, refs)):
        for rank in range(ranks):
            valid = int(np.clip(min(gb, len(val) - b * gb) - rank * per, 0, per))
            mine[rank][0].extend(p[rank * per: rank * per + valid])
            mine[rank][1].extend(r[rank * per: rank * per + valid])
    per_rank = [rouge.compute(p, r, use_stemmer=True) for p, r in mine]
    keys = sorted(per_rank[0])
    table = np.asarray([[s[k] for k in keys] for s in per_rank], np.float32)
    assert (table[:, keys.index("rouge1")] > 0).all(), table
    assert len({tuple(row) for row in table}) == ranks, table
    want = np.mean(table, axis=0)
    assert sorted(k for k in got if k != "epoch") == keys
    for k, w in zip(keys, want):
        assert abs(got[k] - float(w)) <= 1e-9, (k, got[k], float(w))
        assert abs(event[k] - float(w)) <= 1e-6
    assert [len(p) for p, _ in mine] == [6, 4]


def test_sigterm_to_one_rank_stops_both_at_one_step_and_resumes(llama, tmp_path):
    """``--chaos sigterm@2`` on rank 1 alone (``fsdp=2``): the preemption
    flag is agreed at the log cadence, both ranks save step 2 (each its
    shard file, one manifest over both), dump their own flight recorders
    and stop; the rerun resumes from
    it, and the six losses and grad norms, and the final parameters, are
    within 1e-4 of an uninterrupted JAX run on the same mesh."""
    out = tmp_path / "out"
    spec = {"argv": cli_argv(llama["ckpt"], llama["train_file"], out, "--mesh", "fsdp=2",
                             num_epochs=2),
            "rank_argv": {"1": ["--chaos", "sigterm@2"]}}
    _, logs, first = spawn(spec, 2, tmp_path, name="first")
    assert first["result"]["preempted"] and first["result"]["steps"] == 2
    assert any(x.get("event") == "preempted" and x["step"] == 2 for x in json_lines(logs[0]))
    step_dir = out / "checkpoints" / "2"
    assert sorted(p.name for p in step_dir.iterdir()) == [
        "meta.json", "state-r0.safetensors", "state-r1.safetensors"]
    manifest = json.loads((out / "checkpoints" / "integrity-2.json").read_text())
    assert sorted(manifest["files"]) == sorted(p.name for p in step_dir.iterdir())
    # each rank dumped its own flight recorder
    for rank in (0, 1):
        bundle = json.loads((out / "obs" / f"flight-recorder-p00{rank}.json").read_text())
        assert bundle["process_index"] == rank and bundle["reason"] == "preemption"
    spec = {"argv": cli_argv(llama["ckpt"], llama["train_file"], out, "--mesh", "fsdp=2",
                             resume=True, num_epochs=2)}
    _, logs, second = spawn(spec, 2, tmp_path, name="second")
    assert any(x.get("event") == "resumed" and x["step"] == 2 for x in json_lines(logs[0]))
    hist, params, _ = jax_train(llama["ckpt"], llama["records"], "fsdp=2", tmp_path / "jax",
                                num_epochs=2)
    both = {"history": first["history"] + second["history"], "params": second["params"]}
    assert_matches(both, hist, params)
