"""Mixtral in the port (a LLaMA whose blocks hold routed experts,
``ops/moe.py``) against the JAX package on the CPU, fp32, ``mixtral-test``
(2 layers, width 64, GQA 4/2, 4 experts top-2, capacity factor 1.25, aux
weight 0.01), the same weights carried across by ``models/from_jax.py``:

- ``from_jax`` covers every parameter (router transposed, the stacked
  experts as they are);
- uncached logits (the capacity trade, drops included) within 1e-5 of
  JAX's, on the plain and the kernel route; a cached prefill + 3 decode
  steps within 1e-5 of an uncached no-drop pass over the same tokens;
- the engine's greedy tokens, flat and paged, equal to the JAX engine's;
- the causal loss sums with the aux loss (unfused, fused CE, remat full
  and dots) within 1e-5 relative of JAX ``make_loss_fn``'s, every gradient
  within 1e-5 of the largest entry of JAX's;
- the FLOP gauge equal to a hand count at the capacity-padded shape;
- a tiny ``transformers.MixtralForCausalLM`` saved under ``tmp_path``:
  the port's load equals the JAX package's exactly and its logits are
  within 1e-4 of HF's; the port's export reloads bit-equal and loads in
  ``transformers`` with no missing or unexpected key;
- ``train --moe-capacity-factor 1.25`` on that directory: the factor
  reaches the loaded config, 2 steps' losses are within 1e-4 of the JAX
  ``Trainer``'s with the same flag, and the causal eval runs;
- ``serve-router`` and ``serve-loadgen`` serve ``mixtral-test`` with
  ``serve``'s tokens;
- the train CLI under ``--mesh data=2`` and ``fsdp=2`` (two gloo ranks,
  capacity 1.25, each rank's MoE layers routing the global batch) within
  1e-5 relative of the JAX ``Trainer`` on one device (the set-up of JAX
  ``test_moe_sharded_step_equals_single_device``, which holds a sharded
  step to one device) in each step's loss and grad norm, and every final
  parameter within 1e-5 of its leaf's largest entry.
"""

import dataclasses
import functools
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import transformers

from distributed_llms_example_tpu.core.config import CheckpointConfig as JaxCheckpointConfig
from distributed_llms_example_tpu.core.config import MeshConfig
from distributed_llms_example_tpu.core.config import TrainConfig as JaxTrainConfig
from distributed_llms_example_tpu.models.registry import load_model as jax_load_model
from distributed_llms_example_tpu.serving.engine import (
    ServeConfig as JaxServeConfig,
    ServingEngine as JaxServingEngine,
)
from distributed_llms_example_tpu.train import step as jstep
from distributed_llms_example_tpu_torch.evaluation.generation import causal_prefill
from distributed_llms_example_tpu_torch.launch import cli
from distributed_llms_example_tpu_torch.launch.cli import train
from distributed_llms_example_tpu_torch.models.export import save_hf_checkpoint
from distributed_llms_example_tpu_torch.models.from_jax import (
    blocks_state_dict_from_jax,
    load_jax_params,
)
from distributed_llms_example_tpu_torch.models.registry import load_model
from distributed_llms_example_tpu_torch.obs.gauges import count_step_flops
from distributed_llms_example_tpu_torch.serving.engine import ServeConfig, ServingEngine
from distributed_llms_example_tpu_torch.train.step import causal_loss_sums

ATOL, HF_ATOL, LOSS_RTOL, GRAD_RTOL = 1e-5, 1e-4, 1e-5, 1e-5
NAME = "mixtral-test"


@pytest.fixture(autouse=True)
def _no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@pytest.fixture(scope="module")
def jax_mixtral():
    lm = jax_load_model(NAME)
    return lm, jax.device_get(lm.init_params(0))


def _port(params, **kw):
    tlm = load_model(NAME, device="cpu", **kw)
    load_jax_params(tlm.module, params)
    return tlm


def _batch(B=4, S=24, seed=0):
    rng = np.random.RandomState(seed)
    ids = rng.randint(4, 256, (B, S)).astype(np.int32)
    lens = np.array([S, 17, 9, 20])[:B]
    mask = (np.arange(S)[None, :] < lens[:, None]).astype(np.int32)
    labels = np.where(mask > 0, ids, -100).astype(np.int32)
    labels[:, :5] = -100  # the prompt
    return {"input_ids": ids, "attention_mask": mask, "labels": labels}


def _t(x):
    return torch.tensor(np.asarray(x), dtype=torch.long)


def test_from_jax_covers_every_mixtral_parameter(jax_mixtral):
    _, params = jax_mixtral
    sd = blocks_state_dict_from_jax(params)
    own = load_model(NAME, device="cpu").module.state_dict()
    assert set(sd) == set(own)
    assert tuple(sd["blocks.0.mlp.gate_proj"].shape) == (4, 64, 128)
    assert tuple(sd["blocks.1.mlp.down_proj"].shape) == (4, 128, 64)
    np.testing.assert_array_equal(sd["blocks.1.mlp.router.weight"].numpy(),
                                  params["block_1"]["mlp"]["router"]["kernel"].T)


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_logits_match_jax(jax_mixtral, impl):
    lm, params = jax_mixtral
    b = _batch()
    want = lm.module.apply({"params": params}, jnp.asarray(b["input_ids"]),
                           jnp.asarray(b["attention_mask"]))
    tlm = _port(params, attention_impl=impl)
    with torch.no_grad():
        got, aux = tlm.module(_t(b["input_ids"]), _t(b["attention_mask"]), return_aux=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)
    _, mut = lm.module.apply({"params": params}, jnp.asarray(b["input_ids"]),
                             jnp.asarray(b["attention_mask"]), mutable=["losses"])
    leaves = jax.tree.leaves(mut["losses"])
    assert len(leaves) == 2
    assert abs(float(aux) - float(sum(leaves) / len(leaves))) <= 1e-6


def test_cached_decode_equals_uncached_no_drop(jax_mixtral):
    """A cached prefill + 3 greedy decode steps route no-drop, so their
    logits equal an uncached pass over the same tokens with capacity -1;
    the same pass at a capacity that drops (0.5) does not."""
    _, params = jax_mixtral
    model = _port(params).module
    b = _batch(seed=1)
    ids, mask = _t(b["input_ids"]), _t(b["attention_mask"])
    lens = mask.sum(1)
    with torch.no_grad():
        cache, full_mask, lengths, first = causal_prefill(model, ids, mask, 3)
        W = ids.shape[1]
        toks, steps = [first.argmax(-1)], [first]
        for t in range(2):
            full_mask[:, W + t] = 1
            logits = model(toks[-1][:, None], full_mask, positions=(lengths + t)[:, None],
                           cache=cache, cache_positions=torch.full_like(lengths, W + t))[:, -1]
            steps.append(logits)
            toks.append(logits.argmax(-1))
    # the same tokens, each row's continuation right after its prompt
    seqs = torch.zeros(ids.shape[0], W + 2, dtype=torch.long)
    for r in range(ids.shape[0]):
        n = int(lens[r])
        seqs[r, :n] = ids[r, :n]
        seqs[r, n:n + 2] = torch.stack([toks[0][r], toks[1][r]])
    seq_mask = (torch.arange(W + 2)[None] < (lens + 2)[:, None]).long()
    rows = torch.arange(ids.shape[0])
    for cf, agree in ((-1.0, True), (0.5, False)):
        ref = _port(params, moe_capacity_factor=cf).module
        with torch.no_grad():
            full = ref(seqs, seq_mask)
        want = torch.stack([full[rows, lens - 1 + t] for t in range(3)])
        err = float((torch.stack(steps) - want).abs().max())
        assert (err <= ATOL) is agree, (cf, err)


@pytest.mark.parametrize("extra", [{}, {"paged_kv": True}], ids=["flat", "paged"])
def test_engine_tokens_match_jax_engine(jax_mixtral, extra):
    lm, params = jax_mixtral
    kw = dict(max_slots=2, prefill_batch=2, max_new_tokens=8, max_source_length=16,
              log_every_steps=0, request_spans=False)
    rng = np.random.RandomState(7)
    reqs = [list(rng.randint(4, 120, rng.randint(3, 14))) for _ in range(6)]
    want = JaxServingEngine(lm.module, lm.config, None, JaxServeConfig(**kw),
                            is_seq2seq=False).generate(params, reqs)
    tlm = _port(params)
    eng = ServingEngine(tlm.module, tlm.config, ServeConfig(**kw, **extra), is_seq2seq=False,
                        device="cpu")
    assert eng.generate(reqs) == want
    if eng.paged:
        assert eng.pool.blocks_in_use == 0


def _rel_close(got, want, rtol, what):
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(np.asarray(got) - np.asarray(want)).max())
    assert err <= rtol * scale, (what, err, scale)


@functools.lru_cache(maxsize=None)
def _jax_loss(params_key):
    """JAX ``make_loss_fn``'s (loss sum, tokens, port-named gradients) of
    ``mixtral-test`` on ``_batch(seed=2)`` (remat and the fused CE change
    none of them beyond rounding)."""
    jlm = jax_load_model(NAME)
    params = jax.device_get(jlm.init_params(params_key))
    assert jlm.config.moe_aux_weight == 0.01
    batch = _batch(seed=2)
    loss_fn = jax.jit(jax.value_and_grad(
        lambda p, b: jstep.make_loss_fn(jlm.module, jlm.config, is_seq2seq=False)(p, b),
        has_aux=True))
    (jl, jt), jgrads = loss_fn(params, {k: jnp.asarray(v) for k, v in batch.items()})
    return float(jl), float(jt), blocks_state_dict_from_jax(jax.device_get(jgrads))


@pytest.mark.parametrize("variant", ["unfused", "fused_ce", "remat_full", "remat_dots"])
def test_loss_sums_with_aux_match_jax(jax_mixtral, variant):
    _, params = jax_mixtral
    kw = {"fused_ce": variant == "fused_ce"}
    if variant.startswith("remat"):
        kw.update(remat=True, remat_policy=variant.split("_")[1])
    jl, jt, jgrads = _jax_loss(0)
    batch = _batch(seed=2)
    model = _port(params, train=True, **kw).module
    tl, tt = causal_loss_sums(model, {k: _t(v) for k, v in batch.items()})
    tl.backward()
    np.testing.assert_allclose(float(tl.detach()), jl, rtol=LOSS_RTOL)
    assert float(tt) == jt
    for n, p in model.named_parameters():
        _rel_close(p.grad.numpy(), jgrads[n].numpy(), GRAD_RTOL, n)
    # the aux term is in: without it the sum moves
    plain = dataclasses.replace(model.config, moe_aux_weight=0.0)
    model.config = plain
    with torch.no_grad():
        bare, _ = causal_loss_sums(model, {k: _t(v) for k, v in batch.items()})
    assert abs(float(bare) - jl) > 1e-3 * float(tt)


def test_flop_gauge_counts_the_capacity_padded_experts():
    lm = load_model(NAME, device="cpu", train=True)
    cfg = lm.config
    rows, S = 4, 24
    flops = count_step_flops(lm.module, global_batch=rows, src_len=S, tgt_len=0,
                             is_seq2seq=False)
    h, f, L, E, V = (cfg.hidden_size, cfg.intermediate_size, cfg.num_hidden_layers,
                     cfg.num_experts, cfg.vocab_size)
    kv = cfg.head_dim * cfg.num_key_value_heads
    n = rows * S
    cap = math.ceil(cfg.num_experts_per_tok * n / E * cfg.moe_capacity_factor)
    per_layer = 2 * n * (2 * h * h + 2 * h * kv + h * E) + 3 * 2 * E * cap * h * f \
        + 4 * rows * S * S * h
    assert flops == 3 * (L * per_layer + 2 * n * h * V)


def _hf_mixtral_dir(tmp_path):
    cfg = transformers.MixtralConfig(
        vocab_size=256, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, num_local_experts=4,
        num_experts_per_tok=2, max_position_embeddings=128, rope_theta=1e6,
        router_aux_loss_coef=0.02, tie_word_embeddings=False)
    torch.manual_seed(0)
    hf = transformers.MixtralForCausalLM(cfg).eval()
    path = tmp_path / "hf-mixtral"
    hf.save_pretrained(path, safe_serialization=True)
    return hf, str(path)


def test_hf_mixtral_loads_and_exports(tmp_path):
    hf, path = _hf_mixtral_dir(tmp_path)
    lm = load_model(path, device="cpu")
    cfg = lm.config
    assert lm.family == "llama" and not lm.is_seq2seq
    assert (cfg.num_experts, cfg.num_experts_per_tok, cfg.moe_capacity_factor,
            cfg.moe_aux_weight, cfg.rope_theta) == (4, 2, -1.0, 0.02, 1e6)
    jlm = jax_load_model(path)
    want_sd = blocks_state_dict_from_jax(jax.device_get(jlm.params))
    got_sd = lm.module.state_dict()
    assert set(want_sd) == set(got_sd)
    assert all(torch.equal(got_sd[n], want_sd[n]) for n in got_sd)
    b = _batch(seed=3)
    with torch.no_grad():
        want = hf(_t(b["input_ids"]), attention_mask=_t(b["attention_mask"])).logits
        got = lm.module(_t(b["input_ids"]), _t(b["attention_mask"]))
    live = torch.from_numpy(b["attention_mask"]) > 0
    assert float((got - want).abs()[live].max()) <= HF_ATOL
    out = tmp_path / "export"
    save_hf_checkpoint(str(out), lm.family, cfg, lm.module.state_dict())
    written = json.loads((out / "config.json").read_text())
    assert written["model_type"] == "mixtral"
    assert written["architectures"] == ["MixtralForCausalLM"]
    assert (written["num_local_experts"], written["num_experts_per_tok"],
            written["router_aux_loss_coef"]) == (4, 2, 0.02)
    back = load_model(str(out), device="cpu").module.state_dict()
    assert all(torch.equal(back[n], got_sd[n]) for n in got_sd)
    hf2, info = transformers.MixtralForCausalLM.from_pretrained(str(out),
                                                                output_loading_info=True)
    assert not info["missing_keys"] and not info["unexpected_keys"]
    with torch.no_grad():
        again = hf2.eval()(_t(b["input_ids"]), attention_mask=_t(b["attention_mask"])).logits
    assert float((again - want).abs()[live].max()) <= HF_ATOL


def _records(n, seed):
    rng = np.random.RandomState(seed)
    letters = np.array(list("abcdefgh "))
    return [{"dialogue": "".join(rng.choice(letters, rng.randint(10, 40))),
             "summary": "".join(rng.choice(letters, rng.randint(4, 12)))} for _ in range(n)]


def test_train_cli_moe_capacity_factor_matches_jax_trainer(tmp_path, capsys):
    from distributed_llms_example_tpu.train.trainer import Trainer as JaxTrainer

    _, path = _hf_mixtral_dir(tmp_path)
    recs = _records(16, seed=5)
    common = dict(batch_size=8, num_epochs=1, warmup_steps=0, learning_rate=1e-3,
                  max_source_length=48, max_target_length=16, pad_to_multiple=16,
                  evaluation_steps=0, log_every_steps=1, compute_dtype="float32",
                  tokenizer="byte", moe_capacity_factor=1.25)
    jcfg = JaxTrainConfig(
        model_ckpt=path, output_dir=str(tmp_path / "jax"), mesh=MeshConfig(data=-1),
        shuffle_seed=11,
        checkpoint=JaxCheckpointConfig(save_every_steps=0, resume=False, async_save=False),
        **common)
    jt = JaxTrainer(jcfg, train_records=recs)
    assert jt.config.moe_capacity_factor == 1.25
    jt.save_final = lambda: None
    jt.train()
    jlines = [json.loads(x) for x in capsys.readouterr().out.splitlines() if x.startswith("{")]
    jlosses = [x["loss"] for x in jlines if "loss" in x and "step" in x]

    data, val = tmp_path / "train.json", tmp_path / "val.json"
    data.write_text(json.dumps(recs))
    val.write_text(json.dumps(recs[:3]))
    pt = train(["--device", "cpu", "--model-ckpt", path, "--train-file", str(data),
                "--val-file", str(val), "--num-beams", "1", "--eval-max-new-tokens", "4",
                "--output-dir", str(tmp_path / "port"), "--shuffle-seed", "11", "--no-resume",
                *[f"--{k.replace('_', '-')}={v}" for k, v in common.items()]])
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines() if x.startswith("{")]
    losses = [x["loss"] for x in lines if "loss" in x and "step" in x]
    assert pt.loaded.config.moe_capacity_factor == 1.25
    assert all(blk.mlp.capacity_factor == 1.25 for blk in pt.model.blocks)
    assert len(losses) == len(jlosses) == 2
    np.testing.assert_allclose(losses, jlosses, rtol=0, atol=1e-4)
    (ev,) = [x for x in lines if x.get("event") == "eval"]
    assert all(0.0 <= ev[k] <= 1.0 for k in ("rouge1", "rouge2", "rougeL", "rougeLsum"))
    saved = json.loads((tmp_path / "port" / "model" / "config.json").read_text())
    assert saved["model_type"] == "mixtral"


def test_serving_tier_serves_mixtral(tmp_path):
    prompts = tmp_path / "p.json"
    prompts.write_text(json.dumps([f"prompt {i} " * (i + 1) for i in range(4)]))
    base = ["--device", "cpu", "--model-ckpt", NAME, "--tokenizer", "byte", "--prompts-file",
            str(prompts), "--max-slots", "2", "--max-new-tokens", "8", "--max-source-length",
            "32", "--log-every-steps", "0", "--paged-kv", "--kv-block-size", "8"]
    _, closed = cli.serve(base)
    _, routed = cli.serve_router([*base, "--replicas", "2",
                                  "--output-file", str(tmp_path / "r.jsonl")])
    _, swept = cli.serve_loadgen([*base, "--qps-grid", "2000", "--loadgen-seed", "5",
                                  "--output-file", str(tmp_path / "s.json")])
    assert routed == closed and swept == [closed]


@pytest.fixture(scope="module")
def mixtral_one_device(tmp_path_factory):
    """The JAX ``Trainer`` on one device from a ``mixtral-test`` HF
    directory, capacity 1.25, 2 steps of 8 rows."""
    from torch_dist_helpers import hf_dir, jax_train, records

    tmp = tmp_path_factory.mktemp("mixtral_mesh")
    recs = records(16, seed=3)
    path = tmp / "train.json"
    path.write_text(json.dumps(recs))
    ckpt = hf_dir(tmp / "hf", NAME)
    hist, params, _ = jax_train(ckpt, recs, "data=1", tmp / "jax", moe_capacity_factor=1.25)
    return {"tmp": tmp, "ckpt": ckpt, "train_file": path, "jax": (hist, params)}


@pytest.mark.parametrize("layout", ["data=2", "fsdp=2"])
def test_batch_sharded_steps_equal_the_one_device_step(mixtral_one_device, layout):
    from torch_dist_helpers import cli_argv, spawn

    run = mixtral_one_device
    tmp = run["tmp"] / layout.replace("=", "")
    tmp.mkdir()
    argv = cli_argv(run["ckpt"], run["train_file"], tmp / "out", "--mesh", layout,
                    moe_capacity_factor=1.25)
    _, _, got = spawn({"argv": argv}, 2, tmp, name=layout.replace("=", ""))
    hist, params = run["jax"]
    steps = [(h["loss"], h["grad_norm"]) for h in got["history"]]
    assert len(steps) == len(hist) == 2
    np.testing.assert_allclose(np.asarray(steps), np.asarray(hist), rtol=1e-5, atol=0)
    for name, want in params.items():
        err = float(np.abs(got["params"][name].numpy() - want).max())
        assert err <= 1e-5 * max(1.0, float(np.abs(want).max())), (name, err)
