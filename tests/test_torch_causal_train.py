"""Causal-LM fine-tuning in the port against the JAX package, on the CPU
at ``llama-test`` size (2 layers, width 64), fp32, the same numpy inputs
on both sides: ``CausalLMDataset`` field for field (prompt masking,
truncation, lazy encoding) and its batches (labels capped at the source
width); the causal loss sums, unfused and fused (``--fused-ce``), with and
without label smoothing, values within 1e-5 relative and every gradient
within 1e-5 of the largest entry of JAX ``make_loss_fn(is_seq2seq=False)``'s;
``blockwise_cross_entropy_sums`` against JAX's (values and both gradients,
all-masked rows safe, the block picked as JAX picks it; in bf16 the loss
from fp32 chunk logits as JAX's, at 1e-5); one optimizer
step of ``llama-test`` (loss, grad norm, parameters after it) against the
JAX train step; remat off / ``full`` / ``dots`` bit-equal with residual
and attention-probs dropout on (and a recompute that draws fresh seeds
breaks it), ``dots`` recomputing no matmul; the decay mask and health buckets of every LLaMA leaf equal
to JAX's; a 3-step ``train --model-ckpt <llama-test HF dir> --device cpu
--remat --fused-ce --val-file`` whose losses are within 1e-4 of the JAX
``Trainer``'s on the same records and weights, its export reloading
bit-equal."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llms_example_tpu.core.config import CheckpointConfig as JaxCheckpointConfig
from distributed_llms_example_tpu.core.config import MeshConfig
from distributed_llms_example_tpu.core.config import TrainConfig as JaxTrainConfig
from distributed_llms_example_tpu.data import batching as jbatching
from distributed_llms_example_tpu.data import dataset as jdataset
from distributed_llms_example_tpu.data.tokenizer import ByteTokenizer as JaxByteTokenizer
from distributed_llms_example_tpu.models.registry import load_model as jax_load_model
from distributed_llms_example_tpu.ops import blockwise_ce as jbce
from distributed_llms_example_tpu.parallel.sharding import shard_params
from distributed_llms_example_tpu.train import optim as joptim
from distributed_llms_example_tpu.train import step as jstep
from distributed_llms_example_tpu_torch.data.batching import BatchIterator
from distributed_llms_example_tpu_torch.data.dataset import CausalLMDataset
from distributed_llms_example_tpu_torch.data.tokenizer import ByteTokenizer
from distributed_llms_example_tpu_torch.launch.cli import train
from distributed_llms_example_tpu_torch.models.export import save_hf_checkpoint
from distributed_llms_example_tpu_torch.models.from_jax import (
    blocks_state_dict_from_jax,
    load_jax_params,
)
from distributed_llms_example_tpu_torch.models.llama import LlamaForCausalLM
from distributed_llms_example_tpu_torch.models.registry import LLAMA_CONFIGS, load_model
from distributed_llms_example_tpu_torch.ops import blockwise_ce
from distributed_llms_example_tpu_torch.ops.fused_dropout import dropout_seeds
from distributed_llms_example_tpu_torch.train import optim as toptim
from distributed_llms_example_tpu_torch.train.step import (
    HEALTH_BUCKETS,
    causal_loss_sums,
    param_buckets,
    train_step,
)
from distributed_llms_example_tpu_torch.train.trainer import batch_tokens, put_batch
from distributed_llms_example_tpu_torch.utils import remat

SRC, TGT, BUCKET, BATCH, LR = 64, 16, 32, 8, 1e-3


def _records(n=24, seed=0):
    rng = np.random.RandomState(seed)
    alphabet = np.array(list("abcdefghijklmnopqrstuvwxyz   .,"))
    return [{"dialogue": "".join(rng.choice(alphabet, rng.randint(5, 90))),
             "summary": "".join(rng.choice(alphabet, rng.randint(2, 30)))} for _ in range(n)]


def _datasets(records):
    kw = dict(max_length=SRC, max_target_length=TGT)
    return (CausalLMDataset(records, ByteTokenizer(), **kw),
            jdataset.CausalLMDataset(records, JaxByteTokenizer(), **kw))


def _batches(ds, epoch=0, batch=BATCH):
    # the trainer's causal plan: labels capped at the source width
    return list(BatchIterator(ds, global_batch=batch, seed=7, bucket_multiple=BUCKET,
                              max_source_length=SRC, max_target_length=SRC).epoch(epoch))


def test_causal_dataset_matches_jax_field_for_field():
    recs = _records(20) + [{"dialogue": "x" * 200, "summary": "y" * 40}]  # both truncated
    ds, jds = _datasets(recs)
    for i in range(len(recs)):
        ex, jex = ds[i], jds[i]
        assert dataclasses.asdict(ex) == dataclasses.asdict(jex), i
        assert len(ex.input_ids) == len(ex.labels) <= SRC
        assert ex.labels[: len(ex.prompt_ids)] == [-100] * len(ex.prompt_ids)
        assert ex.labels[len(ex.prompt_ids):] == ex.target_ids
        assert ex.target_ids[-1] == ByteTokenizer().eos_id
    long = ds[len(recs) - 1]
    assert len(long.target_ids) == TGT and len(long.prompt_ids) == SRC - TGT


def test_causal_dataset_masks_prompt():
    """The JAX package's ``test_causal_dataset_masks_prompt`` on the port."""
    tok = ByteTokenizer()
    ds = CausalLMDataset([{"dialogue": "abcd", "summary": "xy"}], tok, max_length=32,
                         max_target_length=8)
    ex = ds[0]
    assert len(ex.input_ids) == len(ex.labels)
    n_prompt = len(ex.prompt_ids)
    assert all(v == -100 for v in ex.labels[:n_prompt])
    assert ex.labels[n_prompt:] == ex.target_ids
    assert ex.target_ids[-1] == tok.eos_id


def test_causal_dataset_tokenizes_lazily():
    calls = []

    class Counting(ByteTokenizer):
        def encode_prompt(self, text, max_length):
            calls.append("prompt")
            return super().encode_prompt(text, max_length)

        def encode_continuation(self, text, max_length):
            calls.append("continuation")
            return super().encode_continuation(text, max_length)

    ds = CausalLMDataset(_records(6), Counting(), max_length=SRC)
    assert calls == []
    ex = ds[2]
    assert calls == ["continuation", "prompt"] and ds[2] is ex
    ds.ensure_encoded([0, 2, 3])
    assert len(calls) == 6
    ds.clear_cache()
    assert ds[2] is not ex and ds[2] == ex and len(calls) == 8


def test_causal_batches_match_jax():
    ds, jds = _datasets(_records(30))
    jit = jbatching.BatchIterator(jds, global_batch=BATCH, seed=7, bucket_multiple=BUCKET,
                                  max_source_length=SRC, max_target_length=SRC)
    for epoch in (0, 1):
        got, want = _batches(ds, epoch), list(jit.epoch(epoch))
        assert len(got) == len(want) == 3
        for g, w in zip(got, want):
            assert set(g) == set(w)
            assert g["labels"].shape == g["input_ids"].shape
            for k in w:
                assert g[k].dtype == w[k].dtype
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)
            # a causal batch counts its tokens once (the mask covers both parts)
            assert batch_tokens(g, is_seq2seq=False) == int(g["attention_mask"].sum())


@pytest.fixture(scope="module")
def jax_llama():
    lm = jax_load_model("llama-test")
    return lm, jax.device_get(lm.init_params(0))


def _port(params, **kw):
    tlm = load_model("llama-test", device="cpu", train=True, **kw)
    load_jax_params(tlm.module, params)
    return tlm.module


def _rel_close(got, want, rtol, what):
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(np.asarray(got) - np.asarray(want)).max())
    assert err <= rtol * scale, (what, err, scale)


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
@pytest.mark.parametrize("fused", [False, True])
def test_causal_loss_sums_match_jax(jax_llama, fused, smoothing):
    lm, params = jax_llama
    jlm = jax_load_model("llama-test", fused_ce=fused)
    batch = _batches(_datasets(_records())[0])[0]
    loss_fn = jax.jit(jax.value_and_grad(
        lambda p, b: jstep.make_loss_fn(jlm.module, jlm.config, smoothing, is_seq2seq=False)(
            p, b), has_aux=True))
    (jl, jt), jgrads = loss_fn(params, batch)
    jgrads = blocks_state_dict_from_jax(jax.device_get(jgrads))

    model = _port(params, fused_ce=fused)
    assert model.config.fused_ce is fused
    tl, tt = causal_loss_sums(model, put_batch(batch, torch.device("cpu")), smoothing)
    tl.backward()
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    assert float(tt) == float(jt) == float((batch["labels"][:, 1:] != -100).sum())
    for n, p in model.named_parameters():
        _rel_close(p.grad.numpy(), jgrads[n].numpy(), 1e-5, n)


def test_pick_block_matches_jax():
    for v in (32000, 32128, 50265, 256, 97, 4096, 7):
        assert blockwise_ce.pick_block(v) == jbce.pick_block(v)
    assert blockwise_ce.pick_block(32000) == 4000


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_blockwise_ce_matches_jax(smoothing):
    """Values and both gradients (vocab 50 in chunks of 10) equal JAX's; the
    weight is the port's (V, D), JAX's kernel its transpose."""
    rng = np.random.RandomState(0)
    N, D, V = 24, 16, 50
    h = rng.randn(N, D).astype(np.float32)
    w = (0.3 * rng.randn(V, D)).astype(np.float32)
    labels = rng.randint(0, V, N).astype(np.int32)
    labels[::5] = -100
    upstream = 0.7

    def jloss(h_, w_):
        ls, tk = jbce.blockwise_cross_entropy_sums(h_, w_, jnp.asarray(labels), smoothing, 10)
        return upstream * ls, tk

    (jl, jt), (jdh, jdw) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(h), jnp.asarray(w.T))
    th, tw = (torch.tensor(x, requires_grad=True) for x in (h, w))
    tl, tt = blockwise_ce.blockwise_cross_entropy_sums(th, tw, torch.from_numpy(labels),
                                                       smoothing, block=10)
    (upstream * tl).backward()
    np.testing.assert_allclose(upstream * float(tl.detach()), float(jl), rtol=1e-5)
    assert float(tt) == float(jt) == float((labels != -100).sum())
    _rel_close(th.grad.numpy(), np.asarray(jdh), 1e-5, "dh")
    _rel_close(tw.grad.numpy(), np.asarray(jdw).T, 1e-5, "dw")
    # and against the materialized logits
    from distributed_llms_example_tpu_torch.train.step import cross_entropy_sums

    ref, _ = cross_entropy_sums(torch.from_numpy(h) @ torch.from_numpy(w).T,
                                torch.from_numpy(labels), smoothing)
    np.testing.assert_allclose(float(tl.detach()), float(ref), rtol=1e-5)


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_blockwise_ce_bf16_keeps_fp32_logits_as_jax(smoothing):
    """In bf16 the chunk logits stay fp32 from the bf16 operands, as JAX's
    ``preferred_element_type=float32`` keeps them: the loss is within 1e-5
    of JAX's on the same bf16 inputs, where logits rounded to bf16 (the
    unfused head's) miss it by more; both gradients, returned in bf16 on
    both sides, within 1e-2 of the largest entry (bf16's 2^-8 rounding
    of the result, and of the softmax term entering its products)."""
    rng = np.random.RandomState(2)
    N, D, V = 32, 64, 60
    h = rng.randn(N, D).astype(np.float32)
    w = (0.3 * rng.randn(V, D)).astype(np.float32)
    labels = rng.randint(0, V, N).astype(np.int32)
    labels[::7] = -100

    def jloss(h_, w_):
        return jbce.blockwise_cross_entropy_sums(h_, w_, jnp.asarray(labels), smoothing, 20)

    (jl, _), (jdh, jdw) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(h, jnp.bfloat16), jnp.asarray(w.T, jnp.bfloat16))
    th, tw = (torch.tensor(x).bfloat16().requires_grad_(True) for x in (h, w))
    tl, _ = blockwise_ce.blockwise_cross_entropy_sums(th, tw, torch.from_numpy(labels),
                                                      smoothing, block=20)
    tl.backward()
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    from distributed_llms_example_tpu_torch.train.step import cross_entropy_sums

    rounded, _ = cross_entropy_sums((th.detach() @ tw.detach().T).float(),
                                    torch.from_numpy(labels).long(), smoothing)
    assert abs(float(rounded) - float(jl)) > 1e-5 * abs(float(jl))
    _rel_close(th.grad.float().numpy(), np.asarray(jdh, np.float32), 1e-2, "dh")
    _rel_close(tw.grad.float().numpy(), np.asarray(jdw, np.float32).T, 1e-2, "dw")


def test_blockwise_ce_all_masked_rows_are_safe():
    rng = np.random.RandomState(1)
    h = torch.tensor(rng.randn(6, 8).astype(np.float32), requires_grad=True)
    w = torch.tensor(rng.randn(20, 8).astype(np.float32), requires_grad=True)
    labels = torch.full((6,), -100, dtype=torch.int64)
    ls, tk = blockwise_ce.blockwise_cross_entropy_sums(h, w, labels, 0.1, block=5)
    ls.backward()
    assert float(ls.detach()) == 0.0 and float(tk) == 0.0
    assert torch.isfinite(h.grad).all() and torch.isfinite(w.grad).all()
    assert float(h.grad.abs().max()) == float(w.grad.abs().max()) == 0.0
    with pytest.raises(ValueError, match="divide"):
        blockwise_ce.blockwise_cross_entropy_sums(h, w, labels, block=3)


@pytest.mark.parametrize("fused", [False, True])
def test_one_train_step_matches_jax(jax_llama, dp_mesh, fused):
    """Loss, grad norm and the parameters after one clip + AdamW step of
    ``llama-test`` (fp32) against the JAX train step on the same batch.
    The parameters agree to 1e-3 of the learning rate wherever the
    gradient is 0 or at least 1e-6: Adam's first step moves an element by
    lr·g/(|g| + eps), so an element whose gradient is within the two
    stacks' fp32 noise of 0 moves by a noisy fraction of lr (one
    gate_proj element of 8192 differs by 2e-2·lr); those are held to the
    step's own bound, lr."""
    _, params = jax_llama
    jlm = jax_load_model("llama-test", fused_ce=fused)
    tx, schedule, _ = joptim.make_optimizer_bundle(
        learning_rate=LR, weight_decay=0.01, warmup_steps=0, total_steps=3, max_grad_norm=1.0)
    build = jstep.make_train_step(jlm.module, jlm.config, tx, schedule, dp_mesh, donate=False,
                                  is_seq2seq=False)
    state = jstep.create_train_state(shard_params(params, dp_mesh), tx)
    sh = jstep.state_shardings(state, dp_mesh)
    state = jax.tree.map(lambda x, s: jax.device_put(x, s), state, sh)
    jax_step, _ = build(state)
    batch = _batches(_datasets(_records())[0])[0]
    state, jm = jax_step(state, jstep.put_batch(batch, dp_mesh))

    model = _port(params, fused_ce=fused)
    named = list(model.named_parameters())
    opt = toptim.AdamWState.zeros([p for _, p in named])
    m = train_step(model, named, opt,
                   toptim.OptimizerSpec(learning_rate=LR, weight_decay=0.01, warmup_steps=0,
                                        total_steps=3, max_grad_norm=1.0),
                   toptim.linear_schedule_with_warmup(LR, 0, 3),
                   put_batch(batch, torch.device("cpu")), is_seq2seq=False)
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]), rtol=1e-5)
    assert float(m["target_tokens"]) == float(jm["target_tokens"])
    want = blocks_state_dict_from_jax(jax.device_get(state.params))
    for n, p in named:
        got, ref = p.detach().numpy(), want[n].numpy()
        g = np.abs(p.grad.numpy())
        live = (g >= 1e-6) | (g == 0)  # an unused embedding row decays alone
        np.testing.assert_allclose(got[live], ref[live], rtol=0, atol=1e-3 * LR, err_msg=n)
        assert np.abs(got - ref).max() <= LR, n


def test_decay_mask_and_buckets_match_jax(jax_llama):
    """Every LLaMA leaf in its JAX counterpart's decay class (RMSNorm scales
    not decayed) and health bucket."""
    _, params = jax_llama
    jdecay = blocks_state_dict_from_jax(jax.tree.map(
        lambda x: np.float32(x), jax.device_get(joptim.decay_mask(params))))
    jbuckets = blocks_state_dict_from_jax(jax.tree_util.tree_map_with_path(
        lambda path, x: np.float32(HEALTH_BUCKETS.index(jstep.bucket_of_path(path))), params))
    model = _port(params)
    got = dict(zip((n for n, _ in model.named_parameters()), param_buckets(model).tolist()))
    assert len(got) == len(jdecay) == 21
    for n, p in model.named_parameters():
        assert toptim.decay_mask(n, p) == bool(jdecay[n].item()), n
        assert HEALTH_BUCKETS[got[n]] == HEALTH_BUCKETS[int(jbuckets[n].item())], n
    assert not toptim.decay_mask("final_norm.weight", model.final_norm.weight)
    assert HEALTH_BUCKETS[got["lm_head.weight"]] == "head"
    assert HEALTH_BUCKETS[got["embed_tokens.weight"]] == "embed"


def _dropout_llama(params, policy):
    cfg = dataclasses.replace(LLAMA_CONFIGS["llama-test"], dropout_rate=0.1,
                              attn_dropout_rate=0.1)
    model = LlamaForCausalLM(cfg, remat_policy=policy).train()
    load_jax_params(model, params)
    return model


def _loss_and_grads(model, batch, seed=3):
    with dropout_seeds(torch.Generator().manual_seed(seed)):
        ls, _ = causal_loss_sums(model, batch)
        ls.backward()
    return ls.detach(), {n: p.grad for n, p in model.named_parameters()}


@pytest.mark.parametrize("policy", ["full", "dots"])
def test_remat_is_bit_equal_with_dropout(jax_llama, policy, monkeypatch):
    """Remat changes no bit of the loss or any gradient, with residual and
    attention-probs dropout 0.1; a recompute drawing fresh seeds (no
    replay of the first run's) gives other gradients."""
    _, params = jax_llama
    batch = put_batch(_batches(_datasets(_records())[0])[0], torch.device("cpu"))
    off_l, off_g = _loss_and_grads(_dropout_llama(params, None), batch)
    on_l, on_g = _loss_and_grads(_dropout_llama(params, policy), batch)
    assert torch.equal(on_l, off_l)
    for n in off_g:
        assert torch.equal(on_g[n], off_g[n]), n
    other_l, _ = _loss_and_grads(_dropout_llama(params, None), batch, seed=4)
    assert not torch.equal(other_l, off_l)  # dropout really ran

    class Fresh:  # a naive recompute: every run draws from the stream
        def __init__(self, tape, *, replay):
            pass

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(remat, "seed_tape", Fresh)
    naive_l, naive_g = _loss_and_grads(_dropout_llama(params, policy), batch)
    assert torch.equal(naive_l, off_l)  # the forward draws as before
    assert any(not torch.equal(naive_g[n], off_g[n]) for n in off_g)


def _backward_matmuls(params, policy, batch):
    """The ``aten.mm``/``addmm`` calls of one backward (the recompute's
    included) of the dropout llama under ``policy``."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
                self.n += 1
            return func(*args, **(kwargs or {}))

    model = _dropout_llama(params, policy)
    with dropout_seeds(torch.Generator().manual_seed(3)):
        ls, _ = causal_loss_sums(model, batch)
        with Count() as count:
            ls.backward()
    return count.n


def test_remat_dots_saves_the_matmul_outputs(jax_llama):
    """``dots`` keeps every Dense output: its backward issues no more
    matmuls than a backward without remat, while ``full`` recomputes six of
    the seven Dense of every block (q, k, v, o, gate, up; the recompute
    stops early before down, whose output nothing in the block saves)."""
    _, params = jax_llama
    batch = put_batch(_batches(_datasets(_records())[0])[0], torch.device("cpu"))
    off, full, dots = (_backward_matmuls(params, p, batch) for p in (None, "full", "dots"))
    layers = LLAMA_CONFIGS["llama-test"].num_hidden_layers
    assert off > 0
    assert full - off == 6 * layers
    assert dots == off


def test_remat_policy_names():
    from distributed_llms_example_tpu.core.config import REMAT_POLICIES as JAX_POLICIES

    assert remat.REMAT_POLICIES == tuple(JAX_POLICIES) == ("full", "dots")
    with pytest.raises(ValueError, match="remat_policy"):
        load_model("llama-test", device="cpu", train=True, remat=True, remat_policy="everything")


def _hf_llama_dir(tmp_path, params):
    model = _port(params)
    path = tmp_path / "llama-test-hf"
    save_hf_checkpoint(str(path), "llama", model.config, model.state_dict())
    return path


def test_cli_three_steps_match_jax_trainer(jax_llama, tmp_path, capsys):
    """``train --remat --fused-ce --val-file`` on the CPU from an HF
    directory of the JAX init: 3 steps within 1e-4 of the JAX ``Trainer``'s
    losses (fp32, the same records, byte tokens), one eval line, a
    ``prefetch_stats`` line, and the export reloading bit-equal."""
    from distributed_llms_example_tpu.train.trainer import Trainer as JaxTrainer

    _, params = jax_llama
    ckpt = _hf_llama_dir(tmp_path, params)
    recs = _records(24, seed=5)
    common = dict(batch_size=8, num_epochs=1, warmup_steps=0, learning_rate=LR,
                  max_source_length=SRC, max_target_length=TGT, pad_to_multiple=BUCKET,
                  evaluation_steps=0, eval_max_new_tokens=8, num_beams=1, log_every_steps=1,
                  compute_dtype="float32", tokenizer="byte")
    jcfg = JaxTrainConfig(
        model_ckpt=str(ckpt), output_dir=str(tmp_path / "jax"), remat=True, fused_ce=True,
        mesh=MeshConfig(data=-1), shuffle_seed=11,
        checkpoint=JaxCheckpointConfig(save_every_steps=0, resume=False, async_save=False),
        **common)
    jt = JaxTrainer(jcfg, train_records=recs)
    jt.save_final = lambda: None
    jt.train()
    jlines = [json.loads(x) for x in capsys.readouterr().out.splitlines() if x.startswith("{")]
    jlosses = [x["loss"] for x in jlines if "loss" in x and "step" in x]

    path, val = tmp_path / "train.json", tmp_path / "val.json"
    path.write_text(json.dumps(recs))
    val.write_text(json.dumps(recs[:5]))
    pt = train(["--device", "cpu", "--model-ckpt", str(ckpt), "--train-file", str(path),
                "--val-file", str(val), "--output-dir", str(tmp_path / "port"), "--remat",
                "--fused-ce", "--shuffle-seed", "11", "--no-resume",
                *[f"--{k.replace('_', '-')}={v}" for k, v in common.items()]])
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines() if x.startswith("{")]
    losses = [x["loss"] for x in lines if "loss" in x and "step" in x]
    assert len(losses) == len(jlosses) == 3
    np.testing.assert_allclose(losses, jlosses, rtol=0, atol=1e-4)
    assert pt.model.remat_policy == "full" and pt.loaded.config.fused_ce
    (ev,) = [x for x in lines if x.get("event") == "eval"]
    assert all(0.0 <= ev[k] <= 1.0 for k in ("rouge1", "rouge2", "rougeL", "rougeLsum"))
    (pf,) = [x for x in lines if x.get("event") == "prefetch_stats"]
    assert pf["items"] == 3 and pf["depth"] == 2
    back = load_model(str(tmp_path / "port" / "model"), device="cpu", train=True).module
    trained = dict(pt.model.named_parameters())
    assert all(torch.equal(p, trained[n]) for n, p in back.named_parameters())


@pytest.mark.parametrize("policy", ["full", "dots"])
@pytest.mark.parametrize("name", ["bart-test", "t5-test"])
def test_seq2seq_remat_is_bit_equal_with_dropout(name, policy):
    """BART's and T5's blocks under remat (encoder and decoder layers), with
    their default dropout 0.1: loss and every gradient bit-equal to the
    run without it."""
    from distributed_llms_example_tpu_torch.data.dataset import SummarizationDataset
    from distributed_llms_example_tpu_torch.train.step import seq2seq_loss_sums

    ds = SummarizationDataset(_records(8), ByteTokenizer(), max_source_length=SRC,
                              max_target_length=TGT)
    batch = put_batch(next(iter(BatchIterator(
        ds, global_batch=BATCH, seed=7, bucket_multiple=BUCKET, max_source_length=SRC,
        max_target_length=TGT).epoch(0))), torch.device("cpu"))

    def run(remat_on):
        lm = load_model(name, device="cpu", train=True, seed=0, remat=remat_on,
                        remat_policy=policy)
        assert lm.config.dropout_rate > 0 and lm.module.remat_policy == (
            policy if remat_on else None)
        with dropout_seeds(torch.Generator().manual_seed(5)):
            ls, _ = seq2seq_loss_sums(lm.module, batch)
            ls.backward()
        return ls.detach(), {n: p.grad for n, p in lm.module.named_parameters()}

    (off_l, off_g), (on_l, on_g) = run(False), run(True)
    assert torch.equal(on_l, off_l)
    assert all(torch.equal(on_g[n], off_g[n]) for n in off_g)
