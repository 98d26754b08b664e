"""The port's train step against the JAX package's ``make_train_step`` on
``bart-test`` and ``t5-test``: the same weights (through ``from_jax``),
the same batches (the two ``BatchIterator``s yield identical arrays),
dropout off, three optimizer steps.  Loss, grad norm and learning rate
agree to 1e-5 relative; every gradient tensor to atol 1e-6 (fp32 through
both stacks in different summation orders); the parameters after each
step to 1e-3 of the learning rate (Adam's g / (sqrt(v) + eps) at the first
steps turns those roundings of a near-zero gradient into at most that).
The T5 case draws its records from seed 8: relu's derivative jumps at 0,
and seed 0's batches put one encoder pre-activation 1e-7 from 0, inside
the two stacks' fp32 noise, so the branch taken there depends on
summation order; over seed 8's three steps the smallest relu input of a
real token is 3.3e-6 from 0.  Also: grad accumulation 2 equals 1, a
dropout-on step is deterministic per seed, the cross entropy with label
smoothing, and an attention-probs dropout step deterministic per seed on
both attention routes."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llms_example_tpu.data.batching import BatchIterator as JaxBatchIterator
from distributed_llms_example_tpu.data.dataset import SummarizationDataset as JaxDataset
from distributed_llms_example_tpu.data.tokenizer import ByteTokenizer as JaxByteTokenizer
from distributed_llms_example_tpu.models.registry import load_model as jax_load_model
from distributed_llms_example_tpu.parallel.sharding import shard_params
from distributed_llms_example_tpu.train import optim as joptim
from distributed_llms_example_tpu.train import step as jstep
from distributed_llms_example_tpu_torch.data.batching import BatchIterator
from distributed_llms_example_tpu_torch.data.dataset import SummarizationDataset
from distributed_llms_example_tpu_torch.data.tokenizer import ByteTokenizer
from distributed_llms_example_tpu_torch.models.from_jax import (
    bart_state_dict_from_jax,
    blocks_state_dict_from_jax,
    load_jax_params,
)
from distributed_llms_example_tpu_torch.models.registry import BART_CONFIGS, load_model
from distributed_llms_example_tpu_torch.train import optim as toptim
from distributed_llms_example_tpu_torch.train.step import cross_entropy_sums, train_step
from distributed_llms_example_tpu_torch.train.trainer import put_batch

LR = 1e-3
BATCH = 8
STATE_DICT = {"bart-test": bart_state_dict_from_jax, "t5-test": blocks_state_dict_from_jax}
DATA_SEED = {"bart-test": 0, "t5-test": 8}


@pytest.fixture(autouse=True)
def _no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _records(n=24, seed=0):
    rng = np.random.RandomState(seed)
    alphabet = np.array(list("abcdefghijklmnopqrstuvwxyz   .,"))
    return [{"dialogue": "".join(rng.choice(alphabet, rng.randint(10, 120))),
             "summary": "".join(rng.choice(alphabet, rng.randint(3, 40)))} for _ in range(n)]


def _port_batches(records, epoch=0):
    ds = SummarizationDataset(records, ByteTokenizer(), max_source_length=128,
                              max_target_length=32)
    return list(BatchIterator(ds, global_batch=BATCH, seed=7, bucket_multiple=32,
                              max_source_length=128, max_target_length=32).epoch(epoch))


def test_batch_iterator_matches_jax():
    records = _records(30)
    jds = JaxDataset(records, JaxByteTokenizer(), max_source_length=128, max_target_length=32)
    jit = JaxBatchIterator(jds, global_batch=BATCH, seed=7, bucket_multiple=32,
                           max_source_length=128, max_target_length=32)
    for epoch in (0, 1):
        want = list(jit.epoch(epoch))
        got = _port_batches(records, epoch)
        assert len(got) == len(want) == 3
        for g, w in zip(got, want):
            assert set(g) == set(w)
            for k in w:
                assert g[k].dtype == w[k].dtype
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def _jax_model(name):
    lm = jax_load_model(name)
    return lm, jax.device_get(lm.init_params(0))


@pytest.fixture(scope="module")
def jax_bart():
    return _jax_model("bart-test")


def _port_model(params, impl="xla", name="bart-test"):
    tlm = load_model(name, device="cpu", train=True, attention_impl=impl)
    load_jax_params(tlm.module, params)
    return tlm.module


@pytest.mark.parametrize("impl", ["xla", "flash"])
@pytest.mark.parametrize("name", ["bart-test", "t5-test"])
def test_three_steps_match_jax_make_train_step(name, dp_mesh, impl):
    lm, params = _jax_model(name)
    to_port = STATE_DICT[name]
    tx, schedule, _ = joptim.make_optimizer_bundle(
        learning_rate=LR, weight_decay=0.01, warmup_steps=1, total_steps=3, max_grad_norm=1.0)
    build = jstep.make_train_step(lm.module, lm.config, tx, schedule, dp_mesh, donate=False)
    state = jstep.create_train_state(shard_params(params, dp_mesh), tx)
    sh = jstep.state_shardings(state, dp_mesh)
    state = jax.tree.map(lambda x, s: jax.device_put(x, s), state, sh)
    jax_step, _ = build(state)
    loss_fn = jax.jit(jax.value_and_grad(
        lambda p, b: jstep.make_loss_fn(lm.module, lm.config)(p, b), has_aux=True))

    model = _port_model(params, impl, name).eval()  # dropout off, as the JAX step without an rng
    named = list(model.named_parameters())
    spec = toptim.OptimizerSpec(learning_rate=LR, weight_decay=0.01, warmup_steps=1,
                                total_steps=3, max_grad_norm=1.0)
    sched = toptim.linear_schedule_with_warmup(LR, 1, 3)
    opt = toptim.AdamWState.zeros([p for _, p in named])
    for i, batch in enumerate(_port_batches(_records(seed=DATA_SEED[name]))):
        (_, tokens), jgrads = loss_fn(jax.device_get(state.params), batch)
        jgrads = to_port(
            jax.tree.map(lambda g: np.asarray(g) / float(tokens), jax.device_get(jgrads)))
        state, jm = jax_step(state, jstep.put_batch(batch, dp_mesh))
        m = train_step(model, named, opt, spec, sched, put_batch(batch, torch.device("cpu")))
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-5)
        np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]), rtol=1e-5)
        assert np.float32(m["learning_rate"]) == np.float32(jm["learning_rate"])
        assert float(m["target_tokens"]) == float(jm["target_tokens"])
        want = to_port(jax.device_get(state.params))
        for n, p in named:
            np.testing.assert_allclose(p.grad.numpy(), jgrads[n].numpy(), rtol=0, atol=1e-6,
                                       err_msg=f"step {i} grad {n}")
            if n.endswith("k_proj.bias"):
                # softmax ignores a shift shared by every key, so this
                # gradient is exactly 0 and both stacks hold rounding noise
                # (~1e-9, checked above), which Adam scales up to ~lr
                continue
            np.testing.assert_allclose(p.detach().numpy(), want[n].numpy(), rtol=0,
                                       atol=1e-3 * LR, err_msg=f"step {i} param {n}")


def _one_step_grads(params, batch, accum, *, generator=None, train=False):
    model = _port_model(params).train(train)
    named = list(model.named_parameters())
    opt = toptim.AdamWState.zeros([p for _, p in named])
    m = train_step(model, named, opt, toptim.OptimizerSpec(learning_rate=LR, warmup_steps=0),
                   toptim.linear_schedule_with_warmup(LR, 0, 10), batch,
                   grad_accum_steps=accum, generator=generator)
    return m, {n: p.grad.clone() for n, p in named}, {n: p.detach().clone() for n, p in named}


def test_grad_accumulation_two_equals_one(jax_bart):
    _, params = jax_bart
    batch = put_batch(_port_batches(_records())[0], torch.device("cpu"))
    m1, g1, _ = _one_step_grads(params, batch, 1)
    m2, g2, _ = _one_step_grads(params, batch, 2)
    np.testing.assert_allclose(float(m2["loss"]), float(m1["loss"]), rtol=1e-6)
    assert float(m2["target_tokens"]) == float(m1["target_tokens"])
    for n in g1:
        np.testing.assert_allclose(g2[n].numpy(), g1[n].numpy(), rtol=0, atol=1e-7, err_msg=n)


def test_dropout_step_is_deterministic_per_seed(jax_bart):
    _, params = jax_bart
    batch = put_batch(_port_batches(_records())[0], torch.device("cpu"))
    runs = [_one_step_grads(params, batch, 1, generator=torch.Generator().manual_seed(s),
                            train=True) for s in (3, 3, 4)]
    (ma, ga, pa), (mb, gb, pb), (mc, _, _) = runs
    assert float(ma["loss"]) == float(mb["loss"]) != float(mc["loss"])
    assert all(torch.equal(ga[n], gb[n]) and torch.equal(pa[n], pb[n]) for n in ga)
    m_eval, _, _ = _one_step_grads(params, batch, 1)
    assert float(m_eval["loss"]) != float(ma["loss"])  # dropout really ran


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_cross_entropy_sums_match_jax(smoothing):
    rng = np.random.RandomState(0)
    logits = rng.randn(4, 9, 50).astype(np.float32)
    labels = rng.randint(0, 50, (4, 9)).astype(np.int32)
    labels[:, -3:] = -100
    jl, jt = jstep.cross_entropy_sums(jnp.asarray(logits), jnp.asarray(labels), smoothing)
    tl, tt = cross_entropy_sums(torch.from_numpy(logits), torch.from_numpy(labels), smoothing)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-6)
    assert float(tt) == float(jt) == 4 * 6


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_probs_dropout_step_is_deterministic_per_seed(jax_bart, impl):
    """Attention-probs dropout alone (residual dropout 0) trains on either
    route: a step is the same for the same seed stream, differs for
    another, and differs from rate 0 on the same stream."""
    from distributed_llms_example_tpu_torch.models.bart import BartForConditionalGeneration

    _, params = jax_bart
    batch = put_batch(_port_batches(_records())[0], torch.device("cpu"))

    def loss(rate, seed):
        cfg = dataclasses.replace(BART_CONFIGS["bart-test"], dropout_rate=0.0,
                                  attn_dropout_rate=rate, attention_impl=impl)
        model = BartForConditionalGeneration(cfg).train()
        load_jax_params(model, params)
        named = list(model.named_parameters())
        m = train_step(model, named, toptim.AdamWState.zeros([p for _, p in named]),
                       toptim.OptimizerSpec(learning_rate=LR, warmup_steps=0),
                       toptim.linear_schedule_with_warmup(LR, 0, 10), batch,
                       generator=torch.Generator().manual_seed(seed))
        return float(m["loss"]), {n: p.detach().clone() for n, p in named}

    (la, pa), (lb, pb), (lc, _), (l0, _) = (loss(0.1, 3), loss(0.1, 3), loss(0.1, 4),
                                            loss(0.0, 3))
    assert la == lb and all(torch.equal(pa[n], pb[n]) for n in pa)
    assert lc != la and l0 != la
