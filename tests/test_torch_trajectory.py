"""The 20-step loss curve: the port's train step against the JAX package's
``make_train_step`` over twenty optimizer steps of ``bart-test`` in fp32,
on the same seed-0 weights (through ``from_jax``) and the same twenty
batches, with the JAX trajectory oracle's optimizer (AdamW 5e-5, weight
decay 0.01, 3 warmup steps of a linear schedule over 20, global-norm clip
1.0; dropout off).  The losses agree within the oracle's tolerance
(``rtol=2e-3, atol=2e-4``) and the curve moves (``|loss_0 - loss_19| >
1e-3``): a drift in the optimizer, schedule or clipping compounds over
the steps where a one-step check would miss it."""

import jax
import numpy as np
import torch

from distributed_llms_example_tpu.models.registry import load_model as jax_load_model
from distributed_llms_example_tpu.parallel.sharding import shard_params
from distributed_llms_example_tpu.train import optim as joptim
from distributed_llms_example_tpu.train import step as jstep
from distributed_llms_example_tpu_torch.data.batching import BatchIterator
from distributed_llms_example_tpu_torch.data.dataset import SummarizationDataset
from distributed_llms_example_tpu_torch.data.tokenizer import ByteTokenizer
from distributed_llms_example_tpu_torch.models.from_jax import load_jax_params
from distributed_llms_example_tpu_torch.models.registry import load_model
from distributed_llms_example_tpu_torch.train import optim as toptim
from distributed_llms_example_tpu_torch.train.step import train_step
from distributed_llms_example_tpu_torch.train.trainer import put_batch

N_STEPS, BATCH = 20, 8
LR, WD, WARMUP, CLIP = 5e-5, 0.01, 3, 1.0


def _batches():
    """Twenty batches of one shape ((8, 32) sources, (8, 16) targets), so
    the JAX step compiles once."""
    rng = np.random.RandomState(42)
    alphabet = np.array(list("abcdefghijklmnopqrstuvwxyz   .,"))
    records = [{"dialogue": "".join(rng.choice(alphabet, rng.randint(10, 32))),
                "summary": "".join(rng.choice(alphabet, rng.randint(3, 14)))}
               for _ in range(N_STEPS * BATCH)]
    ds = SummarizationDataset(records, ByteTokenizer(), max_source_length=32,
                              max_target_length=16)
    batches = list(BatchIterator(ds, global_batch=BATCH, seed=7, bucket_multiple=16,
                                 max_source_length=32, max_target_length=16).epoch(0))
    assert len(batches) == N_STEPS and len({b["input_ids"].shape for b in batches}) == 1
    return batches


def test_twenty_step_loss_curve_equals_jax(dp_mesh):
    torch.backends.cuda.matmul.allow_tf32 = False
    lm = jax_load_model("bart-test")
    params = jax.device_get(lm.init_params(0))
    batches = _batches()
    tx, schedule, _ = joptim.make_optimizer_bundle(
        learning_rate=LR, weight_decay=WD, warmup_steps=WARMUP, total_steps=N_STEPS,
        max_grad_norm=CLIP)
    state = jstep.create_train_state(shard_params(params, dp_mesh), tx)
    sh = jstep.state_shardings(state, dp_mesh)
    state = jax.tree.map(lambda x, s: jax.device_put(x, s), state, sh)
    jax_step, _ = jstep.make_train_step(lm.module, lm.config, tx, schedule, dp_mesh,
                                        donate=False)(state)
    want = []
    for batch in batches:
        state, m = jax_step(state, jstep.put_batch(batch, dp_mesh))
        want.append(float(m["loss"]))

    tlm = load_model("bart-test", device="cpu", train=True, attention_impl="xla")
    load_jax_params(tlm.module, params)
    model = tlm.module.eval()  # dropout off, as the JAX step without an rng
    named = list(model.named_parameters())
    spec = toptim.OptimizerSpec(learning_rate=LR, weight_decay=WD, warmup_steps=WARMUP,
                                total_steps=N_STEPS, max_grad_norm=CLIP)
    sched = toptim.linear_schedule_with_warmup(LR, WARMUP, N_STEPS)
    opt = toptim.AdamWState.zeros([p for _, p in named])
    got = [float(train_step(model, named, opt, spec, sched,
                            put_batch(batch, torch.device("cpu")))["loss"])
           for batch in batches]
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-4)
    assert abs(got[0] - got[-1]) > 1e-3
    # fp32 through both stacks in different summation orders: the curves
    # read far tighter than the oracle's tolerance
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)

