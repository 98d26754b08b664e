"""Helpers of the multi-process tests of the port: gloo ranks of the train
CLI on the CPU (``torch_dist_worker.py``, one subprocess a rank, on a free
port of 127.0.0.1), the JAX ``Trainer`` on a CPU mesh of the same layout,
and HF directories both load from the JAX init."""

import dataclasses
import json
import os
import socket
import subprocess
import sys

import jax
import numpy as np
import torch

from distributed_llms_example_tpu.core.config import CheckpointConfig as JaxCheckpointConfig
from distributed_llms_example_tpu.core.config import MeshConfig
from distributed_llms_example_tpu.core.config import TrainConfig as JaxTrainConfig
from distributed_llms_example_tpu.core.mesh import build_mesh as jax_build_mesh
from distributed_llms_example_tpu.models.registry import load_model as jax_load_model
from distributed_llms_example_tpu_torch.models.export import save_hf_checkpoint
from distributed_llms_example_tpu_torch.models.from_jax import load_jax_params
from distributed_llms_example_tpu_torch.models.registry import load_model

TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)
WORKER = os.path.join(TESTS, "torch_dist_worker.py")

# the CLI flags both trainers take (3 steps of 8 rows, fp32, byte tokens).
# One warmup step, whose learning rate is 0: Adam's first update divides
# each gradient by its own magnitude, so an element that is rounding noise
# in both frameworks (~1e-9; T5's relu rows) moves by +-lr in either
# direction; after it the second moments hold real magnitudes.
COMMON = dict(batch_size=8, num_epochs=1, warmup_steps=1, learning_rate=1e-3,
              max_source_length=64, max_target_length=16, pad_to_multiple=32,
              evaluation_steps=0, eval_max_new_tokens=8, num_beams=1, log_every_steps=1,
              compute_dtype="float32", tokenizer="byte", shuffle_seed=11)


def records(n=24, seed=0):
    rng = np.random.RandomState(seed)
    alphabet = np.array(list("abcdefghijklmnopqrstuvwxyz   .,"))
    return [{"dialogue": "".join(rng.choice(alphabet, rng.randint(5, 60))),
             "summary": "".join(rng.choice(alphabet, rng.randint(2, 14)))} for _ in range(n)]


def hf_dir(path, name, **config):
    """An HF checkpoint of registry model ``name`` with the JAX package's
    init (seed 0) and ``config`` replaced (e.g. dropout off), which the
    port and the JAX package both load."""
    jlm = jax_load_model(name)
    params = jax.device_get(jlm.init_params(0))
    lm = load_model(name, device="cpu", train=True)
    load_jax_params(lm.module, params)
    cfg = dataclasses.replace(lm.config, **config)
    save_hf_checkpoint(str(path), lm.family, cfg, lm.module.state_dict())
    return str(path)


def llama_dir(path, **config):
    """An HF checkpoint of a LLaMA of the given config fields (the port's
    and the JAX package's ``LlamaConfig`` take the same ones), with the
    JAX package's init (seed 0)."""
    import jax.numpy as jnp

    from distributed_llms_example_tpu.models.llama import LlamaConfig as JaxLlamaConfig
    from distributed_llms_example_tpu.models.llama import LlamaForCausalLM as JaxLlama
    from distributed_llms_example_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM

    params = jax.device_get(JaxLlama(JaxLlamaConfig(**config)).init(
        jax.random.PRNGKey(0), jnp.ones((1, 8), jnp.int32))["params"])
    cfg = LlamaConfig(**config)
    model = LlamaForCausalLM(cfg)
    load_jax_params(model, params)
    save_hf_checkpoint(str(path), "llama", cfg, model.state_dict())
    return str(path)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def cli_argv(ckpt, train_file, out_dir, *extra, resume=False, **flags):
    kw = {**COMMON, **flags}
    return ["--device", "cpu", "--model-ckpt", str(ckpt), "--train-file", str(train_file),
            "--output-dir", str(out_dir), *([] if resume else ["--no-resume"]),
            *[f"--{k.replace('_', '-')}={v}" for k, v in kw.items()], *extra]


def spawn(spec: dict, n: int, tmp, *, timeout=240, name="run", expect_ok=True):
    """Run ``n`` ranks of ``torch_dist_worker.py`` on ``spec`` (gloo on the
    CPU); returns (exit codes, each rank's log, rank 0's result or None)."""
    tmp = str(tmp)
    spec = {**spec, "out": os.path.join(tmp, f"{name}.pt")}
    path = os.path.join(tmp, f"{name}.json")
    with open(path, "w") as f:
        json.dump(spec, f)
    port = free_port()
    procs, logs = [], []
    for r in range(n):
        env = {k: v for k, v in os.environ.items() if k not in ("LOCAL_RANK",)}
        env.update(RANK=str(r), WORLD_SIZE=str(n), MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(port), OMP_NUM_THREADS="1", PYTHONPATH=REPO)
        log = os.path.join(tmp, f"{name}-rank{r}.log")
        logs.append(log)
        procs.append(subprocess.Popen([sys.executable, WORKER, path], env=env, cwd=REPO,
                                      stdout=open(log, "w"), stderr=subprocess.STDOUT))
    try:
        rcs = [p.wait(timeout=timeout) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    texts = [open(log).read() for log in logs]
    if expect_ok:
        assert rcs == [0] * n, "\n".join(f"--- rank {r} ---\n{t[-4000:]}"
                                         for r, t in enumerate(texts))
    result = torch.load(spec["out"], weights_only=False) if os.path.exists(spec["out"]) else None
    return rcs, texts, result


def json_lines(text: str) -> list[dict]:
    return [json.loads(x) for x in text.splitlines() if x.startswith("{")]


def jax_mesh(layout: str):
    axes = {k: int(v) for k, v in (kv.split("=") for kv in layout.split(","))}
    axes.setdefault("data", 1)
    cfg = MeshConfig(**axes)
    n = int(np.prod([max(v, 1) for v in cfg.axis_sizes().values()]))
    return jax_build_mesh(cfg, devices=jax.devices()[:n]), cfg


def jax_train(ckpt, train_records, layout: str, out_dir, *, val_records=None, **flags):
    """The JAX ``Trainer`` on a CPU mesh of ``layout``: (each step's loss
    and grad norm, the final parameters by port name as numpy, the trainer)."""
    from distributed_llms_example_tpu.train.trainer import Trainer as JaxTrainer
    from distributed_llms_example_tpu_torch.models.from_jax import (
        bart_state_dict_from_jax,
        blocks_state_dict_from_jax,
    )

    mesh, mcfg = jax_mesh(layout)
    cfg = JaxTrainConfig(model_ckpt=str(ckpt), output_dir=str(out_dir), mesh=mcfg,
                         checkpoint=JaxCheckpointConfig(save_every_steps=0, resume=False,
                                                        async_save=False),
                         **{**COMMON, **flags})
    jt = JaxTrainer(cfg, train_records=train_records, val_records=val_records, mesh=mesh)
    seen = []
    step = jt.train_step

    def recording(*args):
        state, metrics = step(*args)
        seen.append(metrics)
        return state, metrics

    jt.train_step = recording
    jt.save_final = lambda: None
    jt.train()
    history = [(float(m["loss"]), float(m["grad_norm"])) for m in seen]
    params = jax.device_get(jt.state.params)
    conv = bart_state_dict_from_jax if jt.loaded.family == "bart" else blocks_state_dict_from_jax
    return history, {k: v.numpy() for k, v in conv(params).items()}, jt


def assert_matches(result, history, params, atol=1e-4):
    """Each step's loss and grad norm, and every final parameter, within
    ``atol`` of the JAX run's."""
    got = [(h["loss"], h["grad_norm"]) for h in result["history"]]
    assert len(got) == len(history), (got, history)
    np.testing.assert_allclose(np.asarray(got), np.asarray(history), rtol=0, atol=atol)
    port = result["params"]
    assert set(params) <= set(port), sorted(set(params) - set(port))[:5]
    worst = max(float(np.abs(port[k].numpy() - v).max()) for k, v in params.items())
    assert worst <= atol, worst
    return worst
