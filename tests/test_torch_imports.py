"""The port stands alone: importing every module of
``distributed_llms_example_tpu_torch`` (the causal-training modules
``data/prefetch.py``, ``utils/remat.py`` and ``ops/blockwise_ce.py`` among
them, ``utils/remat.py`` importing checkpointing only inside its
functions; the distributed modules ``core/mesh.py`` and
``parallel/fsdp.py`` too; the telemetry's ``obs/sink.py``,
``obs/spans.py``, ``obs/budget.py``, ``obs/heartbeat.py``,
``obs/report.py``, and the profiler's ``obs/profile.py``, ``obs/devprof.py``,
``obs/gauges.py``, ``obs/memprof.py`` and ``obs/trace.py``, which keep their
own copies of the JAX package's JAX-free parsers; the serving tier's
``serving/router.py`` and ``serving/loadgen.py``; Mixtral's routed
experts, ``ops/moe.py``; ``native/``, with its own
copy of the C++ loader's source), or ``chip_smoke.py`` as a module,
pulls in no JAX, flax, optax, orbax, transformers or safetensors and no
module of the JAX package (and
importing the script runs none of it); and the port's entry points refuse
to run quietly on the CPU when no GPU is present and the CPU was not asked
for."""

import json
import os
import pkgutil
import subprocess
import sys

import pytest
import torch

import distributed_llms_example_tpu_torch as port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the card's machine need not have transformers or safetensors: the port
# reads and writes HF checkpoints itself
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "distributed_llms_example_tpu",
             "transformers", "safetensors")


def _port_modules():
    return sorted(
        m.name for m in pkgutil.walk_packages(port.__path__, prefix=port.__name__ + ".")
    )


def test_port_imports_nothing_of_jax():
    mods = _port_modules()
    for name in ("serving.engine", "serving.cache_pool", "train.trainer", "models.llama",
                 "models.t5", "evaluation.generation", "data.prefetch", "utils.remat",
                 "ops.blockwise_ce", "core.mesh", "parallel.fsdp", "obs", "obs.sink",
                 "obs.spans", "obs.budget", "obs.heartbeat", "obs.report", "obs.profile",
                 "obs.devprof", "obs.gauges", "obs.memprof", "obs.trace", "serving.router",
                 "serving.loadgen", "native", "ops.moe", "ops.ring_attention",
                 "parallel.sharding", "parallel.activation"):
        assert f"distributed_llms_example_tpu_torch.{name}" in mods
    code = (
        "import importlib, json, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "print(json.dumps(sorted(sys.modules)))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120, check=True)
    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    bad = [m for m in loaded if m.split(".")[0] in FORBIDDEN]
    assert not bad, bad


def test_remat_imports_checkpointing_inside_its_functions():
    """``utils/remat.py`` imports ``torch.utils.checkpoint`` (the selective
    checkpointing of the ``dots`` policy among it) only inside the
    functions that use it, never at module level."""
    import ast

    path = os.path.join(REPO, "distributed_llms_example_tpu_torch", "utils", "remat.py")
    tree = ast.parse(open(path).read())
    top = [n for n in tree.body if isinstance(n, (ast.Import, ast.ImportFrom))]
    names = [a.name for n in top for a in n.names] + [
        n.module for n in top if isinstance(n, ast.ImportFrom) and n.module]
    assert not any("checkpoint" in x for x in names), names
    inner = [n for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)
             and n.module == "torch.utils.checkpoint"]
    assert len(inner) >= 2  # the dots policy's and maybe_checkpointed's


def test_chip_smoke_imports_nothing_of_jax_and_runs_nothing():
    code = (
        "import importlib.util, json, sys\n"
        "spec = importlib.util.spec_from_file_location('chip_smoke', 'chip_smoke.py')\n"
        "mod = importlib.util.module_from_spec(spec)\n"
        "spec.loader.exec_module(mod)\n"
        "from distributed_llms_example_tpu_torch.ops import flash_attention\n"
        "assert callable(mod.main) and mod.KERNELS\n"
        "print(json.dumps(sorted(sys.modules)))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120, check=True)
    lines = out.stdout.strip().splitlines()
    assert len(lines) == 1, lines  # importing the script printed nothing of its own
    loaded = json.loads(lines[0])
    bad = [m for m in loaded if m.split(".")[0] in FORBIDDEN]
    assert not bad, bad


def test_entry_points_refuse_the_cpu_unless_asked(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this check is about a machine without a GPU")
    from distributed_llms_example_tpu_torch.launch.cli import serve_main
    from distributed_llms_example_tpu_torch.models.registry import load_model
    from distributed_llms_example_tpu_torch.serving.engine import ServeConfig, ServingEngine

    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_model("bart-test")
    lm = load_model("bart-test", device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServingEngine(lm.module, lm.config, ServeConfig())
    prompts = tmp_path / "p.json"
    prompts.write_text(json.dumps(["a prompt"]))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_main(["--model-ckpt", "bart-test", "--prompts-file", str(prompts)])
    from distributed_llms_example_tpu_torch.launch.cli import main

    for sub in ("serve-router", "serve-loadgen"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main([sub, "--model-ckpt", "llama-test", "--prompts-file", str(prompts)])
    from distributed_llms_example_tpu_torch.launch.cli import train

    records = tmp_path / "train.json"
    records.write_text(json.dumps([{"dialogue": "a b c", "summary": "a"}] * 4))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train(["--model-ckpt", "bart-test", "--train-file", str(records), "--batch-size", "2"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_model("bart-test", train=True)


def test_native_loader_source_is_the_ports_own():
    """``native/`` builds from the port's copy of the C++ source (the same
    parser as the JAX package's), never from the JAX package's file."""
    from pathlib import Path

    from distributed_llms_example_tpu_torch import native

    assert native.SRC == Path(REPO, "distributed_llms_example_tpu_torch", "native",
                              "jsonl_loader.cc")
    port = native.SRC.read_text()
    with open(os.path.join(REPO, "distributed_llms_example_tpu", "native",
                           "jsonl_loader.cc")) as f:
        jax_src = f.read()
    body = lambda s: s[s.index("#include"):]  # noqa: E731  (the header comments differ)
    assert body(port) == body(jax_src)
