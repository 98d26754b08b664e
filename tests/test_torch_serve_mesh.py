"""``serve --mesh`` across two gloo ranks of the CPU (one subprocess a
rank, ``tests/torch_dist_worker.py``), fp32, held to the JAX package's
engine on one device with the same weights (the JAX init carried in an HF
directory; JAX ``tests/test_serving.py`` holds that engine on its 8-device
mesh to static batching, ``test_engine_matches_static_batching_causal``
and ``..._seq2seq``, whose set-ups these are):

- ``llama-test`` (GQA 4/2), 8 prompts of 3-14 bytes, W = 16, L = 8, 4
  slots, prefill chunks of 4, under ``tensor=2`` (each rank every slot at
  its 2 of 4 heads, 1 of 2 kv heads) and ``data=2`` (each rank 2 slot rows
  and 2 rows of every chunk), flat and paged (blocks of 8): every rank's
  greedy tokens equal the JAX engine's exactly;
- ``bart-test`` under ``data=2``, 8 prompts, W = 32, L = 12: the same;
- ``llama-test`` under ``data=2,tensor=2`` on four ranks, paged: the same;
- two steady rounds of a fresh session on each rank's engine run no op
  that reads a value back (the round's gathered tokens are its one read);
- each rank's slot state (or pool) has the shapes ``CACHE_LAYOUT`` and
  ``POOL_LAYOUT`` (JAX's ``CACHE_RULES`` and ``POOL_RULES``) give the
  one-GPU engine's, and under ``tensor=2`` a card holds half the one-GPU
  cache's bytes;
- JAX's divisibility ``ValueError`` for slots and prefill rows over the
  data shards, the engine's refusal of the prefix cache and speculative
  decode on a mesh, and every parse-time refusal: ``sequence`` (JAX's
  ``decode-sequence`` row), ``stage`` (``decode-pipelined``), ``fsdp``,
  ``expert``, BART and Mixtral under ``tensor``, a tensor size the kv heads
  do not divide, and any mesh in ``serve-router`` and ``serve-loadgen``.
"""

import json

import jax
import numpy as np
import pytest

from distributed_llms_example_tpu.analysis.composition import KNOWN_BAD
from distributed_llms_example_tpu.models.registry import load_model as jax_load_model
from distributed_llms_example_tpu.serving.engine import (
    ServeConfig as JaxServeConfig,
    ServingEngine as JaxServingEngine,
)
from distributed_llms_example_tpu_torch.data.tokenizer import ByteTokenizer
from distributed_llms_example_tpu_torch.launch import cli
from distributed_llms_example_tpu_torch.models.registry import load_model
from distributed_llms_example_tpu_torch.serving.engine import (
    ServeConfig,
    ServeLayout,
    ServingEngine,
    serve_features_error,
)
from torch_dist_helpers import hf_dir, spawn

SLOTS = 4
# family: (registry name, prompt width W, new tokens L)
MODELS = {"llama": ("llama-test", 16, 8), "bart": ("bart-test", 32, 12)}
PAGED = ("--paged-kv", "--kv-block-size", "8")
# name: (family, --mesh, extra flags)
RUNS = {
    "llama_tensor2_flat": ("llama", "tensor=2", ()),
    "llama_tensor2_paged": ("llama", "tensor=2", PAGED),
    "llama_data2_flat": ("llama", "data=2", ()),
    "llama_data2_paged": ("llama", "data=2", PAGED),
    "bart_data2": ("bart", "data=2", ()),
}
# on four ranks
RUNS4 = {"llama_data2_tensor2_paged": ("llama", "data=2,tensor=2", PAGED)}

# The serving state's layout, the JAX package's CACHE_RULES and POOL_RULES:
# the mesh axis each dimension of a leaf splits over.  The slot cache's K/V
# are (slots, kv heads, length, head_dim), its int8 scales (slots, kv heads,
# length): slot rows over data, heads over tensor.  The paged pool's K/V are
# (blocks, kv heads, block size, head_dim): the blocks never split over
# data, heads over tensor.
CACHE_LAYOUT = {"kv": ("data", "tensor", None, None), "scale": ("data", "tensor", None)}
POOL_LAYOUT = {"kv": (None, "tensor", None, None), "scale": (None, "tensor", None)}


def local_shape(shape, layout, sizes):
    """A leaf's ``shape`` on one rank: each dimension its ``layout`` names
    an axis for divided by that axis's size."""
    return tuple(n // int(sizes.get(a, 1)) if a else n for n, a in zip(shape, layout))


def _texts(n=8, seed=9):
    rng = np.random.RandomState(seed)
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz "))
    return ["".join(rng.choice(letters, rng.randint(3, 15))) for _ in range(n)]


def _argv(ckpt, prompts, out, mesh, family, extra=()):
    _, w, l = MODELS[family]
    return ["--device", "cpu", "--model-ckpt", str(ckpt), "--prompts-file", str(prompts),
            "--output-file", str(out), "--mesh", mesh, "--tokenizer", "byte",
            "--compute-dtype", "float32", "--lint", "off", "--max-slots", str(SLOTS),
            "--prefill-batch", str(SLOTS), "--max-source-length", str(w),
            "--max-new-tokens", str(l), "--log-every-steps", "0", *extra]


def _jax_engine_tokens(family, texts):
    name, w, l = MODELS[family]
    lm = jax_load_model(name)
    params = jax.device_get(lm.init_params(0))
    tok = ByteTokenizer()
    seq2seq = family == "bart"
    reqs = [(tok.encode_source if seq2seq else tok.encode_prompt)(t, w) for t in texts]
    cfg = JaxServeConfig(max_slots=SLOTS, prefill_batch=SLOTS, max_new_tokens=l,
                         max_source_length=w, log_every_steps=0)
    return JaxServingEngine(lm.module, lm.config, None, cfg, is_seq2seq=seq2seq).generate(
        params, reqs)


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """One pair of gloo ranks serving every run in turn, and the JAX
    engine's tokens of each family."""
    tmp = tmp_path_factory.mktemp("serve_mesh")
    texts = _texts()
    prompts = tmp / "prompts.json"
    prompts.write_text(json.dumps(texts))
    ckpts = {f: hf_dir(tmp / f, MODELS[f][0]) for f in MODELS}
    runs = [_argv(ckpts[f], prompts, tmp / f"{name}.jsonl", mesh, f, extra)
            for name, (f, mesh, extra) in RUNS.items()]
    _, logs, got = spawn({"serve": {"runs": runs}}, 2, tmp, name="serve")
    return {"runs": dict(zip(RUNS, got["runs"])), "logs": logs, "tmp": tmp, "texts": texts,
            "ckpts": ckpts, "jax": {f: _jax_engine_tokens(f, texts) for f in MODELS}}


@pytest.fixture(scope="module")
def served4(served):
    tmp = served["tmp"]
    runs = [_argv(served["ckpts"][f], tmp / "prompts.json", tmp / f"{name}.jsonl", mesh, f,
                  extra) for name, (f, mesh, extra) in RUNS4.items()]
    _, logs, got = spawn({"serve": {"runs": runs}}, 4, tmp, name="serve4")
    return {"runs": dict(zip(RUNS4, got["runs"])), "logs": logs}


@pytest.mark.parametrize("run", list(RUNS) + list(RUNS4))
def test_every_rank_serves_the_jax_engine_tokens(served, served4, run):
    family = {**RUNS, **RUNS4}[run][0]
    want = served["jax"][family]
    ranks = served if run in RUNS else served4
    got = ranks["runs"][run]["outputs"]
    assert len(got) == len(ranks["logs"]) and all(outs == want for outs in got), (run, got)
    # rank 0 alone writes the outputs
    lines = (served["tmp"] / f"{run}.jsonl").read_text().splitlines()
    assert len(lines) == len(served["texts"])
    assert not [x for log in ranks["logs"][1:] for x in log.splitlines() if x.startswith("{")]


@pytest.mark.parametrize("run", list(RUNS) + list(RUNS4))
def test_steady_rounds_read_back_only_their_tokens(served, served4, run):
    got = (served if run in RUNS else served4)["runs"][run]
    assert got["steady_rounds"] == 4 and got["syncing_ops"] == {}, got["syncing_ops"]


def _one_gpu_state(family, paged):
    name, w, l = MODELS[family]
    lm = load_model(name, device="cpu")
    kw = dict(paged_kv=True, kv_block_size=8) if paged else {}
    eng = ServingEngine(lm.module, lm.config,
                        ServeConfig(max_slots=SLOTS, prefill_batch=SLOTS, max_new_tokens=l,
                                    max_source_length=w, **kw),
                        is_seq2seq=family == "bart", device="cpu")
    from distributed_llms_example_tpu_torch.ops.mha import kv_leaves

    state = eng._init_state()
    trees = state["pool"] if paged else [kv_leaves(c) for c in state["cache"]]
    return [[tuple(x.shape) for x in leaves] for leaves in trees]


@pytest.mark.parametrize("run", list(RUNS) + list(RUNS4))
def test_rank_state_follows_the_serving_layout(served, served4, run):
    family, mesh, extra = {**RUNS, **RUNS4}[run]
    paged = bool(extra)
    sizes = {k: int(v) for k, v in (kv.split("=") for kv in mesh.split(","))}
    layout = POOL_LAYOUT if paged else CACHE_LAYOUT
    want = [[local_shape(s, layout["kv" if len(s) == 4 else "scale"], sizes) for s in leaves]
            for leaves in _one_gpu_state(family, paged)]
    assert (served if run in RUNS else served4)["runs"][run]["kv_shapes"] == want


def test_a_tensor_rank_holds_half_the_cache(served):
    """Under tensor=2 a card's slot cache and pool hold half the one-GPU
    bytes (one of two kv heads); under data=2 a card's slot cache holds
    half the slot rows and its pool is whole."""
    runs = served["runs"]
    flat = sum(int(np.prod(s)) * 4 for leaves in _one_gpu_state("llama", False) for s in leaves)
    pool = sum(int(np.prod(s)) * 4 for leaves in _one_gpu_state("llama", True) for s in leaves)
    assert runs["llama_tensor2_flat"]["resident"] * 2 == flat
    assert runs["llama_data2_flat"]["resident"] * 2 == flat
    assert runs["llama_tensor2_paged"]["pool_bytes"] * 2 == pool
    assert runs["llama_data2_paged"]["pool_bytes"] == pool


@pytest.mark.parametrize("slots,prefill", [(3, 2), (4, 3)])
def test_slots_and_prefill_rows_must_divide_over_data(slots, prefill):
    lm = load_model("llama-test", device="cpu")
    bad = "max_slots" if slots % 2 else "prefill_batch"
    with pytest.raises(ValueError, match=f"{bad}=3 must divide evenly over the mesh's 2 batch "
                                         "shards"):
        ServingEngine(lm.module, lm.config,
                      ServeConfig(max_slots=slots, prefill_batch=prefill, max_new_tokens=8,
                                  max_source_length=16),
                      is_seq2seq=False, device="cpu", layout=ServeLayout(data=2))


REASONS = {c.id: c.reason for c in KNOWN_BAD}
# name: (--mesh, model, the message or a JAX composition row's id, entry point)
REFUSALS = {
    "sequence": ("sequence=2", "llama-test", "decode-sequence", cli.serve),
    "stage": ("stage=2", "llama-test", "decode-pipelined", cli.serve),
    "fsdp": ("fsdp=2", "llama-test", "ROADMAP.md order item 3", cli.serve),
    "expert": ("expert=2", "mixtral-test", "ROADMAP.md order item 6", cli.serve),
    "bart_tensor": ("tensor=2", "bart-test", "ROADMAP.md order item 4", cli.serve),
    "t5_tensor": ("tensor=2", "t5-test", "ROADMAP.md order item 4", cli.serve),
    "mixtral_tensor": ("tensor=2", "mixtral-test", "ROADMAP.md order item 6", cli.serve),
    "kv_heads_ragged": ("tensor=4", "llama-test", "tensor=4 does not divide {'kv heads': 2}",
                        cli.serve),
    "router_data": ("data=2", "llama-test", "serve on one GPU", cli.serve_router),
    "loadgen_tensor": ("tensor=2", "llama-test", "serve on one GPU", cli.serve_loadgen),
}


@pytest.mark.parametrize("case", list(REFUSALS))
def test_refusals_at_parse_time(tmp_path, case):
    """Each layout this slice does not serve stops before a group or a
    model exists, naming the JAX package's row or its ROADMAP.md item."""
    mesh, model, want, entry = REFUSALS[case]
    prompts = tmp_path / "p.json"
    prompts.write_text(json.dumps(["x"]))
    with pytest.raises(SystemExit) as e:
        entry(["--device", "cpu", "--model-ckpt", model, "--prompts-file", str(prompts),
               "--mesh", mesh, "--lint", "off"])
    assert REASONS.get(want, want) in str(e.value)


@pytest.mark.parametrize("flag", ["prefix_cache", "spec_tokens"])
def test_prefix_cache_and_speculation_stay_on_one_gpu(flag):
    kw = {"prefix_cache": flag == "prefix_cache", "spec_tokens": 3 * (flag == "spec_tokens")}
    assert serve_features_error({"data": 1, "tensor": 1}, **kw) is None
    why = serve_features_error({"data": 2, "tensor": 1}, **kw)
    assert "ROADMAP.md order item 1" in why
    lm = load_model("llama-test", device="cpu")
    with pytest.raises(ValueError, match="ROADMAP.md order item 1"):
        ServingEngine(lm.module, lm.config,
                      ServeConfig(max_slots=4, max_new_tokens=8, max_source_length=16,
                                  paged_kv=True, kv_block_size=8,
                                  prefix_cache=kw["prefix_cache"], spec_tokens=kw["spec_tokens"]),
                      is_seq2seq=False, device="cpu", layout=ServeLayout(tensor=2))
