"""``serve --device cpu`` end to end through the port's CLI on a temporary
prompts file (``bart-test`` and ``t5-test``): one output record per
prompt, the serve_summary event, and the one-device ``--mesh`` rule; and
``llama-test --paged-kv`` against the JAX CLI on the same file and
weights: causal prompts carry no trailing eos, and the output records are
equal; the same for ``llama-test`` served from a local HF checkpoint
directory."""

import json

import jax
import pytest

from distributed_llms_example_tpu.launch.cli import serve_main as jax_serve_main
from distributed_llms_example_tpu.models.registry import load_model as jax_load_model
from distributed_llms_example_tpu_torch.data.tokenizer import ByteTokenizer
from distributed_llms_example_tpu_torch.launch.cli import check_single_device_mesh, serve_main
from distributed_llms_example_tpu_torch.models import registry
from distributed_llms_example_tpu_torch.models.from_jax import load_jax_params
from distributed_llms_example_tpu_torch.serving.engine import ServingEngine


def _args(prompts, out, *extra, model="bart-test"):
    return [
        "--device", "cpu", "--model-ckpt", model, "--lint", "off",
        "--prompts-file", str(prompts), "--output-file", str(out),
        "--max-slots", "2", "--max-new-tokens", "8", "--max-source-length", "64",
        *extra,
    ]


@pytest.mark.parametrize("model", ["bart-test", "t5-test"])
def test_serve_cpu_end_to_end(tmp_path, capsys, model):
    prompts = tmp_path / "prompts.jsonl"
    texts = ["first prompt", "a second, longer prompt " * 3, "third", "fourth one"]
    prompts.write_text("\n".join(json.dumps({"article": t}) for t in texts) + "\n")
    out = tmp_path / "out" / "serve.jsonl"
    assert serve_main(_args(prompts, out, "--prefill-buckets", "16,32", model=model)) == 0
    recs = [json.loads(line) for line in out.read_text().splitlines()]
    assert [r["prompt"] for r in recs] == texts
    assert all(set(r) == {"prompt", "output", "tokens"} for r in recs)
    assert all(0 <= r["tokens"] <= 8 for r in recs)
    events = [json.loads(x) for x in capsys.readouterr().out.splitlines() if x.startswith("{")]
    summary = next(e for e in events if e.get("event") == "serve_summary")
    assert summary["sequences"] == len(texts) and summary["prefill_buckets"] == [16, 32, 64]
    assert any(e.get("event") == "serve_output" and e["records"] == len(texts) for e in events)


def test_serve_rejects_later_slices(tmp_path):
    prompts = tmp_path / "p.json"
    prompts.write_text(json.dumps(["x"]))
    # the serving features run since their slice: what still stops is a
    # composition the JAX engine refuses, --spec-tokens out of range at
    # parse time, and Mixtral
    with pytest.raises(ValueError, match="requires paged_kv"):
        serve_main(_args(prompts, tmp_path / "o.jsonl", "--prefix-cache"))
    for k in ("8", "-1"):
        with pytest.raises(SystemExit):
            serve_main(_args(prompts, tmp_path / "o.jsonl", "--spec-tokens", k))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        serve_main(_args(prompts, tmp_path / "o.jsonl", "--model-ckpt", "mixtral-test"))


def test_mesh_must_be_one_device():
    check_single_device_mesh("data=-1")
    check_single_device_mesh("data=1,tensor=1")
    with pytest.raises(SystemExit, match="one GPU"):
        check_single_device_mesh("data=2")


def test_serve_llama_paged_matches_jax_cli(tmp_path, monkeypatch):
    """``serve --model-ckpt llama-test --paged-kv`` on the CPU with the JAX
    CLI's weights (its ``init_params(0)``, carried by ``from_jax``): the
    requests are ``encode_prompt`` ids (no trailing eos) and the output
    records equal the JAX CLI's on the same prompts file."""
    texts = ["a causal prompt", "another, somewhat longer causal prompt " * 2, "x",
             "the fourth prompt", "five"]
    prompts = tmp_path / "prompts.json"
    prompts.write_text(json.dumps(texts))
    common = ["--model-ckpt", "llama-test", "--prompts-file", str(prompts), "--lint", "off",
              "--max-slots", "8", "--max-new-tokens", "8", "--max-source-length", "64",
              "--compute-dtype", "float32", "--paged-kv", "--kv-block-size", "8"]
    out_j, out_t = tmp_path / "jax.jsonl", tmp_path / "port.jsonl"
    assert jax_serve_main([*common, "--output-file", str(out_j)]) == 0

    params = jax.device_get(jax_load_model("llama-test").init_params(0))
    real_load, real_generate = registry.load_model, ServingEngine.generate
    seen = []

    def load_with_jax_weights(*a, **k):
        lm = real_load(*a, **k)
        load_jax_params(lm.module, params)
        return lm

    def generate(self, requests, **k):
        seen.extend(requests)
        return real_generate(self, requests, **k)

    monkeypatch.setattr(registry, "load_model", load_with_jax_weights)
    monkeypatch.setattr(ServingEngine, "generate", generate)
    assert serve_main([*common, "--device", "cpu", "--output-file", str(out_t)]) == 0
    tok = ByteTokenizer()
    assert seen == [tok.encode_prompt(t, 64) for t in texts]
    assert all(r[-1] != tok.eos_id for r in seen)
    read = lambda p: [json.loads(line) for line in p.read_text().splitlines()]  # noqa: E731
    assert read(out_t) == read(out_j)


def test_serve_llama_from_an_hf_dir_matches_jax_cli(tmp_path):
    """``serve --model-ckpt <llama-test HF checkpoint dir>`` (written by the
    JAX package's export of its init_params(0), with attention_dropout set,
    which serving never applies): the port reads the weights from the
    directory and its output records equal the JAX CLI's on the same
    prompts file and directory (flat cache)."""
    from distributed_llms_example_tpu.models.export import save_hf_checkpoint

    lm = jax_load_model("llama-test")
    ckpt = tmp_path / "llama-hf"
    save_hf_checkpoint(str(ckpt), "llama", lm.config, jax.device_get(lm.init_params(0)))
    cfg = json.loads((ckpt / "config.json").read_text())
    (ckpt / "config.json").write_text(json.dumps({**cfg, "attention_dropout": 0.1}))
    texts = ["a causal prompt", "another, somewhat longer causal prompt " * 2, "x", "four"]
    prompts = tmp_path / "prompts.json"
    prompts.write_text(json.dumps(texts))
    common = ["--model-ckpt", str(ckpt), "--prompts-file", str(prompts), "--lint", "off",
              "--max-slots", "8", "--max-new-tokens", "8", "--max-source-length", "64",
              "--compute-dtype", "float32"]
    out_j, out_t = tmp_path / "jax.jsonl", tmp_path / "port.jsonl"
    assert jax_serve_main([*common, "--output-file", str(out_j)]) == 0
    assert serve_main([*common, "--device", "cpu", "--output-file", str(out_t)]) == 0
    read = lambda p: [json.loads(line) for line in p.read_text().splitlines()]  # noqa: E731
    assert read(out_t) == read(out_j) and len(read(out_t)) == len(texts)
