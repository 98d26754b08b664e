"""``serve --device cpu`` end to end through the port's CLI on a temporary
prompts file: one output record per prompt, the serve_summary event, and
the one-device ``--mesh`` rule."""

import json

import pytest

from distributed_llms_example_tpu_torch.launch.cli import check_single_device_mesh, serve_main


def _args(prompts, out, *extra):
    return [
        "--device", "cpu", "--model-ckpt", "bart-test", "--lint", "off",
        "--prompts-file", str(prompts), "--output-file", str(out),
        "--max-slots", "2", "--max-new-tokens", "8", "--max-source-length", "64",
        *extra,
    ]


def test_serve_cpu_end_to_end(tmp_path, capsys):
    prompts = tmp_path / "prompts.jsonl"
    texts = ["first prompt", "a second, longer prompt " * 3, "third", "fourth one"]
    prompts.write_text("\n".join(json.dumps({"article": t}) for t in texts) + "\n")
    out = tmp_path / "out" / "serve.jsonl"
    assert serve_main(_args(prompts, out, "--prefill-buckets", "16,32")) == 0
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
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        serve_main(_args(prompts, tmp_path / "o.jsonl", "--paged-kv"))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        serve_main(_args(prompts, tmp_path / "o.jsonl", "--model-ckpt", "llama-test"))


def test_mesh_must_be_one_device():
    check_single_device_mesh("data=-1")
    check_single_device_mesh("data=1,tensor=1")
    with pytest.raises(SystemExit, match="one GPU"):
        check_single_device_mesh("data=2")
