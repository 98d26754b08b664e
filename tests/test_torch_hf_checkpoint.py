"""Local HF checkpoints in and out of the port (``models/registry.py``'s
directory loading, ``models/convert.py``, ``models/export.py``,
``io/safetensors.py``, ``io/valohai_meta.py``), against the JAX package
and ``transformers`` on the CPU.

- For t5-test, bart-test and llama-test, an HF checkpoint written by
  ``transformers`` in three layouts (one ``model.safetensors``, shards with
  ``model.safetensors.index.json``, ``pytorch_model.bin``) loads through the
  JAX ``load_model(dir)`` and the port's: the port's state dict equals
  ``from_jax`` of the JAX tree exactly, and fp32 logits agree within 1e-5.
- The port's export of ``from_jax(params)`` holds exactly the tensors and
  the ``config.json`` dict of the JAX ``save_hf_checkpoint(params)``, in one
  file and in shards; ``transformers`` loads it with no unexpected keys, to
  the port's logits within 5e-4 (the JAX export test's limit: another
  implementation's fp32 sums).
- The port's safetensors files load with the ``safetensors`` library and
  the library's with the port's reader, every dtype the port reads.
- The Valohai sidecars equal the JAX module's bytes for a fixed
  ``execution.json``.
"""

import json
import os

import jax
import numpy as np
import pytest
import safetensors.torch
import torch
import transformers

from distributed_llms_example_tpu.io import valohai_meta as jax_meta
from distributed_llms_example_tpu.models import export as jax_export
from distributed_llms_example_tpu.models.registry import load_model as jax_load_model
from distributed_llms_example_tpu_torch.io import safetensors as port_st
from distributed_llms_example_tpu_torch.io import valohai_meta as port_meta
from distributed_llms_example_tpu_torch.models import export as port_export
from distributed_llms_example_tpu_torch.models.from_jax import (
    bart_state_dict_from_jax,
    blocks_state_dict_from_jax,
    load_jax_params,
)
from distributed_llms_example_tpu_torch.models.registry import load_model

FAMILIES = {"t5-test": "t5", "bart-test": "bart", "llama-test": "llama"}
FROM_JAX = {"t5": blocks_state_dict_from_jax, "bart": bart_state_dict_from_jax,
            "llama": blocks_state_dict_from_jax}
LAYOUTS = ("safetensors", "sharded", "bin")


@pytest.fixture(autouse=True)
def _no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _jax_params(name):
    return jax.device_get(jax_load_model(name).init_params(0))


def _hf_model(name, tmp_path):
    """A transformers model holding the JAX package's init of ``name``."""
    src = tmp_path / "jax_export"
    jax_export.save_hf_checkpoint(str(src), FAMILIES[name], jax_load_model(name).config,
                                  _jax_params(name))
    auto = (transformers.AutoModelForCausalLM if FAMILIES[name] == "llama"
            else transformers.AutoModelForSeq2SeqLM)
    return auto.from_pretrained(str(src), attn_implementation="eager").eval()


def _write(hf_model, path, layout):
    if layout == "safetensors":
        hf_model.save_pretrained(path, safe_serialization=True)
    elif layout == "sharded":
        hf_model.save_pretrained(path, safe_serialization=True, max_shard_size="40KB")
    else:
        hf_model.save_pretrained(path, safe_serialization=False)
    files = set(os.listdir(path))
    want = {"safetensors": "model.safetensors", "sharded": "model.safetensors.index.json",
            "bin": "pytorch_model.bin"}[layout]
    assert want in files, files
    return str(path)


def _ids(seq2seq):
    rng = np.random.RandomState(0)
    ids = rng.randint(3, 250, (2, 12)).astype(np.int32)
    return ids, np.ones_like(ids), (rng.randint(3, 250, (2, 6)).astype(np.int32)
                                    if seq2seq else None)


def _port_logits(module, ids, mask, dec):
    t = lambda x: torch.tensor(x, dtype=torch.long)  # noqa: E731
    with torch.no_grad():
        if dec is None:
            return module(t(ids), t(mask)).numpy()
        return module(t(ids), t(mask), t(dec)).numpy()


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("name", list(FAMILIES))
def test_port_loads_the_checkpoint_the_jax_package_loads(name, layout, tmp_path):
    path = _write(_hf_model(name, tmp_path), tmp_path / layout, layout)
    jlm = jax_load_model(path)
    lm = load_model(path, device="cpu")
    want = FROM_JAX[FAMILIES[name]](jax.device_get(jlm.params))
    got = lm.module.state_dict()
    if getattr(lm.config, "tie_word_embeddings", False) and "lm_head.weight" in want:
        # a tied T5's pytorch_model.bin carries the head, the tied copy of
        # shared: the JAX tree keeps it unused, the port drops it
        assert torch.equal(want.pop("lm_head.weight"), want["shared.weight"])
    assert set(got) == set(want), set(got) ^ set(want)
    for k in got:
        assert got[k].dtype == torch.float32 and torch.equal(got[k], want[k]), k
    ids, mask, dec = _ids(lm.is_seq2seq)
    args = (ids, mask) if dec is None else (ids, mask, dec)
    ref = np.asarray(jlm.module.apply({"params": jlm.params}, *args))
    np.testing.assert_allclose(_port_logits(lm.module, ids, mask, dec), ref, atol=1e-5, rtol=0)


def test_train_build_keeps_fp32_master_weights(tmp_path):
    """A bf16 checkpoint loads as fp32 master weights for training."""
    hf = _hf_model("bart-test", tmp_path).to(torch.bfloat16)
    path = _write(hf, tmp_path / "bf16", "safetensors")
    lm = load_model(path, device="cpu", dtype=torch.bfloat16, train=True)
    assert {p.dtype for p in lm.module.parameters()} == {torch.float32}
    assert lm.module.training and lm.config.attn_dropout_rate == 0.0
    shared = hf.state_dict()["model.shared.weight"]
    assert torch.equal(lm.module.shared.weight, shared.float())


def test_config_fields_and_refusals(tmp_path):
    path = _write(_hf_model("bart-test", tmp_path), tmp_path / "ckpt", "safetensors")
    cfg = json.loads(open(os.path.join(path, "config.json")).read())
    cfg["attention_dropout"] = 0.25
    open(os.path.join(path, "config.json"), "w").write(json.dumps(cfg))
    assert load_model(path, device="cpu").config.attn_dropout_rate == 0.25
    assert jax_load_model(path, load_weights=False).config.attn_dropout_rate == 0.25
    cfg["model_type"] = "mixtral"
    open(os.path.join(path, "config.json"), "w").write(json.dumps(cfg))
    with pytest.raises(NotImplementedError, match="later slice"):
        load_model(path, device="cpu")
    cfg["model_type"] = "gpt2"
    open(os.path.join(path, "config.json"), "w").write(json.dumps(cfg))
    with pytest.raises(ValueError, match="unsupported model_type"):
        load_model(path, device="cpu")
    os.remove(os.path.join(path, "model.safetensors"))
    cfg["model_type"] = "bart"
    open(os.path.join(path, "config.json"), "w").write(json.dumps(cfg))
    with pytest.raises(FileNotFoundError):
        load_model(path, device="cpu")


def _lib_tensors(path):
    """{name: tensor} of an export directory, read by the safetensors
    library (one file or shards)."""
    index = os.path.join(path, "model.safetensors.index.json")
    files = (sorted(set(json.load(open(index))["weight_map"].values())) if os.path.exists(index)
             else ["model.safetensors"])
    out = {}
    for f in files:
        out.update(safetensors.torch.load_file(os.path.join(path, f)))
    return out


@pytest.mark.parametrize("sharded", [False, True])
@pytest.mark.parametrize("name", list(FAMILIES))
def test_port_export_equals_the_jax_export(name, sharded, tmp_path, monkeypatch):
    family = FAMILIES[name]
    if sharded:  # a shard limit this small splits every test model
        monkeypatch.setattr(port_export, "MAX_SHARD_BYTES", 30_000)
        monkeypatch.setattr(jax_export, "MAX_SHARD_BYTES", 30_000)
    params = _jax_params(name)
    jdir, pdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jax_export.save_hf_checkpoint(jdir, family, jax_load_model(name).config, params)
    lm = load_model(name, device="cpu")
    load_jax_params(lm.module, params)
    port_export.save_hf_checkpoint(pdir, family, lm.config, lm.module.state_dict())
    if sharded:
        # the same total and tensors under the same file names; which shard
        # holds a tensor (and so their count) follows each package's
        # parameter order
        pidx, jidx = (json.load(open(os.path.join(d, "model.safetensors.index.json")))
                      for d in (pdir, jdir))
        assert pidx["metadata"] == jidx["metadata"]
        assert set(pidx["weight_map"]) == set(jidx["weight_map"])
        n = len(set(pidx["weight_map"].values()))
        assert n > 3 and set(os.listdir(pdir)) == {
            "config.json", "model.safetensors.index.json",
            *(f"model-{k:05d}-of-{n:05d}.safetensors" for k in range(1, n + 1))}
    else:
        assert sorted(os.listdir(pdir)) == sorted(os.listdir(jdir))
    for f in ("config.json",):
        assert json.load(open(os.path.join(pdir, f))) == json.load(open(os.path.join(jdir, f)))
    got, want = _lib_tensors(pdir), _lib_tensors(jdir)
    assert set(got) == set(want), set(got) ^ set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype == torch.float32 and torch.equal(got[k], want[k]), k
    # and the export reloads into the port bit for bit
    back = load_model(pdir, device="cpu").module.state_dict()
    assert all(torch.equal(back[k], v) for k, v in lm.module.state_dict().items())


_TIED_OK = ("embed_tokens", "lm_head.weight", "final_logits_bias", "shared.weight")


@pytest.mark.parametrize("name", list(FAMILIES))
def test_transformers_loads_the_port_export(name, tmp_path):
    lm = load_model(name, device="cpu", seed=5)
    out = str(tmp_path / "export")
    port_export.save_hf_checkpoint(out, FAMILIES[name], lm.config, lm.module.state_dict())
    auto = (transformers.AutoModelForCausalLM if FAMILIES[name] == "llama"
            else transformers.AutoModelForSeq2SeqLM)
    hf, info = auto.from_pretrained(out, output_loading_info=True, attn_implementation="eager")
    assert info["unexpected_keys"] == [] and info.get("mismatched_keys", []) == []
    assert not [k for k in info["missing_keys"] if not any(t in k for t in _TIED_OK)]
    ids, mask, dec = _ids(lm.is_seq2seq)
    t = lambda x: torch.tensor(x, dtype=torch.long)  # noqa: E731
    with torch.no_grad():
        kw = {} if dec is None else {"decoder_input_ids": t(dec)}
        ref = hf.eval()(input_ids=t(ids), attention_mask=t(mask), **kw).logits.numpy()
    np.testing.assert_allclose(_port_logits(lm.module, ids, mask, dec), ref, atol=5e-4, rtol=3e-3)


TENSORS = {
    "f32": torch.randn(3, 5, generator=torch.Generator().manual_seed(0)),
    "bf16": torch.randn(7, generator=torch.Generator().manual_seed(1)).to(torch.bfloat16),
    "f16": torch.randn(2, 3, generator=torch.Generator().manual_seed(2)).to(torch.float16),
    "i64": torch.arange(-4, 5, dtype=torch.int64),
    "i32": torch.arange(6, dtype=torch.int32).reshape(2, 3),
    "empty": torch.zeros(0, 4),
    "scalar": torch.tensor(2.5),
}


def test_safetensors_files_are_compatible_both_ways(tmp_path):
    mine, lib = tmp_path / "port.safetensors", tmp_path / "lib.safetensors"
    port_st.save_file(TENSORS, mine, metadata={"format": "pt"})
    safetensors.torch.save_file(TENSORS, lib, metadata={"format": "pt"})
    for read in (safetensors.torch.load_file(mine), port_st.load_file(lib),
                 port_st.load_file(mine)):
        assert set(read) == set(TENSORS)
        for k, v in TENSORS.items():
            assert read[k].dtype == v.dtype and read[k].shape == v.shape
            assert torch.equal(read[k], v), k
    with open(mine, "rb") as f:
        n = int.from_bytes(f.read(8), "little")
        assert n % 8 == 0 and json.loads(f.read(n))["__metadata__"] == {"format": "pt"}


def test_valohai_sidecars_equal_the_jax_modules(tmp_path):
    cfg = tmp_path / "execution.json"
    cfg.write_text(json.dumps({"valohai.project-name": "org/summaries",
                               "valohai.execution-id": "0188-abc"}))
    outs = []
    for meta, sub in ((port_meta, "port"), (jax_meta, "jax")):
        d = tmp_path / sub
        d.mkdir()
        (d / "config.json").write_text("{}")
        (d / "model.safetensors").write_bytes(b"\0" * 8)
        written = meta.save_valohai_metadata(str(d), str(cfg))
        outs.append({os.path.basename(p): open(p, "rb").read() for p in written})
    assert outs[0] == outs[1] and len(outs[0]) == 2
    assert port_meta.get_run_identification(str(tmp_path / "missing.json"))[0] == "test"
