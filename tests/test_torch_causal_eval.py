"""The port's causal eval pass (``Evaluator._run_causal``) against the JAX
``Evaluator`` on ``llama-test`` (fp32, the JAX seed-0 init): 5 validation
records of ``CausalLMDataset`` at eval batch 2 (the last batch wraps
around to the corpus start and its extra row is trimmed), prompts
right-padded to the bucket of each batch's longest, greedy and beam 2;
ROUGE within 1e-9.  The references of the first three records are the
port's own continuations of their prompts alone, the last two's a word it
never generates, so ROUGE is neither 0 nor 1."""

import jax
import numpy as np
import pytest

from distributed_llms_example_tpu.core.config import MeshConfig
from distributed_llms_example_tpu.core.mesh import build_mesh
from distributed_llms_example_tpu.data import dataset as jdataset
from distributed_llms_example_tpu.data.tokenizer import ByteTokenizer as JaxByteTokenizer
from distributed_llms_example_tpu.evaluation.evaluate import Evaluator as JaxEvaluator
from distributed_llms_example_tpu.models.registry import load_model as jax_load_model
from distributed_llms_example_tpu_torch.data.dataset import CausalLMDataset
from distributed_llms_example_tpu_torch.data.tokenizer import ByteTokenizer
from distributed_llms_example_tpu_torch.evaluation.evaluate import Evaluator
from distributed_llms_example_tpu_torch.models.from_jax import load_jax_params
from distributed_llms_example_tpu_torch.models.registry import load_model

NEW = 8


def _wordy_llama_params():
    """llama-test's seed-0 init with the LM head's columns for 'a', 'b' and
    the space (byte id + 2) and eos set to a multiple of the final norm's
    mean direction: the random logits pick among them, so continuations
    are short words."""
    lm = jax_load_model("llama-test")
    params = jax.device_get(lm.init_params(0))
    head = np.array(params["lm_head"]["kernel"], dtype=np.float32)  # (D, V)
    for tok in [ord(c) + 2 for c in "ab "] + [lm.config.eos_token_id]:
        head[:, tok] = 0.5 * np.sign(head[:, tok])
    params = dict(params)
    params["lm_head"] = {"kernel": head}
    return lm, params


@pytest.mark.parametrize("beams", [1, 2])
def test_causal_evaluator_rouge_matches_jax(beams):
    lm, params = _wordy_llama_params()
    tlm = load_model("llama-test", device="cpu")
    load_jax_params(tlm.module, params)
    tok = ByteTokenizer()
    ev = Evaluator(tlm.module, tlm.config, tok, num_beams=beams, max_new_tokens=NEW,
                   is_seq2seq=False)
    rng = np.random.RandomState(3)
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz   "))
    recs = []
    for i in range(5):
        prompt = "".join(rng.choice(letters, rng.randint(10, 50)))
        ids = ev.generator.run(*(x[None] for x in _prompt(tok, prompt)))
        alone = ev._decode_batch(ids.numpy())[0]
        recs.append({"dialogue": prompt, "summary": alone if i < 3 else "zz"})
    kw = dict(max_length=64, max_target_length=16)
    jds = jdataset.CausalLMDataset(recs, JaxByteTokenizer(), **kw)
    mesh = build_mesh(MeshConfig(data=1), devices=jax.devices()[:1])
    jev = JaxEvaluator(lm.module, lm.config, JaxByteTokenizer(), mesh, num_beams=beams,
                       max_new_tokens=NEW, is_seq2seq=False)
    run = dict(global_batch=2, bucket_multiple=32, max_source_length=64)
    want = jev.run(params, jds, **run)
    tlm.module.train()
    got = ev.run(CausalLMDataset(recs, tok, **kw), **run)
    assert tlm.module.training  # the pass ran in eval mode and restored the mode
    assert set(got) == set(want) == {"rouge1", "rouge2", "rougeL", "rougeLsum"}
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-9, (k, got[k], want[k])
    assert got["rouge1"] > 0.0, got  # words were generated and scored


def _prompt(tok, text):
    import torch

    ids = torch.tensor(CausalLMDataset([{"dialogue": text, "summary": "zz"}], tok,
                                       max_length=64, max_target_length=16)[0].prompt_ids)
    return ids, torch.ones_like(ids)
