"""The port's eval pass (``evaluation/evaluate.py``, ``rouge.py``,
``metrics.py``) and its eval loader against the JAX package's, on the CPU:
the ``Evaluator``'s ROUGE within 1e-9 of the JAX ``Evaluator`` on the same
``bart-test`` weights, 5 validation records at eval batch 2 (the last batch
wraps around and its repeated row is trimmed), greedy and beam 2; the
weights are the seed-0 init with ``final_logits_bias`` raised on a few
letters, so that the summaries hold words and ROUGE is not 0.  Also: the
port's ``rouge.compute`` equal to JAX's on fixed strings; the eval
loader's arrays (corpus order, the last batch wrapped around, a corpus
smaller than one batch) and the training loader's equal to JAX's; the
single-process mean; the model's mode restored after a pass; the causal
pass on its own dataset."""

import jax
import numpy as np
import pytest
import torch

from distributed_llms_example_tpu.core.config import MeshConfig
from distributed_llms_example_tpu.core.mesh import build_mesh
from distributed_llms_example_tpu.data import batching as jbatching
from distributed_llms_example_tpu.data import dataset as jdataset
from distributed_llms_example_tpu.data.tokenizer import ByteTokenizer as JaxByteTokenizer
from distributed_llms_example_tpu.evaluation import rouge as jrouge
from distributed_llms_example_tpu.evaluation.evaluate import Evaluator as JaxEvaluator
from distributed_llms_example_tpu.evaluation.metrics import aggregate_mean as jax_mean
from distributed_llms_example_tpu.models.registry import load_model as jax_load_model
from distributed_llms_example_tpu_torch.data.batching import BatchIterator
from distributed_llms_example_tpu_torch.data.dataset import SummarizationDataset, iter_global_batches
from distributed_llms_example_tpu_torch.data.tokenizer import ByteTokenizer
from distributed_llms_example_tpu_torch.evaluation import rouge
from distributed_llms_example_tpu_torch.evaluation.evaluate import Evaluator
from distributed_llms_example_tpu_torch.evaluation.metrics import aggregate_mean
from distributed_llms_example_tpu_torch.models.from_jax import load_jax_params
from distributed_llms_example_tpu_torch.models.registry import load_model

WORDS = ["a", "b", "c", "ab", "ba", "abc", "cab", "a b", "c c"]


def _records(n, seed=0, src=(20, 60), words=(2, 8)):
    rng = np.random.RandomState(seed)
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz   "))
    return [{"dialogue": "".join(rng.choice(letters, rng.randint(*src))),
             "summary": " ".join(rng.choice(WORDS, rng.randint(*words)))} for _ in range(n)]


def _wordy_bart_params():
    """bart-test's seed-0 init with ``final_logits_bias`` +8 on 'a', 'b',
    'c' and the space (byte id + 2) and +7.9 on eos: the random logits pick
    among them, so the summaries are short words and some stop early."""
    lm = jax_load_model("bart-test")
    params = jax.device_get(lm.init_params(0))
    flb = np.array(params["final_logits_bias"], dtype=np.float32)
    for ch in "abc ":
        flb[ord(ch) + 2] = 8.0
    flb[lm.config.eos_token_id] = 7.9
    params = dict(params)
    params["final_logits_bias"] = flb
    return lm, params


@pytest.mark.parametrize("beams", [1, 2])
def test_evaluator_rouge_matches_jax(beams):
    """The first three records' references are their own summaries as the
    port generates them alone, the last two's a word it never generates:
    ROUGE-1 is 0.6, and the wrapped row scored as well would make it 4/6."""
    lm, params = _wordy_bart_params()
    tlm = load_model("bart-test", device="cpu")
    load_jax_params(tlm.module, params)
    tok = ByteTokenizer()
    ev = Evaluator(tlm.module, tlm.config, tok, num_beams=beams, max_new_tokens=16)
    recs = []
    for i, r in enumerate(_records(5)):
        ids = torch.tensor([tok.encode_source(r["dialogue"], 64)])
        alone = ev._decode_batch(ev.generator.run(ids, torch.ones_like(ids)).numpy())[0]
        recs.append({"dialogue": r["dialogue"], "summary": alone if i < 3 else "zz"})
    kw = dict(max_source_length=64, max_target_length=16)
    jds = jdataset.SummarizationDataset(recs, JaxByteTokenizer(), **kw)
    mesh = build_mesh(MeshConfig(data=1), devices=jax.devices()[:1])
    jev = JaxEvaluator(lm.module, lm.config, JaxByteTokenizer(), mesh, num_beams=beams,
                       max_new_tokens=16)
    run = dict(global_batch=2, bucket_multiple=32, max_source_length=64)
    want = jev.run(params, jds, **run)

    tlm.module.train()
    got = ev.run(SummarizationDataset(recs, tok, **kw), **run)
    assert tlm.module.training  # the pass ran in eval mode and restored the mode
    assert set(got) == set(want) == {"rouge1", "rouge2", "rougeL", "rougeLsum"}
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-9, (k, got[k], want[k])
    # words were generated and scored; 3 batches of 2 generate 6 rows, and
    # the wrapped sixth (record 0 again, ROUGE 1) is not scored
    assert got["rouge1"] == pytest.approx(0.6, abs=1e-12)


def test_rouge_compute_equals_jax():
    preds = ["The cats were running quickly.\nA dog barked", "", "numbers 123 and 45",
             "generously happy relational conditioning", "a a a b"]
    refs = ["the cat runs quick\nthe dog barks loudly", "nothing here", "123 45 numbers",
            "generous happiness relate condition", "a b b"]
    for stem in (True, False):
        assert rouge.compute(preds, refs, use_stemmer=stem) == \
            jrouge.compute(preds, refs, use_stemmer=stem)
    words = ["caresses", "ponies", "relational", "conditional", "hopping", "generalization",
             "sky", "agreed", "triplicate", "electrical"]
    assert [rouge.porter_stem(w) for w in words] == [jrouge.porter_stem(w) for w in words]
    assert rouge.compute([], []) == jrouge.compute([], [])


@pytest.mark.parametrize("n,gb", [(5, 2), (8, 4), (3, 8), (1, 4), (9, 4)])
@pytest.mark.parametrize("shuffle,drop_last", [(False, False), (True, True), (True, False),
                                               (False, True)])
def test_batch_order_matches_jax(n, gb, shuffle, drop_last):
    kw = dict(seed=7, epoch=2, shuffle=shuffle, drop_last=drop_last)
    got = [b.tolist() for b in iter_global_batches(n, gb, **kw)]
    want = [b.tolist() for b in jdataset.iter_global_batches(n, gb, **kw)]
    assert got == want
    assert all(len(b) == gb for b in got)


@pytest.mark.parametrize("n,gb,shuffle,drop_last", [
    (5, 2, False, False),  # eval: 3 batches, the last wrapped around
    (3, 8, False, False),  # a corpus smaller than one batch
    (13, 4, True, True),  # training: shuffled, the last partial batch dropped
])
def test_batch_iterator_arrays_match_jax(n, gb, shuffle, drop_last):
    recs = _records(n, seed=n, src=(5, 90), words=(1, 12))
    kw = dict(global_batch=gb, seed=3, shuffle=shuffle, drop_last=drop_last,
              bucket_multiple=32, max_source_length=64, max_target_length=16)
    dkw = dict(max_source_length=64, max_target_length=16)
    it = BatchIterator(SummarizationDataset(recs, ByteTokenizer(), **dkw), **kw)
    jit = jbatching.BatchIterator(jdataset.SummarizationDataset(recs, JaxByteTokenizer(), **dkw),
                                  **kw)
    assert it.steps_per_epoch() == jit.steps_per_epoch()
    for epoch in (0, 1):
        got, want = list(it.epoch(epoch)), list(jit.epoch(epoch))
        assert len(got) == len(want) == it.steps_per_epoch()
        for g, w in zip(got, want):
            assert set(g) == set(w)
            for k in w:
                np.testing.assert_array_equal(g[k], w[k])
                assert g[k].dtype == w[k].dtype


def test_batch_iterator_defaults_are_the_training_stream():
    it = BatchIterator(SummarizationDataset(_records(10), ByteTokenizer()), global_batch=4)
    assert (it.shuffle, it.drop_last, it.steps_per_epoch()) == (True, True, 2)


def test_aggregate_mean_single_process():
    m = {"rouge1": 0.5, "epoch": 3, "step": 7}
    assert aggregate_mean(m) == jax_mean(m) == {"rouge1": 0.5, "epoch": 3.0, "step": 7.0}


def test_causal_eval_waits_for_its_dataset():
    """The causal pass reads a ``CausalLMDataset``'s prompts and targets (a
    summarization dataset has neither); its ROUGE against the JAX
    ``Evaluator``'s is in ``test_torch_causal_eval.py``."""
    from distributed_llms_example_tpu_torch.data.dataset import CausalLMDataset

    lm = load_model("llama-test", device="cpu")
    ev = Evaluator(lm.module, lm.config, ByteTokenizer(), is_seq2seq=False, max_new_tokens=4)
    with pytest.raises(AttributeError, match="prompt_ids"):
        ev.run(SummarizationDataset(_records(2), ByteTokenizer()), global_batch=2)
    scores = ev.run(CausalLMDataset(_records(3), ByteTokenizer(), max_length=64),
                    global_batch=2, bucket_multiple=32, max_source_length=64)
    assert set(scores) == {"rouge1", "rouge2", "rougeL", "rougeLsum"}
