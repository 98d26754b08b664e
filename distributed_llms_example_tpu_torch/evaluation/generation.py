"""Autoregressive generation (port of the JAX package's
``evaluation/generation.py``): decode-cache allocation, the causal prompt
prefill the serving engine shares, and static-batch greedy and beam search
for seq2seq (BART, T5) and decoder-only (LLaMA) models: the reference's
eval pass, ``generate(max_length=128, num_beams=2)``.

The JAX package derives its cache tree from the decode program's shapes;
here the cache is explicit: one ``KVCache`` of zeroed (batch, kv heads,
max_len, head_dim) K and V buffers per self-attention layer, in the compute
dtype.  A generator splits a batch's work as the JAX one does: ``prefill``
(the encoder and the once-a-sequence cross-attention K/V, or the prompt
pass into the cache), ``decode_step`` (one token a row: a cached step of
every decoder layer, which on CUDA is the flash decode kernel), a
``decode_loop`` of exactly the JAX program's steps (a Python loop where
the JAX package has a ``fori_loop``; no early stop) and ``finalize``.
The step counter is a host integer and the per-row cache offsets a device
tensor advanced in place, so a step waits on nothing from the device.

Beam search keeps a flat (batch × beams) leading dim and HF's semantics
(``_beam_step_select``).  Its top-k is a stable descending sort, so that
equal scores rank lower index first, as ``jax.lax.top_k`` ranks them:
with ``NEG_INF`` = -1e7 (this module's own, not attention's -1e9) fp32
sums below the first beam round to whole numbers and tie exactly.
"""

from __future__ import annotations

from typing import Any

import torch

from distributed_llms_example_tpu_torch.ops.mha import KVCache

NEG_INF = -1.0e7


KV_CACHE_DTYPES = ("f32", "int8")


def _zero_caches(attns, batch: int, max_len: int, device, kv_cache_dtype: str) -> list[KVCache]:
    if kv_cache_dtype not in KV_CACHE_DTYPES:
        raise ValueError(f"kv_cache_dtype={kv_cache_dtype!r}: must be 'f32' or 'int8'")
    int8 = kv_cache_dtype == "int8"
    out = []
    for attn in attns:
        shape = (batch, attn.kv_heads, max_len, attn.head_dim)
        store = torch.int8 if int8 else attn.dtype
        c = KVCache(torch.zeros(shape, dtype=store, device=device),
                    torch.zeros(shape, dtype=store, device=device))
        if int8:
            c.k_scale = torch.zeros(shape[:3], dtype=torch.float32, device=device)
            c.v_scale = torch.zeros(shape[:3], dtype=torch.float32, device=device)
        out.append(c)
    return out


def init_cache(model, batch: int, max_len: int, *, device: torch.device | str,
               kv_cache_dtype: str = "f32") -> list[KVCache]:
    """Zero decoder self-attention caches of a seq2seq model (BART or T5:
    both name their decoder layers ``decoder_blocks``) for a (batch,
    max_len) decode; the serving engine's max_len is the decode budget, as
    in the JAX package.  ``kv_cache_dtype`` "f32" keeps K/V in the compute
    dtype (the JAX flag's name), "int8" quantizes them with fp32 scales."""
    return _zero_caches((blk.self_attn for blk in model.decoder_blocks), batch, max_len, device,
                        kv_cache_dtype)


def init_causal_cache(model, batch: int, max_len: int, *, device: torch.device | str,
                      kv_cache_dtype: str = "f32") -> list[KVCache]:
    """Zero self-attention caches of a decoder-only model, one per block
    (``kv_cache_dtype`` as in ``init_cache``)."""
    return _zero_caches((blk.self_attn for blk in model.blocks), batch, max_len, device,
                        kv_cache_dtype)


def causal_prefill(model, input_ids: torch.Tensor, attention_mask: torch.Tensor,
                   new_tokens: int, *, kv_cache_dtype: str = "f32"):
    """One-pass prompt prefill for decoder-only decode (the JAX package's
    ``_causal_prefill``).

    Allocates caches for prompt + generation (width P + ``new_tokens``),
    runs the right-padded prompt through once (every row writes at cache
    slot 0 on), and returns ``(cache, full_mask, lengths, first_logits)``
    where ``first_logits`` are each row's logits at its last valid prompt
    position.  RoPE positions follow the true sequence (``cumsum(mask) −
    1`` clipped at 0), not the cache slot, and pad slots stay masked."""
    B, P = input_ids.shape
    dev = input_ids.device
    cache = init_causal_cache(model, B, P + new_tokens, device=dev,
                              kv_cache_dtype=kv_cache_dtype)
    mask = attention_mask.to(torch.int32)
    full_mask = torch.cat([mask, torch.zeros((B, new_tokens), dtype=torch.int32, device=dev)], 1)
    lengths = mask.sum(dim=1, dtype=torch.int32)
    positions = (torch.cumsum(mask, dim=1) - 1).clamp(min=0)
    logits = model(input_ids, full_mask, positions=positions, cache=cache)
    last = (lengths.long() - 1).clamp(min=0)
    first = logits[torch.arange(B, device=dev), last]
    return cache, full_mask, lengths, first


# --------------------------------------------------------------- seq2seq


class Seq2SeqGenerator:
    """Prefill/decode split for encoder-decoder (BART, T5) generation:
    greedy when ``num_beams`` is 1, HF-parity beam search otherwise
    (finished beams banked, scores normalized by length), HF's
    ``forced_bos_token_id`` / ``forced_eos_token_id`` processors applied
    where the config sets them."""

    def __init__(self, model: torch.nn.Module, config: Any, max_new_tokens: int,
                 num_beams: int = 1, length_penalty: float = 1.0):
        self.model, self.config = model, config
        self.L, self.K = max_new_tokens, num_beams
        self.length_penalty = length_penalty
        self.eos, self.pad = config.eos_token_id, config.pad_token_id
        self.start = config.decoder_start_token_id
        self.forced_bos = getattr(config, "forced_bos_token_id", None)
        self.forced_eos = getattr(config, "forced_eos_token_id", None)

    def prefill(self, input_ids: torch.Tensor, attention_mask: torch.Tensor) -> dict:
        """The encoder, the cross-attention K/V projected once at batch B,
        and zeroed caches of L slots.  With beams, the encoder output and
        mask are repeated K-ways for the decoder and the caches hold B·K
        rows, while the cross K/V stay at B: the beams of a row share them
        (``ops/attention.beam_grouped_attention``)."""
        B = input_ids.shape[0]
        dev = input_ids.device
        enc = self.model.encode(input_ids, attention_mask)
        carry = {"t": 0, "ckv": self.model.cross_kv(enc)}
        rows = B * self.K
        if self.K > 1:
            enc = enc.repeat_interleave(self.K, dim=0)
            attention_mask = attention_mask.repeat_interleave(self.K, dim=0)
            carry["state"] = _beam_init(B, self.K, self.L, self.pad, device=dev)
        else:
            carry["out"] = torch.full((B, self.L), self.pad, dtype=torch.long, device=dev)
            carry["done"] = torch.zeros((B,), dtype=torch.bool, device=dev)
        return carry | {
            "cache": init_cache(self.model, rows, self.L, device=dev),
            "offsets": torch.zeros((rows,), dtype=torch.int32, device=dev),
            "enc": enc,
            "enc_mask": attention_mask,
            "last": torch.full((rows, 1), self.start, dtype=torch.long, device=dev),
        }

    def decode_step(self, carry: dict) -> dict:
        """One token a row: a cached decoder step at offset t, then the
        greedy choice or the beam selection (and the caches' rows
        reordered to the chosen beams' parents)."""
        t = carry["t"]
        logits = self.model.decode(carry["last"], carry["enc"], carry["enc_mask"],
                                   cache=carry["cache"], cache_offset=carry["offsets"],
                                   cross_kv=carry["ckv"])
        carry["offsets"] += 1
        if self.K > 1:
            logp = torch.log_softmax(logits[:, -1].float(), dim=-1)  # (B·K, V)
            if self.forced_bos is not None and t == 0:
                logp = logp + _forced_mask(logp, self.forced_bos)
            if self.forced_eos is not None and t == self.L - 1:
                logp = logp + _forced_mask(logp, self.forced_eos)
            B = carry["state"][0].shape[0]
            state, chosen, parents = _beam_step_select(
                logp, t, carry["state"], eos=self.eos, K=self.K,
                length_penalty=self.length_penalty)
            _gather_beams(carry["cache"], parents, B, self.K)
            return carry | {"t": t + 1, "last": chosen.reshape(B * self.K, 1), "state": state}
        nxt = logits[:, -1].argmax(dim=-1)
        if self.forced_bos is not None and t == 0:
            nxt = torch.full_like(nxt, self.forced_bos)
        if self.forced_eos is not None and t == self.L - 1:
            nxt = torch.full_like(nxt, self.forced_eos)
        nxt = torch.where(carry["done"], self.pad, nxt)
        carry["out"][:, t] = nxt
        return carry | {"t": t + 1, "last": nxt[:, None],
                        "done": carry["done"] | (nxt == self.eos)}

    def decode_loop(self, carry: dict) -> dict:
        for _ in range(self.L):
            carry = self.decode_step(carry)
        return carry

    def finalize(self, carry: dict) -> torch.Tensor:
        """(B, L) token ids, pad after eos.  A beam's final length is the
        start token + L generated (banking at step t uses t + 1)."""
        if self.K > 1:
            return _beam_finalize(carry["state"], self.L + 1, self.length_penalty)
        return carry["out"]

    @torch.no_grad()
    def run(self, input_ids: torch.Tensor, attention_mask: torch.Tensor) -> torch.Tensor:
        return self.finalize(self.decode_loop(self.prefill(input_ids, attention_mask)))


def make_greedy_generate(model: torch.nn.Module, config: Any, max_new_tokens: int):
    """Greedy decoding: (input_ids, attention_mask) → ids of shape (batch,
    max_new_tokens), pad-filled after eos."""
    return Seq2SeqGenerator(model, config, max_new_tokens, num_beams=1).run


def make_beam_search(model: torch.nn.Module, config: Any, max_new_tokens: int,
                     num_beams: int = 2, length_penalty: float = 1.0):
    """Beam search with HF ``generate(num_beams=K)`` semantics: score = sum
    of log-probs / length ** length_penalty, finished beams banked when eos
    is chosen, the best finished (or live) beam returned."""
    return Seq2SeqGenerator(model, config, max_new_tokens, num_beams=num_beams,
                            length_penalty=length_penalty).run


# ----------------------------------------------------------- decoder-only


class CausalGenerator:
    """Prefill/decode split for decoder-only (LLaMA) generation over
    right-padded prompts: the prompt goes into the cache in one pass
    (``causal_prefill``; beams share it, so the prefill is not multiplied
    by K), then one token a row with RoPE at each row's true position.
    Greedy or HF-parity beam search, whose token 0 is chosen from the
    prefill's logits (``len_offset`` P - 1: HF normalizes by prompt +
    generated length)."""

    def __init__(self, model: torch.nn.Module, config: Any, max_new_tokens: int,
                 num_beams: int = 1, length_penalty: float = 1.0):
        self.model, self.config = model, config
        self.L, self.K = max_new_tokens, num_beams
        self.length_penalty = length_penalty
        self.eos, self.pad = config.eos_token_id, config.pad_token_id

    def prefill(self, input_ids: torch.Tensor, attention_mask: torch.Tensor) -> dict:
        B, P = input_ids.shape
        cache, full_mask, lengths, first = causal_prefill(self.model, input_ids,
                                                          attention_mask, self.L)
        if self.K > 1:
            logp0 = torch.log_softmax(first.float(), dim=-1)  # (B, V)
            for c in cache:  # beams share the prefilled prompt
                c.k = c.k.repeat_interleave(self.K, dim=0)
                c.v = c.v.repeat_interleave(self.K, dim=0)
            # token 0 from the prefill logits: with live scores [0, -1e7,
            # ...] only beam 0's distribution counts, HF's first step
            state = _beam_init(B, self.K, self.L, self.pad, device=input_ids.device)
            state, chosen, parents = _beam_step_select(
                logp0.repeat_interleave(self.K, dim=0), 0, state, eos=self.eos, K=self.K,
                length_penalty=self.length_penalty, len_offset=P - 1)
            _gather_beams(cache, parents, B, self.K)
            return {"t": 1, "cache": cache,
                    "full_mask": full_mask.repeat_interleave(self.K, dim=0),
                    "lengths": lengths.repeat_interleave(self.K, dim=0),
                    "last": chosen.reshape(B * self.K, 1), "state": state}
        return {"t": 0, "cache": cache, "full_mask": full_mask, "lengths": lengths,
                "last": first.argmax(dim=-1),
                "out": torch.full((B, self.L), self.pad, dtype=torch.long,
                                  device=input_ids.device),
                "done": torch.zeros((B,), dtype=torch.bool, device=input_ids.device)}

    def decode_step(self, carry: dict) -> dict:
        t = carry["t"]
        full_mask = carry["full_mask"]
        P = full_mask.shape[1] - self.L
        if self.K > 1:
            # `last` is token index t - 1, at cache slot P + t - 1
            full_mask[:, P + t - 1] = 1
            logits = self.model(carry["last"], full_mask,
                                positions=(carry["lengths"] + t - 1)[:, None],
                                cache=carry["cache"])
            logp = torch.log_softmax(logits[:, -1].float(), dim=-1)
            B = carry["state"][0].shape[0]
            state, chosen, parents = _beam_step_select(
                logp, t, carry["state"], eos=self.eos, K=self.K,
                length_penalty=self.length_penalty, len_offset=P - 1)
            _gather_beams(carry["cache"], parents, B, self.K)
            return carry | {"t": t + 1, "last": chosen.reshape(B * self.K, 1), "state": state}
        last = carry["last"]
        carry["out"][:, t] = last
        full_mask[:, P + t] = 1
        logits = self.model(last[:, None], full_mask, positions=(carry["lengths"] + t)[:, None],
                            cache=carry["cache"])
        done = carry["done"] | (last == self.eos)
        nxt = torch.where(done, self.pad, logits[:, -1].argmax(dim=-1))
        return carry | {"t": t + 1, "last": nxt, "done": done}

    def decode_loop(self, carry: dict) -> dict:
        for _ in range(carry["t"], self.L):  # a beam prefill chose token 0
            carry = self.decode_step(carry)
        return carry

    def finalize(self, carry: dict) -> torch.Tensor:
        if self.K > 1:
            P = carry["full_mask"].shape[1] - self.L
            return _beam_finalize(carry["state"], P + self.L, self.length_penalty)
        return carry["out"]

    @torch.no_grad()
    def run(self, input_ids: torch.Tensor, attention_mask: torch.Tensor) -> torch.Tensor:
        return self.finalize(self.decode_loop(self.prefill(input_ids, attention_mask)))


def make_causal_greedy(model: torch.nn.Module, config: Any, max_new_tokens: int):
    """Greedy decoding for decoder-only models over right-padded prompts."""
    return CausalGenerator(model, config, max_new_tokens, num_beams=1).run


def make_causal_beam_search(model: torch.nn.Module, config: Any, max_new_tokens: int,
                            num_beams: int = 2, length_penalty: float = 1.0):
    """Beam search for decoder-only models, the seq2seq search's semantics
    (``_beam_step_select``)."""
    return CausalGenerator(model, config, max_new_tokens, num_beams=num_beams,
                           length_penalty=length_penalty).run


# ------------------------------------------------------- beam primitives


def _forced_mask(logp: torch.Tensor, token: int) -> torch.Tensor:
    """(V,) fp32: NEG_INF everywhere but 0 at ``token`` (HF's forced-token
    processors, added to the log-probs)."""
    mask = torch.full((logp.shape[-1],), NEG_INF, dtype=torch.float32, device=logp.device)
    mask[token] = 0.0
    return mask


def _top_k(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The k largest of each row, equal values lower index first (the
    order of ``jax.lax.top_k``, which ``torch.topk`` does not promise)."""
    values, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


def _gather_beams(caches: list[KVCache], parents: torch.Tensor, batch: int, beams: int) -> None:
    """Reorder every cache's flat (batch·beams) rows to the chosen beams'
    ``parents`` (batch, beams), in the ``KVCache`` objects; each keeps its
    index."""
    flat = (torch.arange(batch, device=parents.device)[:, None] * beams + parents).reshape(-1)
    for c in caches:
        c.k = c.k.index_select(0, flat)
        c.v = c.v.index_select(0, flat)


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[b, idx[b, j]] along dim 1 (``jnp.take_along_axis`` on axis 1)."""
    if x.dim() == 3:
        return torch.gather(x, 1, idx[:, :, None].expand(-1, -1, x.shape[2]))
    return torch.gather(x, 1, idx)


def _length_norm(length: int, length_penalty: float, device) -> torch.Tensor:
    """fp32 ``length ** length_penalty`` as a 0-d tensor on ``device``: a
    true fp32 division by it follows (CUDA divides by a host scalar as a
    product with its reciprocal), and nothing is copied from the host."""
    return torch.full((), length, dtype=torch.float32, device=device) ** length_penalty


def _beam_step_select(logp: torch.Tensor, t: int, state: tuple, *, eos: int, K: int,
                      length_penalty: float, len_offset: int = 0) -> tuple:
    """One beam-search selection from per-beam next-token log-probs ``logp``
    (B·K, V) for token index ``t``.  ``state`` is ``(live_scores,
    live_seqs, fin_scores, fin_seqs, row_done)``.  HF
    ``BeamSearchScorer.process`` semantics, shared by both searches:

    - only eos candidates ranked < K among the top 2K are banked;
    - a row is done (early_stopping=False) once it holds K banked
      hypotheses whose worst beats the best attainable continuation at the
      current length normalization; done rows bank no more;
    - the normalization length is ``t + 1 + len_offset``: the decoder
      length for seq2seq (offset 0), prompt + generated for decoder-only
      (offset P - 1).

    Returns ``(state, chosen_tokens, parent_beams)``, both (B, K)."""
    live_scores, live_seqs, fin_scores, fin_seqs, row_done = state
    B = live_scores.shape[0]
    V = logp.shape[-1]
    cand = live_scores[:, :, None] + logp.reshape(B, K, V)
    top_scores, top_idx = _top_k(cand.reshape(B, K * V), 2 * K)  # (B, 2K)
    beam_idx = top_idx // V
    token = top_idx % V

    cand_seqs = _take(live_seqs, beam_idx).clone()  # (B, 2K, L)
    cand_seqs[:, :, t] = token

    is_eos = token == eos
    rank_ok = torch.arange(2 * K, device=logp.device)[None, :] < K
    lp = _length_norm(t + 1 + len_offset, length_penalty, logp.device)
    bankable = is_eos & rank_ok & ~row_done[:, None]
    fin_cand = torch.where(bankable, top_scores / lp, NEG_INF)
    all_fin_scores = torch.cat([fin_scores, fin_cand], dim=1)  # (B, 3K)
    all_fin_seqs = torch.cat([fin_seqs, cand_seqs], dim=1)
    fin_scores_new, fin_keep = _top_k(all_fin_scores, K)
    fin_seqs_new = _take(all_fin_seqs, fin_keep)

    live_cand = torch.where(is_eos, NEG_INF, top_scores)
    live_scores_new, live_keep = _top_k(live_cand, K)
    live_seqs_new = _take(cand_seqs, live_keep)
    chosen_tokens = _take(token, live_keep)
    parent_beams = _take(beam_idx, live_keep)

    has_k_banked = fin_scores_new[:, K - 1] > NEG_INF / 2
    # HF's is_done takes the best candidate sum overall (eos candidates
    # included), not the best surviving live beam
    attainable = top_scores[:, 0] / lp
    row_done_new = row_done | (has_k_banked & (fin_scores_new[:, K - 1] >= attainable))
    new_state = (live_scores_new, live_seqs_new, fin_scores_new, fin_seqs_new, row_done_new)
    return new_state, chosen_tokens, parent_beams


def _beam_init(batch: int, K: int, L: int, pad: int, *, device=None) -> tuple:
    live_scores = torch.tensor([0.0] + [NEG_INF] * (K - 1), dtype=torch.float32,
                               device=device).repeat(batch, 1)
    live_seqs = torch.full((batch, K, L), pad, dtype=torch.long, device=device)
    fin_scores = torch.full((batch, K), NEG_INF, dtype=torch.float32, device=device)
    fin_seqs = torch.full((batch, K, L), pad, dtype=torch.long, device=device)
    row_done = torch.zeros((batch,), dtype=torch.bool, device=device)
    return live_scores, live_seqs, fin_scores, fin_seqs, row_done


def _beam_finalize(state: tuple, final_len: int, length_penalty: float) -> torch.Tensor:
    """The best sequence of each row, HF's finalize: a row not yet done
    also weighs its best live beam at full length, normalized by the final
    sequence length (decoder length for seq2seq; prompt + generated for
    decoder-only)."""
    live_scores, live_seqs, fin_scores, fin_seqs, row_done = state
    none_finished = (fin_scores <= NEG_INF / 2).all(dim=1)
    live_final = live_scores[:, 0] / _length_norm(final_len, length_penalty,
                                                  live_scores.device)
    take_live = ~row_done & (none_finished | (live_final > fin_scores[:, 0]))
    return torch.where(take_live[:, None], live_seqs[:, 0], fin_seqs[:, 0])
