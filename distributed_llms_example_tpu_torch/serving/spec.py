"""Speculative multi-token decode: draft, then verify in one target pass
(port of the JAX package's ``serving/spec.py``).

A plain decode round costs one target-model step per generated token.  The
decode kernels take a q block of up to 8 rows a slot (their per-row
length masks express staggered offsets), so one target pass over ``x =
[last_emitted, d_1 .. d_k]`` scores k drafts at about the cost of a step.
Two draft sources, each proposing ``k`` tokens a slot a round:

- **n-gram self-drafting** (no extra model): the most recent earlier
  occurrence of the longest suffix n-gram of the slot's prompt + generated
  tokens proposes what followed it (``ngram_draft``);
- **a draft model**: a causal model sharing the target's vocabulary,
  decoded greedily ``k`` steps a round on its own flat cache
  (``DraftRunner``).

The acceptance rule is the contract: take the target's greedy argmax at
every position of ``x``, accept the longest draft prefix equal to it, and
emit the target's own token after that prefix.  Every emitted token is one
greedy decoding would have produced, so the output is greedy's wherever
the target's argmax is the same at a q block of k + 1 rows as at one row
(on the CPU's plain path it is; on the card a matmul of another shape may
round differently).

Rollback is mask discipline, not data movement: the verify pass opens the
k + 1 mask positions up front, and after acceptance keeps only the
accepted prefix + 1 of them.  Rejected positions hold K/V that no read can
see, and the next round's span write covers them before any read.  On the
paged path the span write goes through the step's write plan
(``cache_pool.step_write_plan`` with ``span``), so it lands only in blocks
the slot owns: a rejection returns nothing to the free list, and the
prefix-cache index never sees a speculative block (blocks register only
at admission).
"""

from __future__ import annotations

from typing import Any, Sequence

import numpy as np
import torch

from distributed_llms_example_tpu_torch.evaluation.generation import (
    causal_prefill,
    init_causal_cache,
)
from distributed_llms_example_tpu_torch.ops.mha import kv_leaves, write_cache_rows
from distributed_llms_example_tpu_torch.serving.cache_pool import to_device

__all__ = ["ngram_draft", "ngram_drafts", "acceptance_lengths", "verify", "DraftRunner"]


# ----------------------------------------------------------------- drafting
def ngram_draft(history: Sequence[int], k: int, *, max_n: int = 3) -> list[int]:
    """The ``k`` tokens that followed the most recent earlier occurrence of
    the longest suffix n-gram (n = max_n .. 1) of ``history``, continued
    periodically where the match runs off the end; the last token repeated
    when nothing recurs.  Always exactly ``k`` entries."""
    h = list(history)
    if not h:
        return [0] * k
    for n in range(min(max_n, len(h) - 1), 0, -1):
        suffix = h[-n:]
        for i in range(len(h) - n - 1, -1, -1):
            if h[i:i + n] == suffix:
                out = h[i + n:i + n + k]
                comb = suffix + out
                while len(out) < k:
                    nxt = comb[-n]
                    out.append(nxt)
                    comb.append(nxt)
                return out[:k]
    return [h[-1]] * k


def ngram_drafts(histories: Sequence[Sequence[int] | None], k: int, pad: int) -> np.ndarray:
    """``ngram_draft`` over each slot's history (None: an idle slot, a pad
    row): the (slots, k) int32 draft columns of the verify block."""
    out = np.full((len(histories), k), pad, np.int32)
    for s, h in enumerate(histories):
        if h:
            out[s] = ngram_draft(h, k)
    return out


# --------------------------------------------------------------- acceptance
def acceptance_lengths(x: torch.Tensor, target: torch.Tensor, room: torch.Tensor) -> torch.Tensor:
    """Accepted drafts a slot: the longest prefix of ``x[:, 1:]`` equal to
    ``target[:, :-1]`` (the target's argmax after each prefix of ``x``),
    clamped to ``room`` (the slot's remaining budget minus the bonus
    token), which truncates the prefix and never changes a token.  (S,)
    int32 in [0, k]."""
    k = x.shape[1] - 1
    j = torch.arange(k, device=x.device)
    matches = (x[:, 1:] == target[:, :-1]) & (j[None, :] < room[:, None])
    return torch.cumprod(matches.to(torch.int32), dim=1).sum(dim=1, dtype=torch.int32)


def _set_mask_span(mask: torch.Tensor, offsets: torch.Tensor, values: torch.Tensor) -> None:
    """``mask[s, offsets[s] + j] = values[s, j]`` in place, positions past
    the mask's width dropped."""
    write_cache_rows(mask[:, None], values[:, None].to(mask.dtype), offsets)


# ------------------------------------------------------------- verify pass
@torch.inference_mode()
def verify(model, state: dict, x: torch.Tensor, *, write_pos: torch.Tensor,
           rope_pos: torch.Tensor, active: torch.Tensor, room: torch.Tensor, pad: int,
           cache: Any = None) -> tuple[torch.Tensor, torch.Tensor]:
    """One verify round on the slot state, in place: one target pass over
    the (S, k+1) block ``x`` (row j at cache position ``write_pos + j``,
    RoPE position ``rope_pos + j``; idle slots park past the cache, so
    their writes drop), acceptance, and the mask rollback.  ``cache`` is
    the pass's cache (a ``PagedKVCache`` per layer whose write plan spans
    k + 1 rows), else the state's flat ``cache``.  Returns ``(target,
    n_emit)``: the greedy tokens (pad on idle rows) and how many of their
    leading entries the host appends (accepted + 1; 0 on idle rows).

    Position contract: an accepted prefix of m drafts leaves positions
    ``write_pos .. write_pos + m`` holding [last, target_0 .. target_{m-1}],
    what greedy would have cached there; the bonus token ``target[:, m]``
    is the next round's ``x[:, 0]``, written at ``write_pos + m + 1``,
    where the rejected tail starts."""
    S, K1 = x.shape
    dev = x.device
    width = state["mask"].shape[1]
    span = torch.arange(K1, device=dev)
    offs = torch.where(active, write_pos, width).to(torch.int32)
    _set_mask_span(state["mask"], offs, torch.ones((S, K1), dtype=torch.int32, device=dev))
    logits = model(x, state["mask"], positions=rope_pos.long()[:, None] + span[None, :],
                   cache=state["cache"] if cache is None else cache, cache_positions=offs)
    target = logits.argmax(dim=-1).to(torch.int32)
    accept = acceptance_lengths(x, target, room)
    n_emit = torch.where(active, accept + 1, 0).to(torch.int32)
    # rollback: only the accepted prefix (and x[:, 0]) keep their mask bits
    _set_mask_span(state["mask"], offs, (span[None, :] <= accept[:, None]).to(torch.int32))
    last = target.gather(1, accept.long()[:, None])[:, 0]
    state["last"] = torch.where(active, last, pad).to(torch.int32)
    return torch.where(active[:, None], target, pad).to(torch.int32), n_emit


# ------------------------------------------------------------- draft runner
class DraftRunner:
    """A draft model's slots: a causal model (the target's vocabulary)
    proposes ``k`` tokens a slot a round on its own flat cache, laid out as
    the target's slots are (prompt at positions 0..len-1 of its admission
    bucket, decode tail from ``base = bucket``).

    A round is catch-up-then-draft: the draft cache trails the target by
    the tokens the engine appended last round (``fed``, 1..k+1 of them),
    so the round first writes that span in one pass, whose logits at the
    last fed row give draft 1, then single-steps k - 1 more.  The mask
    then keeps only the fed positions: the draft's own speculative writes
    roll back as the verify pass's do, and the next catch-up overwrites
    them before any read."""

    def __init__(self, model: Any, *, slots: int, src_width: int, max_new: int, k: int,
                 kv_cache_dtype: str, device: torch.device):
        self.model = model
        self.S, self.L, self.K = slots, max_new, k
        self.width = src_width + max_new
        self.kv_cache_dtype = kv_cache_dtype
        self.device = device
        self.prefill_calls = 0  # admission chunks prefilled
        self.rounds = 0

    def init_state(self) -> dict:
        return {
            "cache": init_causal_cache(self.model, self.S, self.width, device=self.device,
                                       kv_cache_dtype=self.kv_cache_dtype),
            "mask": torch.zeros((self.S, self.width), dtype=torch.int32, device=self.device),
        }

    @torch.inference_mode()
    def admit_prompt(self, state: dict, ids: torch.Tensor, mask: torch.Tensor,
                     slot_idx: np.ndarray) -> None:
        """Prefill one bucket-width chunk of prompts into the draft's own
        cache and copy its rows into their slots (rows whose slot index is
        out of range, the chunk's padding, drop)."""
        cache, full_mask, _, _ = causal_prefill(self.model, ids, mask, self.L,
                                                kv_cache_dtype=self.kv_cache_dtype)
        self.prefill_calls += 1
        rows = np.nonzero(slot_idx < self.S)[0]
        r = to_device(rows, self.device)
        s = to_device(slot_idx[rows].astype(np.int64), self.device)
        extra = self.width - full_mask.shape[1]
        for dst, src in zip(state["cache"], cache):
            for d, x in zip(kv_leaves(dst), kv_leaves(src)):
                d[s] = torch.nn.functional.pad(x, [0, 0] * (x.dim() - 3) + [0, extra])[r]
        state["mask"][s] = torch.nn.functional.pad(full_mask, [0, extra])[r]

    @torch.inference_mode()
    def round(self, state: dict, fed: torch.Tensor, n_fed: torch.Tensor, pos0: torch.Tensor,
              rope0: torch.Tensor, active: torch.Tensor) -> torch.Tensor:
        """One draft round over (S, k+1) ``fed`` tokens (``n_fed`` of each
        row real), the span starting at cache position ``pos0`` and RoPE
        position ``rope0``; returns the (S, k) proposals on the device."""
        K, S, dev = self.K, self.S, self.device
        width = self.width
        # the round reaches the catch-up span (n_fed <= K+1 rows from pos0)
        # and the draft tail (K-1 steps from pos0 + n_fed - 1): open every
        # position either can touch, rebuild at the end
        open_w = max(K + 1, 2 * K)
        pos = torch.where(active, pos0, width).to(torch.int32)
        _set_mask_span(state["mask"], pos, torch.ones((S, open_w), dtype=torch.int32, device=dev))
        kspan = torch.arange(K + 1, device=dev)
        logits = self.model(fed, state["mask"], positions=rope0.long()[:, None] + kspan[None, :],
                            cache=state["cache"], cache_positions=pos)
        toks = logits.argmax(dim=-1).to(torch.int32)
        idx = (n_fed - 1).clamp(0, K).long()  # idle rows have n_fed = 0
        cur = toks.gather(1, idx[:, None])[:, 0]
        drafts = [cur]
        q, rq = pos0 + n_fed - 1, rope0 + n_fed - 1  # the last fed position
        for t in range(1, K):
            cp = torch.where(active, q + t, width).to(torch.int32)
            lg = self.model(cur[:, None], state["mask"], positions=(rq + t).long()[:, None],
                            cache=state["cache"], cache_positions=cp)
            cur = lg[:, -1].argmax(dim=-1).to(torch.int32)
            drafts.append(cur)
        ospan = torch.arange(open_w, device=dev)
        _set_mask_span(state["mask"], pos, (ospan[None, :] < n_fed[:, None]).to(torch.int32))
        self.rounds += 1
        return torch.stack(drafts, dim=1)

