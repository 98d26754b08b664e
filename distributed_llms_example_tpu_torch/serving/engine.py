"""Continuous-batching serving engine (port of the JAX package's
``serving/engine.py``: the seq2seq adapter and the causal adapter, flat
and paged).

A fixed set of ``max_slots`` decode slots, each holding one in-flight
sequence at its own offset; finished sequences are evicted and new ones
admitted between per-token steps.  Per model, three steps:

- **prefill** (once per admitted chunk): seq2seq runs the encoder + the
  once-per-sequence cross-attention K/V projection; a causal model runs the
  right-padded prompts through once into a chunk cache (prompt bucket +
  decode budget wide) and reads each row's first token off its last valid
  position;
- **admit**: chunk rows land in their slots; rows beyond the chunk park at
  an out-of-range slot index and are dropped.  Under ``paged_kv`` each
  row's blocks are funded and mapped before the prefill, and the chunk's
  allocated tiles are copied into the shared pool; admission defers while
  the free list is short.  Slot caches and freed blocks are not zeroed on
  reuse: every read is masked to what the owner wrote, so a previous
  occupant's K/V is unreachable;
- **decode step** (every token): one token per slot at per-slot offsets
  (per-row cache writes, per-slot RoPE positions for causal models), idle
  slots parked past the cache so their writes drop.  A paged step writes
  each slot's new row into its pool block and attends through the block
  tables (the paged decode kernel on CUDA; a gathered slot view on the
  plain path).

The slot state lives on the device and is updated in place (the JAX
package donates it to the compiled step for the same effect).  Greedy
only.  The ``serve_window`` / ``serve_request`` / ``serve_summary`` JSON
events carry the JAX engine's keys.  The JAX engine's serving features
compose as there:

- ``kv_cache_dtype="int8"``: K/V stored int8 with per-position fp32
  scales, flat or paged; the decode kernels dequantize per tile, and a
  prompt prefill attends over the dequantized cache (``ops/mha.py``);
- ``prefix_cache`` (paged only): an admission matches its prompt's longest
  cached chain of full blocks (``serving/cache_pool.py``), takes a
  reference on it and prefills only the uncached tail, at absolute
  positions from the chain's end, over a gathered view of its blocks
  (warm admission); only the tail's fresh tiles scatter back, the shared
  chain is never written.  Finished requests' chains stay warm under
  ``prefix_cache_budget_gib``;
- ``spec_tokens`` (causal only): each decode round drafts k tokens a slot
  (n-gram, or ``spec_draft_model`` / an injected ``draft`` model) and
  verifies them in one target pass of k + 1 rows (``serving/spec.py``);
- ``postmortem_dir``: an out-of-memory error escaping ``step()`` writes
  the memory postmortem bundle (``obs/memprof.py``), then re-raises.
"""

from __future__ import annotations

import collections
import dataclasses
import math
import time
from typing import Any, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from distributed_llms_example_tpu_torch.core.config import SPEC_MAX_DRAFT_TOKENS
from distributed_llms_example_tpu_torch.core.precision import resolve_device
from distributed_llms_example_tpu_torch.evaluation.generation import (
    causal_prefill,
    init_cache,
    init_causal_cache,
)
from distributed_llms_example_tpu_torch.obs.memprof import (
    dump_postmortem,
    is_resource_exhausted,
    serving_account,
)
from distributed_llms_example_tpu_torch.ops.flash_attention import auto_block
from distributed_llms_example_tpu_torch.ops.mha import KVCache, PagedKVCache, kv_leaves
from distributed_llms_example_tpu_torch.serving import cache_pool, spec
from distributed_llms_example_tpu_torch.serving.cache_pool import to_device
from distributed_llms_example_tpu_torch.utils.jsonlog import log_json


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Engine shape/behavior knobs, as in the JAX package.

    ``max_slots``: concurrent in-flight sequences (the decode batch).
    ``prefill_batch``: sequences prefilled per admission chunk (0 =
    ``max_slots``).  ``max_source_length``: prompt width.
    ``max_new_tokens``: decode budget per sequence = the KV-cache length.
    ``request_spans``: one ``serve_request`` event per finished request.
    ``ttft_slo_ms``: first-token SLO for the goodput fields (0 = none).
    ``prefill_buckets``: ascending admission widths; each chunk pads to the
    smallest covering bucket (``max_source_length`` is the implicit last).
    ``hbm_budget_gib``: device-memory ceiling for the summary's account
    (an H100 has 80).  ``paged_kv``: causal K/V in a shared block pool of
    ``pool_blocks`` blocks (0 = slots × tiles per slot) of
    ``kv_block_size`` slots (0 = derived from the cache width and the
    buckets).  ``kv_cache_dtype``: "f32" (K/V in the compute dtype, the
    JAX flag's name) or "int8".  ``prefix_cache``: share full prompt blocks
    across requests (paged only); ``prefix_cache_budget_gib`` keeps
    finished requests' blocks warm up to that many GiB.  ``spec_tokens``:
    speculative decode, k drafts a slot a round (causal only, 1 ..
    ``SPEC_MAX_DRAFT_TOKENS``); ``spec_draft_model``: a registry name or
    HF directory of the draft model ("" = n-gram self-drafting).
    ``postmortem_dir``: where an out-of-memory error mid-serve writes its
    memory postmortem ("" = off)."""

    max_slots: int = 8
    prefill_batch: int = 0
    max_new_tokens: int = 128
    max_source_length: int = 1024
    log_every_steps: int = 50
    request_spans: bool = True
    ttft_slo_ms: float = 0.0
    kv_cache_dtype: str = "f32"
    prefill_buckets: tuple = ()
    paged_kv: bool = False
    pool_blocks: int = 0
    kv_block_size: int = 0
    prefix_cache: bool = False
    prefix_cache_budget_gib: float = 0.0
    spec_tokens: int = 0
    spec_draft_model: str = ""
    hbm_budget_gib: float = 80.0
    postmortem_dir: str = ""

    def __post_init__(self):
        if self.kv_cache_dtype not in ("f32", "int8"):
            raise ValueError(f"kv_cache_dtype={self.kv_cache_dtype!r}: must be 'f32' or 'int8'")


@dataclasses.dataclass
class ServeStats:
    """Filled by a serving session — the bench/obs read surface."""

    sequences: int = 0
    decode_steps: int = 0
    decode_tokens: int = 0
    decode_seconds: float = 0.0
    prefill_seconds: float = 0.0
    prefill_calls: int = 0  # cold admission chunks prefilled (from cache slot 0)
    warm_admit_calls: int = 0  # prefix cache: warm chunks (uncached tails only)
    admit_deferrals: int = 0  # paged: admissions deferred on a short free list
    slot_occupancy: float = 0.0
    cache_bytes_resident: int = 0
    peak_cache_bytes_in_use: int = 0
    bytes_per_live_token: float = 0.0
    # prefix cache: a lookup per admitted request, a hit when its longest
    # cached chain is >= 1 block; tokens saved = prompt tokens served from
    # shared blocks instead of prefilled
    prefix_lookups: int = 0
    prefix_hits: int = 0
    prefill_tokens_total: int = 0
    prefill_tokens_saved: int = 0
    # speculative decode: a step is one verify round; drafted counts k a
    # live slot, accepted the drafts the target's argmax confirmed, emitted
    # every appended token; slot_rounds one a live slot a round, so
    # spec_emitted / spec_slot_rounds (accepted_tokens_per_step) is the
    # per-sequence yield in [1, k + 1]
    spec_steps: int = 0
    spec_slot_rounds: int = 0
    spec_drafted: int = 0
    spec_accepted: int = 0
    spec_emitted: int = 0
    ttft_s: list[float] = dataclasses.field(default_factory=list)
    queue_wait_s: list[float] = dataclasses.field(default_factory=list)
    prefill_share_s: list[float] = dataclasses.field(default_factory=list)
    goodput: dict = dataclasses.field(default_factory=dict)

    def tokens_per_sec(self) -> float:
        return self.decode_tokens / max(self.decode_seconds, 1e-9)

    def ttft_percentiles(self) -> tuple[float, float]:
        if not self.ttft_s:
            return 0.0, 0.0
        p50, p95 = percentiles(self.ttft_s, (0.50, 0.95))
        return p50, p95

    def ttft_decomposition(self) -> dict:
        """Queue-wait vs prefill share of TTFT over finished requests."""
        q50, q95 = percentiles(self.queue_wait_s, (0.50, 0.95))
        p50, p95 = percentiles(self.prefill_share_s, (0.50, 0.95))
        total = sum(self.ttft_s)
        return {
            "ttft_queue_p50_ms": round(q50 * 1e3, 1),
            "ttft_queue_p95_ms": round(q95 * 1e3, 1),
            "ttft_prefill_p50_ms": round(p50 * 1e3, 1),
            "ttft_prefill_p95_ms": round(p95 * 1e3, 1),
            "ttft_queue_share": round(sum(self.queue_wait_s) / total, 4) if total else 0.0,
            "ttft_prefill_share": round(sum(self.prefill_share_s) / total, 4) if total else 0.0,
        }


def percentiles(values: Sequence[float], qs: Sequence[float]) -> list[float]:
    """Nearest-rank percentiles of ``values`` (0.0 each when empty)."""
    if not values:
        return [0.0 for _ in qs]
    s = sorted(values)
    return [s[min(len(s) - 1, max(0, int(round(q * (len(s) - 1)))))] for q in qs]


def compute_goodput(ttft_s: Sequence[float | None], tokens_out: Sequence[int], *,
                    wall_s: float, ttft_slo_ms: float, n_chips: int) -> dict:
    """Useful tokens per wall second + SLO attainment.  Useful = tokens of
    finished requests (``ttft_s[i] is not None``) whose first token met
    the SLO (all finished requests when no SLO is set)."""
    wall_s = max(float(wall_s), 1e-9)
    slo_s = float(ttft_slo_ms) / 1e3
    finished = [(i, t) for i, t in enumerate(ttft_s) if t is not None]
    met = [i for i, t in finished if slo_s <= 0 or t <= slo_s]
    useful = sum(int(tokens_out[i]) for i in met)
    out = {
        "goodput_tokens_per_sec": round(useful / wall_s, 1),
        "goodput_tokens_per_sec_chip": round(useful / wall_s / max(n_chips, 1), 1),
    }
    if slo_s > 0:
        out["ttft_slo_ms"] = round(float(ttft_slo_ms), 1)
        out["slo_attainment"] = round(len(met) / len(finished), 4) if finished else 0.0
    return out


class ServingEngine:
    """Greedy continuous-batching decode over a fixed slot set.

    ``model`` is a seq2seq module (``models/t5.py``, ``models/bart.py``:
    ``is_seq2seq``) or a causal LM (``models/llama.py``) already on
    ``device``; ``device`` is CUDA unless ``"cpu"`` is asked for.
    ``draft``: a causal ``LoadedModel`` on ``device`` to draft with in place
    of loading ``spec_draft_model`` (the caller's weights)."""

    def __init__(self, model: Any, config: Any, serve: ServeConfig | None = None, *,
                 is_seq2seq: bool = True, device: str | torch.device | None = None,
                 draft: Any = None):
        self.device = resolve_device(device)
        model_dev = next(model.parameters()).device
        if model_dev.type != self.device.type:
            raise ValueError(f"model is on {model_dev}, engine device is {self.device}")
        self.model, self.config = model, config
        self.serve = serve or ServeConfig()
        self.is_seq2seq = is_seq2seq
        self.eos = config.eos_token_id
        self.pad = config.pad_token_id
        self.start = config.decoder_start_token_id
        self.forced_bos = getattr(config, "forced_bos_token_id", None)
        self.forced_eos = getattr(config, "forced_eos_token_id", None)
        self.L = self.serve.max_new_tokens
        self.S = self.serve.max_slots
        self.W = self.serve.max_source_length
        self.kv_dtype = self.serve.kv_cache_dtype
        self.prefill_batch = self.serve.prefill_batch or self.S
        if not 1 <= self.prefill_batch <= self.S:
            raise ValueError(f"prefill_batch {self.prefill_batch} must be in [1, max_slots={self.S}]")
        self.buckets = tuple(
            sorted({int(b) for b in self.serve.prefill_buckets if 0 < int(b) < self.W})
        ) + (self.W,)
        self.paged = bool(self.serve.paged_kv)
        self.pool: cache_pool.CachePool | None = None
        if self.paged:
            self._init_pool()
        self.prefix = bool(self.serve.prefix_cache)
        if self.prefix and not self.paged:
            raise ValueError(
                "prefix_cache shares paged pool blocks — it requires paged_kv (the flat cache "
                "has no block identity to share)"
            )
        # speculative decode: the verify q block is spec_tokens + 1 rows,
        # capped by the decode kernels' q-row limit
        self.spec = int(self.serve.spec_tokens or 0)
        self.drafter: spec.DraftRunner | None = None
        if self.spec:
            if self.is_seq2seq:
                raise ValueError(
                    "spec_tokens applies to causal decode (the verify q block rides the causal "
                    "decode cache's staggered per-row offsets); seq2seq families run plain decode"
                )
            if not 1 <= self.spec <= SPEC_MAX_DRAFT_TOKENS:
                raise ValueError(
                    f"spec_tokens={self.spec} must be in [1, {SPEC_MAX_DRAFT_TOKENS}]: the "
                    "verify step scores spec_tokens + 1 positions in one decode call and the "
                    f"decode kernels' q block caps at {SPEC_MAX_DRAFT_TOKENS + 1} rows"
                )
            if draft is not None or self.serve.spec_draft_model:
                self.drafter = self._init_drafter(draft)
        self._warmed = False
        self.last_stats: ServeStats | None = None

    def _init_drafter(self, draft: Any) -> spec.DraftRunner:
        name = self.serve.spec_draft_model or "the injected draft"
        if draft is None:
            from distributed_llms_example_tpu_torch.models.registry import load_model

            draft = load_model(self.serve.spec_draft_model, device=self.device,
                               dtype=getattr(self.model, "dtype", torch.float32))
        if draft.is_seq2seq:
            raise ValueError(
                f"spec_draft_model={name!r} is seq2seq — the draft model proposes causal "
                "decode tokens, so it must be a causal family"
            )
        if draft.config.vocab_size != self.config.vocab_size:
            raise ValueError(
                f"spec_draft_model={name!r} vocab {draft.config.vocab_size} != target vocab "
                f"{self.config.vocab_size} — draft proposals are token ids compared against "
                "the target argmax, so the vocabs must be the same id space"
            )
        return spec.DraftRunner(draft.module, slots=self.S, src_width=self.W, max_new=self.L,
                                k=self.spec, kv_cache_dtype=self.kv_dtype,
                                device=self.device)

    def _init_pool(self) -> None:
        """Block size, tiles per slot and the allocator, by the JAX engine's
        rules."""
        if self.is_seq2seq:
            raise ValueError(
                "paged_kv applies to the causal KV cache (prompt + decode tail in one "
                "buffer); the seq2seq slot state is encoder output + cross-KV, which pages "
                "nothing — run the flat cache for seq2seq families"
            )
        width = self.W + self.L
        bs = self.serve.kv_block_size
        if not bs:
            # the block size must tile the cache width and every admission
            # bucket (decode tiles start on tile boundaries): the largest
            # kernel-preferred tile dividing their gcd, else the gcd itself
            g = math.gcd(width, *self.buckets)
            bs = auto_block(g) or (g if g >= 8 and g % 8 == 0 else 0)
        if not bs or width % bs:
            raise ValueError(
                f"kv_block_size={self.serve.kv_block_size} does not tile the cache width "
                f"{width} (prompt {self.W} + decode {self.L}); pass an explicit 8-aligned "
                f"divisor of gcd(width, buckets) = {math.gcd(width, *self.buckets)}"
            )
        for b in self.buckets:
            if b % bs:
                raise ValueError(f"prefill bucket {b} is not a multiple of the kv block size "
                                 f"{bs} — decode tiles must start on a tile boundary")
        self.block_size = int(bs)
        self.n_tiles = width // self.block_size
        n_blocks = self.serve.pool_blocks or self.S * self.n_tiles
        worst = cache_pool.blocks_needed(self.W, self.L, self.block_size)
        if n_blocks < worst:
            raise ValueError(
                f"pool_blocks={n_blocks} cannot hold even one worst-case request ({worst} "
                f"blocks at block size {self.block_size}) — admission would livelock"
            )
        self.pool = cache_pool.CachePool(n_blocks, self.block_size)

    # ------------------------------------------------------------- steps
    @torch.inference_mode()
    def _prefill(self, ids: torch.Tensor, mask: torch.Tensor):
        if self.is_seq2seq:
            enc = self.model.encode(ids, mask)
            return enc, mask, self.model.cross_kv(enc)
        cache, full_mask, lengths, first = causal_prefill(self.model, ids, mask, self.L,
                                                          kv_cache_dtype=self.kv_dtype)
        return cache, full_mask, lengths, first.argmax(dim=-1).to(torch.int32)

    def _pad_axis(self, x: torch.Tensor, axis: int, width: int | None = None) -> torch.Tensor:
        """Right-pad one axis to the slot width with zeros: a bucket-width
        chunk's padding stays mask-invisible (its mask is 0 there)."""
        extra = (width or self.W) - x.shape[axis]
        if extra == 0:
            return x
        pads = [0, 0] * (x.dim() - 1 - axis) + [0, extra]
        return F.pad(x, pads)

    @torch.inference_mode()
    def _admit(self, state: dict, enc, mask, ckv, slot_idx: np.ndarray) -> None:
        """Chunk rows land in their slots in place; rows whose slot index is
        out of range (the chunk's padding rows) are dropped."""
        rows = np.nonzero(slot_idx < self.S)[0]
        if rows.size == 0:
            return
        r = to_device(rows, self.device)
        s = to_device(slot_idx[rows].astype(np.int64), self.device)
        state["enc"][s] = self._pad_axis(enc, 1)[r]
        state["enc_mask"][s] = self._pad_axis(mask, 1)[r]
        for (dk, dv), (k, v) in zip(state["ckv"], ckv):
            dk[s] = self._pad_axis(k, 2)[r]
            dv[s] = self._pad_axis(v, 2)[r]
        state["last"][s] = self.start

    @torch.inference_mode()
    def _admit_causal(self, state: dict, cache, full_mask, first, slot_idx: np.ndarray,
                      admit_blocks: np.ndarray | None = None) -> None:
        """Causal chunk rows into their slots: the chunk cache into the flat
        slot cache (padded to the slot width) or, paged, its allocated
        tiles into the pool; the mask and the first token per slot."""
        width = self.W + self.L
        if self.paged:
            cache_pool.scatter_admit(state["pool"], [kv_leaves(c) for c in cache],
                                     admit_blocks, self.block_size)
        rows = np.nonzero(slot_idx < self.S)[0]
        if rows.size == 0:
            return
        r = to_device(rows, self.device)
        s = to_device(slot_idx[rows].astype(np.int64), self.device)
        if not self.paged:
            for dst, src in zip(state["cache"], cache):
                for d, x in zip(kv_leaves(dst), kv_leaves(src)):
                    d[s] = self._pad_axis(x, 2, width)[r]
        state["mask"][s] = self._pad_axis(full_mask, 1, width)[r]
        state["last"][s] = first[r]

    @torch.inference_mode()
    def _warm_admit(self, state: dict, ids_tail: np.ndarray, mask_full: np.ndarray,
                    start: np.ndarray, tail_last: np.ndarray, slot_idx: np.ndarray,
                    block_tables: np.ndarray, admit_blocks: np.ndarray) -> torch.Tensor:
        """Warm admission: each row's longest cached chain is already in the
        pool, so the model runs over only the uncached tail (``ids_tail``,
        at the tail bucket's width) against a gathered view of the row's
        blocks, at absolute positions from ``start`` (the chain's length),
        writing the tail's K/V as a span from there.  The first token reads
        off the last real tail position, where the cold prefill reads it;
        only the fresh tail tiles scatter back (``admit_blocks`` holds
        sentinels over the shared chain, which is never written).  Returns
        the first tokens on the device."""
        dev = self.device
        bt = to_device(block_tables, dev)
        view = [KVCache(*leaves[:2], 0, *leaves[2:])
                for leaves in cache_pool.gather_cache(state["pool"], bt)]
        start_t = to_device(start.astype(np.int32), dev)
        T = ids_tail.shape[1]
        mask_t = to_device(mask_full, dev)
        logits = self.model(to_device(ids_tail, dev), mask_t,
                            positions=start_t.long()[:, None] + torch.arange(T, device=dev),
                            cache=view, cache_positions=start_t)
        rows = torch.arange(logits.shape[0], device=dev)
        first = logits[rows, to_device(tail_last.astype(np.int64), dev)]
        first = first.argmax(dim=-1).to(torch.int32)
        cache_pool.scatter_admit(state["pool"], [kv_leaves(c) for c in view], admit_blocks,
                                 self.block_size)
        keep = np.nonzero(slot_idx < self.S)[0]
        r = to_device(keep, dev)
        s = to_device(slot_idx[keep].astype(np.int64), dev)
        state["mask"][s] = mask_t[r]
        state["last"][s] = first[r]
        return first

    def _paged_caches(self, state: dict, block_tables: np.ndarray, offsets: np.ndarray,
                      span: int = 1) -> list[PagedKVCache]:
        """Each layer's view of the pool for one pass writing ``span`` rows
        a slot from ``offsets`` (host arrays): one write plan, shared."""
        dev = self.device
        bt = to_device(block_tables, dev)
        plan = cache_pool.step_write_plan(block_tables, offsets, num_blocks=self.pool.num_blocks,
                                          block_size=self.block_size, device=dev, span=span)
        return [PagedKVCache(k, v, bt, plan, span, *scales) for k, v, *scales in state["pool"]]

    @torch.inference_mode()
    def _step(self, state: dict, offsets: np.ndarray, active: np.ndarray) -> torch.Tensor:
        # idle slots park at L: their cache writes drop and their tokens are
        # masked to pad below
        offs_h = np.where(active, offsets, self.L).astype(np.int32)
        offs = to_device(offs_h, self.device)
        act = to_device(active, self.device)
        logits = self.model.decode(
            state["last"], None, state["enc_mask"], cache=state["cache"],
            cache_offset=offs, cross_kv=state["ckv"],
        )
        nxt = logits[:, -1].argmax(dim=-1).to(torch.int32)
        if self.forced_bos is not None:
            nxt = torch.where(offs == 0, self.forced_bos, nxt)
        if self.forced_eos is not None:
            nxt = torch.where(offs == self.L - 1, self.forced_eos, nxt)
        nxt = torch.where(act, nxt, self.pad).to(torch.int32)
        state["last"] = nxt[:, None].clone()
        return nxt

    @torch.inference_mode()
    def _step_causal(self, state: dict, write_pos: np.ndarray, rope_pos: np.ndarray,
                     active: np.ndarray, block_tables: np.ndarray | None = None) -> torch.Tensor:
        """One causal decode step: slot s feeds its last token at cache slot
        ``write_pos[s]`` with RoPE position ``rope_pos[s]``; idle slots park
        past the cache width, so their writes drop."""
        dev = self.device
        width = state["mask"].shape[1]
        offs_h = np.where(active, write_pos, width).astype(np.int32)
        live = np.nonzero(offs_h < width)[0]
        # the value made on the device: a host scalar would be a blocking
        # one-element copy, a sync every round
        state["mask"].index_put_((to_device(live, dev), to_device(offs_h[live].astype(np.int64), dev)),
                                 state["mask"].new_ones(()))
        offs = to_device(offs_h, dev)
        cache = (self._paged_caches(state, block_tables, offs_h) if self.paged
                 else state["cache"])
        logits = self.model(
            state["last"][:, None], state["mask"],
            positions=to_device(rope_pos.astype(np.int64), dev)[:, None],
            cache=cache, cache_positions=offs,
        )
        nxt = logits[:, -1].argmax(dim=-1).to(torch.int32)
        nxt = torch.where(to_device(active, dev), nxt, self.pad).to(torch.int32)
        state["last"] = nxt
        return nxt

    @torch.inference_mode()
    def _verify(self, state: dict, x: torch.Tensor, write_pos: np.ndarray, rope_pos: np.ndarray,
                active: np.ndarray, room: np.ndarray, block_tables: np.ndarray | None):
        """One speculative verify round (``spec.verify``); paged, the pass
        writes its k + 1 rows a slot through one span write plan."""
        dev = self.device
        cache = None
        if self.paged:
            width = state["mask"].shape[1]
            offs_h = np.where(active, write_pos, width).astype(np.int32)
            cache = self._paged_caches(state, block_tables, offs_h, span=self.spec + 1)
        t = lambda a: to_device(a, dev)  # noqa: E731
        return spec.verify(self.model, state, x, write_pos=t(write_pos.astype(np.int32)),
                           rope_pos=t(rope_pos.astype(np.int32)), active=t(active),
                           room=t(room), pad=self.pad, cache=cache)

    # ------------------------------------------------------------- state
    def _init_state(self) -> dict:
        S, W, L = self.S, self.W, self.L
        cfg, dt, dev = self.config, self.model.dtype, self.device
        kv = self.kv_dtype
        if not self.is_seq2seq:
            state = {
                "mask": torch.zeros((S, W + L), dtype=torch.int32, device=dev),
                "last": torch.full((S,), self.pad, dtype=torch.int32, device=dev),
            }
            if self.paged:
                # one slot's worth of shapes is enough to size the pool
                one = init_causal_cache(self.model, 1, 1, device=dev, kv_cache_dtype=kv)
                state["pool"] = cache_pool.pool_cache_tree(
                    [kv_leaves(c) for c in one], self.pool.num_blocks, self.block_size)
            else:
                state["cache"] = init_causal_cache(self.model, S, W + L, device=dev,
                                                   kv_cache_dtype=kv)
            return state
        # the cross-K/V slots take each decoder layer's own cross-attention
        # shape, so any seq2seq family (BART, T5) sizes its state alike
        ckv = []
        for blk in self.model.decoder_blocks:
            shape = (S, blk.cross_attn.kv_heads, W, blk.cross_attn.head_dim)
            ckv.append((torch.zeros(shape, dtype=dt, device=dev),
                        torch.zeros(shape, dtype=dt, device=dev)))
        return {
            "cache": init_cache(self.model, S, L, device=dev, kv_cache_dtype=kv),
            "enc": torch.zeros((S, W, cfg.d_model), dtype=dt, device=dev),
            "enc_mask": torch.zeros((S, W), dtype=torch.int32, device=dev),
            "ckv": ckv,
            "last": torch.full((S, 1), self.pad, dtype=torch.int32, device=dev),
        }

    def _state_byte_account(self, state: dict) -> tuple[int, int]:
        """(resident bytes, per-block bytes) of the serving K/V state
        (cache or pool, + enc + cross-KV for seq2seq); per-block is 0 on the
        flat paths."""
        if self.paged:
            return (cache_pool.tree_bytes(state["pool"]),
                    cache_pool.block_bytes(state["pool"], self.pool.num_blocks))
        keys = ("cache", "enc", "ckv") if self.is_seq2seq else ("cache",)
        return sum(cache_pool.tree_bytes(state[k]) for k in keys), 0

    def warm(self) -> None:
        """Build the CUDA kernels before the first request, so no request
        pays a kernel build (the JAX package AOT-compiles its programs
        here): a seq2seq prefill (BART, or T5 through the learned-bias
        branch) runs the flash forward and its decode the flash decode
        kernel; a causal decode runs the paged or the flat decode kernel,
        a warm prefix tail and a draft model's decode the flat one.
        Nothing to do on the CPU."""
        if self._warmed:
            return
        if self.device.type == "cuda":
            from distributed_llms_example_tpu_torch.ops import cuda_build

            names = (["flash_fwd", "flash_decode"] if self.is_seq2seq
                     else ["flash_decode_paged"] if self.paged else ["flash_decode"])
            if self.prefix or self.drafter is not None:
                names.append("flash_decode")
            cuda_build.build(sorted(set(names)))
        self._warmed = True

    # -------------------------------------------------------------- loop
    def open(self) -> "ServeSession":
        return ServeSession(self)

    def generate(self, requests: Sequence[Sequence[int]], *,
                 max_new: Sequence[int] | None = None) -> list[list[int]]:
        """Serve ``requests`` (token-id prompts, order preserved) to
        completion; returns per-request generated ids (eos included when
        emitted).  ``max_new`` caps each request below ``max_new_tokens``."""
        if max_new is not None and len(max_new) != len(requests):
            raise ValueError(f"max_new has {len(max_new)} entries for {len(requests)} requests")
        sess = self.open()
        for i, req in enumerate(requests):
            sess.submit(req, max_new=max_new[i] if max_new is not None else None)
        while sess.has_work():
            sess.step()
        sess.finalize()
        return list(sess.outputs)


class ServeSession:
    """One serving lifetime over an engine, stepwise: ``submit`` requests,
    drive ``step()`` per scheduler round, ``finalize()`` at the end."""

    def __init__(self, engine: ServingEngine):
        eng = self.eng = engine
        self.n_chips = 1
        S = eng.S
        self.requests: list[list[int]] = []
        self.budgets: list[int] = []
        self.outputs: list[list[int]] = []
        self.ttft: list[float | None] = []
        self.submit_t: list[float] = []
        self.admit_t: list[float | None] = []
        self.prefill_dt: list[float] = []
        self.pending: collections.deque[int] = collections.deque()
        self.stats = ServeStats()
        self.slot_req = np.full(S, -1, np.int64)
        self.emitted = np.zeros(S, np.int64)
        self.lengths = np.zeros(S, np.int64)  # true prompt lengths
        self.base = np.full(S, eng.W, np.int64)  # causal: decode tail start
        self.active = np.zeros(S, bool)
        # paged: blocks each slot holds, and the block tables the step reads
        # (sentinel = num_blocks: reads see nothing, writes drop); prefix
        # cache: each slot's registered full-prompt chain (root first), a
        # part of its blocks, released tail first so the warm LRU keeps a
        # chain's root longest
        self.slot_blocks: list[list[int]] = [[] for _ in range(S)]
        self.slot_chain: list[list[int]] = [[] for _ in range(S)]
        self.slot_bt = (np.full((S, eng.n_tiles), eng.pool.num_blocks, np.int32)
                        if eng.paged else None)
        eng.warm()
        self.state = eng._init_state()
        self.t_open = time.perf_counter()
        self.stats.cache_bytes_resident, self._per_block = eng._state_byte_account(self.state)
        if eng.paged and eng.prefix:
            # the pool tensors were just made anew: chains a previous
            # session left warm index nothing now
            eng.pool.drop_warm()
            if self._per_block:
                eng.pool.warm_capacity = int(
                    eng.serve.prefix_cache_budget_gib * (1 << 30) // self._per_block)
        self.params_bytes = sum(p.numel() * p.element_size() for p in eng.model.parameters())
        self._bpt_samples: list[float] = []
        self._win_tokens, self._win_occ = 0, 0.0
        self._win_t0 = time.perf_counter()
        self._win_prefill, self._win_decode = 0.0, 0.0
        self._win_arrivals, self._win_done = 0, 0
        # speculative decode: what each slot appended last round (the draft
        # model's catch-up feed; None until its first round), the draft
        # model's own slot state
        self._spec_fed: list[list[int] | None] = [None] * S
        self.draft_state = eng.drafter.init_state() if eng.drafter is not None else None
        self._win_spec_steps, self._win_spec_emitted = 0, 0
        self._finalized = False

    # ------------------------------------------------------------ intake
    def submit(self, tokens: Sequence[int], *, max_new: int | None = None) -> int:
        """Enqueue one request (closed loop: it arrives when submitted);
        returns the session-local rid, which its ``serve_request`` event
        carries."""
        if self._finalized:
            raise RuntimeError("session already finalized")
        rid = len(self.requests)
        self.requests.append(list(tokens))
        self.budgets.append(min(int(max_new), self.eng.L) if max_new is not None else self.eng.L)
        self.outputs.append([])
        self.ttft.append(None)
        self.submit_t.append(time.perf_counter())
        self.admit_t.append(None)
        self.prefill_dt.append(0.0)
        self.pending.append(rid)
        self.stats.sequences += 1
        self._win_arrivals += 1
        return rid

    def has_work(self) -> bool:
        return bool(self.pending) or bool(self.active.any())

    def prefix_ref_violations(self) -> list[str]:
        """The pool's refcount invariant walked from this session's live
        block tables (``CachePool.ref_invariant_violations``); empty when
        every block's refcount equals its live references."""
        return self.eng.pool.ref_invariant_violations([sb for sb in self.slot_blocks if sb])

    def _bytes_in_use(self) -> int:
        if self.eng.paged:
            return self.eng.pool.blocks_in_use * self._per_block
        return self.stats.cache_bytes_resident

    def _live_tokens(self) -> int:
        return int((self.lengths[self.active] + self.emitted[self.active]).sum())

    # --------------------------------------------------------- lifecycle
    def _finish_request(self, rid: int, slot: int, now: float) -> None:
        if not self.eng.serve.request_spans:
            return
        t_sub = self.submit_t[rid]
        t_admit = self.admit_t[rid] if self.admit_t[rid] is not None else t_sub
        queue_wait = t_admit - t_sub
        t = self.ttft[rid]
        record = {
            "event": "serve_request",
            "request": rid,
            "slot": int(slot),
            # arrival == submit under closed-loop driving: the open-loop
            # load generator's arrival→submit stage reads 0, as in the JAX engine
            "t_arrival_s": round(t_sub - self.t_open, 6),
            "queue_delay_ms": 0.0,
            "queue_wait_ms": round(queue_wait * 1e3, 3),
            "prefill_ms": round(self.prefill_dt[rid] * 1e3, 3),
            "ttft_ms": round(t * 1e3, 3) if t is not None else None,
            "decode_ms": round((now - t_sub - (t if t is not None else queue_wait)) * 1e3, 3),
            "tokens": len(self.outputs[rid]),
            "t_admit_s": round(t_admit - self.t_open, 6),
            "t_done_s": round(now - self.t_open, 6),
            "finished_at_step": int(self.stats.decode_steps),
        }
        log_json(record)

    def _evict_slot(self, slot: int) -> None:
        """Free the slot now and, paged, drop one reference on every block
        it held (a shared block survives until its last holder leaves); the
        registered chain goes tail first."""
        self.active[slot] = False
        self.slot_req[slot] = -1
        self._spec_fed[slot] = None
        self._win_done += 1
        if self.eng.paged and self.slot_blocks[slot]:
            chain = self.slot_chain[slot]
            in_chain = set(chain)
            rest = [b for b in self.slot_blocks[slot] if b not in in_chain]
            self.eng.pool.free(rest + chain[::-1])
            self.slot_blocks[slot] = []
            self.slot_chain[slot] = []
            self.slot_bt[slot, :] = self.eng.pool.num_blocks

    def _emit(self, slot: int, tok: int, now: float, finished: list) -> bool:
        """Append one generated token to the slot's request; evict on eos
        or an exhausted budget (True when it did)."""
        rid = int(self.slot_req[slot])
        self.outputs[rid].append(tok)
        if self.ttft[rid] is None:
            self.ttft[rid] = now - self.submit_t[rid]
        self.emitted[slot] += 1
        if tok == self.eng.eos or self.emitted[slot] >= self.budgets[rid]:
            self._evict_slot(slot)
            self._finish_request(rid, slot, now)
            finished.append(rid)
            return True
        return False

    def _admit_row(self, rid: int, slot: int, length: int, base: int, t0: float, dt: float,
                   now: float, finished: list, first: int | None = None) -> None:
        """A request's slot bookkeeping after its prefill; a causal
        prefill's first token is emitted here."""
        self.slot_req[slot] = rid
        self.emitted[slot] = 0
        self.lengths[slot] = length
        self.base[slot] = base
        self.active[slot] = True
        self.admit_t[rid] = t0
        self.prefill_dt[rid] = dt
        if first is not None:
            self._emit(slot, first, now, finished)

    def _prefill_chunk(self, rows: list[tuple[int, int]], bucket: int, finished: list,
                       admit_rows: np.ndarray | None = None) -> None:
        """One cold admission chunk: ``rows`` (rid, slot) prefilled from
        cache slot 0 at ``bucket`` width and admitted (paged: by
        ``admit_rows``, the chunk's (chunk, tiles) block assignment)."""
        eng = self.eng
        C, S = eng.prefill_batch, eng.S
        ids = np.full((C, bucket), eng.pad, np.int64)
        mask = np.zeros((C, bucket), np.int32)
        slot_idx = np.full(C, S, np.int64)  # padding rows drop
        for r, (rid, slot) in enumerate(rows):
            toks = self.requests[rid][:bucket]
            ids[r, : len(toks)] = toks
            mask[r, : len(toks)] = 1
            slot_idx[r] = slot
        t0 = time.perf_counter()
        pre = eng._prefill(to_device(ids, eng.device),
                           to_device(mask, eng.device))
        if eng.is_seq2seq:
            enc, pmask, ckv = pre
            eng._admit(self.state, enc, pmask, ckv, slot_idx)
            if eng.device.type == "cuda":
                torch.cuda.synchronize(eng.device)  # the prefill's time is its device time
            lengths, firsts = [min(len(self.requests[rid]), eng.W) for rid, _ in rows], None
        else:
            cache, full_mask, plens, first = pre
            eng._admit_causal(self.state, cache, full_mask, first, slot_idx,
                              None if admit_rows is None else admit_rows.reshape(-1))
            lengths, firsts = plens.cpu().tolist(), first.cpu().tolist()
            del cache, pre
        dt = time.perf_counter() - t0
        self.stats.prefill_seconds += dt
        self.stats.prefill_calls += 1
        self._win_prefill += dt
        now = time.perf_counter()
        for r, (rid, slot) in enumerate(rows):
            self._admit_row(rid, slot, int(lengths[r]), bucket, t0, dt, now, finished,
                            None if firsts is None else int(firsts[r]))

    def _admit_now(self, finished: list) -> None:
        eng = self.eng
        if eng.paged and eng.prefix:
            self._admit_now_prefix(finished)
            return
        S, W, C = eng.S, eng.W, eng.prefill_batch
        free = [i for i in range(S) if not self.active[i]]
        n = min(len(free), C, len(self.pending))
        if n == 0:
            return
        plen = lambda rid: min(len(self.requests[rid]), W)  # noqa: E731
        if eng.paged:
            # shrink the chunk until the free list funds it: admission
            # defers on a short pool instead of over-committing
            while n > 0 and not eng.pool.can_alloc(sum(
                    cache_pool.blocks_needed(plen(self.pending[i]),
                                             self.budgets[self.pending[i]], eng.block_size)
                    for i in range(n))):
                n -= 1
            if n == 0:
                self.stats.admit_deferrals += 1
                return
        reqs = [self.pending.popleft() for _ in range(n)]
        bucket = next(b for b in eng.buckets if b >= max(plen(rid) for rid in reqs))
        admit_rows = None
        if eng.paged:
            # fund and map each row's blocks before the prefill; the flat
            # (chunk × chunk tiles) assignment carries sentinels for tiles
            # that must not copy (padding rows, the prompt gap)
            ntc = (bucket + eng.L) // eng.block_size
            admit_rows = np.full((C, ntc), eng.pool.num_blocks, np.int32)
            for r, rid in enumerate(reqs):
                blocks = eng.pool.alloc(
                    cache_pool.blocks_needed(plen(rid), self.budgets[rid], eng.block_size))
                self.slot_blocks[free[r]] = blocks
                admit_rows[r, :] = self._map_blocks(free[r], rid, plen(rid), bucket)[:ntc]
        self._prefill_chunk(list(zip(reqs, free)), bucket, finished, admit_rows)
        self.stats.peak_cache_bytes_in_use = max(
            self.stats.peak_cache_bytes_in_use, self._bytes_in_use()
        )

    def _map_blocks(self, slot: int, rid: int, p: int, bucket: int) -> np.ndarray:
        """The slot's block-table row over its blocks, set and returned."""
        eng = self.eng
        row = cache_pool.build_block_row(
            eng.n_tiles, self.slot_blocks[slot], prompt_len=p, bucket_width=bucket,
            budget=self.budgets[rid], block_size=eng.block_size, sentinel=eng.pool.num_blocks)
        self.slot_bt[slot, :] = row
        return row

    def _admit_now_prefix(self, finished: list) -> None:
        """Prefix-cache admission: per row, match the longest cached chain,
        acquire it and allocate only the tail (rolled back when the pool
        comes up short), then at most two dispatches: the cold prefill
        chunk of the rows with no cached prefix, then one warm chunk that
        gathers the matched chains and prefills only the tails.  Cold goes
        first so a warm row may match a chain a cold row of the same wave
        registered; a warm row must not match another warm row's fresh
        tail blocks (written in the same pass it would gather from), so a
        match stops before any block this wave's warm chunk writes."""
        eng = self.eng
        S, W, C = eng.S, eng.W, eng.prefill_batch
        bs, N = eng.block_size, eng.pool.num_blocks
        free = [i for i in range(S) if not self.active[i]]
        n = min(len(free), C, len(self.pending))
        if n == 0:
            return
        cold: list[tuple[int, int, int]] = []  # rid, slot, prompt length
        warm: list[dict] = []
        warm_written: set[int] = set()
        taken = 0
        while taken < n:
            rid = self.pending[0]
            p = min(len(self.requests[rid]), W)
            toks = self.requests[rid][:p]
            hashes = cache_pool.chain_hashes(toks, bs)
            # keep >= 1 prompt token in the tail: the first output token
            # comes from the last prompt position's logits
            chain = eng.pool.match_chain(hashes[: (p - 1) // bs])
            for i, b in enumerate(chain):
                if b in warm_written:
                    chain = chain[:i]
                    break
            k = len(chain)
            need = max(1, math.ceil(p / bs)) - k + math.ceil(max(self.budgets[rid], 1) / bs)
            if k:
                eng.pool.acquire(chain)
            fresh = eng.pool.alloc(need)
            if fresh is None:
                if k:
                    eng.pool.free(chain[::-1])  # roll back
                break
            self.pending.popleft()
            slot = free[taken]
            taken += 1
            blocks = chain + fresh
            self.slot_blocks[slot] = blocks
            full_tiles = p // bs
            if full_tiles:
                eng.pool.register(blocks[:full_tiles], hashes[:full_tiles])
            self.slot_chain[slot] = list(blocks[:full_tiles])
            self.stats.prefix_lookups += 1
            self.stats.prefill_tokens_total += p
            if k:
                self.stats.prefix_hits += 1
                self.stats.prefill_tokens_saved += k * bs
                warm_written.update(blocks[k:full_tiles])
                warm.append({"rid": rid, "slot": slot, "p": p,
                             "bucket": next(b for b in eng.buckets if b >= p),
                             "start": k * bs, "tail": toks[k * bs:]})
            else:
                cold.append((rid, slot, p))
        if taken == 0:
            self.stats.admit_deferrals += 1
            return
        if cold:
            bucket = next(b for b in eng.buckets if b >= max(p for _, _, p in cold))
            ntc = (bucket + eng.L) // bs
            admit_rows = np.full((C, ntc), N, np.int32)
            for r, (rid, slot, p) in enumerate(cold):
                admit_rows[r, :] = self._map_blocks(slot, rid, p, bucket)[:ntc]
            self._prefill_chunk([(rid, slot) for rid, slot, _ in cold], bucket, finished,
                                admit_rows)
        if warm:
            self._warm_chunk(warm, finished)
        self.stats.peak_cache_bytes_in_use = max(
            self.stats.peak_cache_bytes_in_use, self._bytes_in_use()
        )

    def _warm_chunk(self, warm: list[dict], finished: list) -> None:
        """The warm admission chunk (``ServingEngine._warm_admit``)."""
        eng = self.eng
        C, S, bs, N = eng.prefill_batch, eng.S, eng.block_size, eng.pool.num_blocks
        width = eng.W + eng.L
        tail_bucket = next(b for b in eng.buckets if b >= max(len(w["tail"]) for w in warm))
        ids_t = np.full((C, tail_bucket), eng.pad, np.int64)
        mask_f = np.zeros((C, width), np.int32)
        start = np.full(C, width, np.int32)  # padding rows write nowhere
        tail_last = np.zeros(C, np.int64)
        slot_idx = np.full(C, S, np.int64)
        bt = np.full((C, eng.n_tiles), N, np.int32)
        admit_rows = np.full((C, eng.n_tiles), N, np.int32)
        for r, wr in enumerate(warm):
            slot, tail = wr["slot"], wr["tail"]
            ids_t[r, : len(tail)] = tail
            mask_f[r, : wr["p"]] = 1
            start[r] = wr["start"]
            tail_last[r] = len(tail) - 1
            slot_idx[r] = slot
            row = self._map_blocks(slot, wr["rid"], wr["p"], wr["bucket"])
            bt[r, :] = row
            # only the fresh prompt tiles scatter back: the matched chain is
            # shared and never written; decode tiles are written by decode
            k_tiles, p_tiles = wr["start"] // bs, max(1, math.ceil(wr["p"] / bs))
            admit_rows[r, k_tiles:p_tiles] = row[k_tiles:p_tiles]
        t0 = time.perf_counter()
        first = eng._warm_admit(self.state, ids_t, mask_f, start, tail_last, slot_idx, bt,
                                admit_rows.reshape(-1)).cpu().tolist()
        dt = time.perf_counter() - t0
        self.stats.prefill_seconds += dt
        self.stats.warm_admit_calls += 1
        self._win_prefill += dt
        now = time.perf_counter()
        for r, wr in enumerate(warm):
            self._admit_row(wr["rid"], wr["slot"], wr["p"], wr["bucket"], t0, dt, now,
                            finished, int(first[r]))

    def _memory_account(self) -> dict:
        return serving_account(
            params_bytes=self.params_bytes, kv_cache_bytes=self._bytes_in_use(),
            hbm_budget_gib=self.eng.serve.hbm_budget_gib,
        )

    def step(self) -> list[int]:
        """One scheduler round: admit into free slots, then one decode step
        (or speculative verify round) if any slot is live.  Returns the
        rids that finished (at prefill included).  An out-of-memory error
        escaping the round writes the memory postmortem when
        ``postmortem_dir`` is set, then re-raises."""
        try:
            return self._step_round()
        except Exception as e:
            self._oom_tripwire(e)
            raise

    def _oom_tripwire(self, e: BaseException) -> None:
        out_dir = self.eng.serve.postmortem_dir
        if not out_dir or not is_resource_exhausted(e):
            return
        dump_postmortem(
            out_dir, reason=f"{type(e).__name__}: {str(e)[:300]}",
            step=self.stats.decode_steps, account=self._memory_account(),
            device=self.eng.device if self.eng.device.type == "cuda" else None,
        )

    def _spec_dispatch(self, offsets: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Assemble and run one draft-then-verify round: drafts from the
        n-gram self-drafter or the draft model (``serving/spec.py``), the
        target's verify pass, one device-to-host read of its tokens and
        emit counts.  Returns host arrays ``(target (S, k+1), n_emit
        (S,))``."""
        eng = self.eng
        K, S, dev = eng.spec, eng.S, eng.device
        x0 = np.full((S, 1), eng.pad, np.int32)
        room = np.zeros((S,), np.int32)
        live = np.nonzero(self.active)[0]
        for s in live:
            rid = int(self.slot_req[s])
            x0[s, 0] = self.outputs[rid][-1]
            # the budget left minus the bonus token that always lands
            room[s] = max(int(self.budgets[rid]) - int(self.emitted[s]) - 1, 0)
        if eng.drafter is not None:
            self._draft_admissions()
            fed = np.full((S, K + 1), eng.pad, np.int32)
            n_fed = np.zeros((S,), np.int32)
            pos0 = np.zeros((S,), np.int32)
            rope0 = np.zeros((S,), np.int32)
            for s in live:
                f = self._spec_fed[s]
                fed[s, : len(f)] = f
                n_fed[s] = len(f)
                pos0[s] = int(self.base[s]) + int(self.emitted[s]) - len(f)
                rope0[s] = int(self.lengths[s]) + int(self.emitted[s]) - len(f)
            t = lambda a: to_device(a, dev)  # noqa: E731
            act = t(self.active)
            drafts = eng.drafter.round(self.draft_state, t(fed), t(n_fed), t(pos0), t(rope0),
                                       act)
            x = torch.cat([t(x0), torch.where(act[:, None], drafts, eng.pad)], dim=1)
        else:
            hist = [self.requests[int(self.slot_req[s])] + self.outputs[int(self.slot_req[s])]
                    if self.active[s] else None for s in range(S)]
            x = to_device(np.concatenate([x0, spec.ngram_drafts(hist, K, eng.pad)], 1), dev)
        target, n_emit = eng._verify(self.state, x, offsets, self.lengths + self.emitted - 1,
                                     self.active.copy(), room, self.slot_bt)
        both = torch.cat([target, n_emit[:, None]], dim=1).cpu().numpy()
        return both[:, :-1], both[:, -1]

    def _draft_admissions(self) -> None:
        """Slots admitted since the last round enter the draft model's
        cache: the draft prefills the same whole prompts at the same bucket
        widths (under a warm prefix hit too: its cache shares nothing), and
        the catch-up feed starts from the admission's first token."""
        eng = self.eng
        need = [s for s in np.nonzero(self.active)[0] if self._spec_fed[s] is None]
        if not need:
            return
        by_bucket: dict[int, list[int]] = collections.defaultdict(list)
        for s in need:
            self._spec_fed[s] = [self.outputs[int(self.slot_req[s])][-1]]
            by_bucket[int(self.base[s])].append(s)
        C = eng.prefill_batch
        for bucket, slots in sorted(by_bucket.items()):
            for i in range(0, len(slots), C):
                ids = np.full((C, bucket), eng.pad, np.int64)
                mask = np.zeros((C, bucket), np.int32)
                slot_idx = np.full((C,), eng.S, np.int64)
                for r, s in enumerate(slots[i:i + C]):
                    toks = self.requests[int(self.slot_req[s])][:bucket]
                    ids[r, : len(toks)] = toks
                    mask[r, : len(toks)] = 1
                    slot_idx[r] = s
                eng.drafter.admit_prompt(self.draft_state, to_device(ids, eng.device),
                                         to_device(mask, eng.device), slot_idx)

    def _spec_append(self, toks: np.ndarray, n_emit: np.ndarray, now: float,
                     finished: list) -> int:
        """Append one verify round's accepted prefix + bonus token a live
        slot, with the plain loop's eos/budget eviction (an accepted prefix
        crossing eos stops there).  Returns the tokens appended."""
        stats = self.stats
        appended = slot_rounds = 0
        for slot in np.nonzero(self.active)[0]:
            n = int(n_emit[slot])
            slot_rounds += 1
            stats.spec_drafted += self.eng.spec
            stats.spec_accepted += n - 1
            fed: list[int] = []
            for j in range(n):
                fed.append(int(toks[slot, j]))
                appended += 1
                if self._emit(slot, fed[-1], now, finished):
                    break
            else:
                self._spec_fed[slot] = fed
        stats.spec_steps += 1
        stats.spec_slot_rounds += slot_rounds
        stats.spec_emitted += appended
        self._win_spec_steps += slot_rounds
        self._win_spec_emitted += appended
        return appended

    def _step_round(self) -> list[int]:
        if self._finalized:
            raise RuntimeError("session already finalized")
        eng = self.eng
        finished: list[int] = []
        self._admit_now(finished)
        if not self.active.any():
            return finished
        t0 = time.perf_counter()
        if eng.spec:
            spec_toks, spec_emit = self._spec_dispatch(self.base + self.emitted - 1)
        elif eng.is_seq2seq:
            toks = eng._step(self.state, self.emitted.astype(np.int32),
                             self.active.copy()).cpu().numpy()
        else:
            toks = eng._step_causal(self.state, self.base + self.emitted - 1,
                                    self.lengths + self.emitted - 1, self.active.copy(),
                                    self.slot_bt).cpu().numpy()
        dt = time.perf_counter() - t0
        self.stats.decode_seconds += dt
        self.stats.decode_steps += 1
        self._win_decode += dt
        n_active = int(self.active.sum())
        self.stats.slot_occupancy += n_active / eng.S
        self._win_occ += n_active / eng.S
        self._bpt_samples.append(self._bytes_in_use() / max(self._live_tokens(), 1))
        now = time.perf_counter()
        if eng.spec:
            # a verify round appends 1..k+1 tokens a slot: the account counts
            # the tokens emitted
            appended = self._spec_append(spec_toks, spec_emit, now, finished)
        else:
            appended = n_active
            for slot in np.nonzero(self.active)[0]:
                self._emit(slot, int(toks[slot]), now, finished)
        self.stats.decode_tokens += appended
        self._win_tokens += appended
        every = eng.serve.log_every_steps
        if every and self.stats.decode_steps % every == 0:
            self._log_window(now, every)
        return finished

    def _log_window(self, now: float, every: int) -> None:
        eng, stats = self.eng, self.stats
        w_dt = max(now - self._win_t0, 1e-9)
        window = {
            "event": "serve_window",
            "step": stats.decode_steps,
            "decode_tokens_per_sec": round(self._win_tokens / w_dt, 1),
            "decode_tokens_per_sec_chip": round(self._win_tokens / w_dt / self.n_chips, 1),
            "slot_occupancy": round(self._win_occ / every, 4),
            "queue_depth": len(self.pending),
            "arrival_rate_per_sec": round(self._win_arrivals / w_dt, 2),
            "service_rate_per_sec": round(self._win_done / w_dt, 2),
            "queue_growth": int(self._win_arrivals - self._win_done),
            "prefill_ms": round(self._win_prefill * 1e3, 1),
            "decode_ms": round(self._win_decode * 1e3, 1),
            "cache_bytes_in_use": self._bytes_in_use(),
            "cache_bytes_per_token": round(
                self._bytes_in_use() / max(self._live_tokens(), 1), 1
            ),
        }
        if eng.paged:
            window["pool_blocks_in_use"] = eng.pool.blocks_in_use
            window["pool_blocks_free"] = eng.pool.blocks_free
            if eng.prefix:
                window["prefix_hit_rate"] = round(
                    stats.prefix_hits / max(stats.prefix_lookups, 1), 4)
                window["prefill_tokens_saved_frac"] = round(
                    stats.prefill_tokens_saved / max(stats.prefill_tokens_total, 1), 4)
                window["pool_blocks_warm"] = eng.pool.blocks_warm
                window["warm_bytes"] = eng.pool.blocks_warm * self._per_block
        if eng.spec:
            window["accepted_tokens_per_step"] = round(
                self._win_spec_emitted / max(self._win_spec_steps, 1), 4)
            window["acceptance_rate"] = round(stats.spec_accepted / max(stats.spec_drafted, 1), 4)
        log_json(window)
        self._win_tokens, self._win_t0, self._win_occ = 0, now, 0.0
        self._win_prefill, self._win_decode = 0.0, 0.0
        self._win_arrivals, self._win_done = 0, 0
        self._win_spec_steps, self._win_spec_emitted = 0, 0

    # ---------------------------------------------------------- closing
    def finalize(self) -> ServeStats:
        """Close the books: TTFT decomposition, goodput, the serve_summary
        event; sets ``engine.last_stats``."""
        if self._finalized:
            return self.stats
        self._finalized = True
        eng, stats = self.eng, self.stats
        stats.ttft_s = [t for t in self.ttft if t is not None]
        for rid, t in enumerate(self.ttft):
            if t is None:
                continue
            t_admit = self.admit_t[rid] if self.admit_t[rid] is not None else self.submit_t[rid]
            stats.queue_wait_s.append(t_admit - self.submit_t[rid])
            stats.prefill_share_s.append(self.prefill_dt[rid])
        stats.slot_occupancy = (
            stats.slot_occupancy / stats.decode_steps if stats.decode_steps else 0.0
        )
        stats.goodput = compute_goodput(
            self.ttft, [len(o) for o in self.outputs],
            wall_s=time.perf_counter() - self.t_open,
            ttft_slo_ms=eng.serve.ttft_slo_ms, n_chips=self.n_chips,
        )
        stats.bytes_per_live_token = (
            sum(self._bpt_samples) / len(self._bpt_samples) if self._bpt_samples else 0.0
        )
        p50, p95 = stats.ttft_percentiles()
        summary = {
            "event": "serve_summary",
            "sequences": stats.sequences,
            "decode_steps": stats.decode_steps,
            "decode_tokens": stats.decode_tokens,
            "decode_tokens_per_sec": round(stats.tokens_per_sec(), 1),
            "decode_tokens_per_sec_chip": round(stats.tokens_per_sec() / self.n_chips, 1),
            "ttft_p50_ms": round(p50 * 1e3, 1),
            "ttft_p95_ms": round(p95 * 1e3, 1),
            "queue_delay_p50_ms": 0.0,
            "queue_delay_p95_ms": 0.0,
            "queue_delay_p99_ms": 0.0,
            **stats.ttft_decomposition(),
            **stats.goodput,
            "slot_occupancy": round(stats.slot_occupancy, 4),
            "prefill_seconds": round(stats.prefill_seconds, 3),
            "slots": eng.S,
            "chips": self.n_chips,
            "kv_cache_dtype": eng.serve.kv_cache_dtype,
            "paged_kv": eng.paged,
            "prefill_buckets": list(eng.buckets),
            "cache_bytes_resident": stats.cache_bytes_resident,
            "peak_cache_bytes_in_use": stats.peak_cache_bytes_in_use,
            "cache_bytes_per_token": round(stats.bytes_per_live_token, 1),
        }
        if eng.paged:
            summary["pool_blocks"] = eng.pool.num_blocks
            summary["kv_block_size"] = eng.block_size
            summary["admit_deferrals"] = stats.admit_deferrals
            if eng.prefix:
                summary.update(
                    prefix_cache=True,
                    prefix_cache_budget_gib=eng.serve.prefix_cache_budget_gib,
                    prefix_lookups=stats.prefix_lookups,
                    prefix_hits=stats.prefix_hits,
                    prefix_hit_rate=round(stats.prefix_hits / max(stats.prefix_lookups, 1), 4),
                    prefill_tokens_total=stats.prefill_tokens_total,
                    prefill_tokens_saved=stats.prefill_tokens_saved,
                    prefill_tokens_saved_frac=round(
                        stats.prefill_tokens_saved / max(stats.prefill_tokens_total, 1), 4),
                    pool_blocks_warm=eng.pool.blocks_warm,
                    warm_bytes=eng.pool.blocks_warm * self._per_block,
                )
        if eng.spec:
            summary.update(
                spec_decode=True,
                spec_tokens=eng.spec,
                spec_draft_model=eng.serve.spec_draft_model or "ngram",
                spec_steps=stats.spec_steps,
                spec_drafted_tokens=stats.spec_drafted,
                spec_accepted_tokens=stats.spec_accepted,
                accepted_tokens_per_step=round(
                    stats.spec_emitted / max(stats.spec_slot_rounds, 1), 4),
                acceptance_rate=round(stats.spec_accepted / max(stats.spec_drafted, 1), 4),
            )
        acct = self._memory_account()
        summary["memory_account"] = acct
        summary["hbm_headroom_gib"] = acct["hbm_headroom_gib"]
        if eng.device.type == "cuda":
            # the allocator's live peak on the card; the static account
            # above is what the CPU run reports
            summary["peak_hbm_bytes"] = torch.cuda.max_memory_allocated(eng.device)
        log_json(summary)
        eng.last_stats = stats
        return stats


def trim_eos(ids: Sequence[int], eos: int, pad: int) -> list[int]:
    """Generated ids up to and including the first EOS, pads stripped."""
    out: list[int] = []
    for t in ids:
        t = int(t)
        if t == pad:
            continue
        out.append(t)
        if t == eos:
            break
    return out
