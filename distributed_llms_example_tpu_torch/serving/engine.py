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
events carry the JAX engine's keys.  Prefix caching, speculative decode
and the int8 KV cache are later slices and raise ``NotImplementedError``
(ROADMAP.md).
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

from distributed_llms_example_tpu_torch.core.precision import resolve_device
from distributed_llms_example_tpu_torch.evaluation.generation import (
    causal_prefill,
    init_cache,
    init_causal_cache,
)
from distributed_llms_example_tpu_torch.obs.memprof import serving_account
from distributed_llms_example_tpu_torch.ops.flash_attention import auto_block
from distributed_llms_example_tpu_torch.ops.mha import PagedKVCache
from distributed_llms_example_tpu_torch.serving import cache_pool
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
    buckets).  The JAX engine's other knobs (prefix caching, speculative
    decode, int8 KV, the OOM postmortem) are fields here so the CLI keeps
    its flags, and raise when set: they are later slices."""

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
        later = {
            "kv_cache_dtype='int8'": self.kv_cache_dtype == "int8",
            "prefix_cache": self.prefix_cache,
            "prefix_cache_budget_gib": bool(self.prefix_cache_budget_gib),
            "spec_tokens": bool(self.spec_tokens),
            "spec_draft_model": bool(self.spec_draft_model),
            "postmortem_dir": bool(self.postmortem_dir),
        }
        asked = [k for k, on in later.items() if on]
        if asked:
            raise NotImplementedError(
                f"{', '.join(asked)}: not ported yet — a later slice of the "
                "PyTorch port (ROADMAP.md)"
            )


@dataclasses.dataclass
class ServeStats:
    """Filled by a serving session — the bench/obs read surface."""

    sequences: int = 0
    decode_steps: int = 0
    decode_tokens: int = 0
    decode_seconds: float = 0.0
    prefill_seconds: float = 0.0
    prefill_calls: int = 0  # admission chunks prefilled
    admit_deferrals: int = 0  # paged: admissions deferred on a short free list
    slot_occupancy: float = 0.0
    cache_bytes_resident: int = 0
    peak_cache_bytes_in_use: int = 0
    bytes_per_live_token: float = 0.0
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
    ``device``; ``device`` is CUDA unless ``"cpu"`` is asked for."""

    def __init__(self, model: Any, config: Any, serve: ServeConfig | None = None, *,
                 is_seq2seq: bool = True, device: str | torch.device | None = None):
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
        self._warmed = False
        self.last_stats: ServeStats | None = None

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
        cache, full_mask, lengths, first = causal_prefill(self.model, ids, mask, self.L)
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
        r = torch.as_tensor(rows, device=self.device)
        s = torch.as_tensor(slot_idx[rows].astype(np.int64), device=self.device)
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
            cache_pool.scatter_admit(state["pool"], [(c.k, c.v) for c in cache],
                                     admit_blocks, self.block_size)
        rows = np.nonzero(slot_idx < self.S)[0]
        if rows.size == 0:
            return
        r = torch.as_tensor(rows, device=self.device)
        s = torch.as_tensor(slot_idx[rows].astype(np.int64), device=self.device)
        if not self.paged:
            for dst, src in zip(state["cache"], cache):
                dst.k[s] = self._pad_axis(src.k, 2, width)[r]
                dst.v[s] = self._pad_axis(src.v, 2, width)[r]
        state["mask"][s] = self._pad_axis(full_mask, 1, width)[r]
        state["last"][s] = first[r]

    @torch.inference_mode()
    def _step(self, state: dict, offsets: np.ndarray, active: np.ndarray) -> torch.Tensor:
        # idle slots park at L: their cache writes drop and their tokens are
        # masked to pad below
        offs_h = np.where(active, offsets, self.L).astype(np.int32)
        offs = torch.as_tensor(offs_h, device=self.device)
        act = torch.as_tensor(active, device=self.device)
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
        S, dev = self.S, self.device
        width = state["mask"].shape[1]
        offs_h = np.where(active, write_pos, width).astype(np.int32)
        live = np.nonzero(offs_h < width)[0]
        state["mask"][torch.as_tensor(live, device=dev),
                      torch.as_tensor(offs_h[live].astype(np.int64), device=dev)] = 1
        offs = torch.as_tensor(offs_h, device=dev)
        if self.paged:
            bt = torch.as_tensor(block_tables, device=dev)
            plan = cache_pool.step_write_plan(block_tables, offs_h, num_blocks=self.pool.num_blocks,
                                              block_size=self.block_size, device=dev)
            cache = [PagedKVCache(k, v, bt, plan) for k, v in state["pool"]]
        else:
            cache = state["cache"]
        logits = self.model(
            state["last"][:, None], state["mask"],
            positions=torch.as_tensor(rope_pos.astype(np.int64), device=dev)[:, None],
            cache=cache, cache_positions=offs,
        )
        nxt = logits[:, -1].argmax(dim=-1).to(torch.int32)
        nxt = torch.where(torch.as_tensor(active, device=dev), nxt, self.pad).to(torch.int32)
        state["last"] = nxt
        return nxt

    # ------------------------------------------------------------- state
    def _init_state(self) -> dict:
        S, W, L = self.S, self.W, self.L
        cfg, dt, dev = self.config, self.model.dtype, self.device
        if not self.is_seq2seq:
            state = {
                "mask": torch.zeros((S, W + L), dtype=torch.int32, device=dev),
                "last": torch.full((S,), self.pad, dtype=torch.int32, device=dev),
            }
            if self.paged:
                # one slot's worth of shapes is enough to size the pool
                one = init_causal_cache(self.model, 1, 1, device=dev)
                state["pool"] = cache_pool.pool_cache_tree(
                    [(c.k, c.v) for c in one], self.pool.num_blocks, self.block_size)
            else:
                state["cache"] = init_causal_cache(self.model, S, W + L, device=dev)
            return state
        # the cross-K/V slots take each decoder layer's own cross-attention
        # shape, so any seq2seq family (BART, T5) sizes its state alike
        ckv = []
        for blk in self.model.decoder_blocks:
            shape = (S, blk.cross_attn.kv_heads, W, blk.cross_attn.head_dim)
            ckv.append((torch.zeros(shape, dtype=dt, device=dev),
                        torch.zeros(shape, dtype=dt, device=dev)))
        return {
            "cache": init_cache(self.model, S, L, device=dev),
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
        kernel; a causal decode runs the paged or the flat decode kernel.
        Nothing to do on the CPU."""
        if self._warmed:
            return
        if self.device.type == "cuda":
            from distributed_llms_example_tpu_torch.ops import cuda_build

            cuda_build.build(["flash_fwd", "flash_decode"] if self.is_seq2seq
                             else ["flash_decode_paged"] if self.paged else ["flash_decode"])
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
        # (sentinel = num_blocks: reads see nothing, writes drop)
        self.slot_blocks: list[list[int]] = [[] for _ in range(S)]
        self.slot_bt = (np.full((S, eng.n_tiles), eng.pool.num_blocks, np.int32)
                        if eng.paged else None)
        eng.warm()
        self.state = eng._init_state()
        self.t_open = time.perf_counter()
        self.stats.cache_bytes_resident, self._per_block = eng._state_byte_account(self.state)
        self.params_bytes = sum(p.numel() * p.element_size() for p in eng.model.parameters())
        self._bpt_samples: list[float] = []
        self._win_tokens, self._win_occ = 0, 0.0
        self._win_t0 = time.perf_counter()
        self._win_prefill, self._win_decode = 0.0, 0.0
        self._win_arrivals, self._win_done = 0, 0
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
        """Free the slot now and, paged, return every block it held."""
        self.active[slot] = False
        self.slot_req[slot] = -1
        self._win_done += 1
        if self.eng.paged and self.slot_blocks[slot]:
            self.eng.pool.free(self.slot_blocks[slot])
            self.slot_blocks[slot] = []
            self.slot_bt[slot, :] = self.eng.pool.num_blocks

    def _emit(self, slot: int, tok: int, now: float, finished: list) -> None:
        """Append one generated token to the slot's request; evict on eos
        or an exhausted budget."""
        rid = int(self.slot_req[slot])
        self.outputs[rid].append(tok)
        if self.ttft[rid] is None:
            self.ttft[rid] = now - self.submit_t[rid]
        self.emitted[slot] += 1
        if tok == self.eng.eos or self.emitted[slot] >= self.budgets[rid]:
            self._evict_slot(slot)
            self._finish_request(rid, slot, now)
            finished.append(rid)

    def _admit_now(self, finished: list) -> None:
        eng = self.eng
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
        ids = np.full((C, bucket), eng.pad, np.int64)
        mask = np.zeros((C, bucket), np.int32)
        for r, rid in enumerate(reqs):
            toks = self.requests[rid][:bucket]
            ids[r, : len(toks)] = toks
            mask[r, : len(toks)] = 1
        slot_idx = np.full(C, S, np.int64)  # padding rows drop
        slot_idx[:n] = free[:n]
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
                slot = free[r]
                self.slot_blocks[slot] = blocks
                row = cache_pool.build_block_row(
                    eng.n_tiles, blocks, prompt_len=plen(rid), bucket_width=bucket,
                    budget=self.budgets[rid], block_size=eng.block_size,
                    sentinel=eng.pool.num_blocks)
                self.slot_bt[slot, :] = row
                admit_rows[r, :] = row[:ntc]
        t0 = time.perf_counter()
        pre = eng._prefill(
            torch.as_tensor(ids, device=eng.device), torch.as_tensor(mask, device=eng.device)
        )
        if eng.is_seq2seq:
            enc, pmask, ckv = pre
            eng._admit(self.state, enc, pmask, ckv, slot_idx)
            if eng.device.type == "cuda":
                torch.cuda.synchronize(eng.device)  # the prefill's time is its device time
        else:
            cache, full_mask, plens, first = pre
            eng._admit_causal(self.state, cache, full_mask, first, slot_idx,
                              None if admit_rows is None else admit_rows.reshape(-1))
            plens_h, first_h = plens.cpu().numpy(), first.cpu().numpy()
            del cache, pre
        dt = time.perf_counter() - t0
        self.stats.prefill_seconds += dt
        self.stats.prefill_calls += 1
        self._win_prefill += dt
        now = time.perf_counter()
        for r, rid in enumerate(reqs):
            slot = free[r]
            self.slot_req[slot] = rid
            self.emitted[slot] = 0
            self.lengths[slot] = plen(rid)
            self.base[slot] = bucket
            self.active[slot] = True
            self.admit_t[rid] = t0
            self.prefill_dt[rid] = dt
            if not eng.is_seq2seq:
                # the causal prefill already produced token #1
                self.lengths[slot] = int(plens_h[r])
                self._emit(slot, int(first_h[r]), now, finished)
        self.stats.peak_cache_bytes_in_use = max(
            self.stats.peak_cache_bytes_in_use, self._bytes_in_use()
        )

    def _memory_account(self) -> dict:
        return serving_account(
            params_bytes=self.params_bytes, kv_cache_bytes=self._bytes_in_use(),
            hbm_budget_gib=self.eng.serve.hbm_budget_gib,
        )

    def step(self) -> list[int]:
        """One scheduler round: admit into free slots, then one decode step
        if any slot is live.  Returns the rids that finished (at prefill
        included)."""
        if self._finalized:
            raise RuntimeError("session already finalized")
        eng = self.eng
        finished: list[int] = []
        self._admit_now(finished)
        if not self.active.any():
            return finished
        t0 = time.perf_counter()
        if eng.is_seq2seq:
            tokens = eng._step(self.state, self.emitted.astype(np.int32), self.active.copy())
        else:
            tokens = eng._step_causal(self.state, self.base + self.emitted - 1,
                                      self.lengths + self.emitted - 1, self.active.copy(),
                                      self.slot_bt)
        toks = tokens.cpu().numpy()
        dt = time.perf_counter() - t0
        self.stats.decode_seconds += dt
        self.stats.decode_steps += 1
        self._win_decode += dt
        n_active = int(self.active.sum())
        self.stats.slot_occupancy += n_active / eng.S
        self._win_occ += n_active / eng.S
        self._bpt_samples.append(self._bytes_in_use() / max(self._live_tokens(), 1))
        now = time.perf_counter()
        for slot in np.nonzero(self.active)[0]:
            self._emit(slot, int(toks[slot]), now, finished)
        self.stats.decode_tokens += n_active
        self._win_tokens += n_active
        every = eng.serve.log_every_steps
        if every and self.stats.decode_steps % every == 0:
            self._log_window(now, every)
        return finished

    def _log_window(self, now: float, every: int) -> None:
        w_dt = max(now - self._win_t0, 1e-9)
        window = {
            "event": "serve_window",
            "step": self.stats.decode_steps,
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
        if self.eng.paged:
            window["pool_blocks_in_use"] = self.eng.pool.blocks_in_use
            window["pool_blocks_free"] = self.eng.pool.blocks_free
        log_json(window)
        self._win_tokens, self._win_t0, self._win_occ = 0, now, 0.0
        self._win_prefill, self._win_decode = 0.0, 0.0
        self._win_arrivals, self._win_done = 0, 0

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
