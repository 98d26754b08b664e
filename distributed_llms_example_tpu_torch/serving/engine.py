"""Continuous-batching serving engine (port of the JAX package's
``serving/engine.py``, seq2seq adapter).

A fixed set of ``max_slots`` decode slots, each holding one in-flight
sequence at its own offset; finished sequences are evicted and new ones
admitted between per-token steps.  Per model, three steps:

- **prefill** (once per admitted chunk): the encoder + the once-per-
  sequence cross-attention K/V projection;
- **admit**: chunk rows land in their slots; rows beyond the chunk park at
  an out-of-range slot index and are dropped.  Slot caches are not zeroed
  on reuse: every read is masked to ``k_pos <= offset``, so a previous
  occupant's K/V is unreachable;
- **decode step** (every token): one token per slot at per-slot offsets
  (per-row cache writes), idle slots parked at offset L so their writes
  drop.

The slot state lives on the device and is updated in place (the JAX
package donates it to the compiled step for the same effect).  Greedy
only.  The ``serve_window`` / ``serve_request`` / ``serve_summary`` JSON
events carry the JAX engine's keys.  Paged KV, prefix caching,
speculative decode, the int8 KV cache and causal (LLaMA) models are later
slices and raise ``NotImplementedError`` (ROADMAP.md).
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Any, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from distributed_llms_example_tpu_torch.core.precision import resolve_device
from distributed_llms_example_tpu_torch.evaluation.generation import init_cache
from distributed_llms_example_tpu_torch.utils.jsonlog import log_json

GIB = 1024**3
MEMORY_BUCKETS = ("params", "optimizer_state", "grad_accum", "activations", "kv_cache", "other")


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
    (an H100 has 80).  The JAX engine's other knobs (paged KV and its pool
    shape, prefix caching, speculative decode, int8 KV, the OOM postmortem)
    are fields here so the CLI keeps its flags, and raise when set: they
    are later slices."""

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
            "paged_kv": self.paged_kv,
            "pool_blocks": bool(self.pool_blocks),
            "kv_block_size": bool(self.kv_block_size),
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


def serving_account(*, params_bytes: int, kv_cache_bytes: int, hbm_budget_gib: float) -> dict:
    """The serving memory account over the JAX package's bucket taxonomy."""
    buckets = {b: 0 for b in MEMORY_BUCKETS}
    buckets["params"] = int(params_bytes)
    buckets["kv_cache"] = int(kv_cache_bytes)
    total = sum(buckets.values())
    budget_bytes = int(float(hbm_budget_gib) * GIB)
    return {
        "buckets_bytes": buckets,
        "bucket_total_bytes": total,
        "peak_bytes": total,
        "peak_gib": round(total / GIB, 3),
        "hbm_budget_gib": float(hbm_budget_gib),
        "hbm_budget_bytes": budget_bytes,
        "peak_frac_of_budget": round(total / budget_bytes, 4) if budget_bytes else None,
        "hbm_headroom_gib": round((budget_bytes - total) / GIB, 3),
        "fits_budget": total < budget_bytes,
    }


def _tree_bytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, dict):
        return sum(_tree_bytes(v) for v in x.values())
    if isinstance(x, (list, tuple)):
        return sum(_tree_bytes(v) for v in x)
    if dataclasses.is_dataclass(x):
        return sum(_tree_bytes(getattr(x, f.name)) for f in dataclasses.fields(x))
    return 0


class ServingEngine:
    """Greedy continuous-batching decode over a fixed slot set.

    ``model`` is a seq2seq module (``models/bart.py``) already on
    ``device``; ``device`` is CUDA unless ``"cpu"`` is asked for."""

    def __init__(self, model: Any, config: Any, serve: ServeConfig | None = None, *,
                 is_seq2seq: bool = True, device: str | torch.device | None = None):
        self.device = resolve_device(device)
        if not is_seq2seq:
            raise NotImplementedError(
                "causal (LLaMA-family) serving is a later slice of the PyTorch port (ROADMAP.md)"
            )
        model_dev = next(model.parameters()).device
        if model_dev.type != self.device.type:
            raise ValueError(f"model is on {model_dev}, engine device is {self.device}")
        self.model, self.config = model, config
        self.serve = serve or ServeConfig()
        self.eos = config.eos_token_id
        self.pad = config.pad_token_id
        self.start = config.decoder_start_token_id
        self.forced_bos = config.forced_bos_token_id
        self.forced_eos = config.forced_eos_token_id
        self.L = self.serve.max_new_tokens
        self.S = self.serve.max_slots
        self.W = self.serve.max_source_length
        self.prefill_batch = self.serve.prefill_batch or self.S
        if not 1 <= self.prefill_batch <= self.S:
            raise ValueError(f"prefill_batch {self.prefill_batch} must be in [1, max_slots={self.S}]")
        self.buckets = tuple(
            sorted({int(b) for b in self.serve.prefill_buckets if 0 < int(b) < self.W})
        ) + (self.W,)
        self._warmed = False
        self.last_stats: ServeStats | None = None

    # ------------------------------------------------------------- steps
    @torch.inference_mode()
    def _prefill(self, ids: torch.Tensor, mask: torch.Tensor):
        enc = self.model.encode(ids, mask)
        return enc, mask, self.model.cross_kv(enc)

    def _pad_axis(self, x: torch.Tensor, axis: int) -> torch.Tensor:
        """Right-pad one axis to the slot width with zeros: a bucket-width
        chunk's padding stays mask-invisible (enc_mask is 0 there)."""
        extra = self.W - x.shape[axis]
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

    # ------------------------------------------------------------- state
    def _init_state(self) -> dict:
        S, W, L = self.S, self.W, self.L
        cfg, dt, dev = self.config, self.model.dtype, self.device
        heads = cfg.decoder_attention_heads
        hd = cfg.d_model // heads
        return {
            "cache": init_cache(self.model, S, L, device=dev),
            "enc": torch.zeros((S, W, cfg.d_model), dtype=dt, device=dev),
            "enc_mask": torch.zeros((S, W), dtype=torch.int32, device=dev),
            "ckv": [
                (torch.zeros((S, heads, W, hd), dtype=dt, device=dev),
                 torch.zeros((S, heads, W, hd), dtype=dt, device=dev))
                for _ in range(cfg.decoder_layers)
            ],
            "last": torch.full((S, 1), self.pad, dtype=torch.int32, device=dev),
        }

    def _state_byte_account(self, state: dict) -> int:
        """Resident bytes of the serving K/V state (cache + enc + cross-KV)."""
        return sum(_tree_bytes(state[k]) for k in ("cache", "enc", "ckv"))

    def warm(self) -> None:
        """Build the CUDA kernels before the first request, so no request
        pays a kernel build (the JAX package AOT-compiles its programs
        here).  Nothing to do on the CPU."""
        if self._warmed:
            return
        if self.device.type == "cuda":
            from distributed_llms_example_tpu_torch.ops import cuda_build

            cuda_build.build(["flash_fwd", "flash_decode"])
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
        self.lengths = np.zeros(S, np.int64)
        self.active = np.zeros(S, bool)
        eng.warm()
        self.state = eng._init_state()
        self.t_open = time.perf_counter()
        self.stats.cache_bytes_resident = eng._state_byte_account(self.state)
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
        self.active[slot] = False
        self.slot_req[slot] = -1
        self._win_done += 1

    def _admit_now(self) -> None:
        eng = self.eng
        S, W, C = eng.S, eng.W, eng.prefill_batch
        free = [i for i in range(S) if not self.active[i]]
        n = min(len(free), C, len(self.pending))
        if n == 0:
            return
        reqs = [self.pending.popleft() for _ in range(n)]
        plen = lambda rid: min(len(self.requests[rid]), W)  # noqa: E731
        bucket = next(b for b in eng.buckets if b >= max(plen(rid) for rid in reqs))
        ids = np.full((C, bucket), eng.pad, np.int64)
        mask = np.zeros((C, bucket), np.int32)
        for r, rid in enumerate(reqs):
            toks = self.requests[rid][:bucket]
            ids[r, : len(toks)] = toks
            mask[r, : len(toks)] = 1
        slot_idx = np.full(C, S, np.int64)  # padding rows drop
        slot_idx[:n] = free[:n]
        t0 = time.perf_counter()
        enc, pmask, ckv = eng._prefill(
            torch.as_tensor(ids, device=eng.device), torch.as_tensor(mask, device=eng.device)
        )
        eng._admit(self.state, enc, pmask, ckv, slot_idx)
        if eng.device.type == "cuda":
            torch.cuda.synchronize(eng.device)  # the prefill's time is its device time
        dt = time.perf_counter() - t0
        self.stats.prefill_seconds += dt
        self.stats.prefill_calls += 1
        self._win_prefill += dt
        for r, rid in enumerate(reqs):
            slot = free[r]
            self.slot_req[slot] = rid
            self.emitted[slot] = 0
            self.lengths[slot] = plen(rid)
            self.active[slot] = True
            self.admit_t[rid] = t0
            self.prefill_dt[rid] = dt
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
        if any slot is live.  Returns the rids that finished."""
        if self._finalized:
            raise RuntimeError("session already finalized")
        eng = self.eng
        finished: list[int] = []
        self._admit_now()
        if not self.active.any():
            return finished
        t0 = time.perf_counter()
        tokens = eng._step(self.state, self.emitted.astype(np.int32), self.active.copy())
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
            rid = int(self.slot_req[slot])
            tok = int(toks[slot])
            self.outputs[rid].append(tok)
            if self.ttft[rid] is None:
                self.ttft[rid] = now - self.submit_t[rid]
            self.emitted[slot] += 1
            if tok == eng.eos or self.emitted[slot] >= self.budgets[rid]:
                self._evict_slot(slot)
                self._finish_request(rid, slot, now)
                finished.append(rid)
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
            "paged_kv": False,
            "prefill_buckets": list(eng.buckets),
            "cache_bytes_resident": stats.cache_bytes_resident,
            "peak_cache_bytes_in_use": stats.peak_cache_bytes_in_use,
            "cache_bytes_per_token": round(stats.bytes_per_live_token, 1),
        }
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
