"""Open-loop load generation: seeded arrival schedules, QPS sweeps, the
saturation knee (port of the JAX package's ``serving/loadgen.py``; numpy
and host code only).

A closed-loop run (submit a batch, step until drained) offers at most
the service rate, so it never shows queueing collapse.  This module
drives the open loop:

- **arrival schedules** (``arrival_schedule``): seeded float64 offset
  arrays for ``poisson`` (exponential gaps at the offered rate),
  ``bursty`` (Poisson bursts of ``burst_size`` arrivals, the same mean
  rate) and ``ramp`` (the rate climbing linearly from
  ``ramp_start_frac`` x rate to rate); the same seed and config give the
  same schedule bit for bit, and no wall clock enters it;
- **the open loop** (``drive_open_loop``): submits each request when its
  arrival passes, never waiting for completions, and otherwise steps the
  target; the clock is injectable (``VirtualClock`` in tests);
- **targets**: ``EngineTarget`` (a ``ServeSession``) and ``RouterTarget``
  (a ``ReplicaRouter``, so the sweep composes with replica chaos);
- **the sweep** (``sweep_qps``): a fresh target a point of the
  offered-QPS grid, the same requests and arrival seed throughout; the
  knee (``detect_knee``) is the first offered rate whose throughput
  stops tracking the offer, that sheds, or whose queue grows
  (``queue_growing``).

TTFT is measured from the scheduled arrival.  Events: one
``loadgen_point`` a grid point and a final ``loadgen_summary`` (the curve
and the knee), which ``obs/report.py``'s load-sweep section and its
``--min-slo-attainment`` / ``--max-p99-ttft-ms`` gates read.  Greedy
decode does not depend on the schedule, so every point's tokens equal
the closed-loop run's: arrival timing moves latency, not tokens.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Sequence

import numpy as np

from distributed_llms_example_tpu_torch.obs.spans import percentiles
from distributed_llms_example_tpu_torch.utils.jsonlog import log_json

ARRIVAL_PROCESSES = ("poisson", "bursty", "ramp")

WORKLOADS = ("random", "chatbot")


def chatbot_requests(
    *,
    sessions: int,
    turns: int,
    seed: int = 0,
    vocab: int = 120,
    system_len: int = 12,
    user_len: tuple[int, int] = (2, 6),
    reply_len: tuple[int, int] = (2, 6),
    shared_frac: float = 0.9,
    max_len: int = 0,
    with_budgets: bool = False,
) -> tuple:
    """The shared-prefix chat mix: (requests, session_keys) in arrival
    order — the workload the prefix cache exists for.

    ``sessions`` conversations × ``turns`` turns each, interleaved
    turn-major (every session's turn 1, then every session's turn 2, …)
    so follow-up turns arrive with OTHER traffic in between — warm
    retention, not just same-wave sharing, is what makes them hit.
    ``shared_frac`` of the sessions open with one COMMON system prompt
    (``system_len`` tokens); the rest draw private system prompts (the
    minority custom-prompt traffic).  Each turn appends a seeded user
    message to the session's history, the prompt is the WHOLE history so
    far (the chat API shape: clients re-send everything), and a seeded
    synthetic assistant reply is appended after — so turn t+1's prompt
    extends turn t's prompt exactly, and every session chain shares the
    system-prompt root.  ``max_len`` (0 = off) right-truncates prompts,
    matching the engine's own ``max_source_length`` truncation.

    Pure function of its arguments (one ``RandomState(seed)`` drives
    every draw in a fixed order): same seed + config → bit-identical
    requests AND keys, the same replay contract as
    ``arrival_schedule``.  ``session_keys`` feed the router's session
    affinity so a conversation's turns land on the replica whose pool
    holds its blocks.

    ``with_budgets=True`` returns ``(requests, session_keys,
    decode_budgets)`` instead, where each budget is the length of the
    turn's synthetic assistant reply — the number of tokens the engine
    would decode to reproduce the scripted conversation.  The budgets
    come from the SAME ``reply_len`` draws that extend the histories
    (no extra rng consumption), so the 2-tuple and 3-tuple forms of one
    seed describe the identical conversation; spec-decode A/B runs use
    them as per-request ``max_new_tokens`` so both legs decode the same
    token counts."""
    if sessions < 1 or turns < 1:
        raise ValueError("sessions and turns must be >= 1")
    if not 0.0 <= shared_frac <= 1.0:
        raise ValueError("shared_frac must be in [0, 1]")
    rng = np.random.RandomState(seed)
    draw = lambda k: rng.randint(4, vocab, int(k)).tolist()  # noqa: E731
    span = lambda lo_hi: rng.randint(lo_hi[0], lo_hi[1] + 1)  # noqa: E731
    shared_system = draw(system_len)
    n_shared = int(round(shared_frac * sessions))
    hist = [
        list(shared_system) if s < n_shared else draw(system_len)
        for s in range(sessions)
    ]
    reqs: list[list[int]] = []
    keys: list[str] = []
    budgets: list[int] = []
    for _t in range(turns):
        for s in range(sessions):
            hist[s] = hist[s] + draw(span(user_len))
            prompt = hist[s][:max_len] if max_len else list(hist[s])
            reqs.append(prompt)
            keys.append(f"session-{s}")
            reply = draw(span(reply_len))
            budgets.append(len(reply))
            hist[s] = hist[s] + reply
    if with_budgets:
        return reqs, keys, budgets
    return reqs, keys


@dataclasses.dataclass(frozen=True)
class LoadgenConfig:
    """Sweep knobs.  Everything the arrival schedule depends on lives
    here, which is why same-config-same-seed runs replay bit-for-bit.

    ``process``: arrival process kind (``ARRIVAL_PROCESSES``).
    ``seed``: the schedule RNG seed.  ``burst_size``: arrivals per
    burst (bursty only).  ``ramp_start_frac``: the ramp's starting
    rate as a fraction of the point's offered rate (ramp only).
    ``qps_grid``: ascending offered-QPS points to sweep.
    ``ttft_slo_ms``: the first-token SLO attainment/goodput are judged
    against (from ARRIVAL, not submit).  ``max_wall_s``: per-point
    wall cap (0 = none) — a point far past saturation stops here and
    reports its unfinished tail instead of running unboundedly.
    ``track_tol``: knee sensitivity — a point whose achieved QPS falls
    below ``track_tol × offered`` has stopped tracking the offer."""

    process: str = "poisson"
    seed: int = 0
    burst_size: int = 4
    ramp_start_frac: float = 0.25
    qps_grid: tuple = (1.0, 2.0, 4.0, 8.0)
    ttft_slo_ms: float = 500.0
    max_wall_s: float = 0.0
    track_tol: float = 0.9

    def __post_init__(self):
        if self.process not in ARRIVAL_PROCESSES:
            raise ValueError(
                f"process={self.process!r}: must be one of {ARRIVAL_PROCESSES}"
            )
        if self.burst_size < 1:
            raise ValueError("burst_size must be >= 1")
        if not 0.0 < self.ramp_start_frac <= 1.0:
            raise ValueError("ramp_start_frac must be in (0, 1]")
        if not self.qps_grid:
            raise ValueError("qps_grid must name at least one offered rate")
        grid = tuple(float(q) for q in self.qps_grid)
        if any(q <= 0 for q in grid):
            raise ValueError("qps_grid rates must be positive")
        if list(grid) != sorted(grid):
            raise ValueError("qps_grid must ascend (the knee is a first-X)")


def arrival_schedule(
    process: str,
    *,
    qps: float,
    n: int,
    seed: int,
    burst_size: int = 4,
    ramp_start_frac: float = 0.25,
) -> np.ndarray:
    """Deterministic arrival offsets (seconds from run start, ascending
    float64, length ``n``) at average offered rate ``qps``.  Pure
    function of its arguments — the determinism acceptance pin is
    ``arrival_schedule(...) == arrival_schedule(...)`` bit-for-bit."""
    if n <= 0:
        raise ValueError("n must be positive")
    if qps <= 0:
        raise ValueError("qps must be positive")
    rng = np.random.RandomState(seed)
    if process == "poisson":
        gaps = rng.exponential(1.0 / qps, size=n)
        return np.cumsum(gaps)
    if process == "bursty":
        k = int(burst_size)
        n_bursts = (n + k - 1) // k
        # burst instants are themselves Poisson at qps/k, so the
        # AVERAGE rate stays the offered qps — the process only moves
        # variance (every burst lands k arrivals on one instant)
        starts = np.cumsum(rng.exponential(k / qps, size=n_bursts))
        return np.repeat(starts, k)[:n].astype(np.float64)
    if process == "ramp":
        u = rng.exponential(1.0, size=n)
        frac = np.arange(n, dtype=np.float64) / max(n - 1, 1)
        rates = qps * (ramp_start_frac + (1.0 - ramp_start_frac) * frac)
        return np.cumsum(u / rates)
    raise ValueError(
        f"process={process!r}: must be one of {ARRIVAL_PROCESSES}"
    )


class VirtualClock:
    """The test clock: ``now()`` in seconds, advanced explicitly.  A
    deterministic fake session advances it from ``step()`` (one step =
    its modeled service time) and stamps its timestamps from it, so a
    whole open-loop run — schedule, queueing, verdicts — replays
    bit-for-bit with no wall clock anywhere."""

    def __init__(self, t: float = 0.0):
        self.t = float(t)

    def now(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        if dt < 0:
            raise ValueError("the clock only runs forward")
        self.t += dt


class EngineTarget:
    """The open loop's surface over a ``ServeSession`` (or any session-shaped
    fake: ``submit``/``step``/``has_work``/``submit_t``/
    ``first_token_wall``/``output``/``finalize``).  The engine never
    sheds — over-offer shows up as unfinished tail + growing delay."""

    def __init__(self, session: Any):
        self.session = session

    def submit(self, tokens, *, budget=None, mask=None, arrival=None,
               session=None) -> int:
        # a bare engine has no affinity tier: the session key is accepted
        # (drive_open_loop passes it to every target) and dropped
        del session
        return self.session.submit(
            tokens, max_new=budget, attention_mask=mask, arrival=arrival
        )

    def advance(self) -> list[int]:
        return list(self.session.step())

    def has_work(self) -> bool:
        return bool(self.session.has_work())

    def close(self) -> None:
        self.session.finalize()

    def row(self, rid: int) -> dict:
        s = self.session
        return {
            "submit": s.submit_t[rid],
            "first_tok": s.first_token_wall(rid),
            "tokens": len(s.output(rid)),
            "shed": False,
        }


class RouterTarget:
    """The open loop's surface over a ``ReplicaRouter`` — the composition point
    with replica chaos (crash/stall/storm fire at router ticks while
    the open-loop schedule keeps offering load).  Synthetic storm
    requests are injected load, not offered traffic: they never appear
    in the rows drive_open_loop returns."""

    def __init__(self, router: Any):
        self.router = router
        self._reported: set[int] = set()

    def submit(self, tokens, *, budget=None, mask=None, arrival=None,
               session=None) -> int:
        return self.router.submit(
            tokens, max_new=budget, attention_mask=mask, arrival=arrival,
            session=session,
        )

    def advance(self) -> list[int]:
        r = self.router
        if not r._serving():
            r.shed_unserved()  # run_until_drained's outage rule
        else:
            r.tick()
        fresh = [
            q.rid
            for q in r.requests
            if (q.done or q.shed)
            and not q.synthetic
            and q.rid not in self._reported
        ]
        self._reported.update(fresh)
        return fresh

    def has_work(self) -> bool:
        return self.router._outstanding()

    def close(self) -> None:
        self.router.finalize()

    def row(self, rid: int) -> dict:
        q = self.router.requests[rid]
        first = (
            q.submit_wall + q.ttft_s if q.ttft_s is not None else None
        )
        return {
            "submit": q.submit_wall,
            "first_tok": first,
            "tokens": len(q.out),
            "shed": bool(q.shed),
        }


def drive_open_loop(
    target: Any,
    requests: Sequence[Sequence[int]],
    schedule: Sequence[float],
    *,
    budgets: Sequence[int] | None = None,
    masks: Sequence[Sequence[int] | None] | None = None,
    sessions: Sequence[Any] | None = None,
    clock: Callable[[], float] | None = None,
    wait: Callable[[float], None] | None = None,
    max_wall_s: float = 0.0,
    idle_wait_s: float = 0.0005,
) -> tuple[list[dict], float]:
    """One open-loop run: submit request ``i`` the instant
    ``schedule[i]`` passes (never waiting on completions), otherwise
    step the target; returns (per-request rows in arrival order, run
    wall seconds).  ``clock``/``wait`` default to the real
    ``time.perf_counter``/``time.sleep``; tests inject a
    ``VirtualClock``'s ``now``/``advance``.  ``max_wall_s`` (0 = none)
    caps a run past saturation — whatever hasn't finished reports as
    the unfinished tail, which is data, not an error."""
    n = len(requests)
    if len(schedule) != n:
        raise ValueError(
            f"schedule has {len(schedule)} arrivals for {n} requests"
        )
    if budgets is not None and len(budgets) != n:
        raise ValueError(f"budgets has {len(budgets)} entries for {n} requests")
    if sessions is not None and len(sessions) != n:
        raise ValueError(
            f"sessions has {len(sessions)} keys for {n} requests"
        )
    clock = clock or time.perf_counter
    wait = wait or time.sleep
    t0 = clock()
    submit_at = [t0 + float(s) for s in schedule]
    idx_of: dict[int, int] = {}
    rids: list[int | None] = [None] * n
    done_at: list[float | None] = [None] * n
    i = 0
    while True:
        now = clock()
        while i < n and submit_at[i] <= now:
            rid = target.submit(
                requests[i],
                budget=budgets[i] if budgets is not None else None,
                mask=masks[i] if masks is not None else None,
                arrival=submit_at[i],
                session=sessions[i] if sessions is not None else None,
            )
            rids[i], idx_of[rid] = rid, i
            i += 1
        if i >= n and not target.has_work():
            break
        if max_wall_s and (now - t0) > max_wall_s:
            break
        if target.has_work():
            finished = target.advance()
            t_done = clock()
            for rid in finished:
                idx = idx_of.get(rid)
                if idx is not None:
                    done_at[idx] = t_done
        else:
            wait(max(submit_at[i] - clock(), 0.0) or idle_wait_s)
    wall_s = max(clock() - t0, 1e-9)
    target.close()
    rows: list[dict] = []
    for idx in range(n):
        rid = rids[idx]
        arrival = float(schedule[idx])
        if rid is None:  # wall cap hit before this arrival was even due
            rows.append({
                "index": idx, "arrival_s": arrival, "submitted": False,
                "queue_delay_s": None, "ttft_s": None, "done_s": None,
                "tokens": 0, "finished": False, "shed": False,
            })
            continue
        info = target.row(rid)
        first = info["first_tok"]
        done = done_at[idx]
        rows.append({
            "index": idx,
            "arrival_s": arrival,
            "submitted": True,
            "queue_delay_s": info["submit"] - submit_at[idx],
            # TTFT from the scheduled ARRIVAL: the wait before the submit is
            # user-visible latency under open-loop load
            "ttft_s": (first - submit_at[idx]) if first is not None else None,
            "done_s": (done - t0) if done is not None else None,
            "tokens": int(info["tokens"]),
            "finished": done is not None and not info["shed"],
            "shed": bool(info["shed"]),
        })
    return rows, wall_s


def _wait_s(row: dict, wall_s: float) -> float:
    """A request's observed queueing wait: TTFT from arrival when it
    got a first token, else how long it has ALREADY waited by run end —
    a lower bound that keeps growing, which is what makes the
    unbounded-growth signal detectable on a capped run."""
    if row["ttft_s"] is not None:
        return float(row["ttft_s"])
    return max(wall_s - row["arrival_s"], 0.0)


def queue_growing(rows: Sequence[dict], wall_s: float, *,
                  growth_x: float = 2.0, min_wait_s: float = 5e-3) -> bool:
    """Unbounded-queue verdict for one run: an unfinished tail at run
    end, or the last-quarter arrivals waiting ``growth_x``× the
    first-quarter ones (and at least ``min_wait_s`` in absolute terms —
    noise on an idle engine is not growth).  Under a stable queue the
    wait distribution is stationary; under over-offer it grows with
    arrival index, which this detects without modeling the queue."""
    if any(not r["finished"] and not r["shed"] for r in rows):
        return True
    n = len(rows)
    if n < 4:
        return False
    k = max(n // 4, 1)
    head = sum(_wait_s(r, wall_s) for r in rows[:k]) / k
    tail = sum(_wait_s(r, wall_s) for r in rows[-k:]) / k
    return tail > growth_x * max(head, 1e-9) and tail > min_wait_s


def summarize_point(
    rows: Sequence[dict],
    *,
    offered_qps: float,
    ttft_slo_ms: float,
    wall_s: float,
    growth_x: float = 2.0,
) -> dict:
    """One sweep point's measured record.  SLO attainment is judged
    over every OFFERED request — unfinished and shed requests are
    misses, never silently dropped from the denominator — and TTFT is
    from arrival.  TTFT percentiles are ``None`` when nothing finished
    (a missing measurement must never read as a pass).

    ``offered_qps`` is the nominal grid label; ``offered_qps_realized``
    is what this finite seeded sample actually offered (n over the
    arrival span).  At small n a Poisson draw can realize well under
    the nominal rate, so throughput tracking must be judged against the
    realized rate or sampling variance reads as saturation."""
    offered = len(rows)
    completed = sum(1 for r in rows if r["finished"])
    shed = sum(1 for r in rows if r["shed"])
    unfinished = offered - completed - shed
    ttfts = [r["ttft_s"] for r in rows if r["finished"] and r["ttft_s"] is not None]
    delays = [r["queue_delay_s"] for r in rows if r["queue_delay_s"] is not None]
    slo_s = float(ttft_slo_ms) / 1e3
    met = [
        r for r in rows
        if r["finished"] and r["ttft_s"] is not None
        and (slo_s <= 0 or r["ttft_s"] <= slo_s)
    ]
    span = max((r.get("arrival_s") or 0.0 for r in rows), default=0.0)
    point = {
        "offered_qps": round(float(offered_qps), 4),
        "offered_qps_realized": round(
            offered / span if span > 0 else float(offered_qps), 4
        ),
        "achieved_qps": round(completed / wall_s, 4),
        "offered": offered,
        "completed": completed,
        "shed": shed,
        "unfinished": unfinished,
        "wall_s": round(wall_s, 4),
        "ttft_slo_ms": round(float(ttft_slo_ms), 1),
        "slo_attainment": round(len(met) / max(offered, 1), 4),
        "goodput_qps": round(len(met) / wall_s, 4),
        "queue_growing": queue_growing(rows, wall_s, growth_x=growth_x),
    }
    if ttfts:
        p50, p95, p99 = percentiles(ttfts, (0.50, 0.95, 0.99))
        point["ttft_p50_ms"] = round(p50 * 1e3, 3)
        point["ttft_p95_ms"] = round(p95 * 1e3, 3)
        point["ttft_p99_ms"] = round(p99 * 1e3, 3)
    else:
        point["ttft_p50_ms"] = None
        point["ttft_p95_ms"] = None
        point["ttft_p99_ms"] = None
    if delays:
        d50, d99 = percentiles(delays, (0.50, 0.99))
        point["queue_delay_p50_ms"] = round(d50 * 1e3, 3)
        point["queue_delay_p99_ms"] = round(d99 * 1e3, 3)
    else:
        point["queue_delay_p50_ms"] = None
        point["queue_delay_p99_ms"] = None
    return point


def detect_knee(points: Sequence[dict], *, track_tol: float = 0.9) -> float | None:
    """The saturation knee: the FIRST offered rate (grid order) whose
    point stopped tracking the offer — achieved QPS below ``track_tol ×``
    the REALIZED offered rate (the nominal grid rate when no realized
    rate was recorded), any request shed, or the unbounded-queue
    verdict.  None when every measured point tracks (the grid never
    reached saturation).  Pure function of the curve, pinnable on
    hand-built points."""
    for p in points:
        offered = float(p["offered_qps"])
        if p.get("queue_growing"):
            return offered
        if int(p.get("shed") or 0) > 0:
            return offered
        achieved = p.get("achieved_qps")
        baseline = float(p.get("offered_qps_realized") or offered)
        if achieved is not None and float(achieved) < track_tol * baseline:
            return offered
    return None


def sweep_qps(
    target_factory: Callable[[], Any],
    requests: Sequence[Sequence[int]],
    cfg: LoadgenConfig,
    *,
    budgets: Sequence[int] | None = None,
    masks: Sequence[Sequence[int] | None] | None = None,
    sessions: Sequence[Any] | None = None,
    clock: Callable[[], float] | None = None,
    wait: Callable[[float], None] | None = None,
    emit: bool = True,
) -> dict:
    """The QPS sweep: one FRESH target per grid point (``target_factory``
    returns an ``EngineTarget``/``RouterTarget`` over a fresh session/
    router), the SAME request set and the SAME arrival seed throughout,
    so points differ only by offered rate.  Emits one ``loadgen_point``
    per grid point and a final ``loadgen_summary`` carrying the whole
    curve + knee; returns the summary dict.

    When ``budgets`` is given (the chatbot mix's per-turn decode
    lengths), every ``loadgen_point`` and the summary carry
    ``decode_budget_tokens``/``decode_budget_mean`` so a later
    spec-vs-plain comparison can confirm both sweeps decoded the same
    scripted token counts — apples-to-apples, stamped in the JSONL
    rather than re-derived."""
    points: list[dict] = []
    budget_stamp: dict = {}
    if budgets is not None and len(budgets) > 0:
        budget_stamp = {
            "decode_budget_tokens": int(sum(int(b) for b in budgets)),
            "decode_budget_mean": round(
                float(sum(int(b) for b in budgets)) / len(budgets), 2
            ),
        }
    for qps in cfg.qps_grid:
        schedule = arrival_schedule(
            cfg.process, qps=float(qps), n=len(requests), seed=cfg.seed,
            burst_size=cfg.burst_size, ramp_start_frac=cfg.ramp_start_frac,
        )
        rows, wall_s = drive_open_loop(
            target_factory(), requests, schedule,
            budgets=budgets, masks=masks, sessions=sessions,
            clock=clock, wait=wait, max_wall_s=cfg.max_wall_s,
        )
        point = summarize_point(
            rows, offered_qps=float(qps), ttft_slo_ms=cfg.ttft_slo_ms,
            wall_s=wall_s,
        )
        point.update(budget_stamp)
        points.append(point)
        if emit:
            log_json({
                "event": "loadgen_point",
                "process": cfg.process,
                "seed": cfg.seed,
                **point,
            })
    knee = detect_knee(points, track_tol=cfg.track_tol)
    summary = {
        "process": cfg.process,
        "seed": cfg.seed,
        "requests_per_point": len(requests),
        "qps_grid": [float(q) for q in cfg.qps_grid],
        "ttft_slo_ms": round(float(cfg.ttft_slo_ms), 1),
        "track_tol": cfg.track_tol,
        "knee_qps": knee,
        **budget_stamp,
        "points": points,
    }
    if emit:
        log_json({"event": "loadgen_summary", **summary})
    return summary
