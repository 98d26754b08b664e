"""Fault-tolerant serving tier: a replica router over N engine replicas
(port of the JAX package's ``serving/router.py``).

A host-side router spreads requests over N ``ServingEngine`` replicas in
one process.  The replicas share one model; each owns its own session,
slot state and block pool, so the replica boundary is the seam a
multi-host router would cut along.

- **dispatch**: session affinity (a ``session`` key stays on one replica
  while it lives) and otherwise the live replica with the smallest queued
  + active load, up to a per-replica depth cap;
- **health machine** a replica: ``live -> suspect -> dead`` from missed
  heartbeats (ticks in which a replica holding work made no ``progress``),
  ``draining -> drained`` for a graceful retirement; a step that raises is
  a crash, dead at once;
- **retry and re-prefill**: every request a dead replica held, queued or
  mid-decode, goes back to the front of the queue with its prompt and
  budget, after ``backoff_ticks`` of capped exponential backoff, at most
  ``max_retries`` times (then it sheds).  Its partial tokens are dropped:
  greedy decode does not depend on the schedule, so the re-prefilled
  output equals an unfailed run's;
- **admission control**: a bounded router queue (``max_queue``); a
  submission over it is shed or deferred to a client-side buffer
  (``shed_policy``);
- **deadlines**: a request's wall or tick deadline is checked while it
  waits (queued, deferred or backing off); an expired one sheds;
- **drain**: ``drain_replica(i)`` stops admitting to a replica, sends its
  queued requests elsewhere, lets its slots finish and retires it;
  ``drain()`` stops the router admitting new submissions.

Chaos (``obs/chaos.py``'s serving kinds, ticks = router ticks):
``replica_crash@K`` fails the busiest replica at tick K,
``replica_stall@K`` wedges it (no step, no progress: only the heartbeat
detector sees it), ``request_storm@K`` submits a synthetic burst through
admission control.  Ticks, not wall time, drive every decision, so a run
replays.

Events: ``router_window`` (every ``log_every_ticks``), ``replica_health``
(each transition, ``local``), ``serve_retry`` and ``serve_shed`` (each
occurrence) and a final ``router_summary`` (MTTR, retry rate, sheds,
goodput, and the tier's prefix-cache and speculation ledgers summed over
the surviving replicas) that ``obs/report.py`` reads.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Any, Sequence

from distributed_llms_example_tpu_torch.obs import sink as sink_mod
from distributed_llms_example_tpu_torch.obs.chaos import ChaosSchedule
from distributed_llms_example_tpu_torch.obs.spans import percentiles
from distributed_llms_example_tpu_torch.serving.engine import ServingEngine, compute_goodput
from distributed_llms_example_tpu_torch.utils.backoff import backoff_ticks
from distributed_llms_example_tpu_torch.utils.jsonlog import log_json


@dataclasses.dataclass(frozen=True)
class RouterConfig:
    """Router policy, as in the JAX package.

    ``max_retries``: re-dispatches a request gets after replica failures
    (then it sheds).  ``retry_backoff_ticks`` / ``retry_backoff_cap_ticks``:
    the capped exponential re-dispatch delay.  ``suspect_after_ticks`` /
    ``dead_after_ticks``: missed heartbeats before live -> suspect ->
    dead.  ``max_queue``: the router queue's bound (0 = none);
    ``shed_policy``: "shed" rejects a submission over it, "defer" parks it
    client-side.  ``replica_queue_depth``: a replica's dispatch cap (0 =
    its prefill chunk).  ``deadline_s``: the default wall deadline (0 =
    none).  ``storm_size`` / ``storm_deadline_ticks``: the
    ``request_storm`` burst's size (0 = twice the queue bound, or four
    depth caps) and its requests' tick deadline."""

    max_retries: int = 2
    retry_backoff_ticks: int = 2
    retry_backoff_cap_ticks: int = 16
    suspect_after_ticks: int = 3
    dead_after_ticks: int = 6
    max_queue: int = 0
    shed_policy: str = "defer"
    replica_queue_depth: int = 0
    deadline_s: float = 0.0
    log_every_ticks: int = 50
    storm_size: int = 0
    storm_deadline_ticks: int = 64
    chaos: ChaosSchedule | None = None

    def __post_init__(self):
        if self.shed_policy not in ("defer", "shed"):
            raise ValueError(f"shed_policy={self.shed_policy!r}: must be 'defer' or 'shed'")
        if self.max_retries < 0:
            raise ValueError("max_retries must be >= 0")
        if self.dead_after_ticks <= self.suspect_after_ticks:
            raise ValueError("dead_after_ticks must exceed suspect_after_ticks (suspect is the "
                             "earlier rung of the same detector)")


@dataclasses.dataclass
class _Request:
    rid: int
    tokens: list
    mask: Any
    budget: int | None
    session_key: Any
    synthetic: bool
    arrival_wall: float  # the scheduled arrival (== submit_wall closed loop)
    submit_wall: float
    submit_tick: int
    deadline_wall: float | None  # an absolute perf_counter instant
    deadline_tick: int | None
    retries: int = 0
    ready_tick: int = 0
    replica: int | None = None  # the current assignment
    local: int | None = None  # its session-local rid there
    done: bool = False
    shed: bool = False
    shed_reason: str = ""
    out: list = dataclasses.field(default_factory=list)
    ttft_s: float | None = None
    done_wall: float | None = None
    first_fail_wall: float | None = None


@dataclasses.dataclass
class _Replica:
    idx: int
    engine: ServingEngine
    session: Any
    state: str = "live"
    last_beat: int = 0
    crashes: int = 0


class ReplicaRouter:
    """The scheduler: one ``tick()`` = chaos, deadlines, dispatch, a step of
    every serving replica, the health update, the cadence window.
    ``serve()`` is the batch entry (submit everything, tick until every
    request is done or shed, finalize)."""

    def __init__(self, engines: Sequence[ServingEngine], cfg: RouterConfig | None = None):
        if not engines:
            raise ValueError("the replica pool needs at least one engine")
        self.cfg = cfg or RouterConfig()
        self.replicas = [_Replica(idx=i, engine=e, session=e.open(replica=i))
                         for i, e in enumerate(engines)]
        self._depth_cap = self.cfg.replica_queue_depth or max(e.prefill_batch for e in engines)
        self.requests: list[_Request] = []
        self.queue: collections.deque[_Request] = collections.deque()
        self.deferred: collections.deque[_Request] = collections.deque()
        self.affinity: dict[Any, int] = {}
        self.ticks = 0
        self.t_open = time.perf_counter()
        self.admitting = True  # drain() turns it off
        self.retries_total = 0
        self.shed_by_reason: dict[str, int] = {}
        self._chaos_stalled: set[int] = set()
        self._requeued_outstanding: set[int] = set()
        self.t_fail: float | None = None  # the first replica failure
        self.t_recovered: float | None = None  # every displaced request re-dispatched
        self.last_stats: dict | None = None
        self._finalized = False

    # ------------------------------------------------------------- intake
    def submit(self, tokens: Sequence[int], *, max_new: int | None = None,
               attention_mask: Sequence[int] | None = None, session: Any = None,
               deadline_s: float | None = None, deadline_ticks: int | None = None,
               synthetic: bool = False, arrival: float | None = None) -> int:
        """Offer one request; admission control applies here (a full queue
        sheds or defers it).  Returns the router-wide request id either
        way.  ``arrival`` (a perf_counter instant, default now) is the
        open-loop scheduled arrival, passed on to the replica's session."""
        now = time.perf_counter()
        ddl_s = self.cfg.deadline_s if deadline_s is None else deadline_s
        req = _Request(
            rid=len(self.requests), tokens=list(tokens),
            mask=list(attention_mask) if attention_mask is not None else None,
            budget=max_new, session_key=session, synthetic=synthetic,
            arrival_wall=float(arrival) if arrival is not None else now, submit_wall=now,
            submit_tick=self.ticks,
            deadline_wall=(now + ddl_s) if ddl_s and ddl_s > 0 else None,
            deadline_tick=self.ticks + int(deadline_ticks) if deadline_ticks is not None else None,
        )
        self.requests.append(req)
        if not self.admitting:
            self._shed(req, "draining")
        elif self.cfg.max_queue and len(self.queue) >= self.cfg.max_queue:
            if self.cfg.shed_policy == "shed":
                self._shed(req, "queue_full")
            else:
                self.deferred.append(req)
        else:
            self.queue.append(req)
        return req.rid

    # ------------------------------------------------------------ helpers
    def _shed(self, req: _Request, reason: str) -> None:
        req.shed, req.shed_reason = True, reason
        self._requeued_outstanding.discard(req.rid)
        self.shed_by_reason[reason] = self.shed_by_reason.get(reason, 0) + 1
        log_json({"event": "serve_shed", "request": req.rid, "reason": reason,
                  "tick": self.ticks, "synthetic": req.synthetic})

    def _emit_health(self, r: _Replica, old: str, new: str, *, reason: str, **extra: Any) -> None:
        r.state = new
        sink_mod.emit({"event": "replica_health", "replica": r.idx, "from": old, "to": new,
                       "tick": self.ticks, "reason": reason, **extra}, local=True)

    def _live(self) -> list[_Replica]:
        return [r for r in self.replicas if r.state == "live"]

    def _serving(self) -> list[_Replica]:
        # worth stepping: live, suspect (maybe only slow), draining (its
        # slots finishing)
        return [r for r in self.replicas if r.state in ("live", "suspect", "draining")]

    def _pick_victim(self) -> _Replica | None:
        """Chaos's target: the steppable replica with the most active slots
        (ties to the lowest id)."""
        cands = [r for r in self.replicas if r.state in ("live", "suspect")]
        if not cands:
            return None
        return max(cands, key=lambda r: (r.session.active_count, -r.idx))

    # ------------------------------------------------------------ failure
    def _fail_replica(self, r: _Replica, *, cause: str, reason: str) -> None:
        """Mark a replica dead and send every request it held, queued or
        mid-decode, back to the front of the queue (or shed it past
        ``max_retries``).  Its partial tokens are dropped."""
        now = time.perf_counter()
        if self.t_fail is None:
            self.t_fail = now
        r.crashes += 1
        self._emit_health(r, r.state, "dead", reason=reason, cause=cause, since_tick=r.last_beat)
        self._chaos_stalled.discard(r.idx)
        held = [q for q in self.requests if q.replica == r.idx and not q.done and not q.shed]
        for q in held:
            had_tokens = bool(q.local is not None and r.session.outputs[q.local])
            q.replica, q.local = None, None
            q.retries += 1
            self.retries_total += 1
            if q.first_fail_wall is None:
                q.first_fail_wall = now
            if q.retries > self.cfg.max_retries:
                self._shed(q, "retries_exhausted")
                continue
            q.ready_tick = self.ticks + backoff_ticks(q.retries, base=self.cfg.retry_backoff_ticks,
                                                      cap=self.cfg.retry_backoff_cap_ticks)
            self._requeued_outstanding.add(q.rid)
            self.queue.appendleft(q)
            log_json({"event": "serve_retry", "request": q.rid, "replica": r.idx,
                      "retries": q.retries, "ready_tick": q.ready_tick, "tick": self.ticks,
                      "had_tokens": had_tokens, "synthetic": q.synthetic, "reason": cause})
        # the session dies with the replica, but the block pool's free list
        # is host state on the engine: the dead session's blocks go back,
        # and its warm set is dropped (no survivor may match against it)
        if r.engine.paged and r.session is not None:
            for blocks in r.session.slot_blocks:
                if blocks:
                    r.engine.pool.free(blocks)
            if r.engine.prefix:
                r.engine.pool.drop_warm()
        r.session = None

    # -------------------------------------------------------------- drain
    def drain_replica(self, idx: int) -> None:
        """Graceful retirement: stop admitting to the replica, re-route its
        queued requests (no backoff, no retry counted), let its slots
        decode to completion; it then parks as ``drained``."""
        r = self.replicas[idx]
        if r.state not in ("live", "suspect"):
            return
        self._emit_health(r, r.state, "draining", reason="operator drain")
        taken = set(r.session.take_pending())
        for q in self.requests:
            if q.rid in taken:
                q.replica, q.local = None, None
                q.ready_tick = self.ticks
                self.queue.appendleft(q)
                log_json({"event": "serve_retry", "request": q.rid, "replica": r.idx,
                          "retries": q.retries, "ready_tick": q.ready_tick, "tick": self.ticks,
                          "had_tokens": False, "synthetic": q.synthetic, "reason": "drain"})

    def drain(self) -> None:
        """Router-wide drain: new submissions shed ("draining"); everything
        accepted finishes."""
        self.admitting = False

    # ------------------------------------------------------------ routing
    def _route(self, req: _Request) -> _Replica | None:
        """Session affinity while the mapped replica is live and has room,
        else the live replica with the smallest queued + active load."""
        def depth(r: _Replica) -> int:
            return r.session.queue_depth + r.session.active_count

        live = self._live()
        if not live:
            return None
        if req.session_key is not None:
            mapped = self.affinity.get(req.session_key)
            if mapped is not None:
                r = self.replicas[mapped]
                if r.state == "live" and depth(r) < self._depth_cap:
                    return r
        best = min(live, key=lambda r: (depth(r), r.idx))
        if depth(best) >= self._depth_cap:
            return None
        if req.session_key is not None:
            self.affinity[req.session_key] = best.idx
        return best

    def _dispatch(self) -> None:
        # FIFO over ready requests: one in backoff does not block those
        # behind it
        held: list[_Request] = []
        while self.queue:
            req = self.queue.popleft()
            if req.shed or req.done:
                continue
            if req.ready_tick > self.ticks:
                held.append(req)
                continue
            target = self._route(req)
            if target is None:
                held.append(req)
                break  # no room anywhere this tick
            req.local = target.session.submit(req.tokens, max_new=req.budget,
                                              attention_mask=req.mask, label=req.rid,
                                              arrival=req.arrival_wall)
            req.replica = target.idx
            if req.rid in self._requeued_outstanding:
                self._requeued_outstanding.discard(req.rid)
                if not self._requeued_outstanding and self.t_fail is not None:
                    self.t_recovered = time.perf_counter()
        for req in reversed(held):
            self.queue.appendleft(req)

    # ----------------------------------------------------------- deadline
    def _sweep_deadlines(self) -> None:
        now = time.perf_counter()

        def expired(q: _Request) -> bool:
            if q.deadline_wall is not None and now > q.deadline_wall:
                return True
            return q.deadline_tick is not None and self.ticks > q.deadline_tick

        for buf in (self.queue, self.deferred):
            for q in list(buf):
                if expired(q):
                    buf.remove(q)
                    self._shed(q, "deadline")

    def _promote_deferred(self) -> None:
        while self.deferred and (not self.cfg.max_queue or len(self.queue) < self.cfg.max_queue):
            self.queue.append(self.deferred.popleft())

    # -------------------------------------------------------------- chaos
    def _take_chaos(self) -> None:
        chaos = self.cfg.chaos
        if not chaos:
            return
        if chaos.take("replica_crash", self.ticks):
            victim = self._pick_victim()
            if victim is not None:
                # the injected crash takes the one failure path
                self._fail_replica(victim, cause="crash", reason="chaos: injected replica crash")
        if chaos.take("replica_stall", self.ticks):
            victim = self._pick_victim()
            if victim is not None:
                self._chaos_stalled.add(victim.idx)  # wedged, not killed
        if chaos.take("request_storm", self.ticks):
            real = [q for q in self.requests if not q.synthetic]
            if real:
                size = self.cfg.storm_size or 2 * (self.cfg.max_queue or 2 * self._depth_cap)
                for i in range(size):
                    src = real[i % len(real)]
                    self.submit(src.tokens, max_new=src.budget, attention_mask=src.mask,
                                deadline_ticks=self.cfg.storm_deadline_ticks, synthetic=True)

    # ------------------------------------------------------------ the tick
    def tick(self) -> None:
        self.ticks += 1
        self._take_chaos()
        self._sweep_deadlines()
        self._promote_deferred()
        self._dispatch()
        now = time.perf_counter()
        for r in self._serving():
            if not r.session.has_work():
                if r.state == "draining":
                    self._emit_health(r, "draining", "drained", reason="slots empty")
                else:
                    r.last_beat = self.ticks  # idle is not a missed beat
                continue
            if r.idx in self._chaos_stalled:
                continue  # wedged: no step, no progress, no beat
            before = r.session.progress
            try:
                finished = r.session.step()
            except Exception as e:  # a replica crash is any exception out of its step
                self._fail_replica(r, cause="crash", reason=f"step raised: {str(e)[:200]}")
                continue
            if r.session.progress > before:
                r.last_beat = self.ticks
                if r.state == "suspect":
                    self._emit_health(r, "suspect", "live", reason="progress resumed")
            for local in finished:
                self._complete(r, local, now)
        self._update_health()
        if self.cfg.log_every_ticks and self.ticks % self.cfg.log_every_ticks == 0:
            self._emit_window()

    def _complete(self, r: _Replica, local: int, now: float) -> None:
        req = self.requests[r.session.labels[local]]
        req.done = True
        req.out = list(r.session.output(local))
        req.done_wall = now
        ft = r.session.first_token_wall(local)
        if ft is not None:
            # from the original submit: a retried request's failure and
            # re-prefill land in its TTFT, where the client saw them
            req.ttft_s = ft - req.submit_wall
        if req.session_key is not None:
            self.affinity[req.session_key] = r.idx

    def _update_health(self) -> None:
        # a draining replica stays under the detector: one wedged mid-drain
        # must still die (and its slots re-prefill) or the drain never ends
        for r in self.replicas:
            if r.state not in ("live", "suspect", "draining"):
                continue
            if not (r.session.has_work() or r.idx in self._chaos_stalled):
                continue
            missed = self.ticks - r.last_beat
            if missed > self.cfg.dead_after_ticks:
                self._fail_replica(r, cause="stall", reason=(
                    f"no progress for {missed} ticks with work queued "
                    "(heartbeat-miss / step-stall detector)"))
            elif missed > self.cfg.suspect_after_ticks and r.state == "live":
                self._emit_health(r, "live", "suspect", reason=f"no progress for {missed} ticks")

    def _emit_window(self) -> None:
        log_json({
            "event": "router_window", "tick": self.ticks, "queue_depth": len(self.queue),
            "deferred": len(self.deferred), "retries": self.retries_total,
            "shed": sum(self.shed_by_reason.values()),
            "completed": sum(1 for q in self.requests if q.done),
            "replicas": [{"replica": r.idx, "state": r.state,
                          "queue_depth": r.session.queue_depth if r.session is not None else 0,
                          "active": r.session.active_count if r.session is not None else 0}
                         for r in self.replicas],
        })

    # -------------------------------------------------------- batch entry
    def _outstanding(self) -> bool:
        return any(not (q.done or q.shed) for q in self.requests)

    def shed_unserved(self) -> None:
        """No steppable replica is left: the remainder sheds
        ("no_replicas") — a router with no replicas is an outage, not a
        hang."""
        for q in self.requests:
            if not (q.done or q.shed):
                self._shed(q, "no_replicas")

    def run_until_drained(self) -> None:
        """Tick until every accepted request is done or shed."""
        while self._outstanding():
            if not self._serving():
                self.shed_unserved()
                break
            self.tick()

    def serve(self, requests: Sequence[Sequence[int]], *,
              max_new: Sequence[int] | None = None,
              attention_masks: Sequence[Sequence[int]] | None = None,
              sessions: Sequence[Any] | None = None) -> list[list[int]]:
        """The batch entry (what ``serve-router`` runs): submit everything,
        run to drained, finalize.  Returns each request's generated ids in
        request order (a shed request's: empty)."""
        if max_new is not None and len(max_new) != len(requests):
            raise ValueError(f"max_new has {len(max_new)} entries for {len(requests)} requests")
        rids = [self.submit(req, max_new=max_new[i] if max_new is not None else None,
                            attention_mask=(attention_masks[i] if attention_masks is not None
                                            else None),
                            session=sessions[i] if sessions is not None else None)
                for i, req in enumerate(requests)]
        self.run_until_drained()
        self.finalize()
        return [list(self.requests[rid].out) for rid in rids]

    # ------------------------------------------------------------ summary
    def finalize(self) -> dict:
        """Close every surviving session (their serve_summary events) and
        emit the ``router_summary``.  Idempotent."""
        if self._finalized:
            return self.last_stats
        self._finalized = True
        for r in self.replicas:
            if r.session is not None:
                r.session.finalize()
        wall = max(time.perf_counter() - self.t_open, 1e-9)
        real = [q for q in self.requests if not q.synthetic]
        completed = [q for q in real if q.done]
        mttr_vals = [q.done_wall - q.first_fail_wall for q in real
                     if q.done and q.first_fail_wall is not None]
        ttfts = [q.ttft_s for q in completed if q.ttft_s is not None]
        p50, p95, p99 = percentiles(ttfts, (0.50, 0.95, 0.99))
        slo_ms = max((r.engine.serve.ttft_slo_ms for r in self.replicas), default=0.0)
        slo_s = slo_ms / 1e3
        useful = [q for q in completed
                  if q.ttft_s is not None and (slo_s <= 0 or q.ttft_s <= slo_s)]
        # the replicas share one card
        goodput = compute_goodput([q.ttft_s for q in real], [len(q.out) for q in real],
                                  wall_s=wall, ttft_slo_ms=slo_ms, n_chips=1)
        # the gated rate counts real traffic's failure retries: a synthetic
        # storm request's retries are injected load
        real_retries = sum(q.retries for q in real)
        summary = {
            "event": "router_summary",
            "replicas": len(self.replicas),
            "replica_states": {str(r.idx): r.state for r in self.replicas},
            "ticks": self.ticks,
            "wall_s": round(wall, 3),
            "requests": len(real),
            "synthetic_requests": len(self.requests) - len(real),
            "completed": len(completed),
            "shed": sum(1 for q in real if q.shed),
            "shed_by_reason": dict(sorted(self.shed_by_reason.items())),
            "retries": real_retries,
            "retries_total": self.retries_total,
            "request_retry_rate": round(real_retries / max(len(real), 1), 4),
            "goodput_frac": round(len(useful) / max(len(real), 1), 4),
            "request_mttr_s": round(sum(mttr_vals) / len(mttr_vals), 4) if mttr_vals else None,
            "ttft_p50_ms": round(p50 * 1e3, 1),
            "ttft_p95_ms": round(p95 * 1e3, 1),
            "ttft_p99_ms": round(p99 * 1e3, 1),
            **goodput,
        }
        # the tier's ledgers, summed over the surviving replicas' closed
        # sessions (a dead replica's stats die with its session)
        stats = [r.engine.last_stats for r in self.replicas
                 if r.session is not None and r.engine.last_stats is not None]
        if any(r.engine.paged and r.engine.prefix for r in self.replicas):
            lookups = sum(st.prefix_lookups for st in stats)
            hits = sum(st.prefix_hits for st in stats)
            saved = sum(st.prefill_tokens_saved for st in stats)
            total = sum(st.prefill_tokens_total for st in stats)
            summary.update(prefix_lookups=lookups, prefix_hits=hits,
                           prefix_hit_rate=round(hits / max(lookups, 1), 4),
                           prefill_tokens_saved=saved, prefill_tokens_total=total,
                           prefill_tokens_saved_frac=round(saved / max(total, 1), 4))
        if any(r.engine.spec for r in self.replicas):
            drafted = sum(st.spec_drafted for st in stats)
            accepted = sum(st.spec_accepted for st in stats)
            emitted = sum(st.spec_emitted for st in stats)
            rounds = sum(st.spec_slot_rounds for st in stats)
            summary.update(spec_tokens=max(r.engine.spec for r in self.replicas),
                           spec_drafted_tokens=drafted, spec_accepted_tokens=accepted,
                           acceptance_rate=round(accepted / max(drafted, 1), 4),
                           accepted_tokens_per_step=round(emitted / max(rounds, 1), 4))
        if self.t_fail is not None:
            summary["t_fail_s"] = round(self.t_fail - self.t_open, 4)
            if self.t_recovered is not None:
                summary["t_recovered_s"] = round(self.t_recovered - self.t_open, 4)
        log_json(summary)
        self.last_stats = summary
        return summary

    def request_rows(self) -> list[dict]:
        """Per-request rows: arrival, submit and done instants relative to
        the router's open, TTFT, tokens, retries, shed."""
        return [{
            "rid": q.rid, "synthetic": q.synthetic,
            "arrival_s": round(q.arrival_wall - self.t_open, 6),
            "queue_delay_ms": round((q.submit_wall - q.arrival_wall) * 1e3, 3),
            "submit_s": round(q.submit_wall - self.t_open, 6),
            "done_s": round(q.done_wall - self.t_open, 6) if q.done_wall is not None else None,
            "ttft_s": q.ttft_s, "tokens": len(q.out), "retries": q.retries, "shed": q.shed,
            "shed_reason": q.shed_reason,
        } for q in self.requests]
