"""Offline reader of a run's ``--obs jsonl`` telemetry (port of the JAX
package's ``obs/report.py``).

``python -m distributed_llms_example_tpu_torch.obs.report <output_dir>``
reads every ``obs/metrics-p*.jsonl`` and ``obs/flight-recorder-p*.json``
the run left, checks ``schema_version`` on every line, and rebuilds:

- a merged per-step timeline (process 0's metric lines, every rank's
  ``obs_window`` summaries, evals, heartbeats, anomalies) on ``step``;
- window trends: p50/p95 step time per rank across the run;
- straggler attribution: which ranks the heartbeat named laggards and how
  often, beside each rank's mean window p95;
- "Where did the time go": the ``step_budget`` accounts per rank
  (``obs/budget.py``), the host-stall components ranked, the wall-weighted
  ``dispatch_efficiency`` and every off-cadence sync the tripwire flagged;
- the recovery timeline: chaos injections, recoveries (rewinds, skips,
  halts), quarantines, checkpoint integrity failures, data retries,
  topology changes and reshard restores (their wall in the MTTR), the
  serving tier's replica events, host-loss suspects, and every fault split
  into injected (a ``chaos_injection`` explains it) and organic;
- the device account of every profiled window (``device_account``,
  ``obs/devprof.py``): per-bucket device time, each collective's achieved
  bandwidth against the startup gauges' byte account, compute/comm
  overlap and exposed idle;
- the comm account (``obs_gauges``, ``obs/gauges.py``) with the
  reduce-scatter smell;
- "Where did the bytes go" (``memory_account``, ``memory_window`` and the
  ``memory-postmortem-p*.json`` bundles, ``obs/memprof.py``);
- the serving engine's prefix-cache and speculative-decode ledgers (its
  ``serve_summary`` and ``serve_window`` events, the router's
  cross-replica aggregate in ``router_summary`` when there is one);
- the open-loop load sweep (``loadgen_point`` / ``loadgen_summary``,
  ``serving/loadgen.py``): offered, achieved and goodput QPS, TTFT
  percentiles and queue delay a point, and the saturation knee;
- the anomaly log and the flight-recorder bundles.

Markdown by default, ``--json`` for the whole report, ``--trace out.json``
the merged Perfetto trace (``obs/trace.py``).  ``--strict`` exits 1 on a
schema error, an organic fault, or a gate it is given that fails or has
nothing to read: ``--min-dispatch-efficiency``, ``--min-overlap-frac``,
``--max-peak-hbm-frac``, ``--min-hbm-headroom-gib``,
``--max-request-retry-rate``, ``--min-serve-goodput-frac``,
``--min-slo-attainment``, ``--max-p99-ttft-ms``, ``--min-prefix-hit-rate``,
``--min-acceptance-rate``.  A pure file reader: nothing here touches a
device.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import re
import sys
from typing import Any

from distributed_llms_example_tpu_torch.obs.budget import COMPONENTS, aggregate_accounts
from distributed_llms_example_tpu_torch.obs.sink import SCHEMA_VERSION

_PROC_RE = re.compile(r"-p(\d+)\.jsonl?$")


def load_jsonl(path: str) -> tuple[list[dict], list[str]]:
    """One JSONL file's records whose ``schema_version`` is ours, and an
    error string for every other line (a torn last line included)."""
    records: list[dict] = []
    errors: list[str] = []
    with open(path) as f:
        for lineno, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError as e:
                errors.append(f"{path}:{lineno}: unparseable line ({e})")
                continue
            if not isinstance(rec, dict):
                errors.append(f"{path}:{lineno}: not a JSON object")
                continue
            v = rec.get("schema_version")
            if v != SCHEMA_VERSION:
                errors.append(f"{path}:{lineno}: schema_version {v!r} != {SCHEMA_VERSION}")
                continue
            records.append(rec)
    return records, errors


def load_run(output_dir: str) -> dict[str, Any]:
    """Every rank's stream and recorder bundle under ``<output_dir>/obs/``."""
    obs_dir = os.path.join(output_dir, "obs")
    processes: dict[int, list[dict]] = {}
    errors: list[str] = []
    for path in sorted(glob.glob(os.path.join(obs_dir, "metrics-p*.jsonl"))):
        m = _PROC_RE.search(path)
        if not m:
            continue
        recs, errs = load_jsonl(path)
        processes[int(m.group(1))] = recs
        errors.extend(errs)
    recorders: dict[int, dict] = {}
    for path in sorted(glob.glob(os.path.join(obs_dir, "flight-recorder-p*.json"))):
        m = re.search(r"-p(\d+)\.json$", path)
        if not m:
            continue
        try:
            with open(path) as f:
                bundle = json.load(f)
        except (OSError, json.JSONDecodeError) as e:
            errors.append(f"{path}: unreadable bundle ({e})")
            continue
        if bundle.get("schema_version") != SCHEMA_VERSION:
            errors.append(f"{path}: schema_version {bundle.get('schema_version')!r} "
                          f"!= {SCHEMA_VERSION}")
            continue
        recorders[int(m.group(1))] = bundle
    postmortems: dict[int, dict] = {}
    for path in sorted(glob.glob(os.path.join(obs_dir, "memory-postmortem-p*.json"))):
        m = re.search(r"-p(\d+)\.json$", path)
        if not m:
            continue
        try:
            with open(path) as f:
                bundle = json.load(f)
        except (OSError, json.JSONDecodeError) as e:
            errors.append(f"{path}: unreadable bundle ({e})")
            continue
        if bundle.get("schema_version") != SCHEMA_VERSION:
            errors.append(f"{path}: schema_version {bundle.get('schema_version')!r} "
                          f"!= {SCHEMA_VERSION}")
            continue
        postmortems[int(m.group(1))] = bundle
    return {"processes": processes, "recorders": recorders, "postmortems": postmortems,
            "errors": errors}


def _by_event(records: list[dict]) -> dict[str, list[dict]]:
    out: dict[str, list[dict]] = {}
    for r in records:
        out.setdefault(r.get("event", "metric"), []).append(r)
    return out


def merge_timeline(processes: dict[int, list[dict]]) -> list[dict]:
    """Every rank's records joined on the global ``step`` into one
    chronological per-step timeline."""
    steps: dict[int, dict[str, Any]] = {}

    def at(step: Any) -> dict | None:
        if not isinstance(step, (int, float)):
            return None
        return steps.setdefault(int(step), {"step": int(step)})

    for proc, records in sorted(processes.items()):
        ev = _by_event(records)
        for r in ev.get("metric", []):
            row = at(r.get("step"))
            if row is None or "loss" not in r:
                continue
            for k in ("loss", "learning_rate", "tokens_per_sec", "steps_per_sec", "epoch"):
                if k in r:
                    row[k] = r[k]
        for r in ev.get("obs_window", []):
            row = at(r.get("step"))
            if row is None:
                continue
            row.setdefault("windows", {})[proc] = {
                "p50": r.get("step_ms_p50"), "p95": r.get("step_ms_p95"),
                "max": r.get("step_ms_max"), "straggler": r.get("straggler")}
            if "health" in r:
                row.setdefault("health", {})[proc] = r["health"]
        for r in ev.get("eval", []):
            row = at(r.get("step"))
            if row is None:
                continue
            for k, v in r.items():
                if k not in ("event", "step", "schema_version"):
                    row.setdefault("eval", {})[k] = v
        for r in ev.get("heartbeat", []):
            row = at(r.get("step"))
            if row is None:
                continue
            row["heartbeat"] = {k: r.get(k) for k in ("skew_steps", "arrival_spread_s",
                                                      "laggards", "process_count")}
        for r in ev.get("obs_anomaly", []):
            row = at(r.get("step"))
            if row is None:
                continue
            row.setdefault("anomalies", []).append(
                {k: r.get(k) for k in ("code", "ranks", "policy", "value", "detail",
                                       "detected_at_step") if k in r})
    return [steps[s] for s in sorted(steps)]


def straggler_attribution(processes: dict[int, list[dict]]) -> dict[str, Any]:
    """Who was slow: the heartbeat's laggard counts per rank (the gather is
    a barrier: a laggard there kept everyone waiting) beside each rank's
    mean window p95."""
    laggard_counts: dict[int, int] = {}
    max_skew = 0
    max_spread = 0.0
    per_rank_p95: dict[int, float] = {}
    straggler_windows: dict[int, int] = {}
    for proc, records in sorted(processes.items()):
        ev = _by_event(records)
        for r in ev.get("heartbeat", []):
            for lag in r.get("laggards", []) or []:
                laggard_counts[int(lag)] = laggard_counts.get(int(lag), 0) + 1
            max_skew = max(max_skew, int(r.get("skew_steps", 0) or 0))
            max_spread = max(max_spread, float(r.get("arrival_spread_s", 0.0) or 0.0))
        windows = ev.get("obs_window", [])
        p95s = [r["step_ms_p95"] for r in windows if isinstance(r.get("step_ms_p95"), (int, float))]
        if p95s:
            per_rank_p95[proc] = round(sum(p95s) / len(p95s), 3)
        straggler_windows[proc] = sum(1 for r in windows if r.get("straggler"))
    return {
        "heartbeat_laggard_counts": {str(k): v for k, v in sorted(laggard_counts.items())},
        "max_skew_steps": max_skew,
        "max_arrival_spread_s": max_spread,
        "mean_step_ms_p95_by_rank": {str(k): v for k, v in sorted(per_rank_p95.items())},
        "straggler_windows_by_rank": {str(k): v for k, v in sorted(straggler_windows.items())},
    }


def window_trends(processes: dict[int, list[dict]]) -> dict[str, list[dict]]:
    return {str(proc): [{"step": r.get("step"), "p50": r.get("step_ms_p50"),
                         "p95": r.get("step_ms_p95"), "mfu": r.get("mfu")}
                        for r in _by_event(records).get("obs_window", [])]
            for proc, records in sorted(processes.items())}


def account_gradient_bytes_by_op(account: dict) -> dict[str, int]:
    """The comm account's ``{op: gradient_bytes}``."""
    return {op: int(slot["gradient_bytes"]) for op, slot in account.items()
            if isinstance(slot, dict) and "gradient_bytes" in slot}


# the smell's thresholds (the JAX package's): all-reduce gradient bytes at
# least this multiple of the reduce-scatter ones, and at least this many
SMELL_RATIO = 2.0
SMELL_MIN_BYTES = 1 << 20


def reduce_scatter_smell(gradient_bytes_by_op: dict[str, int], mesh_axes: dict) -> dict | None:
    """The JAX package's reduce-scatter smell over a gradient-byte account:
    on an ``fsdp`` mesh, gradient bytes riding all-reduce well above those
    riding reduce-scatter (the gradients kept replicated through the
    reduction, twice the traffic).  Its finding as JSON, or None."""
    if int(mesh_axes.get("fsdp", 1) or 1) <= 1:
        return None
    merged: dict[str, int] = {}
    for op, b in gradient_bytes_by_op.items():
        base = op[: -len("-start")] if op.endswith("-start") else op
        merged[base] = merged.get(base, 0) + int(b)
    ar = merged.get("all-reduce", 0)
    rs = merged.get("reduce-scatter", 0)
    if ar < max(SMELL_MIN_BYTES, int(SMELL_RATIO * max(rs, 1))):
        return None
    return {"event": "lint_finding", "severity": "warning", "pass": "ir",
            "code": "gradient-all-reduce-not-reduce-scatter",
            "message": (f"{ar / 1024**2:.1f} MiB of gradient bytes ride all-reduce vs "
                        f"{rs / 1024**2:.1f} MiB on reduce-scatter on an fsdp mesh "
                        f"(fsdp={mesh_axes.get('fsdp')}) — sharded gradients should "
                        "reduce-scatter; an all-reduce keeps them replicated through "
                        "the reduction and pays ~2× the gradient traffic"),
            "all_reduce_gradient_bytes": ar, "reduce_scatter_gradient_bytes": rs,
            "ratio_threshold": SMELL_RATIO}


def comm_report(processes: dict[int, list[dict]]) -> dict[str, Any] | None:
    """The startup gauges' collective byte account, with the reduce-scatter
    smell over it."""
    for records in processes.values():
        for r in _by_event(records).get("obs_gauges", []):
            comm = r.get("comm")
            if not isinstance(comm, dict):
                continue
            out: dict[str, Any] = {"mesh": r.get("mesh"), "flops_per_step": r.get("flops_per_step"),
                                   "flops_source": r.get("flops_source"),
                                   "grad_compression": r.get("grad_compression"), "comm": comm}
            smell = reduce_scatter_smell(account_gradient_bytes_by_op(comm), r.get("mesh") or {})
            if smell is not None:
                out["reduce_scatter_smell"] = smell
            return out
    return None


def budget_report(processes: dict[int, list[dict]]) -> dict[str, Any] | None:
    """"Where did the time go" over every rank's ``step_budget`` events:
    per-rank totals and efficiency (``aggregate_accounts``), the host-stall
    components ranked, and the off-cadence sync incidents."""
    ranks: dict[str, Any] = {}
    windows: dict[str, list[dict]] = {}
    incidents: list[dict] = []
    eff_wall: list[tuple[float, float]] = []
    for proc, records in sorted(processes.items()):
        accts = _by_event(records).get("step_budget", [])
        if not accts:
            continue
        agg = aggregate_accounts(accts)
        ranks[str(proc)] = agg
        windows[str(proc)] = [
            {"step": a.get("step"), "wall_ms": a.get("wall_ms"),
             **{f"{c}_ms": a.get(f"{c}_ms") for c in COMPONENTS},
             "dispatch_efficiency": a.get("dispatch_efficiency"),
             "accounted_frac": a.get("accounted_frac"),
             "offcadence_sync_steps": a.get("offcadence_sync_steps", 0)}
            for a in accts]
        for a in accts:
            # suspect windows only: where dispatch is synchronous (the CPU)
            # the raw count is that backend's normal mode
            if a.get("offcadence_sync_suspect"):
                incidents.append({"rank": proc, "step": a.get("step"),
                                  "blocked_steps": int(a.get("offcadence_sync_steps", 0) or 0),
                                  "window_steps": a.get("window_steps"),
                                  "dispatch_ms": a.get("dispatch_ms")})
        if agg and agg.get("wall_ms"):
            eff_wall.append((agg["dispatch_efficiency"], agg["wall_ms"]))
    if not ranks:
        return None
    total_wall = sum(w for _, w in eff_wall)
    overall_eff = round(sum(e * w for e, w in eff_wall) / total_wall, 4) if total_wall else None
    # the host-stall components (the time the card was not being fed),
    # ranked by their share of all ranks' wall
    stall_components = ("data_wait", "host_overhead", "sync_block", "unattributed")
    totals = {c: sum(r.get(f"{c}_ms", 0.0) or 0.0 for r in ranks.values())
              for c in stall_components}
    all_wall = sum(r.get("wall_ms", 0.0) or 0.0 for r in ranks.values())
    offenders = sorted(({"component": c, "total_ms": round(v, 3),
                         "share": round(v / all_wall, 4) if all_wall else 0.0}
                        for c, v in totals.items()), key=lambda o: -o["total_ms"])
    return {"ranks": ranks, "windows": windows, "offenders": offenders,
            "incidents": incidents, "dispatch_efficiency": overall_eff}


def device_report(processes: dict[int, list[dict]]) -> dict[str, Any] | None:
    """Each rank's newest ``device_account``, the ``profile_captured``
    inventory, and the bandwidth join for an account emitted without it."""
    from distributed_llms_example_tpu_torch.obs.devprof import join_collective_bandwidth

    comm = None
    for records in processes.values():
        for r in _by_event(records).get("obs_gauges", []):
            if isinstance(r.get("comm"), dict):
                comm = r["comm"]
                break
        if comm:
            break
    ranks: dict[str, dict] = {}
    captures: list[dict] = []
    n_accounts = 0
    for proc, records in sorted(processes.items()):
        ev = _by_event(records)
        for r in ev.get("profile_captured", []):
            captures.append({"rank": proc, "path": r.get("path"), "window": r.get("window"),
                             "steps": r.get("steps"),
                             **({"truncated": True} if r.get("truncated") else {})})
        accts = ev.get("device_account", [])
        n_accounts += len(accts)
        if not accts:
            continue
        acct = dict(accts[-1])
        acct.pop("lanes", None)  # the exporter's payload
        needs_join = any("achieved_bytes_per_sec" not in slot
                         for slot in (acct.get("collectives") or {}).values())
        if needs_join and comm:
            join_collective_bandwidth(acct, comm, int(acct.get("window_steps", 0) or 0))
        ranks[str(proc)] = acct
    if not ranks and not captures:
        return None
    return {"ranks": ranks, "captures": captures, "accounts": n_accounts}


def memory_report(processes: dict[int, list[dict]],
                  postmortems: dict[int, dict] | None = None) -> dict[str, Any] | None:
    """"Where did the bytes go": the last static ``memory_account``, the
    ``memory_window`` envelope over every rank, the serving account, the
    postmortem bundles.  ``measured_peak_bytes`` (the gates' input) is the
    runtime peak where a window was sampled, else the static account's."""
    accounts: list[dict] = []
    windows: list[dict] = []
    skips: list[dict] = []
    serve_accounts: list[dict] = []
    for _, records in sorted(processes.items()):
        ev = _by_event(records)
        accounts.extend(ev.get("memory_account", []))
        windows.extend(ev.get("memory_window", []))
        skips.extend(ev.get("memory_window_skipped", []))
        for r in ev.get("serve_summary", []):
            if isinstance(r.get("memory_account"), dict):
                serve_accounts.append(r["memory_account"])
    postmortems = postmortems or {}
    if not (accounts or windows or skips or serve_accounts or postmortems):
        return None
    account = accounts[-1] if accounts else None
    serve_account = serve_accounts[-1] if serve_accounts else None
    runtime = None
    if windows:
        runtime = {
            "windows": len(windows),
            "max_bytes_in_use": max(int(w.get("bytes_in_use", 0)) for w in windows),
            "peak_bytes_in_use": max(int(w.get("peak_bytes_in_use", 0)) for w in windows),
            "max_watermark_delta_bytes": max(int(w.get("watermark_delta_bytes", 0))
                                             for w in windows),
            "bytes_limit": max(int(w.get("bytes_limit", 0)) for w in windows),
        }
    measured_peak = peak_source = None
    if runtime is not None:
        measured_peak, peak_source = runtime["peak_bytes_in_use"], "memory_window"
    elif account is not None and isinstance(account.get("peak_bytes"), (int, float)):
        measured_peak, peak_source = int(account["peak_bytes"]), "static_account"
    budget_bytes = None
    for src in (account, serve_account):
        if src is not None and isinstance(src.get("hbm_budget_bytes"), (int, float)):
            budget_bytes = int(src["hbm_budget_bytes"])
            break
    headrooms = [a["hbm_headroom_gib"] for a in (account, serve_account)
                 if a is not None and isinstance(a.get("hbm_headroom_gib"), (int, float))]
    return {
        "account": account,
        "serve_account": serve_account,
        "runtime": runtime,
        "static_only": bool(not windows and (account or serve_account)),
        "skips": [x.get("reason") for x in skips[:1]],
        "measured_peak_bytes": measured_peak,
        "measured_peak_source": peak_source,
        "hbm_budget_bytes": budget_bytes,
        "peak_frac_of_budget": (round(measured_peak / budget_bytes, 4)
                                if (measured_peak is not None and budget_bytes) else None),
        "min_headroom_gib": min(headrooms) if headrooms else None,
        "postmortems": {str(p): {"reason": b.get("reason"), "step": b.get("step"),
                                 "has_account": b.get("account") is not None,
                                 "watermark_samples": len(b.get("watermark_history") or []),
                                 "live_buffers_top": len(b.get("live_buffers_top") or [])}
                        for p, b in sorted(postmortems.items())},
    }


def recovery_report(processes: dict[int, list[dict]]) -> dict[str, Any]:
    """The fault-tolerance timeline with the injected/organic split.  A
    fault is injected when a ``chaos_injection`` explains it (``nan_grad``
    at the anomaly's step, ``ckpt_corrupt`` of that step, ``data_error`` at
    the retry's step, ``host_loss`` at the topology change's step, a
    replica crash at its tick or a stall within its window); any other is
    organic, which ``--strict`` fails on."""
    injections: list[dict] = []
    corrupted: list[dict] = []
    recoveries: list[dict] = []
    quarantines: list[dict] = []
    verify_failures: list[dict] = []
    data_events: list[dict] = []
    anomalies: list[dict] = []
    topo_changes: list[dict] = []
    reshards: list[dict] = []
    replica_events: list[dict] = []
    serve_retries: list[dict] = []
    serve_sheds: list[dict] = []
    router_summaries: list[dict] = []
    suspects: list[dict] = []
    # local events: every rank's file may carry a copy; one row per event
    seen: set = set()

    def dedup(into: list[dict], rec: dict, *keys: str) -> None:
        k = (rec.get("event"),) + tuple(rec.get(x) for x in keys)
        if k not in seen:
            seen.add(k)
            into.append(rec)

    for _, records in sorted(processes.items()):
        ev = _by_event(records)
        for r in ev.get("chaos_injection", []):
            dedup(injections, r, "kind", "step")
        for r in ev.get("chaos_ckpt_corrupted", []):
            dedup(corrupted, r, "step", "path")
        for r in ev.get("recovery", []):
            # rewind_index in the key: two rewinds of the same steps are two
            dedup(recoveries, r, "action", "step", "detected_at_step", "restored_step",
                  "rewind_index")
        for r in ev.get("quarantine", []):
            dedup(quarantines, r, "epoch", "epoch_step")
        for r in ev.get("topology_change", []):
            dedup(topo_changes, r, "step", "policy")
        for r in ev.get("reshard_restore", []):
            # the wall differs per rank: out of the key
            dedup(reshards, r, "step", "detected_at_step", "new_processes")
        for r in ev.get("replica_health", []):
            dedup(replica_events, r, "replica", "from", "to", "tick")
        for r in ev.get("serve_retry", []):
            dedup(serve_retries, r, "request", "retries", "tick", "reason")
        for r in ev.get("serve_shed", []):
            dedup(serve_sheds, r, "request", "tick")
        for r in ev.get("host_loss_suspect", []):
            dedup(suspects, r, "rank", "step")
        router_summaries.extend(ev.get("router_summary", []))
        for kind in ("ckpt_verify_failed", "ckpt_restore_failed"):
            verify_failures.extend(ev.get(kind, []))
        for kind in ("data_retry", "data_skipped_records"):
            data_events.extend(ev.get(kind, []))
        anomalies.extend(ev.get("obs_anomaly", []))
    injected_at: dict[str, set] = {}
    for i in injections:
        injected_at.setdefault(i.get("kind", "?"), set()).add(i.get("step"))

    def fault_row(kind: str, step: Any, injected: bool, detail: str) -> dict:
        return {"kind": kind, "step": step, "injected": injected, "detail": detail}

    faults: list[dict] = []
    seen_anomaly_steps = set()
    for a in anomalies:
        key = (a.get("step"), a.get("code"))
        if key in seen_anomaly_steps:
            continue  # one fault per (step, code), however many ranks logged it
        seen_anomaly_steps.add(key)
        faults.append(fault_row(f"anomaly:{a.get('code')}", a.get("step"),
                                a.get("step") in injected_at.get("nan_grad", set()),
                                str(a.get("detail", ""))[:120]))
    # a verify failure is injected only when the chaos harness corrupted
    # THAT step
    corrupted_steps = {c.get("step") for c in corrupted if "step" in c}
    seen_ckpt_steps = set()
    for v in verify_failures:
        if v.get("step") in seen_ckpt_steps:
            continue
        seen_ckpt_steps.add(v.get("step"))
        faults.append(fault_row("ckpt_integrity", v.get("step"),
                                v.get("step") in corrupted_steps,
                                str(v.get("detail", v.get("error", "")))[:120]))
    seen_data_steps = set()
    for d in data_events:
        if d.get("event") == "data_retry" and d.get("step") not in seen_data_steps:
            seen_data_steps.add(d.get("step"))
            faults.append(fault_row("data_retry", d.get("step"),
                                    d.get("step") in injected_at.get("data_error", set()),
                                    str(d.get("error", ""))[:120]))
    # a topology change is a fault (a host left) even when the recovery works
    for t in topo_changes:
        faults.append(fault_row(
            "topology_change", t.get("step"),
            t.get("step") in injected_at.get("host_loss", set()),
            f"policy {t.get('policy')}: {t.get('old_mesh')} → {t.get('reason', 'reshard')}"[:120]))
    # a replica dying is a fault; a stall's death trails its injection by
    # the detector's window [since_tick, tick]
    for r in replica_events:
        if r.get("to") != "dead":
            continue
        cause = r.get("cause", "crash")
        tick = r.get("tick")
        if cause == "stall":
            lo = r.get("since_tick", tick)
            injected = any(s is not None and lo is not None and tick is not None and lo <= s <= tick
                           for s in injected_at.get("replica_stall", set()))
        else:
            injected = tick in injected_at.get("replica_crash", set())
        faults.append(fault_row(f"replica_{cause}", tick, injected,
                                f"replica {r.get('replica')}: {str(r.get('reason', ''))}"[:120]))
    organic = [f for f in faults if not f["injected"]]
    rewinds = [r for r in recoveries if r.get("action") == "rewind"]
    # a reshard's wall counts toward MTTR: its restore is the recovery
    mttr_vals = [r["recovery_wall_s"] for r in rewinds
                 if isinstance(r.get("recovery_wall_s"), (int, float))] + [
                 r["reshard_wall_s"] for r in reshards
                 if isinstance(r.get("reshard_wall_s"), (int, float))]
    serving = None
    if replica_events or serve_retries or serve_sheds or router_summaries:
        rs = router_summaries[-1] if router_summaries else {}
        serving = {
            "replica_transitions": [{k: r.get(k) for k in ("replica", "from", "to", "tick",
                                                           "reason", "cause") if k in r}
                                    for r in replica_events],
            "replicas_lost": sum(1 for r in replica_events if r.get("to") == "dead"),
            # failure retries of real traffic only (a drain lost no work, a
            # synthetic storm request's retries are injected load)
            "retries": sum(1 for r in serve_retries
                           if r.get("reason") != "drain" and not r.get("synthetic")),
            "redispatches": len(serve_retries),
            "shed": sum(1 for r in serve_sheds if not r.get("synthetic")),
            "shed_total": len(serve_sheds),
            "shed_by_reason": rs.get("shed_by_reason"),
            "request_mttr_s": rs.get("request_mttr_s"),
            "request_retry_rate": rs.get("request_retry_rate"),
            "goodput_frac": rs.get("goodput_frac"),
            "requests": rs.get("requests"),
            "completed": rs.get("completed"),
        }
    return {
        "injections": [{"kind": i.get("kind"), "step": i.get("step")} for i in injections],
        "actions": [{k: r.get(k) for k in ("action", "step", "code", "restored_step",
                                           "steps_lost", "rewind_index", "recovery_wall_s",
                                           "reason") if k in r} for r in recoveries],
        "quarantines": [{k: q.get(k) for k in ("epoch", "epoch_step", "reason") if k in q}
                        for q in quarantines],
        "topology": [{k: t.get(k) for k in ("step", "policy", "old_mesh", "old_processes",
                                            "reason") if k in t} for t in topo_changes],
        "reshards": [{k: r.get(k) for k in ("step", "detected_at_step", "old_mesh", "new_mesh",
                                            "old_processes", "new_processes", "ef_mode",
                                            "steps_lost", "reshard_wall_s") if k in r}
                     for r in reshards],
        "rewinds": len(rewinds),
        "steps_lost_total": sum(int(r.get("steps_lost", 0) or 0) for r in rewinds)
        + sum(int(r.get("steps_lost", 0) or 0) for r in reshards),
        "mttr_s": round(sum(mttr_vals) / len(mttr_vals), 4) if mttr_vals else None,
        "serving": serving,
        "host_loss_suspects": [{k: s.get(k) for k in ("rank", "step", "consecutive_beats")
                                if k in s} for s in suspects],
        "faults": faults,
        "organic_faults": organic,
    }


def loadgen_report(processes: dict[int, list[dict]]) -> dict[str, Any] | None:
    """The open-loop load sweep: the curve (a row a grid point) and the
    knee, from ``loadgen_point`` / ``loadgen_summary`` events; the newest
    summary is authoritative (bare points, a sweep cut short, still
    render).  ``best_slo_attainment`` and ``best_ttft_p99_ms`` are the
    gates' inputs: the best attainment of any point and the lowest measured
    p99 TTFT (a point where nothing finished measures None and is left
    out, so a sweep whose every point collapsed has no p99 and the gate
    fails it)."""
    points: list[dict] = []
    summaries: list[dict] = []
    for _, records in sorted(processes.items()):
        ev = _by_event(records)
        points.extend(ev.get("loadgen_point", []))
        summaries.extend(ev.get("loadgen_summary", []))
    if not points and not summaries:
        return None
    summary = summaries[-1] if summaries else None
    curve = list((summary or {}).get("points") or points)
    attains = [p["slo_attainment"] for p in curve
               if isinstance(p.get("slo_attainment"), (int, float))]
    p99s = [p["ttft_p99_ms"] for p in curve if isinstance(p.get("ttft_p99_ms"), (int, float))]
    meta = summary or (points[-1] if points else {})
    return {
        "process": meta.get("process"),
        "seed": meta.get("seed"),
        "ttft_slo_ms": meta.get("ttft_slo_ms"),
        "requests_per_point": (summary or {}).get("requests_per_point"),
        "qps_grid": (summary or {}).get("qps_grid"),
        "knee_qps": (summary or {}).get("knee_qps"),
        "sweeps": len(summaries),
        "points": curve,
        "best_slo_attainment": max(attains) if attains else None,
        "best_ttft_p99_ms": min(p99s) if p99s else None,
    }


def _serving_ledger(processes: dict[int, list[dict]], flag: str,
                    window_key: str) -> tuple[list[dict], list[dict], int]:
    """The ``serve_summary`` events whose engine ran with ``flag`` on, the
    ``router_summary`` events that carry ``window_key`` (the router's
    cross-replica aggregate), and the count of serve windows that carry
    ``window_key``."""
    serve: list[dict] = []
    router: list[dict] = []
    windows = 0
    for _, records in sorted(processes.items()):
        ev = _by_event(records)
        serve.extend(r for r in ev.get("serve_summary", []) if r.get(flag))
        router.extend(r for r in ev.get("router_summary", []) if window_key in r)
        windows += sum(1 for r in ev.get("serve_window", []) if window_key in r)
    return serve, router, windows


def prefix_report(processes: dict[int, list[dict]]) -> dict[str, Any] | None:
    """The prefix-cache rollup: the router's cross-replica aggregate when a
    ``router_summary`` carries one (``scope`` "router": a replica's own
    summary sees only its traffic), else the last ``serve_summary`` of an
    engine run with the cache on (``scope`` "engine").  ``hit_rate`` is the
    ``--min-prefix-hit-rate`` gate's input: None when neither exists,
    which the gate fails."""
    serve, router, windows = _serving_ledger(processes, "prefix_cache", "prefix_hit_rate")
    if not (serve or router):
        return None
    src = router[-1] if router else serve[-1]
    latest = serve[-1] if serve else {}
    return {
        "scope": "router" if router else "engine",
        "hit_rate": src.get("prefix_hit_rate"),
        "lookups": src.get("prefix_lookups"),
        "hits": src.get("prefix_hits"),
        "prefill_tokens_total": src.get("prefill_tokens_total"),
        "prefill_tokens_saved": src.get("prefill_tokens_saved"),
        "prefill_tokens_saved_frac": src.get("prefill_tokens_saved_frac"),
        "budget_gib": latest.get("prefix_cache_budget_gib"),
        "pool_blocks_warm": latest.get("pool_blocks_warm"),
        "warm_bytes": latest.get("warm_bytes"),
        "windows": windows,
        "engines": len(serve),
    }


def spec_report(processes: dict[int, list[dict]]) -> dict[str, Any] | None:
    """The speculative-decode rollup, scoped as ``prefix_report``.
    ``acceptance_rate`` is the ``--min-acceptance-rate`` gate's input: None
    when no spec-enabled engine or router summarized, which the gate
    fails."""
    serve, router, windows = _serving_ledger(processes, "spec_decode", "acceptance_rate")
    if not (serve or router):
        return None
    src = router[-1] if router else serve[-1]
    latest = serve[-1] if serve else {}
    return {
        "scope": "router" if router else "engine",
        "acceptance_rate": src.get("acceptance_rate"),
        "accepted_tokens_per_step": src.get("accepted_tokens_per_step"),
        "drafted_tokens": src.get("spec_drafted_tokens"),
        "accepted_tokens": src.get("spec_accepted_tokens"),
        "spec_tokens": latest.get("spec_tokens", src.get("spec_tokens")),
        "draft_model": latest.get("spec_draft_model"),
        "spec_steps": latest.get("spec_steps"),
        "windows": windows,
        "engines": len(serve),
    }


def build_report(output_dir: str) -> dict[str, Any]:
    run = load_run(output_dir)
    processes = run["processes"]
    return {
        "output_dir": output_dir,
        "schema_version": SCHEMA_VERSION,
        "processes": sorted(processes),
        "records": sum(len(r) for r in processes.values()),
        "schema_errors": run["errors"],
        "timeline": merge_timeline(processes),
        "trends": window_trends(processes),
        "stragglers": straggler_attribution(processes),
        "comm": comm_report(processes),
        "budget": budget_report(processes),
        "device": device_report(processes),
        "memory": memory_report(processes, run["postmortems"]),
        "loadgen": loadgen_report(processes),
        "prefix": prefix_report(processes),
        "spec": spec_report(processes),
        "recovery": recovery_report(processes),
        "anomalies": [r for records in processes.values()
                      for r in _by_event(records).get("obs_anomaly", [])],
        "recorders": {str(p): {"reason": b.get("reason"), "step": b.get("step"),
                               "steps_recorded": len(b.get("entries", [])),
                               "anomalies": b.get("anomalies", [])}
                      for p, b in run["recorders"].items()},
    }


def _fmt(v: Any) -> str:
    if isinstance(v, float):
        return f"{v:.4g}"
    return "" if v is None else str(v)


def render_markdown(report: dict[str, Any], *, last: int = 20) -> str:
    lines: list[str] = []
    add = lines.append
    add(f"# obs report — {report['output_dir']}")
    add("")
    add(f"processes: {report['processes'] or 'none'} · records: {report['records']} · "
        f"schema errors: {len(report['schema_errors'])}")
    for e in report["schema_errors"][:10]:
        add(f"- schema error: {e}")
    timeline = report["timeline"]
    add("")
    add(f"## Step timeline ({len(timeline)} steps with events; last {last} shown)")
    add("")
    add("| step | loss | val_loss | p50/p95 ms by rank | skew | anomalies |")
    add("|---|---|---|---|---|---|")
    for row in timeline[-last:]:
        winfmt = " ".join(f"r{p}:{_fmt(w['p50'])}/{_fmt(w['p95'])}"
                          + ("!" if w.get("straggler") else "")
                          for p, w in sorted(row.get("windows", {}).items()))
        hb = row.get("heartbeat") or {}
        anom = "; ".join(f"{a.get('code')}@ranks{a.get('ranks')}"
                         for a in row.get("anomalies", []))
        add(f"| {row['step']} | {_fmt(row.get('loss'))} | "
            f"{_fmt((row.get('eval') or {}).get('val_loss'))} | {winfmt} | "
            f"{_fmt(hb.get('skew_steps'))} | {anom} |")
    add("")
    add("## Trends (window p50/p95 ms)")
    for proc, ws in report["trends"].items():
        if not ws:
            continue
        first, final = ws[0], ws[-1]
        add(f"- rank {proc}: p50 {_fmt(first['p50'])} → {_fmt(final['p50'])}, "
            f"p95 {_fmt(first['p95'])} → {_fmt(final['p95'])} over {len(ws)} windows"
            + (f", last mfu {_fmt(final['mfu'])}" if final.get("mfu") is not None else ""))
    s = report["stragglers"]
    add("")
    add("## Straggler attribution")
    add(f"- max heartbeat skew: {s['max_skew_steps']} steps; max arrival spread: "
        f"{_fmt(s['max_arrival_spread_s'])} s")
    if s["heartbeat_laggard_counts"]:
        for rank, n in s["heartbeat_laggard_counts"].items():
            add(f"- rank {rank}: named laggard in {n} heartbeat(s)")
    else:
        add("- no laggards named by any heartbeat")
    if s["mean_step_ms_p95_by_rank"]:
        add("- mean window p95 by rank: " + ", ".join(
            f"r{k}={_fmt(v)}ms" for k, v in s["mean_step_ms_p95_by_rank"].items()))
    budget = report.get("budget")
    add("")
    add("## Where did the time go")
    if budget is None:
        add("- no step_budget records (run without --obs-budget?)")
    else:
        add(f"- dispatch efficiency (wall-weighted, all ranks): "
            f"{_fmt(budget['dispatch_efficiency'])}")
        add("")
        add(f"| rank | windows | wall ms | {' | '.join(COMPONENTS)} | efficiency |")
        add("|---" * (len(COMPONENTS) + 4) + "|")
        for rank, agg in sorted(budget["ranks"].items()):
            comps = " | ".join(_fmt(agg.get(f"{c}_ms")) for c in COMPONENTS)
            add(f"| {rank} | {agg['windows']} | {_fmt(agg['wall_ms'])} | {comps} | "
                f"{_fmt(agg['dispatch_efficiency'])} |")
        opt_rows = [(rank, agg) for rank, agg in sorted(budget["ranks"].items())
                    if agg.get("optimizer_apply_ms") is not None]
        if opt_rows:
            add("optimizer apply (cadenced stand-alone sample): " + ", ".join(
                f"r{rank}={_fmt(agg['optimizer_apply_ms'])}ms"
                + (f" ({_fmt(agg['optimizer_share_of_step'] * 100)}% of step)"
                   if agg.get("optimizer_share_of_step") is not None else "")
                for rank, agg in opt_rows))
        add("")
        add("worst offenders (host-stall components, share of total wall):")
        for o in budget["offenders"]:
            add(f"- {o['component']}: {_fmt(o['total_ms'])} ms ({_fmt(o['share'] * 100)}% of wall)")
        if budget["incidents"]:
            add("")
            add("**off-cadence host-blocking dispatch incidents** (a step body waited on "
                "the card outside the logging window):")
            for inc in budget["incidents"]:
                add(f"- rank {inc['rank']} window@step {inc['step']}: "
                    f"{inc['blocked_steps']}/{inc['window_steps']} step(s) blocked in dispatch "
                    f"({_fmt(inc['dispatch_ms'])} ms total)")
        else:
            add("- no off-cadence host-blocking dispatch detected")
        for rank, ws in sorted(budget["windows"].items()):
            shown = ws[-last:]
            if not shown:
                continue
            first, final = shown[0], shown[-1]
            add(f"- rank {rank} windows: efficiency {_fmt(first['dispatch_efficiency'])} → "
                f"{_fmt(final['dispatch_efficiency'])}, accounted "
                f"{_fmt(final['accounted_frac'])} of wall over {len(ws)} window(s)")
    _render_device(add, report.get("device"))
    _render_comm(add, report.get("comm"))
    _render_memory(add, report.get("memory"))
    _render_loadgen(add, report.get("loadgen"))
    _render_serving(add, report.get("prefix"), report.get("spec"))
    rec = report.get("recovery") or {}
    add("")
    add("## Recovery timeline")
    if rec.get("injections"):
        add("- chaos injections: " + ", ".join(f"{i['kind']}@{i['step']}"
                                                for i in rec["injections"]))
    for a in rec.get("actions", []):
        if a.get("action") == "rewind":
            add(f"- **rewind** {a.get('rewind_index')}: anomaly [{a.get('code')}] at step "
                f"{a.get('step')} → restored step {a.get('restored_step')} "
                f"({a.get('steps_lost')} steps lost, {_fmt(a.get('recovery_wall_s'))} s)")
        else:
            add(f"- **{a.get('action')}**: anomaly [{a.get('code')}] at step {a.get('step')} — "
                f"{a.get('reason', '')}")
    for t in rec.get("topology", []):
        add(f"- **topology change** at step {t.get('step')} (policy {t.get('policy')}): mesh "
            f"was {t.get('old_mesh')} over {t.get('old_processes')} process(es)"
            + (f" — {t['reason']}" if t.get("reason") else ""))
    for r in rec.get("reshards", []):
        add(f"- **reshard restore**: step {r.get('step')} re-laid "
            f"{r.get('old_mesh')}×{r.get('old_processes')}p → "
            f"{r.get('new_mesh')}×{r.get('new_processes')}p (ef {r.get('ef_mode')}, "
            f"{r.get('steps_lost', 0)} steps lost, {_fmt(r.get('reshard_wall_s'))} s)")
    for q in rec.get("quarantines", []):
        add(f"- quarantined batch (epoch {q.get('epoch')}, epoch_step {q.get('epoch_step')}): "
            f"{q.get('reason', '')}")
    if rec.get("rewinds"):
        add(f"- {rec['rewinds']} rewind(s), {rec['steps_lost_total']} optimizer steps lost, "
            f"MTTR {_fmt(rec.get('mttr_s'))} s")
    serving = rec.get("serving")
    if serving:
        for t in serving.get("replica_transitions", []):
            add(f"- **replica {t.get('replica')}** {t.get('from')} → {t.get('to')} at tick "
                f"{t.get('tick')}" + (f" [{t['cause']}]" if t.get("cause") else "")
                + f": {t.get('reason', '')}")
        add(f"- serving tier: {serving.get('replicas_lost', 0)} replica(s) lost, "
            f"{serving.get('retries', 0)} request retr"
            f"{'y' if serving.get('retries', 0) == 1 else 'ies'}, {serving.get('shed', 0)} shed "
            f"({serving.get('shed_by_reason') or {}}), request MTTR "
            f"{_fmt(serving.get('request_mttr_s'))} s, retry rate "
            f"{_fmt(serving.get('request_retry_rate'))}, goodput frac "
            f"{_fmt(serving.get('goodput_frac'))}")
    for sus in rec.get("host_loss_suspects", []):
        add(f"- **host_loss_suspect**: rank {sus.get('rank')} named laggard "
            f"{sus.get('consecutive_beats')} consecutive heartbeat(s) by step {sus.get('step')} "
            "(detection only — go look at that host)")
    injected = [f for f in rec.get("faults", []) if f["injected"]]
    organic = rec.get("organic_faults", [])
    if not rec.get("faults"):
        add("- no faults observed")
    else:
        add(f"- faults: {len(injected)} injected, {len(organic)} organic")
        for f in organic:
            add(f"  - **organic** {f['kind']} at step {f['step']}: {f['detail']}")
    add("")
    add(f"## Anomalies ({len(report['anomalies'])})")
    for a in report["anomalies"]:
        add(f"- step {a.get('step')} [{a.get('code')}] ranks {a.get('ranks')} policy "
            f"{a.get('policy')}: {a.get('detail', '')}")
    for proc, r in report["recorders"].items():
        add(f"- flight recorder p{proc}: reason {r['reason']!r} at step {r['step']}, "
            f"{r['steps_recorded']} steps recorded")
    return "\n".join(lines) + "\n"


def _render_device(add, device: dict | None) -> None:
    from distributed_llms_example_tpu_torch.obs.devprof import DEVICE_BUCKETS

    add("")
    add("## Device account (profiled windows)")
    if device is None:
        add("- no device_account records (no profile window landed — "
            "touch the profile trigger or pass --profile-steps)")
        return
    for cap in device["captures"]:
        add(f"- capture r{cap['rank']}: steps {cap.get('window')} → `{cap.get('path')}`"
            + (" (truncated)" if cap.get("truncated") else ""))
    if not device["ranks"]:
        add("- captures exist but no device_account parsed — run with "
            "--obs-budget on, or parse offline: python -m "
            "distributed_llms_example_tpu_torch.obs.devprof <capture_dir>")
        return
    add("")
    add("| rank | window | span ms | busy ms | idle ms | " + " | ".join(DEVICE_BUCKETS) + " |")
    add("|---" * (len(DEVICE_BUCKETS) + 5) + "|")
    for rank, acct in sorted(device["ranks"].items()):
        b = acct.get("buckets_ms", {})
        cells = " | ".join(_fmt(b.get(k)) for k in DEVICE_BUCKETS)
        add(f"| {rank} | {acct.get('window')} | {_fmt(acct.get('span_ms'))} | "
            f"{_fmt(acct.get('busy_ms'))} | {_fmt(acct.get('exposed_idle_ms'))} | {cells} |")
    add("")
    add("collective bandwidth (measured device time × static byte account):")
    any_coll = False
    for rank, acct in sorted(device["ranks"].items()):
        for op, slot in sorted((acct.get("collectives") or {}).items()):
            any_coll = True
            bw = slot.get("achieved_bytes_per_sec")
            add(f"- r{rank} {op}: ×{slot.get('count')} — {_fmt(slot.get('time_ms'))} ms"
                + (f", {slot.get('bytes_per_step', 0):,} B/step → {bw / 1e6:.1f} MB/s achieved"
                   if isinstance(bw, (int, float)) else ""))
    if not any_coll:
        add("- no collective device time in the captured window")
    for rank, acct in sorted(device["ranks"].items()):
        ov = acct.get("overlap") or {}
        if not ov:
            continue
        frac = ov.get("overlap_frac")
        add(f"- r{rank} overlap: collective {_fmt(ov.get('collective_ms'))} ms, "
            f"compute {_fmt(ov.get('compute_ms'))} ms, "
            f"overlapped {_fmt(ov.get('overlapped_ms'))} ms"
            + (f" (overlap_frac {_fmt(frac)})" if frac is not None else "")
            + f", exposed collective {_fmt(ov.get('exposed_collective_ms'))} ms, "
            f"exposed idle {_fmt(acct.get('exposed_idle_ms'))} ms")


def _render_comm(add, comm: dict | None) -> None:
    add("")
    add("## Comm account")
    if comm is None:
        add("- no obs_gauges record (run without --obs-gauges?)")
        return
    acct = comm["comm"]
    add(f"- total {acct.get('total_bytes', 0):,} B/step — gradient "
        f"{acct.get('gradient_bytes', 0):,} B, activation "
        f"{acct.get('activation_bytes', 0):,} B (mesh {comm.get('mesh')})")
    for op, slot in sorted(acct.items()):
        if isinstance(slot, dict):
            add(f"  - {op}: ×{slot.get('count')} — grad {slot.get('gradient_bytes', 0):,} B, "
                f"act {slot.get('activation_bytes', 0):,} B")
    if "reduce_scatter_smell" in comm:
        add(f"- **smell**: {comm['reduce_scatter_smell'].get('message')}")


def _render_memory(add, mem: dict | None) -> None:
    if mem is None:
        return
    add("")
    add("## Where did the bytes go")
    acct = mem.get("account")
    if acct is not None:
        add(f"- static account (model {acct.get('model')}, mesh {acct.get('mesh')}): "
            f"compiled peak {int(acct.get('peak_bytes', 0)):,} B "
            f"({_fmt(acct.get('peak_gib'))} GiB) vs budget {_fmt(acct.get('hbm_budget_gib'))} GiB — "
            + ("fits" if acct.get("fits_budget") else "**OVER BUDGET**")
            + f" (headroom {_fmt(acct.get('hbm_headroom_gib'))} GiB, "
            f"additivity gap {int(acct.get('additivity_gap_bytes', 0)):,} B)")
        add("")
        add("| bucket | bytes | GiB | share of peak |")
        add("|---|---|---|---|")
        peak = max(1, int(acct.get("peak_bytes", 0)))
        for bucket, b in sorted((acct.get("buckets_bytes") or {}).items(), key=lambda kv: -kv[1]):
            add(f"| {bucket} | {int(b):,} | {b / 1024**3:.3f} | {b / peak:.1%} |")
        add("")
        for row in (acct.get("largest_buffers") or [])[:8]:
            add(f"- {row.get('name')}: {int(row.get('bytes', 0)):,} B "
                f"(shard {row.get('shard_shape')} {row.get('dtype')}"
                + (f", module {row['module']}" if row.get("module") else "") + ")")
    sa = mem.get("serve_account")
    if sa is not None:
        buckets = sa.get("buckets_bytes") or {}
        add(f"- serving account: params {int(buckets.get('params', 0)):,} B"
            f" + kv_cache {int(buckets.get('kv_cache', 0)):,} B = "
            f"{int(sa.get('peak_bytes', 0)):,} B vs budget {_fmt(sa.get('hbm_budget_gib'))} GiB — "
            + ("fits" if sa.get("fits_budget") else "**OVER BUDGET**"))
    rt = mem.get("runtime")
    if rt is not None:
        add(f"- runtime ({rt.get('windows')} memory_window samples): bytes in use ≤ "
            f"{rt.get('max_bytes_in_use', 0):,} B, process peak {rt.get('peak_bytes_in_use', 0):,} B, "
            f"largest per-window watermark delta {rt.get('max_watermark_delta_bytes', 0):,} B")
    elif mem.get("static_only"):
        reason = (mem.get("skips") or [None])[0]
        add("- runtime: static-only" + (f" — {reason}" if reason else ""))
    for p, b in sorted((mem.get("postmortems") or {}).items()):
        add(f"- **OOM postmortem** p{p} at step {b.get('step')}: {b.get('reason')} "
            f"({b.get('watermark_samples')} watermark samples, account "
            + ("attached" if b.get("has_account") else "absent") + ")")


def _render_loadgen(add, lg: dict | None) -> None:
    if lg is None:
        return
    add("")
    add("## Open-loop load sweep")
    knee = lg.get("knee_qps")
    add(f"- process={lg.get('process')} seed={lg.get('seed')} "
        f"slo={_fmt(lg.get('ttft_slo_ms'))}ms requests/point={lg.get('requests_per_point')} "
        "— knee: " + (f"**{_fmt(knee)} QPS** (first saturated offered rate)"
                      if knee is not None else "not reached on this grid"))
    add("")
    add("| offered QPS | achieved | goodput | SLO attain | ttft p50 ms | p95 | p99 "
        "| qdelay p99 ms | growing | shed | unfinished |")
    add("|---" * 11 + "|")
    for pt in lg.get("points", []):
        add(f"| {_fmt(pt.get('offered_qps'))} | {_fmt(pt.get('achieved_qps'))} | "
            f"{_fmt(pt.get('goodput_qps'))} | {_fmt(pt.get('slo_attainment'))} | "
            f"{_fmt(pt.get('ttft_p50_ms'))} | {_fmt(pt.get('ttft_p95_ms'))} | "
            f"{_fmt(pt.get('ttft_p99_ms'))} | {_fmt(pt.get('queue_delay_p99_ms'))} | "
            f"{'yes' if pt.get('queue_growing') else ''} | {_fmt(pt.get('shed'))} | "
            f"{_fmt(pt.get('unfinished'))} |")


def _render_serving(add, px: dict | None, sp: dict | None) -> None:
    if px is not None:
        add("")
        add("## Prefix cache")
        add(f"- scope={px.get('scope')} engines={px.get('engines')} "
            f"budget={_fmt(px.get('budget_gib'))} GiB — hit rate: "
            f"**{_fmt(px.get('hit_rate'))}** "
            f"({_fmt(px.get('hits'))}/{_fmt(px.get('lookups'))} lookups)")
        add(f"- prefill tokens saved: {_fmt(px.get('prefill_tokens_saved'))}"
            f"/{_fmt(px.get('prefill_tokens_total'))} "
            f"({_fmt(px.get('prefill_tokens_saved_frac'))} of all prefill) — "
            f"warm set {_fmt(px.get('pool_blocks_warm'))} blocks / "
            f"{_fmt(px.get('warm_bytes'))} bytes at last summary")
    if sp is not None:
        add("")
        add("## Speculative decode")
        add(f"- scope={sp.get('scope')} engines={sp.get('engines')} "
            f"k={_fmt(sp.get('spec_tokens'))} "
            f"draft={_fmt(sp.get('draft_model'))} — accepted tokens per "
            f"step: **{_fmt(sp.get('accepted_tokens_per_step'))}** "
            "(plain decode = 1.0)")
        add(f"- draft acceptance: {_fmt(sp.get('accepted_tokens'))}"
            f"/{_fmt(sp.get('drafted_tokens'))} proposals "
            f"(rate {_fmt(sp.get('acceptance_rate'))}) over "
            f"{_fmt(sp.get('spec_steps'))} verify rounds")


def _strict_gates(report: dict, args) -> int:
    """The gates ``--strict`` was given: 1 where one fails or has nothing to
    read (a missing measurement never reads as a pass), else 0."""
    rc = 0

    def failed(msg: str) -> None:
        nonlocal rc
        print(f"strict: {msg}", file=sys.stderr)
        rc = 1

    floor = args.min_dispatch_efficiency
    if floor > 0:
        eff = report["budget"]["dispatch_efficiency"] if report["budget"] else None
        if eff is None:
            failed("--min-dispatch-efficiency set but no step_budget records found")
        elif eff < floor:
            failed(f"dispatch_efficiency {eff} below the {floor} floor")
    mem = report.get("memory")
    if args.max_peak_hbm_frac > 0:
        frac = (mem or {}).get("peak_frac_of_budget")
        if frac is None:
            failed("--max-peak-hbm-frac set but no memory measurement found (no memory_window "
                   "samples and no memory_account)")
        elif frac > args.max_peak_hbm_frac:
            failed(f"HBM peak at {frac} of the budget (source: "
                   f"{(mem or {}).get('measured_peak_source')}) exceeds the "
                   f"{args.max_peak_hbm_frac} ceiling")
    if args.min_hbm_headroom_gib > 0:
        headroom = (mem or {}).get("min_headroom_gib")
        if headroom is None:
            failed("--min-hbm-headroom-gib set but no memory account found")
        elif headroom < args.min_hbm_headroom_gib:
            failed(f"hbm_headroom_gib {headroom} below the {args.min_hbm_headroom_gib} GiB floor")
    if args.min_overlap_frac > 0:
        device = report.get("device")
        if device is None or not device["ranks"]:
            failed("--min-overlap-frac set but no device_account records found"
                   + (f" ({len(device['captures'])} profile capture(s) landed without one)"
                      if device is not None else ""))
        else:
            for rank, acct in sorted(device["ranks"].items()):
                frac = (acct.get("overlap") or {}).get("overlap_frac")
                if frac is not None and frac < args.min_overlap_frac:
                    failed(f"rank {rank} overlap_frac {frac} below the "
                           f"{args.min_overlap_frac} floor (exposed collective time)")
    serving = report["recovery"].get("serving")
    if args.max_request_retry_rate >= 0:
        rate = (serving or {}).get("request_retry_rate")
        if rate is None:
            failed("--max-request-retry-rate set but no router_summary found (a serve-router "
                   "run is needed) — a missing measurement must never read as a pass")
        elif rate > args.max_request_retry_rate:
            failed(f"request_retry_rate {rate} exceeds the {args.max_request_retry_rate} "
                   "ceiling — the pool is retry-storming (dying replicas, or a deadline or "
                   "backoff too tight)")
    if args.min_serve_goodput_frac > 0:
        frac = (serving or {}).get("goodput_frac")
        if frac is None:
            failed("--min-serve-goodput-frac set but no router_summary found (a serve-router "
                   "run is needed) — a missing measurement must never read as a pass")
        elif frac < args.min_serve_goodput_frac:
            failed(f"goodput_frac {frac} below the {args.min_serve_goodput_frac} floor — "
                   "requests are shed or miss the TTFT SLO")
    lg = report.get("loadgen")
    if args.min_slo_attainment > 0:
        best = (lg or {}).get("best_slo_attainment")
        if best is None:
            failed("--min-slo-attainment set but no loadgen measurement found (run "
                   "serve-loadgen) — a missing measurement must never read as a pass")
        elif best < args.min_slo_attainment:
            failed(f"best per-point slo_attainment {best} below the {args.min_slo_attainment} "
                   "floor — no offered rate on the sweep grid meets the SLO")
    if args.max_p99_ttft_ms > 0:
        best = (lg or {}).get("best_ttft_p99_ms")
        if best is None:
            failed("--max-p99-ttft-ms set but no measured p99 TTFT found (no loadgen run, or "
                   "nothing finished at any offered rate) — a missing measurement must never "
                   "read as a pass")
        elif best > args.max_p99_ttft_ms:
            failed(f"best per-point p99 TTFT {best} ms exceeds the {args.max_p99_ttft_ms} ms "
                   "ceiling at every offered rate on the sweep grid")
    if args.min_prefix_hit_rate > 0:
        rate = (report.get("prefix") or {}).get("hit_rate")
        if rate is None:
            failed("--min-prefix-hit-rate set but no prefix-enabled serve_summary found (run "
                   "with --prefix-cache on a paged engine) — a missing measurement must never "
                   "read as a pass")
        elif rate < args.min_prefix_hit_rate:
            failed(f"prefix_hit_rate {rate} below the {args.min_prefix_hit_rate} floor — the "
                   "workload is not sharing prefixes or the warm budget is too small")
    if args.min_acceptance_rate > 0:
        rate = (report.get("spec") or {}).get("acceptance_rate")
        if rate is None:
            failed("--min-acceptance-rate set but no spec-enabled serve_summary found (run "
                   "with --spec-tokens > 0) — a missing measurement must never read as a pass")
        elif rate < args.min_acceptance_rate:
            failed(f"acceptance_rate {rate} below the {args.min_acceptance_rate} floor — the "
                   "drafter is mispredicting this workload (try a draft model, fewer "
                   "--spec-tokens, or a more repetitive mix)")
    return rc


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(prog="python -m distributed_llms_example_tpu_torch.obs.report",
                                description="read a run's --obs jsonl telemetry")
    p.add_argument("output_dir", help="a run's --output-dir (containing obs/)")
    p.add_argument("--json", action="store_true", help="emit the full report as JSON")
    p.add_argument("--last", type=int, default=20, help="timeline rows to render")
    p.add_argument("--strict", action="store_true",
                   help="nonzero exit on any schema-invalid line OR any ORGANIC fault (one no "
                        "chaos_injection event explains) — a chaos run is green only when "
                        "every fault it saw is one it caused — OR a wall-weighted "
                        "dispatch_efficiency below --min-dispatch-efficiency")
    p.add_argument("--min-dispatch-efficiency", type=float, default=0.0,
                   help="with --strict: fail when the run's wall-weighted dispatch_efficiency "
                        "(step_budget events) falls below this floor (0 = no floor)")
    p.add_argument("--min-overlap-frac", type=float, default=0.0,
                   help="with --strict: fail when a rank's device_account shows collective "
                        "time with overlap_frac below this floor, or when no device_account "
                        "exists (0 = no floor)")
    p.add_argument("--max-peak-hbm-frac", type=float, default=0.0,
                   help="with --strict: fail when the measured peak (memory_window, else the "
                        "static account's) exceeds this fraction of --hbm-budget-gib, or when "
                        "no memory measurement exists (0 = off)")
    p.add_argument("--min-hbm-headroom-gib", type=float, default=0.0,
                   help="with --strict: fail when a memory account's hbm_headroom_gib falls "
                        "below this floor, or when none exists (0 = off)")
    p.add_argument("--max-request-retry-rate", type=float, default=-1.0,
                   help="with --strict: fail when the router's request_retry_rate "
                        "(router_summary) exceeds this ceiling, or when no router_summary "
                        "exists (-1 = off; 0 is a ceiling: any retry fails)")
    p.add_argument("--min-serve-goodput-frac", type=float, default=0.0,
                   help="with --strict: fail when the router's goodput_frac (requests "
                        "completed within the TTFT SLO over requests submitted) falls below "
                        "this floor, or when no router_summary exists (0 = off)")
    p.add_argument("--min-slo-attainment", type=float, default=0.0,
                   help="with --strict: fail when the load sweep's best per-point "
                        "slo_attainment falls below this floor, or when no loadgen "
                        "measurement exists (0 = off)")
    p.add_argument("--max-p99-ttft-ms", type=float, default=0.0,
                   help="with --strict: fail when the load sweep's lowest measured "
                        "per-point p99 TTFT exceeds this ceiling, or when no point measured "
                        "one (0 = off)")
    p.add_argument("--min-prefix-hit-rate", type=float, default=0.0,
                   help="with --strict: fail when the prefix cache's hit rate (the router "
                        "aggregate, else the last prefix-enabled serve_summary's) falls below this "
                        "floor, or when no such summary exists (0 = off)")
    p.add_argument("--min-acceptance-rate", type=float, default=0.0,
                   help="with --strict: fail when speculative decode's draft acceptance rate "
                        "(the router aggregate, else the last spec-enabled serve_summary's) "
                        "falls below this floor, or "
                        "when no such summary exists (0 = off)")
    p.add_argument("--trace", type=str, default="",
                   help="also export the merged Chrome-trace/Perfetto JSON here (every "
                        "rank's spans aligned on shared step boundaries, budget counters, "
                        "device lanes of profiled windows) — open at ui.perfetto.dev")
    args = p.parse_args(argv)
    if not os.path.isdir(os.path.join(args.output_dir, "obs")):
        print(f"no obs/ directory under {args.output_dir}", file=sys.stderr)
        return 2
    report = build_report(args.output_dir)
    if args.json:
        print(json.dumps(report))
    else:
        print(render_markdown(report, last=args.last), end="")
    if args.trace:
        from distributed_llms_example_tpu_torch.obs.trace import export_chrome_trace

        summary = export_chrome_trace(args.output_dir, args.trace)
        print(f"trace: {summary['events']} events from ranks {summary['ranks']} → "
              f"{summary['path']}", file=sys.stderr)
    if not args.strict:
        return 0
    rc = 1 if report["schema_errors"] or report["recovery"]["organic_faults"] else 0
    return max(rc, _strict_gates(report, args))


if __name__ == "__main__":
    sys.exit(main())
