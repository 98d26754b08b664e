"""Device-time attribution (port of the JAX package's ``obs/devprof.py``):
a ``torch.profiler`` capture reduced to a per-module device account.

The budget (``obs/budget.py``) closes every log window into an additive
host account whose ``device_busy`` and ``dispatch`` cannot say what the
card did.  This module opens the card's side: a pure-Python reader of the
Chrome trace that ``obs/profile.py`` writes, reducing its device events
into the **device account**:

- **per-bucket device time**: every device op goes to a module bucket
  (embed / attn / mlp / head, the port's copy of the JAX package's
  ``MODULE_BUCKET_PATTERNS``, ``train/step.py``), to ``optimizer`` (kernel
  8's gradient pass and AdamW), ``collective`` (NCCL kernels), ``infeed``
  (memcpy and memset) or ``other`` (the loss, casts outside a module);
- **per-collective-op time**, joined against ``obs/gauges.py``'s byte
  account (``join_collective_bandwidth``) into achieved bytes/s;
- **overlap / exposed idle**: interval arithmetic over the merged
  collective and compute timelines.

The arithmetic (``build_account``, the interval helpers,
``join_collective_bandwidth``) is the JAX package's: over the same
normalized events the two accounts are equal key for key.  What differs
is how a torch trace names a device op's module:

- the scopes are ``torch.profiler.record_function`` ranges named
  ``SCOPE_PREFIX`` + a module path, which ``open_module_scopes`` opens
  around the forward of a model's blocks' children, its embeddings and its
  head, and ``train/step.py`` around ``optimizer_apply_block``, for the
  length of a capture only (``obs/profile.py``: no step outside a capture
  pays for the hooks, and no other profiler sees the scopes);
- on CUDA the device ops are the ``kernel``, ``gpu_memcpy`` and
  ``gpu_memset`` events; each is placed by its launch, the runtime event
  (``cudaLaunchKernel``, ...) of the same ``correlation`` id, on the
  thread that made it: that holds for the port's own kernels, launched
  through ctypes rather than as aten ops, as for any other;
- on the CPU, where a trace has no device lanes, the device ops are the
  leaf ``cpu_op`` events (no child op on their thread), placed by their
  own start (the counterpart of the JAX package's ``hlo_op`` events);
- a launch inside a scope on its thread takes that scope's bucket (the
  innermost scope): remat's recompute in the backward opens the same
  scopes again, on the autograd thread, so a recomputed kernel-1 launch
  lands in ``attn``;
- a launch in no scope but inside a backward op (a ``cpu_op`` whose
  ``Fwd thread id`` names a forward thread) is linked through that op's
  ``Sequence number`` to the forward op that made its autograd node (the
  latest forward op of that number before it, outside any backward op)
  and takes the scope of that forward op.

Bucket sums are per-op durations: where streams overlap (FSDP2's
all-gathers on their own streams) they can exceed the busy union.

Offline: ``python -m distributed_llms_example_tpu_torch.obs.devprof
<capture_dir>`` prints the account; at run time ``TrainerObs`` parses each
landed capture into a ``device_account`` event (bulk, local), which
``obs/report.py`` renders from the JSONL alone.
"""

from __future__ import annotations

import argparse
import contextlib
import glob
import gzip
import json
import os
import sys
from typing import Any, Iterable, Mapping

# the device-account buckets, in emission order (the JAX package's)
DEVICE_BUCKETS: tuple[str, ...] = (
    "embed", "attn", "mlp", "head", "optimizer", "collective", "infeed", "other",
)

_INFEED_NAMES = ("infeed", "outfeed", "send", "recv", "send-done", "recv-done")

# cap on the per-bucket lane slices a device_account event carries for the
# Perfetto export; overflow is counted (lane_slices_dropped)
MAX_LANE_SLICES = 512

# the prefix of the port's module scopes among a trace's user annotations
SCOPE_PREFIX = "dllm/"

# scope substrings of the optimizer tail (the JAX package's hints)
_OPTIMIZER_SCOPE_HINTS = (
    "adam", "optax", "optimizer", "opt_state", "fused_optim", "apply_updates",
    "clip_by_global_norm", "weight_decay",
)

# NCCL kernel name fragment -> the JAX package's collective opcode, first
# match wins (ReduceScatter before AllReduce's "Reduce")
_NCCL_OPS = (
    ("allreduce", "all-reduce"), ("allgather", "all-gather"),
    ("reducescatter", "reduce-scatter"), ("alltoall", "all-to-all"),
    ("sendrecv", "collective-permute"), ("broadcast", "collective-broadcast"),
)

_DEVICE_CATS = {"kernel": "kernel", "gpu_memcpy": "memcpy", "gpu_memset": "memset"}
_LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


# ---------------------------------------------------------------------------
# scopes: naming (what the model opens) and classification
# ---------------------------------------------------------------------------


def module_bucket_of(scope: str) -> str | None:
    """The module bucket a scope names (``train/step.py``'s
    ``MODULE_BUCKET_PATTERNS``), or None when it names none."""
    from distributed_llms_example_tpu_torch.train.step import MODULE_BUCKET_PATTERNS

    p = scope.lower()
    for bucket, needles in MODULE_BUCKET_PATTERNS:
        if any(n in p for n in needles):
            return bucket
    return None


def classify_op_scope(scope: str) -> str | None:
    """A scope's device-account class: "optimizer" for the optimizer tail,
    else its module bucket, else None ("other")."""
    p = scope.lower()
    if any(h in p for h in _OPTIMIZER_SCOPE_HINTS):
        return "optimizer"
    return module_bucket_of(p)


def base_collective_op(op: str) -> str | None:
    """"all-reduce-start.1" -> "all-reduce"; None for non-collectives (the
    JAX package's, for HLO instruction names)."""
    base = op.split(".", 1)[0]
    for suffix in ("-start", "-done"):
        if base.endswith(suffix):
            base = base[: -len(suffix)]
    return base if base in (
        "all-gather", "all-reduce", "reduce-scatter", "all-to-all",
        "collective-permute", "collective-broadcast",
    ) else None


def nccl_collective_op(name: str) -> str | None:
    """An NCCL kernel's (``nccl...``) or a c10d op's (``c10d::...``) base
    opcode under the JAX package's names ("collective" when the name says
    no more); None for anything else."""
    low = name.lower()
    if not (low.startswith("nccl") or low.startswith("c10d::")):
        return None
    flat = "".join(ch for ch in low if ch.isalpha())
    return next((op for frag, op in _NCCL_OPS if frag in flat), "collective")


def collective_op(name: str, hlo_op: str = "") -> str | None:
    return base_collective_op(hlo_op or name) or nccl_collective_op(name)


def classify_event(name: str, hlo_op: str, *, scope: str | None = None,
                   kind: str | None = None) -> str:
    """One device op -> its account bucket.  For the JAX package's event
    shape (``scope`` None) the JAX package's order, without its HLO
    instruction index (the port has no HLO): collective and infeed by
    opcode, an op_name scope path, then ``other``.  For a torch event:
    memcpy/memset are ``infeed``, NCCL kernels ``collective``, anything
    else its resolved scope's class ("" = no scope = ``other``)."""
    if kind in ("memcpy", "memset"):
        return "infeed"
    if collective_op(name, hlo_op) is not None:
        return "collective"
    instr = hlo_op or name
    if instr.split(".", 1)[0] in _INFEED_NAMES:
        return "infeed"
    if scope is not None:
        return classify_op_scope(scope) or "other"
    if "/" in name:  # an op_name scope path
        return classify_op_scope(name) or "other"
    return "other"


def _scoped_modules(model) -> list[tuple[str, Any]]:
    """(path, module) of the modules ``open_module_scopes`` wraps: every
    child of a transformer block (an entry of a ``ModuleList``), and the
    model's own children that are not ``ModuleList``s (embeddings, final
    norms, the head)."""
    from torch import nn

    out = []
    for name, mod in model.named_modules():
        if isinstance(mod, nn.ModuleList):
            for i, blk in enumerate(mod):
                out.extend((f"{name}.{i}.{child}", m) for child, m in blk.named_children())
    top_lists = {n for n, m in model.named_children() if isinstance(m, nn.ModuleList)}
    out.extend((n, m) for n, m in model.named_children()
               if n not in top_lists and not any(isinstance(c, nn.ModuleList)
                                                 for c in m.modules()))
    return out


# whether the scopes are open: only while a capture records, so that no
# step outside a capture pays for them and no other profiler sees them
_scopes_open = False


def open_module_scopes(model) -> list:
    """Open the scopes for one capture: a ``record_function`` named
    ``SCOPE_PREFIX`` + the module path around the forward of every module of
    ``_scoped_modules(model)`` (forward hooks), and ``scope``'s.  Returns
    the hook handles, which ``close_module_scopes`` removes."""
    import torch

    global _scopes_open
    handles = []
    for path, mod in _scoped_modules(model):
        open_scopes: list = []

        def pre(m, args, _name=SCOPE_PREFIX + path, _open=open_scopes):
            rf = torch.profiler.record_function(_name)
            rf.__enter__()
            _open.append(rf)

        def post(m, args, out, _open=open_scopes):
            if _open:
                _open.pop().__exit__(None, None, None)

        handles.append(mod.register_forward_pre_hook(pre))
        handles.append(mod.register_forward_hook(post, always_call=True))
    _scopes_open = True
    return handles


def close_module_scopes(handles: list) -> None:
    """Close the scopes ``open_module_scopes`` opened."""
    global _scopes_open
    for h in handles:
        h.remove()
    _scopes_open = False


@contextlib.contextmanager
def scope(path: str):
    """A module scope around code that runs outside any module's forward
    (the optimizer tail, the vocab-chunked head), opened only while the
    scopes are open."""
    if not _scopes_open:
        yield
        return
    import torch

    with torch.profiler.record_function(SCOPE_PREFIX + path):
        yield


# ---------------------------------------------------------------------------
# trace loading
# ---------------------------------------------------------------------------


def find_trace_files(trace_dir: str) -> list[str]:
    """Every ``*.trace.json(.gz)`` under ``trace_dir``, newest first."""
    hits = [p for pattern in ("*.trace.json.gz", "*.trace.json")
            for p in glob.glob(os.path.join(trace_dir, "**", pattern), recursive=True)]
    return sorted(hits, key=os.path.getmtime, reverse=True)


def load_trace_events(path: str) -> list[dict]:
    """One Chrome-trace JSON file -> its ``traceEvents`` list."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        doc = json.load(f)
    events = doc.get("traceEvents", []) if isinstance(doc, dict) else []
    return [e for e in events if isinstance(e, dict)]


def _innermost(intervals: list[tuple[float, float, Any]],
               points: list[tuple[float, Any]]) -> dict[Any, Any]:
    """For each (t, key) of ``points``, the payload of the innermost of the
    properly nested ``intervals`` (t0, t1, payload) containing t (t0 <= t
    <= t1), or None: one sweep in time order."""
    ivs = sorted(intervals, key=lambda iv: (iv[0], -iv[1]))
    out: dict[Any, Any] = {}
    stack: list[tuple[float, float, Any]] = []
    j = 0
    for t, key in sorted(points, key=lambda p: p[0]):
        while j < len(ivs) and ivs[j][0] <= t:
            while stack and stack[-1][1] < ivs[j][0]:
                stack.pop()
            stack.append(ivs[j])
            j += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        out[key] = stack[-1][2] if stack else None
    return out


def _args(e: dict) -> dict:
    return e.get("args") or {}


def _is_backward(e: dict) -> bool:
    a = _args(e)
    return "Sequence number" in a and int(a.get("Fwd thread id", 0) or 0) > 0


def _leaf_ops(ops: list[dict]) -> list[dict]:
    """The ops with no child op on their thread (sorted by start, a longer
    op first: an op's first successor that starts before it ends is its
    child)."""
    by_thread: dict[tuple, list[dict]] = {}
    for e in ops:
        by_thread.setdefault((e.get("pid"), e.get("tid")), []).append(e)
    leaves = []
    for seq in by_thread.values():
        seq.sort(key=lambda e: (float(e["ts"]), -float(e.get("dur", 0.0) or 0.0)))
        for i, e in enumerate(seq):
            end = float(e["ts"]) + float(e.get("dur", 0.0) or 0.0)
            if i + 1 < len(seq) and float(seq[i + 1]["ts"]) < end:
                continue
            leaves.append(e)
    return leaves


def device_op_events(events: Iterable[dict]) -> list[dict]:
    """Normalize a torch.profiler Chrome trace to its DEVICE OP events:
    ``{"name", "hlo_op", "ts", "dur", "pid", "tid", "kind", "scope"}``
    (times in µs; ``scope`` the resolved module scope, "" for none): the
    kernel / memcpy / memset events where the trace has device lanes, the
    leaf ``cpu_op`` events where it has none (a CPU run)."""
    xs = [e for e in events if e.get("ph") == "X" and "ts" in e]
    device = [e for e in xs if e.get("cat") in _DEVICE_CATS]
    ops = [e for e in xs if e.get("cat") == "cpu_op"]
    if device:
        launches = {_args(e).get("correlation"): e for e in xs
                    if e.get("cat") in _LAUNCH_CATS and "correlation" in _args(e)}
        placed = []
        for e in device:
            launch = launches.get(_args(e).get("correlation"))
            placed.append((e, _DEVICE_CATS[e["cat"]], launch))
    else:
        placed = [(e, "op", e) for e in _leaf_ops(ops)]
    placed = [(e, kind, at) for e, kind, at in placed if float(e.get("dur", 0.0) or 0.0) > 0]
    # per thread: the module scopes and the backward ops, each a nested family
    scopes: dict[tuple, list] = {}
    backward: dict[tuple, list] = {}
    for e in xs:
        key = (e.get("pid"), e.get("tid"))
        t0, t1 = float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0) or 0.0)
        if e.get("cat") == "user_annotation" and str(e.get("name", "")).startswith(SCOPE_PREFIX):
            scopes.setdefault(key, []).append((t0, t1, e["name"][len(SCOPE_PREFIX):]))
        elif e.get("cat") == "cpu_op" and _is_backward(e):
            backward.setdefault(key, []).append((t0, t1, e))
    queries: dict[tuple, list] = {}
    for i, (_, _, at) in enumerate(placed):
        if at is not None:
            queries.setdefault((at.get("pid"), at.get("tid")), []).append((float(at["ts"]), i))
    # the forward ops by sequence number: outside every backward op (remat's
    # recompute runs inside one and makes no node a backward op names)
    fwd_pts: dict[tuple, list] = {}
    for e in ops:
        a = _args(e)
        if "Sequence number" in a and not _is_backward(e):
            fwd_pts.setdefault((e.get("pid"), e.get("tid")), []).append((float(e["ts"]), id(e)))
    inside_bwd: dict[int, Any] = {}
    for key, pts in fwd_pts.items():
        inside_bwd.update(_innermost(backward.get(key, []), pts))
    forward_by_seq: dict[int, list[dict]] = {}
    for e in ops:
        a = _args(e)
        if "Sequence number" in a and not _is_backward(e) and inside_bwd.get(id(e)) is None:
            forward_by_seq.setdefault(int(a["Sequence number"]), []).append(e)
    scope_of: dict[int, str | None] = {}
    bwd_of: dict[int, dict | None] = {}
    for key, pts in queries.items():
        scope_of.update(_innermost(scopes.get(key, []), pts))
        bwd_of.update(_innermost(backward.get(key, []), pts))
    # the scopes of the forward ops that backward launches link to
    links: dict[int, dict] = {}
    for i, b in bwd_of.items():
        if b is None or scope_of.get(i) is not None:
            continue
        cands = [f for f in forward_by_seq.get(int(_args(b)["Sequence number"]), ())
                 if float(f["ts"]) <= float(b["ts"])]
        if cands:
            links[i] = max(cands, key=lambda f: float(f["ts"]))
    fwd_queries: dict[tuple, list] = {}
    for i, f in links.items():
        fwd_queries.setdefault((f.get("pid"), f.get("tid")), []).append((float(f["ts"]), i))
    linked_scope: dict[int, str | None] = {}
    for key, pts in fwd_queries.items():
        linked_scope.update(_innermost(scopes.get(key, []), pts))
    out: list[dict] = []
    for i, (e, kind, _) in enumerate(placed):
        sc = scope_of.get(i) or linked_scope.get(i) or ""
        out.append({"name": str(e.get("name", "")), "hlo_op": "", "ts": float(e["ts"]),
                    "dur": float(e["dur"]), "pid": e.get("pid"), "tid": e.get("tid"),
                    "kind": kind, "scope": sc})
    return out


# ---------------------------------------------------------------------------
# the account (the JAX package's arithmetic)
# ---------------------------------------------------------------------------


def _merged_intervals(spans: Iterable[tuple[float, float]]) -> list[list[float]]:
    """Sorted (start, end) µs intervals -> merged disjoint cover."""
    merged: list[list[float]] = []
    for t0, t1 in sorted(spans):
        if merged and t0 <= merged[-1][1]:
            if t1 > merged[-1][1]:
                merged[-1][1] = t1
        else:
            merged.append([t0, t1])
    return merged


def _union_us(merged: list[list[float]]) -> float:
    return sum(t1 - t0 for t0, t1 in merged)


def _intersect_us(a: list[list[float]], b: list[list[float]]) -> float:
    """Total overlap between two merged interval lists."""
    out = 0.0
    i = j = 0
    while i < len(a) and j < len(b):
        lo = max(a[i][0], b[j][0])
        hi = min(a[i][1], b[j][1])
        if hi > lo:
            out += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return out


def _ms(us: float) -> float:
    return round(us / 1e3, 3)


def build_account(events: list[dict], *,
                  max_lane_slices: int = MAX_LANE_SLICES) -> dict[str, Any] | None:
    """Reduce normalized device op events into the device account (the JAX
    package's fields and arithmetic); None when there is no event.  Times
    in ms, three decimals."""
    if not events:
        return None
    span_lo = min(e["ts"] for e in events)
    span_hi = max(e["ts"] + e["dur"] for e in events)
    buckets = {b: 0.0 for b in DEVICE_BUCKETS}
    collectives: dict[str, dict[str, Any]] = {}
    op_spans: dict[str, list[tuple[float, float]]] = {}
    all_spans: list[tuple[float, float]] = []
    comm_spans: list[tuple[float, float]] = []
    compute_spans: list[tuple[float, float]] = []
    lane_raw: dict[str, list[tuple[float, float]]] = {}
    for e in events:
        bucket = classify_event(e["name"], e["hlo_op"], scope=e.get("scope"),
                                kind=e.get("kind"))
        buckets[bucket] += e["dur"]
        t0, t1 = e["ts"], e["ts"] + e["dur"]
        all_spans.append((t0, t1))
        if bucket == "collective":
            comm_spans.append((t0, t1))
            op = collective_op(e["name"], e["hlo_op"]) or "collective"
            slot = collectives.setdefault(op, {"count": 0, "time_us": 0.0})
            slot["count"] += 1
            slot["time_us"] += e["dur"]
            op_spans.setdefault(op, []).append((t0, t1))
        else:
            compute_spans.append((t0, t1))
        lane_raw.setdefault(bucket, []).append((t0 - span_lo, t1 - span_lo))
    busy = _merged_intervals(all_spans)
    comm = _merged_intervals(comm_spans)
    compute = _merged_intervals(compute_spans)
    busy_us = _union_us(busy)
    comm_us = _union_us(comm)
    compute_us = _union_us(compute)
    overlapped_us = _intersect_us(comm, compute)
    span_us = span_hi - span_lo
    total_op_us = sum(buckets.values())
    acct: dict[str, Any] = {
        "event": "device_account",
        "events": len(events),
        "span_ms": _ms(span_us),
        "busy_ms": _ms(busy_us),
        "exposed_idle_ms": _ms(max(0.0, span_us - busy_us)),
        "buckets_ms": {b: _ms(buckets[b]) for b in DEVICE_BUCKETS},
        "bucket_frac": {b: round(buckets[b] / total_op_us, 4) if total_op_us else 0.0
                        for b in DEVICE_BUCKETS},
        # time_ms: device time summed over every lane that ran the op;
        # wall_ms: their union, the denominator of the bandwidth join
        "collectives": {
            op: {"count": s["count"], "time_ms": _ms(s["time_us"]),
                 "wall_ms": _ms(_union_us(_merged_intervals(op_spans[op])))}
            for op, s in sorted(collectives.items())
        },
        "overlap": {
            "collective_ms": _ms(comm_us),
            "compute_ms": _ms(compute_us),
            "overlapped_ms": _ms(overlapped_us),
            "exposed_collective_ms": _ms(comm_us - overlapped_us),
            **({"overlap_frac": round(overlapped_us / comm_us, 4)} if comm_us > 0 else {}),
        },
    }
    # bounded per-bucket lanes (merged, longest first) for the trace export
    lanes: list[list[Any]] = []
    dropped = 0
    for b in DEVICE_BUCKETS:
        if b not in lane_raw:
            continue
        merged = _merged_intervals(lane_raw[b])
        merged.sort(key=lambda iv: iv[0] - iv[1])
        budget_n = max_lane_slices - len(lanes)
        dropped += max(0, len(merged) - budget_n)
        lanes.extend([b, _ms(t0), _ms(t1 - t0)] for t0, t1 in merged[:budget_n])
    lanes.sort(key=lambda s: s[1])
    acct["lanes"] = lanes
    if dropped:
        acct["lane_slices_dropped"] = dropped
    return acct


def device_account_from_dir(trace_dir: str) -> dict[str, Any] | None:
    """The newest capture session under ``trace_dir`` as a device account;
    None when there is no trace file or no device op event."""
    files = find_trace_files(trace_dir)
    if not files:
        return None
    session_dir = os.path.dirname(files[0])
    events: list[dict] = []
    for path in files:
        if os.path.dirname(path) == session_dir:
            events.extend(device_op_events(load_trace_events(path)))
    acct = build_account(events)
    if acct is not None:
        acct["trace_dir"] = trace_dir
    return acct


# ---------------------------------------------------------------------------
# the byte-account join
# ---------------------------------------------------------------------------


def join_collective_bandwidth(account: dict[str, Any], comm: Mapping[str, Any] | None,
                              window_steps: int) -> dict[str, Any]:
    """Stamp achieved bytes/s onto the account's per-collective rows:
    ``comm`` is ``obs/gauges.py``'s per-step byte account; bytes moved =
    per-step bytes x window steps, over the op's wall time (``wall_ms``).
    Mutates and returns ``account``."""
    if not comm or window_steps <= 0:
        return account
    for op, slot in account.get("collectives", {}).items():
        per_step = comm.get(op)
        if not isinstance(per_step, Mapping):
            continue
        step_bytes = int(per_step.get("gradient_bytes", 0)) + int(
            per_step.get("activation_bytes", 0))
        slot["bytes_per_step"] = step_bytes
        wall_s = float(slot.get("wall_ms", slot.get("time_ms", 0.0)) or 0.0) / 1e3
        if step_bytes > 0 and wall_s > 0:
            slot["achieved_bytes_per_sec"] = round(step_bytes * window_steps / wall_s, 1)
    return account


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(prog="python -m distributed_llms_example_tpu_torch.obs.devprof",
                                description="a torch.profiler capture's device account")
    p.add_argument("trace_dir", help="a profile capture dir (obs/profile.py)")
    args = p.parse_args(argv)
    acct = device_account_from_dir(args.trace_dir)
    if acct is None:
        print(f"no device op events under {args.trace_dir}", file=sys.stderr)
        return 2
    print(json.dumps(acct))
    return 0


if __name__ == "__main__":
    sys.exit(main())
