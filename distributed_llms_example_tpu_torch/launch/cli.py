"""Command line for the PyTorch port (port of the JAX package's
``launch/cli.py``): training without a subcommand, ``serve``,
``serve-router`` and ``serve-loadgen``.

    python -m distributed_llms_example_tpu_torch.launch.cli \\
        --model-ckpt bart-large-cnn --train-file train.json --batch-size 8 \\
        --num-epochs 1 --max-source-length 1024 --max-target-length 128
    python -m distributed_llms_example_tpu_torch.launch.cli \\
        --model-ckpt t5-large --train-file train.json --batch-size 8 \\
        --num-epochs 1 --max-source-length 1024 --max-target-length 128
    python -m distributed_llms_example_tpu_torch.launch.cli \\
        --model-ckpt <HF checkpoint dir> --output-dir out --train-file train.json
    python -m distributed_llms_example_tpu_torch.launch.cli \\
        --model-ckpt bart-large-cnn --train-file train.json --val-file val.json \\
        --evaluation-steps 500 --num-beams 2 --eval-max-new-tokens 128
    python -m distributed_llms_example_tpu_torch.launch.cli \\
        --model-ckpt <LLaMA HF checkpoint dir> --train-file train.json --remat \\
        --fused-ce --batch-size 8 --max-source-length 1024 --max-target-length 128
    torchrun --nproc-per-node 4 -m distributed_llms_example_tpu_torch.launch.cli \\
        --model-ckpt llama-2-7b --mesh fsdp=4 --remat --fused-ce \\
        --train-file train.json --batch-size 8 --max-source-length 1024
    python -m distributed_llms_example_tpu_torch.launch.cli serve \\
        --model-ckpt bart-large-cnn --prompts-file prompts.json \\
        --max-slots 8 --max-new-tokens 128 --max-source-length 1024
    python -m distributed_llms_example_tpu_torch.launch.cli serve \\
        --model-ckpt flan-t5-xl --prompts-file prompts.json \\
        --max-slots 8 --max-new-tokens 128 --max-source-length 1024
    python -m distributed_llms_example_tpu_torch.launch.cli serve \\
        --model-ckpt llama-2-7b --prompts-file prompts.json \\
        --max-slots 8 --max-new-tokens 128 --max-source-length 1024 --paged-kv \\
        [--kv-cache-dtype int8] [--prefix-cache --prefix-cache-budget-gib 2] \\
        [--spec-tokens 3 [--spec-draft-model <causal HF dir>]] [--postmortem-dir D]

Both take ``--device`` (default ``cuda``; without a GPU they stop unless
``--device cpu`` is given), ``--model-ckpt`` (a registry name, whose
weights are drawn from ``--seed``: no weights ship with the repository, or
a local HF checkpoint directory, whose weights are read) and ``--seed``.
Training takes a seq2seq model (T5 or BART: summarization) or a causal
one (LLaMA: prompt-continuation fine-tuning, the loss masked over the
prompt) and the JAX CLI's flags that the port implements
(``core/config.py``: ``--remat``, ``--remat-policy``, ``--fused-ce`` and
``--prefetch-batches`` among them), no others, scores the model on
``--val-file`` (ROUGE of beam-search summaries or continuations, an
``eval`` line every ``--evaluation-steps`` steps and at each epoch's end)
and writes the fine-tuned model to ``<output-dir>/model/`` as an HF
checkpoint.  ``serve`` takes every family of the
registry, Mixtral among the LLaMAs, and encodes a seq2seq model's prompts as sources
(ending in eos) and a causal model's as prompts (no eos), as the JAX CLI
does.  The JAX CLI's startup lints read the compiled XLA program and
have no counterpart here: ``--lint`` (train and serve) is parsed and one
``lint_skipped`` line says so.  ``--dry-run`` prints the resolved training
config and exits.  Telemetry: ``--obs jsonl`` with ``--obs-gauges``,
``--profile-steps a:b`` (a ``torch.profiler`` capture parsed into a
``device_account``), ``--hbm-budget-gib``; read a run with ``python -m
distributed_llms_example_tpu_torch.obs.report <output-dir> [--trace
out.json]``.

Training runs over several GPUs as one process per GPU (``torchrun
--nproc-per-node N -m distributed_llms_example_tpu_torch.launch.cli ...``,
or each process started with ``VH_MASTER_IP``, ``VH_WORLD_SIZE`` and
``VH_RANK`` set, or with ``--coordinator-address``, ``--num-processes`` and
``--process-id``; on Valohai the platform's own facts), laid out by
``--mesh``: ``data=N`` (replicated parameters, the gradients all-reduced),
``fsdp=N`` (sharded, FSDP2) or ``data=a,fsdp=b`` (HSDP), and for the
LLaMA dense family ``tensor=N`` (Megatron: the heads and the MLP width
split), ``sequence=N`` (ring attention over each row's positions;
``--attention-impl ring`` forces it and needs this axis) or both beside
``data`` (``data=2,sequence=2,tensor=2``); fsdp with them, BART, T5,
Mixtral and the eval pass under them are refused at parse time
(``core/config.py mesh_composition_error``).  The group is
NCCL on CUDA and gloo with ``--device cpu`` (``core/mesh.py``).  Without
``--train-file``, ``train.json`` and ``val.json`` beside the Valohai
``dataset`` input are read.  ``serve``'s ``--mesh`` accepts one-device
layouts only; multi-GPU serving is a later slice (ROADMAP.md).

``serve-router`` serves the prompts through ``--replicas`` engines that
share the one loaded model, behind ``serving/router.py``'s router (health
machine, retry and re-prefill, admission control, deadlines, ``--chaos
replica_crash@K,replica_stall@K,request_storm@K``); ``serve-loadgen`` drives
one engine session (``--replicas 0``, its default) or a router pool
through ``serving/loadgen.py``'s open-loop QPS sweep (``--qps-grid``,
``--arrival-process``, ``--loadgen-seed``).  Both take every ``serve``
flag, run on CUDA unless ``--device cpu`` and write through ``--output-file``:

    python -m distributed_llms_example_tpu_torch.launch.cli serve-router \\
        --model-ckpt llama-2-7b --prompts-file prompts.json --paged-kv \\
        --replicas 2 --chaos replica_crash@40
    python -m distributed_llms_example_tpu_torch.launch.cli serve-loadgen \\
        --model-ckpt llama-2-7b --prompts-file prompts.json --paged-kv \\
        --qps-grid 0.5,1,2 --loadgen-seed 0
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys


def build_serve_parser() -> argparse.ArgumentParser:
    from distributed_llms_example_tpu_torch.core.config import add_model_args

    p = add_model_args(argparse.ArgumentParser(
        prog="dllm-torch serve",
        description="continuous-batching inference over a prompts file "
                    "(serving/engine.py): prefill/decode split, KV-cache slots, "
                    "admit/evict per token step",
    ))
    p.add_argument("--prompts-file", type=str, required=True,
                   help="JSON array / JSONL of records or plain strings")
    p.add_argument("--output-file", type=str, default="",
                   help="write {prompt, output, tokens} JSONL here (default: stdout)")
    p.add_argument("--num-prompts", type=int, default=0, help="0 = all")
    p.add_argument("--max-slots", type=int, default=8)
    p.add_argument("--prefill-batch", type=int, default=0)
    p.add_argument("--max-new-tokens", type=int, default=128)
    p.add_argument("--log-every-steps", type=int, default=50)
    p.add_argument("--ttft-slo-ms", type=float, default=0.0)
    p.add_argument("--kv-cache-dtype", type=str, default="f32", choices=("f32", "int8"),
                   help="f32: K/V in the compute dtype; int8: quantized with one fp32 scale "
                        "per position (the decode kernels dequantize per tile)")
    p.add_argument("--prefill-buckets", type=str, default="")
    p.add_argument("--paged-kv", action="store_true")
    p.add_argument("--pool-blocks", type=int, default=0)
    p.add_argument("--kv-block-size", type=int, default=0)
    p.add_argument("--prefix-cache", action="store_true",
                   help="--paged-kv: share full prompt blocks across requests by chain hash; "
                        "a hit prefills only the uncached tail")
    p.add_argument("--prefix-cache-budget-gib", type=float, default=0.0,
                   help="prefix cache: GiB of finished requests' blocks kept warm (LRU, "
                        "evicted only at refcount 0; 0 = no warm retention)")
    p.add_argument("--spec-tokens", type=int, default=0,
                   help="causal families: speculative decode, this many drafts a slot a "
                        "round verified in one decode pass of k + 1 rows (0 = off, max "
                        "SPEC_MAX_DRAFT_TOKENS = 7)")
    p.add_argument("--spec-draft-model", type=str, default="",
                   help="registry name or HF directory of a causal draft model with the "
                        "target's vocabulary ('' = n-gram self-drafting)")
    p.add_argument("--hbm-budget-gib", type=float, default=80.0,
                   help="device-memory ceiling in GiB for the serve summary's "
                        "memory account (H100 = 80)")
    p.add_argument("--postmortem-dir", type=str, default="",
                   help="where an out-of-memory error mid-serve writes its "
                        "memory-postmortem-p*.json bundle ('' = off)")
    p.add_argument("--mesh", type=str, default="data=-1",
                   help="serve: data=N (slot rows split), tensor=N (heads split, LLaMA "
                        "dense) or data=a,tensor=b, one process a GPU; serve-router and "
                        "serve-loadgen: one-device layouts only")
    p.add_argument("--compute-dtype", type=str, default="bfloat16")
    p.add_argument("--lint", type=str, default="warn", choices=("off", "warn", "strict"))
    # the multi-process rendezvous triple (else Valohai, VH_* or torchrun env)
    p.add_argument("--coordinator-address", type=str, default="")
    p.add_argument("--num-processes", type=int, default=0)
    p.add_argument("--process-id", type=int, default=-1)
    return p


def check_single_device_mesh(spec: str) -> None:
    """Accept a ``--mesh`` layout only if it places everything on one device
    (``serve-router`` and ``serve-loadgen``: their tick-driven health
    machine and arrival clocks would have to be agreed across ranks
    first, ROADMAP.md order item 1's leftovers)."""
    sizes = []
    for part in filter(None, (s.strip() for s in spec.split(","))):
        name, _, val = part.partition("=")
        if not val:
            raise SystemExit(f"--mesh {spec!r}: expected axis=size pairs")
        sizes.append(int(val))
    if math.prod(1 if n == -1 else n for n in sizes) != 1:
        raise SystemExit(
            f"--mesh {spec!r}: serve-router and serve-loadgen serve on one GPU: their "
            "health machine and arrival clocks are not agreed across ranks (ROADMAP.md "
            "order item 1's leftovers); serve --mesh runs on several"
        )


def _prompt_text(record, source_column: str) -> str:
    if isinstance(record, str):
        return record
    if source_column:
        return str(record[source_column])
    for col in ("dialogue", "article", "prompt", "text", "source"):
        if col in record:
            return str(record[col])
    raise SystemExit(
        f"cannot resolve a prompt column in record keys {sorted(record)}; pass --source-column"
    )


def _serve_config_from_args(args):
    from distributed_llms_example_tpu_torch.serving.engine import ServeConfig

    return ServeConfig(
        max_slots=args.max_slots,
        prefill_batch=args.prefill_batch,
        max_new_tokens=args.max_new_tokens,
        max_source_length=args.max_source_length,
        log_every_steps=args.log_every_steps,
        ttft_slo_ms=args.ttft_slo_ms,
        kv_cache_dtype=args.kv_cache_dtype,
        prefill_buckets=tuple(int(b) for b in args.prefill_buckets.split(",") if b.strip()),
        paged_kv=args.paged_kv,
        pool_blocks=args.pool_blocks,
        kv_block_size=args.kv_block_size,
        prefix_cache=args.prefix_cache,
        prefix_cache_budget_gib=args.prefix_cache_budget_gib,
        spec_tokens=args.spec_tokens,
        spec_draft_model=args.spec_draft_model,
        hbm_budget_gib=args.hbm_budget_gib,
        postmortem_dir=args.postmortem_dir,
    )


def _write_serve_output(args, lm, tok, prompts, outputs, *, extra=None) -> None:
    """Request outputs (the served product): JSONL on stdout or, with
    ``--output-file``, through ``obs/sink.py``'s ``ProductJsonlWriter``
    (one ``os.write`` a line, an fsync on close).  ``extra``: fields added
    to each record (the router's shed reason)."""
    from distributed_llms_example_tpu_torch.obs.sink import ProductJsonlWriter
    from distributed_llms_example_tpu_torch.serving.engine import trim_eos
    from distributed_llms_example_tpu_torch.utils.jsonlog import log_json

    eos, pad = lm.config.eos_token_id, lm.config.pad_token_id
    lines = []
    for i, (prompt, ids) in enumerate(zip(prompts, outputs)):
        kept = [t for t in trim_eos(ids, eos, pad) if t != eos]
        lines.append({"prompt": prompt, "output": tok.decode(kept), "tokens": len(kept),
                      **(extra[i] if extra is not None else {})})
    if not args.output_file:
        for rec in lines:
            sys.stdout.write(json.dumps(rec) + "\n")
        return
    writer = ProductJsonlWriter(args.output_file)
    try:
        for rec in lines:
            writer.write(rec)
    finally:
        writer.close()
    log_json({"event": "serve_output", "path": args.output_file, "records": len(lines)})


def _serve_mesh(args, loaded):
    """``serve --mesh``'s layout: the refused compositions stop here, before
    a group or a model exists (``core/config.parse_serve_mesh``); then the
    process joins its group (``core/mesh.initialize_distributed``: torchrun,
    Valohai, ``VH_*`` or the rendezvous flags; NCCL on CUDA, gloo with
    ``--device cpu``) and the shape is resolved against the world (the
    engine checks the serving features against it).  Returns the
    ``MeshSpec``."""
    from distributed_llms_example_tpu_torch.core.config import parse_serve_mesh
    from distributed_llms_example_tpu_torch.core.mesh import (
        initialize_distributed,
        resolve_mesh_shape,
    )
    from distributed_llms_example_tpu_torch.models.registry import model_config

    family, model_cfg = ((loaded.family, loaded.config) if loaded is not None
                         else model_config(args.model_ckpt))
    try:
        mesh = parse_serve_mesh(args.mesh, family=family, model_cfg=model_cfg)
    except ValueError as e:
        raise SystemExit(f"--mesh {args.mesh!r}: {e}") from None
    world = initialize_distributed(args.coordinator_address, args.num_processes,
                                   args.process_id, device_type=args.device)
    try:
        return resolve_mesh_shape(mesh, world)
    except ValueError as e:
        raise SystemExit(f"--mesh {args.mesh!r}: {e}") from None


def _serve_layout(spec, lm):
    """This rank's ``ServeLayout`` on ``spec`` (None on one GPU), the model
    cut to its tensor rank's heads first."""
    from distributed_llms_example_tpu_torch.core.mesh import axis_groups, mesh_coords, process_index
    from distributed_llms_example_tpu_torch.parallel.activation import ModelParallel, attach
    from distributed_llms_example_tpu_torch.parallel.sharding import shard_tensor_parallel
    from distributed_llms_example_tpu_torch.serving.engine import ServeLayout

    if spec.size == 1:
        return None
    rank = process_index()
    groups = axis_groups(spec, rank)
    if spec.tensor > 1:
        shard_tensor_parallel(lm.module, spec.tensor, groups.tensor_index)
        attach(lm.module, ModelParallel(mesh=spec.axes(), tensor_group=groups.tensor,
                                        tensor_index=groups.tensor_index))
    return ServeLayout(data=spec.data, data_index=mesh_coords(spec, rank)[0],
                       data_group=groups.data, tensor=spec.tensor)


def _serve_setup(args, loaded, *, mesh: bool = False):
    """What ``serve``, ``serve-router`` and ``serve-loadgen`` share: the
    device, the prompts, the model (``loaded``, or ``--model-ckpt``'s,
    loaded once: the router's replicas share it), the tokenizer and the
    encoded requests.  ``mesh``: ``serve``'s layouts over several GPUs
    (else one device only).  Returns ``(device, lm, tok, prompts,
    requests, layout)``."""
    from distributed_llms_example_tpu_torch.core.config import SPEC_MAX_DRAFT_TOKENS
    from distributed_llms_example_tpu_torch.core.mesh import local_device, process_count
    from distributed_llms_example_tpu_torch.core.precision import parse_dtype, resolve_device
    from distributed_llms_example_tpu_torch.data.dataset import load_json_records
    from distributed_llms_example_tpu_torch.data.tokenizer import get_tokenizer
    from distributed_llms_example_tpu_torch.models.registry import load_model
    from distributed_llms_example_tpu_torch.utils.jsonlog import log_json

    if not 0 <= args.spec_tokens <= SPEC_MAX_DRAFT_TOKENS:
        raise SystemExit(f"--spec-tokens {args.spec_tokens}: must be in [0, "
                         f"{SPEC_MAX_DRAFT_TOKENS}] (the verify pass scores spec_tokens + 1 "
                         f"rows; the decode kernels take at most {SPEC_MAX_DRAFT_TOKENS + 1})")
    device = resolve_device(args.device)
    if mesh:
        spec = _serve_mesh(args, loaded)
        if process_count() > 1 and device.type == "cuda":
            device = local_device("cuda")
    else:
        check_single_device_mesh(args.mesh)
    records = load_json_records(args.prompts_file)
    if args.num_prompts > 0:
        records = records[: args.num_prompts]
    prompts = [_prompt_text(r, args.source_column) for r in records]
    lm = loaded or load_model(
        args.model_ckpt, dtype=parse_dtype(args.compute_dtype), device=device,
        attention_impl=args.attention_impl or None, seed=args.seed,
    )
    layout = _serve_layout(spec, lm) if mesh else None
    if args.lint != "off":
        log_json({"event": "lint_skipped", "lint": args.lint,
                  "reason": "the serving lints read XLA cache specs; the port has none yet"})
    tok = get_tokenizer(args.tokenizer, args.model_ckpt)
    encode = tok.encode_source if lm.is_seq2seq else tok.encode_prompt
    requests = [encode(t, args.max_source_length) for t in prompts]
    return device, lm, tok, prompts, requests, layout


def _engine(args, lm, device, layout=None):
    from distributed_llms_example_tpu_torch.serving.engine import ServingEngine

    return ServingEngine(lm.module, lm.config, _serve_config_from_args(args),
                         is_seq2seq=lm.is_seq2seq, device=device, layout=layout)


def serve(argv: list[str] | None = None, *, loaded=None):
    """The ``serve`` subcommand: load → continuous-batching decode → write
    outputs.  Returns ``(engine, outputs)``: the engine's ``last_stats``
    hold the run, ``outputs`` the generated ids per prompt (on every rank
    of a mesh; rank 0 alone writes them).  ``loaded``: a model built by the
    caller (a ``LoadedModel`` on the device; cut in place to this rank's
    heads under ``tensor``), served in place of ``--model-ckpt``'s."""
    from distributed_llms_example_tpu_torch.core.mesh import process_index

    args = build_serve_parser().parse_args(argv)
    device, lm, tok, prompts, requests, layout = _serve_setup(args, loaded, mesh=True)
    engine = _engine(args, lm, device, layout)
    outputs = engine.generate(requests)
    if process_index() == 0:
        _write_serve_output(args, lm, tok, prompts, outputs)
    return engine, outputs


def serve_main(argv: list[str] | None = None) -> int:
    serve(argv)
    return 0


def build_router_parser() -> argparse.ArgumentParser:
    """``serve-router``: every ``serve`` flag and the router's."""
    p = build_serve_parser()
    p.prog = "dllm-torch serve-router"
    p.description = ("fault-tolerant serving tier (serving/router.py): N engine replicas "
                     "sharing one model behind a router with session affinity, queue-depth "
                     "dispatch, bounded retry and re-prefill on a replica's failure, "
                     "admission control, drain, and the serving chaos kinds")
    p.add_argument("--replicas", type=int, default=2,
                   help="engine replicas in the pool (each its own slots and block pool)")
    p.add_argument("--max-retries", type=int, default=2,
                   help="re-dispatches a request gets after replica failures; past it, shed")
    p.add_argument("--deadline-ms", type=float, default=0.0,
                   help="a request's wall deadline while it waits for dispatch (0 = none); "
                        "expired requests shed with reason 'deadline'")
    p.add_argument("--router-max-queue", type=int, default=0,
                   help="the router queue's bound (0 = none); submissions over it shed or "
                        "defer per --shed-policy")
    p.add_argument("--shed-policy", type=str, default="defer", choices=("defer", "shed"),
                   help="a submission over the bound: defer parks it client-side, shed "
                        "rejects it")
    p.add_argument("--suspect-after-ticks", type=int, default=3,
                   help="missed heartbeats (router ticks without a replica's progress) "
                        "before live -> suspect")
    p.add_argument("--dead-after-ticks", type=int, default=6,
                   help="missed heartbeats before suspect -> dead (its requests re-prefill "
                        "elsewhere)")
    p.add_argument("--chaos", type=str, default="",
                   help="serving chaos (obs/chaos.py): replica_crash@K,replica_stall@K,"
                        "request_storm@K with K a router tick")
    return p


def _router_config(args):
    from distributed_llms_example_tpu_torch.obs.chaos import parse_chaos
    from distributed_llms_example_tpu_torch.serving.router import RouterConfig

    try:
        return RouterConfig(
            max_retries=args.max_retries, deadline_s=args.deadline_ms / 1e3,
            max_queue=args.router_max_queue, shed_policy=args.shed_policy,
            suspect_after_ticks=args.suspect_after_ticks,
            dead_after_ticks=args.dead_after_ticks, log_every_ticks=args.log_every_steps,
            chaos=parse_chaos(args.chaos) if args.chaos else None,
        )
    except ValueError as e:
        raise SystemExit(str(e)) from None


def serve_router(argv: list[str] | None = None, *, loaded=None):
    """The ``serve-router`` subcommand: the model loaded once, ``--replicas``
    engines over it, routed to completion, the outputs written (a shed
    request's record carries its reason).  Returns ``(router, outputs)``."""
    from distributed_llms_example_tpu_torch.serving.router import ReplicaRouter

    args = build_router_parser().parse_args(argv)
    if args.replicas < 1:
        raise SystemExit("--replicas must be >= 1")
    cfg = _router_config(args)
    device, lm, tok, prompts, requests, _ = _serve_setup(args, loaded)
    router = ReplicaRouter([_engine(args, lm, device) for _ in range(args.replicas)], cfg)
    outputs = router.serve(requests)
    extra = [{"shed": q.shed_reason} if q.shed else {}
             for q in router.requests if not q.synthetic]
    _write_serve_output(args, lm, tok, prompts, outputs, extra=extra)
    return router, outputs


def build_loadgen_parser() -> argparse.ArgumentParser:
    """``serve-loadgen``: every ``serve-router`` flag and the sweep's;
    ``--replicas 0`` (the default here) drives one engine session, >= 1 a
    router pool (which composes with ``--chaos``)."""
    p = build_router_parser()
    p.prog = "dllm-torch serve-loadgen"
    p.description = ("open-loop load sweep (serving/loadgen.py): seeded arrivals over an "
                     "offered-QPS grid, offered vs goodput and TTFT percentile curves, the "
                     "saturation knee; --replicas 0 drives one engine session, >= 1 a router")
    p.set_defaults(replicas=0)
    p.add_argument("--arrival-process", type=str, default="poisson",
                   choices=("poisson", "bursty", "ramp"),
                   help="exponential gaps, bursts of --burst-size, or a linear rate ramp "
                        "from --ramp-start-frac x rate")
    p.add_argument("--loadgen-seed", type=int, default=0,
                   help="the arrival schedule's seed (same seed and config: the same "
                        "schedule bit for bit)")
    p.add_argument("--qps-grid", type=str, default="1,2,4,8",
                   help="comma list of ascending offered QPS points")
    p.add_argument("--burst-size", type=int, default=4, help="bursty: arrivals a burst")
    p.add_argument("--ramp-start-frac", type=float, default=0.25,
                   help="ramp: the starting rate as a fraction of the point's")
    p.add_argument("--max-wall-s", type=float, default=0.0,
                   help="a point's wall cap (0 = none); past it the unfinished tail reports")
    p.add_argument("--track-tol", type=float, default=0.9,
                   help="knee sensitivity: achieved QPS below track-tol x offered saturates")
    p.add_argument("--workload", type=str, default="random", choices=("random", "chatbot"),
                   help="'random' drives the prompts file; 'chatbot' the seeded "
                        "shared-prefix multi-turn mix (serving/loadgen.py chatbot_requests: "
                        "session keys for the router's affinity, the scripted reply lengths "
                        "as decode budgets), ignoring the prompts file")
    p.add_argument("--chat-sessions", type=int, default=8, help="chatbot: sessions")
    p.add_argument("--chat-turns", type=int, default=4, help="chatbot: turns a session")
    p.add_argument("--chat-shared-frac", type=float, default=0.9,
                   help="chatbot: the fraction of sessions opening with the shared system "
                        "prompt")
    return p


def serve_loadgen(argv: list[str] | None = None, *, loaded=None):
    """The ``serve-loadgen`` subcommand: the model loaded once, a fresh
    session (or router pool) a point of the QPS grid, the sweep's summary
    written with ``--output-file``.  Returns ``(summary, outputs)``:
    ``outputs[i]`` the generated ids of every request at grid point i, in
    request order."""
    from distributed_llms_example_tpu_torch.serving.loadgen import (
        EngineTarget,
        LoadgenConfig,
        RouterTarget,
        chatbot_requests,
        sweep_qps,
    )
    from distributed_llms_example_tpu_torch.serving.router import ReplicaRouter

    args = build_loadgen_parser().parse_args(argv)
    if args.replicas < 0:
        raise SystemExit("--replicas must be >= 0")
    router_cfg = _router_config(args) if args.replicas else None
    try:
        cfg = LoadgenConfig(
            process=args.arrival_process, seed=args.loadgen_seed, burst_size=args.burst_size,
            ramp_start_frac=args.ramp_start_frac,
            qps_grid=tuple(float(q) for q in args.qps_grid.split(",") if q.strip()),
            # the serve flag's 0 (no SLO) would make attainment vacuous
            ttft_slo_ms=args.ttft_slo_ms or 500.0, max_wall_s=args.max_wall_s,
            track_tol=args.track_tol,
        )
    except ValueError as e:
        raise SystemExit(str(e)) from None
    device, lm, tok, prompts, requests, _ = _serve_setup(args, loaded)
    sessions = budgets = None
    if args.workload == "chatbot":
        requests, sessions, budgets = chatbot_requests(
            sessions=args.chat_sessions, turns=args.chat_turns, seed=args.loadgen_seed,
            vocab=int(lm.config.vocab_size), shared_frac=args.chat_shared_frac,
            max_len=args.max_source_length, with_budgets=True)
    targets: list = []
    if args.replicas:
        def target_factory():
            engines = [_engine(args, lm, device) for _ in range(args.replicas)]
            targets.append(RouterTarget(ReplicaRouter(engines, router_cfg)))
            return targets[-1]
    else:
        engine = _engine(args, lm, device)

        def target_factory():
            targets.append(EngineTarget(engine.open()))
            return targets[-1]

    summary = sweep_qps(target_factory, requests, cfg, sessions=sessions, budgets=budgets)
    if args.replicas:
        outputs = [[list(q.out) for q in t.router.requests if not q.synthetic] for t in targets]
    else:
        outputs = [[list(o) for o in t.session.outputs] for t in targets]
    if args.output_file:
        from distributed_llms_example_tpu_torch.obs.sink import ProductJsonlWriter

        writer = ProductJsonlWriter(args.output_file)
        try:
            writer.write(summary)
        finally:
            writer.close()
    return summary, outputs


def build_train_parser() -> argparse.ArgumentParser:
    from distributed_llms_example_tpu_torch.core.config import add_train_args

    p = add_train_args(argparse.ArgumentParser(
        prog="dllm-torch",
        description="fine-tune a seq2seq model (T5, BART) on a JSON summarization "
                    "file or a causal LM (LLaMA) on prompt/continuation records "
                    "(train/trainer.py); 'serve' runs inference",
    ))
    p.add_argument("--dry-run", action="store_true", help="print the resolved config and exit")
    p.add_argument("--lint", type=str, default="warn", choices=("off", "warn", "strict"),
                   help="the JAX CLI's startup lints; the port has no XLA program to lint: "
                        "one lint_skipped line says so")
    return p


def resolve_dataset_files(train_file: str, val_file: str) -> tuple[str, str]:
    """Explicit paths win; otherwise train.json and val.json beside the
    first Valohai ``dataset`` input (the JAX CLI's fallback)."""
    if train_file:
        return train_file, val_file
    try:
        import valohai  # type: ignore

        base = os.path.dirname(valohai.inputs("dataset").path())
        return os.path.join(base, "train.json"), os.path.join(base, "val.json")
    except Exception:
        raise SystemExit(
            "no --train-file given and no Valohai 'dataset' input available; "
            "pass --train-file/--val-file"
        ) from None


def train(argv: list[str] | None = None, *, loaded=None):
    """Training (``main`` without a subcommand): load the records, build
    the Trainer (which resumes from ``--output-dir``'s newest verified
    checkpoint), run every epoch; the trainer saves the model under
    ``--output-dir`` when the run completes.  Returns the trainer, whose
    ``history`` holds each step's metrics and ``result`` what its
    ``train`` returned.
    ``loaded``: a model built by the caller, trained in place of
    ``--model-ckpt``'s (``Trainer``).  The process joins its process group
    (``core/mesh.py initialize_distributed``) before the model is built.
    ``--dry-run`` prints the resolved ``TrainConfig`` and returns None,
    before any device or dataset is touched."""
    import dataclasses

    from distributed_llms_example_tpu_torch.core.config import (
        check_mesh_composition,
        config_from_args,
    )
    from distributed_llms_example_tpu_torch.core.mesh import initialize_distributed
    from distributed_llms_example_tpu_torch.data.dataset import load_json_records
    from distributed_llms_example_tpu_torch.train.trainer import Trainer

    parser = build_train_parser()
    args = parser.parse_args(argv)
    try:
        cfg = config_from_args(args)
    except ValueError as e:
        parser.error(str(e))
    if args.dry_run:
        print(cfg.to_json())
        return None
    train_file, val_file = resolve_dataset_files(cfg.train_file, cfg.val_file)
    if val_file != cfg.val_file:  # a Valohai val.json: the eval rows against the mesh again
        check_mesh_composition(dataclasses.replace(cfg, val_file=val_file))
    cfg = dataclasses.replace(cfg, train_file=train_file, val_file=val_file)
    initialize_distributed(cfg.coordinator_address, cfg.num_processes, cfg.process_id,
                           device_type=cfg.device)
    if args.lint != "off":
        from distributed_llms_example_tpu_torch.utils.jsonlog import log_json

        log_json({"event": "lint_skipped", "lint": args.lint,
                  "reason": "the JAX CLI's lints read the compiled XLA program; the port has none"})
    # the JAX CLI's rule: a validation file is read only when it is given
    # and exists
    val = cfg.val_file
    val_records = load_json_records(val) if val and os.path.exists(val) else None
    trainer = Trainer(cfg, load_json_records(cfg.train_file), val_records=val_records,
                      loaded=loaded)
    trainer.train()
    return trainer


def main(argv: list[str] | None = None) -> int:
    if argv is None:
        argv = sys.argv[1:]
    if argv and argv[0] == "serve":
        return serve_main(argv[1:])
    if argv and argv[0] == "serve-router":
        serve_router(argv[1:])
        return 0
    if argv and argv[0] == "serve-loadgen":
        serve_loadgen(argv[1:])
        return 0
    train(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
