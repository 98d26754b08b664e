"""Command line for the PyTorch port (port of the JAX package's
``launch/cli.py``): training without a subcommand, and ``serve``.

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
registry but Mixtral, and encodes a seq2seq model's prompts as sources
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
``fsdp=N`` (sharded, FSDP2) or ``data=a,fsdp=b`` (HSDP).  The group is
NCCL on CUDA and gloo with ``--device cpu`` (``core/mesh.py``).  Without
``--train-file``, ``train.json`` and ``val.json`` beside the Valohai
``dataset`` input are read.  ``serve``'s ``--mesh`` accepts one-device
layouts only; multi-GPU serving, ``serve-router`` and ``serve-loadgen`` are
later slices (ROADMAP.md).
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
                   help="one-device layouts only (every axis 1 or -1)")
    p.add_argument("--compute-dtype", type=str, default="bfloat16")
    p.add_argument("--lint", type=str, default="warn", choices=("off", "warn", "strict"))
    return p


def check_single_device_mesh(spec: str) -> None:
    """Accept a ``--mesh`` layout only if it places everything on one device."""
    sizes = []
    for part in filter(None, (s.strip() for s in spec.split(","))):
        name, _, val = part.partition("=")
        if not val:
            raise SystemExit(f"--mesh {spec!r}: expected axis=size pairs")
        sizes.append(int(val))
    if math.prod(1 if n == -1 else n for n in sizes) != 1:
        raise SystemExit(
            f"--mesh {spec!r}: the port serves on one GPU; multi-GPU serving is a "
            "later slice (ROADMAP.md)"
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


def _write_serve_output(args, lm, tok, prompts, outputs) -> None:
    """Request outputs (the served product): JSONL on stdout or, with
    ``--output-file``, one ``os.write`` per line and an fsync on close."""
    from distributed_llms_example_tpu_torch.serving.engine import trim_eos
    from distributed_llms_example_tpu_torch.utils.jsonlog import log_json

    eos, pad = lm.config.eos_token_id, lm.config.pad_token_id
    lines = []
    for prompt, ids in zip(prompts, outputs):
        kept = [t for t in trim_eos(ids, eos, pad) if t != eos]
        lines.append({"prompt": prompt, "output": tok.decode(kept), "tokens": len(kept)})
    if not args.output_file:
        for rec in lines:
            sys.stdout.write(json.dumps(rec) + "\n")
        return
    parent = os.path.dirname(args.output_file)
    if parent:
        os.makedirs(parent, exist_ok=True)
    fd = os.open(args.output_file, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o644)
    try:
        for rec in lines:
            data = (json.dumps(rec) + "\n").encode("utf-8")
            while data:
                data = data[os.write(fd, data):]
        os.fsync(fd)
    finally:
        os.close(fd)
    log_json({"event": "serve_output", "path": args.output_file, "records": len(lines)})


def serve(argv: list[str] | None = None, *, loaded=None):
    """The ``serve`` subcommand: load → continuous-batching decode → write
    outputs.  Returns ``(engine, outputs)``: the engine's ``last_stats``
    hold the run, ``outputs`` the generated ids per prompt.  ``loaded``: a
    model built by the caller (a ``LoadedModel`` on the device), served in
    place of ``--model-ckpt``'s."""
    from distributed_llms_example_tpu_torch.core.config import SPEC_MAX_DRAFT_TOKENS

    parser = build_serve_parser()
    args = parser.parse_args(argv)
    if not 0 <= args.spec_tokens <= SPEC_MAX_DRAFT_TOKENS:
        parser.error(f"--spec-tokens {args.spec_tokens}: must be in [0, {SPEC_MAX_DRAFT_TOKENS}] "
                     f"(the verify pass scores spec_tokens + 1 rows; the decode kernels take "
                     f"at most {SPEC_MAX_DRAFT_TOKENS + 1})")
    from distributed_llms_example_tpu_torch.core.precision import parse_dtype, resolve_device
    from distributed_llms_example_tpu_torch.data.dataset import load_json_records
    from distributed_llms_example_tpu_torch.data.tokenizer import get_tokenizer
    from distributed_llms_example_tpu_torch.models.registry import load_model
    from distributed_llms_example_tpu_torch.serving.engine import ServingEngine
    from distributed_llms_example_tpu_torch.utils.jsonlog import log_json

    device = resolve_device(args.device)
    check_single_device_mesh(args.mesh)
    serve_cfg = _serve_config_from_args(args)
    records = load_json_records(args.prompts_file)
    if args.num_prompts > 0:
        records = records[: args.num_prompts]
    prompts = [_prompt_text(r, args.source_column) for r in records]
    lm = loaded or load_model(
        args.model_ckpt, dtype=parse_dtype(args.compute_dtype), device=device,
        attention_impl=args.attention_impl or None, seed=args.seed,
    )
    if args.lint != "off":
        log_json({"event": "lint_skipped", "lint": args.lint,
                  "reason": "the serving lints read XLA cache specs; the port has none yet"})
    tok = get_tokenizer(args.tokenizer, args.model_ckpt)
    encode = tok.encode_source if lm.is_seq2seq else tok.encode_prompt
    requests = [encode(t, args.max_source_length) for t in prompts]
    engine = ServingEngine(lm.module, lm.config, serve_cfg, is_seq2seq=lm.is_seq2seq,
                           device=device)
    outputs = engine.generate(requests)
    _write_serve_output(args, lm, tok, prompts, outputs)
    return engine, outputs


def serve_main(argv: list[str] | None = None) -> int:
    serve(argv)
    return 0


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

    from distributed_llms_example_tpu_torch.core.config import config_from_args
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
    if argv and argv[0] in ("serve-router", "serve-loadgen"):
        raise SystemExit(f"{argv[0]} is a later slice of the port (ROADMAP.md)")
    train(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
