#!/usr/bin/env python3
"""Chip smoke for the PyTorch port: builds the CUDA kernels, holds each
against its plain PyTorch version on the card, serves bart-large-cnn at
full width through the port's ``serve`` entry, and checks that the serve
run went through both kernels.

    python3 chip_smoke.py        # from the repository root, on one NVIDIA GPU

Phases (each fatal, non-zero exit, no result line):
  1. device: a CUDA card; prints nvidia-smi's name and power limit
  2. build: one nvcc per kernel source, all at once (ptxas report printed)
  3. kernels vs plain versions at the serve shapes and at lengths no tile
     divides (bf16 atol=rtol 2e-2, fp32 atol 1e-4, fully-masked rows
     exactly zero), timed with CUDA events beside the plain version, SDPA
     (the yardstick, never called by the port) and the bound
     max(flops / 989 TFLOP/s, bytes / 3.35 TB/s)
  4. serve: the CLI's serve entry in-process, bart-large-cnn, bf16, seed 0,
     16 prompts of 200-1024 byte-tokens, 8 slots, 128 new tokens, source
     1024; launch counters zeroed before and read after; first-step logits
     with the kernels vs with their plain versions (fp32 atol 1e-4, which a
     decode mask shifted by one must break), plus the difference from plain
     softmax attention and the greedy token match rate of a whole serve run
     on that path; then a shorter run at source 1000 and 64 new tokens,
     whose counters must show both kernels too
  5. a {"kernels": [...]} line, then the last line
     {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}

Imports nothing of JAX or of the JAX package.  Everything it writes goes
under build/chip_smoke/ in the checkout.
"""

from __future__ import annotations

import contextlib
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
PEAK_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core rate
PEAK_BYTES = 3.35e12  # H100 SXM HBM3 rate
NUM_LAYERS = 12  # bart-large-cnn encoder layers = decoder layers
# fp32 first-step logits, kernel path vs plain path, through all 24 layers:
# read 2.4e-6 on an H100 (PERF.md), so 1e-4 leaves ~40x of room while a
# decode mask shifted by one moves them far more (the planted-fault check)
FP32_LOGITS_ATOL = 1e-4
WORK = os.path.join(HERE, "build", "chip_smoke")


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def say(obj) -> None:
    print(json.dumps(obj) if isinstance(obj, dict) else obj, flush=True)


def time_ms(fn, *, per_rep: int, reps: int = 7) -> float:
    """Median over ``reps`` of (CUDA-event time of ``per_rep`` calls) /
    ``per_rep``, after a warm-up."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(per_rep):
            fn()
        end.record()
        torch.cuda.synchronize()
        out.append(start.elapsed_time(end) / per_rep)
    return statistics.median(out)


def profile_device(fn, n: int):
    """(wall ms per call, {kernel name: device ms per call}) over ``n``
    calls under torch.profiler; device times are the CUDA kernels' own."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels: dict[str, float] = {}
    for e in prof.key_averages():
        if not str(e.device_type).endswith("CUDA"):
            continue
        t = getattr(e, "self_device_time_total", None)
        if t is None:
            t = getattr(e, "self_cuda_time_total", 0.0)
        kernels[e.key] = kernels.get(e.key, 0.0) + t / n / 1e3
    return wall / n * 1e3, kernels


def device_ms_of(fn, n: int, name: str):
    """Device ms per call of the kernels named ``name``, or None when two
    profiler sessions in a row record none of them."""
    for _ in range(2):
        _, kernels = profile_device(fn, n)
        hits = [v for k, v in kernels.items() if name in k]
        if hits:
            return sum(hits)
    return None


def bound(flops: float, nbytes: float) -> tuple[float, str]:
    t_ops, t_bytes = flops / PEAK_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def check_close(name, got, want, *, atol, rtol=0.0):
    import torch

    err = (got.float() - want.float()).abs()
    ok = bool(torch.isfinite(got.float()).all()) and bool(
        (err <= atol + rtol * want.float().abs()).all()
    )
    max_err = float(err.max())
    say({"phase": "kernel_check", "case": name, "max_abs_err": max_err, "atol": atol,
         "rtol": rtol, "ok": ok})
    if not ok:
        fail(f"{name}: kernel disagrees with its plain version (max abs err {max_err})")
    return max_err


def kernel_phase(torch, fa):
    import torch.nn.functional as F

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    B, H, S, D = 8, 16, 1024, 64
    results = {}

    # ---- kernel 1: flash-attention forward at the encoder's prefill shape
    def qkv(dtype, s=S):
        return [torch.randn(B, H, s, D, generator=gen, device=dev).to(dtype) for _ in range(3)]

    lens = torch.randint(200, S + 1, (B,), generator=gen, device=dev)
    pad_bias = torch.where(torch.arange(S, device=dev)[None, :] < lens[:, None], 0.0, -1e9)
    pad_bias = pad_bias[:, None, None, :].float().contiguous()
    errs = []
    for dtype, tol in ((torch.bfloat16, dict(atol=2e-2, rtol=2e-2)), (torch.float32, dict(atol=1e-4))):
        q, k, v = qkv(dtype)
        o, lse = fa.flash_attention(q, k, v, pad_bias, return_lse=True)
        po, plse = fa.flash_attention_plain(q, k, v, pad_bias)
        torch.cuda.synchronize()
        errs.append(check_close(f"flash_fwd padding {dtype}", o, po, **tol))
        errs.append(check_close(f"flash_fwd padding lse {dtype}", lse, plse, **tol))
    q, k, v = qkv(torch.bfloat16)
    o = fa.flash_attention(q, k, v, causal=True)
    po, _ = fa.flash_attention_plain(q, k, v, causal=True)
    errs.append(check_close("flash_fwd causal bf16", o, po, atol=2e-2, rtol=2e-2))
    qf, kf, vf = qkv(torch.float32)
    dead_bias = torch.zeros(B, 1, S, S, device=dev)
    dead = torch.tensor([0, 7, 500, S - 1], device=dev)
    dead_bias[:, :, dead, :] = -float("inf")
    o, lse = fa.flash_attention(qf, kf, vf, dead_bias, return_lse=True)
    po, plse = fa.flash_attention_plain(qf, kf, vf, dead_bias)
    torch.cuda.synchronize()
    if not (bool((o[:, :, dead] == 0).all()) and bool((lse[:, :, dead] == fa.MASK_VALUE).all())):
        fail("flash_fwd: fully-masked rows are not exactly zero with lse = MASK_VALUE")
    live = torch.ones(S, dtype=torch.bool, device=dev)
    live[dead] = False
    errs.append(check_close("flash_fwd fully-masked rows fp32", o[:, :, live], po[:, :, live], atol=1e-4))
    # lengths that are no multiple of the 64-row tile: a 1000-token source
    # and a causal 200
    for dtype, s, causal, tol in ((torch.bfloat16, 1000, False, dict(atol=2e-2, rtol=2e-2)),
                                  (torch.float32, 1000, False, dict(atol=1e-4)),
                                  (torch.float32, 200, True, dict(atol=1e-4))):
        q, k, v = qkv(dtype, s)
        rb = None if causal else pad_bias[..., :s].contiguous()
        o, lse = fa.flash_attention(q, k, v, rb, causal=causal, return_lse=True)
        po, plse = fa.flash_attention_plain(q, k, v, rb, causal=causal)
        torch.cuda.synchronize()
        errs.append(check_close(f"flash_fwd S={s} causal={causal} {dtype}", o, po, **tol))
        errs.append(check_close(f"flash_fwd S={s} causal={causal} lse {dtype}", lse, plse, **tol))

    q, k, v = qkv(torch.bfloat16)
    sdpa_mask = pad_bias.to(torch.bfloat16)
    ms = time_ms(lambda: fa.flash_attention(q, k, v, pad_bias), per_rep=10)
    plain_ms = time_ms(lambda: fa.flash_attention_plain(q, k, v, pad_bias), per_rep=3)
    lib_ms = time_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=sdpa_mask), per_rep=10)
    flops = 4.0 * B * H * S * S * D
    nbytes = 4 * B * H * S * D * 2 + pad_bias.numel() * 4 + B * H * S * 4
    b_ms, b_by = bound(flops, nbytes)
    results["flash_attention_fwd"] = dict(
        max_abs_err=max(errs), ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
        library_ms=lib_ms,
    )
    say({"phase": "kernel_time", "kernel": "flash_attention_fwd", **results["flash_attention_fwd"],
         "device_ms": device_ms_of(lambda: fa.flash_attention(q, k, v, pad_bias), 10,
                                   "flash_fwd_kernel")})

    # ---- kernel 5: flash decode at the decoder's self-attention shape
    L = 128
    errs = []

    def dec_inputs(dtype, Q, offs, n=L):
        qd = torch.randn(B, H, Q, D, generator=gen, device=dev).to(dtype)
        kd = torch.randn(B, H, n, D, generator=gen, device=dev).to(dtype)
        vd = torch.randn(B, H, n, D, generator=gen, device=dev).to(dtype)
        return qd, kd, vd, torch.tensor(offs, dtype=torch.int32, device=dev)

    stagger = [0, 5, 17, 40, 64, 99, 120, 127]
    # the serve cache (L = 128), then a 64-slot cache (--max-new-tokens 64)
    # and a 200-slot one, which no 64-slot tile divides
    for dtype, Q, n, tol in (
        (torch.bfloat16, 1, L, dict(atol=2e-2, rtol=2e-2)),
        (torch.bfloat16, 8, L, dict(atol=2e-2, rtol=2e-2)),
        (torch.float32, 1, L, dict(atol=1e-4)),
        (torch.float32, 8, L, dict(atol=1e-4)),
        (torch.bfloat16, 1, 64, dict(atol=2e-2, rtol=2e-2)),
        (torch.float32, 8, 200, dict(atol=1e-4)),
    ):
        offs = [min(o * n // L, n - Q) for o in stagger]
        qd, kd, vd, off = dec_inputs(dtype, Q, offs, n)
        o = fa.flash_decode(qd, kd, vd, offsets=off)
        po = fa.flash_decode_plain(qd, kd, vd, offsets=off)
        torch.cuda.synchronize()
        errs.append(check_close(f"flash_decode Q={Q} L={n} {dtype}", o, po, **tol))
    qd, kd, vd, off = dec_inputs(torch.bfloat16, 1, stagger)
    dec_bias = torch.where(torch.rand(B, 1, 1, L, generator=gen, device=dev) > 0.2, 0.0, -1e9)
    o = fa.flash_decode(qd, kd, vd, dec_bias, offsets=off)
    po = fa.flash_decode_plain(qd, kd, vd, dec_bias, offsets=off)
    torch.cuda.synchronize()
    errs.append(check_close("flash_decode padding bias Q=1 bf16", o, po, atol=2e-2, rtol=2e-2))
    kq, ks = fa.quantize_kv(kd)
    vq, vs = fa.quantize_kv(vd)
    o = fa.flash_decode(qd, kq, vq, offsets=off, k_scale=ks, v_scale=vs)
    po = fa.flash_decode_plain(qd, kq, vq, offsets=off, k_scale=ks, v_scale=vs)
    torch.cuda.synchronize()
    errs.append(check_close("flash_decode int8 KV Q=1 bf16", o, po, atol=2e-2, rtol=2e-2))

    qd, kd, vd, off = dec_inputs(torch.bfloat16, 1, stagger)
    k_pos = torch.arange(L, device=dev)[None, None, None, :]
    sdpa_mask = k_pos <= off[:, None, None, None]
    ms = time_ms(lambda: fa.flash_decode(qd, kd, vd, offsets=off), per_rep=200)
    plain_ms = time_ms(lambda: fa.flash_decode_plain(qd, kd, vd, offsets=off), per_rep=50)
    lib_ms = time_ms(
        lambda: F.scaled_dot_product_attention(qd, kd, vd, attn_mask=sdpa_mask), per_rep=200
    )
    live = [min(L, o + 1) for o in stagger]
    flops = sum(4.0 * H * 1 * n * D for n in live)
    nbytes = sum(2 * H * n * D * 2 for n in live) + 2 * B * H * D * 2 + B * 4
    b_ms, b_by = bound(flops, nbytes)
    results["flash_decode"] = dict(
        max_abs_err=max(errs), ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
        library_ms=lib_ms,
    )
    say({"phase": "kernel_time", "kernel": "flash_decode", **results["flash_decode"],
         "device_ms": device_ms_of(lambda: fa.flash_decode(qd, kd, vd, offsets=off), 50,
                                   "flash_decode_kernel")})
    return results


def write_prompts(path: str, n: int = 16) -> None:
    import numpy as np

    rng = np.random.RandomState(0)
    alphabet = np.array(list("abcdefghijklmnopqrstuvwxyz      .,"))
    # byte tokenizer: n bytes + EOS = n + 1 tokens, so 199..1023 bytes give 200..1024
    texts = ["".join(rng.choice(alphabet, rng.randint(199, 1024))) for _ in range(n)]
    with open(path, "w") as f:
        json.dump(texts, f)


def set_impl(model, impl: str) -> None:
    from distributed_llms_example_tpu_torch.ops.mha import MultiHeadAttention

    for m in model.modules():
        if isinstance(m, MultiHeadAttention):
            m.attention_impl = impl


@contextlib.contextmanager
def plain_kernels(fa):
    """Route the model's two kernel call sites to the kernels' plain
    versions on the same CUDA tensors (the wrappers themselves never fall
    back), so the kernel path and the plain path differ only in the kernels."""
    from distributed_llms_example_tpu_torch.ops import mha

    def fwd(q, k, v, bias=None, *, causal=False, dtype=None):
        return fa.flash_attention_plain(q, k, v, bias, causal=causal)[0].to(dtype or q.dtype)

    def dec(q, k, v, bias=None, *, offsets, dtype=None):
        return fa.flash_decode_plain(q, k, v, bias, offsets=offsets).to(dtype or q.dtype)

    saved = mha.flash_attention, mha.flash_decode
    mha.flash_attention, mha.flash_decode = fwd, dec
    try:
        yield
    finally:
        mha.flash_attention, mha.flash_decode = saved


@contextlib.contextmanager
def planted_fault(fa):
    """The model's decode call site with the kernel's per-row length mask
    shifted by one (row r attends slots <= offsets[b] + r + 1): a fault
    that touches only not-yet-written, zero-initialised cache slots, which
    the serve-path logits check must see."""
    from distributed_llms_example_tpu_torch.ops import mha

    def dec(q, k, v, bias=None, *, offsets, dtype=None):
        return fa.flash_decode(q, k, v, bias, offsets=offsets + 1, dtype=dtype)

    saved = mha.flash_decode
    mha.flash_decode = dec
    try:
        yield
    finally:
        mha.flash_decode = saved


def first_step_logits(torch, model, ids, mask):
    from distributed_llms_example_tpu_torch.evaluation.generation import init_cache

    with torch.inference_mode():
        enc = model.encode(ids, mask)
        ckv = model.cross_kv(enc)
        B = ids.shape[0]
        cache = init_cache(model, B, 128, device=ids.device)
        tok = torch.full((B, 1), model.config.decoder_start_token_id, device=ids.device)
        offs = torch.zeros(B, dtype=torch.int32, device=ids.device)
        return model.decode(tok, None, mask, cache=cache, cache_offset=offs, cross_kv=ckv).float()


def where_the_time_goes(torch, engine) -> None:
    """Profile one admission prefill and 8 steady decode rounds of a fresh
    session on the served engine: wall vs device-busy time per call and the
    heaviest kernels.  Runs after the counted serve run."""
    import numpy as np

    S, W = engine.S, engine.W
    rng = np.random.RandomState(1)
    reqs = [list(rng.randint(4, 200, W - 1)) + [2] for _ in range(S)]
    ids = torch.as_tensor(np.array(reqs), device=engine.device)
    mask = torch.ones_like(ids, dtype=torch.int32)
    for what, fn, n in (
        ("prefill_chunk", lambda: engine._prefill(ids, mask), 3),
        ("decode_round", None, 8),
    ):
        if fn is None:
            sess = engine.open()
            for r in reqs:
                sess.submit(r)
            sess.step()  # admission + first step, outside the window
            fn = sess.step
        wall, kernels = profile_device(fn, n)
        busy = sum(kernels.values())
        top = sorted(kernels.items(), key=lambda kv: -kv[1])[:6]
        say({"phase": "where_the_time_goes", "call": what, "wall_ms": wall,
             "device_busy_ms": busy, "device_idle_share": max(0.0, 1 - busy / wall),
             "top_kernels_ms": {k[:60]: v for k, v in top}})


def serve_phase(torch, fa, cli):
    os.makedirs(WORK, exist_ok=True)
    prompts = os.path.join(WORK, "prompts.json")
    write_prompts(prompts)
    args = [
        "--model-ckpt", "bart-large-cnn", "--prompts-file", prompts,
        "--max-slots", "8", "--max-new-tokens", "128", "--max-source-length", "1024",
        "--compute-dtype", "bfloat16", "--seed", "0", "--log-every-steps", "64",
        "--lint", "off",
    ]
    out_k = os.path.join(WORK, "serve_kernel.jsonl")
    fa.flash_attention.launches = 0
    fa.flash_decode.launches = 0
    t0 = time.perf_counter()
    engine, outs_k = cli.serve([*args, "--output-file", out_k])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"flash_attention_fwd": fa.flash_attention.launches,
                "flash_decode": fa.flash_decode.launches}
    stats = engine.last_stats
    with open(out_k) as f:
        recs = [json.loads(line) for line in f]
    if len(recs) != 16:
        fail(f"serve wrote {len(recs)} records for 16 prompts")
    want = {"flash_attention_fwd": NUM_LAYERS * stats.prefill_calls,
            "flash_decode": NUM_LAYERS * stats.decode_steps}
    say({"phase": "serve_launches", "launches": launches, "expected": want,
         "prefill_calls": stats.prefill_calls, "decode_steps": stats.decode_steps})
    if any(launches[k] == 0 or launches[k] != want[k] for k in want):
        fail(f"serve run did not go through both kernels as expected: {launches} vs {want}")
    where_the_time_goes(torch, engine)
    p50, p95 = stats.ttft_percentiles()
    serve_numbers = {
        "phase": "serve", "wall_s": wall, "decode_tokens": stats.decode_tokens,
        "decode_steps": stats.decode_steps, "decode_tokens_per_sec": stats.tokens_per_sec(),
        "ttft_p50_ms": p50 * 1e3, "ttft_p95_ms": p95 * 1e3,
        "prefill_seconds": stats.prefill_seconds, "decode_seconds": stats.decode_seconds,
        "peak_mem_bytes": torch.cuda.max_memory_allocated(),
    }

    # kernel path vs plain path: first decode step's logits, then greedy
    # tokens of a whole serve run on the plain path
    from distributed_llms_example_tpu_torch.data.tokenizer import ByteTokenizer

    model = engine.model
    tok = ByteTokenizer()
    with open(prompts) as f:
        texts = json.load(f)[:8]
    enc_ids = [tok.encode_source(t, 1024) for t in texts]
    ids = torch.full((8, 1024), model.config.pad_token_id, dtype=torch.long, device="cuda")
    mask = torch.zeros((8, 1024), dtype=torch.int32, device="cuda")
    for r, row in enumerate(enc_ids):
        ids[r, : len(row)] = torch.tensor(row, device="cuda")
        mask[r, : len(row)] = 1
    set_impl(model, "auto")
    logits_k = first_step_logits(torch, model, ids, mask)
    with plain_kernels(fa):
        logits_p = first_step_logits(torch, model, ids, mask)
    set_impl(model, "xla")
    logits_x = first_step_logits(torch, model, ids, mask)
    set_impl(model, "auto")
    # fp32 copy of the same weights: the reference both bf16 paths round away from
    from distributed_llms_example_tpu_torch.models.bart import BartForConditionalGeneration

    ref = BartForConditionalGeneration(model.config, dtype=torch.float32,
                                       param_dtype=torch.float32, device="cuda")
    ref.load_state_dict(model.state_dict())
    logits_rk = first_step_logits(torch, ref, ids, mask)
    with plain_kernels(fa):
        logits_r = first_step_logits(torch, ref, ids, mask)
    with planted_fault(fa):
        logits_f = first_step_logits(torch, ref, ids, mask)
    del ref
    d = lambda a, b: float((a - b).abs().max())  # noqa: E731
    finite = all(bool(torch.isfinite(x).all()) for x in (logits_k, logits_rk))
    shape_ok = list(logits_k.shape) == [8, 1, model.config.vocab_size]
    err32, err16 = d(logits_rk, logits_r), d(logits_k, logits_p)
    fault32 = d(logits_f, logits_r)
    noise16 = d(logits_p, logits_r)  # plain path in bf16 vs the fp32 reference
    argmax16 = float((logits_k.argmax(-1) == logits_p.argmax(-1)).float().mean())
    say({"phase": "logits_kernel_vs_plain", "shape": list(logits_k.shape), "finite": finite,
         "fp32_max_abs_err": err32, "fp32_atol": FP32_LOGITS_ATOL,
         "fp32_planted_fault_err": fault32,
         "bf16_max_abs_err": err16, "bf16_kernel_vs_fp32": d(logits_k, logits_r),
         "bf16_plain_vs_fp32": noise16, "bf16_plain_attention_vs_fp32": d(logits_x, logits_r),
         "bf16_kernel_vs_plain_attention": d(logits_k, logits_x),
         "bf16_argmax_match": argmax16, "max_abs_logit": float(logits_r.abs().max())})
    # fp32: the kernel path must match the plain path to FP32_LOGITS_ATOL
    # through all 24 layers, and the decode mask shifted by one must break
    # that limit.  bf16: two plain implementations already differ by ~5e-2
    # there (rounding through 24 layers), so the kernel path is held to the
    # plain path's own distance from the fp32 reference, with 1.5x headroom,
    # and must pick the same first token.
    if not (finite and shape_ok):
        fail(f"first-step logits: finite={finite}, shape {list(logits_k.shape)}")
    if err32 > FP32_LOGITS_ATOL:
        fail(f"fp32 first-step logits: kernel path vs plain path max abs err {err32}")
    if not fault32 > FP32_LOGITS_ATOL:
        fail(f"fp32 first-step logits: a decode mask shifted by one moves them only {fault32}")
    if d(logits_k, logits_r) > 1.5 * noise16 or argmax16 < 1.0:
        fail(f"bf16 first-step logits: kernel path {d(logits_k, logits_r)} from fp32 against "
             f"the plain path's {noise16}, argmax match {argmax16}")

    out_p = os.path.join(WORK, "serve_plain.jsonl")
    _, outs_p = cli.serve([*args, "--attention-impl", "xla", "--output-file", out_p])
    same = sum(x == y for ra, rb in zip(outs_k, outs_p) for x, y in zip(ra, rb))
    total = sum(max(len(ra), len(rb)) for ra, rb in zip(outs_k, outs_p))
    serve_numbers["greedy_token_match_rate"] = same / max(total, 1)
    say(serve_numbers)
    ragged_serve(fa, cli, args)
    return launches


def ragged_serve(fa, cli, args) -> None:
    """A second, shorter serve run at lengths no 64-slot tile divides evenly
    or that the TPU rule would not tile: a 1000-token source and a 64-slot
    decode cache.  Both kernels must still carry every attention call they
    own (counts zeroed before, read after)."""
    from distributed_llms_example_tpu_torch.ops.mha import select_attention_impl, select_decode_impl

    picked = (select_attention_impl("auto", head_dim=64, q_len=1000, kv_len=1000,
                                    use_cache=False, backend="cuda")[0],
              select_decode_impl("auto", head_dim=64, q_len=1, kv_len=64, backend="cuda")[0])
    if picked != ("flash", "flash_decode"):
        fail(f"auto on CUDA picks {picked} for a 1000-token source / 64-slot cache")
    argv = [*args, "--max-new-tokens", "64", "--max-source-length", "1000",
            "--output-file", os.path.join(WORK, "serve_ragged.jsonl")]
    fa.flash_attention.launches = 0
    fa.flash_decode.launches = 0
    engine, outs = cli.serve(argv)
    launches = {"flash_attention_fwd": fa.flash_attention.launches,
                "flash_decode": fa.flash_decode.launches}
    stats = engine.last_stats
    want = {"flash_attention_fwd": NUM_LAYERS * stats.prefill_calls,
            "flash_decode": NUM_LAYERS * stats.decode_steps}
    say({"phase": "serve_ragged", "max_source_length": 1000, "max_new_tokens": 64,
         "launches": launches, "expected": want, "records": len(outs),
         "decode_tokens_per_sec": stats.tokens_per_sec()})
    if len(outs) != 16 or any(launches[k] == 0 or launches[k] != want[k] for k in want):
        fail(f"ragged serve run: {len(outs)} records, launches {launches} vs {want}")


def main() -> None:
    if not os.path.isdir(os.path.join(HERE, "distributed_llms_example_tpu_torch")):
        fail("the port's package is not beside chip_smoke.py: run it from a checkout")
    sys.path.insert(0, HERE)
    import torch

    # phase 1: device
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this check needs an NVIDIA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    say(smi.stdout.strip().splitlines()[0])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # phase 2: build every kernel of the path, one nvcc each, in parallel
    from distributed_llms_example_tpu_torch.ops import cuda_build
    from distributed_llms_example_tpu_torch.ops import flash_attention as fa

    t0 = time.perf_counter()
    secs = cuda_build.build(["flash_fwd", "flash_decode"], verbose=True)
    say({"phase": "build", "seconds": time.perf_counter() - t0, "per_kernel_s": secs})

    # phase 3: kernels against their plain versions
    measured = kernel_phase(torch, fa)

    # phase 4: the main path
    from distributed_llms_example_tpu_torch.launch import cli

    launches = serve_phase(torch, fa, cli)

    # phase 5: the kernel list, then the contract line
    rows = [
        dict(name="flash_attention_fwd", route="cuda",
             source="distributed_llms_example_tpu_torch/csrc/flash_fwd.cu",
             replaces="distributed_llms_example_tpu/ops/flash_attention.py:119",
             launches=launches["flash_attention_fwd"], **measured["flash_attention_fwd"]),
        dict(name="flash_decode", route="cuda",
             source="distributed_llms_example_tpu_torch/csrc/flash_decode.cu",
             replaces="distributed_llms_example_tpu/ops/flash_attention.py:931",
             launches=launches["flash_decode"], **measured["flash_decode"]),
    ]
    say({"kernels": rows})
    say({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
