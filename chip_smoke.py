#!/usr/bin/env python3
"""Chip smoke for the PyTorch port: builds the CUDA kernels, holds each
against its plain PyTorch version on the card, serves bart-large-cnn at
full width through the port's ``serve`` entry and fine-tunes it through the
train entry, fine-tunes t5-large and serves flan-t5-xl at full width the
same ways, serves llama-2-7b at full width through ``serve --paged-kv`` and
through the flat cache, and checks that each run went through its kernels.

    python3 chip_smoke.py    # from the repository root, on one NVIDIA GPU

Phases (each fatal, non-zero exit, no result line):
  1. device: a CUDA card; prints nvidia-smi's name and power limit
  2. build: one nvcc per kernel source, all nine at once (ptxas report);
     the HGMMA instructions of every instance of the tensor-core forward
     and of both tensor-core backward kernels (cuobjdump -sass), none of
     which may have 0
  3. kernels vs plain versions at the main paths' shapes and at lengths no
     tile divides, timed with CUDA events beside the plain version, the
     library yardstick (never called by the port) and the bound
     max(flops / 989 TFLOP/s, bytes / 3.35 TB/s), kernel 1's over the live
     keys of its padding mask, since it skips the tiles the mask zeroes:
     - flash forward / decode (bf16 atol=rtol 2e-2, fp32 atol 1e-4,
       fully-masked rows exactly zero);
     - the tensor-core forward (bf16) at head dims 16, 32, 64 and 128 in
       every case the main paths give it (padding, causal, learned bias
       with padding and with causal, -inf rows, S = 1000 and 200, one query
       row against 1024 keys, 128 x 768 cross): within 2e-2 of the plain
       version and, against an fp32 reference on the same values, within
       1.5x the plain bf16 path's own error; K rows permuted inside one
       64-key tile must break that limit by 10x;
     - flash backward dq and dk/dv at the encoder, decoder-causal, cross
       and ragged shapes (same limits; -inf rows give exactly zero dq);
     - the tensor-core backward (bf16) at head dims 16, 32, 64 and 128 in
       every case the train paths give it (padding S = 1024, causal 128,
       cross 128 x 1024, S = 1000, causal 200, -inf rows, learned bias
       with padding and with causal): dq, dk and dv within 2e-2 of the
       plain version and, against an fp32 reference, within 1.5x the plain
       bf16 path's own error; K rows permuted inside one 64-key tile (read
       by the dq kernel) and Q and dO rows permuted inside one query tile
       (read by the dk/dv kernel) must break that limit by 10x; kernels 2
       and 3 timed on both branches with their bounds over the live keys
       (the tiles the mask zeroes are skipped) and over all keys;
     - fused dropout: exactly equal in bf16 and fp32, kept fraction within
       1e-3 of 1 - rate;
     - fused AdamW: p', mu', nu' within AdamW_RTOL, health sums within
       1e-5 relative, NaN counted once;
     - paged flash decode at the llama-2-7b decode shape (72-block pool in
       scrambled order, sentinel tiles in the prompt gap and past the
       budget, padding bias; Q = 1 and 8, bf16 / fp32 / int8 / GQA 32:8,
       the limits of flash decode); flash decode over the gathered view of
       the same blocks against the same plain output (the flat LLaMA
       path's d = 128 shape) and bit for bit against paged decode; and a
       planted fault (a gap sentinel read as a poisoned block) that must
       break the fp32 limit by orders of magnitude;
     - the learned-bias branch of kernels 1-3 and the learned-bias gradient
       (kernel 4) at the t5-large shapes, scale 1: encoder (8, 16, 1024,
       64) with a ragged padding mask, a 1000-token encoder, the causal
       decoder (8, 16, 128, 64), -inf rows (the same limits; dlbias within
       2e-2 bf16 / 1e-4 fp32 of its largest entry, exactly 0 on dead rows
       and above the causal diagonal); kernel 4 summing B - 1 rows must
       break the fp32 limit by orders of magnitude; SDPA forward + backward
       with the bias as a grad-requiring mask as the yardstick, and SDPA
       forward with the summed masks beside kernel 1
  4. serve: the CLI's serve entry in-process, bart-large-cnn, bf16, seed 0,
     16 prompts of 200-1024 byte-tokens, 8 slots, 128 new tokens, source
     1024; launch counters zeroed before and read after (on every bf16 main
     path each launch of kernels 1-3 must be a tensor-core one); first-step logits
     with the kernels vs with their plain versions (fp32 atol 1e-4, which a
     decode mask shifted by one must break), plus the difference from plain
     softmax attention and the greedy token match rate of a whole serve run
     on that path; then a shorter run at source 1000 and 64 new tokens,
     whose counters must show both kernels too
  5. train: the CLI's train entry in-process, bart-large-cnn at full width,
     bf16, batch 8, source 1024 / target 128, 48 synthetic records (6
     steps); every count of kernels 1, 2, 3, 7 and 8 equals what the model
     implies (attention modules, dropout sites, parameter tensors) times
     the steps; finite losses; non-zero q/k/v projection gradients; then
     three more steps timed for host enqueue vs finish on the card, and one
     under torch.profiler (device busy, kernels by group and by launches)
  6. gradient check: one fp32 forward+backward with dropout on, kernel
     path vs plain path (same seeds, so the same masks): loss, global grad
     norm and the largest per-tensor grad difference within limits that a
     backward dropout seed off by one must break; in bf16 the kernel path's
     gradient must stay within 1.5x the plain path's distance from fp32
  7. t5-large train: as phase 5 (same recipe and records), with kernel 4
     once per self-attention layer per step (72 / 72 / 72 / 48 a step for
     kernels 1 / 2 / 3 / 4) and non-zero gradients in both bucket tables
  8. T5 gradient check: fp32, t5-large widths at 2 + 2 layers, the recipe's
     batch, within phase 6's limits and each bucket table's gradient
     within relative L2 1e-5: with t5-large's relu MLP, kernels 2, 3 and 4
     vs their plain versions inside the model on one forward (δ of another
     batch row fed to kernel 4 must break it); with the gated-gelu MLP, the
     whole kernel path (kernels 1-4) vs the wholly plain path (the learned
     bias read one key off must break it); reported beside: the relu
     model's whole-path distance, each model's plain path nudged by one
     fp32 ulp; a rerun of the relu kernel path must give the same bits in
     every gradient, both bucket tables included (their lookup's
     backward is a fixed-order reduction)
  9. flan-t5-xl serve: phase 4's prompts and settings; kernel 1 once per
     encoder layer per prefill chunk, kernel 5 once per decoder layer per
     decode round, kernels 2, 3, 4 and 6 never; one profiled round
 10. T5 fp32 logits at flan-t5-xl widths, 2 + 2 layers: prefill + 5 decode
     steps at staggered per-row offsets, kernel path vs plain path within
     1e-4; the per-row relative bias shifted by one must break it
 11. llama-2-7b serve: the CLI's serve entry, bf16, seed 0, 16 byte-token
     prompts of 200-1024 tokens, 8 slots, 128 new tokens, source 1024,
     once with --paged-kv and once flat (the T5 model freed first);
     counters zeroed before and read after each: paged decode = attention
     modules x decode rounds and flash decode 0 on the paged run, the
     reverse on the flat one, flash forward 0 on both (the prompt prefill
     is plain attention, as in the JAX package); the pool drained; the
     greedy tokens of the two runs all equal; one profiled paged decode
     round
 12. fp32 logits at llama-2-7b widths, 2 layers: a prefill + 4 decode
     steps, paged and flat, kernel path vs plain path within 1e-4; a
     decode offset shifted by one must break it on each route
 13. a {"kernels_unported": []} line (every TPU kernel has a port), a
     {"kernels": [...]} line of all eight (kernels 1-3 name both sources),
     then the last line
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
# fp32 gradient check, kernel path vs plain path on one full-width batch
# with dropout on, through all 24 layers: read 4.8e-7 (loss), 4.8e-7 (grad
# norm), 1.2e-7 (largest per-tensor grad difference) and 2.4e-7 (relative
# L2 of the whole gradient) on an H100 (PERF.md), so these leave 20-40x of
# room, while a backward dropout seed off by one moves the grad norm by
# 3.7e-3 and a tensor's grads by 4.5e-3 (the planted-fault check)
# fp32 logits of a paged prefill + 4 decode steps at llama-2-7b widths (2
# layers), kernel 6 vs its plain version; a decode offset shifted by one
# must break it
LLAMA_FP32_ATOL = 1e-4
GRAD_LIMITS = {"loss_diff": 1e-5, "grad_norm_diff": 1e-5, "max_tensor_grad_diff": 5e-6,
               "grad_rel_l2": 1e-5}
# T5: each relative-position bucket table's gradient, kernel path vs plain
# path, relative L2 (fp32, 2+2 layers at t5-large widths); δ of another
# batch row fed to kernel 4 must break it
T5_TABLE_REL_L2 = 1e-5
# T5 with the gated-gelu MLP, whole kernel path vs wholly plain path (fp32):
# this random-init model's gradient has a rounding floor above those limits
# (its unscaled attention logits give peaked softmax rows whose backward
# cancels; PERF.md), so a gradient metric may also read up to this factor
# times what a one-ulp nudge of every attention output moves it in the same
# run; the loss limit stays
T5_NUDGE_FACTOR = 8.0
# fp32 logits of a T5 prefill + 5 decode steps at flan-t5-xl widths (2+2
# layers), kernels 1 and 5 vs their plain versions; the per-row relative
# bias shifted by one position must break it
T5_FP32_ATOL = 1e-4
# fused AdamW, kernel vs plain: both do one IEEE op at a time (the kernel
# with non-contracting intrinsics), so any difference is a fault; 2 fp32
# ulps of headroom for a library sqrt or division that rounds differently
ADAMW_RTOL = 2.4e-7
WORK = os.path.join(HERE, "build", "chip_smoke")
KERNELS = ["flash_fwd_tc", "flash_bwd_tc", "flash_fwd", "flash_decode", "flash_bwd",
           "flash_bwd_dlbias", "fused_dropout", "fused_adamw", "flash_decode_paged"]
# kernels 1-3 in bf16 against an fp32 reference on the same bf16 values:
# their error may be at most this factor times the plain bf16 path's own
TC_REF_FACTOR = 1.5
# a tile whose rows are permuted (what a wrong swizzle does) must break
# that limit by at least this factor
TC_FAULT_FACTOR = 10.0


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


def profile_device(fn, n: int, counts: dict | None = None):
    """(wall ms per call, {kernel name: device ms per call}) over ``n``
    calls under torch.profiler; device times are the CUDA kernels' own.
    ``counts``, when given, receives {kernel name: launches per call}."""
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
        if counts is not None:
            counts[e.key] = counts.get(e.key, 0.0) + e.count / n
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


def fwd_work(bias, B, H, S, D, extra_bytes=0):
    """(flops, bytes) kernel 1 needs at (B, H, S, S, D) bf16 under a (B, 1,
    1, S) padding mask: only each row's live keys (bias above -1e8) enter
    the products, and only their K and V rows need reading; q and o whole,
    the mask fp32, lse fp32, plus ``extra_bytes`` (a learned bias)."""
    live = (bias.reshape(B, -1) > -1e8).sum(dim=1).double()
    keys = float(live.sum())
    flops = 4.0 * H * S * keys * D
    nbytes = 2 * B * H * S * D * 2 + 2 * H * keys * D * 2 + bias.numel() * 4 + B * H * S * 4
    return flops, nbytes + extra_bytes


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
    b_ms, b_by = bound(*fwd_work(pad_bias, B, H, S, D))
    results["flash_attention_fwd"] = dict(
        max_abs_err=max(errs), ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
        library_ms=lib_ms,
    )
    say({"phase": "kernel_time", "kernel": "flash_attention_fwd", **results["flash_attention_fwd"],
         "device_ms": device_ms_of(lambda: fa.flash_attention(q, k, v, pad_bias), 10,
                                   "flash_fwd_tc_kernel")})

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


def tc_kernel_phase(torch, fa):
    """Kernel 1's tensor-core entry (bf16) at every head dim it is built
    for, in every case the main paths give it: (8, 16, 1024, d) with a
    ragged padding mask, the causal decoder (8, 16, 128, d), the learned
    bias (scale 1) with the padding mask and with causal, -inf rows, a
    1000-token source, a causal 200, one query row against 1024 keys
    (decode cross-attention under --attention-impl flash) and 128 x 768
    cross-attention.  Each case holds the kernel against its plain version
    (atol = rtol = 2e-2, lse too) and against an fp32 reference on the same
    bf16 values, where its error may be at most TC_REF_FACTOR times the
    plain bf16 path's own; -inf rows give exactly o = 0 and lse =
    MASK_VALUE.  A planted fault (K's rows permuted inside one 64-key tile,
    V kept, as a wrong swizzle would read them) must break that limit by
    TC_FAULT_FACTOR.  Returns the largest error against the plain version."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(7)
    B, H = 8, 16
    tol = dict(atol=2e-2, rtol=2e-2)

    def rnd(*shape, s=1.0):
        return (torch.randn(*shape, generator=gen, device=dev) * s).to(torch.bfloat16)

    def pad_bias(K):
        lens = torch.randint(K // 5, K + 1, (B,), generator=gen, device=dev)
        b = torch.where(torch.arange(K, device=dev)[None, :] < lens[:, None], 0.0, -1e9)
        return b[:, None, None, :].float().contiguous()

    def run(name, q, k, v, *, bias=None, lb=None, causal=False, scale=None, k_ref=None):
        """(max err vs plain, kernel's and plain's max err vs fp32 reference)."""
        o, lse = fa.flash_attention(q, k, v, bias, learned_bias=lb, causal=causal, scale=scale,
                                    return_lse=True)
        po, plse = fa.flash_attention_plain(q, k, v, bias, lbias=lb, causal=causal, scale=scale)
        kr = k if k_ref is None else k_ref
        ref, _ = fa.flash_attention_plain(q.float(), kr.float(), v.float(), bias, lbias=lb,
                                          causal=causal, scale=scale)
        torch.cuda.synchronize()
        err = kernel_err = plain_err = 0.0
        if k_ref is None:
            err = max(check_close(f"flash_fwd_tc {name}", o, po, **tol),
                      check_close(f"flash_fwd_tc {name} lse", lse, plse, **tol))
        kernel_err = float((o.float() - ref).abs().max())
        plain_err = float((po.float() - ref).abs().max())
        return err, kernel_err, plain_err, o, lse

    worst, fault = 0.0, None
    S = 1024
    dead = torch.tensor([0, 7, 500, S - 1], device=dev)
    dead_bias = torch.zeros(B, 1, S, S, device=dev)
    dead_bias[:, :, dead, :] = -float("inf")
    for D in fa.KERNEL_HEAD_DIMS:
        t5_q = D ** -0.5  # T5 carries 1/sqrt(d) in q and runs at scale 1
        cases = [
            ("padding S=1024", 1024, 1024, dict(bias=pad_bias(1024))),
            ("causal S=128", 128, 128, dict(causal=True)),
            ("learned bias + padding S=1024", 1024, 1024,
             dict(bias=pad_bias(1024), lb=rnd(1, H, 1024, 1024, s=0.5), scale=1.0)),
            ("learned bias causal S=128", 128, 128,
             dict(lb=rnd(1, H, 128, 128, s=0.5), causal=True, scale=1.0)),
            ("-inf rows S=1024", 1024, 1024, dict(bias=dead_bias)),
            ("padding S=1000", 1000, 1000, dict(bias=pad_bias(1000))),
            ("causal S=200", 200, 200, dict(causal=True)),
            ("Lq=1 Lk=1024 padding", 1, 1024, dict(bias=pad_bias(1024))),
            ("cross 128x768 padding", 128, 768, dict(bias=pad_bias(768))),
        ]
        for name, Q, K, kw in cases:
            q = rnd(B, H, Q, D, s=t5_q if "lb" in kw else 1.0)
            k, v = rnd(B, H, K, D), rnd(B, H, K, D)
            err, kernel_err, plain_err, o, lse = run(f"{name} d={D}", q, k, v, **kw)
            worst = max(worst, err)
            limit = TC_REF_FACTOR * plain_err
            ok = kernel_err <= limit
            say({"phase": "kernel_check", "case": f"flash_fwd_tc {name} d={D} vs fp32 reference",
                 "kernel_err": kernel_err, "plain_bf16_err": plain_err, "limit": limit,
                 "ratio": kernel_err / max(plain_err, 1e-30), "ok": ok})
            if not ok:
                fail(f"flash_fwd_tc {name} d={D}: {kernel_err} from the fp32 reference, beyond "
                     f"{TC_REF_FACTOR}x the plain bf16 path's {plain_err}")
            if "-inf" in name and not (bool((o[:, :, dead] == 0).all())
                                       and bool((lse[:, :, dead] == fa.MASK_VALUE).all())):
                fail(f"flash_fwd_tc d={D}: fully-masked rows are not o = 0, lse = MASK_VALUE")
            if D == 64 and name == "padding S=1024":
                fault = (q, k, v, kw, limit)
    # planted fault: keys 0-63 permuted within their tile (row r read as r ^ 7,
    # an 8-row swizzle phase off), values kept
    q, k, v, kw, limit = fault
    perm = torch.arange(64, device=dev) ^ 7
    k_bad = k.clone()
    k_bad[:, :, :64] = k[:, :, perm]
    _, fault_err, _, _, _ = run("planted fault", q, k_bad, v, k_ref=k, **kw)
    say({"phase": "kernel_check", "case": "flash_fwd_tc planted fault: K rows permuted in one "
         "64-key tile", "kernel_err": fault_err, "limit": limit,
         "times_limit": fault_err / limit, "must_exceed": TC_FAULT_FACTOR})
    if not fault_err >= TC_FAULT_FACTOR * limit:
        fail(f"flash_fwd_tc: a permuted K tile reads {fault_err}, under {TC_FAULT_FACTOR}x the "
             f"limit {limit}")
    return worst


def tc_backward_phase(torch, fa):
    """Kernels 2 and 3's tensor-core entries (bf16) at every head dim they
    are built for, in every case the train paths give them: the encoder's
    (8, 16, 1024, d) with a ragged padding mask, the causal decoder (8, 16,
    128, d), 128 x 1024 cross-attention with padding, a 1000-token source,
    a causal 200, -inf rows, and the learned bias (scale 1, q scaled by
    d^-1/2 as T5's init does) with the padding mask and with causal.  o and
    lse come from kernel 1.  Each case holds dq, dk and dv against the plain
    version (atol = rtol = 2e-2) and against an fp32 reference (the exact
    gradient on the same bf16 values), where each may be at most
    TC_REF_FACTOR times the plain bf16 path's own error; -inf rows give
    exactly dq = 0.  Two planted faults must break that limit by
    TC_FAULT_FACTOR: K's rows permuted inside one 64-key tile, read by the
    dq kernel; Q's and dO's rows permuted the same way inside one query
    tile, read by the dk/dv kernel (lse and delta in order).  Returns the
    largest error against the plain version, for dq and for dk/dv."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(9)
    B, H = 8, 16
    tol = dict(atol=2e-2, rtol=2e-2)

    def rnd(*shape, s=1.0):
        return (torch.randn(*shape, generator=gen, device=dev) * s).to(torch.bfloat16)

    def pad_bias(K):
        lens = torch.randint(K // 5, K + 1, (B,), generator=gen, device=dev)
        b = torch.where(torch.arange(K, device=dev)[None, :] < lens[:, None], 0.0, -1e9)
        return b[:, None, None, :].float().contiguous()

    def reference(q, k, v, do, bias, lb, causal, scale):
        """The exact gradient at these bf16 values, in fp32."""
        qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
        lbf = None if lb is None else lb.float()
        of, lsef = fa.flash_attention_plain(qf, kf, vf, bias, lbias=lbf, causal=causal,
                                            scale=scale)
        return fa.flash_attention_bwd_plain(qf, kf, vf, bias, of, lsef, dof, lbias=lbf,
                                            causal=causal, scale=scale)

    def kernels(q, k, v, do, bias, lb, causal, scale, *, k_dq=None, q_do_dkv=None):
        """(dq, dk, dv, o, lse) from kernels 1-3; the dq kernel may read
        ``k_dq`` for K, the dk/dv kernel ``q_do_dkv`` for (Q, dO)."""
        o, lse = fa.flash_attention(q, k, v, bias, learned_bias=lb, causal=causal, scale=scale,
                                    return_lse=True)
        delta = fa.attention_delta(do, o)
        kw = dict(lbias=lb, causal=causal, scale=scale)
        dq = fa.flash_bwd_dq(q, k if k_dq is None else k_dq, v, bias, do, lse, delta, **kw)
        qq, dd = (q, do) if q_do_dkv is None else q_do_dkv
        dk, dv = fa.flash_bwd_dkv(qq, k, v, bias, dd, lse, delta, **kw)
        return dq, dk, dv, o, lse

    def max_err(a, b):
        return float((a.float() - b.float()).abs().max())

    worst = {"dq": 0.0, "dkv": 0.0}
    fault = None
    S = 1024
    dead = torch.tensor([0, 7, 500, S - 1], device=dev)
    dead_bias = torch.zeros(B, 1, S, S, device=dev)
    dead_bias[:, :, dead, :] = -float("inf")
    for D in fa.KERNEL_HEAD_DIMS:
        cases = [
            ("encoder padding S=1024", 1024, 1024, dict(bias=pad_bias(1024))),
            ("causal S=128", 128, 128, dict(causal=True)),
            ("cross 128x1024 padding", 128, 1024, dict(bias=pad_bias(1024))),
            ("ragged padding S=1000", 1000, 1000, dict(bias=pad_bias(1000))),
            ("ragged causal S=200", 200, 200, dict(causal=True)),
            ("-inf rows S=1024", 1024, 1024, dict(bias=dead_bias)),
            ("learned bias + padding S=1024", 1024, 1024,
             dict(bias=pad_bias(1024), lb=rnd(1, H, 1024, 1024, s=0.5), scale=1.0)),
            ("learned bias causal S=128", 128, 128,
             dict(lb=rnd(1, H, 128, 128, s=0.5), causal=True, scale=1.0)),
        ]
        for name, Q, K, kw in cases:
            bias, lb, causal = kw.get("bias"), kw.get("lb"), kw.get("causal", False)
            scale = kw.get("scale", D ** -0.5)
            q = rnd(B, H, Q, D, s=D ** -0.5 if lb is not None else 1.0)
            k, v, do = rnd(B, H, K, D), rnd(B, H, K, D), rnd(B, H, Q, D)
            dq, dk, dv, o, lse = kernels(q, k, v, do, bias, lb, causal, scale)
            want = fa.flash_attention_bwd_plain(q, k, v, bias, o, lse, do, lbias=lb,
                                                causal=causal, scale=scale)
            ref = reference(q, k, v, do, bias, lb, causal, scale)
            torch.cuda.synchronize()
            limits = {}
            for n, g, w, r in zip(("dq", "dk", "dv"), (dq, dk, dv), want, ref):
                err = check_close(f"flash_bwd_tc {name} d={D} {n}", g, w, **tol)
                worst["dq" if n == "dq" else "dkv"] = max(worst["dq" if n == "dq" else "dkv"],
                                                          err)
                kernel_err, plain_err = max_err(g, r), max_err(w, r)
                limits[n] = limit = TC_REF_FACTOR * plain_err
                ok = kernel_err <= limit
                say({"phase": "kernel_check",
                     "case": f"flash_bwd_tc {name} d={D} {n} vs fp32 reference",
                     "kernel_err": kernel_err, "plain_bf16_err": plain_err, "limit": limit,
                     "ratio": kernel_err / max(plain_err, 1e-30), "ok": ok})
                if not ok:
                    fail(f"flash_bwd_tc {name} d={D} {n}: {kernel_err} from the fp32 "
                         f"reference, beyond {TC_REF_FACTOR}x the plain bf16 path's {plain_err}")
            if "-inf" in name and not bool((dq[:, :, dead] == 0).all()):
                fail(f"flash_bwd_tc d={D}: fully-masked rows have a non-zero dq")
            if D == 64 and name == "encoder padding S=1024":
                fault = (q, k, v, do, bias, scale, ref, limits)
            del dq, dk, dv, o, lse, want, ref
    # planted faults: rows 0-63 read as r ^ 7 (an 8-row swizzle phase off)
    q, k, v, do, bias, scale, ref, limits = fault
    perm = torch.arange(64, device=dev) ^ 7

    def permuted(x):
        y = x.clone()
        y[:, :, :64] = x[:, :, perm]
        return y

    dq, _, _, _, _ = kernels(q, k, v, do, bias, None, False, scale, k_dq=permuted(k))
    _, dk, dv, _, _ = kernels(q, k, v, do, bias, None, False, scale,
                              q_do_dkv=(permuted(q), permuted(do)))
    torch.cuda.synchronize()
    for what, times in (
            ("K rows permuted in one 64-key tile, read by the dq kernel",
             max_err(dq, ref[0]) / limits["dq"]),
            ("Q and dO rows permuted in one query tile, read by the dk/dv kernel",
             max(max_err(dk, ref[1]) / limits["dk"], max_err(dv, ref[2]) / limits["dv"]))):
        say({"phase": "kernel_check", "case": f"flash_bwd_tc planted fault: {what}",
             "times_limit": times, "must_exceed": TC_FAULT_FACTOR})
        if not times >= TC_FAULT_FACTOR:
            fail(f"flash_bwd_tc planted fault ({what}) reads {times}x the limit, under "
                 f"{TC_FAULT_FACTOR}x")
    return worst


def bwd_work(bias, B, H, S, D, per_key):
    """(flops over the live keys, flops over all keys) of kernel 2
    (``per_key`` 6: S, dP, dQ) or 3 (8: S, dP, dV, dK) at (B, H, S, S, D)
    under a (B, 1, 1, S) padding mask: the kernels skip the tiles the mask
    zeroes, so only each row's live keys (bias above -1e8) need the
    products."""
    keys = float((bias.reshape(B, -1) > -1e8).sum())
    return per_key * H * S * keys * D, per_key * B * H * S * S * D


def hgmma_counts(cuda_build, lib: str, kernel: str, params: tuple) -> dict:
    """{kernel instance: HGMMA instructions} of every instance of the
    template ``kernel`` in the built library ``lib``, from ``cuobjdump
    -sass``; an instance is named by its int template arguments
    (``params``)."""
    import re
    import shutil

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    out = subprocess.run([tool, "-sass", str(cuda_build.library_path(lib))],
                         capture_output=True, text=True, timeout=300)
    if out.returncode != 0:
        fail(f"cuobjdump -sass failed: {out.stderr.strip()[:300]}")
    counts, name = {}, None
    for line in out.stdout.splitlines():
        if "Function :" in line:
            m = re.search(kernel + r"I((?:Li\d+E)+)E", line)
            name = None
            if m:
                args = re.findall(r"Li(\d+)E", m.group(1))
                name = " ".join(f"{p}={a}" for p, a in zip(params, args))
                counts[name] = 0
        elif name and "HGMMA" in line:
            counts[name] += 1
    return counts


# each tensor-core kernel template: (library, kernel, template parameters)
TC_KERNELS = [("flash_fwd_tc", "flash_fwd_tc_kernel", ("d", "rows", "lbias_bytes")),
              ("flash_bwd_tc", "flash_bwd_dq_tc_kernel", ("d", "lbias_bytes")),
              ("flash_bwd_tc", "flash_bwd_dkv_tc_kernel", ("d", "lbias_bytes"))]


def tensor_core_route(fa, run: str, launches: dict) -> None:
    """Every bf16 launch of kernels 1, 2 and 3 in a main-path run (all of
    its launches: every main path runs bf16) went to the tensor-core
    entry."""
    pairs = {"flash_attention_fwd": fa.flash_attention.tc_launches,
             "flash_attention_bwd_dq": fa.flash_bwd_dq.tc_launches,
             "flash_attention_bwd_dkv": fa.flash_bwd_dkv.tc_launches}
    say({"phase": "tensor_core_route", "run": run,
         "launches": {k: launches.get(k, 0) for k in pairs}, "tensor_core_launches": pairs})
    for k, tc in pairs.items():
        if tc != launches.get(k, 0):
            fail(f"{run}: {tc} of {launches.get(k, 0)} {k} launches went to the tensor-core "
                 "entry")


def close_enough(got, want, *, atol, rtol=0.0):
    """(ok, max abs err) with NaNs required in the same places."""
    import torch

    g, w = got.float(), want.float()
    nan_g, nan_w = torch.isnan(g), torch.isnan(w)
    if not bool((nan_g == nan_w).all()):
        return False, float("nan")
    live = ~nan_w
    err = (g[live] - w[live]).abs()
    if err.numel() == 0:
        return True, 0.0
    return bool((err <= atol + rtol * w[live].abs()).all()), float(err.max())


def backward_kernel_phase(torch, fa):
    """Kernels 2 and 3 against flash_attention_bwd_plain on the same inputs
    (o and lse from kernel 1), then their times at the encoder shape."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    B, H, D = 8, 16, 64
    bf = dict(atol=2e-2, rtol=2e-2)
    f32 = dict(atol=1e-4)

    def rnd(*shape, dtype):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)

    def pad_bias(K):
        lens = torch.randint(K // 5, K + 1, (B,), generator=gen, device=dev)
        b = torch.where(torch.arange(K, device=dev)[None, :] < lens[:, None], 0.0, -1e9)
        return b[:, None, None, :].float().contiguous()

    def run(name, Q, K, dtype, tol, *, causal=False, bias=None, dead=None):
        q, do = rnd(B, H, Q, D, dtype=dtype), rnd(B, H, Q, D, dtype=dtype)
        k, v = rnd(B, H, K, D, dtype=dtype), rnd(B, H, K, D, dtype=dtype)
        o, lse = fa.flash_attention(q, k, v, bias, causal=causal, return_lse=True)
        delta = fa.attention_delta(do, o)
        scale = D ** -0.5
        dq = fa.flash_bwd_dq(q, k, v, bias, do, lse, delta, causal=causal, scale=scale)
        dk, dv = fa.flash_bwd_dkv(q, k, v, bias, do, lse, delta, causal=causal, scale=scale)
        want = fa.flash_attention_bwd_plain(q, k, v, bias, o, lse, do, causal=causal, scale=scale)
        torch.cuda.synchronize()
        errs = [check_close(f"flash_bwd {name} {n} {dtype}", g, w, **tol)
                for n, g, w in zip(("dq", "dk", "dv"), (dq, dk, dv), want)]
        if dead is not None and not bool((dq[:, :, dead] == 0).all()):
            fail(f"flash_bwd {name}: fully-masked rows have a non-zero dq")
        return max(errs)

    errs = []
    for dtype, tol in ((torch.bfloat16, bf), (torch.float32, f32)):
        errs.append(run("encoder S=1024 padding", 1024, 1024, dtype, tol, bias=pad_bias(1024)))
        errs.append(run("decoder causal S=128", 128, 128, dtype, tol, causal=True))
        errs.append(run("cross 128x1024 padding", 128, 1024, dtype, tol, bias=pad_bias(1024)))
        errs.append(run("ragged S=1000 padding", 1000, 1000, dtype, tol, bias=pad_bias(1000)))
    errs.append(run("ragged causal S=200", 200, 200, torch.float32, f32, causal=True))
    S = 1024
    dead = torch.tensor([0, 7, 500, S - 1], device=dev)
    dead_bias = torch.zeros(B, 1, S, S, device=dev)
    dead_bias[:, :, dead, :] = -float("inf")
    errs.append(run("fully-masked -inf rows", S, S, torch.float32, f32, bias=dead_bias, dead=dead))
    # planted fault: the dk/dv kernel run non-causal on the decoder's causal
    # inputs must break the fp32 limit (the checks above read exactly 0 on
    # an H100, where cuBLAS's fp32 GEMM sums in the kernels' order)
    q, k, v, do = (rnd(B, H, 128, D, dtype=torch.float32) for _ in range(4))
    o, lse = fa.flash_attention(q, k, v, causal=True, return_lse=True)
    delta = fa.attention_delta(do, o)
    dk, dv = fa.flash_bwd_dkv(q, k, v, None, do, lse, delta, causal=False, scale=D ** -0.5)
    _, want_dk, want_dv = fa.flash_attention_bwd_plain(q, k, v, None, o, lse, do, causal=True)
    fault = max(float((dk - want_dk).abs().max()), float((dv - want_dv).abs().max()))
    say({"phase": "kernel_check", "case": "flash_bwd planted fault: dk/dv non-causal on the "
         "decoder", "max_abs_err": fault, "atol": f32["atol"], "must_exceed": True})
    if not fault > f32["atol"]:
        fail(f"flash_bwd: dk/dv run non-causal stays within the fp32 limit ({fault})")

    # times at the encoder shape, bf16, ragged padding bias
    bias = pad_bias(S)
    q, k, v, do = (rnd(B, H, S, D, dtype=torch.bfloat16) for _ in range(4))
    o, lse = fa.flash_attention(q, k, v, bias, return_lse=True)
    delta = fa.attention_delta(do, o)
    kw = dict(causal=False, scale=D ** -0.5)
    # SDPA's backward (the yardstick) computes dq, dk and dv in one call
    qs, ks, vs = (t.detach().clone().requires_grad_(True) for t in (q, k, v))
    out = torch.nn.functional.scaled_dot_product_attention(qs, ks, vs,
                                                           attn_mask=bias.to(torch.bfloat16))
    lib_ms = time_ms(lambda: torch.autograd.grad(out, (qs, ks, vs), do, retain_graph=True),
                     per_rep=5)
    nbytes_in = 4 * B * H * S * D * 2 + 2 * B * H * S * 4 + bias.numel() * 4
    results = {}
    for name, fn, plain, per_key, out_bytes, dev_name in (
        ("flash_attention_bwd_dq",
         lambda: fa.flash_bwd_dq(q, k, v, bias, do, lse, delta, **kw),
         lambda: fa._dq_plain(q, k, fa._bwd_plain(q, k, v, bias, do, lse, delta, **kw)[1]),
         6, B * H * S * D * 2, "flash_bwd_dq_tc_kernel"),
        ("flash_attention_bwd_dkv",
         lambda: fa.flash_bwd_dkv(q, k, v, bias, do, lse, delta, **kw),
         lambda: fa._dkv_plain(q, k, v, do, *fa._bwd_plain(q, k, v, bias, do, lse, delta, **kw)),
         8, 2 * B * H * S * D * 2, "flash_bwd_dkv_tc_kernel"),
    ):
        # the kernels skip what the padding mask zeroes: the bound counts
        # the live keys' products; over all keys it is reported beside
        live, every = bwd_work(bias, B, H, S, D, per_key)
        b_ms, b_by = bound(live, nbytes_in + out_bytes)
        results[name] = dict(max_abs_err=max(errs), ms=time_ms(fn, per_rep=5),
                             plain_ms=time_ms(plain, per_rep=2), bound_ms=b_ms, bound_by=b_by,
                             library_ms=lib_ms)
        say({"phase": "kernel_time", "kernel": name, "branch": "padding", **results[name],
             "bound_all_keys_ms": bound(every, nbytes_in + out_bytes)[0],
             "device_ms": device_ms_of(fn, 5, dev_name)})
    return results


def check_rel(name, got, want, *, limit):
    """Max abs error over the largest |want|: the limit of a batch sum
    (kernel 4's output), whose entries span orders of magnitude."""
    import torch

    scale = float(want.float().abs().max())
    err = float((got.float() - want.float()).abs().max())
    rel = err / max(scale, 1e-30)
    ok = bool(torch.isfinite(got.float()).all()) and rel <= limit
    say({"phase": "kernel_check", "case": name, "max_abs_err": err, "max_abs_want": scale,
         "rel_to_max": rel, "limit": limit, "ok": ok})
    if not ok:
        fail(f"{name}: kernel disagrees with its plain version (relative to max {rel})")
    return err


def lbias_kernel_phase(torch, fa):
    """Kernels 1-3's learned-bias branch and kernel 4 against their plain
    versions at the t5-large shapes, bf16 and fp32: the encoder's (8, 16,
    1024, 64) with a ragged padding mask (rows of 1000 and 100 tokens among
    them), a 1000-token encoder no 64-row tile divides, the decoder's
    causal (8, 16, 128, 64), and -inf rows.  Scale 1, as T5 runs it (q
    carries T5's 1/sqrt(d) init).  dlbias is exactly 0 on fully-masked rows
    and above the causal diagonal; a planted fault (kernel 4 summing B - 1
    batch rows) must break the fp32 limit by orders of magnitude.  Then the
    four kernels' times at the encoder shape in bf16 beside the bound, the
    plain versions and SDPA forward + backward with the learned bias as an
    ``attn_mask`` that requires grad (never called by the port)."""
    import torch.nn.functional as F

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)
    B, H, D = 8, 16, 64
    bf = dict(atol=2e-2, rtol=2e-2)
    f32 = dict(atol=1e-4)
    rel_limit = {torch.bfloat16: 2e-2, torch.float32: 1e-4}

    def rnd(*shape, dtype, s=1.0):
        return (torch.randn(*shape, generator=gen, device=dev) * s).to(dtype)

    def pad_bias(K):
        lens = torch.randint(K // 5, K + 1, (B,), generator=gen, device=dev)
        lens[0], lens[1] = min(1000, K), 100
        b = torch.where(torch.arange(K, device=dev)[None, :] < lens[:, None], 0.0, -1e9)
        return b[:, None, None, :].float().contiguous()

    def inputs(S, dtype):
        q = rnd(B, H, S, D, dtype=dtype, s=D ** -0.5)
        k, v, do = (rnd(B, H, S, D, dtype=dtype) for _ in range(3))
        return q, k, v, do, rnd(1, H, S, S, dtype=dtype, s=0.5)

    def run(name, S, dtype, tol, *, causal=False, bias=None, dead=None):
        q, k, v, do, lb = inputs(S, dtype)
        o, lse = fa.flash_attention(q, k, v, bias, learned_bias=lb, causal=causal, scale=1.0,
                                    return_lse=True)
        po, plse = fa.flash_attention_plain(q, k, v, bias, lbias=lb, causal=causal, scale=1.0)
        delta = fa.attention_delta(do, o)
        kw = dict(lbias=lb, causal=causal, scale=1.0)
        dq = fa.flash_bwd_dq(q, k, v, bias, do, lse, delta, **kw)
        dk, dv = fa.flash_bwd_dkv(q, k, v, bias, do, lse, delta, **kw)
        dlb = fa.flash_bwd_dlbias(q, k, v, bias, lb, do, lse, delta, causal=causal, scale=1.0)
        want = fa.flash_attention_bwd_plain(q, k, v, bias, o, lse, do, **kw)
        want_dlb = fa._dlbias_plain(q, k, v, bias, lb, do, lse, delta, causal=causal, scale=1.0)
        torch.cuda.synchronize()
        errs = {"fwd": [check_close(f"flash_fwd lbias {name} {dtype}", o, po, **tol),
                        check_close(f"flash_fwd lbias {name} lse {dtype}", lse, plse, **tol)]}
        for n, g, w in zip(("dq", "dkv", "dkv"), (dq, dk, dv), want):
            errs.setdefault(n, []).append(check_close(f"flash_bwd lbias {name} {n} {dtype}", g, w,
                                                      **tol))
        errs["dlbias"] = [check_rel(f"flash_bwd_dlbias {name} {dtype}", dlb, want_dlb,
                                    limit=rel_limit[dtype])]
        if dlb.dtype != lb.dtype or dlb.shape != lb.shape:
            fail(f"flash_bwd_dlbias {name}: {dlb.dtype} {tuple(dlb.shape)} for a learned bias of "
                 f"{lb.dtype} {tuple(lb.shape)}")
        if causal and bool(torch.triu(dlb[0].float().abs(), diagonal=1).any()):
            fail(f"flash_bwd_dlbias {name}: non-zero gradient above the causal diagonal")
        if dead is not None and bool(dlb[:, :, dead].any()):
            fail(f"flash_bwd_dlbias {name}: non-zero gradient on fully-masked rows")
        again = fa.flash_bwd_dlbias(q, k, v, bias, lb, do, lse, delta, causal=causal, scale=1.0)
        if not torch.equal(again, dlb):
            fail(f"flash_bwd_dlbias {name}: two launches on the same inputs differ")
        return errs

    errs: dict[str, list] = {}
    for dtype, tol in ((torch.bfloat16, bf), (torch.float32, f32)):
        for e in (run("encoder S=1024 padding", 1024, dtype, tol, bias=pad_bias(1024)),
                  run("decoder causal S=128", 128, dtype, tol, causal=True),
                  run("encoder S=1000 padding", 1000, dtype, tol, bias=pad_bias(1000))):
            for n, v in e.items():
                errs.setdefault(n, []).extend(v)
    S = 1024
    dead = torch.tensor([0, 7, 500, S - 1], device=dev)
    dead_bias = torch.zeros(B, 1, S, S, device=dev)
    dead_bias[:, :, dead, :] = -float("inf")
    for n, v in run("fully-masked -inf rows", S, torch.float32, f32, bias=dead_bias,
                    dead=dead).items():
        errs[n].extend(v)
    say({"phase": "kernel_check", "case": "flash_bwd_dlbias launched twice on each case's "
         "inputs", "bit_equal": True})

    # planted fault: kernel 4 summing the first B - 1 batch rows only
    q, k, v, do, lb = inputs(S, torch.float32)
    bias = pad_bias(S)
    o, lse = fa.flash_attention(q, k, v, bias, learned_bias=lb, scale=1.0, return_lse=True)
    delta = fa.attention_delta(do, o)
    kw = dict(causal=False, scale=1.0)
    want = fa._dlbias_plain(q, k, v, bias, lb, do, lse, delta, **kw)
    short = fa.flash_bwd_dlbias(q[:-1], k[:-1], v[:-1], bias[:-1], lb, do[:-1], lse[:-1],
                                delta[:-1], **kw)
    fault = float((short - want).abs().max()) / float(want.abs().max())
    say({"phase": "kernel_check", "case": "flash_bwd_dlbias planted fault: B - 1 batch rows",
         "rel_to_max": fault, "limit": rel_limit[torch.float32], "must_exceed": True})
    if not fault > 100 * rel_limit[torch.float32]:
        fail(f"flash_bwd_dlbias: dropping a batch row stays near the fp32 limit ({fault})")

    # times at the t5-large encoder shape, bf16, ragged padding mask
    q, k, v, do, lb = inputs(S, torch.bfloat16)
    bias = pad_bias(S)
    o, lse = fa.flash_attention(q, k, v, bias, learned_bias=lb, scale=1.0, return_lse=True)
    delta = fa.attention_delta(do, o)
    kw = dict(lbias=lb, causal=False, scale=1.0)
    # bytes each function must move: a (B, H, S, D) bf16 tensor, an fp32
    # (B, H, S) row vector (lse or delta), the two biases as the kernels read
    # them (the padding mask fp32, the learned bias bf16)
    act, rows = B * H * S * D * 2, B * H * S * 4
    masks = bias.numel() * 4 + lb.numel() * lb.element_size()
    bwd_in = 4 * act + 2 * rows + masks  # q, k, v, dO, lse, delta and the biases
    # kernel 1 skips what the padding mask zeroes: its bound counts live keys
    fwd_flops, fwd_bytes = fwd_work(bias, B, H, S, D, lb.numel() * lb.element_size())
    results, lbias_times = {}, {}
    # kernels 2 and 3 skip the tiles the padding mask zeroes: their bound
    # counts the live keys' products, beside it the bound over all keys
    dq_flops, dq_all = bwd_work(bias, B, H, S, D, 6)
    dkv_flops, dkv_all = bwd_work(bias, B, H, S, D, 8)
    for name, fn, plain, flops, every, nbytes, dev_name in (
        ("flash_attention_fwd",
         lambda: fa.flash_attention(q, k, v, bias, learned_bias=lb, scale=1.0),
         lambda: fa.flash_attention_plain(q, k, v, bias, lbias=lb, scale=1.0),
         fwd_flops, None, fwd_bytes, "flash_fwd_tc_kernel"),
        ("flash_attention_bwd_dq",
         lambda: fa.flash_bwd_dq(q, k, v, bias, do, lse, delta, **kw),
         lambda: fa._dq_plain(q, k, fa._bwd_plain(q, k, v, bias, do, lse, delta, **kw)[1]),
         dq_flops, dq_all, bwd_in + act, "flash_bwd_dq_tc_kernel"),
        ("flash_attention_bwd_dkv",
         lambda: fa.flash_bwd_dkv(q, k, v, bias, do, lse, delta, **kw),
         lambda: fa._dkv_plain(q, k, v, do, *fa._bwd_plain(q, k, v, bias, do, lse, delta, **kw)),
         dkv_flops, dkv_all, bwd_in + 2 * act, "flash_bwd_dkv_tc_kernel"),
        ("flash_attention_bwd_dlbias",
         lambda: fa.flash_bwd_dlbias(q, k, v, bias, lb, do, lse, delta, causal=False, scale=1.0),
         lambda: fa._dlbias_plain(q, k, v, bias, lb, do, lse, delta, causal=False, scale=1.0),
         4.0 * B * H * S * S * D, None, bwd_in + lb.numel() * lb.element_size(),
         "flash_bwd_dlbias_kernel"),
    ):
        b_ms, b_by = bound(flops, nbytes)
        r = dict(max_abs_err=max(errs[{"flash_attention_fwd": "fwd",
                                       "flash_attention_bwd_dq": "dq",
                                       "flash_attention_bwd_dkv": "dkv"}.get(name, "dlbias")]),
                 ms=time_ms(fn, per_rep=5), plain_ms=time_ms(plain, per_rep=2), bound_ms=b_ms,
                 bound_by=b_by)
        r["device_ms"] = device_ms_of(fn, 5, dev_name)
        if every is not None:
            r["bound_all_keys_ms"] = bound(every, nbytes)[0]
            # backward yardstick: SDPA's dq, dk and dv in one call, the
            # padding mask and the learned bias summed into a constant mask
            qs, ks, vs = (t.detach().clone().requires_grad_(True) for t in (q, k, v))
            out = F.scaled_dot_product_attention(qs, ks, vs, attn_mask=bias.to(lb.dtype) + lb,
                                                 scale=1.0)
            r["library_ms"] = time_ms(
                lambda: torch.autograd.grad(out, (qs, ks, vs), do, retain_graph=True), per_rep=5)
            del qs, ks, vs, out
        if name == "flash_attention_fwd":
            # forward-only yardstick: SDPA with the padding mask and the
            # learned bias summed into one attn_mask (never called by the port)
            mask = bias.to(lb.dtype) + lb
            r["library_ms"] = time_ms(
                lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask, scale=1.0),
                per_rep=5)
        lbias_times[name] = r
        say({"phase": "kernel_time", "kernel": name, "branch": "learned bias", **r})
    # the yardstick: SDPA forward + backward with the learned bias (plus the
    # padding mask) as an attn_mask that requires grad, beside kernels 1-4
    qs, ks, vs = (t.detach().clone().requires_grad_(True) for t in (q, k, v))
    lbs = lb.detach().clone().requires_grad_(True)

    def sdpa():
        out = F.scaled_dot_product_attention(qs, ks, vs, attn_mask=bias.to(lbs.dtype) + lbs,
                                             scale=1.0)
        return torch.autograd.grad(out, (qs, ks, vs, lbs), do)

    library_ms, library_note = None, ""
    try:
        grads = sdpa()
        torch.cuda.synchronize()
        library_note = f"SDPA fwd+bwd, dlbias max |{float(grads[3].float().abs().max())}|"
        library_ms = time_ms(sdpa, per_rep=3)
    except RuntimeError as e:  # the yardstick only: the port never calls SDPA
        library_note = f"no SDPA backend returned a bias gradient: {str(e)[:160]}"
    kernels_ms = sum(lbias_times[n]["ms"] for n in lbias_times)
    say({"phase": "kernel_time", "kernel": "flash attention fwd+bwd with learned bias",
         "kernels_1_2_3_4_ms": kernels_ms,
         "kernels_2_3_4_ms": kernels_ms - lbias_times["flash_attention_fwd"]["ms"],
         "library_ms": library_ms, "library": library_note})
    r = dict(lbias_times["flash_attention_bwd_dlbias"])
    r.pop("device_ms")
    results["flash_attention_bwd_dlbias"] = dict(r, library_ms=library_ms)
    return results, {n: max(v) for n, v in errs.items()}


def dropout_kernel_phase(torch, fd):
    """Kernel 7 against dropout_plain: exactly equal, and the kept fraction."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2)
    rate = 0.1
    errs = []
    for shape, with_res in (((8, 1024, 1024), True), ((8, 1024, 4096), False),
                            ((8, 128, 1000), True), ((8, 128, 4096), False)):
        for dtype in (torch.bfloat16, torch.float32):
            for seed in (12345, -987654321):
                x = torch.randn(*shape, generator=gen, device=dev).to(dtype)
                res = torch.randn(*shape, generator=gen, device=dev).to(dtype) if with_res else None
                got = fd.fused_dropout(x, seed, rate, residual=res)
                want = fd.dropout_plain(x, seed, rate, res)
                torch.cuda.synchronize()
                same = bool(torch.equal(got, want))
                kept = float(((got if res is None else got - res) != 0).float().mean())
                say({"phase": "kernel_check", "case": f"fused_dropout {shape} residual={with_res} "
                     f"{dtype} seed={seed}", "bitwise_equal": same, "kept_fraction": kept})
                if not same:
                    fail(f"fused_dropout {shape} {dtype}: kernel differs from its plain version "
                         f"(max abs err {float((got.float() - want.float()).abs().max())})")
                if res is None and abs(kept - (1 - rate)) > 1e-3:
                    fail(f"fused_dropout {shape}: kept fraction {kept} vs {1 - rate}")
                errs.append(0.0)
    # the backward is the same kernel on g: one Function round trip
    x = torch.randn(8, 128, 1024, generator=gen, device=dev, dtype=torch.bfloat16,
                    requires_grad=True)
    g = torch.randn(8, 128, 1024, generator=gen, device=dev, dtype=torch.bfloat16)
    (fd.fused_dropout(x, 7, rate) * g).sum().backward()
    if not torch.equal(x.grad, fd.dropout_plain(g, 7, rate)):
        fail("fused_dropout backward: the gradient is not the forward's mask on g")
    results = {}
    for shape, with_res, lib in (((8, 1024, 4096), False, True), ((8, 1024, 1024), True, False)):
        x = torch.randn(*shape, generator=gen, device=dev).to(torch.bfloat16)
        res = torch.randn(*shape, generator=gen, device=dev).to(torch.bfloat16) if with_res else None
        n = x.numel()
        b_ms, b_by = bound(0.0, n * 2 * (3 if with_res else 2))
        r = dict(max_abs_err=max(errs),
                 ms=time_ms(lambda: fd.fused_dropout(x, 5, rate, residual=res), per_rep=20),
                 plain_ms=time_ms(lambda: fd.dropout_plain(x, 5, rate, res), per_rep=3),
                 bound_ms=b_ms, bound_by=b_by,
                 library_ms=time_ms(lambda: torch.nn.functional.dropout(x, rate), per_rep=20)
                 if lib else None)
        say({"phase": "kernel_time", "kernel": "fused_dropout", "shape": list(shape),
             "residual": with_res, **r,
             "device_ms": device_ms_of(lambda: fd.fused_dropout(x, 5, rate, residual=res), 20,
                                       "fused_dropout_kernel")})
        results.setdefault("fused_dropout", r)
    return results


def adamw_kernel_phase(torch, fo):
    """Kernel 8 against adamw_leaf_plain at bart-large-cnn's leaf sizes."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)
    hyper = dict(b1=0.9, b2=0.999, eps=1e-8, max_norm=1.0)
    worst = 0.0
    for n in (1024, 50265, 50265 * 1024):
        for trigger in (0.0, 1.0):
            for wd in (0.0, 0.01):
                for nan in (False, True):
                    if n > 50265 and (wd, nan) not in ((0.01, False), (0.0, True)):
                        continue
                    p, mu, g = (torch.randn(n, generator=gen, device=dev) for _ in range(3))
                    nu = torch.rand(n, generator=gen, device=dev) * 1e-3
                    if nan:
                        g[n // 3] = float("nan")
                    scal = torch.tensor([3.5, trigger, 0.271, 0.00299, -1e-4, 0, 0, 0],
                                        device=dev)
                    want = fo.adamw_leaf_plain(p, mu, nu, g, scal, wd=wd, **hyper)
                    got_p, got_mu, got_nu = p.clone(), mu.clone(), nu.clone()
                    stats = fo.fused_adamw_leaf(got_p, got_mu, got_nu, g, scal, wd=wd, **hyper)
                    torch.cuda.synchronize()
                    case = f"fused_adamw n={n} trigger={trigger} wd={wd} nan={nan}"
                    for what, got, w in (("p", got_p, want[0]), ("mu", got_mu, want[1]),
                                         ("nu", got_nu, want[2])):
                        ok, err = close_enough(got, w, atol=0.0, rtol=ADAMW_RTOL)
                        say({"phase": "kernel_check", "case": f"{case} {what}",
                             "max_abs_err": err, "rtol": ADAMW_RTOL, "ok": ok})
                        if not ok:
                            fail(f"{case} {what}: kernel differs from its plain version ({err})")
                        worst = max(worst, err if err == err else 0.0)
                    ok, err = close_enough(stats.float(), want[3], atol=0.0, rtol=1e-5)
                    if not ok or stats[fo.STAT_NONFINITE] != float(nan):
                        fail(f"{case} stats: {stats.tolist()} vs {want[3].tolist()}")
    n = 50265 * 1024  # the shared embedding, the largest leaf
    p, mu, g = (torch.randn(n, generator=gen, device=dev) for _ in range(3))
    nu = torch.rand(n, generator=gen, device=dev) * 1e-3
    scal = torch.tensor([0.5, 1.0, 0.271, 0.00299, -1e-4, 0, 0, 0], device=dev)
    stats = torch.zeros(fo.STATS, dtype=torch.float64, device=dev)
    run = lambda: fo.fused_adamw_leaf(p, mu, nu, g, scal, wd=0.01, stats=stats, **hyper)  # noqa: E731
    ref = torch.nn.Parameter(p.clone())
    ref.grad = g.clone()
    lib = torch.optim.AdamW([ref], lr=1e-4, weight_decay=0.01, fused=True)
    b_ms, b_by = bound(0.0, 28.0 * n)
    r = dict(max_abs_err=worst, ms=time_ms(run, per_rep=5),
             plain_ms=time_ms(lambda: fo.adamw_leaf_plain(p, mu, nu, g, scal, wd=0.01, **hyper),
                              per_rep=2),
             bound_ms=b_ms, bound_by=b_by, library_ms=time_ms(lib.step, per_rep=5))
    say({"phase": "kernel_time", "kernel": "fused_adamw", "elements": n, **r,
         "device_ms": device_ms_of(run, 5, "fused_adamw_kernel")})
    return {"fused_adamw": r}


def paged_case(torch, fa, *, dtype, Q, heads_kv=32, gen):
    """Kernel 6's inputs at the llama-2-7b decode shape: q (8, 32, Q, 128);
    a pool of 72 blocks of 128 slots in scrambled order; 9 tiles a row,
    rows in a 1024-wide or a 512-wide bucket with 200-1024 prompt tokens,
    so the block tables hold sentinels in the prompt gap (under the
    padding bias) and, for the 512-wide rows, past the budget; staggered
    offsets inside each row's decode tile."""
    import numpy as np

    dev = torch.device("cuda")
    B, H, D, N, BS, NT = 8, 32, 128, 72, 128, 9
    rng = np.random.RandomState(40 + Q)
    buckets = [1024, 512, 1024, 512, 1024, 1024, 512, 1024]
    lens = [int(rng.randint(200, b + 1)) for b in buckets]
    lens[0] = 300  # tiles 3-7 of row 0 are the prompt gap
    perm = [int(x) for x in rng.permutation(N)]
    bt = np.full((B, NT), N, np.int32)
    bias = np.zeros((B, 1, 1, NT * BS), np.float32)
    for b in range(B):
        n_prompt = -(-lens[b] // BS)
        bt[b, :n_prompt] = [perm.pop() for _ in range(n_prompt)]
        bt[b, buckets[b] // BS] = perm.pop()
        bias[b, ..., lens[b]:buckets[b]] = -1e9
    offsets = np.array([buckets[b] + int(e) for b, e in
                        enumerate([0, 5, 17, 40, 64, 99, 111, 120 - Q + 1])], np.int32)
    q = torch.randn(B, H, Q, D, generator=gen, device=dev).to(dtype)
    k_pool = torch.randn(N, heads_kv, BS, D, generator=gen, device=dev).to(dtype)
    v_pool = torch.randn(N, heads_kv, BS, D, generator=gen, device=dev).to(dtype)
    to = lambda x: torch.as_tensor(x, device=dev)  # noqa: E731
    return q, k_pool, v_pool, to(bt), to(offsets), to(bias), perm


def paged_kernel_phase(torch, fa):
    """Kernel 6 against its plain version (bf16, fp32, int8, GQA, Q = 1 and
    8); kernel 5 over the gathered view of the same blocks against the same
    plain output (the flat LLaMA path's shape, d = 128) and bit for bit
    against kernel 6; a planted fault; kernel 6's times at the llama-2-7b
    decode shape.  Returns ({"flash_decode_paged": numbers}, kernel 5's
    largest error here)."""
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(4)
    bf = dict(atol=2e-2, rtol=2e-2)
    f32 = dict(atol=1e-4)
    errs, errs5, vs_flat = [], [], {}
    for dtype, Q, heads_kv, tol in ((torch.bfloat16, 1, 32, bf), (torch.bfloat16, 8, 32, bf),
                                    (torch.float32, 1, 32, f32), (torch.float32, 8, 32, f32),
                                    (torch.bfloat16, 1, 8, bf), (torch.float32, 8, 8, f32)):
        q, kp, vp, bt, off, bias, _ = paged_case(torch, fa, dtype=dtype, Q=Q, heads_kv=heads_kv,
                                                 gen=gen)
        o = fa.flash_decode_paged(q, kp, vp, bias, block_tables=bt, offsets=off)
        po = fa.flash_decode_paged_plain(q, kp, vp, bias, block_tables=bt, offsets=off)
        rep = 32 // heads_kv
        view = [fa.gather_blocks(x, bt).repeat_interleave(rep, dim=1) for x in (kp, vp)]
        o5 = fa.flash_decode(q, *view, bias, offsets=off)
        torch.cuda.synchronize()
        case = f"flash_decode_paged Q={Q} H_kv={heads_kv} {dtype}"
        errs.append(check_close(case, o, po, **tol))
        errs5.append(check_close(f"flash_decode on the gathered view Q={Q} H_kv={heads_kv} "
                                 f"{dtype}", o5, po, **tol))
        vs_flat[case] = float((o.float() - o5.float()).abs().max())
    q, kp, vp, bt, off, bias, _ = paged_case(torch, fa, dtype=torch.bfloat16, Q=1, gen=gen)
    kq, ks = fa.quantize_kv(kp)
    vq, vsc = fa.quantize_kv(vp)
    o = fa.flash_decode_paged(q, kq, vq, bias, block_tables=bt, offsets=off, k_scale_pool=ks,
                              v_scale_pool=vsc)
    po = fa.flash_decode_paged_plain(q, kq, vq, bias, block_tables=bt, offsets=off,
                                     k_scale_pool=ks, v_scale_pool=vsc)
    view = [fa.gather_blocks(x, bt) for x in (kq, vq, ks, vsc)]
    o5 = fa.flash_decode(q, view[0], view[1], bias, offsets=off, k_scale=view[2],
                         v_scale=view[3])
    torch.cuda.synchronize()
    errs.append(check_close("flash_decode_paged int8 pool Q=1 bf16", o, po, **bf))
    errs5.append(check_close("flash_decode on the gathered view int8 Q=1 bf16", o5, po, **bf))
    vs_flat["flash_decode_paged int8 pool Q=1 bf16"] = float((o.float() - o5.float()).abs().max())
    bit_equal = all(v == 0.0 for v in vs_flat.values())
    say({"phase": "kernel6_vs_kernel5_gathered", "max_abs_diff": vs_flat,
         "bit_equal": bit_equal})
    # the two kernels share their tile size and accumulation order, so any
    # difference over the same blocks is a fault of one of them
    if not bit_equal:
        fail(f"flash_decode_paged differs from flash_decode over the gathered view: {vs_flat}")

    # planted fault: the gap's sentinel entry of row 0 read as block N - 1
    # (what a kernel that clamped instead of skipping would fetch), over a
    # pool whose unallocated blocks hold 1e12: must break the fp32 limit by
    # orders of magnitude
    q, kp, vp, bt, off, bias, free = paged_case(torch, fa, dtype=torch.float32, Q=1, gen=gen)
    for blk in free:
        kp[blk] = 1e12
        vp[blk] = 1e12
    gap = int((bt[0] == 72).nonzero()[0])
    bad = bt.clone()
    bad[0, gap] = free[0]
    o = fa.flash_decode_paged(q, kp, vp, bias, block_tables=bad, offsets=off)
    po = fa.flash_decode_paged_plain(q, kp, vp, bias, block_tables=bt, offsets=off)
    good = fa.flash_decode_paged(q, kp, vp, bias, block_tables=bt, offsets=off)
    torch.cuda.synchronize()
    fault = float((o - po).abs().max())
    errs.append(check_close("flash_decode_paged fp32 over a poisoned pool", good, po, **f32))
    say({"phase": "kernel_check", "case": "flash_decode_paged planted fault: a gap sentinel read "
         "as a poisoned block", "max_abs_err": fault, "atol": f32["atol"], "must_exceed": True})
    if not fault > 1e3 * f32["atol"]:
        fail(f"flash_decode_paged: reading a sentinel tile stays near the fp32 limit ({fault})")

    # times at the llama-2-7b decode shape, bf16
    q, kp, vp, bt, off, bias, _ = paged_case(torch, fa, dtype=torch.bfloat16, Q=1, gen=gen)
    run = lambda: fa.flash_decode_paged(q, kp, vp, bias, block_tables=bt, offsets=off)  # noqa: E731
    view_k, view_v = fa.gather_blocks(kp, bt), fa.gather_blocks(vp, bt)
    k_pos = torch.arange(view_k.shape[2], device="cuda")[None, None, None, :]
    sdpa_mask = (bias > -1) & (k_pos <= off[:, None, None, None])
    lib_ms = time_ms(lambda: F.scaled_dot_product_attention(q, view_k, view_v,
                                                            attn_mask=sdpa_mask), per_rep=100)
    gather_ms = time_ms(lambda: (fa.gather_blocks(kp, bt), fa.gather_blocks(vp, bt)), per_rep=20)
    # bytes: the K/V of every slot the output depends on, read once — up to
    # each row's offset, in an allocated tile and not under the padding
    # bias (the tail of each row's last prompt tile is) — plus q, o, the
    # bias, the tables and the offsets
    k_pos = torch.arange(bt.shape[1] * 128, device="cuda")
    needed = ((k_pos[None, :] <= off[:, None]) & (bt < 72).repeat_interleave(128, dim=1)
              & (bias[:, 0, 0, :] > -1))
    live = int(needed.sum())
    H, D = 32, 128
    flops = 4.0 * H * live * D
    nbytes = 2 * H * live * D * 2 + 2 * q.numel() * 2 + bias.numel() * 4 + bt.numel() * 4 + 8 * 4
    b_ms, b_by = bound(flops, nbytes)
    r = dict(max_abs_err=max(errs), ms=time_ms(run, per_rep=200),
             plain_ms=time_ms(lambda: fa.flash_decode_paged_plain(
                 q, kp, vp, bias, block_tables=bt, offsets=off), per_rep=20),
             bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms)
    # kernel 5 on the already gathered view of the same blocks: the flat
    # path's call at this shape, beside kernel 6
    flat = lambda: fa.flash_decode(q, view_k, view_v, bias, offsets=off)  # noqa: E731
    say({"phase": "kernel_time", "kernel": "flash_decode_paged", **r, "live_slots": live,
         "gather_ms_beside_library": gather_ms, "kernel6_bit_equal_kernel5": bit_equal,
         "device_ms": device_ms_of(run, 50, "flash_decode_paged_kernel"),
         "flash_decode_on_gathered_view_ms": time_ms(flat, per_rep=200),
         "flash_decode_on_gathered_view_device_ms": device_ms_of(flat, 50,
                                                                 "flash_decode_kernel")})
    return {"flash_decode_paged": r}, max(errs5)


def write_train_records(path: str, n: int = 48) -> None:
    import numpy as np

    rng = np.random.RandomState(0)
    alphabet = np.array(list("abcdefghijklmnopqrstuvwxyz      .,"))
    recs = [{"dialogue": "".join(rng.choice(alphabet, rng.randint(200, 1025))),
             "summary": "".join(rng.choice(alphabet, rng.randint(20, 128)))} for _ in range(n)]
    with open(path, "w") as f:
        json.dump(recs, f)


TRAIN_ARGS = [
    "--model-ckpt", "bart-large-cnn", "--batch-size", "8", "--num-epochs", "1",
    "--max-source-length", "1024", "--max-target-length", "128", "--compute-dtype", "bfloat16",
    "--learning-rate", "1e-4", "--warmup-steps", "0", "--seed", "0", "--log-every-steps", "1",
]


def zero_counters(fa, fd, fo) -> None:
    for fn in (fa.flash_attention, fa.flash_bwd_dq, fa.flash_bwd_dkv, fa.flash_bwd_dlbias,
               fd.fused_dropout, fo.fused_adamw_leaf, fa.flash_decode, fa.flash_decode_paged):
        fn.launches = 0
    for fn in (fa.flash_attention, fa.flash_bwd_dq, fa.flash_bwd_dkv):
        fn.tc_launches = 0


def read_counters(fa, fd, fo) -> dict:
    return {"flash_attention_fwd": fa.flash_attention.launches,
            "flash_attention_bwd_dq": fa.flash_bwd_dq.launches,
            "flash_attention_bwd_dkv": fa.flash_bwd_dkv.launches,
            "flash_attention_bwd_dlbias": fa.flash_bwd_dlbias.launches,
            "fused_dropout": fd.fused_dropout.launches,
            "fused_adamw": fo.fused_adamw_leaf.launches}


def learned_bias_attention(model) -> int:
    """Attention modules that take a learned bias in training: every
    self-attention of a T5 stack (the relative-position bias); none in
    BART."""
    from distributed_llms_example_tpu_torch.models.t5 import T5Attention

    return sum(isinstance(m, T5Attention) and name.endswith("self_attn")
               for name, m in model.named_modules())


def expected_train_launches(model, steps: int, accum: int = 1) -> dict:
    """Per-run launch counts the model implies: one forward kernel and one
    dq and one dk/dv kernel per attention module per microbatch, one
    learned-bias gradient kernel per attention module with a learned bias
    per microbatch, one dropout kernel per dropout site in the forward and
    again in the backward, one AdamW kernel per parameter tensor per
    step."""
    from distributed_llms_example_tpu_torch.ops.fused_dropout import count_dropout_sites
    from distributed_llms_example_tpu_torch.ops.mha import MultiHeadAttention

    attn = sum(isinstance(m, MultiHeadAttention) for m in model.modules())
    return {"flash_attention_fwd": attn * accum * steps,
            "flash_attention_bwd_dq": attn * accum * steps,
            "flash_attention_bwd_dkv": attn * accum * steps,
            "flash_attention_bwd_dlbias": learned_bias_attention(model) * accum * steps,
            "fused_dropout": 2 * count_dropout_sites(model) * accum * steps,
            "fused_adamw": len(list(model.parameters())) * steps}


def train_phase(torch, fa, fd, fo, cli, model: str = "bart-large-cnn"):
    """The CLI's train entry at full width; counters, losses, gradients
    (and, for T5, both bucket tables') and one profiled step."""
    from distributed_llms_example_tpu_torch.ops.mha import MultiHeadAttention

    os.makedirs(WORK, exist_ok=True)
    path = os.path.join(WORK, "train.json")
    write_train_records(path)
    zero_counters(fa, fd, fo)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    trainer = cli.train([*TRAIN_ARGS, "--model-ckpt", model, "--train-file", path])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counters(fa, fd, fo)
    tensor_core_route(fa, f"{model} train", launches)
    steps = len(trainer.history)
    want = expected_train_launches(trainer.model, steps, trainer.cfg.grad_accum_steps)
    losses = [float(m["loss"]) for m in trainer.history]
    step_s = [b - a for a, b in zip(trainer.step_ends, trainer.step_ends[1:])]
    t5 = model.startswith("t5")
    say({"phase": "train_launches", "model": model, "steps": steps, "launches": launches,
         "expected": want, "per_step": {k: v / max(steps, 1) for k, v in launches.items()}})
    # every kernel of the path launched, the learned-bias gradient on T5 only
    required = [k for k in want if t5 or k != "flash_attention_bwd_dlbias"]
    if steps != 6 or launches != want or any(want[k] == 0 for k in required):
        fail(f"{model} train run: {steps} steps, launches {launches} vs {want}")
    named = dict(trainer.model.named_parameters())
    qkv = {n: float(named[n].grad.abs().max()) for n in named
           if n.endswith(("q_proj.weight", "k_proj.weight", "v_proj.weight"))}
    attn = sum(isinstance(m, MultiHeadAttention) for m in trainer.model.modules())
    tables = {n: float(named[n].grad.abs().max()) for n in named
              if n.endswith("relative_attention_bias.weight")}
    say({"phase": "train", "model": model, "wall_s": wall, "losses": losses,
         "grad_norms": [float(m["grad_norm"]) for m in trainer.history],
         "learning_rates": [m["learning_rate"] for m in trainer.history],
         "step_s_after_first": step_s, "step_s_median": statistics.median(step_s),
         "tokens_per_step": [float(m["target_tokens"]) for m in trainer.history],
         "peak_mem_bytes": torch.cuda.max_memory_allocated(),
         "qkv_weight_grads": len(qkv), "qkv_min_of_max_abs_grad": min(qkv.values()),
         "bucket_table_max_abs_grad": tables})
    if not all(torch.isfinite(torch.tensor(losses))):
        fail(f"{model} train losses not finite: {losses}")
    if len(qkv) != 3 * attn or min(qkv.values()) <= 0.0:
        fail(f"{model}: some q/k/v projection weight got no gradient on the kernel path")
    if t5 and (len(tables) != 2 or min(tables.values()) <= 0.0):
        fail(f"{model}: a relative-position bucket table got no gradient: {tables}")
    profile_train_step(torch, trainer)
    return launches, trainer


def profile_train_step(torch, trainer) -> None:
    """More steps of the same trainer on its first batch.  Unprofiled: the
    host's time to enqueue a step against the step's time to finish on the
    card (near equal when the host holds the card back).  Then one under
    torch.profiler: wall vs device busy, the kernels by group, and the
    heaviest kernels with their launches per step."""
    from distributed_llms_example_tpu_torch.train.step import train_step
    from distributed_llms_example_tpu_torch.train.trainer import put_batch

    batch = put_batch(next(iter(trainer.batches.epoch(0))), trainer.device)

    def step():
        train_step(trainer.model, trainer.named_params, trainer.opt_state, trainer.spec,
                   trainer.schedule, batch, generator=trainer.generator)

    step()
    enqueue, total = [], []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        enqueue.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        total.append((time.perf_counter() - t0) * 1e3)
    counts: dict[str, float] = {}
    wall, kernels = profile_device(step, 2, counts)
    busy = sum(kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:20]
    groups: dict[str, list[float]] = {}
    for k, v in kernels.items():
        low = k.lower()
        g = next((tag for tag in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv",
                                  "flash_bwd_dlbias", "fused_dropout", "fused_adamw")
                  if tag in low),
                 "gemm" if any(t in low for t in ("gemm", "nvjet", "xmma", "cutlass", "sm90_"))
                 else "elementwise" if "elementwise" in low
                 else "reduce" if "reduce" in low else "other")
        ms, n = groups.get(g, [0.0, 0.0])
        groups[g] = [ms + v, n + counts.get(k, 0.0)]
    say({"phase": "where_the_time_goes", "call": "train_step",
         "model": trainer.cfg.model_ckpt, "batch_shape": {
             k: list(v.shape) for k, v in batch.items()},
         "enqueue_ms": enqueue, "step_ms": total, "wall_ms_profiled": wall,
         "device_busy_ms": busy, "device_idle_share": max(0.0, 1 - busy / wall),
         "kernel_launches": sum(counts.values()),
         "by_group_ms_launches": groups,
         "top_kernels": [[k[:90], v, counts.get(k, 0.0)] for k, v in top]})


@contextlib.contextmanager
def backward_dropout_seed_off_by_one(fd):
    """Planted fault: the dropout backward redraws its mask from seed + 1,
    so gradients flow through the wrong elements."""
    saved = fd._FusedDropout.backward

    def bad(ctx, g):
        g = g.contiguous()
        dx = fd._run(g, None, ctx.seed + 1, ctx.rate)
        return dx, None if ctx.res_dtype is None else g.to(ctx.res_dtype), None, None

    fd._FusedDropout.backward = staticmethod(bad)
    try:
        yield
    finally:
        fd._FusedDropout.backward = saved


def loss_and_grads(torch, model, batch):
    """One forward+backward with dropout seeds from a fresh generator:
    (loss, normalized gradients) like the train step's."""
    from distributed_llms_example_tpu_torch.ops.fused_dropout import dropout_seeds
    from distributed_llms_example_tpu_torch.train.step import seq2seq_loss_sums

    for p in model.parameters():
        p.grad = None
    with dropout_seeds(torch.Generator().manual_seed(11)):
        lsum, tokens = seq2seq_loss_sums(model, batch)
        lsum.backward()
    grads = [(p.grad / tokens).detach().clone() for p in model.parameters()]
    for p in model.parameters():
        p.grad = None
    return float((lsum / tokens).detach()), grads


def grad_check_phase(torch, fa, fd, trainer):
    """fp32: kernel path vs plain path on one batch, with a planted fault
    that must break the limits; bf16: the kernel path's gradient distance
    from fp32 against the plain path's."""
    from distributed_llms_example_tpu_torch.models.registry import load_model
    from distributed_llms_example_tpu_torch.train.optim import global_norm
    from distributed_llms_example_tpu_torch.train.trainer import put_batch

    batch = put_batch(next(iter(trainer.batches.epoch(0))), trainer.device)
    state = trainer.model.state_dict()
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        lm = load_model("bart-large-cnn", dtype=dtype, device="cuda", train=True)
        lm.module.load_state_dict(state)
        model = lm.module
        out[dtype, "kernel"] = loss_and_grads(torch, model, batch)
        with plain_kernels(fa, fd):
            out[dtype, "plain"] = loss_and_grads(torch, model, batch)
        if dtype == torch.float32:
            with backward_dropout_seed_off_by_one(fd):
                out[dtype, "fault"] = loss_and_grads(torch, model, batch)
        del lm, model
        torch.cuda.empty_cache()

    def dist(a, b):
        (la, ga), (lb, gb) = a, b
        per = [float((x - y).abs().max()) for x, y in zip(ga, gb)]
        diff = float(global_norm([x - y for x, y in zip(ga, gb)]))
        return {"loss_diff": abs(la - lb), "grad_norm_diff": abs(float(global_norm(ga)) -
                                                                  float(global_norm(gb))),
                "max_tensor_grad_diff": max(per),
                "grad_rel_l2": diff / float(global_norm(gb))}

    f32 = torch.float32
    ref = out[f32, "plain"]
    k32, fault = dist(out[f32, "kernel"], ref), dist(out[f32, "fault"], ref)
    k16, p16 = dist(out[torch.bfloat16, "kernel"], ref), dist(out[torch.bfloat16, "plain"], ref)
    say({"phase": "grad_check", "fp32_kernel_vs_plain": k32, "fp32_planted_fault": fault,
         "limits": GRAD_LIMITS, "bf16_kernel_vs_fp32_plain": k16,
         "bf16_plain_vs_fp32_plain": p16, "loss_fp32": ref[0],
         "grad_norm_fp32": float(global_norm(ref[1]))})
    for key, lim in GRAD_LIMITS.items():
        if not k32[key] <= lim:
            fail(f"fp32 gradient check: kernel path vs plain path {key} {k32[key]} > {lim}")
    if not any(fault[key] > lim for key, lim in GRAD_LIMITS.items()):
        fail(f"fp32 gradient check: the planted fault stays within every limit: {fault}")
    if not k16["grad_rel_l2"] <= 1.5 * p16["grad_rel_l2"]:
        fail(f"bf16 gradient: kernel path {k16['grad_rel_l2']} from fp32 against the plain "
             f"path's {p16['grad_rel_l2']}")


@contextlib.contextmanager
def dlbias_delta_of_another_row(fa):
    """Planted fault: kernel 4 reads each batch row's δ from its
    neighbour (δ rolled by one along the batch)."""
    saved = fa.flash_bwd_dlbias

    def bad(q, k, v, bias, lbias, do, lse, delta, **kw):
        return saved(q, k, v, bias, lbias, do, lse, delta.roll(1, dims=0).contiguous(), **kw)

    bad.launches = 0  # the kernel's own count, bumped through the module name, lands here
    fa.flash_bwd_dlbias = bad
    try:
        yield
    finally:
        fa.flash_bwd_dlbias = saved


@contextlib.contextmanager
def plain_backward_kernels(fa):
    """The flash Function's backward with kernels 2, 3 and 4 replaced by
    their plain versions on the same CUDA tensors; the forward (kernel 1)
    untouched, so both paths see bit-identical activations."""
    saved = fa.flash_bwd_dq, fa.flash_bwd_dkv, fa.flash_bwd_dlbias

    def dq(q, k, v, bias, do, lse, delta, *, lbias=None, causal, scale):
        _, ds = fa._bwd_plain(q, k, v, bias, do, lse, delta, lbias=lbias, causal=causal,
                              scale=scale)
        return fa._dq_plain(q, k, ds)

    def dkv(q, k, v, bias, do, lse, delta, *, lbias=None, causal, scale):
        p, ds = fa._bwd_plain(q, k, v, bias, do, lse, delta, lbias=lbias, causal=causal,
                              scale=scale)
        return fa._dkv_plain(q, k, v, do, p, ds)

    def dlbias(q, k, v, bias, lbias, do, lse, delta, *, causal, scale):
        return fa._dlbias_plain(q, k, v, bias, lbias, do, lse, delta, causal=causal,
                                scale=scale)

    fa.flash_bwd_dq, fa.flash_bwd_dkv, fa.flash_bwd_dlbias = dq, dkv, dlbias
    try:
        yield
    finally:
        fa.flash_bwd_dq, fa.flash_bwd_dkv, fa.flash_bwd_dlbias = saved


@contextlib.contextmanager
def attention_nudged_by_one_ulp():
    """Every attention output times 1 ± 2^-23 (a fixed random sign per
    element): a change of the forward the size of one fp32 rounding, the
    size by which two correct fp32 attention implementations differ."""
    import torch

    from distributed_llms_example_tpu_torch.ops import mha

    saved = mha.flash_attention
    gens: dict = {}

    def nudged(*args, **kw):
        o = saved(*args, **kw)
        gen = gens.setdefault(o.device, torch.Generator(device=o.device).manual_seed(0))
        sign = torch.randint(0, 2, o.shape, generator=gen, device=o.device).to(o.dtype) * 2 - 1
        return o * (1 + sign * 2.0 ** -23)

    mha.flash_attention = nudged
    try:
        yield
    finally:
        mha.flash_attention = saved


@contextlib.contextmanager
def learned_bias_one_key_off():
    """Planted fault: kernel 1 (and after it kernels 2-4) reads the learned
    bias one key position off (rolled by one along the key axis)."""
    from distributed_llms_example_tpu_torch.ops import mha

    saved = mha.flash_attention

    def shifted(q, k, v, bias=None, *, learned_bias=None, **kw):
        if learned_bias is not None:
            learned_bias = learned_bias.roll(1, dims=-1)
        return saved(q, k, v, bias, learned_bias=learned_bias, **kw)

    mha.flash_attention = shifted
    try:
        yield
    finally:
        mha.flash_attention = saved


def lookup_backward_bit_equal(torch, stack, q_len: int) -> bool:
    """Whether the bucket lookup's backward (the embedding gather's, which
    sums a million positions into 32 table rows) gives the same bits twice
    on one upstream gradient."""
    w = stack.relative_attention_bias.weight
    g = torch.randn(1, w.shape[1], q_len, q_len, device=w.device,
                    generator=torch.Generator(device=w.device).manual_seed(4))
    got = [torch.autograd.grad(stack.position_bias(q_len, q_len), w, g)[0] for _ in range(2)]
    return torch.equal(*got)


def t5_grad_check_phase(torch, fa, fd, batch) -> None:
    """fp32 T5 at t5-large widths, 2 encoder + 2 decoder layers, on the
    recipe's batch (8 x 1024 source, 128 target), dropout on with the same
    seeds on every path, with each of T5's two MLPs.

    relu (t5-large's own): kernels 2, 3 and 4 against their plain versions
    inside the model, on one forward (kernel 1), within GRAD_LIMITS and each
    bucket table's gradient within relative L2 T5_TABLE_REL_L2; δ of
    another batch row fed to kernel 4 must break the table limit.  The
    whole kernel path against the wholly plain path (torch autograd through
    the plain forward) is reported, not held: fp32 rounding in the forward
    flips relu units whose input lies within it of 0.

    gated-gelu (flan's MLP at the same widths; no kink): the whole kernel
    path (kernels 1-4) against the wholly plain path, so kernel 1's
    learned-bias branch is held inside a gradient: the loss within
    GRAD_LIMITS, every gradient metric within GRAD_LIMITS or within
    T5_NUDGE_FACTOR times the same metric of the plain path nudged by one
    ulp (below); kernel 1 reading the learned bias one key off must break
    them.

    Reported beside them: each MLP's plain path against itself with every
    attention output nudged by one fp32 ulp (how far a rounding-sized
    change of the forward moves each model's gradient), the same for the
    gated-gelu model with its attention logits shrunk 8x (q_proj x 1/8, as
    if scaled by d^-1/2), which tensors differ when the relu kernel path
    runs twice, and whether the bucket lookup's backward gives the same
    bits twice."""
    import dataclasses

    from distributed_llms_example_tpu_torch.models.registry import T5_CONFIGS
    from distributed_llms_example_tpu_torch.models.t5 import T5ForConditionalGeneration
    from distributed_llms_example_tpu_torch.train.optim import global_norm

    def build(mlp: str):
        cfg = dataclasses.replace(T5_CONFIGS["t5-large"], num_layers=2, feed_forward_proj=mlp)
        model = T5ForConditionalGeneration(cfg, dtype=torch.float32, param_dtype=torch.float32,
                                           device="cuda").train()
        model.init_weights(torch.Generator(device="cuda").manual_seed(0))
        names = [n for n, _ in model.named_parameters()]
        return model, names, [i for i, n in enumerate(names)
                              if n.endswith("relative_attention_bias.weight")]

    def dist(a, b, names, tables):
        (la, ga), (lb, gb) = a, b
        rel = lambda i: float((ga[i] - gb[i]).norm() / gb[i].norm())  # noqa: E731
        return {"loss_diff": abs(la - lb),
                "grad_norm_diff": abs(float(global_norm(ga)) - float(global_norm(gb))),
                "max_tensor_grad_diff": max(float((x - y).abs().max()) for x, y in zip(ga, gb)),
                "grad_rel_l2": float(global_norm([x - y for x, y in zip(ga, gb)]))
                / float(global_norm(gb)),
                "bucket_table_rel_l2": {names[i]: rel(i) for i in tables}}

    def within(d, nudged=None):
        """Every metric within its limit or, given the nudged distance,
        within T5_NUDGE_FACTOR times that metric there (the loss excepted)."""
        def limit(key, base, table=None):
            if nudged is None or key == "loss_diff":
                return base
            at = nudged[key] if table is None else nudged[key][table]
            return max(base, T5_NUDGE_FACTOR * at)

        return (all(d[k] <= limit(k, lim) for k, lim in GRAD_LIMITS.items())
                and all(v <= limit("bucket_table_rel_l2", T5_TABLE_REL_L2, t)
                        for t, v in d["bucket_table_rel_l2"].items()))

    model, names, tables = build("relu")
    fa.flash_bwd_dlbias.launches = 0
    kernel = loss_and_grads(torch, model, batch)
    launched = fa.flash_bwd_dlbias.launches
    rerun = loss_and_grads(torch, model, batch)
    with plain_backward_kernels(fa):
        plain_bwd = loss_and_grads(torch, model, batch)
    with dlbias_delta_of_another_row(fa):
        fault = loss_and_grads(torch, model, batch)
    with plain_kernels(fa, fd):
        plain = loss_and_grads(torch, model, batch)
        with attention_nudged_by_one_ulp():
            nudged = loss_and_grads(torch, model, batch)
    lookup_equal = lookup_backward_bit_equal(torch, model.encoder, batch["input_ids"].shape[1])
    del model
    free_cuda()
    relu = {"kernels_2_3_4_vs_plain": dist(kernel, plain_bwd, names, tables),
            "planted_fault_dlbias_delta": dist(fault, plain_bwd, names, tables),
            "kernel_path_vs_plain_path": dist(kernel, plain, names, tables),
            "plain_path_nudged_one_ulp": dist(nudged, plain, names, tables),
            "rerun_loss_equal": kernel[0] == rerun[0],
            "rerun_tensors_not_bit_equal": [names[i] for i, (x, y) in
                                            enumerate(zip(kernel[1], rerun[1]))
                                            if not torch.equal(x, y)],
            "lookup_backward_bit_equal": lookup_equal,
            "loss_fp32": plain[0], "grad_norm_fp32": float(global_norm(plain[1])),
            "bucket_table_grad_norms": {names[i]: float(plain[1][i].norm()) for i in tables}}

    model, gnames, gtables = build("gated-gelu")
    gkernel = loss_and_grads(torch, model, batch)
    with learned_bias_one_key_off():
        gfault = loss_and_grads(torch, model, batch)
    with plain_kernels(fa, fd):
        gplain = loss_and_grads(torch, model, batch)
        with attention_nudged_by_one_ulp():
            gnudged = loss_and_grads(torch, model, batch)
        with torch.no_grad():
            for n, p in model.named_parameters():
                if n.endswith("q_proj.weight"):
                    p.mul_(0.125)
        gplain_q8 = loss_and_grads(torch, model, batch)
        with attention_nudged_by_one_ulp():
            gnudged_q8 = loss_and_grads(torch, model, batch)
    del model
    free_cuda()
    gelu = {"kernel_path_vs_plain_path": dist(gkernel, gplain, gnames, gtables),
            "planted_fault_learned_bias_one_key_off": dist(gfault, gplain, gnames, gtables),
            "plain_path_nudged_one_ulp": dist(gnudged, gplain, gnames, gtables),
            "logits_shrunk_8x_plain_path_nudged_one_ulp": dist(gnudged_q8, gplain_q8, gnames,
                                                               gtables),
            "loss_fp32": gplain[0], "grad_norm_fp32": float(global_norm(gplain[1]))}
    say({"phase": "t5_grad_check", "layers": "2+2", "kernel4_launches": launched,
         "fp32_relu": relu, "fp32_gated_gelu": gelu,
         "limits": dict(GRAD_LIMITS, bucket_table_rel_l2=T5_TABLE_REL_L2,
                        gated_gelu_nudge_factor=T5_NUDGE_FACTOR)})
    if launched != 4 or len(tables) != 2 or len(gtables) != 2:
        fail(f"t5 gradient check: {launched} kernel-4 launches for 4 self-attention layers")
    if not within(relu["kernels_2_3_4_vs_plain"]):
        fail(f"t5 fp32 gradient check (relu): kernels 2-4 vs plain "
             f"{relu['kernels_2_3_4_vs_plain']}")
    if not max(relu["planted_fault_dlbias_delta"]["bucket_table_rel_l2"].values()) \
            > T5_TABLE_REL_L2:
        fail(f"t5 gradient check: δ of another batch row keeps the bucket tables within "
             f"the limit: {relu['planted_fault_dlbias_delta']['bucket_table_rel_l2']}")
    if not within(gelu["kernel_path_vs_plain_path"], gelu["plain_path_nudged_one_ulp"]):
        fail(f"t5 fp32 gradient check (gated-gelu): kernel path vs plain path "
             f"{gelu['kernel_path_vs_plain_path']}")
    if within(gelu["planted_fault_learned_bias_one_key_off"], gelu["plain_path_nudged_one_ulp"]):
        fail("t5 gradient check: the learned bias one key off stays within every limit")
    # the train path's gradient, both bucket tables included, is the same
    # bits on a rerun (no atomics anywhere in its backward)
    if not (relu["rerun_loss_equal"] and relu["lookup_backward_bit_equal"]) \
            or relu["rerun_tensors_not_bit_equal"]:
        fail(f"t5 gradient check: a rerun is not bit-equal: loss equal "
             f"{relu['rerun_loss_equal']}, lookup backward equal "
             f"{relu['lookup_backward_bit_equal']}, tensors that differ "
             f"{relu['rerun_tensors_not_bit_equal']}")


T5_SERVE_ARGS = [
    "--model-ckpt", "flan-t5-xl", "--max-slots", "8", "--max-new-tokens", "128",
    "--max-source-length", "1024", "--compute-dtype", "bfloat16", "--seed", "0",
    "--log-every-steps", "64", "--lint", "off",
]


def t5_serve_phase(torch, fa, fd, fo, cli) -> dict:
    """flan-t5-xl at full width through the CLI's serve entry (the BART
    phase's 16 prompts): kernel 1 once per encoder layer per prefill chunk
    (its learned-bias branch), kernel 5 once per decoder layer per decode
    round (the per-row relative bias as its bias), kernels 2, 3, 4 and 6
    never; then one profiled prefill and decode round."""
    prompts = os.path.join(WORK, "prompts.json")
    out = os.path.join(WORK, "t5_serve.jsonl")
    zero_counters(fa, fd, fo)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    engine, outs = cli.serve([*T5_SERVE_ARGS, "--prompts-file", prompts, "--output-file", out])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"flash_attention_fwd": fa.flash_attention.launches,
                "flash_decode": fa.flash_decode.launches,
                "flash_attention_bwd_dq": fa.flash_bwd_dq.launches,
                "flash_attention_bwd_dkv": fa.flash_bwd_dkv.launches,
                "flash_attention_bwd_dlbias": fa.flash_bwd_dlbias.launches,
                "flash_decode_paged": fa.flash_decode_paged.launches}
    tensor_core_route(fa, "flan-t5-xl serve", launches)
    stats = engine.last_stats
    model = engine.model
    want = {"flash_attention_fwd": len(model.encoder.blocks) * stats.prefill_calls,
            "flash_decode": len(model.decoder_blocks) * stats.decode_steps,
            "flash_attention_bwd_dq": 0, "flash_attention_bwd_dkv": 0,
            "flash_attention_bwd_dlbias": 0, "flash_decode_paged": 0}
    with open(out) as f:
        records = sum(1 for _ in f)
    p50, p95 = stats.ttft_percentiles()
    say({"phase": "t5_serve", "model": "flan-t5-xl", "wall_s": wall, "records": records,
         "params": sum(p.numel() for p in model.parameters()), "launches": launches,
         "expected": want, "prefill_calls": stats.prefill_calls,
         "decode_steps": stats.decode_steps, "decode_tokens": stats.decode_tokens,
         "decode_tokens_per_sec": stats.tokens_per_sec(), "ttft_p50_ms": p50 * 1e3,
         "ttft_p95_ms": p95 * 1e3, "prefill_seconds": stats.prefill_seconds,
         "decode_seconds": stats.decode_seconds,
         "peak_mem_bytes": torch.cuda.max_memory_allocated()})
    if (records != 16 or len(outs) != 16 or stats.decode_steps == 0 or launches != want
            or want["flash_attention_fwd"] == 0):
        fail(f"flan-t5-xl serve: {records} records, launches {launches} vs {want}")
    where_the_time_goes(torch, engine)
    del engine, model
    free_cuda()
    return launches


@contextlib.contextmanager
def position_bias_shifted_by_one():
    """Planted fault: every per-row decode offset moved by one in the
    relative-position bias alone (the cache writes and masks unchanged)."""
    import torch

    from distributed_llms_example_tpu_torch.models import t5

    saved = t5.T5Stack.position_bias

    def shifted(self, q_len, kv_len, offset=0):
        per_row = isinstance(offset, torch.Tensor) and offset.dim() == 1
        return saved(self, q_len, kv_len, offset + 1 if per_row else offset)

    t5.T5Stack.position_bias = shifted
    try:
        yield
    finally:
        t5.T5Stack.position_bias = saved


def t5_logits_phase(torch, fa) -> None:
    """fp32, flan-t5-xl widths at 2 + 2 layers: the prefill (encoder through
    kernel 1's learned-bias branch) and the first + 4 more decode steps at
    staggered per-row offsets (kernel 5 with the per-row relative bias),
    kernel path vs plain path within T5_FP32_ATOL; the relative bias of
    every row shifted by one position must break it."""
    import dataclasses

    import numpy as np

    from distributed_llms_example_tpu_torch.data.tokenizer import ByteTokenizer
    from distributed_llms_example_tpu_torch.evaluation.generation import init_cache
    from distributed_llms_example_tpu_torch.models.registry import T5_CONFIGS
    from distributed_llms_example_tpu_torch.models.t5 import T5ForConditionalGeneration

    cfg = dataclasses.replace(T5_CONFIGS["flan-t5-xl"], num_layers=2)
    model = T5ForConditionalGeneration(cfg, dtype=torch.float32, param_dtype=torch.float32,
                                       device="cuda").eval()
    model.init_weights(torch.Generator(device="cuda").manual_seed(0))
    with open(os.path.join(WORK, "prompts.json")) as f:
        texts = json.load(f)[:8]
    tok = ByteTokenizer()
    ids = np.zeros((8, 1024), np.int64)
    mask = np.zeros((8, 1024), np.int32)
    for r, t in enumerate(texts):
        row = tok.encode_source(t, 1024)
        ids[r, : len(row)] = row
        mask[r, : len(row)] = 1
    ids, mask = torch.as_tensor(ids, device="cuda"), torch.as_tensor(mask, device="cuda")
    steps = torch.as_tensor(np.random.RandomState(3).randint(2, 258, (5, 8, 1)), device="cuda")
    base = torch.tensor([0, 5, 17, 40, 64, 99, 111, 120], dtype=torch.int32, device="cuda")

    def run():
        with torch.inference_mode():
            enc = model.encode(ids, mask)
            ckv = model.cross_kv(enc)
            cache = init_cache(model, 8, 128, device="cuda")
            return torch.stack([
                model.decode(steps[t], None, mask, cache=cache, cache_offset=base + t,
                             cross_kv=ckv)[:, -1].float() for t in range(5)])

    fa.flash_attention.launches = fa.flash_decode.launches = 0
    kernel = run()
    launched = (fa.flash_attention.launches, fa.flash_decode.launches)
    with plain_kernels(fa):
        plain = run()
    with position_bias_shifted_by_one():
        fault = run()
    del model
    free_cuda()
    err = float((kernel - plain).abs().max())
    fault_err = float((fault - plain).abs().max())
    finite = bool(torch.isfinite(kernel).all())
    say({"phase": "t5_logits_kernel_vs_plain", "layers": "2+2", "steps": 5,
         "shape": list(kernel.shape), "finite": finite, "fp32_max_abs_err": err,
         "fp32_atol": T5_FP32_ATOL, "fp32_planted_fault_err": fault_err,
         "kernel_launches": {"flash_attention_fwd": launched[0], "flash_decode": launched[1]},
         "max_abs_logit": float(plain.abs().max())})
    if not finite or list(kernel.shape) != [5, 8, cfg.vocab_size] or launched != (2, 2 * 5):
        fail(f"t5 fp32 logits: finite={finite}, shape {list(kernel.shape)}, launches {launched}")
    if err > T5_FP32_ATOL:
        fail(f"t5 fp32 logits: kernel path vs plain path max abs err {err}")
    if not fault_err > T5_FP32_ATOL:
        fail(f"t5 fp32 logits: the relative bias shifted by one moves them only {fault_err}")

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
def plain_kernels(fa, fd=None):
    """Route the model's kernel call sites to the kernels' plain versions
    on the same CUDA tensors (the wrappers themselves never fall back), so
    the kernel path and the plain path differ only in the kernels.
    Attention goes through torch autograd of the plain forward; dropout
    through its autograd Function with the plain version in both passes."""
    from distributed_llms_example_tpu_torch.ops import mha

    def fwd(q, k, v, bias=None, *, learned_bias=None, causal=False, scale=None, dtype=None):
        return fa.flash_attention_plain(q, k, v, bias, lbias=learned_bias, causal=causal,
                                        scale=scale)[0].to(dtype or q.dtype)

    def dec(q, k, v, bias=None, *, offsets, scale=None, dtype=None):
        return fa.flash_decode_plain(q, k, v, bias, offsets=offsets,
                                     scale=scale).to(dtype or q.dtype)

    saved = mha.flash_attention, mha.flash_decode
    mha.flash_attention, mha.flash_decode = fwd, dec
    if fd is not None:
        saved_run = fd._run
        fd._run = lambda x, res, seed, rate: fd.dropout_plain(x, seed, rate, res)
    try:
        yield
    finally:
        mha.flash_attention, mha.flash_decode = saved
        if fd is not None:
            fd._run = saved_run


@contextlib.contextmanager
def planted_fault(fa):
    """The model's decode call site with the kernel's per-row length mask
    shifted by one (row r attends slots <= offsets[b] + r + 1): a fault
    that touches only not-yet-written, zero-initialised cache slots, which
    the serve-path logits check must see."""
    from distributed_llms_example_tpu_torch.ops import mha

    def dec(q, k, v, bias=None, *, offsets, scale=None, dtype=None):
        return fa.flash_decode(q, k, v, bias, offsets=offsets + 1, scale=scale, dtype=dtype)

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
        say({"phase": "where_the_time_goes", "call": what,
             "model": type(engine.model).__name__, "wall_ms": wall,
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
    fa.flash_attention.launches = fa.flash_attention.tc_launches = 0
    fa.flash_bwd_dq.tc_launches = fa.flash_bwd_dkv.tc_launches = 0
    fa.flash_decode.launches = 0
    t0 = time.perf_counter()
    engine, outs_k = cli.serve([*args, "--output-file", out_k])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"flash_attention_fwd": fa.flash_attention.launches,
                "flash_decode": fa.flash_decode.launches}
    tensor_core_route(fa, "bart-large-cnn serve", launches)
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

    # (eval mode: a module starts in training mode, whose dropout would
    # draw different masks on each path)
    ref = BartForConditionalGeneration(model.config, dtype=torch.float32,
                                       param_dtype=torch.float32, device="cuda").eval()
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
    fa.flash_attention.launches = fa.flash_attention.tc_launches = 0
    fa.flash_bwd_dq.tc_launches = fa.flash_bwd_dkv.tc_launches = 0
    fa.flash_decode.launches = 0
    engine, outs = cli.serve(argv)
    launches = {"flash_attention_fwd": fa.flash_attention.launches,
                "flash_decode": fa.flash_decode.launches}
    tensor_core_route(fa, "bart-large-cnn serve, source 1000", launches)
    stats = engine.last_stats
    want = {"flash_attention_fwd": NUM_LAYERS * stats.prefill_calls,
            "flash_decode": NUM_LAYERS * stats.decode_steps}
    say({"phase": "serve_ragged", "max_source_length": 1000, "max_new_tokens": 64,
         "launches": launches, "expected": want, "records": len(outs),
         "decode_tokens_per_sec": stats.tokens_per_sec()})
    if len(outs) != 16 or any(launches[k] == 0 or launches[k] != want[k] for k in want):
        fail(f"ragged serve run: {len(outs)} records, launches {launches} vs {want}")


LLAMA_ARGS = [
    "--model-ckpt", "llama-2-7b", "--max-slots", "8", "--max-new-tokens", "128",
    "--max-source-length", "1024", "--compute-dtype", "bfloat16", "--seed", "0",
    "--log-every-steps", "64", "--lint", "off",
]


def write_llama_prompts(path: str, n: int = 16) -> None:
    import numpy as np

    rng = np.random.RandomState(1)
    alphabet = np.array(list("abcdefghijklmnopqrstuvwxyz      .,"))
    # byte tokenizer, causal prompts: n bytes = n tokens, no eos
    texts = ["".join(rng.choice(alphabet, rng.randint(200, 1025))) for _ in range(n)]
    with open(path, "w") as f:
        json.dump(texts, f)


def free_cuda() -> None:
    """Return what the caller dropped to the card (after its ``del``)."""
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()


def llama_serve_phase(torch, fa, cli):
    """llama-2-7b at full width through the CLI's serve entry, paged then
    flat: launch counts derived from the model, the pool drained, the
    greedy tokens of both runs equal (kernel 6 equals kernel 5 bit for bit
    over the same blocks, which the kernel phase checks), and one profiled
    paged decode round."""
    from distributed_llms_example_tpu_torch.ops.mha import MultiHeadAttention

    os.makedirs(WORK, exist_ok=True)
    prompts = os.path.join(WORK, "llama_prompts.json")
    write_llama_prompts(prompts)
    runs = {}
    for name, extra in (("paged", ["--paged-kv"]), ("flat", [])):
        out = os.path.join(WORK, f"llama_{name}.jsonl")
        fa.flash_attention.launches = fa.flash_decode.launches = 0
        fa.flash_decode_paged.launches = 0
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        engine, outs = cli.serve([*LLAMA_ARGS, "--prompts-file", prompts, "--output-file", out,
                                  *extra])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"flash_attention_fwd": fa.flash_attention.launches,
                    "flash_decode": fa.flash_decode.launches,
                    "flash_decode_paged": fa.flash_decode_paged.launches}
        stats = engine.last_stats
        layers = sum(isinstance(m, MultiHeadAttention) for m in engine.model.modules())
        steps = layers * stats.decode_steps
        want = {"flash_attention_fwd": 0, "flash_decode": 0 if name == "paged" else steps,
                "flash_decode_paged": steps if name == "paged" else 0}
        with open(out) as f:
            records = sum(1 for _ in f)
        p50, p95 = stats.ttft_percentiles()
        numbers = {"phase": f"llama_serve_{name}", "wall_s": wall, "records": records,
                   "attention_modules": layers, "decode_steps": stats.decode_steps,
                   "prefill_calls": stats.prefill_calls, "launches": launches, "expected": want,
                   "decode_tokens": stats.decode_tokens,
                   "decode_tokens_per_sec": stats.tokens_per_sec(),
                   "ttft_p50_ms": p50 * 1e3, "ttft_p95_ms": p95 * 1e3,
                   "prefill_seconds": stats.prefill_seconds,
                   "decode_seconds": stats.decode_seconds,
                   "peak_mem_bytes": torch.cuda.max_memory_allocated(),
                   "cache_bytes_resident": stats.cache_bytes_resident,
                   "bytes_per_live_token": stats.bytes_per_live_token}
        if name == "paged":
            numbers.update(pool_blocks=engine.pool.num_blocks, kv_block_size=engine.block_size,
                           blocks_in_use_at_end=engine.pool.blocks_in_use,
                           admit_deferrals=stats.admit_deferrals)
        say(numbers)
        if records != 16 or stats.decode_steps == 0 or launches != want:
            fail(f"llama-2-7b {name} serve: {records} records, launches {launches} vs {want}")
        if name == "paged":
            if engine.pool.blocks_in_use != 0:
                fail(f"llama-2-7b paged serve left {engine.pool.blocks_in_use} blocks in use")
            where_the_time_goes(torch, engine)
        runs[name] = (outs, launches)
        del engine
        free_cuda()
    (outs_p, launches_p), (outs_f, launches_f) = runs["paged"], runs["flat"]
    same = sum(x == y for ra, rb in zip(outs_p, outs_f) for x, y in zip(ra, rb))
    total = sum(max(len(ra), len(rb)) for ra, rb in zip(outs_p, outs_f))
    rate = same / max(total, 1)
    say({"phase": "llama_paged_vs_flat_tokens", "greedy_token_match_rate": rate,
         "positions": total})
    if rate < 1.0 or [len(r) for r in outs_p] != [len(r) for r in outs_f]:
        fail(f"paged and flat greedy tokens differ (match rate {rate})")
    return launches_p, launches_f


def decode_logits(torch, model, chunk, full_mask, lengths, first, *, paged: bool,
                  steps: int = 4):
    """A decode of ``steps`` greedy tokens from a prefilled chunk, with
    per-row write and RoPE positions: paged (a fresh pool of 72 blocks of
    128, the chunk's tiles admitted) or flat (a copy of the chunk's own
    (P + L)-wide cache).  Returns the fp32 logits of every step."""
    import numpy as np

    from distributed_llms_example_tpu_torch.ops.mha import KVCache, PagedKVCache
    from distributed_llms_example_tpu_torch.serving import cache_pool

    B, width = full_mask.shape
    bucket, L, bs = width - 128, 128, 128
    if paged:
        pool = cache_pool.CachePool(72, bs)
        tree = cache_pool.pool_cache_tree([(c.k[:1], c.v[:1]) for c in chunk], 72, bs)
        bt = np.stack([cache_pool.build_block_row(
            width // bs, pool.alloc(cache_pool.blocks_needed(int(n), L, bs)), prompt_len=int(n),
            bucket_width=bucket, budget=L, block_size=bs, sentinel=72) for n in lengths.tolist()])
        cache_pool.scatter_admit(tree, [(c.k, c.v) for c in chunk], bt.reshape(-1), bs)
    else:
        flat = [KVCache(c.k.clone(), c.v.clone()) for c in chunk]
    mask = full_mask.clone()
    last = first.argmax(-1)
    out = []
    for t in range(steps):
        pos = np.full(B, bucket + t, np.int32)
        mask[:, bucket + t] = 1
        if paged:
            plan = cache_pool.step_write_plan(bt, pos, num_blocks=72, block_size=bs,
                                              device="cuda")
            cache = [PagedKVCache(k, v, torch.as_tensor(bt, device="cuda"), plan)
                     for k, v in tree]
        else:
            cache = flat
        logits = model(last[:, None], mask, positions=(lengths.long() + t)[:, None], cache=cache,
                       cache_positions=torch.as_tensor(pos, device="cuda"))[:, -1].float()
        out.append(logits)
        last = logits.argmax(-1)
    return torch.stack(out)


@contextlib.contextmanager
def decode_route(fa, how: str):
    """The model's decode call sites (paged and flat) routed to their plain
    versions (``plain``), or to the kernels with each row's offset shifted
    back by one (``fault``: a row no longer sees its own new K/V)."""
    from distributed_llms_example_tpu_torch.ops import mha

    def plain_paged(q, kp, vp, bias=None, *, block_tables, offsets, scale=None, dtype=None):
        return fa.flash_decode_paged_plain(q, kp, vp, bias, block_tables=block_tables,
                                           offsets=offsets, scale=scale).to(dtype or q.dtype)

    def fault_paged(q, kp, vp, bias=None, *, block_tables, offsets, scale=None, dtype=None):
        return fa.flash_decode_paged(q, kp, vp, bias, block_tables=block_tables,
                                     offsets=offsets - 1, scale=scale, dtype=dtype)

    def plain_flat(q, k, v, bias=None, *, offsets, scale=None, dtype=None):
        return fa.flash_decode_plain(q, k, v, bias, offsets=offsets,
                                     scale=scale).to(dtype or q.dtype)

    def fault_flat(q, k, v, bias=None, *, offsets, scale=None, dtype=None):
        return fa.flash_decode(q, k, v, bias, offsets=offsets - 1, scale=scale, dtype=dtype)

    saved = mha.flash_decode_paged, mha.flash_decode
    if how == "plain":
        mha.flash_decode_paged, mha.flash_decode = plain_paged, plain_flat
    else:
        mha.flash_decode_paged, mha.flash_decode = fault_paged, fault_flat
    try:
        yield
    finally:
        mha.flash_decode_paged, mha.flash_decode = saved


def llama_logits_phase(torch, fa) -> None:
    """fp32, llama-2-7b widths at 2 layers: a prefill + 4 decode steps,
    paged (kernel 6) and flat (kernel 5), kernel path vs plain path on the
    same weights, within LLAMA_FP32_ATOL; a decode offset shifted by one
    must break it on each route."""
    import dataclasses

    import numpy as np

    from distributed_llms_example_tpu_torch.data.tokenizer import ByteTokenizer
    from distributed_llms_example_tpu_torch.evaluation.generation import causal_prefill
    from distributed_llms_example_tpu_torch.models.llama import LlamaForCausalLM
    from distributed_llms_example_tpu_torch.models.registry import LLAMA_CONFIGS

    cfg = dataclasses.replace(LLAMA_CONFIGS["llama-2-7b"], num_hidden_layers=2)
    model = LlamaForCausalLM(cfg, dtype=torch.float32, param_dtype=torch.float32,
                             device="cuda").eval()
    model.init_weights(torch.Generator(device="cuda").manual_seed(0))
    with open(os.path.join(WORK, "llama_prompts.json")) as f:
        texts = json.load(f)[:8]
    tok = ByteTokenizer()
    ids = np.zeros((8, 1024), np.int64)
    mask = np.zeros((8, 1024), np.int32)
    for r, t in enumerate(texts):
        row = tok.encode_prompt(t, 1024)
        ids[r, : len(row)] = row
        mask[r, : len(row)] = 1
    with torch.inference_mode():
        chunk, full_mask, lengths, first = causal_prefill(
            model, torch.as_tensor(ids, device="cuda"), torch.as_tensor(mask, device="cuda"), 128)
        for route, counter in (("paged", fa.flash_decode_paged), ("flat", fa.flash_decode)):
            args = (torch, model, chunk, full_mask, lengths, first)
            kw = dict(paged=route == "paged")
            counter.launches = 0
            kernel = decode_logits(*args, **kw)
            launched = counter.launches
            with decode_route(fa, "plain"):
                plain = decode_logits(*args, **kw)
            with decode_route(fa, "fault"):
                fault = decode_logits(*args, **kw)
            err = float((kernel - plain).abs().max())
            fault_err = float((fault - plain).abs().max())
            finite = bool(torch.isfinite(kernel).all())
            say({"phase": f"llama_logits_kernel_vs_plain_{route}", "layers": 2, "steps": 4,
                 "shape": list(kernel.shape), "finite": finite, "fp32_max_abs_err": err,
                 "fp32_atol": LLAMA_FP32_ATOL, "fp32_planted_fault_err": fault_err,
                 "kernel_launches": launched, "max_abs_logit": float(plain.abs().max())})
            if not finite or list(kernel.shape) != [4, 8, cfg.vocab_size] or launched != 2 * 4:
                fail(f"llama fp32 logits ({route}): finite={finite}, shape "
                     f"{list(kernel.shape)}, {launched} kernel launches")
            if err > LLAMA_FP32_ATOL:
                fail(f"llama fp32 logits ({route}): kernel path vs plain path max abs err {err}")
            if not fault_err > LLAMA_FP32_ATOL:
                fail(f"llama fp32 logits ({route}): a decode offset shifted by one moves them "
                     f"only {fault_err}")


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

    # phase 2: build every kernel, one nvcc each, in parallel
    from distributed_llms_example_tpu_torch.ops import cuda_build
    from distributed_llms_example_tpu_torch.ops import flash_attention as fa
    from distributed_llms_example_tpu_torch.ops import fused_dropout as fd
    from distributed_llms_example_tpu_torch.ops import fused_optim as fo

    t0 = time.perf_counter()
    secs = cuda_build.build(KERNELS, verbose=True)
    say({"phase": "build", "seconds": time.perf_counter() - t0, "per_kernel_s": secs})
    for lib, kernel, params in TC_KERNELS:
        hgmma = hgmma_counts(cuda_build, lib, kernel, params)
        say({"phase": "sass", "library": lib, "kernel": kernel, "hgmma_per_instance": hgmma,
             "hgmma_total": sum(hgmma.values())})
        if not hgmma or min(hgmma.values()) == 0:
            fail(f"{kernel}: an instance has no HGMMA instruction: {hgmma}")

    # phase 3: kernels against their plain versions
    measured = kernel_phase(torch, fa)
    tc_err = tc_kernel_phase(torch, fa)
    measured["flash_attention_fwd"]["max_abs_err"] = max(
        measured["flash_attention_fwd"]["max_abs_err"], tc_err)
    measured.update(backward_kernel_phase(torch, fa))
    for name, err in zip(("flash_attention_bwd_dq", "flash_attention_bwd_dkv"),
                         tc_backward_phase(torch, fa).values()):
        measured[name]["max_abs_err"] = max(measured[name]["max_abs_err"], err)
    measured.update(dropout_kernel_phase(torch, fd))
    measured.update(adamw_kernel_phase(torch, fo))
    paged, kernel5_err_d128 = paged_kernel_phase(torch, fa)
    measured.update(paged)
    measured["flash_decode"]["max_abs_err"] = max(measured["flash_decode"]["max_abs_err"],
                                                  kernel5_err_d128)
    dlbias, lbias_errs = lbias_kernel_phase(torch, fa)
    measured.update(dlbias)
    for name, key in (("flash_attention_fwd", "fwd"), ("flash_attention_bwd_dq", "dq"),
                      ("flash_attention_bwd_dkv", "dkv")):
        measured[name]["max_abs_err"] = max(measured[name]["max_abs_err"], lbias_errs[key])

    # phases 4-6: the main paths
    from distributed_llms_example_tpu_torch.launch import cli

    launches = serve_phase(torch, fa, cli)
    torch.cuda.empty_cache()
    train_launches, trainer = train_phase(torch, fa, fd, fo, cli)
    trainer.opt_state = None
    for p in trainer.model.parameters():
        p.grad = None
    torch.cuda.empty_cache()
    grad_check_phase(torch, fa, fd, trainer)
    del trainer
    free_cuda()

    # phases 7-10: T5 — t5-large training and its gradient check, flan-t5-xl
    # serving and its fp32 logits check
    from distributed_llms_example_tpu_torch.train.trainer import put_batch

    t5_train, trainer = train_phase(torch, fa, fd, fo, cli, "t5-large")
    batch = put_batch(next(iter(trainer.batches.epoch(0))), trainer.device)
    del trainer
    free_cuda()
    t5_grad_check_phase(torch, fa, fd, batch)
    del batch
    t5_serve = t5_serve_phase(torch, fa, fd, fo, cli)
    t5_logits_phase(torch, fa)

    # phases 11-12: llama-2-7b serving, paged and flat; fp32 logits
    llama_paged, llama_flat = llama_serve_phase(torch, fa, cli)
    llama_logits_phase(torch, fa)

    # phase 13: the TPU kernels with no port yet (none), the kernel list,
    # then the contract line.  A kernel that runs on several main paths
    # reports the sum of their counts: kernel 1 the BART and T5 serve and
    # train runs, kernels 2, 3, 7 and 8 the BART and T5 train runs, kernel 4
    # the T5 train run, kernel 5 the BART and flan-T5 serve runs and the flat
    # LLaMA serve, kernel 6 the paged LLaMA serve.
    say({"kernels_unported": []})
    src = "distributed_llms_example_tpu_torch/csrc/"
    ref = "distributed_llms_example_tpu/ops/"
    both = {k: train_launches[k] + t5_train[k] for k in t5_train}
    rows = [
        dict(name="flash_attention_fwd", route="cuda", source=src + "flash_fwd_tc.cu",
             sources=[src + "flash_fwd_tc.cu", src + "flash_fwd.cu"],
             replaces=ref + "flash_attention.py:119",
             launches=(launches["flash_attention_fwd"] + both["flash_attention_fwd"]
                       + t5_serve["flash_attention_fwd"]),
             **measured["flash_attention_fwd"]),
        dict(name="flash_decode", route="cuda", source=src + "flash_decode.cu",
             replaces=ref + "flash_attention.py:931",
             launches=(launches["flash_decode"] + llama_flat["flash_decode"]
                       + t5_serve["flash_decode"]),
             **measured["flash_decode"]),
        dict(name="flash_decode_paged", route="cuda", source=src + "flash_decode_paged.cu",
             replaces=ref + "flash_attention.py:1155",
             launches=llama_paged["flash_decode_paged"], **measured["flash_decode_paged"]),
        dict(name="flash_attention_bwd_dq", route="cuda", source=src + "flash_bwd_tc.cu",
             sources=[src + "flash_bwd_tc.cu", src + "flash_bwd.cu"],
             replaces=ref + "flash_attention.py:264",
             launches=both["flash_attention_bwd_dq"], **measured["flash_attention_bwd_dq"]),
        dict(name="flash_attention_bwd_dkv", route="cuda", source=src + "flash_bwd_tc.cu",
             sources=[src + "flash_bwd_tc.cu", src + "flash_bwd.cu"],
             replaces=ref + "flash_attention.py:328",
             launches=both["flash_attention_bwd_dkv"], **measured["flash_attention_bwd_dkv"]),
        dict(name="flash_attention_bwd_dlbias", route="cuda",
             source=src + "flash_bwd_dlbias.cu", replaces=ref + "flash_attention.py:399",
             launches=both["flash_attention_bwd_dlbias"],
             **measured["flash_attention_bwd_dlbias"]),
        dict(name="fused_dropout", route="cuda", source=src + "fused_dropout.cu",
             replaces=ref + "fused_dropout.py:195",
             launches=both["fused_dropout"], **measured["fused_dropout"]),
        dict(name="fused_adamw", route="cuda", source=src + "fused_adamw.cu",
             replaces=ref + "fused_optim.py:162",
             launches=both["fused_adamw"], **measured["fused_adamw"]),
    ]
    say({"kernels": rows})
    say({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
