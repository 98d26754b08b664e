#!/usr/bin/env python3
"""Chip smoke for the PyTorch port: builds the CUDA kernels, holds each
against its plain PyTorch version on the card, serves bart-large-cnn at
full width through the port's ``serve`` entry and fine-tunes it through the
train entry, which saves it as an HF checkpoint, then fine-tunes it again
from that checkpoint with attention_dropout set (kernels 1-3's probs
dropout), stops, resumes and rewinds it (checkpoints, SIGTERM, the
health watchdog on kernel 8's sums), fine-tunes t5-large and serves
flan-t5-xl at full width the same ways, serves llama-2-7b at full width through ``serve --paged-kv`` and
through the flat cache, through ``serve-router`` (a replica crash, stall and
drain) and ``serve-loadgen`` (an open-loop QPS sweep), runs the reference recipe's eval pass (beam search
and ROUGE on a validation file) on bart-large-cnn, trains over process
groups (FSDP; a host loss rebuilt onto a new mesh and replayed), serves
and fine-tunes Mixtral at mixtral-8x7b's widths, and checks that each run
went through its kernels.

    python3 chip_smoke.py    # from the repository root, on one NVIDIA GPU
    python3 chip_smoke.py --phase 13    # the build, then phase 13 alone
    python3 chip_smoke.py --phase 14    # the build, then phases 14 and 19, chained as in the run
    python3 chip_smoke.py --phase 15    # the build, then phase 15 alone
    python3 chip_smoke.py --phase 16    # the build, then phase 16 alone
    python3 chip_smoke.py --phase 17    # the build, then phase 17 alone
    python3 chip_smoke.py --phase 18    # the build, then phase 18 alone
    python3 chip_smoke.py --phase 19    # the build, then phase 19 alone
    python3 chip_smoke.py --phase 20    # the build, then phases 19 and 20, chained as in the run

Phases (each fatal, non-zero exit, no result line):
  1. device: a CUDA card; prints nvidia-smi's name and power limit
  2. build: one nvcc per kernel source, all ten at once (ptxas report),
     and beside them an eleventh, a copy of csrc/flash_bwd_tc.cu whose
     dk/dv hash takes (key, query) (a planted fault for phase 3);
     each tensor-core kernel holds its instances with and without probs
     dropout (48, 24, 24 and 16);
     the HGMMA instructions of every instance of the tensor-core forward,
     of both tensor-core backward kernels and of the tensor-core
     learned-bias gradient (cuobjdump -sass), none of which may have 0;
     every instance of the last must have no stack frame and no local
     memory, hence no spill (cuobjdump -res-usage, read from the built
     library, so a cached build is checked too); each tensor-core
     instance's registers, stack frame and local memory reported; every
     instance of kernels 7 and 8 (dropout, AdamW, the gradient pass) must
     have no stack frame and no local memory either, and so must every
     instance of kernels 5 and 6: the flat and the paged instances of the
     one template in csrc/flash_decode.cuh, 32 in each library
  3. kernels vs plain versions at the main paths' shapes and at lengths no
     tile divides, timed with CUDA events beside the plain version, the
     library yardstick (never called by the port) and the bound
     max(flops / 989 TFLOP/s, bytes / 3.35 TB/s), kernel 1's over the live
     keys of its padding mask, since it skips the tiles the mask zeroes:
     - flash forward / decode (bf16 atol=rtol 2e-2, fp32 atol 1e-4,
       fully-masked rows exactly zero); decode also with flan-t5-xl's
       per-row relative bias, and timed at the bart-large-cnn and
       flan-t5-xl serve shapes and at the llama-2-7b flat decode step (the
       paged case's gathered view, Q = 1 and 8), with the host's enqueue
       time and, at the last, the bound over every slot it reads beside the
       bound over the live ones;
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
     - the tensor-core learned-bias gradient (kernel 4, bf16) at head dims
       16, 32, 64 and 128 (padding S = 1024 and 1000, causal 128 and 200,
       -inf rows; a learned bias in bf16 and in fp32): within 2e-2 of the
       plain version's largest entry and, against an fp32 reference,
       within 1.5x the plain bf16 path's own error; exactly 0 on -inf rows
       and above the diagonal; two launches bit-equal; Q and dO rows
       permuted inside one query tile must break that limit by 10x;
     - fused dropout: exactly equal in bf16 and fp32 at the main paths'
       shapes, rows of 1001, 7 and 1, views at a storage offset that is
       not 16-byte aligned (vectors after a scalar head; all scalar where
       x and the residual disagree modulo 16) and an fp32 residual into a
       bf16 activation, each case's vector and scalar element counts
       printed; kept fraction within 1e-3 of 1 - rate; timed at (8, 1024,
       4096) beside F.dropout and at (8, 1024, 1024) with a residual;
     - fused AdamW (a table of one leaf): p', mu', nu' within ADAMW_RTOL,
       health sums within 1e-5 relative, NaN counted once; one launch over
       t5-large's 509 leaves plus an odd-length, an empty and a
       misaligned leaf, against per-leaf adamw_leaf_plain, the NaN counted
       once in its own row; the train step's tail (gradient pass, step
       scalars, AdamW) on the 509 leaves: the norm within one fp32 ulp of
       grad_prep_plain, the division bit-equal to div_'s, a rerun
       bit-equal in the norm and in every parameter and moment; the tail
       timed beside clip_grad_norm_(foreach=True) + AdamW(fused=True);
     - paged flash decode at the llama-2-7b decode shape (72-block pool in
       scrambled order, sentinel tiles in the prompt gap and past the
       budget, padding bias; Q = 1 and 8, bf16 / fp32 / int8 / GQA 32:8,
       and a pool of 32-slot blocks, so that one 64-slot tile spans two;
       the limits of flash decode); flash decode over the gathered view of
       the same blocks against the same plain output (the flat LLaMA
       path's d = 128 shape) and bit for bit against paged decode; and a
       planted fault (a gap sentinel read as a poisoned block) that must
       break the fp32 limit by orders of magnitude;
     - the probs-dropout branch of kernels 1-4 (bf16 tensor-core and fp32
       instances, the mask of csrc/dropout_hash.cuh) at the BART encoder
       (8, 16, 1024, 64) with a ragged padding mask (rate 0.1 and 0.5), the
       causal decoder 128, cross 128 x 1024, S = 1000, -inf rows, and the
       t5-large learned-bias encoder and causal decoder: within the limits
       above of the plain versions with the same seed (bf16 also against
       an fp32 reference, within 1.5x the plain path's own error); a second
       launch bit-equal; rate 0 bit-equal to the no-dropout instances; the
       backward's seed off by one and the dk/dv hash with (query, key)
       swapped must each break the bf16 limit by 10x; the dropout
       instances timed beside max(flops, bytes, hash operations / int32
       rate) and SDPA with dropout_p 0.1 (forward, backward, both);
     - the learned-bias branch of kernels 1-3 and the learned-bias gradient
       (kernel 4) at the t5-large shapes, scale 1: encoder (8, 16, 1024,
       64) with a ragged padding mask, a 1000-token encoder, the causal
       decoder (8, 16, 128, 64), -inf rows (the same limits; dlbias within
       2e-2 bf16 / 1e-4 fp32 of its largest entry, exactly 0 on dead rows
       and above the causal diagonal); kernel 4 summing B - 1 rows must
       break the fp32 limit by orders of magnitude; kernel 4 timed with its
       bound over the live keys and over all keys; SDPA forward + backward
       with the bias as a grad-requiring mask as the yardstick, and SDPA
       forward with the summed masks beside kernel 1
  4. serve: the CLI's serve entry in-process, bart-large-cnn, bf16, seed 0,
     16 prompts of 200-1024 byte-tokens, 8 slots, 128 new tokens, source
     1024; launch counters zeroed before and read after (on every bf16 main
     path each launch of kernels 1-4 must be a tensor-core one); first-step logits
     with the kernels vs with their plain versions (fp32 atol 1e-4, which a
     decode mask shifted by one must break), plus the difference from plain
     softmax attention and the greedy token match rate of a whole serve run
     on that path; then a shorter run at source 1000 and 64 new tokens,
     whose counters must show both kernels too
  5. train: the CLI's train entry in-process, bart-large-cnn at full width,
     bf16, batch 8, source 1024 / target 128, 48 synthetic records (6
     steps), --output-dir under build/chip_smoke/; every count of kernels
     1, 2, 3, 7 and 8 (AdamW and the gradient pass) equals what the model
     implies (attention modules, dropout sites, the leaf table's launches)
     times the steps, none of them a probs-dropout instance; finite
     losses; non-zero q/k/v projection gradients; <output-dir>/model/
     reloaded (load_model(dir, train=True)) bit-equal in every parameter;
     then
     three more steps timed for host enqueue vs finish on the card, and one
     under torch.profiler (device busy, kernels by group and by launches);
     every train run (5, 5b, 5c, 6c, 7, 7b) empties its --output-dir first
     (a run resumes from the checkpoints it finds there) and, after its
     checks, deletes the checkpoints/ that every run now ends with (phase
     5's model/ stays: 5b, 5c and 6c read it), printing each save's and
     restore's seconds and GB
  6. gradient check: one fp32 forward+backward with dropout on, kernel
     path vs plain path (same seeds, so the same masks): loss, global grad
     norm and the largest per-tensor grad difference within limits that a
     backward dropout seed off by one must break; in bf16 the kernel path's
     gradient must stay within 1.5x the plain path's distance from fp32
 5b. train from phase 5's saved checkpoint with attention_dropout 0.1 in
     its config.json (the weights linked, not copied), the same 6 steps:
     phase 5's checks, and every launch of kernels 1, 2 and 3 (36 each a
     step) a probs-dropout instance on the tensor cores
 6b. phase 6's fp32 check on that model (probs dropout 0.1): the fault
     that must break the limits is the probs-dropout seed off by one in
     kernels 2-4
 5c. fault tolerance, phase 5's recipe at bart-large-cnn's widths and
     1 + 1 layers (2 + 2 until phase 19 joined the run; seed-0 weights
     written as an HF directory; the depth
     cut holds the time limit): (a) from that directory with dropout,
     attention_dropout and activation_dropout 0 (weights linked), an
     uninterrupted run with --save-every-steps 3, a run with
     --chaos sigterm@4 (a real SIGTERM to this process through the
     trainer's handler, restored after) that stops preempted at step 4,
     and a third run in its --output-dir that logs resumed at step 4 with
     cursor (0, 4) and takes steps 5-6, kernels 1-3 and 8 launched for
     exactly those 2 steps: its losses, its final checkpoint's payload
     (parameters, mu, nu, count) and its model/ export bit-equal to the
     uninterrupted run's; (b) the default config (dropout 0.1, kernel 7)
     with --save-every-steps 2 --health on --on-anomaly rewind --chaos
     nan_grad@3 --log-every-steps 1: exactly one chaos_injection,
     obs_anomaly (nonfinite), rewind to step 2, quarantine and
     quarantine_skip, 5 steps with a finite final loss, kernel 8's
     non-finite count > 0 at the anomaly step's first run only, the leaf
     table built once, the final state bit-equal to a clean run that
     quarantines the same batch from the start; (c) one more step of that
     trainer: param_norm and the four update ratios from kernel 8's
     float64 sums within 1e-6 relative of kernel 8's plain version's on
     the same state, and the leaf of the largest norm moved to another
     bucket must break it; (d) each save's and restore's seconds and GB,
     the crc32 manifest's and verify's GB/s, the peak bytes under
     build/chip_smoke/
  6c. eval: the CLI's train entry on bart-large-cnn from phase 5's saved
     checkpoint (the weights linked), bf16, --tokenizer byte, 16 records
     (2 steps of 8) and a --val-file of 16 (sources of 200-1024
     byte-tokens, targets of 40-128), --num-beams 2, --eval-max-new-tokens
     128, --eval-batch-size 8, --evaluation-steps 0: exactly one eval
     event, at the epoch's end, its four ROUGE means finite in [0, 1];
     counters zeroed just before the eval and read just after: kernel 1
     12 encoder layers x 2 batches = 24 launches, all on the tensor cores
     and none a dropout instance, kernel 5 12 decoder layers x 128 steps x
     2 batches = 3 072, kernels 2-4 and 6-8 none; the eval's wall time and
     generated tokens/s; one beam decode step profiled (host enqueue vs
     device busy); kernel 5 at that step's shape (16 rows x 16 heads, a
     128-slot cache, d 64, bf16) against its plain version, timed beside
     SDPA and its bound
 6d. beam search, kernel path vs plain path, fp32, beam 2, 32 new tokens,
     8 ragged rows: BART at bart-large-cnn widths and T5 at t5-large widths
     (2 + 2 layers: the beam-grouped cross-attention, T5's at scale 1,
     kernel 5 with T5's per-row relative bias), LLaMA at llama-2-7b widths
     (2 layers, a causal search over right-padded prompts): tokens,
     parents and outputs equal, the chosen beams' per-step log-probs
     within 1e-4, the smallest gap among each row's top 2K + 1 candidates
     reported, kernel 1 once per encoder layer (LLaMA: per layer, the
     prompt prefill) and kernel 5 once per decoder layer per step; the
     decode offset shifted by one must break the 1e-4 limit
 7. t5-large train at t5-large's widths and 4 + 4 layers (seed-0
     weights, the model built here and handed to the train entry; the
     depth cut holds the time limit): as phase 5 (same recipe and
     records), with kernel 4 once per self-attention layer per step
     (12 / 12 / 12 / 8 a step for kernels 1 / 2 / 3 / 4) and non-zero
     gradients in both bucket tables; with --obs jsonl --obs-budget on, as
     phase 5, and its last step_budget account printed
 7b. t5-large train with attention-probs dropout 0.1: the same model with
     T5Config's attn_dropout_rate (which no HF T5 config sets); phase 7's checks, and every launch of
     kernels 1-4 a probs-dropout instance on the tensor cores
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
     backward is a fixed-order reduction); the relu model again with
     attention-probs dropout 0.1, kernels 2-4's dropout instances vs their
     plain versions within the relu limits, kernel 4's fp32 dropout
     instance launched once per self-attention layer (counted from zero)
  9. flan-t5-xl serve: phase 4's prompts and settings, 64 new tokens
     (128 until phase 19 joined the run); kernel 1 once per
     encoder layer per prefill chunk, kernel 5 once per decoder layer per
     decode round, kernels 2, 3, 4 and 6 never; one profiled round
 10. T5 fp32 logits at flan-t5-xl widths, 2 + 2 layers: prefill + 5 decode
     steps at staggered per-row offsets, kernel path vs plain path within
     1e-4; the per-row relative bias shifted by one must break it
 11. llama-2-7b serve: the CLI's serve entry, bf16, seed 0, 16 byte-token
     prompts of 200-1024 tokens (two waves: the second admitted into the
     slots the first freed), 8 slots, 64 new tokens (128 until phase 19
     joined the run),
     source 1024,
     once with --paged-kv and once flat (the T5 model freed first);
     counters zeroed before and read after each: paged decode = attention
     modules x decode rounds and flash decode 0 on the paged run, the
     reverse on the flat one, flash forward = attention modules x prompt
     prefills on both (a prefill written from cache slot 0 attends its own
     keys: the causal pass through kernel 1); the pool drained; the
     greedy tokens of the two runs all equal; one profiled prefill chunk
     and decode round of each
 12. fp32 logits at llama-2-7b widths, 2 layers: a prefill + 4 decode
     steps, paged and flat, kernel path vs plain path within 1e-4; a
     decode offset shifted by one must break it on each route
 13. llama train: llama-2-7b's published config.json at 2 of its 32
     layers (all 32 take ~108 GB of fp32 state; 4 before the serving
     tier's phase 17 took their time) and seed-0 weights,
     written as a local HF directory by the port's export; the CLI's train
     entry on it with --tokenizer byte --remat --fused-ce, bf16 compute and
     fp32 masters, batch 8, source 1024 / target 128, lr 1e-4, 48 synthetic
     instruction records (prompts of 200-900 bytes, targets of 64-128: 6
     steps) and a --val-file of 16 (beam 2, 128 new tokens, eval batch 8,
     --evaluation-steps 0); counters zeroed before, the eval's read in its
     own window: the steps launch kernel 1 4 times a step (2 layers, the
     forward and remat's recompute, all on the tensor cores), kernels 2 and
     3 twice, kernel 8 once and its gradient pass once, nothing else; the
     eval exactly one event, four ROUGE means finite in [0, 1], kernel 1
     twice a batch (the prompt prefill) and kernel 5 2 x 127 a batch, nothing
     else; finite losses; the export reloaded bit-equal; tokens/s, MFU, the
     peak memory; one profiled step; each save's seconds and GB; kernel 8
     over the 21-leaf table against its plain version (2 fp32 ulps; the norm
     within one) and timed beside clip_grad_norm_(foreach=True) +
     AdamW(fused=True). Then at 2 layers (the trained model's),
     one batch of the recipe: (a) fp32, residual and attention-probs dropout
     0.1, kernel path vs plain path within the BART limits, which kernels
     2-3 drawing the probs mask from seed + 1 must break; (b) bf16 with
     dropout and the fused CE: --remat off, full and dots bit-equal in the
     loss and every gradient, each one's peak memory; (c) fp32: the fused CE
     against the unfused (loss within 1e-5 relative, gradients within the
     BART limits), the peak memory of each in fp32 and bf16. Last, kernels
     1-3 at (8, 32, 1024, 128) bf16, causal with a ragged padding, against
     their plain versions (2e-2) and timed beside their bounds and SDPA's
     forward and backward with the same mask.  The CLI run also takes
     --obs-gauges on --profile-steps 4:5: exactly one capture of [4, 5]
     and one device_account; every kernel event of kernels 1-3 in attn and
     of kernel 8's two entries in optimizer, as many as 2 steps of the
     launch counters (16/8/8/2 + 2); the bucket sum equal to the event sum,
     the busy union within the span; each memory_window's peak equal to
     torch.cuda.max_memory_allocated read beside it; the memory account's
     params + optimizer_state equal to the state's bytes; the gauge FLOPs
     (flop_counter) and window MFU beside this script's own MFU;
     optimizer_apply_ms beside kernel 8's profiler time; no device sync
     (cudaStreamSynchronize or other) inside the optimizer tail's scope;
     obs.report --trace loads with host spans and device lanes
 14. data-parallel and FSDP training: a world-1 NCCL group, the
     FSDP-wrapped llama-2-7b-width step bit-equal to the unwrapped one,
     kernel 8's split norm, the CLI on two gloo ranks of cuda:0 (no
     end-of-run checkpoint since phase 19 joined the run; its HF
     directory is phase 19's too)
 15. elastic fine-tuning: bart-large-cnn's widths at 1 + 1 layers, seed-0
     weights written by the port's export, its residual dropout 0.1, bf16,
     48 records (6 steps), --obs jsonl --obs-budget on, a save every 2
     steps and --chaos host_loss@3. (a) over a world-1 NCCL group, log
     cadence 2: 6 steps, one chaos_injection, one topology_change
     (reshard), one reshard_restore of step 2 found at step 3 (1 step
     lost); the trainer keeps the group; the losses of steps 3-6 and the
     final state bit-equal to a clean run resumed from the same step-2
     checkpoint with that save's dropout stream; kernels 1, 2, 3, 7 and 8
     launched exactly as 7 steps (the replay included); then
     reinitialize_distributed tears the group down and re-creates it
     (generation + 1, NCCL, an all-reduce right). (b) two gloo ranks on
     cuda:0 (--dist-rank), --mesh data=2 rebuilt on fsdp=2 after the loss
     (the _next_mesh_override hook) over a re-created group: ends on
     fsdp=2, the replay and the export bit-equal to a clean fsdp=2 run
     resumed from the step-2 checkpoint, rank 0's heartbeats skew 0, its
     launches exact. (c) the port's obs.report on both output directories:
     one topology change, one reshard, MTTR > 0, no organic fault,
     --strict 0. (d) the telemetry's device syncs in (a) equal its log
     windows. Phases 5 and 13 run with --obs jsonl --obs-budget on (health
     off, as without; phase 5 at log cadence 2) and print their last
     step_budget account. (e) the same model with --chaos oom@3, log
     cadence 1: the run raises the injected out-of-memory error, leaves
     exactly one memory-postmortem-p000.json with the memory account and
     the memory windows of steps 1-2, obs.report renders it; an oversize
     torch.empty on the card raises an error is_resource_exhausted accepts
 16. the serving features at llama-2-7b's full width, one loaded model
     (bf16, seed 0, byte tokenizer), through the serve entry's loaded=:
     first kernels 5 and 6 at the verify shape (Q = 4) and int8, each row
     of a Q = 4 launch bit-equal to a Q = 1 launch at that row's offset
     (bf16, fp32, int8), within 2 bf16 ulps of the plain version's
     largest entry and timed beside it and SDPA on the same dequantized
     K/V; then 8 prompts, 8 slots, 64 new tokens, blocks
     of 64: plain paged, --kv-cache-dtype int8 paged and flat (their tokens
     equal),
     --spec-tokens 3 n-gram and with a 2-layer
     llama-2-7b-width draft directory, and a planted fault (one more draft
     accepted than matched); 16 multi-turn prompts (a 512-token system
     prefix, 64-256-token tails, 64 new tokens, blocks of 64; 128 new
     tokens in blocks of 128 until phase 20 joined the run) with --prefix-cache
     --prefix-cache-budget-gib 2 against the same prompts cold (15 hits,
     15 x 512 tokens saved).  Each run: launches of kernels
     1, 5 and 6 equal to the counts its ledger and layer counts give, the
     pool drained with exact refcounts; the plain paged, n-gram and draft
     runs: in a profiler trace of 2 steady rounds of a fresh session, one
     device sync, one device-to-host copy and no scalar read a round.
     Speculative and warm runs equal their plain runs up to each request's
     first divergence, where the run's token lies within 4x the phase's
     own route floor (a verify block against single-row steps, steps
     against a teacher-forced prefill) of the plain run's top logit (so its
     top-2 gap does too); the planted fault must break that.  (e) a
     ballast tensor leaves 256 MiB: a session's step runs out of memory,
     the postmortem bundle (its kv_cache bytes the engine's account) is
     written and the error re-raised
 17. the serving tier at llama-2-7b's full width on phase 16's model
     (bf16; a bare serve run of one 4-slot engine, closed loop, and phase
     16's route floor the oracles): (a) serve-router --replicas 2
     --paged-kv, 4 slots a replica,
     16 prompts (two waves a replica), 32 new tokens, blocks of 32, without
     chaos and with --chaos replica_crash@12 (the busier replica holds 4
     requests mid-decode): 16 completed, 4 re-prefilled, every request
     within the route floor of the unfailed run and of the bare run's,
     obs.report --strict 0 with the injected crash its only fault; (b) the
     same at 2 of 32 layers in fp32: tokens equal and the re-prefilled
     requests' decode logits within 1e-4 of the unfailed run's, and a retry
     that keeps the dead replica's partial tokens must break both; (c) fp32,
     --chaos replica_stall@12: live -> suspect -> dead from ticks alone,
     its requests re-prefilled, tokens equal; drain_replica(0) after the
     first tick: drained, no retry, nothing lost; (d) serve-loadgen
     --replicas 0, Poisson (seed 17), 16 requests a point at 0.5x, 1x and 2x
     the bare run's closed-loop requests/s (the same single engine): the
     0.5x point's queue stable and the 2x point's growing, every point's
     tokens within the route floor of the bare run's.
     Each run: kernel 1 a layer per prompt chunk and kernel 6 a layer per
     decode round of every session (a dead replica's too), every pool
     drained with exact refcounts
 18. Mixtral at mixtral-8x7b's published widths (hidden 4096, FFN 14336,
     32 q heads over 8 kv heads of 128, 8 experts top-2, rope theta 1e6),
     2 of 32 layers, seed-0 weights: (e) kernels 5 and 6 at its decode
     shape (Q = 1 and 4, bf16 and fp32) against their plain versions,
     kernel 6 bit-equal to kernel 5 on the gathered view, bf16 times beside
     SDPA; (c) the train CLI on a 2-layer Mixtral HF directory it writes
     (bf16 on disk), --remat --fused-ce --moe-capacity-factor 1.25, batch 8
     x 1024, 6 steps: finite losses, kernels 1/2/3/8 launched 4/2/2/1+1 a
     step, the export reloaded bit-equal with a mixtral config.json, the
     gauge FLOPs equal to the hand count at the capacity-padded shape, the
     memory account's state equal to the reckoning; tokens/s, MFU, the peak
     beside the 50.6 GB state, the device account's shares (the run's
     end-of-run 38 GB training-state checkpoint left out); kernel 8 over its
     3.16 B-element table against the plain version (2 ulps, the norm 1
     ulp); (b) fp32: kernels 1-3 inside the model against the plain path
     (GRAD_LIMITS), K/V groups swapped for kernels 2-3 planted; (a) fp32: a
     prefill + 4 decode steps, paged and flat, kernel path within 1e-4 of
     the plain path, paged and flat tokens equal, the cached logits within
     1e-4 of an uncached no-drop pass; planted: an offset shifted by one, a
     decode at the training capacity; (d) serve --paged-kv and flat through
     the CLI (bf16, 16 prompts, 8 slots, 32 new tokens): exact launches of
     kernels 1, 5 and 6, tokens equal, decode tokens/s, TTFT and the
     cache's bytes a token
 19. tensor and sequence parallelism, on two gloo ranks of cuda:0
     (--dist-rank, like phase 14 (b)): (a) ring attention alone
     (ops/ring_attention.py; each hop one all_to_all_single, which gloo
     takes for CUDA tensors) at the llama-2-7b train shape (8, 32, 1024,
     128), fp32, causal with a ragged padding mask, the output and the
     q/k/v gradients within 1e-5 of the largest entry of plain attention
     over the whole length in one process; the held block's key positions
     one block late (planted) must break it; each hop's time and the
     ring's and the plain path's; (b) the train CLI under --mesh tensor=2
     and (c) under --mesh sequence=2 at llama-2-7b's widths and 1 layer,
     fp32, no --fused-ce, no remat, the recipe's batch 8 x 1024, 2 steps
     with no warmup (both update the weights), against the same CLI on one
     rank within GRAD_LIMITS' loss and norm terms (the three parts in one
     pair of rank processes); rank 0's launches exact (b: kernels 1-3 once
     a layer a step at 16 of 32 heads, kernel 8's gradient pass twice a
     step and its finish once; c: no kernel 1-3, ring attention); the
     export bit-equal to the weights gathered whole, and each of its leaves
     within 1e-3 of the one-rank run's update (the L2 norm of the
     difference over that of the update); the end-of-run checkpoints left
     out (the CPU tests hold the tensor blocks' save and restore); each step's time,
     rank 0's peak memory, the collective account and rank 0's device
     account of step 1
 20. serving across ranks, on two gloo ranks of cuda:0 (--dist-rank; the
     pair of rank processes phase 19 starts, after its parts; the one-rank
     runs, in this process, before):
     (a) llama-2-7b's widths at 2 of 32 layers, fp32, seed 0, 8 prompts of
     64-500 byte tokens in one prefill chunk, 32 new tokens (a prefill and
     31 decode rounds), serve --mesh tensor=2 and then data=2 (in one pair
     of rank processes), flat and --paged-kv (blocks of 32), each against
     the same CLI on one rank: every rank's greedy tokens equal, every
     decode row's logits within 1e-4 (each row compared on the rank that
     computed it), rank 0's launches of kernels 1, 5 and 6 exact (a layer a
     prefill chunk, a layer a round: a data rank runs its rows every chunk
     and round), their q heads 16 under tensor=2 and 32 under data=2; the
     planted faults, attention's o_proj output left un-reduced under
     tensor=2 and each rank reading its neighbour's slot rows under data=2,
     must each break the check; (b) the same model in bf16, 16 prompts, 64
     new tokens, tensor=2 --paged-kv (blocks of 64): each request equal to
     the one-rank run up to its first divergence, where its token lies
     within 4x the model's route floor of the one-rank run's top logit;
     kernels 5 and 6 at a tensor=2 rank's decode shape (8, 16, 1, 128),
     bf16, against their plain versions, bit-equal on the gathered view,
     timed beside SDPA and their bounds;
     (c) phase 19 (a)'s ring case in bf16: out, dq, dk and dv each within
     1.5x plain bf16 attention's own distance from fp32 plain attention
     (relative to the largest entry), timed beside the fp32 ring; (d) one
     MoEMLP at mixtral-8x7b's widths (8 experts, top-2, capacity 1.25),
     fp32, an (8, 1024) batch whose first half leans towards expert 0
     (two groups of 4 096, one a rank) and a (6, 1024) one (a group across
     the ranks, a padded last group), split over the two ranks as data=2
     splits it: the output, the input's gradient and the router's (at
     (8, 1024) every expert's too) within 1e-5 of their largest entry, the
     aux within 1e-6 of itself and the dropped pairs equal to the whole
     batch's on one rank; each rank routing alone must differ in output or aux; (e)
     phase 19 (b)'s tensor=2 run evaluates one batch of 8 records (beam 2,
     16 new tokens) at the epoch's end: one eval, ROUGE in [0, 1], kernel 1
     once and kernel 5 15 times (1 layer), nothing else, counted in the
     eval's own window
 21. a {"kernels_unported": []} line (every TPU kernel has a port), the
     whole run's wall time, a {"kernels": [...]} line of all eight and of
     kernels 1-4's probs-dropout branch (kernels 1-4 name both sources,
     kernel 8 both entries of its source; kernels 1 and 5 count phase 6c's
     eval launches too, kernels 1-3, 7 and 8 phase 5c's resumed and rewind
     runs, kernels 1, 2, 3, 5 and 8 phase 13's train and eval, kernels 1-3,
     7 and 8 phase 14's step and phase 15's two host-loss runs, kernel 1
     phase 11's prompt prefills, kernels 1, 5 and 6 phase 16's runs,
     kernels 1 and 6 phase 17's, kernels 1, 2, 3, 5, 6 and 8 phase 18's
     train and serve runs, kernels 1-3 and 8 rank 0 of phase 19's runs
     (kernels 1 and 5 its tensor=2 eval), kernels 1, 5 and 6 rank 0 of
     phase 20's serve runs, and kernels 5 and 6 carry phase 16's verify_q4
     and int8 times),
     then the last line
     {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}

Imports nothing of JAX or of the JAX package.  Everything it writes goes
under build/chip_smoke/ in the checkout.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import shutil
import signal
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
KERNELS = ["flash_fwd_tc", "flash_bwd_tc", "flash_bwd_dlbias_tc", "flash_fwd", "flash_decode",
           "flash_bwd", "flash_bwd_dlbias", "fused_dropout", "fused_adamw", "flash_decode_paged"]
# kernels 1-4 in bf16 against an fp32 reference on the same bf16 values:
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


def host_us(fn, n: int = 200) -> float:
    """The host's median time to enqueue one call of ``fn`` onto an empty
    queue (microseconds; the device is synchronized between calls, outside
    the timed window, so a full launch queue cannot hold the host): what
    the event time of back-to-back calls reads when it exceeds the device
    time."""
    import torch

    for _ in range(10):
        fn()
    out = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        out.append((time.perf_counter() - t0) * 1e6)
    torch.cuda.synchronize()
    return statistics.median(out)


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

    # flan-t5-xl's decoder self-attention, with its per-row relative bias
    shapes = decode_shapes(torch, gen)
    qt, kt, vt, rel, off = shapes["flan-t5-xl"]
    o = fa.flash_decode(qt, kt, vt, rel, offsets=off)
    po = fa.flash_decode_plain(qt, kt, vt, rel, offsets=off)
    torch.cuda.synchronize()
    errs.append(check_close("flash_decode per-row relative bias Q=1 bf16 (flan-t5-xl shape)",
                            o, po, atol=2e-2, rtol=2e-2))

    # times at the BART shape (the numbers returned) and the flan-t5-xl one
    for name in ("bart-large-cnn", "flan-t5-xl"):
        r = decode_time(torch, fa, name, *shapes[name])
        if name == "bart-large-cnn":
            results["flash_decode"] = dict(max_abs_err=max(errs), **r)
    return results


def decode_shapes(torch, gen) -> dict:
    """Kernel 5's inputs (q, k, v, bias, offsets) at the seq2seq serve
    shapes, bf16, Q = 1, a 128-slot cache at staggered offsets:
    bart-large-cnn's decoder self-attention (8, 16, 1, 64), no bias, and
    flan-t5-xl's (8, 32, 1, 64) with its per-row (8, 32, 1, 128) relative
    bias."""
    dev = torch.device("cuda")
    B, D, L = 8, 64, 128
    off = torch.tensor([0, 5, 17, 40, 64, 99, 120, 127], dtype=torch.int32, device=dev)
    out = {}
    for name, H, biased in (("bart-large-cnn", 16, False), ("flan-t5-xl", 32, True)):
        q = torch.randn(B, H, 1, D, generator=gen, device=dev).to(torch.bfloat16)
        k, v = (torch.randn(B, H, L, D, generator=gen, device=dev).to(torch.bfloat16)
                for _ in range(2))
        bias = torch.randn(B, H, 1, L, generator=gen, device=dev) if biased else None
        out[name] = (q, k, v, bias, off)
    return out


def decode_work(q, k, bias, off, *, padding: bool):
    """(flops, bytes, (B, H, Q, L) mask of the slots each row attends) of
    kernel 5 over the slots each row's output depends on: K/V up to the
    last row's offset (under a padding bias only the slots it leaves live,
    where ``padding``), q, o, the bias over those slots, the offsets."""
    import torch

    B, H, Q, D = q.shape
    L = k.shape[2]
    k_pos = torch.arange(L, device=q.device)[None, None, None, :]
    row = torch.arange(Q, device=q.device)[None, None, :, None]
    seen = k_pos <= off[:, None, None, None] + row  # (B, 1, Q, L)
    if padding:
        seen = seen & (bias > -1)
    seen = seen.expand(B, H, Q, L)
    slots = float(seen[:, :, -1].sum())  # over the (b, h) pairs
    nbytes = 2 * slots * D * k.element_size() + 2 * q.numel() * q.element_size() + B * 4
    if bias is not None:
        used = seen  # the bias entries those slots read, once each
        for dim, n in enumerate(bias.shape):
            if n == 1:
                used = used.any(dim=dim, keepdim=True)
        nbytes += float(used.sum()) * 4
    return 4.0 * D * float(seen.sum()), nbytes, seen


def decode_time(torch, fa, shape, q, k, v, bias, off, *, padding=False, **extra) -> dict:
    """Kernel 5's timing line at one shape: events and device time, the
    host's enqueue time, the plain version, SDPA on the same cache with the
    same mask (the bias plus the per-row length mask), and the bound
    (``decode_work``; under a ``padding`` bias over the live slots, with
    the bound over every slot the kernel reads beside it).  Returns the
    contract's numbers."""
    import torch.nn.functional as F

    flops, nbytes, seen = decode_work(q, k, bias, off, padding=padding)
    b_ms, b_by = bound(flops, nbytes)
    if padding:
        extra["bound_all_slots_ms"] = bound(*decode_work(q, k, bias, off, padding=False)[:2])[0]
    mask = seen if bias is None else torch.where(seen, bias, -torch.inf)
    run = lambda: fa.flash_decode(q, k, v, bias, offsets=off)  # noqa: E731
    r = dict(ms=time_ms(run, per_rep=200),
             plain_ms=time_ms(lambda: fa.flash_decode_plain(q, k, v, bias, offsets=off),
                              per_rep=50),
             bound_ms=b_ms, bound_by=b_by,
             library_ms=time_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask),
                                per_rep=200))
    say({"phase": "kernel_time", "kernel": "flash_decode", "shape": shape, "Q": q.shape[2], **r,
         **extra, "device_ms": device_ms_of(run, 50, "flash_decode_kernel"),
         "host_us": host_us(run)})
    return r


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


def tc_dlbias_phase(torch, fa):
    """Kernel 4's tensor-core entry (bf16) at every head dim it is built
    for, in the cases the train paths give it: the encoder's (8, 16, 1024,
    d) and a 1000-token source with a ragged padding mask, the causal
    decoder at 128 and 200, and -inf rows; each with a learned bias in bf16
    and in fp32 (scale 1, q scaled by d^-1/2 as T5's init does).  o and lse
    come from kernel 1.  Each case holds dlbias against the plain version
    (within 2e-2 of its largest entry) and against an fp32 reference (the
    exact gradient on the same bf16 values), where it may be at most
    TC_REF_FACTOR times the plain bf16 path's own error; exactly 0 on -inf
    rows and above the causal diagonal; two launches bit-equal; every
    launch on the tensor-core entry.  A planted fault, Q's and dO's rows
    permuted inside one query tile (lse and delta in order), must break
    that limit by TC_FAULT_FACTOR.  Returns the largest error against the
    plain version."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(10)
    B, H = 8, 16

    def rnd(*shape, s=1.0):
        return (torch.randn(*shape, generator=gen, device=dev) * s).to(torch.bfloat16)

    def pad_bias(K):
        lens = torch.randint(K // 5, K + 1, (B,), generator=gen, device=dev)
        b = torch.where(torch.arange(K, device=dev)[None, :] < lens[:, None], 0.0, -1e9)
        return b[:, None, None, :].float().contiguous()

    def reference(q, k, v, do, bias, lb, causal):
        """The exact gradient at these bf16 values, in fp32."""
        qf, kf, vf, dof, lbf = q.float(), k.float(), v.float(), do.float(), lb.float()
        of, lsef = fa.flash_attention_plain(qf, kf, vf, bias, lbias=lbf, causal=causal, scale=1.0)
        return fa._dlbias_plain(qf, kf, vf, bias, lbf, dof, lsef, fa.attention_delta(dof, of),
                                causal=causal, scale=1.0)

    def max_err(a, b):
        return float((a.float() - b.float()).abs().max())

    worst, fault = 0.0, None
    S = 1024
    dead = torch.tensor([0, 7, 500, S - 1], device=dev)
    dead_bias = torch.zeros(B, 1, S, S, device=dev)
    dead_bias[:, :, dead, :] = -float("inf")
    for D in fa.KERNEL_HEAD_DIMS:
        cases = [("encoder padding S=1024", 1024, dict(bias=pad_bias(1024))),
                 ("ragged padding S=1000", 1000, dict(bias=pad_bias(1000))),
                 ("causal S=128", 128, dict(causal=True)),
                 ("ragged causal S=200", 200, dict(causal=True)),
                 ("-inf rows S=1024", 1024, dict(bias=dead_bias))]
        for name, L, kw in cases:
            bias, causal = kw.get("bias"), kw.get("causal", False)
            q = rnd(B, H, L, D, s=D ** -0.5)
            k, v, do = rnd(B, H, L, D), rnd(B, H, L, D), rnd(B, H, L, D)
            for lb_dtype in (torch.bfloat16, torch.float32):
                lb = rnd(1, H, L, L, s=0.5).to(lb_dtype)
                o, lse = fa.flash_attention(q, k, v, bias, learned_bias=lb, causal=causal,
                                            scale=1.0, return_lse=True)
                delta = fa.attention_delta(do, o)
                kw4 = dict(causal=causal, scale=1.0)
                tc_before = fa.flash_bwd_dlbias.tc_launches
                dlb = fa.flash_bwd_dlbias(q, k, v, bias, lb, do, lse, delta, **kw4)
                again = fa.flash_bwd_dlbias(q, k, v, bias, lb, do, lse, delta, **kw4)
                want = fa._dlbias_plain(q, k, v, bias, lb, do, lse, delta, **kw4)
                ref = reference(q, k, v, do, bias, lb, causal)
                torch.cuda.synchronize()
                case = f"flash_bwd_dlbias_tc {name} d={D} lbias {lb_dtype}"
                if fa.flash_bwd_dlbias.tc_launches - tc_before != 2:
                    fail(f"{case}: a bf16 launch missed the tensor-core entry")
                if dlb.dtype != lb_dtype or dlb.shape != lb.shape:
                    fail(f"{case}: {dlb.dtype} {tuple(dlb.shape)} for a learned bias of "
                         f"{lb_dtype} {tuple(lb.shape)}")
                worst = max(worst, check_rel(case, dlb, want, limit=2e-2))
                kernel_err, plain_err = max_err(dlb, ref), max_err(want, ref)
                limit = TC_REF_FACTOR * plain_err
                ok = kernel_err <= limit
                say({"phase": "kernel_check", "case": f"{case} vs fp32 reference",
                     "kernel_err": kernel_err, "plain_bf16_err": plain_err, "limit": limit,
                     "ratio": kernel_err / max(plain_err, 1e-30), "ok": ok})
                if not ok:
                    fail(f"{case}: {kernel_err} from the fp32 reference, beyond "
                         f"{TC_REF_FACTOR}x the plain bf16 path's {plain_err}")
                if not torch.equal(dlb, again):
                    fail(f"{case}: two launches on the same inputs differ")
                if causal and bool(torch.triu(dlb[0].float().abs(), diagonal=1).any()):
                    fail(f"{case}: non-zero gradient above the causal diagonal")
                if "-inf" in name and bool(dlb[:, :, dead].any()):
                    fail(f"{case}: non-zero gradient on fully-masked rows")
                if D == 64 and name.startswith("encoder") and lb_dtype == torch.bfloat16:
                    fault = (q, k, v, do, bias, lb, lse, delta, ref, limit)
                del o, lse, delta, dlb, again, want, ref
    say({"phase": "kernel_check", "case": "flash_bwd_dlbias_tc launched twice on each case's "
         "inputs", "bit_equal": True})
    # planted fault: Q's and dO's rows 0-63 read as r ^ 7 (an 8-row swizzle
    # phase off), lse and delta in order
    q, k, v, do, bias, lb, lse, delta, ref, limit = fault
    perm = torch.arange(64, device=dev) ^ 7

    def permuted(x):
        y = x.clone()
        y[:, :, :64] = x[:, :, perm]
        return y

    bad = fa.flash_bwd_dlbias(permuted(q), k, v, bias, lb, permuted(do), lse, delta,
                              causal=False, scale=1.0)
    torch.cuda.synchronize()
    times = max_err(bad, ref) / limit
    say({"phase": "kernel_check", "case": "flash_bwd_dlbias_tc planted fault: Q and dO rows "
         "permuted in one query tile", "times_limit": times, "must_exceed": TC_FAULT_FACTOR})
    if not times >= TC_FAULT_FACTOR:
        fail(f"flash_bwd_dlbias_tc planted fault reads {times}x the limit, under "
             f"{TC_FAULT_FACTOR}x")
    return worst


def bwd_work(bias, B, H, S, D, per_key):
    """(flops over the live keys, flops over all keys) of kernel 2
    (``per_key`` 6: S, dP, dQ), 3 (8: S, dP, dV, dK) or 4 (4: S, dP) at (B, H, S, S, D)
    under a (B, 1, 1, S) padding mask: the kernels skip the tiles the mask
    zeroes, so only each row's live keys (bias above -1e8) need the
    products."""
    keys = float((bias.reshape(B, -1) > -1e8).sum())
    return per_key * H * S * keys * D, per_key * B * H * S * S * D


def cuobjdump_instances(cuda_build, lib: str, kernel: str, params: tuple, flag: str) -> dict:
    """{kernel instance: the lines cuobjdump ``flag`` prints for it} of
    every instance of ``kernel`` in the built library ``lib`` (read from
    the library itself, so a cached build is read as a fresh one); an
    instance of a template is named by its int template arguments
    (``params``), a kernel that is no template by its own name."""
    import re
    import shutil

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    out = subprocess.run([tool, flag, str(cuda_build.library_path(lib))],
                         capture_output=True, text=True, timeout=300)
    if out.returncode != 0:
        fail(f"cuobjdump {flag} failed: {out.stderr.strip()[:300]}")
    found, name = {}, None
    for line in out.stdout.splitlines():
        if line.lstrip().startswith("Function"):
            # the mangled name: the kernel's length-prefixed identifier, then
            # its template arguments or the end of its nested name
            m = re.search(rf"{len(kernel)}{kernel}(?:I((?:Li\d+E)+)E|(?=E))", line)
            name = None
            if m:
                args = re.findall(r"Li(\d+)E", m.group(1) or "")
                name = " ".join(f"{p}={a}" for p, a in zip(params, args)) or kernel
                found[name] = []
        elif name:
            found[name].append(line)
    return found


def hgmma_counts(cuda_build, lib: str, kernel: str, params: tuple) -> dict:
    """{kernel instance: HGMMA instructions in its SASS (cuobjdump -sass)}."""
    return {name: sum("HGMMA" in line for line in lines) for name, lines in
            cuobjdump_instances(cuda_build, lib, kernel, params, "-sass").items()}


def resource_usage(cuda_build, lib: str, kernel: str, params: tuple) -> dict:
    """{kernel instance: {"registers", "stack_bytes", "local_bytes"}} from
    cuobjdump -res-usage.  A register spill goes to the thread's stack
    frame, so a 0-byte stack frame means 0 bytes of spill."""
    import re

    out = {}
    for name, lines in cuobjdump_instances(cuda_build, lib, kernel, params,
                                           "-res-usage").items():
        use = next((dict(re.findall(r"(REG|STACK|LOCAL):(\d+)", line)) for line in lines
                    if "REG:" in line), {})
        if set(use) != {"REG", "STACK", "LOCAL"}:
            fail(f"cuobjdump -res-usage gives no REG/STACK/LOCAL for {kernel} {name}: {lines}")
        out[name] = {"registers": int(use["REG"]), "stack_bytes": int(use["STACK"]),
                     "local_bytes": int(use["LOCAL"])}
    return out


# each tensor-core kernel template: (library, kernel, template parameters)
# (the last, "drop", is 1 for the probs-dropout instances)
TC_KERNELS = [("flash_fwd_tc", "flash_fwd_tc_kernel", ("d", "rows", "lbias_bytes", "drop")),
              ("flash_bwd_tc", "flash_bwd_dq_tc_kernel", ("d", "lbias_bytes", "drop")),
              ("flash_bwd_tc", "flash_bwd_dkv_tc_kernel", ("d", "lbias_bytes", "drop")),
              ("flash_bwd_dlbias_tc", "flash_bwd_dlbias_tc_kernel", ("d", "lbias_bytes", "drop"))]
# each tensor-core kernel's instances: head dims x (rows) x learned-bias
# dtypes x with and without probs dropout
TC_INSTANCES = {"flash_fwd_tc_kernel": 4 * 2 * 3 * 2, "flash_bwd_dq_tc_kernel": 4 * 3 * 2,
                "flash_bwd_dkv_tc_kernel": 4 * 3 * 2, "flash_bwd_dlbias_tc_kernel": 4 * 2 * 2}
# kernels whose every instance, the dropout ones included, must have no
# stack frame and no local memory, hence no spill
NO_SPILL = ("flash_bwd_dlbias_tc_kernel",)
# kernels 7 and 8 (CUDA-core kernels): (library, kernel, template
# parameters); every instance must have no stack frame and no local memory
# (kernel 8's leaf table is a __grid_constant__ parameter block: a copy of
# it would land in local memory)
STREAM_KERNELS = [("fused_dropout", "fused_dropout_kernel", ("bf16", "residual")),
                  ("fused_adamw", "fused_adamw_kernel", ("clip",)),
                  ("fused_adamw", "fused_grad_prep_kernel", ()),
                  ("fused_adamw", "grad_norm_finish_kernel", ())]
# kernels 5 and 6: one template (csrc/flash_decode.cuh), its flat and its
# paged instances, each library with DECODE_INSTANCES of them; every one
# must have no stack frame and no local memory
DECODE_PARAMS = ("paged", "bf16", "int8", "d", "q_rows")
DECODE_KERNELS = [("flash_decode", "flash_decode_kernel", DECODE_PARAMS),
                  ("flash_decode_paged", "flash_decode_kernel", DECODE_PARAMS)]
DECODE_INSTANCES = 2 * 2 * 4 * 2  # q dtype x int8 K/V x head dims x (1 or 8 q rows)


def sass_phase(cuda_build, kernels=TC_KERNELS) -> None:
    """Every instance of each tensor-core kernel in its built library has
    HGMMA instructions, and every instance of a ``NO_SPILL`` kernel has no
    stack frame and no local memory.  Both are read from the libraries,
    whether this run built them or found them built."""
    for lib, kernel, params in kernels:
        hgmma = hgmma_counts(cuda_build, lib, kernel, params)
        usage = resource_usage(cuda_build, lib, kernel, params)
        say({"phase": "sass", "library": lib, "kernel": kernel, "hgmma_per_instance": hgmma,
             "hgmma_total": sum(hgmma.values()), "resources_per_instance": usage})
        if not hgmma or min(hgmma.values()) == 0:
            fail(f"{kernel}: an instance has no HGMMA instruction: {hgmma}")
        if kernel in TC_INSTANCES and len(hgmma) != TC_INSTANCES[kernel]:
            fail(f"{kernel}: {len(hgmma)} instances, expected {TC_INSTANCES[kernel]}")
        if kernel in NO_SPILL and (set(usage) != set(hgmma) or any(
                v["stack_bytes"] or v["local_bytes"] for v in usage.values())):
            fail(f"{kernel}: an instance spills (stack frame or local memory) or is missing "
                 f"from cuobjdump -res-usage: {usage}")


def resource_phase(cuda_build, kernels=STREAM_KERNELS) -> None:
    """Every instance of kernels 7 and 8 in its built library: registers,
    and no stack frame and no local memory (no spill)."""
    for lib, kernel, params in kernels:
        usage = resource_usage(cuda_build, lib, kernel, params)
        say({"phase": "resources", "library": lib, "kernel": kernel,
             "resources_per_instance": usage})
        if not usage or any(v["stack_bytes"] or v["local_bytes"] for v in usage.values()):
            fail(f"{kernel}: no instance found, or an instance spills (stack frame or local "
                 f"memory): {usage}")


def decode_resource_phase(cuda_build) -> None:
    """Kernels 5 and 6: each library holds the DECODE_INSTANCES instances
    of its own entry (paged=0 in flash_decode, paged=1 in
    flash_decode_paged), each with its registers, none with a stack frame
    or local memory (no spill)."""
    for lib, kernel, params in DECODE_KERNELS:
        usage = resource_usage(cuda_build, lib, kernel, params)
        say({"phase": "resources", "library": lib, "kernel": kernel,
             "resources_per_instance": usage})
        paged = int(lib == "flash_decode_paged")
        if (len(usage) != DECODE_INSTANCES
                or any(not n.startswith(f"paged={paged} ") for n in usage)
                or any(v["stack_bytes"] or v["local_bytes"] for v in usage.values())):
            fail(f"{lib}: expected {DECODE_INSTANCES} instances of {kernel} with paged={paged}, "
                 f"none with a stack frame or local memory: {usage}")


def tensor_core_route(fa, run: str, launches: dict) -> None:
    """Every bf16 launch of kernels 1, 2, 3 and 4 in a main-path run (all
    of its launches: every main path runs bf16) went to the tensor-core
    entry."""
    pairs = {"flash_attention_fwd": fa.flash_attention.tc_launches,
             "flash_attention_bwd_dq": fa.flash_bwd_dq.tc_launches,
             "flash_attention_bwd_dkv": fa.flash_bwd_dkv.tc_launches,
             "flash_attention_bwd_dlbias": fa.flash_bwd_dlbias.tc_launches}
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
    # kernel 4 skips what the padding mask zeroes as well (per warpgroup
    # tile and batch row): the same two bounds over its two products
    dlb_flops, dlb_all = bwd_work(bias, B, H, S, D, 4)
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
         dlb_flops, dlb_all, bwd_in + lb.numel() * lb.element_size(),
         "flash_bwd_dlbias_tc_kernel"),
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
        if name in ("flash_attention_bwd_dq", "flash_attention_bwd_dkv"):
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


# Attention-probs dropout in kernels 1-4 (csrc/dropout_hash.cuh): the rate
# the train path from a checkpoint with attention_dropout runs at, and the
# hash's integer operations per score entry (the column term's add,
# murmur3's finalizer, the compare and the select) over the H100 SXM's
# int32 rate (132 SMs x 64 int32 lanes x 1.98 GHz boost clock), the third
# term of a dropout instance's bound
PROBS_DROPOUT = 0.1
HASH_OPS = 12
PEAK_INT32 = 132 * 64 * 1.98e9


def dropout_bound(flops: float, nbytes: float, entries: float) -> tuple[float, str, str]:
    """(ms, "operations" or "bytes", the term that sets it: "tensor",
    "hash" or "bytes") of max(flops / 989 TFLOP/s, bytes / 3.35 TB/s,
    HASH_OPS * entries / int32 rate)."""
    terms = {"tensor": flops / PEAK_FLOPS * 1e3, "hash": HASH_OPS * entries / PEAK_INT32 * 1e3,
             "bytes": nbytes / PEAK_BYTES * 1e3}
    term = max(terms, key=terms.get)
    return terms[term], "bytes" if term == "bytes" else "operations", term


# the dk/dv kernel's hash multipliers as csrc/flash_bwd_tc.cu names them,
# and the swap a planted fault compiles into a copy of the source
DKV_MULS = "constexpr uint32_t DKV_QUERY_MUL = HASH_ROW_MUL, DKV_KEY_MUL = HASH_COL_MUL;"
DKV_MULS_SWAPPED = "constexpr uint32_t DKV_QUERY_MUL = HASH_COL_MUL, DKV_KEY_MUL = HASH_ROW_MUL;"


def start_swapped_dkv_build(cuda_build):
    """Planted fault: csrc/flash_bwd_tc.cu with the dk/dv kernel's hash
    taking (key, query) where it takes (query, key), compiled from a copy
    by one nvcc started now (beside the real build) unless its library is
    already built: it is named, as the real ones are, by the hash of the
    source and csrc's headers.  Returns a function that waits for the build
    and returns the library's path."""
    src = (cuda_build.CSRC / "flash_bwd_tc.cu").read_text()
    if src.count(DKV_MULS) != 1:
        fail("csrc/flash_bwd_tc.cu no longer names the dk/dv hash multipliers as the planted "
             "fault expects")
    real = cuda_build.library_path("flash_bwd_tc")
    lib = real.with_name(real.name.replace("flash_bwd_tc", "flash_bwd_tc_swapped_hash", 1))
    if lib.exists():
        return lambda: str(lib)
    os.makedirs(WORK, exist_ok=True)
    cu = os.path.join(WORK, "flash_bwd_tc_swapped_hash.cu")
    with open(cu, "w") as f:
        f.write(src.replace(DKV_MULS, DKV_MULS_SWAPPED))
    lib.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS, "-I", str(cuda_build.CSRC), "-o",
           str(tmp), cu]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)

    def wait() -> str:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            fail(f"the planted fault's build (dk/dv hash swapped) failed:\n{log[-3000:]}")
        os.replace(tmp, lib)
        return str(lib)

    return wait


@contextlib.contextmanager
def library_swapped(cuda_build, lib: str, path: str):
    """The wrappers' entries of ``lib`` loaded from the library at ``path``
    (a planted fault's build) instead of their own."""
    import ctypes

    real = cuda_build.load

    def load(name, argtypes, symbol=None):
        if name != lib:
            return real(name, argtypes, symbol)
        fn = getattr(ctypes.CDLL(path), symbol or name)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        return fn

    cuda_build.load = load
    try:
        yield
    finally:
        cuda_build.load = real


def probs_dropout_phase(torch, fa, swapped_dkv_lib: str):
    """Kernels 1-4's probs-dropout branch, bf16 on the tensor cores and
    fp32 on the CUDA cores, against their plain versions with the same seed
    at the main paths' shapes: the BART encoder (8, 16, 1024, 64) with a
    ragged padding mask (rate 0.1 and 0.5), the causal decoder at 128,
    128 x 1024 cross-attention, S = 1000, -inf rows, and the t5-large
    learned-bias encoder (with padding) and causal decoder (scale 1).  The
    limits are the no-dropout checks': bf16 within 2e-2 of the plain
    version and within TC_REF_FACTOR x the plain bf16 path's own error from
    an fp32 reference (the exact function at these bf16 values, same mask);
    fp32 within 1e-4; dlbias relative to its largest entry.  -inf rows give
    o = 0 and dq = 0; rate 0 gives the no-dropout instances' bits; a second
    launch gives the same bits.  Planted faults must break the bf16 limit
    by TC_FAULT_FACTOR: the backward's seed off by one (kernels 2-4), and
    the dk/dv kernel's hash with (query, key) swapped (a build of that
    swap).  Then the bf16 dropout instances timed at PERF.md's shapes
    beside their bound max(flops, bytes, hash operations), their plain
    versions and SDPA with dropout_p = 0.1 under the same mask (forward,
    backward, forward + backward; never called by the port).  Returns
    {row name: the kernel line's numbers}, each row's max_abs_err the
    largest error against the plain version over every case."""
    import torch.nn.functional as F

    from distributed_llms_example_tpu_torch.ops import cuda_build

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(13)
    B, H, D, S = 8, 16, 64, 1024
    seed = -1_234_567_891
    tol = {torch.bfloat16: dict(atol=2e-2, rtol=2e-2), torch.float32: dict(atol=1e-4)}
    rel_limit = {torch.bfloat16: 2e-2, torch.float32: 1e-4}

    def rnd(*shape, dtype, s=1.0):
        return (torch.randn(*shape, generator=gen, device=dev) * s).to(dtype)

    def pad_bias(K):
        lens = torch.randint(K // 5, K + 1, (B,), generator=gen, device=dev)
        lens[0], lens[1] = min(1000, K), 100
        b = torch.where(torch.arange(K, device=dev)[None, :] < lens[:, None], 0.0, -1e9)
        return b[:, None, None, :].float().contiguous()

    def max_err(a, b):
        return float((a.float() - b.float()).abs().max())

    def kernels(q, k, v, do, bias, lb, causal, scale, drop, bwd_drop=None):
        """{o, lse, dq, dk, dv[, dlb]} from kernels 1-4; the backward may
        take other dropout arguments (a planted fault)."""
        o, lse = fa.flash_attention(q, k, v, bias, learned_bias=lb, causal=causal, scale=scale,
                                    return_lse=True, **drop)
        delta = fa.attention_delta(do, o)
        kw = dict(causal=causal, scale=scale, **(drop if bwd_drop is None else bwd_drop))
        out = dict(o=o, lse=lse, dq=fa.flash_bwd_dq(q, k, v, bias, do, lse, delta, lbias=lb, **kw))
        out["dk"], out["dv"] = fa.flash_bwd_dkv(q, k, v, bias, do, lse, delta, lbias=lb, **kw)
        if lb is not None:
            out["dlb"] = fa.flash_bwd_dlbias(q, k, v, bias, lb, do, lse, delta, **kw)
        return out

    def plain(q, k, v, do, bias, lb, causal, scale, drop, o, lse):
        """The plain versions; the backward from ``o`` and ``lse``."""
        po, plse = fa.flash_attention_plain(q, k, v, bias, lbias=lb, causal=causal, scale=scale,
                                            **drop)
        kw = dict(lbias=lb, causal=causal, scale=scale, **drop)
        out = dict(o=po, lse=plse)
        out["dq"], out["dk"], out["dv"] = fa.flash_attention_bwd_plain(q, k, v, bias, o, lse, do,
                                                                       **kw)
        if lb is not None:
            out["dlb"] = fa._dlbias_plain(q, k, v, bias, lb, do, lse, fa.attention_delta(do, o),
                                          causal=causal, scale=scale, **drop)
        return out

    def reference(q, k, v, do, bias, lb, causal, scale, drop):
        """The exact function at these bf16 values, in fp32, same mask."""
        f = [t.float() for t in (q, k, v, do)]
        lbf = None if lb is None else lb.float()
        o, lse = fa.flash_attention_plain(*f[:3], bias, lbias=lbf, causal=causal, scale=scale,
                                          **drop)
        return plain(*f, bias, lbf, causal, scale, drop, o, lse)

    dead = torch.tensor([0, 7, 500, S - 1], device=dev)
    dead_bias = torch.zeros(B, 1, S, S, device=dev)
    dead_bias[:, :, dead, :] = -float("inf")
    cases = [("BART encoder padding S=1024", S, S, dict(bias=pad_bias(S)), (PROBS_DROPOUT, 0.5)),
             ("decoder causal S=128", 128, 128, dict(causal=True), (PROBS_DROPOUT,)),
             ("cross 128x1024 padding", 128, S, dict(bias=pad_bias(S)), (PROBS_DROPOUT,)),
             ("padding S=1000", 1000, 1000, dict(bias=pad_bias(1000)), (PROBS_DROPOUT,)),
             ("-inf rows S=1024", S, S, dict(bias=dead_bias), (PROBS_DROPOUT,)),
             ("t5-large encoder learned bias + padding S=1024", S, S,
              dict(bias=pad_bias(S), lb=True), (PROBS_DROPOUT,)),
             ("t5-large decoder learned bias causal S=128", 128, 128, dict(causal=True, lb=True),
              (PROBS_DROPOUT,))]
    errs: dict[str, list] = {}
    faults = {}
    for dtype in (torch.bfloat16, torch.float32):
        for name, Q, K, kw, rates in cases:
            bias, causal = kw.get("bias"), kw.get("causal", False)
            q = rnd(B, H, Q, D, dtype=dtype, s=D ** -0.5 if kw.get("lb") else 1.0)
            k, v, do = rnd(B, H, K, D, dtype=dtype), rnd(B, H, K, D, dtype=dtype), rnd(
                B, H, Q, D, dtype=dtype)
            lb = rnd(1, H, Q, K, dtype=dtype, s=0.5) if kw.get("lb") else None
            scale = 1.0 if lb is not None else D ** -0.5
            for rate in rates:
                drop = dict(dropout_rate=rate, dropout_seed=seed)
                case = f"probs dropout {rate} {name} {dtype}"
                got = kernels(q, k, v, do, bias, lb, causal, scale, drop)
                want = plain(q, k, v, do, bias, lb, causal, scale, drop, got["o"], got["lse"])
                torch.cuda.synchronize()
                for n in got:
                    row = {"o": "fwd", "lse": "fwd", "dq": "dq", "dk": "dkv", "dv": "dkv",
                           "dlb": "dlbias"}[n]
                    if n == "dlb":
                        e = check_rel(f"{case} dlbias", got[n], want[n], limit=rel_limit[dtype])
                    else:
                        e = check_close(f"{case} {n}", got[n], want[n], **tol[dtype])
                    errs.setdefault(row, []).append(e)
                if dtype == torch.bfloat16:
                    ref = reference(q, k, v, do, bias, lb, causal, scale, drop)
                    limits = {}
                    for n in ("o", "dq", "dk", "dv", "dlb"):
                        if n not in got:
                            continue
                        kernel_err, plain_err = max_err(got[n], ref[n]), max_err(want[n], ref[n])
                        limits[n] = limit = TC_REF_FACTOR * plain_err
                        ok = kernel_err <= limit
                        say({"phase": "kernel_check", "case": f"{case} {n} vs fp32 reference",
                             "kernel_err": kernel_err, "plain_bf16_err": plain_err,
                             "limit": limit, "ok": ok})
                        if not ok:
                            fail(f"{case} {n}: {kernel_err} from the fp32 reference, beyond "
                                 f"{TC_REF_FACTOR}x the plain bf16 path's {plain_err}")
                    if rate == PROBS_DROPOUT and (name.startswith("BART") or lb is not None):
                        faults[name] = (q, k, v, do, bias, lb, causal, scale, drop, ref, limits)
                if "-inf" in name and not (bool((got["o"][:, :, dead] == 0).all())
                                           and bool((got["dq"][:, :, dead] == 0).all())):
                    fail(f"{case}: fully-masked rows are not o = 0 and dq = 0")
                if lb is not None and causal and bool(
                        torch.triu(got["dlb"][0].float().abs(), diagonal=1).any()):
                    fail(f"{case}: non-zero learned-bias gradient above the causal diagonal")
                if name.startswith("BART") or lb is not None:
                    # a second launch gives the same bits; rate 0 runs the
                    # instances without dropout, bit for bit
                    again = kernels(q, k, v, do, bias, lb, causal, scale, drop)
                    none = kernels(q, k, v, do, bias, lb, causal, scale, {})
                    zero = kernels(q, k, v, do, bias, lb, causal, scale,
                                   dict(dropout_rate=0.0, dropout_seed=seed))
                    torch.cuda.synchronize()
                    if not all(torch.equal(got[n], again[n]) for n in got):
                        fail(f"{case}: two launches on the same inputs differ")
                    if not all(torch.equal(none[n], zero[n]) for n in none):
                        fail(f"{case}: rate 0 does not give the no-dropout instances' bits")
                del got, want
    say({"phase": "kernel_check", "case": "probs dropout kernels 1-4: a second launch bit-equal, "
         "rate 0 bit-equal to no dropout", "ok": True})

    # planted faults, bf16: the backward's seed off by one; the dk/dv
    # kernel's hash with (query, key) swapped
    for name, (q, k, v, do, bias, lb, causal, scale, drop, ref, limits) in faults.items():
        off = dict(drop, dropout_seed=drop["dropout_seed"] + 1)
        bad = kernels(q, k, v, do, bias, lb, causal, scale, drop, bwd_drop=off)
        with library_swapped(cuda_build, "flash_bwd_tc", swapped_dkv_lib):
            swapped = kernels(q, k, v, do, bias, lb, causal, scale, drop)
        torch.cuda.synchronize()
        for what, got, names in (("backward seed off by one", bad, ("dq", "dk", "dv", "dlb")),
                                 ("dk/dv hash with (query, key) swapped", swapped, ("dk", "dv"))):
            times = max(max_err(got[n], ref[n]) / limits[n] for n in names if n in got)
            say({"phase": "kernel_check", "case": f"probs dropout planted fault: {what}, {name}",
                 "times_limit": times, "must_exceed": TC_FAULT_FACTOR})
            if not times >= TC_FAULT_FACTOR:
                fail(f"probs dropout planted fault ({what}, {name}) reads {times}x the limit, "
                     f"under {TC_FAULT_FACTOR}x")
    del faults

    # times, bf16, rate 0.1: kernels 1-3 at the BART encoder shape, kernel 4
    # at the t5-large encoder shape with its learned bias
    drop = dict(dropout_rate=PROBS_DROPOUT, dropout_seed=seed)
    act, rows = B * H * S * D * 2, B * H * S * 4
    results = {}
    for lb_case in (False, True):
        bias = pad_bias(S)
        q = rnd(B, H, S, D, dtype=torch.bfloat16, s=D ** -0.5 if lb_case else 1.0)
        k, v, do = (rnd(B, H, S, D, dtype=torch.bfloat16) for _ in range(3))
        lb = rnd(1, H, S, S, dtype=torch.bfloat16, s=0.5) if lb_case else None
        scale = 1.0 if lb_case else D ** -0.5
        o, lse = fa.flash_attention(q, k, v, bias, learned_bias=lb, scale=scale, return_lse=True,
                                    **drop)
        delta = fa.attention_delta(do, o)
        kw = dict(causal=False, scale=scale, **drop)
        entries = float((bias.reshape(B, -1) > -1e8).sum()) * H * S  # live score entries
        lb_bytes = 0 if lb is None else lb.numel() * lb.element_size()
        bwd_in = 4 * act + 2 * rows + bias.numel() * 4 + lb_bytes
        mask = bias.to(torch.bfloat16) if lb is None else bias.to(torch.bfloat16) + lb
        qs, ks, vs = (t.detach().clone().requires_grad_(True) for t in (q, k, v))
        out = F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask, dropout_p=PROBS_DROPOUT,
                                             scale=scale)
        sdpa_fwd = time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, dropout_p=PROBS_DROPOUT, scale=scale), per_rep=5)
        sdpa_bwd = time_ms(lambda: torch.autograd.grad(out, (qs, ks, vs), do, retain_graph=True),
                           per_rep=5)

        def sdpa_both():
            o2 = F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask,
                                                dropout_p=PROBS_DROPOUT, scale=scale)
            return torch.autograd.grad(o2, (qs, ks, vs), do)

        sdpa_all = time_ms(sdpa_both, per_rep=3)
        if lb_case:
            rows_to_time = [
                ("flash_attention_bwd_dlbias_dropout",
                 lambda: fa.flash_bwd_dlbias(q, k, v, bias, lb, do, lse, delta, **kw),
                 lambda: fa._dlbias_plain(q, k, v, bias, lb, do, lse, delta, **kw),
                 bwd_work(bias, B, H, S, D, 4)[0], bwd_in + lb_bytes, "flash_bwd_dlbias_tc_kernel",
                 sdpa_all)]
        else:
            fwd_flops, fwd_bytes = fwd_work(bias, B, H, S, D)
            rows_to_time = [
                ("flash_attention_fwd_dropout",
                 lambda: fa.flash_attention(q, k, v, bias, **drop),
                 lambda: fa.flash_attention_plain(q, k, v, bias, **drop),
                 fwd_flops, fwd_bytes, "flash_fwd_tc_kernel", sdpa_fwd),
                ("flash_attention_bwd_dq_dropout",
                 lambda: fa.flash_bwd_dq(q, k, v, bias, do, lse, delta, **kw),
                 lambda: fa.flash_attention_bwd_plain(q, k, v, bias, o, lse, do, **kw)[0],
                 bwd_work(bias, B, H, S, D, 6)[0], bwd_in + act, "flash_bwd_dq_tc_kernel",
                 sdpa_bwd),
                ("flash_attention_bwd_dkv_dropout",
                 lambda: fa.flash_bwd_dkv(q, k, v, bias, do, lse, delta, **kw),
                 lambda: fa.flash_attention_bwd_plain(q, k, v, bias, o, lse, do, **kw)[1:],
                 bwd_work(bias, B, H, S, D, 8)[0], bwd_in + 2 * act, "flash_bwd_dkv_tc_kernel",
                 sdpa_bwd)]
        for name, fn, plain_fn, flops, nbytes, dev_name, lib_ms in rows_to_time:
            b_ms, b_by, term = dropout_bound(flops, nbytes, entries)
            err_row = {"fwd": "fwd", "dq": "dq", "dkv": "dkv", "dlbias": "dlbias"}[
                name.removeprefix("flash_attention_").removeprefix("bwd_").removesuffix(
                    "_dropout")]
            r = dict(max_abs_err=max(errs[err_row]), ms=time_ms(fn, per_rep=5),
                     plain_ms=time_ms(plain_fn, per_rep=2), bound_ms=b_ms, bound_by=b_by,
                     library_ms=lib_ms)
            results[name] = r
            say({"phase": "kernel_time", "kernel": name, "branch": "probs dropout 0.1", **r,
                 "bound_term": term, "bound_terms_ms": {
                     "tensor": flops / PEAK_FLOPS * 1e3, "bytes": nbytes / PEAK_BYTES * 1e3,
                     "hash": HASH_OPS * entries / PEAK_INT32 * 1e3},
                 "device_ms": device_ms_of(fn, 5, dev_name)})
        say({"phase": "kernel_time", "kernel": "SDPA with dropout_p 0.1 (yardstick)",
             "shape": "t5-large encoder, learned bias" if lb_case else "BART encoder",
             "forward_ms": sdpa_fwd, "backward_ms": sdpa_bwd, "forward_backward_ms": sdpa_all})
        del qs, ks, vs, out
    if "flash_attention_bwd_dq_dropout" in results:
        say({"phase": "kernel_time", "kernel": "probs dropout kernels 2 + 3",
             "ms": results["flash_attention_bwd_dq_dropout"]["ms"]
             + results["flash_attention_bwd_dkv_dropout"]["ms"],
             "sdpa_backward_ms": results["flash_attention_bwd_dq_dropout"]["library_ms"]})
    return results


def dropout_cases(torch, dev, gen):
    """(name, x, residual) for kernel 7's checks: the main paths' shapes in
    bf16 and fp32, a row length no vector width divides (1001), rows of 7
    and of 1, views at a storage offset that is not 16-byte aligned (x and
    the residual at the same offset, so vectors follow a scalar head; and
    at different ones, so every element is a scalar), and an fp32
    residual into a bf16 activation."""
    def rand(shape, dtype, offset=0):
        n = 1
        for d in shape:
            n *= d
        return torch.randn(n + offset, generator=gen, device=dev).to(dtype)[offset:].view(shape)

    out = []
    for shape, with_res in (((8, 1024, 1024), True), ((8, 1024, 4096), False),
                            ((8, 128, 1000), True), ((8, 128, 4096), False),
                            ((8, 128, 1001), True), ((8, 128, 1001), False),
                            ((64, 7), True), ((4096, 1), False)):
        for dtype in (torch.bfloat16, torch.float32):
            out.append((f"{shape} residual={with_res} {dtype}", rand(shape, dtype),
                        rand(shape, dtype) if with_res else None))
    for dtype, xo, ro in ((torch.bfloat16, 3, 3), (torch.bfloat16, 3, 0), (torch.bfloat16, 5, None),
                          (torch.float32, 1, 1), (torch.float32, 2, 0)):
        out.append((f"(8, 128, 1001) {dtype} offset x={xo} residual={ro}",
                    rand((8, 128, 1001), dtype, xo),
                    None if ro is None else rand((8, 128, 1001), dtype, ro)))
    out.append(("(8, 128, 1024) bf16 with an fp32 residual", rand((8, 128, 1024), torch.bfloat16),
                rand((8, 128, 1024), torch.float32)))
    return out


def dropout_kernel_phase(torch, fd):
    """Kernel 7 against dropout_plain: exactly equal, and the kept fraction;
    each case's split into vector and scalar elements (``dropout_plan``)."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2)
    rate = 0.1
    errs = []
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for case, x, res in dropout_cases(torch, dev, gen):
        for seed in (12345, -987654321):
            got = fd.fused_dropout(x, seed, rate, residual=res)
            want = fd.dropout_plain(x, seed, rate, res)
            torch.cuda.synchronize()
            same = bool(torch.equal(got, want))
            kept = float(((got if res is None else got - res.to(x.dtype)) != 0).float().mean())
            r = None if res is None else res.to(x.dtype)
            plan = fd.dropout_plan(x.numel(), x.shape[-1], x.dtype, x.data_ptr(),
                                   None if r is None else r.data_ptr(), got.data_ptr(), sms=sms)
            say({"phase": "kernel_check", "case": f"fused_dropout {case} seed={seed}",
                 "bitwise_equal": same, "kept_fraction": kept,
                 "vector_elements": plan.vector_elements,
                 "scalar_elements": plan.head + plan.tail, "grid": plan.grid})
            if not same:
                fail(f"fused_dropout {case}: kernel differs from its plain version "
                     f"(max abs err {float((got.float() - want.float()).abs().max())})")
            if res is None and x.numel() >= 2**20 and abs(kept - (1 - rate)) > 1e-3:
                fail(f"fused_dropout {case}: kept fraction {kept} vs {1 - rate}")
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
        ours = lambda: fd.fused_dropout(x, 5, rate, residual=res)  # noqa: E731
        lib_call = lambda: torch.nn.functional.dropout(x, rate)  # noqa: E731
        say({"phase": "kernel_time", "kernel": "fused_dropout", "shape": list(shape),
             "residual": with_res, **r,
             "device_ms": device_ms_of(ours, 20, "fused_dropout_kernel"), "host_us": host_us(ours),
             **({"library_device_ms": sum(profile_device(lib_call, 20)[1].values()),
                 "library_host_us": host_us(lib_call)} if lib else {})})
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
    del p, mu, nu, g, ref, lib
    worst = max(worst, adamw_table_phase(torch, fo))
    r["max_abs_err"] = worst
    return {"fused_adamw": r}


def t5_large_leaves(torch):
    """(name, shape) of every parameter tensor of t5-large, in the model's
    order (built on the meta device: nothing is allocated)."""
    from distributed_llms_example_tpu_torch.models.registry import T5_CONFIGS
    from distributed_llms_example_tpu_torch.models.t5 import T5ForConditionalGeneration

    model = T5ForConditionalGeneration(T5_CONFIGS["t5-large"], dtype=torch.float32,
                                       param_dtype=torch.float32, device="meta")
    return [(name, tuple(p.shape)) for name, p in model.named_parameters()]


def flat_leaves(buf, shapes, offsets):
    """Views of ``buf``: one leaf of each shape at each offset."""
    out = []
    for shape, o in zip(shapes, offsets):
        n = 1
        for d in shape:
            n *= d
        out.append(buf[o:o + n].view(shape))
    return out


def adamw_table_phase(torch, fo) -> float:
    """Kernel 8 over t5-large's 509 leaves in one launch: against per-leaf
    adamw_leaf_plain with one odd-length leaf (BART's final_logits_bias),
    one empty leaf, one leaf at an address no float4 takes and one NaN in
    a gradient (counted once); then the train step's tail (the gradient
    pass, the step scalars, AdamW) on the 509 leaves: the norm within one
    fp32 ulp of grad_prep_plain, the divided gradients bit-equal to
    ``div_``'s, a rerun bit-equal in the norm and in every parameter and
    moment; the tail's time against clip_grad_norm_(foreach=True) +
    AdamW(fused=True) on the same tensors.  Returns the largest error."""
    from distributed_llms_example_tpu_torch.train import optim as toptim

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)
    hyper = dict(b1=0.9, b2=0.999, eps=1e-8, max_norm=1.0)
    named = t5_large_leaves(torch)
    shapes = [shape for _, shape in named]
    decay = [len(shape) >= 2 and not name.endswith(("scale", "bias")) for name, shape in named]
    t5_leaves = len(shapes)
    # extra leaves: odd length, empty, and one a float off 16-byte alignment
    shapes += [(50265,), (0,), (1000,)]
    decay += [False, False, True]
    sizes = [int(torch.Size(shape).numel()) for shape in shapes]
    offsets, o = [], 0
    for i, n in enumerate(sizes):
        o += (-o) % 4 + (1 if i == len(sizes) - 1 else 0)
        offsets.append(o)
        o += n
    total = o
    originals = {k: torch.randn(total, generator=gen, device=dev) for k in ("p", "mu", "g")}
    originals["nu"] = torch.rand(total, generator=gen, device=dev) * 1e-3
    nan_leaf = next(i for i, n in enumerate(sizes) if n == 1024)
    originals["g"][offsets[nan_leaf] + 17] = float("nan")
    work = {k: v.clone() for k, v in originals.items()}
    leaves = {k: flat_leaves(v, shapes, offsets) for k, v in work.items()}
    table = fo.leaf_table(leaves["g"], leaves["p"], leaves["mu"], leaves["nu"], decay)
    vec = int((table.flags & fo.FLAG_VEC).astype(bool).sum())
    scal = torch.tensor([3.5, 0.0, 0.271, 0.00299, -1e-4, 0, 0, 0], device=dev)
    stats = torch.zeros(len(sizes), fo.STATS, dtype=torch.float64, device=dev)
    before = fo.fused_adamw_leaf.launches
    fo.adamw_tree_apply(leaves["p"], leaves["mu"], leaves["nu"], leaves["g"], scal, stats,
                        weight_decay=0.01, decay=decay, table=table, **hyper)
    torch.cuda.synchronize()
    launches = fo.fused_adamw_leaf.launches - before
    want = {k: originals[k].clone() for k in ("p", "mu", "nu")}  # the gaps stay as they are
    want_stats = torch.zeros_like(stats)
    orig = {k: flat_leaves(v, shapes, offsets) for k, v in originals.items()}
    for i, (n, off) in enumerate(zip(sizes, offsets)):
        wp, wmu, wnu, st = fo.adamw_leaf_plain(orig["p"][i], orig["mu"][i], orig["nu"][i],
                                               orig["g"][i], scal, wd=0.01 if decay[i] else 0.0,
                                               **hyper)
        for k, v in (("p", wp), ("mu", wmu), ("nu", wnu)):
            want[k][off:off + n] = v.reshape(-1)
        want_stats[i] = st.double()
    worst = 0.0
    for k in ("p", "mu", "nu"):
        ok, err = close_enough(work[k], want[k], atol=0.0, rtol=ADAMW_RTOL)
        say({"phase": "kernel_check", "case": f"fused_adamw table t5-large + 3 leaves {k}",
             "leaves": len(sizes), "float4_leaves": vec, "launches": launches,
             "max_abs_err": err, "rtol": ADAMW_RTOL, "ok": ok})
        if not ok:
            fail(f"fused_adamw table {k}: kernel differs from per-leaf adamw_leaf_plain ({err})")
        worst = max(worst, err)
    nonfinite = stats[:, fo.STAT_NONFINITE]
    ok_st, err_st = close_enough(stats[:, :2], want_stats[:, :2], atol=0.0, rtol=1e-5)
    if (launches != 1 or not ok_st or float(nonfinite[nan_leaf]) != 1.0
            or float(nonfinite.sum()) != 1.0):
        fail(f"fused_adamw table: {launches} launches, stats rel err {err_st}, non-finite "
             f"counts {nonfinite.nonzero().flatten().tolist()} (want leaf {nan_leaf} once)")
    del want, want_stats, orig, stats

    # the train step's tail on the 509 t5-large leaves, no NaN: twice from
    # the same state, bit-equal
    originals["g"][offsets[nan_leaf] + 17] = 0.5
    shapes, sizes, offsets = shapes[:t5_leaves], sizes[:t5_leaves], offsets[:t5_leaves]
    t5_total = offsets[-1] + sizes[-1]
    spec = toptim.OptimizerSpec(learning_rate=1e-4, warmup_steps=0)
    sched = toptim.linear_schedule_with_warmup(1e-4, 0, 100)
    tokens = torch.full((), 977.0, device=dev)
    first = None
    for _ in range(2):
        for k, v in work.items():
            v.copy_(originals[k])
        leaves = {k: flat_leaves(v, shapes, offsets) for k, v in work.items()}
        state = toptim.AdamWState(0, leaves["mu"], leaves["nu"], torch.zeros(
            len(sizes), fo.STATS, dtype=torch.float64, device=dev))
        named_p = [(n, p) for (n, _), p in zip(named, leaves["p"])]
        gnorm = toptim.fused_optimizer_apply(spec, sched, named_p, state, leaves["g"], tokens)
        torch.cuda.synchronize()
        if first is None:
            first = (gnorm.clone(), {k: v.clone() for k, v in work.items() if k != "g"})
    rerun = bool(torch.equal(first[0], gnorm)) and all(
        torch.equal(v, work[k]) for k, v in first[1].items())
    divided = bool(torch.equal(work["g"][:t5_total], originals["g"][:t5_total] / tokens))
    g_plain = [v.clone() for v in flat_leaves(originals["g"], shapes, offsets)]
    gnorm_plain = fo.grad_prep_plain(g_plain, tokens)
    del g_plain
    ulp = float(torch.nextafter(gnorm_plain, torch.full((), float("inf"), device=dev))
                - gnorm_plain)
    norm_err = abs(float(gnorm) - float(gnorm_plain))
    say({"phase": "kernel_check", "case": "fused_grad_prep + fused_adamw t5-large tail",
         "gnorm": float(gnorm), "gnorm_plain": float(gnorm_plain),
         "gnorm_abs_err": norm_err, "fp32_ulp": ulp, "divided_bitwise_equal": divided,
         "rerun_bitwise_equal": rerun})
    if not (norm_err <= ulp and divided and rerun):
        fail("fused_grad_prep: the norm is more than one fp32 ulp from grad_prep_plain, the "
             "division differs from div_, or a rerun differs")
    del first

    # the tail's time: ours (tokens 1, so the gradients keep their size
    # from call to call) against the library's clip + AdamW on the same
    # tensors; both sets of state take ~24 GB, freed afterwards
    del originals
    free_cuda()
    ones = torch.ones((), device=dev)
    named_p = [(n, p) for (n, _), p in zip(named, leaves["p"])]
    state.count = 0
    run = lambda: toptim.fused_optimizer_apply(spec, sched, named_p, state, leaves["g"], ones)  # noqa: E731
    n = sum(sizes)
    counts: dict[str, float] = {}
    _, kernels = profile_device(run, 3, counts)
    ours = {k: v for k, v in kernels.items() if "fused_" in k}
    params = [torch.nn.Parameter(p) for p in leaves["p"]]
    for p, g in zip(params, leaves["g"]):
        p.grad = g

    def lib_step():
        torch.nn.utils.clip_grad_norm_(params, 1.0, foreach=True)
        lib.step()

    lib = torch.optim.AdamW(params, lr=1e-4, weight_decay=0.01, fused=True)
    b_ms, b_by = bound(0.0, 36.0 * n)
    say({"phase": "kernel_time", "kernel": "fused_grad_prep + fused_adamw",
         "call": "train step tail, t5-large", "leaves": len(sizes), "elements": n,
         "ms": time_ms(run, per_rep=2, reps=5), "device_ms": sum(ours.values()),
         "host_ms": host_us(run, 20) / 1e3,
         "device_ms_by_kernel": ours, "launches_per_tail": sum(counts.values()),
         "kernel_launches_per_tail": {k: counts[k] for k in ours},
         "bound_ms": b_ms, "bound_by": b_by,
         "library": "clip_grad_norm_(foreach=True) + AdamW(fused=True)",
         "library_ms": time_ms(lib_step, per_rep=2, reps=5),
         "library_host_ms": host_us(lib_step, 20) / 1e3})
    del params, lib, leaves, work, state
    free_cuda()
    return worst


def paged_case(torch, fa, *, dtype, Q, heads_kv=32, gen, block_size=128, heads=32):
    """Kernel 6's inputs at the llama-2-7b decode shape: q (8, 32, Q, 128);
    a pool of 72 blocks of 128 slots in scrambled order (or as many blocks
    of ``block_size`` slots as hold the same 9216); 1152 logical slots a
    row, rows in a 1024-wide or a 512-wide bucket with 200-1024 prompt
    tokens, so the block tables hold sentinels in the prompt gap (under the
    padding bias) and, for the 512-wide rows, past the budget; staggered
    offsets inside each row's 128-slot decode tail.  ``heads``: q heads (a
    tensor rank's share)."""
    import numpy as np

    dev = torch.device("cuda")
    B, H, D, BS = 8, heads, 128, block_size
    N, NT = 72 * 128 // BS, 1152 // BS
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
        for j in range(128 // BS):
            bt[b, buckets[b] // BS + j] = perm.pop()
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
    decode shape, Q = 8 and then Q = 1 (the numbers returned), each beside
    kernel 5's on the gathered view (``decode_time``).  Returns
    ({"flash_decode_paged": numbers}, kernel 5's largest error here)."""
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
    # a pool block size --kv-block-size admits beside 128, so that one
    # 64-slot tile spans two blocks
    for dtype, Q, tol in ((torch.bfloat16, 1, bf), (torch.float32, 8, f32)):
        q, kp, vp, bt, off, bias, _ = paged_case(torch, fa, dtype=dtype, Q=Q, gen=gen,
                                                 block_size=32)
        o = fa.flash_decode_paged(q, kp, vp, bias, block_tables=bt, offsets=off)
        po = fa.flash_decode_paged_plain(q, kp, vp, bias, block_tables=bt, offsets=off)
        o5 = fa.flash_decode(q, fa.gather_blocks(kp, bt), fa.gather_blocks(vp, bt), bias,
                             offsets=off)
        torch.cuda.synchronize()
        case = f"flash_decode_paged block size 32 Q={Q} {dtype}"
        errs.append(check_close(case, o, po, **tol))
        errs5.append(check_close(f"flash_decode on the gathered view block size 32 Q={Q} "
                                 f"{dtype}", o5, po, **tol))
        vs_flat[case] = float((o.float() - o5.float()).abs().max())
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

    # times at the llama-2-7b decode shape, bf16: Q = 1 (the decode step)
    # and Q = 8 (a block of eight rows, the kernel's other instance)
    for Q in (8, 1):
        q, kp, vp, bt, off, bias, _ = paged_case(torch, fa, dtype=torch.bfloat16, Q=Q, gen=gen)
        run = lambda: fa.flash_decode_paged(q, kp, vp, bias, block_tables=bt, offsets=off)  # noqa: E731
        view_k, view_v = fa.gather_blocks(kp, bt), fa.gather_blocks(vp, bt)
        # query row i sits at offset + i and sees the slots up to there
        row = torch.arange(Q, device="cuda")[None, None, :, None]
        k_pos = torch.arange(view_k.shape[2], device="cuda")[None, None, None, :]
        sdpa_mask = (bias > -1) & (k_pos <= off[:, None, None, None] + row)
        lib_ms = time_ms(lambda: F.scaled_dot_product_attention(q, view_k, view_v,
                                                                attn_mask=sdpa_mask),
                         per_rep=100)
        gather_ms = time_ms(lambda: (fa.gather_blocks(kp, bt), fa.gather_blocks(vp, bt)),
                            per_rep=20)
        # bytes: the K/V of every slot the output depends on, read once — up
        # to the last row's offset, in an allocated tile and not under the
        # padding bias (the tail of each row's last prompt tile is) — plus
        # q, o, the bias, the tables and the offsets; flops: each row's own
        # slots
        alloc = (bt < 72).repeat_interleave(128, dim=1) & (bias[:, 0, 0, :] > -1)
        seen = alloc[:, None, :] & (k_pos[0, 0] <= off[:, None, None] + row[0, 0])  # (B, Q, L)
        live = int(seen[:, -1].sum())
        H, D = 32, 128
        flops = 4.0 * H * D * float(seen.sum())
        nbytes = (2 * H * live * D * 2 + 2 * q.numel() * 2 + bias.numel() * 4 + bt.numel() * 4
                  + 8 * 4)
        b_ms, b_by = bound(flops, nbytes)
        r = dict(max_abs_err=max(errs), ms=time_ms(run, per_rep=200),
                 plain_ms=time_ms(lambda: fa.flash_decode_paged_plain(
                     q, kp, vp, bias, block_tables=bt, offsets=off), per_rep=20),
                 bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms)
        say({"phase": "kernel_time", "kernel": "flash_decode_paged", "Q": Q, **r,
             "live_slots": live, "gather_ms_beside_library": gather_ms,
             "kernel6_bit_equal_kernel5": bit_equal,
             "device_ms": device_ms_of(run, 50, "flash_decode_kernel")})
        # kernel 5 on the already gathered view of the same blocks: the flat
        # path's call at this shape (it reads the prompt gap too, which the
        # padding bias masks)
        decode_time(torch, fa, "llama-2-7b flat", q, view_k, view_v, bias, off, padding=True,
                    kernel6_bit_equal_kernel5=bit_equal)
    return {"flash_decode_paged": r}, max(errs5)


def write_train_records(path: str, n: int = 48, *, seed: int = 0,
                        summary: tuple[int, int] = (20, 128)) -> None:
    import numpy as np

    rng = np.random.RandomState(seed)
    alphabet = np.array(list("abcdefghijklmnopqrstuvwxyz      .,"))
    recs = [{"dialogue": "".join(rng.choice(alphabet, rng.randint(200, 1025))),
             "summary": "".join(rng.choice(alphabet, rng.randint(*summary)))} for _ in range(n)]
    with open(path, "w") as f:
        json.dump(recs, f)


# byte tokens on every run, a checkpoint directory's included (it holds no
# tokenizer files)
TRAIN_ARGS = [
    "--model-ckpt", "bart-large-cnn", "--tokenizer", "byte", "--batch-size", "8",
    "--num-epochs", "1", "--max-source-length", "1024", "--max-target-length", "128",
    "--compute-dtype", "bfloat16",
    "--learning-rate", "1e-4", "--warmup-steps", "0", "--seed", "0", "--log-every-steps", "1",
]


def zero_counters(fa, fd, fo) -> None:
    for fn in (fa.flash_attention, fa.flash_bwd_dq, fa.flash_bwd_dkv, fa.flash_bwd_dlbias,
               fd.fused_dropout, fo.fused_adamw_leaf, fo.fused_grad_prep, fo.grad_norm_finish,
               fa.flash_decode, fa.flash_decode_paged):
        fn.launches = 0
    for fn in (fa.flash_attention, fa.flash_bwd_dq, fa.flash_bwd_dkv, fa.flash_bwd_dlbias):
        fn.tc_launches = fn.drop_launches = 0


def drop_counters(fa) -> dict:
    """Kernels 1-4's launches of their probs-dropout instances."""
    return {"flash_attention_fwd": fa.flash_attention.drop_launches,
            "flash_attention_bwd_dq": fa.flash_bwd_dq.drop_launches,
            "flash_attention_bwd_dkv": fa.flash_bwd_dkv.drop_launches,
            "flash_attention_bwd_dlbias": fa.flash_bwd_dlbias.drop_launches}


def read_counters(fa, fd, fo) -> dict:
    return {"flash_attention_fwd": fa.flash_attention.launches,
            "flash_attention_bwd_dq": fa.flash_bwd_dq.launches,
            "flash_attention_bwd_dkv": fa.flash_bwd_dkv.launches,
            "flash_attention_bwd_dlbias": fa.flash_bwd_dlbias.launches,
            "fused_dropout": fd.fused_dropout.launches,
            "fused_adamw": fo.fused_adamw_leaf.launches,
            "fused_grad_prep": fo.fused_grad_prep.launches,
            "fused_grad_norm_finish": fo.grad_norm_finish.launches}


def learned_bias_attention(model) -> int:
    """Attention modules that take a learned bias in training: every
    self-attention of a T5 stack (the relative-position bias); none in
    BART."""
    from distributed_llms_example_tpu_torch.models.t5 import T5Attention

    return sum(isinstance(m, T5Attention) and name.endswith("self_attn")
               for name, m in model.named_modules())


def expected_train_launches(model, steps: int, accum: int = 1, *, sharded: bool = False) -> dict:
    """Per-run launch counts the model implies: one forward kernel and one
    dq and one dk/dv kernel per attention module per microbatch, one
    learned-bias gradient kernel per attention module with a learned bias
    per microbatch, one dropout kernel per dropout site in the forward and
    again in the backward, and per step one gradient pass and one AdamW
    launch per group of the leaf table (MAX_LEAVES parameter tensors a
    launch), and for a sharded model (FSDP) the norm's finish once a step."""
    from distributed_llms_example_tpu_torch.ops.fused_dropout import count_dropout_sites
    from distributed_llms_example_tpu_torch.ops.fused_optim import leaf_groups
    from distributed_llms_example_tpu_torch.ops.mha import MultiHeadAttention

    attn = sum(isinstance(m, MultiHeadAttention) for m in model.modules())
    tables = len(leaf_groups([p.numel() for p in model.parameters()]))
    return {"flash_attention_fwd": attn * accum * steps,
            "flash_attention_bwd_dq": attn * accum * steps,
            "flash_attention_bwd_dkv": attn * accum * steps,
            "flash_attention_bwd_dlbias": learned_bias_attention(model) * accum * steps,
            "fused_dropout": 2 * count_dropout_sites(model) * accum * steps,
            "fused_adamw": tables * steps,
            "fused_grad_prep": tables * steps,
            "fused_grad_norm_finish": steps if sharded else 0}


def train_phase(torch, fa, fd, fo, cli, model: str = "bart-large-cnn", *, probs_dropout=0.0,
                loaded=None, budget: bool = False):
    """The CLI's train entry at full width, saving to <WORK>/<run>-out;
    counters, losses, gradients (and, for T5, both bucket tables'), the
    export reloaded bit-equal, and one profiled step.  ``model`` may be a
    checkpoint directory whose config sets attention_dropout to
    ``probs_dropout``, or ``loaded`` a model built here with that
    attn_dropout_rate (trained in place of ``model``'s, whose name it
    keeps): then every launch of kernels 1-4 must be a dropout instance,
    and none otherwise.  ``budget``: with the JSONL sink and the step-time
    budget at a log cadence of 2 (the health numerics off, as without), and
    the last account printed."""
    from distributed_llms_example_tpu_torch.models.registry import load_model
    from distributed_llms_example_tpu_torch.ops.mha import MultiHeadAttention

    os.makedirs(WORK, exist_ok=True)
    path = os.path.join(WORK, "train.json")
    write_train_records(path)
    run = os.path.basename(model) + ("-attention-dropout" if loaded is not None and probs_dropout
                                     else "")
    out_dir = fresh_dir(run + "-out")
    zero_counters(fa, fd, fo)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with logged_events() as events:
        trainer = cli.train([*TRAIN_ARGS, "--model-ckpt", model, "--train-file", path,
                             "--output-dir", out_dir,
                             *([*BUDGET_ARGS, "--log-every-steps", "2"] if budget else [])],
                            loaded=loaded)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if budget:
        budget_account(run, out_dir)
    launches = read_counters(fa, fd, fo)
    dropped = drop_counters(fa)
    tensor_core_route(fa, f"{run} train", launches)
    want_drop = {k: launches[k] if probs_dropout else 0 for k in dropped}
    say({"phase": "train_probs_dropout_launches", "model": run,
         "attention_dropout": trainer.loaded.config.attn_dropout_rate,
         "dropout_launches": dropped, "expected": want_drop})
    if trainer.loaded.config.attn_dropout_rate != probs_dropout or dropped != want_drop:
        fail(f"{run} train: probs-dropout launches {dropped}, expected {want_drop}")
    # the export of the trained fp32 weights reloads bit for bit
    saved = os.path.join(out_dir, "model")
    t1 = time.perf_counter()
    back = load_model(saved, dtype=trainer.model.dtype, device="cuda", train=True).module
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t1
    trained = dict(trainer.model.named_parameters())
    equal = [torch.equal(p, trained[n]) for n, p in back.named_parameters()]
    say({"phase": "train_export", "model": run, "dir": saved, "files": sorted(os.listdir(saved)),
         "bytes": os.path.getsize(os.path.join(saved, "model.safetensors")),
         "reload_s": load_s, "parameters": len(equal), "bit_equal": sum(equal)})
    if len(equal) != len(trained) or not all(equal):
        fail(f"{run}: the saved checkpoint does not reload to the trained weights")
    del back
    steps = len(trainer.history)
    want = expected_train_launches(trainer.model, steps, trainer.cfg.grad_accum_steps)
    losses = [float(m["loss"]) for m in trainer.history]
    step_s = [b - a for a, b in zip(trainer.step_ends, trainer.step_ends[1:])]
    t5 = model.startswith("t5")
    say({"phase": "train_launches", "model": run, "steps": steps, "launches": launches,
         "expected": want, "per_step": {k: v / max(steps, 1) for k, v in launches.items()}})
    # every kernel of the path launched, the learned-bias gradient on T5
    # only (the norm's finish entry runs for a sharded model alone)
    required = [k for k in want if (t5 or k != "flash_attention_bwd_dlbias")
                and k != "fused_grad_norm_finish"]
    if steps != 6 or launches != want or any(want[k] == 0 for k in required):
        fail(f"{run} train run: {steps} steps, launches {launches} vs {want}")
    named = dict(trainer.model.named_parameters())
    qkv = {n: float(named[n].grad.abs().max()) for n in named
           if n.endswith(("q_proj.weight", "k_proj.weight", "v_proj.weight"))}
    attn = sum(isinstance(m, MultiHeadAttention) for m in trainer.model.modules())
    tables = {n: float(named[n].grad.abs().max()) for n in named
              if n.endswith("relative_attention_bias.weight")}
    say({"phase": "train", "model": run, "wall_s": wall, "losses": losses,
         "grad_norms": [float(m["grad_norm"]) for m in trainer.history],
         "learning_rates": [m["learning_rate"] for m in trainer.history],
         "step_s_after_first": step_s, "step_s_median": statistics.median(step_s),
         "tokens_per_step": [float(m["target_tokens"]) for m in trainer.history],
         "peak_mem_bytes": torch.cuda.max_memory_allocated(),
         "qkv_weight_grads": len(qkv), "qkv_min_of_max_abs_grad": min(qkv.values()),
         "bucket_table_max_abs_grad": tables})
    if not all(torch.isfinite(torch.tensor(losses))):
        fail(f"{run} train losses not finite: {losses}")
    if len(qkv) != 3 * attn or min(qkv.values()) <= 0.0:
        fail(f"{run}: some q/k/v projection weight got no gradient on the kernel path")
    if t5 and (len(tables) != 2 or min(tables.values()) <= 0.0):
        fail(f"{run}: a relative-position bucket table got no gradient: {tables}")
    profile_train_step(torch, trainer)
    checkpoint_costs(run, events, out_dir)
    return launches | {f"{k}_dropout": v for k, v in dropped.items()}, trainer


def fresh_dir(name: str) -> str:
    """<WORK>/<name>, emptied: a run resumes from the checkpoints it finds
    in its --output-dir, and a save refuses a step already on disk."""
    path = os.path.join(WORK, name)
    shutil.rmtree(path, ignore_errors=True)
    return path


def tree_bytes(path: str) -> int:
    """Bytes of the files under ``path`` (a link counts as itself)."""
    return sum(os.lstat(os.path.join(d, f)).st_size for d, _, fs in os.walk(path) for f in fs)


# the modules whose JSON lines the fault-tolerance checks read
LOGGING_MODULES = ("train.trainer", "io.checkpoint", "obs.health", "obs.chaos", "obs.recorder",
                   "train.recovery")


@contextlib.contextmanager
def logged_events():
    """Every JSON line those modules log, collected (and printed as ever);
    a ``ckpt_saved`` line also gets the bytes under WORK when it is logged
    (the write is renamed into place, retention not yet applied: the peak)."""
    import importlib

    mods = [importlib.import_module(f"distributed_llms_example_tpu_torch.{m}")
            for m in LOGGING_MODULES]
    real = mods[0].log_json
    events: list[dict] = []

    def log(obj, **kw):
        obj = dict(obj)
        if obj.get("event") == "ckpt_saved":
            obj["work_bytes"] = tree_bytes(WORK)
        events.append(obj)
        real(obj, **kw)

    for m in mods:
        m.log_json = log
    try:
        yield events
    finally:
        for m in mods:
            m.log_json = real


def checkpoint_costs(run: str, events: list[dict], out_dir: str) -> None:
    """Each save's and restore's seconds and GB (the crc32 manifest's and
    verify's GB/s beside them), the peak bytes under WORK; then the run's
    checkpoints/ goes (its model/ export stays)."""
    saves = [{"step": e["step"], "gb": e["bytes"] / 1e9, "host_copy_s": e["copy_s"],
              "write_s": e["write_s"], "manifest_crc32_s": e["manifest_s"],
              "crc32_gb_per_s": e["bytes"] / 1e9 / max(e["manifest_s"], 1e-9)}
             for e in events if e.get("event") == "ckpt_saved"]
    restores = [{"step": e["step"], "gb": e["bytes"] / 1e9, "verify_s": e["verify_s"],
                 "read_s": e["read_s"], "verify_gb_per_s": e["bytes"] / 1e9 / max(e["verify_s"], 1e-9)}
                for e in events if e.get("event") == "ckpt_restored"]
    say({"phase": "checkpoint_cost", "run": run, "saves": saves, "restores": restores,
         "peak_work_gb": max([e["work_bytes"] for e in events if "work_bytes" in e] + [0]) / 1e9})
    shutil.rmtree(os.path.join(out_dir, "checkpoints"), ignore_errors=True)


# phase 5c: phase 5's recipe with a checkpoint every 3 steps, the second run
# preempted by a real SIGTERM to this process after step 4
FT_SAVE_EVERY = 3
FT_PREEMPT_AT = 4
# the rewind run: a checkpoint every 2 steps, NaN before step 3
FT_REWIND_SAVE_EVERY = 2
FT_NAN_AT = 3
# phase 5c's depth (bart-large-cnn's widths): its nine saves of the whole
# training state at 12 + 12 layers held the run near its time limit, at
# 4 + 4 phase 16's serving runs did, and at 2 + 2 phase 19 did
FT_LAYERS = 1
# health numerics from kernel 8's float64 per-leaf sums against the same
# numbers from its plain version's (fp32 sums per leaf): relative
HEALTH_RTOL = 1e-6


def equal_payloads(torch, a: str, b: str) -> bool:
    """Two checkpoint steps' state.safetensors hold the same tensors, bit
    for bit, and their meta.json the same host scalars."""
    from distributed_llms_example_tpu_torch.io.safetensors import load_file

    ta, tb = (load_file(os.path.join(d, "state.safetensors")) for d in (a, b))
    metas = [json.load(open(os.path.join(d, "meta.json"))) for d in (a, b)]
    return set(ta) == set(tb) and all(torch.equal(ta[k], tb[k]) for k in ta) \
        and metas[0] == metas[1]


def ft_events(events, name):
    return [e for e in events if e.get("event") == name]


def fault_tolerance_phase(torch, fa, fd, fo, cli) -> dict:
    """Phase 5c: phase 5's recipe (bart-large-cnn, bf16, batch 8, 6 steps).
    (a) From phase 5's checkpoint with every dropout 0: an uninterrupted run
    with a checkpoint every 3 steps, one that a SIGTERM stops after step 4,
    and one resuming it: steps 5-6's losses, the final checkpoint's payload
    and the model export bit-equal to the uninterrupted run's, kernels 1-3
    and 8 launched for exactly 2 steps.  (b) The default config (dropout
    0.1: kernel 7 too) with a rewind on a NaN before step 3: one rewind to
    step 2, kernel 8's non-finite count > 0 at the anomaly step only, the
    leaf table built once, the final state bit-equal to a clean run that
    quarantines the same batch from the start.  (c) One more step of (b)'s
    trainer: the health numerics from kernel 8's sums within HEALTH_RTOL
    of the plain version's; a leaf moved to another bucket must break it.
    (d) Each save's and restore's seconds and GB.  Returns the launches of
    the resumed run and of the rewind run."""
    import filecmp

    from distributed_llms_example_tpu_torch import obs as obs_mod
    from distributed_llms_example_tpu_torch.core.config import config_from_args
    from distributed_llms_example_tpu_torch.data.dataset import load_json_records
    from distributed_llms_example_tpu_torch.train import optim as optim_mod
    from distributed_llms_example_tpu_torch.train import trainer as trainer_mod

    path = os.path.join(WORK, "train.json")
    write_train_records(path)
    say({"phase": "fault_tolerance_disk", "free_gb": shutil.disk_usage(WORK).free / 1e9})
    # ---- (a) preemption and resume, bit-equal
    src = bart_hf_dir(torch, FT_LAYERS)
    ckpt = linked_checkpoint(src, "bart-large-cnn-no-dropout", dropout=0.0,
                             attention_dropout=0.0, activation_dropout=0.0)
    args = [*TRAIN_ARGS, "--model-ckpt", ckpt, "--train-file", path,
            "--save-every-steps", str(FT_SAVE_EVERY)]
    straight_dir, resumed_dir = fresh_dir("ft-straight-out"), fresh_dir("ft-resumed-out")
    handlers = (signal.getsignal(signal.SIGTERM), signal.getsignal(signal.SIGINT))
    with logged_events() as events:
        t = cli.train([*args, "--output-dir", straight_dir])
        straight = {"result": t.result, "losses": [m["loss"].item() for m in t.history]}
        del t
        free_cuda()
        t = cli.train([*args, "--output-dir", resumed_dir, "--chaos", f"sigterm@{FT_PREEMPT_AT}"])
        stopped = {"result": t.result, "steps_on_disk": t.checkpointer.all_steps(),
                   "handlers_restored": handlers == (signal.getsignal(signal.SIGTERM),
                                                     signal.getsignal(signal.SIGINT))}
        del t
        free_cuda()
        torch.cuda.synchronize()
        zero_counters(fa, fd, fo)
        t = cli.train([*args, "--output-dir", resumed_dir])
        torch.cuda.synchronize()
        resume_launches = read_counters(fa, fd, fo)
        want = expected_train_launches(t.model, 2)
        resumed = {"result": t.result, "start_step": t.start_step, "count": t.opt_state.count,
                   "losses": [m["loss"].item() for m in t.history]}
        del t
        free_cuda()
    cursor = ft_events(events, "recovery_cursor_restored")
    final = [os.path.join(d, "checkpoints", "6") for d in (straight_dir, resumed_dir)]
    same_payload = equal_payloads(torch, *final)
    same_export = filecmp.cmp(*(os.path.join(d, "model", "model.safetensors")
                                for d in (straight_dir, resumed_dir)), shallow=False)
    say({"phase": "fault_tolerance_resume", "uninterrupted": straight, "preempted": stopped,
         "resumed": resumed, "resumed_events": ft_events(events, "resumed"), "cursor": cursor,
         "launches": resume_launches, "expected": want,
         "losses_bit_equal": resumed["losses"] == straight["losses"][FT_PREEMPT_AT:],
         "final_checkpoint_bit_equal": same_payload, "model_export_bit_equal": same_export})
    if straight["result"].get("steps") != 6 or "preempted" in straight["result"]:
        fail(f"phase 5c uninterrupted run: {straight['result']}")
    if not stopped["result"].get("preempted") or stopped["result"]["steps"] != FT_PREEMPT_AT \
            or stopped["steps_on_disk"] != [FT_SAVE_EVERY, FT_PREEMPT_AT] \
            or not stopped["handlers_restored"]:
        fail(f"phase 5c preempted run: {stopped}")
    if [e["step"] for e in ft_events(events, "resumed")] != [FT_PREEMPT_AT] or len(cursor) != 1 \
            or (cursor[0]["epoch"], cursor[0]["pos"]) != (0, FT_PREEMPT_AT) \
            or resumed["start_step"] != FT_PREEMPT_AT or resumed["count"] != 6:
        fail(f"phase 5c resume: {resumed}, cursor {cursor}")
    if resume_launches != want:
        fail(f"phase 5c resumed run: launches {resume_launches}, expected 2 steps' {want}")
    if resumed["losses"] != straight["losses"][FT_PREEMPT_AT:] or not same_payload \
            or not same_export:
        fail("phase 5c: the resumed run is not bit-equal to the uninterrupted one")
    checkpoint_costs("5c (a) resume", events, resumed_dir)
    shutil.rmtree(os.path.join(straight_dir, "checkpoints"), ignore_errors=True)

    # ---- (b) the rewind on a NaN
    rewind_dir, oracle_dir = fresh_dir("ft-rewind-out"), fresh_dir("ft-oracle-out")
    # bart-large-cnn's config (dropout 0.1) at FT_LAYERS layers
    rargs = [*TRAIN_ARGS, "--model-ckpt", src, "--train-file", path, "--health", "on"]
    windows: list = []
    tables = []
    # the health window's one transfer (TrainerObs) and the leaf table
    real_to_host, real_leaf_table = obs_mod.to_host, optim_mod.leaf_table

    def to_host(pending):
        out = real_to_host(pending)
        windows.extend(out)
        return out

    def leaf_table(*a, **k):
        tables.append(1)
        return real_leaf_table(*a, **k)

    obs_mod.to_host, optim_mod.leaf_table = to_host, leaf_table
    try:
        with logged_events() as events:
            torch.cuda.synchronize()
            zero_counters(fa, fd, fo)
            t = cli.train([*rargs, "--output-dir", rewind_dir, "--save-every-steps",
                           str(FT_REWIND_SAVE_EVERY), "--on-anomaly", "rewind",
                           "--chaos", f"nan_grad@{FT_NAN_AT}"])
            torch.cuda.synchronize()
            rewind_launches = read_counters(fa, fd, fo)
    finally:
        obs_mod.to_host, optim_mod.leaf_table = real_to_host, real_leaf_table
    steps_run = len(windows)
    want = expected_train_launches(t.model, steps_run)
    nonfinite = [[s, m["nonfinite_count"]] for s, m in windows]
    kinds = {k: ft_events(events, k) for k in ("chaos_injection", "obs_anomaly", "recovery",
                                                "quarantine", "quarantine_skip")}
    say({"phase": "fault_tolerance_rewind", "result": t.result, "history": len(t.history),
         "events": kinds, "nonfinite_count_per_step": nonfinite, "leaf_tables_built": len(tables),
         "launches": rewind_launches, "expected": want,
         "losses": [m["loss"].item() for m in t.history]})
    counts = {k: len(v) for k, v in kinds.items()}
    if counts != dict.fromkeys(kinds, 1) \
            or (kinds["obs_anomaly"][0]["code"], kinds["obs_anomaly"][0]["step"]) != ("nonfinite",
                                                                                    FT_NAN_AT) \
            or (kinds["recovery"][0]["action"], kinds["recovery"][0]["restored_step"]) != (
                "rewind", FT_REWIND_SAVE_EVERY):
        fail(f"phase 5c rewind: events {counts}, {kinds['obs_anomaly']}, {kinds['recovery']}")
    if t.result.get("steps") != 5 or "anomaly" in t.result or len(t.history) != 5 \
            or not math.isfinite(t.history[-1]["loss"].item()):
        fail(f"phase 5c rewind run: {t.result}, {len(t.history)} steps in its history")
    if [s for s, _ in nonfinite] != [1, 2, FT_NAN_AT, FT_NAN_AT, 4, 5] \
            or not all((v > 0) == (i == 2) for i, (_, v) in enumerate(nonfinite)):
        fail(f"phase 5c rewind: kernel 8's non-finite counts {nonfinite}; > 0 at step "
             f"{FT_NAN_AT}'s first run only")
    if len(tables) != 1:
        fail(f"phase 5c rewind: the leaf table was built {len(tables)} times; the restore "
             "must keep the parameters' and moments' addresses")
    if rewind_launches != want:
        fail(f"phase 5c rewind run: launches {rewind_launches}, expected {want}")

    # ---- (c) health numerics: kernel 8's sums against its plain version's
    health_numerics_check(torch, t)
    del t
    free_cuda()

    # the oracle: a clean run that quarantines the same batch from the start
    cfg = config_from_args(cli.build_train_parser().parse_args([*rargs, "--output-dir",
                                                                oracle_dir]))
    oracle = trainer_mod.Trainer(cfg, load_json_records(path))
    oracle.recovery.quarantine(0, FT_NAN_AT - 1, {}, reason="oracle")
    oracle_result = oracle.train()
    del oracle
    free_cuda()
    final = [os.path.join(d, "checkpoints", "6") for d in (rewind_dir, oracle_dir)]
    same = equal_payloads(torch, *final)
    say({"phase": "fault_tolerance_rewind_oracle", "result": oracle_result,
         "final_state_bit_equal": same})
    if oracle_result.get("steps") != 5 or not same:
        fail("phase 5c: the rewind run's final state is not bit-equal to the oracle's")
    checkpoint_costs("5c (b) rewind", events, rewind_dir)
    shutil.rmtree(os.path.join(oracle_dir, "checkpoints"), ignore_errors=True)
    return {k: resume_launches[k] + rewind_launches[k] for k in resume_launches}


def health_numerics_check(torch, t) -> dict:
    """One more step of ``t`` (a trainer with --health on), its health
    numerics from kernel 8's float64 sums, against the same numbers from
    kernel 8's plain version on the same state, gradients and step
    scalars, within HEALTH_RTOL; moving the leaf of the largest norm to
    another bucket must break it."""
    from distributed_llms_example_tpu_torch.ops.fused_optim import STAT_P_SUMSQ, adamw_leaf_plain
    from distributed_llms_example_tpu_torch.train.optim import decay_mask, step_scalars
    from distributed_llms_example_tpu_torch.train.step import (
        HEALTH_BUCKETS,
        HEALTH_METRIC_KEYS,
        health_metrics_from_stats,
        train_step,
    )
    from distributed_llms_example_tpu_torch.train.trainer import put_batch

    opt, spec = t.opt_state, t.spec
    before = [(p.detach().clone(), mu.clone(), nu.clone())
              for (_, p), mu, nu in zip(t.named_params, opt.mu, opt.nu)]
    count = opt.count
    batch = put_batch(next(iter(t.batches.epoch(0))), t.device)
    got = train_step(t.model, t.named_params, opt, spec, t.schedule, batch,
                     generator=t.generator, health_buckets=t.health_buckets)
    scal = step_scalars(spec, t.schedule, count, got["grad_norm"])
    rows = []
    for (name, p), (p0, mu0, nu0) in zip(t.named_params, before):
        rows.append(adamw_leaf_plain(
            p0, mu0, nu0, p.grad, scal, b1=spec.b1, b2=spec.b2, eps=spec.eps,
            max_norm=spec.max_grad_norm,
            wd=spec.weight_decay if decay_mask(name, p) else 0.0)[3].double())
    plain = torch.stack(rows)
    del before

    def rel(a, b):
        return max(abs(float(a[k]) - float(b[k])) / max(abs(float(b[k])), 1e-30)
                   for k in HEALTH_METRIC_KEYS if k != "nonfinite_count")

    want = health_metrics_from_stats(plain, t.health_buckets)
    err = rel(got, want)
    swapped = t.health_buckets.clone()
    leaf = int(torch.argmax(plain[:, STAT_P_SUMSQ]))
    swapped[leaf] = (swapped[leaf] + 1) % len(HEALTH_BUCKETS)
    planted = rel(got, health_metrics_from_stats(plain, swapped))
    out = {"kernel": {k: float(got[k]) for k in HEALTH_METRIC_KEYS},
           "plain": {k: float(want[k]) for k in HEALTH_METRIC_KEYS},
           "max_rel_err": err, "rtol": HEALTH_RTOL,
           "planted_fault": f"{t.named_params[leaf][0]} moved from "
                            f"{HEALTH_BUCKETS[int(t.health_buckets[leaf])]} to "
                            f"{HEALTH_BUCKETS[int(swapped[leaf])]}",
           "planted_max_rel_err": planted}
    say({"phase": "kernel_check", "case": "fused_adamw health sums vs plain (one step of 5c (b))",
         **out})
    if float(got["nonfinite_count"]) != float(want["nonfinite_count"]) or not err <= HEALTH_RTOL:
        fail(f"phase 5c: kernel 8's health numerics {out['kernel']} vs plain {out['plain']}: "
             f"{err} > {HEALTH_RTOL}")
    if not planted > HEALTH_RTOL:
        fail(f"phase 5c: the planted bucket fault moved the health numerics by {planted} only")
    return out


# phase 7's depth (t5-large's widths): at 24 + 24 layers its two runs' saves
# of the whole training state held the run near its time limit, and at 12 +
# 12 and 6 + 6 phase 16's serving runs did
T5_TRAIN_LAYERS = 4


def t5_large_train_model(torch, attn_dropout_rate: float = 0.0):
    """t5-large's widths at T5_TRAIN_LAYERS + T5_TRAIN_LAYERS layers for
    training (bf16 compute, fp32 master weights drawn from seed 0), with
    ``attn_dropout_rate``: the one way to train T5 with probs dropout, as in
    the JAX package (HF's T5 config has no field for it), handed to the
    train entry as a built model."""
    import dataclasses

    from distributed_llms_example_tpu_torch.core.precision import param_dtype
    from distributed_llms_example_tpu_torch.models.registry import T5_CONFIGS, LoadedModel
    from distributed_llms_example_tpu_torch.models.t5 import T5ForConditionalGeneration

    cfg = dataclasses.replace(T5_CONFIGS["t5-large"], num_layers=T5_TRAIN_LAYERS,
                              attn_dropout_rate=attn_dropout_rate)
    dev = torch.device("cuda")
    module = T5ForConditionalGeneration(cfg, dtype=torch.bfloat16,
                                        param_dtype=param_dtype(torch.bfloat16, dev, train=True),
                                        device=dev)
    module.init_weights(torch.Generator(device=dev).manual_seed(0))
    return LoadedModel("t5", cfg, module)


def linked_checkpoint(src: str, name: str, **config) -> str:
    """A checkpoint directory <WORK>/<name> holding ``src``'s config.json
    (an HF checkpoint the train entry saved) with ``config``'s fields set,
    and a model.safetensors that links to ``src``'s (no copy of the
    weights)."""
    dst = os.path.join(WORK, name)
    os.makedirs(dst, exist_ok=True)
    with open(os.path.join(src, "config.json")) as f:
        cfg = json.load(f)
    with open(os.path.join(dst, "config.json"), "w") as f:
        json.dump({**cfg, **config}, f, indent=2, sort_keys=True)
    link = os.path.join(dst, "model.safetensors")
    if os.path.lexists(link):
        os.remove(link)
    os.symlink(os.path.abspath(os.path.join(src, "model.safetensors")), link)
    return dst


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
                   trainer.schedule, batch, generator=trainer.generator,
                   is_seq2seq=trainer.loaded.is_seq2seq)

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
                                  "flash_bwd_dlbias", "fused_dropout", "fused_adamw",
                                  "fused_grad_prep")
                  if tag in low),
                 "gemm" if any(t in low for t in ("gemm", "nvjet", "xmma", "cutlass", "sm90_"))
                 else "elementwise" if "elementwise" in low
                 else "reduce" if "reduce" in low else "other")
        ms, n = groups.get(g, [0.0, 0.0])
        groups[g] = [ms + v, n + counts.get(k, 0.0)]
    say({"phase": "where_the_time_goes", "call": "train_step",
         "model": os.path.basename(trainer.cfg.model_ckpt), "batch_shape": {
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


def global_norm(grads):
    """sqrt of the sum of per-tensor sums of squares, fp32 (optax's
    ``global_norm``): the gradient checks' distance metric."""
    import torch

    return torch.sqrt(sum(torch.sum(g.float() ** 2) for g in grads))


def loss_and_grads(torch, model, batch, *, is_seq2seq=True):
    """One forward+backward with dropout seeds from a fresh generator:
    (loss, normalized gradients) like the train step's."""
    from distributed_llms_example_tpu_torch.ops.fused_dropout import dropout_seeds
    from distributed_llms_example_tpu_torch.train.step import loss_sums

    for p in model.parameters():
        p.grad = None
    with dropout_seeds(torch.Generator().manual_seed(11)):
        lsum, tokens = loss_sums(model, batch, is_seq2seq=is_seq2seq)
        lsum.backward()
    grads = [(p.grad / tokens).detach().clone() for p in model.parameters()]
    for p in model.parameters():
        p.grad = None
    return float((lsum / tokens).detach()), grads


def grad_dist(a, b) -> dict:
    """The gradient checks' distances between two (loss, gradients) pairs,
    ``b`` the reference: the GRAD_LIMITS keys."""
    (la, ga), (lb, gb) = a, b
    per = [float((x - y).abs().max()) for x, y in zip(ga, gb)]
    diff = float(global_norm([x - y for x, y in zip(ga, gb)]))
    return {"loss_diff": abs(la - lb), "grad_norm_diff": abs(float(global_norm(ga)) -
                                                              float(global_norm(gb))),
            "max_tensor_grad_diff": max(per),
            "grad_rel_l2": diff / float(global_norm(gb))}


@contextlib.contextmanager
def probs_dropout_seed_off_by_one(fa):
    """Planted fault: kernels 2-4 redraw the attention-probs dropout mask
    from seed + 1, so the backward masks other entries than the forward."""
    saved = fa._bwd_dq, fa._bwd_dkv, fa._bwd_dlbias

    def shifted(fn):
        def run(*args, drop, **kw):
            return fn(*args, drop=None if drop is None else drop._replace(seed=drop.seed + 1),
                      **kw)
        return run

    fa._bwd_dq, fa._bwd_dkv, fa._bwd_dlbias = map(shifted, saved)
    try:
        yield
    finally:
        fa._bwd_dq, fa._bwd_dkv, fa._bwd_dlbias = saved


def grad_check_phase(torch, fa, fd, trainer):
    """fp32: kernel path vs plain path on one batch, with a planted fault
    that must break the limits; bf16: the kernel path's gradient distance
    from fp32 against the plain path's.  The trainer's model config is
    used as it is: with attention-probs dropout (a checkpoint that sets
    attention_dropout), the fault is the probs-dropout seed off by one in
    the backward, and the bf16 comparison is left out; without it, the
    residual dropout's backward seed off by one."""
    from distributed_llms_example_tpu_torch.train.trainer import put_batch

    batch = put_batch(next(iter(trainer.batches.epoch(0))), trainer.device)
    state = trainer.model.state_dict()
    cfg = trainer.loaded.config
    probs = cfg.attn_dropout_rate
    out = {}
    for dtype in (torch.float32,) if probs else (torch.float32, torch.bfloat16):
        model = type(trainer.model)(cfg, dtype=dtype, param_dtype=torch.float32,
                                    device="cuda").train()
        model.load_state_dict(state)
        out[dtype, "kernel"] = loss_and_grads(torch, model, batch)
        with plain_kernels(fa, fd):
            out[dtype, "plain"] = loss_and_grads(torch, model, batch)
        if dtype == torch.float32:
            fault = probs_dropout_seed_off_by_one(fa) if probs else \
                backward_dropout_seed_off_by_one(fd)
            with fault:
                out[dtype, "fault"] = loss_and_grads(torch, model, batch)
        del model
        torch.cuda.empty_cache()

    f32 = torch.float32
    ref = out[f32, "plain"]
    k32, fault = grad_dist(out[f32, "kernel"], ref), grad_dist(out[f32, "fault"], ref)
    line = {"phase": "grad_check", "attention_dropout": probs, "fp32_kernel_vs_plain": k32,
            "fp32_planted_fault": fault, "planted_fault": (
                "probs-dropout seed off by one in the backward" if probs
                else "residual dropout's backward seed off by one"),
            "limits": GRAD_LIMITS, "loss_fp32": ref[0],
            "grad_norm_fp32": float(global_norm(ref[1]))}
    if not probs:
        line["bf16_kernel_vs_fp32_plain"] = k16 = grad_dist(out[torch.bfloat16, "kernel"], ref)
        line["bf16_plain_vs_fp32_plain"] = p16 = grad_dist(out[torch.bfloat16, "plain"], ref)
    say(line)
    for key, lim in GRAD_LIMITS.items():
        if not k32[key] <= lim:
            fail(f"fp32 gradient check: kernel path vs plain path {key} {k32[key]} > {lim}")
    if not any(fault[key] > lim for key, lim in GRAD_LIMITS.items()):
        fail(f"fp32 gradient check: the planted fault stays within every limit: {fault}")
    if not probs and not k16["grad_rel_l2"] <= 1.5 * p16["grad_rel_l2"]:
        fail(f"bf16 gradient: kernel path {k16['grad_rel_l2']} from fp32 against the plain "
             f"path's {p16['grad_rel_l2']}")


@contextlib.contextmanager
def dlbias_delta_of_another_row(fa):
    """Planted fault: kernel 4 reads each batch row's δ from its
    neighbour (δ rolled by one along the batch)."""
    saved = fa._bwd_dlbias

    def bad(q, k, v, bias, lbias, do, lse, delta, **kw):
        return saved(q, k, v, bias, lbias, do, lse, delta.roll(1, dims=0).contiguous(), **kw)

    fa._bwd_dlbias = bad
    try:
        yield
    finally:
        fa._bwd_dlbias = saved


@contextlib.contextmanager
def plain_backward_kernels(fa):
    """The flash Function's backward with kernels 2, 3 and 4 replaced by
    their plain versions on the same CUDA tensors; the forward (kernel 1)
    untouched, so both paths see bit-identical activations."""
    saved = fa._bwd_dq, fa._bwd_dkv, fa._bwd_dlbias

    def dq(q, k, v, bias, do, lse, delta, *, lbias, causal, scale, drop):
        _, ds = fa._bwd_plain(q, k, v, bias, do, lse, delta, lbias=lbias, causal=causal,
                              scale=scale, drop=drop)
        return fa._dq_plain(q, k, ds)

    def dkv(q, k, v, bias, do, lse, delta, *, lbias, causal, scale, drop):
        p, ds = fa._bwd_plain(q, k, v, bias, do, lse, delta, lbias=lbias, causal=causal,
                              scale=scale, drop=drop)
        return fa._dkv_plain(q, k, v, do, p, ds)

    fa._bwd_dq, fa._bwd_dkv, fa._bwd_dlbias = dq, dkv, fa._dlbias_sum
    try:
        yield
    finally:
        fa._bwd_dq, fa._bwd_dkv, fa._bwd_dlbias = saved


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


def t5_grad_check_phase(torch, fa, fd, fo, batch) -> int:
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

    relu with attention-probs dropout at PROBS_DROPOUT: kernels 2, 3 and 4
    (their dropout instances) against their plain versions inside the model
    within the relu limits, kernel 4's fp32 (CUDA-core) dropout instance
    launched once per self-attention layer, counted from zero (returned:
    4).

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

    def build(mlp: str, attn_dropout: float = 0.0):
        cfg = dataclasses.replace(T5_CONFIGS["t5-large"], num_layers=2, feed_forward_proj=mlp,
                                  attn_dropout_rate=attn_dropout)
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

    # the relu model with attention-probs dropout: kernel 4's dropout branch
    # (and kernels 2-3's) inside the model, against their plain versions
    model, _, _ = build("relu", PROBS_DROPOUT)
    zero_counters(fa, fd, fo)
    dkernel = loss_and_grads(torch, model, batch)
    drop_launched = fa.flash_bwd_dlbias.drop_launches
    with plain_backward_kernels(fa):
        dplain = loss_and_grads(torch, model, batch)
    del model
    free_cuda()
    relu_drop = dist(dkernel, dplain, names, tables)

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
         "fp32_relu_attention_dropout": {"rate": PROBS_DROPOUT,
                                         "kernel4_dropout_launches": drop_launched,
                                         "kernels_2_3_4_vs_plain": relu_drop},
         "limits": dict(GRAD_LIMITS, bucket_table_rel_l2=T5_TABLE_REL_L2,
                        gated_gelu_nudge_factor=T5_NUDGE_FACTOR)})
    if launched != 4 or len(tables) != 2 or len(gtables) != 2:
        fail(f"t5 gradient check: {launched} kernel-4 launches for 4 self-attention layers")
    if not within(relu["kernels_2_3_4_vs_plain"]):
        fail(f"t5 fp32 gradient check (relu): kernels 2-4 vs plain "
             f"{relu['kernels_2_3_4_vs_plain']}")
    if drop_launched != 4 or not within(relu_drop):
        fail(f"t5 fp32 gradient check with attention dropout: {drop_launched} kernel-4 dropout "
             f"launches for 4 self-attention layers, kernels 2-4 vs plain {relu_drop}")
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
    return drop_launched


# 64 new tokens since phase 19 joined the run (128 before)
T5_SERVE_ARGS = [
    "--model-ckpt", "flan-t5-xl", "--max-slots", "8", "--max-new-tokens", "64",
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

    def fwd(q, k, v, bias=None, *, learned_bias=None, causal=False, scale=None, dtype=None,
            **drop):
        return fa.flash_attention_plain(q, k, v, bias, lbias=learned_bias, causal=causal,
                                        scale=scale, **drop)[0].to(dtype or q.dtype)

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
    fa.flash_bwd_dlbias.tc_launches = 0
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
    fa.flash_bwd_dlbias.tc_launches = 0
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


# two waves of the 8 slots: the second is admitted into freed slots, whose
# stale K/V its masks must hide (the paged and the flat run's tokens equal)
LLAMA_SERVE_PROMPTS = 16
# 64 new tokens since phase 19 joined the run (128 before)
LLAMA_ARGS = [
    "--model-ckpt", "llama-2-7b", "--num-prompts", str(LLAMA_SERVE_PROMPTS), "--max-slots", "8",
    "--max-new-tokens", "64",
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
    decode round of each."""
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
        # kernel 1 once a layer per prompt prefill (a flat cache written
        # from slot 0), then kernel 6 (paged) or 5 (flat) every decode round
        want = {"flash_attention_fwd": layers * stats.prefill_calls,
                "flash_decode": 0 if name == "paged" else steps,
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
        if records != LLAMA_SERVE_PROMPTS or stats.decode_steps == 0 or launches != want:
            fail(f"llama-2-7b {name} serve: {records} records, launches {launches} vs {want}")
        if name == "paged" and engine.pool.blocks_in_use != 0:
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
    back by one (``fault``: a row no longer sees its own new K/V; a flat
    row at offset 0 stays at 0)."""
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
        return fa.flash_decode(q, k, v, bias, offsets=(offsets - 1).clamp(min=0), scale=scale,
                               dtype=dtype)

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


# the eval pass (phases 6c-6d): the reference recipe's generate(max_length
# =128, num_beams=2) -> ROUGE through the train entry, and the beam search's
# kernel path against its plain path
EVAL_ARGS = ["--num-beams", "2", "--eval-max-new-tokens", "128", "--eval-batch-size", "8",
             "--evaluation-steps", "0"]
EVAL_RECORDS = 16
BEAM_NEW_TOKENS = 32
BEAM_LOGP_ATOL = 1e-4


def eval_phase(torch, fa, fd, fo, cli) -> dict:
    """The CLI's train entry on bart-large-cnn from phase 5's saved
    checkpoint (the weights linked), 16 records (2 steps of 8), with a
    --val-file of 16 records (sources 200-1024 byte-tokens, targets
    40-128), beam 2, 128 new tokens, eval batch 8, --evaluation-steps 0:
    one eval at the epoch's end.  Counters zeroed just before the eval and
    read just after: kernel 1 once per encoder layer per batch, all on the
    tensor cores and none a dropout instance, kernel 5 once per decoder
    layer per step per batch, kernels 2-4 and 6-8 never.  Then one beam
    decode step profiled.  Returns the eval's launches."""
    from distributed_llms_example_tpu_torch.train import trainer as trainer_mod

    ckpt = linked_checkpoint(os.path.join(WORK, "bart-large-cnn-out", "model"),
                             "bart-large-cnn-eval")
    train_path, val_path = (os.path.join(WORK, f"eval_{x}.json") for x in ("train", "val"))
    write_train_records(train_path, EVAL_RECORDS)
    write_train_records(val_path, EVAL_RECORDS, seed=1, summary=(40, 129))
    windows = []
    real_evaluate = trainer_mod.Trainer.evaluate

    def evaluate(self, *a, **k):
        torch.cuda.synchronize()
        zero_counters(fa, fd, fo)
        t0 = time.perf_counter()
        scores = real_evaluate(self, *a, **k)
        torch.cuda.synchronize()
        windows.append(dict(
            wall_s=time.perf_counter() - t0,
            launches=read_counters(fa, fd, fo) | {
                "flash_decode": fa.flash_decode.launches,
                "flash_decode_paged": fa.flash_decode_paged.launches},
            tc_launches=fa.flash_attention.tc_launches, dropout_launches=drop_counters(fa)))
        return scores

    out_dir = fresh_dir("bart-large-cnn-eval-out")
    trainer_mod.Trainer.evaluate = evaluate
    try:
        with logged_events() as logged:
            t0 = time.perf_counter()
            trainer = cli.train([*TRAIN_ARGS, "--model-ckpt", ckpt, "--train-file", train_path,
                                 "--val-file", val_path, *EVAL_ARGS, "--output-dir", out_dir])
            wall = time.perf_counter() - t0
    finally:
        trainer_mod.Trainer.evaluate = real_evaluate
    events = [e for e in logged if e.get("event") == "eval"]
    cfg, mcfg = trainer.cfg, trainer.loaded.config
    batches = -(-EVAL_RECORDS // cfg.eval_batch_size)
    want = {k: 0 for k in windows[0]["launches"]} if windows else {}
    want["flash_attention_fwd"] = mcfg.encoder_layers * batches
    want["flash_decode"] = mcfg.decoder_layers * cfg.eval_max_new_tokens * batches
    rouge = {k: events[0].get(k) for k in ("rouge1", "rouge2", "rougeL", "rougeLsum")} \
        if events else {}
    w = windows[0] if windows else {}
    positions = EVAL_RECORDS * cfg.eval_max_new_tokens
    say({"phase": "eval", "model": "bart-large-cnn", "checkpoint": ckpt,
         "train_steps": len(trainer.history), "eval_events": events, "evals": len(windows),
         "eval_wall_s": w.get("wall_s"), "run_wall_s": wall,
         "generated_tokens": positions, "beam_rows": EVAL_RECORDS * cfg.num_beams,
         "generated_tokens_per_s": positions / w["wall_s"] if w else None,
         "launches": w.get("launches"), "expected": want,
         "tc_launches": w.get("tc_launches"), "dropout_launches": w.get("dropout_launches")})
    if len(trainer.history) != 2 or len(events) != 1 or len(windows) != 1:
        fail(f"eval run: {len(trainer.history)} train steps, {len(events)} eval events, "
             f"{len(windows)} evals (want 2, 1, 1)")
    if not all(isinstance(v, float) and math.isfinite(v) and 0.0 <= v <= 1.0
               for v in rouge.values()) or len(rouge) != 4 or events[0].get("step") != 2:
        fail(f"eval event {events[0]}: the four ROUGE means must be finite in [0, 1]")
    if w["launches"] != want or w["tc_launches"] != want["flash_attention_fwd"] \
            or any(w["dropout_launches"].values()):
        fail(f"eval launches {w['launches']} (tensor-core {w['tc_launches']}, dropout "
             f"{w['dropout_launches']}), expected {want}, all kernel-1 launches on the "
             "tensor cores and none a dropout instance")
    profile_beam_step(torch, trainer)
    shutil.rmtree(os.path.join(out_dir, "checkpoints"), ignore_errors=True)
    return w["launches"]


def profile_beam_step(torch, trainer) -> None:
    """One beam decode step of the trainer's eval generator on the first
    validation batch (8 rows x 2 beams, 128-slot caches, past a few warm
    steps): the host's time to enqueue it against its time to finish on the
    card, then one under torch.profiler (device busy, the heaviest
    kernels)."""
    from distributed_llms_example_tpu_torch.data.batching import BatchIterator

    cfg, gen = trainer.cfg, trainer.evaluator.generator
    batch = next(iter(BatchIterator(
        trainer.val_ds, global_batch=cfg.eval_batch_size, shuffle=False, drop_last=False,
        bucket_multiple=cfg.pad_to_multiple, max_source_length=cfg.max_source_length,
        max_target_length=cfg.eval_max_new_tokens).epoch(0)))
    ids, mask = (torch.as_tensor(batch[k], device=trainer.device).long()
                 for k in ("input_ids", "attention_mask"))
    trainer.model.eval()
    with torch.no_grad():
        box = [gen.prefill(ids, mask)]

        def step():
            box[0] = gen.decode_step(box[0])

        for _ in range(4):
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
        wall, kernels = profile_device(step, 4, counts)
    trainer.model.train()
    busy = sum(kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:8]
    say({"phase": "where_the_time_goes", "call": "beam_decode_step", "model": "bart-large-cnn",
         "rows": int(ids.shape[0]) * gen.K, "t_after": box[0]["t"], "enqueue_ms": enqueue,
         "step_ms": total, "wall_ms_profiled": wall, "device_busy_ms": busy,
         "device_idle_share": max(0.0, 1 - busy / wall),
         "kernel_launches": sum(counts.values()),
         "top_kernels": [[k[:90], v, counts.get(k, 0.0)] for k, v in top]})


def beam_kernel_time(torch, fa) -> None:
    """Kernel 5 at the eval's beam step (16 rows = 8 x 2 beams, 16 heads,
    a 128-slot cache read whole (the last step), d 64, bf16): against its
    plain version, timed beside SDPA and its bound."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)
    q = torch.randn(16, 16, 1, 64, generator=gen, device=dev).to(torch.bfloat16)
    k, v = (torch.randn(16, 16, 128, 64, generator=gen, device=dev).to(torch.bfloat16)
            for _ in range(2))
    off = torch.full((16,), 127, dtype=torch.int32, device=dev)
    check_close("flash_decode beam step (16, 16, 1, 64) L=128 bf16",
                fa.flash_decode(q, k, v, offsets=off), fa.flash_decode_plain(q, k, v, offsets=off),
                atol=2e-2, rtol=2e-2)
    decode_time(torch, fa, "bart-large-cnn beam 2 eval step", q, k, v, None, off)


def traced_beam_search(torch, gen_cls, model, cfg, ids, mask):
    """A beam-2 search of BEAM_NEW_TOKENS tokens whose every selection is
    recorded: (output ids, the chosen beams' log-probs (steps, B, K), the
    chosen tokens and parents, the smallest gap between consecutive
    candidates among each row's top 2K + 1, those of a -1e7 beam left
    out)."""
    from distributed_llms_example_tpu_torch.evaluation import generation

    rec = []
    real = generation._beam_step_select

    def select(logp, t, state, **kw):
        new, chosen, parents = real(logp, t, state, **kw)
        B, K = state[0].shape
        lp = logp.reshape(B, K, -1)
        rows = torch.arange(B, device=logp.device)[:, None]
        top = (state[0][:, :, None] + lp).reshape(B, -1).topk(2 * K + 1, dim=-1).values
        # gaps between live candidates (those below NEG_INF / 2 tie by design)
        live = (top[:, 1:] > generation.NEG_INF / 2)
        gaps = torch.where(live, top[:, :-1] - top[:, 1:], torch.inf)
        rec.append((lp[rows, parents, chosen], chosen, parents, gaps.min()))
        return new, chosen, parents

    generation._beam_step_select = select
    try:
        out = gen_cls(model, cfg, BEAM_NEW_TOKENS, num_beams=2).run(ids, mask)
    finally:
        generation._beam_step_select = real
    return (out, torch.stack([r[0] for r in rec]), torch.stack([r[1] for r in rec]),
            torch.stack([r[2] for r in rec]), float(torch.stack([r[3] for r in rec]).min()))


def beam_check_phase(torch, fa) -> None:
    """fp32 beam search (2 beams, 32 new tokens, 8 ragged rows of 200-1024
    byte-tokens), kernel path vs plain path on the same random weights: BART
    at bart-large-cnn widths and T5 at t5-large widths (2 + 2 layers; the
    beam-grouped cross-attention, T5's at scale 1, and kernel 5 with T5's
    per-row relative bias), and LLaMA at llama-2-7b widths (2 layers; a
    causal beam search over right-padded prompts).  Tokens, parents and
    outputs equal; the chosen beams' per-step log-probs within
    BEAM_LOGP_ATOL, which the decode offset shifted by one must break."""
    import dataclasses

    import numpy as np

    from distributed_llms_example_tpu_torch.data.tokenizer import ByteTokenizer
    from distributed_llms_example_tpu_torch.evaluation.generation import (
        CausalGenerator,
        Seq2SeqGenerator,
    )
    from distributed_llms_example_tpu_torch.models.bart import BartForConditionalGeneration
    from distributed_llms_example_tpu_torch.models.llama import LlamaForCausalLM
    from distributed_llms_example_tpu_torch.models.registry import (
        BART_CONFIGS,
        LLAMA_CONFIGS,
        T5_CONFIGS,
    )
    from distributed_llms_example_tpu_torch.models.t5 import T5ForConditionalGeneration

    path = os.path.join(WORK, "beam_prompts.json")
    write_prompts(path, 8)
    with open(path) as f:
        texts = json.load(f)
    tok = ByteTokenizer()
    cases = (
        ("bart-large-cnn", BartForConditionalGeneration, Seq2SeqGenerator,
         dataclasses.replace(BART_CONFIGS["bart-large-cnn"], encoder_layers=2, decoder_layers=2)),
        ("t5-large", T5ForConditionalGeneration, Seq2SeqGenerator,
         dataclasses.replace(T5_CONFIGS["t5-large"], num_layers=2)),
        ("llama-2-7b", LlamaForCausalLM, CausalGenerator,
         dataclasses.replace(LLAMA_CONFIGS["llama-2-7b"], num_hidden_layers=2)),
    )
    for name, cls, gen_cls, cfg in cases:
        seq2seq = gen_cls is Seq2SeqGenerator
        encode = tok.encode_source if seq2seq else tok.encode_prompt
        ids = np.zeros((8, 1024), np.int64)
        mask = np.zeros((8, 1024), np.int64)
        for r, t in enumerate(texts):
            row = encode(t, 1024)
            ids[r, : len(row)] = row
            mask[r, : len(row)] = 1
        ids, mask = torch.as_tensor(ids, device="cuda"), torch.as_tensor(mask, device="cuda")
        model = cls(cfg, dtype=torch.float32, param_dtype=torch.float32, device="cuda").eval()
        model.init_weights(torch.Generator(device="cuda").manual_seed(0))
        fa.flash_attention.launches = fa.flash_decode.launches = 0
        kernel = traced_beam_search(torch, gen_cls, model, cfg, ids, mask)
        launched = (fa.flash_attention.launches, fa.flash_decode.launches)
        with plain_kernels(fa):
            plain = traced_beam_search(torch, gen_cls, model, cfg, ids, mask)
        with decode_route(fa, "fault"):
            fault = traced_beam_search(torch, gen_cls, model, cfg, ids, mask)
        del model
        free_cuda()
        same = all(torch.equal(a, b) for a, b in zip(kernel[:1] + kernel[2:4],
                                                      plain[:1] + plain[2:4]))
        err = float((kernel[1] - plain[1]).abs().max())
        fault_err = float((fault[1] - plain[1]).abs().nan_to_num(float("inf")).max())
        layers = 2
        steps = BEAM_NEW_TOKENS if seq2seq else BEAM_NEW_TOKENS - 1
        want = (layers, layers * steps)  # the encoder's or the prompt prefill's kernel 1
        finite = bool(torch.isfinite(kernel[1]).all())
        say({"phase": "beam_kernel_vs_plain", "model": name, "layers": "2+2" if seq2seq else 2,
             "beams": 2, "new_tokens": BEAM_NEW_TOKENS, "rows": 8,
             "tokens_equal": same, "finite": finite, "chosen_logp_max_abs_err": err,
             "atol": BEAM_LOGP_ATOL, "planted_fault_err": fault_err,
             "smallest_top_2k_margin": kernel[4], "plain_smallest_top_2k_margin": plain[4],
             "kernel_launches": {"flash_attention_fwd": launched[0], "flash_decode": launched[1]},
             "expected": {"flash_attention_fwd": want[0], "flash_decode": want[1]}})
        if not same or not finite or launched != want:
            fail(f"{name} beam search: tokens equal {same}, finite {finite}, launches "
                 f"{launched} (want {want})")
        if err > BEAM_LOGP_ATOL:
            fail(f"{name} beam search: chosen log-probs differ by {err} between the paths")
        if not fault_err > BEAM_LOGP_ATOL:
            fail(f"{name} beam search: the decode offset shifted by one moves the chosen "
                 f"log-probs only {fault_err}")


# phase 13: causal-LM fine-tuning of llama-2-7b at full width, 2 of its 32
# layers (its fp32 weights, gradients and AdamW moments take ~108 GB whole,
# more than the card holds), from a local HF directory of seed-0 weights
LLAMA_TRAIN_LAYERS = 2
# llama-2-7b's published config.json (meta-llama/Llama-2-7b-hf), depth cut,
# no attention dropout
LLAMA_HF_CONFIG = {
    "architectures": ["LlamaForCausalLM"], "model_type": "llama", "bos_token_id": 1,
    "eos_token_id": 2, "hidden_act": "silu", "hidden_size": 4096, "initializer_range": 0.02,
    "intermediate_size": 11008, "max_position_embeddings": 4096, "num_attention_heads": 32,
    "num_hidden_layers": LLAMA_TRAIN_LAYERS, "num_key_value_heads": 32, "pretraining_tp": 1,
    "rms_norm_eps": 1e-05, "rope_scaling": None, "rope_theta": 10000.0,
    "tie_word_embeddings": False, "torch_dtype": "float16", "use_cache": True,
    "vocab_size": 32000, "attention_dropout": 0.0, "attention_bias": False,
}
LLAMA_TRAIN_ARGS = [
    "--tokenizer", "byte", "--remat", "--fused-ce", "--batch-size", "8", "--num-epochs", "1",
    "--max-source-length", "1024", "--max-target-length", "128", "--compute-dtype", "bfloat16",
    "--learning-rate", "1e-4", "--warmup-steps", "0", "--seed", "0", "--log-every-steps", "1",
    "--evaluation-steps", "0", "--num-beams", "2", "--eval-max-new-tokens", "128",
    "--eval-batch-size", "8",
]
LLAMA_TRAIN_RECORDS = 48
LLAMA_VAL_RECORDS = 16
# phase 13's telemetry: the startup gauges and a torch.profiler window of
# steps 4-5 (steady state: step 1 loads the kernels), parsed into the
# device account (obs/devprof.py)
LLAMA_PROFILE_WINDOW = (4, 5)
LLAMA_OBS_ARGS = ["--obs-gauges", "on", "--profile-steps", "%d:%d" % LLAMA_PROFILE_WINDOW]
# each kernel of the path by the tag its kernel events' names carry, and
# the launch counter it is held to
KERNEL_TAGS = {"flash_fwd": "flash_attention_fwd", "flash_bwd_dq": "flash_attention_bwd_dq",
               "flash_bwd_dkv": "flash_attention_bwd_dkv", "fused_adamw": "fused_adamw",
               "fused_grad_prep": "fused_grad_prep"}
# the device-account bucket each of those kernels must land in
KERNEL_BUCKETS = {"flash_fwd": "attn", "flash_bwd_dq": "attn", "flash_bwd_dkv": "attn",
                  "fused_adamw": "optimizer", "fused_grad_prep": "optimizer"}
# the CE check (fused against unfused, fp32): the loss, relative
LLAMA_CE_LOSS_RTOL = 1e-5


def write_instruction_records(path: str, n: int, *, seed: int) -> None:
    """``n`` synthetic instruction records: prompts of 200-900 bytes,
    targets of 64-128 (byte tokens)."""
    import numpy as np

    rng = np.random.RandomState(seed)
    alphabet = np.array(list("abcdefghijklmnopqrstuvwxyz      .,"))
    recs = [{"dialogue": "".join(rng.choice(alphabet, rng.randint(200, 901))),
             "summary": "".join(rng.choice(alphabet, rng.randint(64, 129)))} for _ in range(n)]
    with open(path, "w") as f:
        json.dump(recs, f)


def llama_hf_dir(torch, layers: int = LLAMA_TRAIN_LAYERS) -> str:
    """<WORK>/llama-2-7b-<layers>l-hf: llama-2-7b's published config.json
    fields at ``layers`` layers, and seed-0 random fp32 weights written by
    the port's HF export (nothing is fetched)."""
    import dataclasses

    from distributed_llms_example_tpu_torch.models.export import save_hf_checkpoint
    from distributed_llms_example_tpu_torch.models.llama import LlamaForCausalLM
    from distributed_llms_example_tpu_torch.models.registry import LLAMA_CONFIGS

    path = fresh_dir(f"llama-2-7b-{layers}l-hf")
    cfg = dataclasses.replace(LLAMA_CONFIGS["llama-2-7b"], num_hidden_layers=layers)
    model = LlamaForCausalLM(cfg, dtype=torch.float32, param_dtype=torch.float32, device="cuda")
    model.init_weights(torch.Generator(device="cuda").manual_seed(0))
    t0 = time.perf_counter()
    save_hf_checkpoint(path, "llama", cfg, model.state_dict())
    with open(os.path.join(path, "config.json")) as f:
        written = json.load(f)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump({**written, **LLAMA_HF_CONFIG, "num_hidden_layers": layers}, f, indent=2,
                  sort_keys=True)
    say({"phase": "llama_train_checkpoint", "dir": path, "layers": layers,
         "parameters": sum(p.numel() for p in model.parameters()),
         "leaves": len(list(model.parameters())), "write_s": time.perf_counter() - t0,
         "bytes": tree_bytes(path)})
    del model
    free_cuda()
    return path


def llama_train_phase(torch, fa, fd, fo, cli) -> dict:
    """The CLI's train entry on llama-2-7b's full width at LLAMA_TRAIN_LAYERS
    layers from a local HF directory, --remat --fused-ce, bf16 compute and
    fp32 master weights, 48 records (6 steps), one eval at the epoch's end
    over a --val-file of 16 (beam 2, 128 new tokens).  Launches of the
    steps exact (kernel 1 twice a layer a step: the forward and remat's
    recompute; kernels 2-3 once; kernel 8 one AdamW and one gradient-pass
    launch), the eval's in their own window (kernel 1 once a layer a batch:
    the prompt prefill; kernel 5 once a layer a beam step), finite losses,
    the export reloaded bit-equal, tokens/s, the peak memory; one profiled
    step; kernel 8 over the 21-leaf table; then the in-process checks at 2
    layers and the attention kernels timed at the recipe's shape.  Returns
    the launches of the train and eval windows together."""
    from distributed_llms_example_tpu_torch.models.registry import load_model
    from distributed_llms_example_tpu_torch.train import trainer as trainer_mod
    from distributed_llms_example_tpu_torch.train.trainer import batch_tokens, put_batch

    ckpt = llama_hf_dir(torch)
    train_path, val_path = (os.path.join(WORK, f"llama_{x}.json") for x in ("train", "val"))
    write_instruction_records(train_path, LLAMA_TRAIN_RECORDS, seed=0)
    write_instruction_records(val_path, LLAMA_VAL_RECORDS, seed=1)
    out_dir = fresh_dir("llama-2-7b-train-out")
    windows = []
    real_evaluate = trainer_mod.Trainer.evaluate

    def evaluate(self, *a, **k):
        torch.cuda.synchronize()
        before = read_counters(fa, fd, fo) | {"flash_decode": fa.flash_decode.launches,
                                              "flash_decode_paged": fa.flash_decode_paged.launches}
        tc0 = fa.flash_attention.tc_launches
        t0 = time.perf_counter()
        scores = real_evaluate(self, *a, **k)
        torch.cuda.synchronize()
        after = read_counters(fa, fd, fo) | {"flash_decode": fa.flash_decode.launches,
                                             "flash_decode_paged": fa.flash_decode_paged.launches}
        windows.append(dict(wall_s=time.perf_counter() - t0,
                            launches={k: after[k] - before[k] for k in after},
                            tc_launches=fa.flash_attention.tc_launches - tc0))
        return scores

    from distributed_llms_example_tpu_torch.obs import memprof

    # each memory_window's peak beside the allocator's peak read at once
    mem_pairs = []
    real_sample = memprof.MemoryMonitor.sample

    def sample(self, step, **kw):
        rec = real_sample(self, step, **kw)
        if rec is not None:
            mem_pairs.append((step, rec["peak_bytes_in_use"], torch.cuda.max_memory_allocated()))
        return rec

    zero_counters(fa, fd, fo)
    fa.flash_decode.launches = fa.flash_decode_paged.launches = 0
    torch.cuda.reset_peak_memory_stats()
    trainer_mod.Trainer.evaluate = evaluate
    memprof.MemoryMonitor.sample = sample
    try:
        with logged_events() as events:
            t0 = time.perf_counter()
            trainer = cli.train([*LLAMA_TRAIN_ARGS, "--model-ckpt", ckpt, "--train-file",
                                 train_path, "--val-file", val_path, "--output-dir", out_dir,
                                 *BUDGET_ARGS, *LLAMA_OBS_ARGS])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        trainer_mod.Trainer.evaluate = real_evaluate
        memprof.MemoryMonitor.sample = real_sample
    budget_account("llama-2-7b", out_dir)
    peak = torch.cuda.max_memory_allocated()
    total = read_counters(fa, fd, fo) | {"flash_decode": fa.flash_decode.launches,
                                         "flash_decode_paged": fa.flash_decode_paged.launches}
    ev = windows[0] if windows else {"launches": {k: 0 for k in total}, "tc_launches": 0}
    train_launches = {k: total[k] - ev["launches"][k] for k in total}
    model, cfg = trainer.model, trainer.loaded.config
    steps = len(trainer.history)
    layers = cfg.num_hidden_layers
    want = expected_train_launches(model, steps) | {"flash_decode": 0, "flash_decode_paged": 0}
    want["flash_attention_fwd"] *= 2  # the forward, and remat's recompute in the backward
    batches = -(-LLAMA_VAL_RECORDS // trainer.cfg.eval_batch_size)
    beam_steps = trainer.cfg.eval_max_new_tokens - 1  # the prefill picks token 0
    want_eval = {k: 0 for k in total} | {"flash_attention_fwd": layers * batches,
                                         "flash_decode": layers * beam_steps * batches}
    eval_events = [e for e in events if e.get("event") == "eval"]
    rouge = {k: eval_events[0].get(k) for k in ("rouge1", "rouge2", "rougeL", "rougeLsum")} \
        if eval_events else {}
    losses = [float(m["loss"]) for m in trainer.history]
    step_s = [b - a for a, b in zip(trainer.step_ends, trainer.step_ends[1:])]
    plan = list(trainer.batches.epoch(0))
    tokens = [batch_tokens(b, is_seq2seq=False) for b in plan]
    widths = [int(b["input_ids"].shape[1]) for b in plan]
    flops = [llama_model_flops(cfg, int(b["input_ids"].shape[0]), w) for b, w in zip(plan, widths)]
    # the timed steps: after the first (kernel loading), outside the
    # profiled window and the step after it (which carries the capture's
    # stop, export and parse); step_s[i] is step i + 2's
    lo, hi = LLAMA_PROFILE_WINDOW
    timed = [i + 2 for i in range(len(step_s)) if not lo <= i + 2 <= hi + 1]
    med = statistics.median(step_s[s - 2] for s in timed) if timed else float("nan")
    mean_tokens = statistics.mean(tokens[s - 1] for s in timed) if timed else float("nan")
    mean_flops = statistics.mean(flops[s - 1] for s in timed) if timed else float("nan")
    own_mfu = mean_flops / med / PEAK_FLOPS
    say({"phase": "llama_train", "model": "llama-2-7b", "layers": layers, "checkpoint": ckpt,
         "wall_s": wall, "steps": steps, "losses": losses,
         "grad_norms": [float(m["grad_norm"]) for m in trainer.history],
         "step_s_after_first": step_s, "timed_steps": timed, "step_s_median": med,
         "tokens_per_step": tokens, "batch_widths": widths,
         "tokens_per_sec": mean_tokens / med, "model_flops_per_step": flops,
         "mfu": own_mfu,
         "peak_mem_bytes": peak, "remat": model.remat_policy, "fused_ce": cfg.fused_ce,
         "launches": train_launches, "expected": want,
         "tc_launches": fa.flash_attention.tc_launches - ev["tc_launches"],
         "dropout_launches": drop_counters(fa)})
    say({"phase": "llama_eval", "eval_events": eval_events, "evals": len(windows),
         "eval_wall_s": ev.get("wall_s"), "launches": ev["launches"], "expected": want_eval,
         "tc_launches": ev["tc_launches"]})
    if steps != 6 or not all(math.isfinite(x) for x in losses):
        fail(f"llama train: {steps} steps, losses {losses}")
    if train_launches != want or fa.flash_attention.tc_launches - ev["tc_launches"] != \
            want["flash_attention_fwd"] or any(drop_counters(fa).values()):
        fail(f"llama train launches {train_launches}, expected {want}, every kernel-1 launch "
             "on the tensor cores and none a dropout instance")
    if len(eval_events) != 1 or len(windows) != 1 or ev["launches"] != want_eval \
            or ev["tc_launches"] != want_eval["flash_attention_fwd"]:
        fail(f"llama eval: {len(eval_events)} events, {len(windows)} evals, launches "
             f"{ev['launches']} vs {want_eval}")
    if len(rouge) != 4 or not all(isinstance(v, float) and math.isfinite(v) and 0 <= v <= 1
                                  for v in rouge.values()):
        fail(f"llama eval event {eval_events}: the four ROUGE means must be finite in [0, 1]")
    if len(timed) < 2:
        fail(f"llama train: {len(timed)} steps timed outside the profiled window")
    llama_obs_checks(torch, trainer, out_dir, per_step={k: v // steps for k, v in want.items()},
                     mem_pairs=mem_pairs, own_mfu=own_mfu)
    saved = os.path.join(out_dir, "model")
    t1 = time.perf_counter()
    back = load_model(saved, dtype=model.dtype, device="cuda", train=True).module
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t1
    trained = dict(model.named_parameters())
    equal = [torch.equal(p, trained[n]) for n, p in back.named_parameters()]
    say({"phase": "train_export", "model": "llama-2-7b", "dir": saved,
         "files": sorted(os.listdir(saved)), "bytes": tree_bytes(saved), "reload_s": load_s,
         "parameters": len(equal), "bit_equal": sum(equal)})
    if len(equal) != len(trained) or not all(equal):
        fail("llama train: the saved checkpoint does not reload to the trained weights")
    del back
    free_cuda()
    checkpoint_costs("llama-2-7b", events, out_dir)
    profile_train_step(torch, trainer)
    llama_adamw_phase(torch, fo, trainer)
    batch = put_batch(plan[0], trainer.device)
    small = {k: v.detach().clone() for k, v in model.state_dict().items()
             if not k.startswith("blocks.") or int(k.split(".")[1]) < 2}
    del trainer, model, trained
    free_cuda()
    shutil.rmtree(out_dir, ignore_errors=True)
    shutil.rmtree(ckpt, ignore_errors=True)
    llama_grad_checks(torch, fa, fd, batch, small, cfg)
    del batch, small
    free_cuda()
    return {k: train_launches[k] + ev["launches"][k] for k in total}


def llama_model_flops(cfg, rows: int, width: int) -> int:
    """Model FLOPs of one LLaMA train step of ``rows`` x ``width`` tokens,
    padding included, counted by hand as obs/gauges.py's FlopCounterMode
    count defines them: every matmul of the forward (q, k, v, o, gate, up,
    down, the head; the two attention products over the whole S x S
    square) and its backward (twice each), no recompute."""
    h, i, L = cfg.hidden_size, cfg.intermediate_size, cfg.num_hidden_layers
    kv = cfg.head_dim * (cfg.num_key_value_heads or cfg.num_attention_heads)
    tokens = rows * width
    forward = (2 * tokens * (L * (2 * h * h + 2 * h * kv + 3 * h * i) + h * cfg.vocab_size)
               + L * 4 * rows * width * width * h)
    return 3 * forward


def llama_state_bytes(cfg) -> tuple[int, int]:
    """(params, optimizer state) bytes of a LLaMA trained on one card, from
    its config alone: fp32 masters of every parameter (embeddings, the
    head, each layer's seven matrices and two norms, the final norm), and
    AdamW's two fp32 moments plus kernel 8's float64 (leaves, STATS) table."""
    from distributed_llms_example_tpu_torch.ops.fused_optim import STATS

    h, i, L, V = cfg.hidden_size, cfg.intermediate_size, cfg.num_hidden_layers, cfg.vocab_size
    kv = cfg.head_dim * (cfg.num_key_value_heads or cfg.num_attention_heads)
    n = 2 * V * h + L * (2 * h * h + 2 * h * kv + 3 * h * i + 2 * h) + h
    leaves = 3 + 9 * L
    return 4 * n, 8 * n + leaves * STATS * 8


def llama_obs_checks(torch, trainer, out_dir: str, *, per_step: dict, mem_pairs: list,
                     own_mfu: float) -> None:
    """Phase 13's telemetry, read from the CLI run's JSONL and its capture:
    one capture of LLAMA_PROFILE_WINDOW and one device_account; every kernel
    event of kernels 1-3 in attn and of kernel 8's two entries in
    optimizer, as many as the launch counters give those steps; the
    bucket sum equal to the event sum and the busy union within the span;
    each memory_window's peak equal to torch.cuda.max_memory_allocated read
    beside it; the memory account's params + optimizer_state equal to the
    bytes this script reckons from the config; the gauge FLOPs equal to
    this script's hand count at the cap shape, the window MFU beside this
    script's own MFU (one definition: model FLOPs); optimizer_apply_ms beside kernel 8's profiler time;
    and obs.report's --trace export loading with host and device lanes."""
    import contextlib as ctx
    import io

    from distributed_llms_example_tpu_torch.obs import devprof, report
    from distributed_llms_example_tpu_torch.obs.budget import sync_device
    from distributed_llms_example_tpu_torch.obs.trace import TID_DEVICE, TID_SPANS

    events = obs_events(out_dir)

    def named(kind):
        return [e for e in events if e.get("event") == kind]

    captures, accounts = named("profile_captured"), named("device_account")
    if [c["window"] for c in captures] != [list(LLAMA_PROFILE_WINDOW)] or len(accounts) != 1:
        fail(f"llama telemetry: captures {captures}, {len(accounts)} device accounts "
             f"({named('device_account_skipped')})")
    acct = accounts[0]
    window_steps = LLAMA_PROFILE_WINDOW[1] - LLAMA_PROFILE_WINDOW[0] + 1
    files = devprof.find_trace_files(captures[0]["path"])
    raw = [e for f in files for e in devprof.load_trace_events(f)]
    ops = devprof.device_op_events(raw)
    trace_bytes = sum(os.path.getsize(f) for f in files)
    # where the host waits inside its enqueue: the CUDA runtime calls by
    # their summed time (a diagnostic, no limit)
    runtime: dict[str, list[float]] = {}
    waits, syncs = [], []
    for e in raw:
        if e.get("ph") == "X" and e.get("cat") in ("cuda_runtime", "cuda_driver"):
            slot = runtime.setdefault(e["name"], [0, 0.0, 0.0])
            slot[0] += 1
            slot[1] += float(e.get("dur", 0.0)) / 1e3
            slot[2] = max(slot[2], float(e.get("dur", 0.0)) / 1e3)
            if "Synchronize" in e["name"]:
                syncs.append(e)
                if float(e.get("dur", 0.0)) > 1000.0:
                    waits.append(e)
    def around(w) -> list[str]:
        """The ops (and scopes) open around a runtime call on its thread,
        outermost first."""
        t0, t1 = float(w["ts"]), float(w["ts"]) + float(w["dur"])
        return [e["name"][:60] for e in sorted(
            (e for e in raw if e.get("ph") == "X" and e.get("cat") in ("cpu_op", "user_annotation")
             and (e.get("pid"), e.get("tid")) == (w.get("pid"), w.get("tid"))
             and float(e["ts"]) <= t0 and float(e["ts"]) + float(e["dur"]) >= t1),
            key=lambda e: float(e["ts"]))]

    # each wait over 1 ms and the ops open around it; and every device sync
    # of any length inside the optimizer tail, which must wait for nothing
    # (a host value enters the step's scalars through a fill, not a copy)
    blocking = [[w["name"], round(float(w["dur"]) / 1e3, 3), around(w)[-8:]] for w in waits]
    tail_syncs = [[w["name"], round(float(w["dur"]) / 1e3, 3), around(w)[-8:]] for w in syncs
                  if "dllm/optimizer_apply_block" in around(w)]
    del raw
    by_kernel: dict[str, dict[str, int]] = {t: {} for t in KERNEL_TAGS}
    unscoped: dict[str, int] = {}
    kernel8_ms = 0.0
    # each bucket's device ms by kind of kernel (a diagnostic, no limit)
    classes: dict[str, dict[str, float]] = {}
    for e in ops:
        bucket = devprof.classify_event(e["name"], e["hlo_op"], scope=e["scope"],
                                        kind=e["kind"])
        low = e["name"].lower()
        tag = next((t for t in KERNEL_TAGS if t in low), None)
        kind = tag or ("gemm" if any(t in low for t in ("gemm", "nvjet", "xmma", "cutlass",
                                                          "sm90_"))
                       else "elementwise" if "elementwise" in low
                       else "reduce" if "reduce" in low else e["kind"])
        row = classes.setdefault(bucket, {})
        row[kind] = round(row.get(kind, 0.0) + e["dur"] / 1e3, 3)
        if tag is not None:
            by_kernel[tag][bucket] = by_kernel[tag].get(bucket, 0) + 1
            if tag in ("fused_adamw", "fused_grad_prep"):
                kernel8_ms += e["dur"] / 1e3
        if not e["scope"] and e["kind"] == "kernel" and bucket == "other":
            unscoped[e["name"][:60]] = unscoped.get(e["name"][:60], 0) + 1
    event_ms = sum(e["dur"] for e in ops) / 1e3
    bucket_ms = sum(acct["buckets_ms"].values())
    say({"phase": "llama_device_account", "window": acct["window"], "events": acct["events"],
         "trace_files": len(files), "trace_bytes": trace_bytes,
         "span_ms": acct["span_ms"], "busy_ms": acct["busy_ms"],
         "exposed_idle_ms": acct["exposed_idle_ms"], "buckets_ms": acct["buckets_ms"],
         "bucket_frac": acct["bucket_frac"], "collectives": acct["collectives"],
         "overlap": acct["overlap"], "event_ms": event_ms, "bucket_sum_ms": bucket_ms,
         "kernels_by_bucket": by_kernel, "bucket_ms_by_kind": classes,
         "unscoped_other_kernels": dict(sorted(unscoped.items(), key=lambda kv: -kv[1])[:12]),
         "host_runtime_calls_count_ms_max": dict(sorted(runtime.items(),
                                                        key=lambda kv: -kv[1][1])[:6]),
         "host_waits_ms_inside": blocking, "optimizer_tail_syncs": tail_syncs})
    if tail_syncs:
        fail(f"llama device account: the optimizer tail waits on the card: {tail_syncs}")
    for tag, counter in KERNEL_TAGS.items():
        want = per_step[counter] * window_steps
        got = by_kernel[tag]
        if got != {KERNEL_BUCKETS[tag]: want}:
            fail(f"llama device account: {tag} kernel events by bucket {got}, expected "
                 f"{want} in {KERNEL_BUCKETS[tag]} (2 steps of the launch counters)")
    if acct["events"] != len(ops) or abs(bucket_ms - event_ms) > 0.001 * len(acct["buckets_ms"]) \
            or acct["busy_ms"] > acct["span_ms"] + 0.001:
        fail(f"llama device account: {acct['events']} events vs {len(ops)}, bucket sum "
             f"{bucket_ms} ms vs event sum {event_ms}, busy {acct['busy_ms']} vs span "
             f"{acct['span_ms']}")
    # the memory account and the watermark
    (mem,) = named("memory_account")
    state, opt_bytes = llama_state_bytes(trainer.loaded.config)
    windows = named("memory_window")
    say({"phase": "llama_memory_account", "buckets_bytes": mem["buckets_bytes"],
         "peak_bytes": mem["peak_bytes"], "measured": mem["measured"],
         "fits_budget": mem["fits_budget"],
         "hbm_headroom_gib": mem["hbm_headroom_gib"], "state_params_bytes": state,
         "state_optimizer_bytes": opt_bytes, "windows": len(windows),
         "window_peaks_vs_allocator": mem_pairs[:8]})
    # the peak was reset before the run: its first step sets the run's peak
    if mem["buckets_bytes"]["params"] != state or mem["buckets_bytes"]["optimizer_state"] \
            != opt_bytes or not (mem["measured"] or {}).get("step_set_peak"):
        fail(f"llama memory account {mem['buckets_bytes']} vs params {state} B, optimizer "
             f"state {opt_bytes} B (measured {mem['measured']})")
    if not mem_pairs or any(a != b for _, a, b in mem_pairs) or len(windows) != len(mem_pairs):
        fail(f"llama memory_window peaks vs torch.cuda.max_memory_allocated: {mem_pairs}")
    # the gauges: FLOPs a step and the window MFU; the optimizer sample
    (gauges,) = named("obs_gauges")
    cap = llama_model_flops(trainer.loaded.config, trainer.cfg.batch_size,
                            trainer.cfg.max_source_length)
    mfus = [w["mfu"] for w in named("obs_window") if "mfu" in w]
    budgets = [b for b in named("step_budget") if "optimizer_apply_ms" in b]
    say({"phase": "llama_gauges", "flops_per_step": gauges["flops_per_step"],
         "flops_source": gauges["flops_source"], "flops_counted": gauges["flops_counted"],
         "hand_count_flops_at_cap": cap, "tokens_per_step": gauges["tokens_per_step"],
         "params": gauges["params"], "comm_total_bytes": gauges["comm"]["total_bytes"],
         "window_mfu": mfus, "chip_smoke_mfu": own_mfu,
         "optimizer_apply_ms": [b["optimizer_apply_ms"] for b in budgets],
         "optimizer_share_of_step": [b["optimizer_share_of_step"] for b in budgets],
         "kernel8_profiler_ms_per_step": kernel8_ms / window_steps,
         "syncs": {"budget": sync_device.syncs, "profile": sync_device.profile_syncs}})
    if gauges["flops_source"] != "flop_counter" or gauges["flops_per_step"] != cap \
            or not mfus or not all(math.isfinite(m) and 0 < m < 1 for m in mfus) or not budgets:
        fail(f"llama gauges: {gauges['flops_source']} {gauges['flops_per_step']} FLOPs vs the "
             f"hand count {cap}, window MFU {mfus}, {len(budgets)} windows with "
             "optimizer_apply_ms")
    # the merged Perfetto export: host spans and device lanes
    path = os.path.join(out_dir, "trace.json")
    with ctx.redirect_stdout(io.StringIO()), ctx.redirect_stderr(io.StringIO()):
        rc = report.main([out_dir, "--trace", path])
    with open(path) as f:
        trace = json.load(f)["traceEvents"]
    host = sum(1 for e in trace if e.get("ph") == "X" and e.get("tid") == TID_SPANS)
    lanes = sum(1 for e in trace if e.get("ph") == "X" and e.get("tid") == TID_DEVICE)
    say({"phase": "llama_trace_export", "rc": rc, "events": len(trace), "host_spans": host,
         "device_slices": lanes, "bytes": os.path.getsize(path)})
    if rc != 0 or not host or not lanes:
        fail(f"llama trace export: rc {rc}, {host} host spans, {lanes} device slices")


def llama_adamw_phase(torch, fo, trainer) -> None:
    """Kernel 8 over the trained model's 21-leaf table (0.67 B elements, the
    last step's gradients, tokens 1): one tail against the plain version's
    on copies of the same state (each of p, mu, nu within ADAMW_RTOL, the
    norm within one fp32 ulp), then timed beside the plain tail and
    clip_grad_norm_(foreach=True) + AdamW(fused=True)."""
    from distributed_llms_example_tpu_torch.train import optim as toptim

    named = trainer.named_params
    state, spec = trainer.opt_state, trainer.spec
    params = [p for _, p in named]
    grads = [p.grad for p in params]
    dev = params[0].device
    ones = torch.ones((), device=dev)
    copies = [[t.detach().clone() for t in ts] for ts in (params, state.mu, state.nu, grads)]
    count = state.count
    with torch.no_grad():
        gnorm = toptim.fused_optimizer_apply(spec, trainer.schedule, named, state, grads, ones)
        cp, cmu, cnu, cg = copies
        gplain = fo.grad_prep_plain(cg, ones)
        scal = toptim.step_scalars(spec, trainer.schedule, count, gplain)
        worst = 0.0
        for i, (n, p) in enumerate(named):
            wp, wmu, wnu, _ = fo.adamw_leaf_plain(
                cp[i], cmu[i], cnu[i], cg[i], scal, b1=spec.b1, b2=spec.b2, eps=spec.eps,
                max_norm=spec.max_grad_norm,
                wd=spec.weight_decay if toptim.decay_mask(n, p) else 0.0)
            for got, w in ((p, wp), (state.mu[i], wmu), (state.nu[i], wnu)):
                ok, err = close_enough(got, w, atol=0.0, rtol=ADAMW_RTOL)
                if not ok:
                    fail(f"fused_adamw llama table {n}: kernel differs from plain ({err})")
                worst = max(worst, err)
            del wp, wmu, wnu
    ulp = float(torch.finfo(torch.float32).eps * gplain.abs())
    norm_err = float((gnorm - gplain).abs())
    say({"phase": "kernel_check", "case": "fused_grad_prep + fused_adamw llama-2-7b "
         f"{LLAMA_TRAIN_LAYERS}-layer table vs plain", "leaves": len(params), "elements": sum(p.numel() for p in params),
         "max_abs_err": worst, "rtol": ADAMW_RTOL, "gnorm_abs_err": norm_err, "fp32_ulp": ulp})
    if not norm_err <= ulp:
        fail(f"fused_grad_prep llama table: norm {float(gnorm)} vs plain {float(gplain)}")
    del copies, cp, cmu, cnu, cg
    free_cuda()
    n = sum(p.numel() for p in params)

    def run():
        toptim.fused_optimizer_apply(spec, trainer.schedule, named, state, grads, ones)

    def plain():
        g = fo.grad_prep_plain(grads, ones)
        scal = toptim.step_scalars(spec, trainer.schedule, state.count, g)
        for i, (name, p) in enumerate(named):
            fo.adamw_leaf_plain(p, state.mu[i], state.nu[i], grads[i], scal, b1=spec.b1,
                                b2=spec.b2, eps=spec.eps, max_norm=spec.max_grad_norm,
                                wd=spec.weight_decay if toptim.decay_mask(name, p) else 0.0)

    with torch.no_grad():
        # a profiler session may drop events: take the first of up to three
        # that saw both kernels once a tail
        for _ in range(3):
            counts: dict[str, float] = {}
            _, kernels = profile_device(run, 3, counts)
            ours = {k: v for k, v in kernels.items() if "fused_" in k}
            if len(ours) == 2 and all(counts[k] == 1.0 for k in ours):
                break
        r = dict(ms=time_ms(run, per_rep=2, reps=5), device_ms=sum(ours.values()),
                 plain_ms=time_ms(plain, per_rep=1, reps=3))
    lib = torch.optim.AdamW(params, lr=1e-4, weight_decay=0.01, fused=True)

    def lib_step():
        torch.nn.utils.clip_grad_norm_(params, 1.0, foreach=True)
        lib.step()

    b_ms, b_by = bound(0.0, 36.0 * n)
    say({"phase": "kernel_time", "kernel": "fused_grad_prep + fused_adamw",
         "call": f"train step tail, llama-2-7b {LLAMA_TRAIN_LAYERS} layers", "leaves": len(params), "elements": n,
         **r, "host_ms": host_us(run, 10) / 1e3, "device_ms_by_kernel": ours,
         "launches_per_tail": sum(counts.values()), "bound_ms": b_ms, "bound_by": b_by,
         "library": "clip_grad_norm_(foreach=True) + AdamW(fused=True)",
         "library_ms": time_ms(lib_step, per_rep=1, reps=5)})
    del lib
    free_cuda()


def llama_small(torch, state, cfg, *, dtype, dropout: float, fused_ce: bool):
    """llama-2-7b's widths at 2 layers holding ``state`` (the trained
    model's first two layers, embedding, final norm and head), in training
    mode: residual and attention-probs dropout at ``dropout``."""
    import dataclasses

    from distributed_llms_example_tpu_torch.models.llama import LlamaForCausalLM

    cfg = dataclasses.replace(cfg, num_hidden_layers=2, dropout_rate=dropout,
                              attn_dropout_rate=dropout, fused_ce=fused_ce)
    model = LlamaForCausalLM(cfg, dtype=dtype, param_dtype=torch.float32, device="cuda")
    model.load_state_dict(state)
    return model.train()


def llama_grad_checks(torch, fa, fd, batch, state, cfg) -> None:
    """At llama-2-7b's widths, 2 layers, one batch of the recipe:
    the trained model's first two layers.
    (a) fp32 with residual and attention-probs dropout 0.1 (kernels 1-3's
    dropout instances at d = 128, kernel 7): the kernel path against the
    plain path within GRAD_LIMITS, which kernels 2-3 drawing the probs
    mask from seed + 1 must break; (b) bf16 with dropout, the recipe's
    fused CE: --remat off, full and dots give a bit-equal loss and every
    gradient bit-equal, with each one's peak memory; (c) fp32 without
    dropout: the fused CE against the unfused within LLAMA_CE_LOSS_RTOL
    (loss) and GRAD_LIMITS (gradients); each one's peak memory, in bf16
    too; (d) the CLI run's instances, bf16 without dropout and with the
    fused CE: the kernel path's gradient distance from the fp32 plain path
    within 1.5 times the bf16 plain path's, as in phase 5's bf16 check."""

    from distributed_llms_example_tpu_torch.ops import fused_optim as fo
    from distributed_llms_example_tpu_torch.ops.fused_dropout import dropout_seeds
    from distributed_llms_example_tpu_torch.train.step import causal_loss_sums

    def measured(model):
        """loss_and_grads's (loss, normalized gradients), with the forward +
        backward's peak memory above the weights (the gradients included,
        their normalized copies not) and its launches."""
        for p in model.parameters():
            p.grad = None
        free_cuda()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        zero_counters(fa, fd, fo)
        with dropout_seeds(torch.Generator().manual_seed(11)):
            lsum, tokens = causal_loss_sums(model, batch)
            lsum.backward()
        torch.cuda.synchronize()
        info = {"peak_bytes_above_weights": torch.cuda.max_memory_allocated() - base,
                "launches": read_counters(fa, fd, fo) | {
                    "flash_attention_fwd_dropout": fa.flash_attention.drop_launches}}
        grads = [(p.grad / tokens).detach().clone() for p in model.parameters()]
        for p in model.parameters():
            p.grad = None
        return (float((lsum / tokens).detach()), grads), info

    # (a) fp32 kernel path vs plain path, dropout on
    model = llama_small(torch, state, cfg, dtype=torch.float32, dropout=PROBS_DROPOUT,
                        fused_ce=False)
    kernel, k_info = measured(model)
    with plain_kernels(fa, fd):
        plain = loss_and_grads(torch, model, batch, is_seq2seq=False)
    with probs_dropout_seed_off_by_one(fa):
        fault = loss_and_grads(torch, model, batch, is_seq2seq=False)
    del model
    k32, f32 = grad_dist(kernel, plain), grad_dist(fault, plain)
    say({"phase": "llama_grad_check", "dtype": "float32", "layers": 2,
         "dropout": PROBS_DROPOUT, "attention_dropout": PROBS_DROPOUT,
         "batch_shape": list(batch["input_ids"].shape), "kernel_vs_plain": k32,
         "planted_fault": "kernels 2-3 draw the probs mask from seed + 1",
         "planted_fault_vs_plain": f32, "limits": GRAD_LIMITS, "loss": plain[0],
         "kernel_launches": k_info["launches"]})
    want_a = {"flash_attention_fwd": 2, "flash_attention_bwd_dq": 2,
              "flash_attention_bwd_dkv": 2, "fused_dropout": 8, "flash_attention_fwd_dropout": 2}
    if any(k_info["launches"][k] != v for k, v in want_a.items()):
        fail(f"llama fp32 gradient check launches {k_info['launches']}, expected {want_a}")
    for key, lim in GRAD_LIMITS.items():
        if not k32[key] <= lim:
            fail(f"llama fp32 gradient check: kernel path vs plain path {key} {k32[key]} > {lim}")
    if not any(f32[key] > lim for key, lim in GRAD_LIMITS.items()):
        fail(f"llama fp32 gradient check: the planted fault stays within every limit: {f32}")

    # (b) bf16 with dropout and the fused CE: remat off, full, dots bit-equal
    model = llama_small(torch, state, cfg, dtype=torch.bfloat16, dropout=PROBS_DROPOUT,
                        fused_ce=True)
    runs = {}
    for policy in (None, "full", "dots"):
        model.remat_policy = policy
        runs[policy or "off"] = measured(model)
    (off, off_info) = runs["off"]
    equal = {k: (v[0][0] == off[0], all(torch.equal(a, b) for a, b in zip(v[0][1], off[1])))
             for k, v in runs.items()}
    say({"phase": "llama_remat_check", "dtype": "bfloat16", "layers": 2,
         "dropout": PROBS_DROPOUT, "fused_ce": True, "losses": {k: v[0][0] for k, v in runs.items()},
         "loss_and_grads_bit_equal_to_off": equal,
         "peak_bytes_above_weights": {k: v[1]["peak_bytes_above_weights"]
                                      for k, v in runs.items()},
         "launches": {k: v[1]["launches"] for k, v in runs.items()}})
    if not all(a and b for a, b in equal.values()):
        fail(f"llama remat: loss or gradients differ from the run without remat: {equal}")
    del model, runs

    # (c) the fused CE against the unfused, fp32 (and the memory of each in bf16);
    # (d) with the fused CE, each dtype's plain path too
    out, plain = {}, {}
    for dtype in (torch.float32, torch.bfloat16):
        for fused in (False, True):
            model = llama_small(torch, state, cfg, dtype=dtype, dropout=0.0, fused_ce=fused)
            out[dtype, fused] = measured(model)
            if fused:
                with plain_kernels(fa, fd):
                    plain[dtype] = loss_and_grads(torch, model, batch, is_seq2seq=False)
            del model
    f, u = out[torch.float32, True][0], out[torch.float32, False][0]
    ce = grad_dist(f, u)
    ce["loss_rel_diff"] = abs(f[0] - u[0]) / abs(u[0])
    say({"phase": "llama_fused_ce_check", "dtype": "float32", "layers": 2, "fused_vs_unfused": ce,
         "limits": {**GRAD_LIMITS, "loss_rel_diff": LLAMA_CE_LOSS_RTOL},
         "bf16_loss": {"fused": out[torch.bfloat16, True][0][0],
                       "unfused": out[torch.bfloat16, False][0][0]},
         "peak_bytes_above_weights": {
             f"{'bf16' if d == torch.bfloat16 else 'fp32'}_{'fused' if fu else 'unfused'}":
             v[1]["peak_bytes_above_weights"] for (d, fu), v in out.items()}})
    if not ce["loss_rel_diff"] <= LLAMA_CE_LOSS_RTOL:
        fail(f"llama fused CE: loss {f[0]} vs unfused {u[0]}")
    for key, lim in GRAD_LIMITS.items():
        if key != "loss_diff" and not ce[key] <= lim:
            fail(f"llama fused CE: gradients {key} {ce[key]} > {lim}")
    ref = plain[torch.float32]
    k16 = grad_dist(out[torch.bfloat16, True][0], ref)
    p16 = grad_dist(plain[torch.bfloat16], ref)
    say({"phase": "llama_bf16_check", "layers": 2, "dropout": 0.0, "fused_ce": True,
         "bf16_kernel_vs_fp32_plain": k16, "bf16_plain_vs_fp32_plain": p16,
         "limit": "kernel grad_rel_l2 <= 1.5 x plain grad_rel_l2", "loss_fp32_plain": ref[0]})
    if not k16["grad_rel_l2"] <= 1.5 * p16["grad_rel_l2"]:
        fail(f"llama bf16 gradient: kernel path {k16['grad_rel_l2']} from fp32 against the "
             f"plain path's {p16['grad_rel_l2']}")
    del out, plain, f, u, ref


def causal_pad_work(lens, B, H, S, D, per_key):
    """(flops, live (query, key) pairs) of a causal pass with right padding:
    query row i of batch row b meets keys j <= i below its row's length."""
    import torch

    i = torch.arange(S, device=lens.device)
    pairs = float(torch.minimum(i[None, :] + 1, lens[:, None]).sum())
    return per_key * H * pairs * D, pairs


def llama_attention_time(torch, fa) -> dict:
    """Kernels 1, 2 and 3 at the llama recipe's shape, (8, 32, 1024, 128)
    bf16, causal with a ragged right padding: against their plain versions
    (the bf16 limits of phase 3), timed (events and device) beside their
    bounds over the live (query, key) pairs and SDPA's forward and backward
    with the same causal + padding mask."""
    import torch.nn.functional as F

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(13)
    B, H, S, D = 8, 32, 1024, 128
    lens = torch.randint(200, S + 1, (B,), generator=gen, device=dev)
    lens[0] = S
    bias = torch.where(torch.arange(S, device=dev)[None, :] < lens[:, None], 0.0, -1e9)
    bias = bias[:, None, None, :].float().contiguous()
    q, k, v, do = (torch.randn(B, H, S, D, generator=gen, device=dev).to(torch.bfloat16)
                   for _ in range(4))
    kw = dict(causal=True, scale=D ** -0.5)
    tol = dict(atol=2e-2, rtol=2e-2)
    o, lse = fa.flash_attention(q, k, v, bias, causal=True, return_lse=True)
    po, plse = fa.flash_attention_plain(q, k, v, bias, causal=True)
    errs = {"fwd": max(check_close("flash_fwd llama (8, 32, 1024, 128) causal + padding bf16",
                                   o, po, **tol),
                       check_close("flash_fwd llama causal + padding lse bf16", lse, plse, **tol))}
    delta = fa.attention_delta(do, o)
    dq = fa.flash_bwd_dq(q, k, v, bias, do, lse, delta, **kw)
    dk, dv = fa.flash_bwd_dkv(q, k, v, bias, do, lse, delta, **kw)
    _, ds = fa._bwd_plain(q, k, v, bias, do, lse, delta, **kw)
    pdq = fa._dq_plain(q, k, ds)
    pdk, pdv = fa._dkv_plain(q, k, v, do, *fa._bwd_plain(q, k, v, bias, do, lse, delta, **kw))
    errs["dq"] = check_close("flash_bwd_dq llama causal + padding bf16", dq, pdq, **tol)
    errs["dkv"] = max(check_close("flash_bwd_dkv llama causal + padding dk bf16", dk, pdk, **tol),
                      check_close("flash_bwd_dkv llama causal + padding dv bf16", dv, pdv, **tol))
    del po, plse, pdq, pdk, pdv, ds
    free_cuda()
    # SDPA with the same causal + padding mask (a boolean (B, 1, S, S))
    keep = (torch.arange(S, device=dev)[None, :] <= torch.arange(S, device=dev)[:, None])
    keep = keep[None, None] & (torch.arange(S, device=dev) < lens[:, None])[:, None, None, :]
    qs, ks, vs = (t.detach().clone().requires_grad_(True) for t in (q, k, v))
    out = F.scaled_dot_product_attention(qs, ks, vs, attn_mask=keep)
    sdpa_fwd = time_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=keep),
                       per_rep=10)
    sdpa_bwd = time_ms(lambda: torch.autograd.grad(out, (qs, ks, vs), do, retain_graph=True),
                       per_rep=5)
    flops1, pairs = causal_pad_work(lens, B, H, S, D, 4)
    keys = float(lens.sum())
    # every query row is read (q, do, lse, delta) and every output row
    # written at full size, but only the live key rows of k and v: a padded
    # key adds nothing to dq, and its dk/dv rows are zeros needing no read
    kv_live = 2 * H * keys * D * 2
    io_fwd = 2 * B * H * S * D * 2 + kv_live + bias.numel() * 4 + B * H * S * 4
    io_bwd = 2 * B * H * S * D * 2 + kv_live + 2 * B * H * S * 4 + bias.numel() * 4
    rows = {}
    for name, fn, plain, per_key, out_bytes, dev_name, lib_ms, lib in (
        ("flash_attention_fwd", lambda: fa.flash_attention(q, k, v, bias, causal=True),
         lambda: fa.flash_attention_plain(q, k, v, bias, causal=True), 4, 0,
         "flash_fwd_tc_kernel", sdpa_fwd, "SDPA forward, same mask"),
        ("flash_attention_bwd_dq", lambda: fa.flash_bwd_dq(q, k, v, bias, do, lse, delta, **kw),
         lambda: fa._dq_plain(q, k, fa._bwd_plain(q, k, v, bias, do, lse, delta, **kw)[1]),
         6, B * H * S * D * 2, "flash_bwd_dq_tc_kernel", sdpa_bwd,
         "SDPA backward (dq, dk, dv in one call), same mask"),
        ("flash_attention_bwd_dkv", lambda: fa.flash_bwd_dkv(q, k, v, bias, do, lse, delta, **kw),
         lambda: fa._dkv_plain(q, k, v, do, *fa._bwd_plain(q, k, v, bias, do, lse, delta, **kw)),
         8, 2 * B * H * S * D * 2, "flash_bwd_dkv_tc_kernel", sdpa_bwd,
         "SDPA backward (dq, dk, dv in one call), same mask"),
    ):
        flops, _ = causal_pad_work(lens, B, H, S, D, per_key)
        nbytes = io_fwd if name == "flash_attention_fwd" else io_bwd + out_bytes
        b_ms, b_by = bound(flops, nbytes)
        rows[name] = dict(ms=time_ms(fn, per_rep=5), plain_ms=time_ms(plain, per_rep=1, reps=3),
                          bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms)
        say({"phase": "kernel_time", "kernel": name, "shape": [B, H, S, D],
             "branch": "llama causal + padding", **rows[name], "library": lib,
             "device_ms": device_ms_of(fn, 5, dev_name), "live_pairs": pairs,
             "flops": flops, "bytes": nbytes})
    del q, k, v, do, o, lse, delta, qs, ks, vs, out, keep
    free_cuda()
    return errs



# phase 14: data-parallel and FSDP training.  (a) in this process: a
# world-1 NCCL group, llama-2-7b's widths at DIST_LAYERS layers, one bf16
# --remat --fused-ce step of the model wrapped by parallel/fsdp.shard_model
# against the same step unwrapped (a reduction over one rank is a copy:
# loss, grad norm and every parameter after the step bit-equal), kernel
# 8's partial norm mode split in two tables on the card; (b) two ranks on
# cuda:0 over gloo (NCCL takes one rank a GPU) running the CLI with
# --mesh fsdp=2, fp32, against the same CLI run on one rank within
# GRAD_LIMITS' loss and norm terms.  One layer since phase 16 joined the
# run: (b)'s fp32 gradients cross gloo through host memory every step, and
# at 2 layers (b) took 73 s of the run's time limit.  Since phase 19 joined
# the run, the end-of-run checkpoints of (b)'s runs are left out (phase 15
# (b) saves and restores sharded steps on the card, phases 5c and 13 whole
# ones), and its HF directory is phase 19's as well
DIST_LAYERS = 1
DIST_STEPS = 3
DIST_RECORDS = 24
DIST_ARGS = [
    "--tokenizer", "byte", "--remat", "--fused-ce", "--batch-size", "8", "--num-epochs", "1",
    "--max-source-length", "1024", "--max-target-length", "128", "--compute-dtype", "float32",
    "--learning-rate", "1e-4", "--warmup-steps", "1", "--seed", "0", "--log-every-steps", "1",
    "--evaluation-steps", "0",
]
DIST_RANK_TIMEOUT_S = 420


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


@contextlib.contextmanager
def trainer_hooks(torch, *, next_mesh=None, rng_state=None):
    """``Trainer.train`` with the test hooks set first: ``next_mesh``
    ([data, fsdp]) the layout a host loss rebuilds onto
    (``_next_mesh_override``), ``rng_state`` (a list of bytes) the dropout
    generator's state."""
    from distributed_llms_example_tpu_torch.core.mesh import MeshSpec
    from distributed_llms_example_tpu_torch.train.trainer import Trainer

    real = Trainer.train

    def train(self):
        if next_mesh is not None:
            self._next_mesh_override = MeshSpec(*next_mesh)
        if rng_state is not None:
            self.generator.set_state(torch.tensor(rng_state, dtype=torch.uint8))
        return real(self)

    Trainer.train = train
    try:
        yield
    finally:
        Trainer.train = real


def dist_rank_main(spec_path: str) -> None:
    """One rank of phase 14 (b), 15 (b), 19 or 20 (``chip_smoke.py
    --dist-rank spec.json``): a gloo group on cuda:0 joined through
    ``core/mesh.py`` from the spec (NCCL refuses two ranks on one card),
    then the train CLI (with phase 15's hooks; ``rank0_argv`` added on rank
    0), phase 19's parts or phase 20's; rank 0 writes its steps' losses and
    grad norms and its launches, or the phase's numbers."""
    with open(spec_path) as f:
        spec = json.load(f)
    sys.path.insert(0, HERE)
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    rank = int(spec["rank"])
    from distributed_llms_example_tpu_torch.core.mesh import initialize_distributed
    from distributed_llms_example_tpu_torch.launch import cli
    from distributed_llms_example_tpu_torch.ops import flash_attention as fa
    from distributed_llms_example_tpu_torch.ops import fused_dropout as fd
    from distributed_llms_example_tpu_torch.ops import fused_optim as fo

    initialize_distributed(spec["address"], spec["world"], rank, device_type="cpu")
    if spec.get("phase19"):
        out = model_parallel_rank_main(torch, fa, fd, fo, cli, spec, rank)
        if spec.get("phase20"):  # phase 20's rank parts in the same processes
            free_cuda()
            t0 = time.perf_counter()
            out["serving"] = serve_mesh_rank_main(torch, fa, fd, fo, cli, spec, rank)
            out["serving"]["seconds"] = time.perf_counter() - t0
        if rank == 0:
            with open(spec["out"], "w") as f:
                json.dump(out, f)
        torch.distributed.destroy_process_group()
        return
    zero_counters(fa, fd, fo)
    skip = no_final_state_save() if spec.get("no_final_save") else contextlib.nullcontext()
    with trainer_hooks(torch, next_mesh=spec.get("next_mesh"),
                       rng_state=spec.get("rng_state")), skip:
        trainer = cli.train(spec["argv"])
    torch.cuda.synchronize()
    out = {"losses": [float(m["loss"]) for m in trainer.history],
           "grad_norms": [float(m["grad_norm"]) for m in trainer.history],
           "launches": read_counters(fa, fd, fo),
           "peak_mem_bytes": torch.cuda.max_memory_allocated()}
    if "steps_run" in spec:  # phase 15: the steps launched (a replay included)
        out["expected"] = expected_train_launches(trainer.model, spec["steps_run"]) | {
            "fused_grad_norm_finish": spec["sharded_steps"]}
        snap = trainer.recovery.snapshot_for(ELASTIC_SAVE_EVERY)
        out.update(mesh=[trainer.mesh_spec.data, trainer.mesh_spec.fsdp],
                   result={k: v for k, v in trainer.result.items() if k != "final_eval"},
                   rng_state=snap["rng"].tolist() if snap is not None else None)
    else:
        out["expected"] = expected_train_launches(trainer.model, len(trainer.history),
                                                  sharded=True)
        out["expected"]["flash_attention_fwd"] *= 2  # remat's recompute
    if rank == 0:
        with open(spec["out"], "w") as f:
            json.dump(out, f)
    torch.distributed.destroy_process_group()


def dist_ranks(argv: list[str], world: int, *, phase: str, **extra) -> dict:
    """``world`` ranks of the train CLI with ``argv`` over gloo on cuda:0
    (``extra``: more of the spec, phase 15's hooks); rank 0's result.
    Every rank process is waited for or killed before this returns."""
    address = f"127.0.0.1:{free_port()}"
    result = os.path.join(WORK, "dist-rank0.json")
    if os.path.exists(result):
        os.remove(result)
    procs, logs = [], []
    for rank in range(world):
        spec = os.path.join(WORK, f"dist-rank{rank}-spec.json")
        with open(spec, "w") as f:
            json.dump({"rank": rank, "world": world, "address": address, "argv": argv,
                       "out": result, **extra}, f)
        log = os.path.join(WORK, f"dist-rank{rank}.log")
        logs.append(log)
        procs.append(subprocess.Popen([sys.executable, os.path.abspath(__file__), "--dist-rank",
                                       spec], stdout=open(log, "w"), stderr=subprocess.STDOUT,
                                      cwd=HERE))
    deadline = time.perf_counter() + DIST_RANK_TIMEOUT_S
    rcs: list = []
    try:
        for p in procs:
            try:
                rcs.append(p.wait(timeout=max(deadline - time.perf_counter(), 1.0)))
            except subprocess.TimeoutExpired:
                rcs.append("timed out")  # a rank waits on one that died or hung
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if rcs != [0] * world or not os.path.exists(result):
        for r, log in enumerate(logs):
            with open(log) as f:
                tail = f.read()[-3000:]
            print(f"--- phase {phase} rank {r} (exit {rcs[r]}) ---\n{tail}", file=sys.stderr)
        fail(f"phase {phase}: the {world} gloo ranks exited {rcs}")
    with open(result) as f:
        return json.load(f)


def kernel8_split_norm_check(torch, fo, grads) -> dict:
    """Kernel 8's partial mode on the card: the gradient pass over every
    leaf in one table, partial then finished, bit-equal to the one-pass
    norm; each leaf cut in two tables, two partial passes summed and
    finished, within 1 fp32 ulp of it; a leaf of no element in each table;
    the plain version the same.  Tokens 1, so the in-place division leaves
    the gradients as they are.  The finish entry timed (one thread), beside
    its plain version and its library call, one torch.sqrt into fp32."""
    import numpy as np

    tokens = torch.ones(1, dtype=torch.float32, device="cuda")
    empty = torch.empty(0, dtype=torch.float32, device="cuda")
    flat = [g.reshape(-1) for g in grads]
    halves_a = [g[: g.numel() // 2] for g in flat] + [empty]
    halves_b = [g[g.numel() // 2:] for g in flat] + [empty.clone()]
    leaves = flat + [empty]
    one = fo.fused_grad_prep(leaves, tokens)
    whole = fo.grad_norm_finish(fo.fused_grad_prep(leaves, tokens, partial=True))
    total = (fo.fused_grad_prep(halves_a, tokens, partial=True)
             + fo.fused_grad_prep(halves_b, tokens, partial=True))
    split = fo.grad_norm_finish(total)
    cpu = [g.detach().cpu() for g in leaves]
    plain_one = fo.grad_prep_plain(cpu, tokens.cpu())
    plain_whole = fo.norm_finish_plain(fo.grad_prep_plain(cpu, tokens.cpu(), partial=True))
    plain_split = fo.norm_finish_plain(
        fo.grad_prep_plain([g[: g.numel() // 2] for g in cpu], tokens.cpu(), partial=True)
        + fo.grad_prep_plain([g[g.numel() // 2:] for g in cpu], tokens.cpu(), partial=True))
    torch.cuda.synchronize()
    one_f = np.float32(float(one))
    ulp = float(np.spacing(one_f))
    t = fo.fused_grad_prep(leaves, tokens, partial=True)
    finish_ms = time_ms(lambda: fo.grad_norm_finish(t), per_rep=200)
    plain_ms = time_ms(lambda: fo.norm_finish_plain(t), per_rep=200)
    # the library call: one torch.sqrt of the float64 total into an fp32
    # tensor, the root rounded once as the finish rounds it (timed here,
    # used nowhere in the port)
    out32 = torch.empty((), dtype=torch.float32, device="cuda")
    library_ms = time_ms(lambda: torch.sqrt(t, out=out32), per_rep=200)
    torch.cuda.synchronize()
    library_equal = bool(torch.equal(out32, fo.grad_norm_finish(t)))
    # one float64 read and one fp32 write
    finish_bound_ms, finish_bound_by = bound(2, 12)
    line = {"phase": "kernel_check", "case": "fused_grad_prep partial + fused_grad_norm_finish",
            "leaves": len(leaves), "elements": sum(g.numel() for g in leaves),
            "one_pass": float(one), "partial_finished": float(whole),
            "split_two_tables": float(split), "fp32_ulp": ulp,
            "split_diff_ulps": abs(float(split) - float(one)) / ulp,
            "plain_one_pass": float(plain_one), "plain_partial_finished": float(plain_whole),
            "plain_split": float(plain_split),
            "kernel_vs_plain_ulps": abs(float(one) - float(plain_one)) / ulp,
            "finish_ms": finish_ms, "finish_plain_ms": plain_ms,
            "finish_library_ms": library_ms, "library_bit_equal": library_equal,
            "finish_bound_ms": finish_bound_ms, "finish_bound_by": finish_bound_by}
    say(line)
    if float(whole) != float(one) or float(plain_whole) != float(plain_one):
        fail("kernel 8: the partial pass and its finish differ from the one-pass norm")
    if abs(float(split) - float(one)) > ulp or abs(float(plain_split) - float(plain_one)) > ulp:
        fail("kernel 8: two tables' partial sums, finished, are more than one fp32 ulp from "
             "the one-pass norm")
    if abs(float(one) - float(plain_one)) > ulp:
        fail("kernel 8: the one-pass norm is more than one fp32 ulp from grad_prep_plain")
    return {"finish_ms": finish_ms, "finish_plain_ms": plain_ms,
            "finish_library_ms": library_ms, "finish_bound_ms": finish_bound_ms}


def one_rank_baseline(torch, cli, argv: list[str], out_dir: str) -> dict:
    """The CLI on one rank with ``argv`` into ``out_dir`` (its end-of-run
    checkpoint left out, its HF export kept): the losses, grad norms, step
    times and peak memory that phases 14 (b) and 19 hold their ranks to."""
    torch.cuda.reset_peak_memory_stats()
    with no_final_state_save():
        one = cli.train([*argv, "--output-dir", out_dir])
    torch.cuda.synchronize()
    out = {"losses": [float(m["loss"]) for m in one.history],
           "grad_norms": [float(m["grad_norm"]) for m in one.history],
           "step_s": [b - a for a, b in zip(one.step_ends, one.step_ends[1:])],
           "peak_mem_bytes": torch.cuda.max_memory_allocated()}
    del one
    free_cuda()
    return out


def distributed_phase(torch, fa, fd, fo, cli) -> tuple[dict, dict, str]:
    """Phase 14.  Returns (the wrapped step's launches, kernel 8's finish
    numbers, phase 19's HF directory)."""
    import dataclasses

    from distributed_llms_example_tpu_torch.core.config import MeshConfig
    from distributed_llms_example_tpu_torch.core.mesh import build_mesh, resolve_mesh_shape
    from distributed_llms_example_tpu_torch.data.batching import BatchIterator
    from distributed_llms_example_tpu_torch.data.dataset import CausalLMDataset, load_json_records
    from distributed_llms_example_tpu_torch.data.tokenizer import ByteTokenizer
    from distributed_llms_example_tpu_torch.models.llama import LlamaForCausalLM
    from distributed_llms_example_tpu_torch.models.registry import LLAMA_CONFIGS
    from distributed_llms_example_tpu_torch.parallel.fsdp import local, shard_model
    from distributed_llms_example_tpu_torch.train.optim import (
        AdamWState,
        OptimizerSpec,
        linear_schedule_with_warmup,
    )
    from distributed_llms_example_tpu_torch.train.step import StepGroups, train_step
    from distributed_llms_example_tpu_torch.train.trainer import put_batch

    t_phase = time.perf_counter()
    train_path = os.path.join(WORK, "dist_train.json")
    write_instruction_records(train_path, DIST_RECORDS, seed=2)
    ds = CausalLMDataset(load_json_records(train_path), ByteTokenizer(), max_length=1024,
                         max_target_length=128)
    batch = put_batch(next(iter(BatchIterator(ds, global_batch=8, seed=1234,
                                              max_source_length=1024,
                                              max_target_length=1024).epoch(0))),
                      torch.device("cuda"))

    # (a) a world-1 NCCL group
    torch.distributed.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{free_port()}",
                                         world_size=1, rank=0)
    try:
        mesh = build_mesh(resolve_mesh_shape(MeshConfig(data=1, fsdp=1), 1), "cuda")
        cfg = dataclasses.replace(LLAMA_CONFIGS["llama-2-7b"], num_hidden_layers=DIST_LAYERS,
                                  fused_ce=True)
        spec = OptimizerSpec(learning_rate=1e-4, warmup_steps=0, total_steps=10)
        sched = linear_schedule_with_warmup(1e-4, 0, 10)

        def build():
            m = LlamaForCausalLM(cfg, dtype=torch.bfloat16, param_dtype=torch.float32,
                                 device="cuda", remat_policy="full")
            m.init_weights(torch.Generator(device="cuda").manual_seed(0))
            return m.train()

        runs = {}
        for name in ("unwrapped", "wrapped"):
            model = build()
            groups = StepGroups()
            if name == "wrapped":
                shard_model(model, mesh)
                groups = StepGroups(world=1, shard_group=mesh.get_group("fsdp"))
            named = list(model.named_parameters())
            state = AdamWState.zeros([local(p.detach()) for _, p in named])
            if name == "unwrapped":
                want = expected_train_launches(model, 1, sharded=True)
            free_cuda()
            torch.cuda.reset_peak_memory_stats()
            zero_counters(fa, fd, fo)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            m = train_step(model, named, state, spec, sched, batch, is_seq2seq=False,
                           generator=torch.Generator().manual_seed(3), groups=groups)
            torch.cuda.synchronize()
            first_s = time.perf_counter() - t0
            launches = read_counters(fa, fd, fo)
            after = {n: local(p.detach()).clone() for n, p in named}
            metrics = (float(m["loss"]), float(m["grad_norm"]))
            step_s = []
            for _ in range(4):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                train_step(model, named, state, spec, sched, batch, is_seq2seq=False,
                           generator=torch.Generator().manual_seed(3), groups=groups)
                torch.cuda.synchronize()
                step_s.append(time.perf_counter() - t0)
            runs[name] = dict(metrics=metrics, after=after, launches=launches,
                              first_step_s=first_s, step_s=step_s,
                              peak_mem_bytes=torch.cuda.max_memory_allocated())
            if name == "wrapped":
                grads = [local(p.grad).detach().clone() for _, p in named]
            del model, named, state, m
            free_cuda()
        want["flash_attention_fwd"] *= 2  # remat's recompute
        want_plain = want | {"fused_grad_norm_finish": 0}
        ref, wrapped = runs["unwrapped"], runs["wrapped"]
        unequal = [n for n, t in ref["after"].items() if not torch.equal(t, wrapped["after"][n])]
        line = {"phase": "dist_fsdp_world1", "model": "llama-2-7b", "layers": DIST_LAYERS,
                "batch_shape": list(batch["input_ids"].shape), "compute_dtype": "bfloat16",
                "remat": "full", "fused_ce": True,
                "loss_grad_norm": {k: v["metrics"] for k, v in runs.items()},
                "parameters": len(ref["after"]), "parameters_bit_equal":
                    len(ref["after"]) - len(unequal), "unequal": unequal[:5],
                "launches": {k: v["launches"] for k, v in runs.items()},
                "expected": {"wrapped": want, "unwrapped": want_plain},
                "first_step_s": {k: v["first_step_s"] for k, v in runs.items()},
                "step_s": {k: v["step_s"] for k, v in runs.items()},
                "step_s_median": {k: statistics.median(v["step_s"]) for k, v in runs.items()},
                "peak_mem_bytes": {k: v["peak_mem_bytes"] for k, v in runs.items()}}
        say(line)
        if ref["metrics"] != wrapped["metrics"] or unequal:
            fail(f"phase 14 (a): the wrapped step differs from the unwrapped one over one rank "
                 f"(loss, grad norm {ref['metrics']} vs {wrapped['metrics']}; parameters "
                 f"{unequal[:5]})")
        if wrapped["launches"] != want or ref["launches"] != want_plain:
            fail(f"phase 14 (a) launches {line['launches']}, expected {line['expected']}")
        finish = kernel8_split_norm_check(torch, fo, grads)
        del grads
        free_cuda()
    finally:
        torch.distributed.destroy_process_group()

    # (b) the CLI on one rank, then on two gloo ranks of cuda:0 (fsdp=2)
    ckpt = llama_hf_dir(torch, DIST_LAYERS)
    one_run = one_rank_baseline(torch, cli, [*DIST_ARGS, "--model-ckpt", ckpt, "--train-file",
                                             train_path], fresh_dir("dist-one-out"))
    t0 = time.perf_counter()
    two = dist_ranks([*DIST_ARGS, "--model-ckpt", ckpt, "--train-file", train_path,
                      "--output-dir", fresh_dir("dist-fsdp-out"), "--mesh", "fsdp=2"], 2,
                     phase="14 (b)", no_final_save=True)
    two_s = time.perf_counter() - t0
    loss_diff = max(abs(a - b) for a, b in zip(one_run["losses"], two["losses"]))
    norm_diff = max(abs(a - b) for a, b in zip(one_run["grad_norms"], two["grad_norms"]))
    say({"phase": "dist_fsdp_two_ranks", "backend": "gloo", "device": "cuda:0",
         "mesh": "fsdp=2", "compute_dtype": "float32", "layers": DIST_LAYERS,
         "one_rank": one_run, "two_ranks": two, "loss_diff": loss_diff,
         "grad_norm_diff": norm_diff, "wall_s": two_s,
         "phase_s": time.perf_counter() - t_phase})
    if len(two["losses"]) != DIST_STEPS or len(one_run["losses"]) != DIST_STEPS \
            or loss_diff > GRAD_LIMITS["loss_diff"] or norm_diff > GRAD_LIMITS["grad_norm_diff"]:
        fail(f"phase 14 (b): two ranks' losses and norms are not within the BART limits of one "
             f"rank's (loss {loss_diff}, norm {norm_diff})")
    if two["launches"] != two["expected"]:
        fail(f"phase 14 (b): rank 0's launches {two['launches']}, expected {two['expected']}")
    # the exports: the machine's disk holds what every phase ever wrote at
    # once, so they go before phase 15 (the 1.9 GB HF directory stays for
    # phase 19)
    for name in ("dist-one-out", "dist-fsdp-out"):
        shutil.rmtree(os.path.join(WORK, name), ignore_errors=True)
    return wrapped["launches"], finish, ckpt


# phase 19: tensor and sequence parallelism.  (a) ring attention alone on
# two gloo ranks of cuda:0 (ops/ring_attention.py: every hop one
# all_to_all_single, which gloo takes for CUDA tensors where it refuses
# isend/irecv) at the llama-2-7b train shape (8, 32, 1024, 128), fp32,
# causal with a padding mask, against plain attention over the whole length
# in one process; the held block's key positions one block late (the causal
# mask a block off) must break the limit.  (b) the train CLI under --mesh
# tensor=2 and (c) under --mesh sequence=2 (ring attention, kernel 8), each
# on two gloo ranks of cuda:0 at llama-2-7b's widths and DIST_LAYERS layers
# (phase 14's HF directory), fp32, with MP_ARGS, against the same CLI on
# one rank.  (a), (b) and (c) run in one pair of rank processes.  The first
# step is profiled on rank 0 and the second timed.
MP_STEPS = 2
MP_RECORDS = 16
# DIST_ARGS without --remat and --fused-ce (the fused CE is refused on a
# tensor or sequence mesh), with no warmup: both steps update the weights,
# so the second step's loss and norm and the exported weights come from a
# sharded AdamW update
MP_ARGS = [a for a in DIST_ARGS if a not in ("--remat", "--fused-ce")]
MP_ARGS[MP_ARGS.index("--warmup-steps") + 1] = "0"
MP_PROFILE_STEP = 1
# each leaf of a two-rank run's export against the one-rank run's: the
# L2 norm of their difference over that of the one-rank run's update
# (trained minus initial weights).  fp32: the two runs' weights differ by a
# rounding (the norm scales near 1 by 1.2e-7 against an update of ~1e-4);
# an update lost or misapplied on a shard differs by the update itself
MP_EXPORT_REL_LIMIT = 1e-3
RING_SHAPE = (8, 32, 1024, 128)
# relative to the largest entry of the plain output or gradient (fp32: the
# ring's tiles sum in another order than the plain softmax's rows)
RING_REL_LIMIT = 1e-5
RING_HOP_REPS = 5


def ring_rank_main(torch, spec: dict, rank: int) -> dict:
    """Phase 19 (a) on one rank (``chip_smoke.py --dist-rank``): the same
    seeded inputs on every rank, this rank's sequence block through
    ``ring_attention`` forward and backward, every block gathered; rank 0
    also runs plain attention over the whole length, times both and one
    hop, and with the held block's positions one block late (planted)."""
    from distributed_llms_example_tpu_torch.ops import ring_attention as ra
    from distributed_llms_example_tpu_torch.ops.attention import (
        NEG_INF,
        dot_product_attention,
        make_causal_bias,
    )
    from distributed_llms_example_tpu_torch.parallel.activation import hop, merge_sequence

    world = torch.distributed.get_world_size()
    group = torch.distributed.group.WORLD
    B, H, S, D = RING_SHAPE
    gen = torch.Generator(device="cuda").manual_seed(19)
    q, k, v, dout = (torch.randn(B, H, S, D, generator=gen, device="cuda") for _ in range(4))
    lens = torch.tensor([S - 37 * i for i in range(B)], device="cuda")
    bias = torch.where(torch.arange(S, device="cuda")[None, :] < lens[:, None], 0.0,
                       NEG_INF)[:, None, None, :].contiguous()
    ring = ra.Ring(group, world, rank)

    def run():
        blocks = [t.chunk(world, dim=2)[rank].clone().requires_grad_(True) for t in (q, k, v)]
        out = ra.ring_attention(*blocks, bias.chunk(world, dim=-1)[rank].contiguous(),
                                ring=ring, causal=True)
        out.backward(dout.chunk(world, dim=2)[rank])
        got = [out.detach()] + [b.grad for b in blocks]
        return [merge_sequence(t.contiguous(), group, world, dim=2) for t in got]

    def timed(fn, *, both_ranks=True):
        torch.cuda.synchronize()
        if both_ranks:
            torch.distributed.barrier()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        return res, (time.perf_counter() - t0) * 1e3

    run()  # warm
    got, ring_ms = timed(run)
    kv = torch.cat([k.chunk(world, dim=2)[rank].reshape(-1), v.chunk(world, dim=2)[rank]
                    .reshape(-1)])
    hop_ms = []
    for _ in range(RING_HOP_REPS):
        _, ms = timed(lambda: hop(kv, group, world, rank)[1].wait())
        hop_ms.append(ms)
    real = ra._block_update
    ra._block_update = lambda m, l, acc, q_, k_, v_, b_, qp, kp, **kw: real(
        m, l, acc, q_, k_, v_, b_, qp, kp + k_.shape[2], **kw)
    try:
        planted = run()
    finally:
        ra._block_update = real
    out = {"ring_ms": ring_ms, "hop_ms": hop_ms, "hop_bytes": kv.numel() * kv.element_size(),
           "world": world}
    if rank != 0:
        return out

    def plain():
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        o = dot_product_attention(*leaves, bias + make_causal_bias(S, S, device="cuda"),
                                  scale=D ** -0.5, dtype=torch.float32)
        o.backward(dout)
        return [o.detach()] + [t.grad for t in leaves]

    plain()
    want, plain_ms = timed(plain, both_ranks=False)  # rank 1 has left
    names = ("out", "dq", "dk", "dv")

    def rel(a, b):
        return {n: float((x - y).abs().max() / y.abs().max()) for n, x, y in zip(names, a, b)}

    out.update(plain_ms=plain_ms, rel_err=rel(got, want), planted_rel_err=rel(planted, want),
               peak_mem_bytes=torch.cuda.max_memory_allocated())
    return out


def model_parallel_launches(trainer, axis: str, steps: int) -> dict:
    """What phase 19's run must launch on a rank: under ``tensor`` kernels
    1-3 once a layer a step at the rank's heads, kernel 8's gradient pass
    twice a step (the replicated leaves, the tensor shards) and its finish
    once; under ``sequence`` no kernel 1-3 (ring attention) and the
    gradient pass once a leaf table."""
    want = expected_train_launches(trainer.model, steps)
    if axis == "tensor":
        want.update(fused_grad_prep=2 * steps, fused_grad_norm_finish=steps)
    else:
        want.update(flash_attention_fwd=0, flash_attention_bwd_dq=0, flash_attention_bwd_dkv=0)
    return want


def model_parallel_rank_extras(torch, trainer, axis: str, rank: int) -> dict:
    """Phase 19 (b)/(c) on one rank after the run: the launches it implies,
    the export against the weights gathered whole (every rank joins every
    gather; rank 0 reads the export), each step's host time and the
    collective account."""
    from distributed_llms_example_tpu_torch.models.convert import convert_state_dict
    from distributed_llms_example_tpu_torch.models.export import full_state_dict
    from distributed_llms_example_tpu_torch.models.registry import load_local_state_dict

    gathered = full_state_dict(trainer.model, tensor_group=trainer.groups.tensor_group,
                               tensor=trainer.mesh_spec.tensor)
    out = {"expected": model_parallel_launches(trainer, axis, len(trainer.history)),
           "step_s": [b - a for a, b in zip(trainer.step_ends, trainer.step_ends[1:])],
           "comm": trainer.obs._comm_account}
    budget = trainer.obs.budget
    acct = getattr(budget, "last_device_account", None) if budget is not None else None
    if acct is not None:
        out["device_account"] = {k: acct.get(k) for k in (
            "window", "buckets_ms", "bucket_frac", "busy_ms", "span_ms", "events")}
    if rank == 0:
        exported = convert_state_dict("llama", load_local_state_dict(
            os.path.join(trainer.cfg.output_dir, "model")))
        out["export_leaves"] = len(gathered)
        out["export_unequal"] = sorted(
            n for n, t in gathered.items()
            if n not in exported or not torch.equal(exported[n], t.detach().cpu()))
    return out


def model_parallel_rank_main(torch, fa, fd, fo, cli, spec: dict, rank: int) -> dict:
    """Phase 19 on one rank (``chip_smoke.py --dist-rank``, one spawn for
    all three parts): (a)'s ring check, then the train CLI with each of
    ``spec["runs"]`` ((axis, argv) pairs; ``rank0_argv`` added on rank 0),
    the launch counters zeroed just before each run and read just after."""
    from distributed_llms_example_tpu_torch.train import trainer as trainer_mod

    out = {"ring": ring_rank_main(torch, spec, rank)}
    real_evaluate = trainer_mod.Trainer.evaluate

    def counters():
        return read_counters(fa, fd, fo) | {"flash_decode": fa.flash_decode.launches,
                                            "flash_decode_paged": fa.flash_decode_paged.launches}

    for axis, argv in spec["runs"]:
        zero_counters(fa, fd, fo)
        torch.cuda.reset_peak_memory_stats()
        evals: list = []

        def evaluate(self, *a, **k):
            # phase 20 (e): the eval under tensor=2, its launches in their
            # own window
            torch.cuda.synchronize()
            before = counters()
            t0 = time.perf_counter()
            scores = real_evaluate(self, *a, **k)
            torch.cuda.synchronize()
            after = counters()
            evals.append({"scores": scores, "wall_s": time.perf_counter() - t0,
                          "launches": {n: after[n] - before[n] for n in after}})
            return scores

        trainer_mod.Trainer.evaluate = evaluate
        try:
            with no_final_state_save():
                trainer = cli.train(argv + (spec.get("rank0_argv", []) if rank == 0 else []))
        finally:
            trainer_mod.Trainer.evaluate = real_evaluate
        torch.cuda.synchronize()
        eval_launches = {n: sum(e["launches"][n] for e in evals) for n in counters()}
        # the train steps' own launches: the eval's taken out
        train_launches = {n: v - eval_launches[n] for n, v in read_counters(fa, fd, fo).items()}
        run = {"losses": [float(m["loss"]) for m in trainer.history],
               "grad_norms": [float(m["grad_norm"]) for m in trainer.history],
               "launches": train_launches, "evals": evals,
               "peak_mem_bytes": torch.cuda.max_memory_allocated()}
        run.update(model_parallel_rank_extras(torch, trainer, axis, rank))
        out[axis] = run
        del trainer
        free_cuda()
    return out


def export_update_diffs(torch, ckpt: str, one_dir: str, two_dirs: list[str]) -> list[dict]:
    """For each of ``two_dirs`` (a two-rank run's HF export), each leaf's
    ``MP_EXPORT_REL_LIMIT`` measure against ``one_dir`` (the one-rank
    run's) from the initial weights in ``ckpt``, and the largest absolute
    difference."""
    from distributed_llms_example_tpu_torch.models.convert import convert_state_dict
    from distributed_llms_example_tpu_torch.models.registry import load_local_state_dict

    def load(d):
        return convert_state_dict("llama", load_local_state_dict(d))

    init, one = load(ckpt), load(one_dir)
    out = []
    for two_dir in two_dirs:
        two = load(two_dir)
        rel, max_abs = {}, 0.0
        for n, w1 in one.items():
            w1, w2, w0 = (t.to("cuda", torch.float32) for t in (w1, two[n], init[n]))
            rel[n] = float((w2 - w1).norm() / (w1 - w0).norm())
            max_abs = max(max_abs, float((w2 - w1).abs().max()))
        out.append({"rel": rel, "max_abs": max_abs, "leaves": len(rel)})
        del two
    del init, one
    free_cuda()
    return out


def model_parallel_eval_check(evals: list[dict]) -> None:
    """Phase 20 (e): phase 19 (b)'s eval under tensor=2 on rank 0, one
    event of one batch: ROUGE finite in [0, 1], kernel 1 once a layer (the
    prompt prefill at 16 of 32 heads) and kernel 5 once a layer a beam
    step, nothing else."""
    steps = MP_EVAL_NEW - 1
    want = {k: 0 for k in evals[0]["launches"]} if evals else {}
    want.update(flash_attention_fwd=DIST_LAYERS, flash_decode=DIST_LAYERS * steps)
    say({"phase": "eval_under_tensor", "mesh": "tensor=2", "layers": DIST_LAYERS,
         "records": MP_VAL_RECORDS, "num_beams": 2, "new_tokens": MP_EVAL_NEW,
         "events": len(evals), "expected": want, **(evals[0] if evals else {})})
    rouge = ("rouge1", "rouge2", "rougeL", "rougeLsum")
    if len(evals) != 1 or evals[0]["launches"] != want \
            or not all(0.0 <= evals[0]["scores"].get(k, -1.0) <= 1.0 for k in rouge):
        fail(f"phase 20 (e): the eval under tensor=2 gave {evals}, launches expected {want}")


def model_parallel_phase(torch, fa, fd, fo, cli, ckpt: str | None = None,
                         serving: dict | None = None) -> dict:
    """Phase 19 (``ckpt``: phase 14's HF directory; ``--phase 19`` alone
    makes its own).  ``serving``: phase 20's ``serve_mesh_prepare``, whose
    rank parts run in the same rank processes, after phase 19's (one spawn
    for both); their results land in ``serving["result"]``.  Returns rank
    0's launches of (b) and (c), summed."""
    t_phase = time.perf_counter()
    ckpt = ckpt or llama_hf_dir(torch, DIST_LAYERS)
    train_path, val_path = (os.path.join(WORK, f"mp_{x}.json") for x in ("train", "val"))
    write_instruction_records(train_path, MP_RECORDS, seed=2)
    write_instruction_records(val_path, MP_VAL_RECORDS, seed=3)
    base = [*MP_ARGS, "--model-ckpt", ckpt, "--train-file", train_path]
    t0 = time.perf_counter()
    one_run = one_rank_baseline(torch, cli, base, fresh_dir("mp-one-out"))
    one_s = time.perf_counter() - t0
    axes = (("b", "tensor"), ("c", "sequence"))
    # phase 20 (e): the tensor run's eval pass, one batch at the epoch's end
    evals = {"tensor": ["--val-file", val_path, "--eval-batch-size", str(MP_VAL_RECORDS),
                        "--num-beams", "2", "--eval-max-new-tokens", str(MP_EVAL_NEW)],
             "sequence": []}
    runs = [(axis, [*base, "--output-dir", fresh_dir(f"mp-{axis}-out"), "--mesh", f"{axis}=2",
                    "--obs-gauges", "on", *evals[axis]]) for _, axis in axes]
    t0 = time.perf_counter()
    res = dist_ranks([], 2, phase="19" if serving is None else "19-20", phase19=True,
                     runs=runs, rank0_argv=["--profile-steps",
                                            f"{MP_PROFILE_STEP}:{MP_PROFILE_STEP}"],
                     **(serving["spec"] if serving is not None else {}))
    ranks_s = time.perf_counter() - t0
    if serving is not None:
        serving["result"] = res.pop("serving")
        ranks_s -= serving["result"]["seconds"]

    # (a) ring attention alone
    ring = res["ring"]
    say({"phase": "ring_attention", "backend": "gloo", "device": "cuda:0", "ranks": 2,
         "shape": list(RING_SHAPE), "dtype": "float32", "causal": True, "padding": True,
         "rel_err": ring["rel_err"], "limit": RING_REL_LIMIT,
         "planted_block_late_rel_err": ring["planted_rel_err"],
         "ring_fwd_bwd_ms": ring["ring_ms"], "plain_fwd_bwd_ms": ring["plain_ms"],
         "hop_ms": ring["hop_ms"], "hop_ms_median": statistics.median(ring["hop_ms"]),
         "hop_bytes": ring["hop_bytes"], "peak_mem_bytes_rank0": ring["peak_mem_bytes"]})
    if not all(e <= RING_REL_LIMIT for e in ring["rel_err"].values()):
        fail(f"phase 19 (a): the ring is not within {RING_REL_LIMIT} of plain attention "
             f"({ring['rel_err']})")
    if not all(not (e <= RING_REL_LIMIT) for e in ring["planted_rel_err"].values()):
        fail(f"phase 19 (a): the planted fault (key positions a block late) stayed within the "
             f"limit ({ring['planted_rel_err']})")

    # (b), (c): the CLI under tensor=2 and sequence=2 against one rank
    launches: dict = {}
    t0 = time.perf_counter()
    exports = export_update_diffs(torch, ckpt, os.path.join(WORK, "mp-one-out", "model"),
                                  [os.path.join(WORK, f"mp-{axis}-out", "model")
                                   for _, axis in axes])
    exports_s = time.perf_counter() - t0
    for (part, axis), weights in zip(axes, exports):
        two = res[axis]
        acct = two.get("device_account") or {}
        loss_diff = max(abs(a - b) for a, b in zip(one_run["losses"], two["losses"]))
        norm_diff = max(abs(a - b) for a, b in zip(one_run["grad_norms"], two["grad_norms"]))
        worst = max(weights["rel"].values())
        say({"phase": f"model_parallel_{axis}", "backend": "gloo", "device": "cuda:0",
             "mesh": f"{axis}=2", "compute_dtype": "float32", "layers": DIST_LAYERS,
             "one_rank": one_run, "two_ranks": {k: two[k] for k in (
                 "losses", "grad_norms", "step_s", "peak_mem_bytes", "launches", "expected")},
             "loss_diff": loss_diff, "grad_norm_diff": norm_diff,
             "export_leaves": two["export_leaves"], "export_unequal": two["export_unequal"],
             "export_vs_one_rank": weights, "export_vs_one_rank_worst": worst,
             "export_limit": MP_EXPORT_REL_LIMIT, "comm": two["comm"], "device_account": acct})
        if len(two["losses"]) != MP_STEPS or len(one_run["losses"]) != MP_STEPS \
                or loss_diff > GRAD_LIMITS["loss_diff"] \
                or norm_diff > GRAD_LIMITS["grad_norm_diff"]:
            fail(f"phase 19 ({part}): {axis}=2's losses and norms are not within the BART limits "
                 f"of one rank's (loss {loss_diff}, norm {norm_diff})")
        if two["launches"] != two["expected"]:
            fail(f"phase 19 ({part}): rank 0's launches {two['launches']}, expected "
                 f"{two['expected']}")
        if two["export_unequal"] or not two["export_leaves"]:
            fail(f"phase 19 ({part}): the export differs from the gathered weights in "
                 f"{two['export_unequal'][:5]}")
        if weights["leaves"] != two["export_leaves"] or not worst <= MP_EXPORT_REL_LIMIT:
            fail(f"phase 19 ({part}): the trained weights are not within {MP_EXPORT_REL_LIMIT} "
                 f"of one rank's update ({weights['rel']})")
        if not acct:
            fail(f"phase 19 ({part}): rank 0's profiled step gave no device_account")
        for k, n in two["launches"].items():
            launches[k] = launches.get(k, 0) + n
        if axis == "tensor":
            model_parallel_eval_check(two["evals"])
            for k, n in two["evals"][0]["launches"].items():
                launches[k] = launches.get(k, 0) + n
        shutil.rmtree(os.path.join(WORK, f"mp-{axis}-out"), ignore_errors=True)
    for path in (ckpt, os.path.join(WORK, "mp-one-out")):
        shutil.rmtree(path, ignore_errors=True)
    say({"phase": "model_parallel_wall", "seconds": time.perf_counter() - t_phase,
         "one_rank_s": one_s, "ranks_s": ranks_s, "export_compare_s": exports_s})
    return launches


# phase 15: elastic fine-tuning at bart-large-cnn's published widths (d_model
# 1024, 16 heads, FFN 4096, its vocabulary) cut to 1 + 1 of its 12 + 12
# layers (2 + 2 until phase 16 joined the run), its residual dropout 0.1 (kernel 7 on the path) and attention
# dropout 0; 48 records (6 steps), a save every 2 steps, the host lost after
# step 3 (so step 2 is restored and step 3 replayed: 7 steps launched)
ELASTIC_LAYERS = 1
ELASTIC_SAVE_EVERY = 2
ELASTIC_HOST_LOSS_AT = 3
ELASTIC_ARGS = [
    "--tokenizer", "byte", "--batch-size", "8", "--num-epochs", "1",
    "--max-source-length", "1024", "--max-target-length", "128", "--compute-dtype", "bfloat16",
    "--learning-rate", "1e-4", "--warmup-steps", "0", "--seed", "0", "--evaluation-steps", "0",
    "--save-every-steps", str(ELASTIC_SAVE_EVERY), "--obs", "jsonl", "--obs-budget", "on",
]
ELASTIC_CHAOS = ["--chaos", f"host_loss@{ELASTIC_HOST_LOSS_AT}"]
# (a)'s log cadence: steps 1, 3 and 5 are off it, so a telemetry sync there
# would show in the sync count
ELASTIC_LOG_EVERY = 2
# the oracles resume from a linked step and save only at their end: the
# machine's disk counts every byte written
ORACLE_SAVES = ["--save-every-steps", "0"]
# phases 5 and 13: the sink, the budget, the health numerics as before (off)
BUDGET_ARGS = ["--obs", "jsonl", "--obs-budget", "on", "--health", "off"]


def obs_events(out_dir: str, rank: int = 0) -> list[dict]:
    with open(os.path.join(out_dir, "obs", f"metrics-p{rank:03d}.jsonl")) as f:
        return [json.loads(line) for line in f]


def budget_account(run: str, out_dir: str) -> dict:
    """A run's last ``step_budget`` account on a line of its own (the six
    components in ms, the efficiency, the tripwire's count) and the stdout
    sink back in place of the run's."""
    from distributed_llms_example_tpu_torch.obs import sink
    from distributed_llms_example_tpu_torch.obs.budget import COMPONENTS

    sink.install_sink(sink.build_sink("stdout", ""))
    accounts = [e for e in obs_events(out_dir) if e.get("event") == "step_budget"]
    if not accounts:
        fail(f"{run}: no step_budget account under {out_dir}/obs")
    last = accounts[-1]
    line = {"phase": "step_budget", "run": run, "step": last["step"],
            "window_steps": last["window_steps"], "wall_ms": last["wall_ms"],
            **{f"{c}_ms": last[f"{c}_ms"] for c in COMPONENTS},
            "dispatch_efficiency": last["dispatch_efficiency"],
            "offcadence_sync_steps": last["offcadence_sync_steps"],
            "offcadence_sync_suspect": last["offcadence_sync_suspect"],
            "accounts": len(accounts),
            "offcadence_sync_steps_all": [a["offcadence_sync_steps"] for a in accounts],
            "dispatch_efficiency_all": [a["dispatch_efficiency"] for a in accounts]}
    say(line)
    return line


def bart_hf_dir(torch, layers: int) -> str:
    """<WORK>/bart-large-cnn-<layers>l-hf: bart-large-cnn's config at
    ``layers`` + ``layers`` layers and seed-0 random fp32 weights, written by
    the port's HF export (a link to phase 5's 12 + 12-layer weights would not
    load: the loader is strict)."""
    import dataclasses

    from distributed_llms_example_tpu_torch.models.bart import BartForConditionalGeneration
    from distributed_llms_example_tpu_torch.models.export import save_hf_checkpoint
    from distributed_llms_example_tpu_torch.models.registry import BART_CONFIGS

    path = fresh_dir(f"bart-large-cnn-{layers}l-hf")
    cfg = dataclasses.replace(BART_CONFIGS["bart-large-cnn"], encoder_layers=layers,
                              decoder_layers=layers)
    model = BartForConditionalGeneration(cfg, dtype=torch.float32, param_dtype=torch.float32,
                                         device="cuda")
    model.init_weights(torch.Generator(device="cuda").manual_seed(0))
    save_hf_checkpoint(path, "bart", cfg, model.state_dict())
    del model
    free_cuda()
    return path


def step_copy(out_dir: str, name: str, step: int) -> str:
    """<WORK>/<name>/checkpoints holding step ``step`` of ``out_dir``'s run
    (its files hard-linked: nothing written) and its two sidecars: a run
    there resumes from that step."""
    src, dst = os.path.join(out_dir, "checkpoints"), os.path.join(fresh_dir(name), "checkpoints")
    shutil.copytree(os.path.join(src, str(step)), os.path.join(dst, str(step)),
                    copy_function=os.link)
    for side in (f"integrity-{step}.json", f"recovery-{step}.json"):
        shutil.copy(os.path.join(src, side), os.path.join(dst, side))
    return os.path.dirname(dst)


def host_loss_events(name: str, events: list[dict]) -> dict:
    """The run's chaos, topology and reshard lines: exactly one of each, the
    reshard restoring the last save before the loss and replaying what
    followed it."""
    def named(kind):
        return [e for e in events if e.get("event") == kind]

    chaos, topo, reshard = named("chaos_injection"), named("topology_change"), \
        named("reshard_restore")
    want = (ELASTIC_SAVE_EVERY, ELASTIC_HOST_LOSS_AT, ELASTIC_HOST_LOSS_AT - ELASTIC_SAVE_EVERY)
    if [(e["kind"], e["step"]) for e in chaos] != [("host_loss", ELASTIC_HOST_LOSS_AT)] \
            or [e["policy"] for e in topo] != ["reshard"] or len(reshard) != 1 \
            or (reshard[0]["step"], reshard[0]["detected_at_step"],
                reshard[0]["steps_lost"]) != want:
        fail(f"phase 15 ({name}): chaos {chaos}, topology {topo}, reshard {reshard}")
    return reshard[0]


def elastic_phase(torch, fa, fd, fo, cli) -> dict:
    """Phase 15.  Returns the launches of the two host-loss runs ((a), and
    (b)'s rank 0)."""
    import contextlib as ctx
    import io

    from distributed_llms_example_tpu_torch.core import mesh
    from distributed_llms_example_tpu_torch.obs import report, sink
    from distributed_llms_example_tpu_torch.obs.budget import sync_device

    t_phase = time.perf_counter()
    ckpt = bart_hf_dir(torch, ELASTIC_LAYERS)
    path = os.path.join(WORK, "elastic_train.json")
    write_train_records(path, seed=15)
    base = [*ELASTIC_ARGS, "--model-ckpt", ckpt, "--train-file", path]

    # (a) a world-1 NCCL group: the trainer keeps it through the host loss
    out_a = fresh_dir("elastic-a-out")
    torch.distributed.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{free_port()}",
                                         world_size=1, rank=0)
    try:
        gen0 = mesh.generation()
        zero_counters(fa, fd, fo)
        syncs0 = sync_device.syncs
        t0 = time.perf_counter()
        run = cli.train([*base, "--output-dir", out_a, "--log-every-steps",
                         str(ELASTIC_LOG_EVERY), *ELASTIC_CHAOS])
        torch.cuda.synchronize()
        wall_a = time.perf_counter() - t0
        syncs = sync_device.syncs - syncs0
        launches = read_counters(fa, fd, fo)
        want = expected_train_launches(run.model, len(run.history) + 1)  # the replayed step
        kept = mesh.generation() == gen0 and torch.distributed.get_backend() == "nccl"
        events = obs_events(out_a)
        reshard = host_loss_events("a", events)
        rng = run.recovery.snapshot_for(ELASTIC_SAVE_EVERY)["rng"]
        losses = [float(m["loss"]) for m in run.history]
        result = {k: v for k, v in run.result.items() if k != "final_eval"}
        state = {k: v.clone() for k, v in run.state_tensors().items()}
        del run
        free_cuda()
        # the oracle: a clean run resumed from the same step-2 checkpoint with
        # that save's dropout stream
        out_ac = step_copy(out_a, "elastic-a-clean-out", ELASTIC_SAVE_EVERY)
        with trainer_hooks(torch, rng_state=rng.tolist()):
            clean = cli.train([*base, "--output-dir", out_ac, "--log-every-steps",
                               str(ELASTIC_LOG_EVERY), *ORACLE_SAVES])
        torch.cuda.synchronize()
        clean_losses = [float(m["loss"]) for m in clean.history]
        cstate = clean.state_tensors()
        unequal = [k for k in state if not torch.equal(state[k], cstate[k])]
        state_names = sorted(state)
        del clean, cstate, state
        free_cuda()
        for d in (os.path.join(out_a, "checkpoints"), os.path.join(out_a, "model"), out_ac):
            shutil.rmtree(d, ignore_errors=True)
        # the group torn down and re-created by reinitialize_distributed, and
        # an all-reduce over it
        t1 = time.perf_counter()
        world = mesh.reinitialize_distributed(f"127.0.0.1:{free_port()}", 1, 0)
        x = torch.full((1 << 20,), 3.0, device="cuda")
        torch.distributed.all_reduce(x)
        torch.cuda.synchronize()
        reinit_s = time.perf_counter() - t1
        recreated = (world == 1 and mesh.generation() == gen0 + 1
                     and torch.distributed.get_backend() == "nccl" and bool((x == 3.0).all()))
    finally:
        torch.distributed.destroy_process_group()
    windows = [e for e in events if e.get("event") == "step_budget"]
    say({"phase": "elastic_world1", "backend": "nccl", "layers": ELASTIC_LAYERS,
         "result": result, "wall_s": wall_a, "losses": losses,
         "clean_resume_losses": clean_losses, "state_tensors": len(state_names),
         "unequal": unequal[:5], "reshard_restore": reshard, "group_kept": kept,
         "launches": launches, "expected": want, "telemetry_syncs": syncs,
         "log_windows": len(windows), "reinit_s": reinit_s, "group_recreated": recreated})
    if result.get("steps") != 6 or "anomaly" in result or len(losses) != 6:
        fail(f"phase 15 (a): the host-loss run ended {result} with {len(losses)} steps")
    if losses[ELASTIC_SAVE_EVERY:] != clean_losses or unequal:
        fail(f"phase 15 (a): the replay differs from a clean resume from step "
             f"{ELASTIC_SAVE_EVERY} (losses {losses[ELASTIC_SAVE_EVERY:]} vs {clean_losses}, "
             f"state {unequal[:5]})")
    required = ("flash_attention_fwd", "flash_attention_bwd_dq", "flash_attention_bwd_dkv",
                "fused_dropout", "fused_adamw", "fused_grad_prep")
    if launches != want or any(want[k] == 0 for k in required):
        fail(f"phase 15 (a): launches {launches}, expected {want} (the replayed step included)")
    if not kept or not recreated:
        fail(f"phase 15 (a): the world-1 group kept by the trainer {kept}, torn down and "
             f"re-created by reinitialize_distributed {recreated}")
    # (d) the telemetry waited on the card at the log cadence only
    if syncs != len(windows) or len(windows) != 6 // ELASTIC_LOG_EVERY:
        fail(f"phase 15 (d): {syncs} telemetry syncs over {len(windows)} log windows")

    # (b) two gloo ranks on cuda:0: data=2, rebuilt on fsdp=2 over a
    # re-created group; then the oracle, a clean fsdp=2 run from the same
    # step-2 checkpoint with that save's dropout stream
    out_b = fresh_dir("elastic-b-out")
    t0 = time.perf_counter()
    two = dist_ranks([*base, "--output-dir", out_b, "--mesh", "data=2", "--log-every-steps", "1",
                      "--obs-heartbeat-steps", "1", *ELASTIC_CHAOS], 2, phase="15 (b)",
                     next_mesh=[1, 2], steps_run=7, sharded_steps=4)
    wall_b = time.perf_counter() - t0
    out_bc = step_copy(out_b, "elastic-b-clean-out", ELASTIC_SAVE_EVERY)
    clean_b = dist_ranks([*base, "--output-dir", out_bc, "--mesh", "fsdp=2", "--log-every-steps",
                          "1", *ORACLE_SAVES], 2, phase="15 (b) oracle",
                         rng_state=two["rng_state"], steps_run=4, sharded_steps=4)
    events_b = obs_events(out_b)
    reshard_b = host_loss_events("b", events_b)
    beats = [e for e in events_b if e.get("event") == "heartbeat"]
    exported = [open(os.path.join(d, "model", "model.safetensors"), "rb").read()
                for d in (out_b, out_bc)]
    for d in (os.path.join(out_b, "checkpoints"), os.path.join(out_b, "model"), out_bc):
        shutil.rmtree(d, ignore_errors=True)
    say({"phase": "elastic_two_ranks", "backend": "gloo", "device": "cuda:0",
         "mesh": "data=2 -> fsdp=2", "result": two["result"], "ended_on": two["mesh"],
         "losses": two["losses"], "clean_resume_losses": clean_b["losses"],
         "exports_bit_equal": exported[0] == exported[1], "reshard_restore": reshard_b,
         "heartbeats": [(b["step"], b["skew_steps"], b["process_count"]) for b in beats],
         "launches": two["launches"], "expected": two["expected"], "wall_s": wall_b})
    if two["mesh"] != [1, 2] or two["result"].get("steps") != 6 or "anomaly" in two["result"]:
        fail(f"phase 15 (b): ended {two['result']} on {two['mesh']}")
    if two["losses"][ELASTIC_SAVE_EVERY:] != clean_b["losses"] or exported[0] != exported[1]:
        fail("phase 15 (b): the two ranks' replay differs from a clean fsdp=2 resume")
    if not beats or any(b["skew_steps"] or b["process_count"] != 2 for b in beats):
        fail(f"phase 15 (b): heartbeats {beats}")
    if two["launches"] != two["expected"] or clean_b["launches"] != clean_b["expected"]:
        fail(f"phase 15 (b): launches {two['launches']} vs {two['expected']}, the oracle's "
             f"{clean_b['launches']} vs {clean_b['expected']}")

    # (c) the port's obs.report on both output directories
    for name, out_dir in (("a", out_a), ("b", out_b)):
        rep = report.build_report(out_dir)
        with ctx.redirect_stdout(io.StringIO()):
            rc = report.main([out_dir, "--strict"])
        rec = rep["recovery"]
        say({"phase": "elastic_report", "run": name, "topology": rec["topology"],
             "reshards": rec["reshards"], "mttr_s": rec["mttr_s"],
             "organic_faults": rec["organic_faults"], "strict_rc": rc,
             "dispatch_efficiency": (rep["budget"] or {}).get("dispatch_efficiency"),
             "stragglers": rep["stragglers"]})
        if len(rec["topology"]) != 1 or len(rec["reshards"]) != 1 or not rec["mttr_s"] \
                or rec["organic_faults"] or rc != 0:
            fail(f"phase 15 (c): obs.report on ({name}): {rec}, --strict {rc}")
    sink.install_sink(sink.build_sink("stdout", ""))
    for d in (out_a, out_b):
        shutil.rmtree(d, ignore_errors=True)
    oom_postmortem_phase(torch, cli, base)
    say({"phase": "elastic", "phase_s": time.perf_counter() - t_phase})
    shutil.rmtree(ckpt, ignore_errors=True)
    return {k: launches[k] + two["launches"][k] for k in launches}


# phase 15e: the OOM postmortem, injected before this step
OOM_AT = 3


def oom_postmortem_phase(torch, cli, base: list[str]) -> None:
    """Phase 15e: phase 15's BART (1 + 1 layers) through the CLI with
    ``--chaos oom@OOM_AT``: the run raises the injected out-of-memory error,
    which ``is_resource_exhausted`` accepts, and leaves exactly one
    parseable ``memory-postmortem-p000.json`` carrying the memory account
    and the memory windows of the steps before it; obs.report renders its
    memory section; and an oversize ``torch.empty`` on the card raises an
    error ``is_resource_exhausted`` accepts."""
    import contextlib as ctx
    import glob
    import io

    from distributed_llms_example_tpu_torch.obs import report, sink
    from distributed_llms_example_tpu_torch.obs.memprof import is_resource_exhausted

    t0 = time.perf_counter()
    out = fresh_dir("oom-out")
    try:
        cli.train([*base, "--output-dir", out, "--log-every-steps", "1", "--obs-gauges", "on",
                   "--chaos", f"oom@{OOM_AT}"])
    except RuntimeError as e:
        error = e.with_traceback(None)  # its frames hold the trainer's tensors
    else:
        fail(f"phase 15e: the run with --chaos oom@{OOM_AT} ended without an error")
    sink.install_sink(sink.build_sink("stdout", ""))
    torch.cuda.synchronize()
    free_cuda()
    bundles = sorted(glob.glob(os.path.join(out, "obs", "memory-postmortem-p*.json")))
    bundle = {}
    if bundles:
        with open(bundles[0]) as f:
            bundle = json.load(f)
    history = [w["step"] for w in bundle.get("watermark_history", [])]
    account = bundle.get("account") or {}
    rep = report.build_report(out)
    with ctx.redirect_stdout(io.StringIO()) as md:
        report.main([out])
    text = md.getvalue()
    try:
        torch.empty(1 << 40, dtype=torch.uint8, device="cuda")
        oversize = None
    except RuntimeError as e:
        oversize = e
    free_cuda()
    say({"phase": "oom_postmortem", "error": str(error)[:160],
         "recognized": is_resource_exhausted(error),
         "bundles": [os.path.basename(b) for b in bundles], "bundle_step": bundle.get("step"),
         "watermark_steps": history, "account_buckets": account.get("buckets_bytes"),
         "account_measured": account.get("measured"),
         "live_buffers_top": len(bundle.get("live_buffers_top") or []),
         "report_postmortems": (rep.get("memory") or {}).get("postmortems"),
         "report_memory_section": "## Where did the bytes go" in text and "OOM postmortem" in text,
         "oversize_empty": f"{type(oversize).__name__}: {str(oversize)[:120]}",
         "oversize_recognized": oversize is not None and is_resource_exhausted(oversize),
         "phase_s": time.perf_counter() - t0})
    if not is_resource_exhausted(error) or f"before step {OOM_AT}" not in str(error):
        fail(f"phase 15e: the run raised {error!r}, not the injected out-of-memory error")
    if [os.path.basename(b) for b in bundles] != ["memory-postmortem-p000.json"] \
            or bundle.get("event") != "memory_postmortem" or not account.get("buckets_bytes") \
            or history != list(range(1, OOM_AT)):
        fail(f"phase 15e: postmortems {bundles}: step {bundle.get('step')}, watermark steps "
             f"{history}, account {account.get('buckets_bytes')}")
    if "0" not in ((rep.get("memory") or {}).get("postmortems") or {}) \
            or "OOM postmortem" not in text:
        fail(f"phase 15e: obs.report's memory section {rep.get('memory')}")
    if oversize is None or not is_resource_exhausted(oversize):
        fail(f"phase 15e: an oversize torch.empty raised {oversize!r}")
    shutil.rmtree(out, ignore_errors=True)


# phase 16: the JAX engine's serving features at llama-2-7b's full width
# (6.74 B parameters, bf16, seed 0, byte tokenizer), one loaded model for
# every run: (a) the int8 KV cache paged and flat, (b) n-gram speculative
# decode and (c) a 2-layer llama-2-7b-width draft model, both paged, each
# against the plain paged run on the same prompts; (d) the prefix cache
# over multi-turn prompts against the same prompts cold; (e) a real CUDA
# out-of-memory error in a session's step with --postmortem-dir
SERVE16_ARGS = ["--model-ckpt", "llama-2-7b", "--num-prompts", "8", "--max-slots", "8",
                "--max-new-tokens", "64",
                "--max-source-length", "1024", "--kv-block-size", "64", "--compute-dtype",
                "bfloat16", "--seed", "0", "--log-every-steps", "0", "--lint", "off"]
SPEC_K = 3
# run (d): one 512-token system prefix, 64-256-token tails, 16 requests,
# 64 new tokens, pool blocks of 64 slots (768 + 64 = 13 blocks a row; 128
# new tokens in blocks of 128 until phase 20 joined the run: its cut); a
# 256 bucket, so that a warm tail is prefilled at 256 rows, not at the
# prompt width
PREFIX16_ARGS = ["--model-ckpt", "llama-2-7b", "--max-slots", "8", "--max-new-tokens", "64",
                 "--max-source-length", "768", "--kv-block-size", "64", "--compute-dtype",
                 "bfloat16", "--seed", "0", "--log-every-steps", "0", "--lint", "off",
                 "--paged-kv", "--prefill-buckets", "256"]
PREFIX16_SYS, PREFIX16_TAILS = 512, (64, 256)
# a divergence from the plain run is rounding when the other run's token
# there lies within this many times the phase's own route floor of the
# plain run's top logit: each of the two tokens' logits may move by the
# floor between the two runs, and again between the plain run and the
# teacher-forced pass that reads its logits
ROUTE_FLOOR_FACTOR = 4


def write_prefix_prompts(path: str, n: int = 16) -> None:
    """Run (d)'s prompts: one 512-byte system prefix, then a 64-256-byte
    tail each (byte tokenizer: a byte a token, no eos)."""
    import numpy as np

    rng = np.random.RandomState(16)
    alphabet = np.array(list("abcdefghijklmnopqrstuvwxyz      .,"))
    head = "".join(rng.choice(alphabet, PREFIX16_SYS))
    texts = [head + "".join(rng.choice(alphabet, rng.randint(PREFIX16_TAILS[0],
                                                             PREFIX16_TAILS[1] + 1)))
             for _ in range(n)]
    with open(path, "w") as f:
        json.dump(texts, f)


def draft_hf_dir(torch) -> str:
    """Run (c)'s draft: llama-2-7b's widths at 2 layers (phase 14's
    directory when it is there)."""
    path = os.path.join(WORK, "llama-2-7b-2l-hf")
    if os.path.exists(os.path.join(path, "config.json")):
        return path
    return llama_hf_dir(torch, 2)


def round_host_traffic(torch, engine, reqs: list[list[int]], n: int = 2) -> dict:
    """What ``n`` steady rounds of a fresh session on the served engine
    read back from the card, per round, from a torch.profiler trace: the
    CUDA runtime's device syncs inside the rounds by name (a blocking copy
    either way waits in cudaStreamSynchronize), the device-to-host copies,
    and the scalar reads (``aten::_local_scalar_dense``)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    sess = engine.open()
    for r in reqs:
        sess.submit(r)
    for _ in range(2):  # the admission (the draft's prefill too) and the first two rounds
        sess.step()
    torch.cuda.synchronize()
    steps = sess.stats.decode_steps
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function("smoke/rounds"):
            for _ in range(n):
                sess.step()
    torch.cuda.synchronize()
    events = prof.events()
    win = next(e.time_range for e in events if e.name == "smoke/rounds")
    inside = [e for e in events if win.start <= e.time_range.start <= win.end]
    syncs: dict[str, float] = {}
    copies: dict[str, float] = {}
    for e in events:
        if e.name.startswith("Memcpy"):
            copies[e.name] = copies.get(e.name, 0) + 1 / n
    for e in inside:
        if "Synchronize" not in e.name:
            continue
        # the ops open around the sync on its thread, innermost last
        t = e.time_range
        ops = sorted((o for o in inside if o.thread == e.thread and o is not e
                      and not o.name.startswith("cuda") and o.time_range.start <= t.start
                      and o.time_range.end >= t.end), key=lambda o: o.time_range.start)
        key = " > ".join([o.name[:40] for o in ops][-5:] + [e.name])
        syncs[key] = syncs.get(key, 0) + 1 / n
    return {"rounds": sess.stats.decode_steps - steps,
            "runtime_calls": sum(e.name.startswith("cuda") for e in inside),
            "syncs_per_round": syncs, "copies_per_round": copies,
            "dtoh_copies_per_round": sum(v for k, v in copies.items() if "DtoH" in k),
            "scalar_reads_per_round": sum(e.name == "aten::_local_scalar_dense"
                                          for e in inside) / n}


def serve16(torch, fa, cli, lm, name: str, argv: list[str], prompts: str, *,
            reads: list[list[int]] | None = None) -> dict:
    """One run of the CLI's serve entry on the loaded model: launches of
    kernels 1, 5 and 6 held to the counts the engine's ledger and the
    layer counts give, the pool drained with exact refcounts; with
    ``reads`` (the run's prompts), a fresh session's steady rounds read
    back one copy of their tokens each, behind one device sync
    (``round_host_traffic``)."""
    from distributed_llms_example_tpu_torch.ops.mha import MultiHeadAttention

    out = os.path.join(WORK, f"serve16_{name}.jsonl")
    fa.flash_attention.launches = fa.flash_decode.launches = 0
    fa.flash_decode_paged.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    engine, outs = cli.serve([*argv, "--prompts-file", prompts, "--output-file", out],
                             loaded=lm)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"flash_attention_fwd": fa.flash_attention.launches,
                "flash_decode": fa.flash_decode.launches,
                "flash_decode_paged": fa.flash_decode_paged.launches}
    st = engine.last_stats
    layers = sum(isinstance(m, MultiHeadAttention) for m in engine.model.modules())
    # kernel 1: a layer's prompt prefill from cache slot 0 per cold chunk
    # (not into an int8 cache: those prompts take the plain path, wider
    # than 8 rows); kernel 6 (paged) or 5 (flat): a layer per decode round
    # or verify round (at Q = k + 1); warm tails wider than 8 rows take the
    # plain path; a draft model: a layer per prompt chunk (kernel 1) and
    # per catch-up pass and draft step (kernel 5)
    int8 = engine.kv_dtype == "int8"
    steps = layers * st.decode_steps
    want = {"flash_attention_fwd": 0 if int8 else layers * st.prefill_calls,
            "flash_decode": 0 if engine.paged else steps,
            "flash_decode_paged": steps if engine.paged else 0}
    drafter = engine.drafter
    if drafter is not None:
        dl = sum(isinstance(m, MultiHeadAttention) for m in drafter.model.modules())
        want["flash_attention_fwd"] += dl * drafter.prefill_calls
        want["flash_decode"] += dl * drafter.rounds * engine.spec
    p50, p95 = st.ttft_percentiles()
    line = {"phase": f"serve16_{name}", "wall_s": wall, "attention_modules": layers,
            "kv_cache_dtype": engine.kv_dtype, "paged": engine.paged,
            "decode_steps": st.decode_steps, "prefill_calls": st.prefill_calls,
            "warm_admit_calls": st.warm_admit_calls, "launches": launches, "expected": want,
            "decode_tokens": st.decode_tokens, "decode_tokens_per_sec": st.tokens_per_sec(),
            "ttft_p50_ms": p50 * 1e3, "ttft_p95_ms": p95 * 1e3, **st.ttft_decomposition(),
            "prefill_seconds": st.prefill_seconds, "decode_seconds": st.decode_seconds,
            "cache_bytes_resident": st.cache_bytes_resident,
            "bytes_per_live_token": st.bytes_per_live_token,
            "peak_mem_bytes": torch.cuda.max_memory_allocated()}
    if engine.paged:
        line.update(pool_blocks=engine.pool.num_blocks, kv_block_size=engine.block_size,
                    blocks_in_use_at_end=engine.pool.blocks_in_use,
                    ref_violations=engine.pool.ref_invariant_violations([]),
                    admit_deferrals=st.admit_deferrals)
    if engine.prefix:
        line.update(prefix_lookups=st.prefix_lookups, prefix_hits=st.prefix_hits,
                    prefill_tokens_total=st.prefill_tokens_total,
                    prefill_tokens_saved=st.prefill_tokens_saved,
                    pool_blocks_warm=engine.pool.blocks_warm)
    if engine.spec:
        line.update(spec_steps=st.spec_steps, spec_slot_rounds=st.spec_slot_rounds,
                    spec_drafted=st.spec_drafted, spec_accepted=st.spec_accepted,
                    spec_emitted=st.spec_emitted,
                    accepted_tokens_per_step=st.spec_emitted / max(st.spec_slot_rounds, 1),
                    acceptance_rate=st.spec_accepted / max(st.spec_drafted, 1),
                    draft_rounds=drafter.rounds if drafter else None)
    say(line)
    if launches != want or st.decode_steps == 0 or len(outs) != st.sequences:
        fail(f"serve16 {name}: launches {launches} vs {want}, {st.decode_steps} decode rounds")
    if engine.paged and (engine.pool.blocks_in_use or line["ref_violations"]):
        fail(f"serve16 {name}: {engine.pool.blocks_in_use} blocks left in use, "
             f"{line['ref_violations']}")
    if engine.spec and st.spec_emitted != st.decode_tokens:
        fail(f"serve16 {name}: spec_emitted {st.spec_emitted} != decode_tokens {st.decode_tokens}")
    if reads is not None:
        traffic = round_host_traffic(torch, engine, reads)
        say({"phase": f"serve16_{name}_round_host_traffic", **traffic})
        if traffic["rounds"] != 2 or not traffic["runtime_calls"] \
                or sum(traffic["syncs_per_round"].values()) != 1 \
                or traffic["dtoh_copies_per_round"] != 1 or traffic["scalar_reads_per_round"]:
            fail(f"serve16 {name}: a steady round reads back more than its tokens, behind "
                 f"more than one device sync: {traffic}")
    # no free_cuda() between the runs: the next run reuses the allocator's
    # cached blocks (a collection and an empty cache a run cost seconds)
    del engine
    return {"outs": outs, "stats": st, "launches": launches, "line": line}


def divergences(plain: list[list[int]], other: list[list[int]]) -> list[tuple[int, int]]:
    """(request, token index) of each request's first token that differs
    from the plain run's (a length difference counts at the shorter
    end)."""
    out = []
    for i, (a, b) in enumerate(zip(plain, other)):
        j = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y), None)
        if j is None and len(a) != len(b):
            j = min(len(a), len(b))
        if j is not None:
            out.append((i, j))
    return out


def padded_batch(torch, seqs: list[list[int]], dev):
    """Right-padded (ids, mask) of token sequences on ``dev``."""
    width = max(len(s) for s in seqs)
    ids = torch.zeros((len(seqs), width), dtype=torch.long, device=dev)
    mask = torch.zeros((len(seqs), width), dtype=torch.int32, device=dev)
    for r, s in enumerate(seqs):
        ids[r, : len(s)] = torch.as_tensor(s, device=dev)
        mask[r, : len(s)] = 1
    return ids, mask


def logit_gaps(torch, model, prompts: list[list[int]], plain: list[list[int]],
               other: list[list[int]], where: list[tuple[int, int]]) -> list[list[float]]:
    """At each divergence, the plain run's logits read by a teacher-forced
    prefill of the prompt and the plain run's tokens before it (kernel 1,
    one pass): [its top-2 gap, its gap from the top to the other run's
    token there] (the latter the top-2 gap where the other run has no
    token there)."""
    from distributed_llms_example_tpu_torch.evaluation.generation import causal_prefill

    if not where:
        return []
    ids, mask = padded_batch(torch, [prompts[i] + plain[i][:j] for i, j in where],
                             next(model.parameters()).device)
    with torch.inference_mode():
        _, _, _, first = causal_prefill(model, ids, mask, 1)
    first = first.float()
    top = first.topk(2, dim=-1).values
    out = []
    for r, (i, j) in enumerate(where):
        top2 = float(top[r, 0] - top[r, 1])
        to_other = float(top[r, 0] - first[r, other[i][j]]) if j < len(other[i]) else top2
        out.append([top2, to_other])
    return out


def route_floor(torch, model, prompts: list[list[int]]) -> dict:
    """The logit noise between routes that compute the same function on
    this model in bf16: (i) a verify block of k + 1 rows (kernel 5 at Q = 4)
    against k + 1 single-row decode steps (Q = 1) over the same prefilled
    cache; (ii) those decode steps against the teacher-forced prefill of
    the same tokens (kernel 1).  The largest |Δ logit| of each."""
    from distributed_llms_example_tpu_torch.evaluation.generation import causal_prefill
    from distributed_llms_example_tpu_torch.ops.mha import KVCache

    dev = next(model.parameters()).device
    rows = prompts[:8]
    ids, mask = padded_batch(torch, rows, dev)
    P = ids.shape[1]
    K1 = SPEC_K + 1
    x = torch.randint(4, 120, (len(rows), K1), device=dev,
                      generator=torch.Generator(device=dev).manual_seed(3))
    with torch.inference_mode():
        cache, full_mask, lengths, _ = causal_prefill(model, ids, mask, K1)
        offs = torch.full((len(rows),), P, dtype=torch.int32, device=dev)
        fm = full_mask.clone()
        fm[:, P:] = 1
        block = model(x, fm, positions=lengths.long()[:, None] + torch.arange(K1, device=dev),
                      cache=[KVCache(c.k.clone(), c.v.clone()) for c in cache],
                      cache_positions=offs).float()
        singles = []
        for j in range(K1):
            m = full_mask.clone()
            m[:, P:P + j + 1] = 1
            singles.append(model(x[:, j:j + 1], m, positions=(lengths.long() + j)[:, None],
                                 cache=cache, cache_positions=offs + j)[:, 0].float())
        singles = torch.stack(singles, 1)
        # (ii): the prefill of prompt + x[:, :j+1] reads row j's logits
        # at its last position
        forced = [causal_prefill(model, *padded_batch(
            torch, [list(r) + x[b, : j + 1].tolist() for b, r in enumerate(rows)], dev), 1)[3]
            .float() for j in range(K1)]
        forced = torch.stack(forced, 1)
    out = {"verify_vs_steps": float((block - singles).abs().max()),
           "steps_vs_prefill": float((singles - forced).abs().max()),
           "max_abs_logit": float(singles.abs().max())}
    out["floor"] = max(out["verify_vs_steps"], out["steps_vs_prefill"])
    return out


def end_to_end_check(torch, lm, name: str, prompts: list[list[int]], plain: list[list[int]],
                     other: list[list[int]], floor: float) -> dict:
    """The serving features' end-to-end check: each request's tokens equal
    the plain run's up to its first divergence, where the other run's
    token lies within ROUTE_FLOOR_FACTOR × the route floor of the plain
    run's top logit (so the plain run's top-2 gap does too): a token a
    rounding of the same logits could have picked.  Each divergence is
    [request, token, top-2 gap, gap to the other run's token]."""
    where = divergences(plain, other)
    gaps = logit_gaps(torch, lm.module, prompts, plain, other, where)
    limit = ROUTE_FLOOR_FACTOR * floor
    same = sum(x == y for a, b in zip(plain, other) for x, y in zip(a, b))
    total = sum(max(len(a), len(b)) for a, b in zip(plain, other))
    rows = [[i, j, *g] for (i, j), g in zip(where, gaps)]
    return {"run": name, "token_match_rate": same / max(total, 1), "positions": total,
            "requests_equal": len(plain) - len(where), "divergences": rows,
            "gap_limit": limit, "unexplained": [r for r in rows if r[3] > limit]}


def verify_kernel_phase(torch, fa) -> dict:
    """Kernels 5 and 6 at the verify shape (Q = k + 1 = 4) and in their int8
    branch, at the llama-2-7b step's shape (``paged_case``): each row of a
    Q = 4 launch bit-equal to a Q = 1 launch at that row's offset over the
    same cache, bf16, fp32 and int8; then times at Q = 4 (bf16) and int8
    Q = 1, each beside the plain version and SDPA on the same (dequantized,
    bf16) K/V, with the bound.  Returns {kernel: {"verify_q4": numbers,
    "int8": numbers}}."""
    from functools import partial

    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(16)
    equal = {}
    for dtype, int8 in ((torch.bfloat16, False), (torch.float32, False), (torch.bfloat16, True)):
        q, kp, vp, bt, off, bias, _ = paged_case(torch, fa, dtype=dtype, Q=SPEC_K + 1, gen=gen)
        s6, s5 = {}, {}
        if int8:
            (kp, ks), (vp, vs) = fa.quantize_kv(kp), fa.quantize_kv(vp)
            s6 = dict(k_scale_pool=ks, v_scale_pool=vs)
            s5 = dict(k_scale=fa.gather_blocks(ks, bt), v_scale=fa.gather_blocks(vs, bt))
        vk, vv = fa.gather_blocks(kp, bt), fa.gather_blocks(vp, bt)
        o6 = fa.flash_decode_paged(q, kp, vp, bias, block_tables=bt, offsets=off, **s6)
        o5 = fa.flash_decode(q, vk, vv, bias, offsets=off, **s5)
        for r in range(SPEC_K + 1):
            qr = q[:, :, r:r + 1].contiguous()
            r6 = fa.flash_decode_paged(qr, kp, vp, bias, block_tables=bt, offsets=off + r, **s6)
            r5 = fa.flash_decode(qr, vk, vv, bias, offsets=off + r, **s5)
            name = f"{'int8' if int8 else dtype} row {r}"
            equal[f"kernel6 {name}"] = bool(torch.equal(o6[:, :, r], r6[:, :, 0]))
            equal[f"kernel5 {name}"] = bool(torch.equal(o5[:, :, r], r5[:, :, 0]))
    say({"phase": "verify_rows_vs_single_rows", "bit_equal": equal})
    if not all(equal.values()):
        fail(f"a Q = {SPEC_K + 1} decode launch differs from Q = 1 launches at its rows' "
             f"offsets: {[k for k, v in equal.items() if not v]}")
    out: dict[str, dict] = {"flash_decode": {}, "flash_decode_paged": {}}
    timed = []
    for what, Q, int8 in (("verify_q4", SPEC_K + 1, False), ("int8", 1, True)):
        q, kp, vp, bt, off, bias, _ = paged_case(torch, fa, dtype=torch.bfloat16, Q=Q, gen=gen)
        s6, s5, esz = {}, {}, 2
        if int8:
            (kp, ks), (vp, vs) = fa.quantize_kv(kp), fa.quantize_kv(vp)
            s6 = dict(k_scale_pool=ks, v_scale_pool=vs)
            s5 = dict(k_scale=fa.gather_blocks(ks, bt), v_scale=fa.gather_blocks(vs, bt))
            esz = 1
        vk, vv = fa.gather_blocks(kp, bt), fa.gather_blocks(vp, bt)
        dk = fa.dequantize_kv(vk, s5["k_scale"]).to(torch.bfloat16) if int8 else vk
        dv = fa.dequantize_kv(vv, s5["v_scale"]).to(torch.bfloat16) if int8 else vv
        row = torch.arange(Q, device="cuda")[None, None, :, None]
        k_pos = torch.arange(vk.shape[2], device="cuda")[None, None, None, :]
        sdpa_mask = (bias > -1) & (k_pos <= off[:, None, None, None] + row)
        lib_ms = time_ms(lambda: F.scaled_dot_product_attention(q, dk, dv, attn_mask=sdpa_mask),
                         per_rep=100)
        alloc = (bt < kp.shape[0]).repeat_interleave(128, dim=1) & (bias[:, 0, 0, :] > -1)
        seen = alloc[:, None, :] & (k_pos[0, 0] <= off[:, None, None] + row[0, 0])
        live = int(seen[:, -1].sum())
        H, D = 32, 128
        # K/V of every slot the output depends on read once (int8: a byte
        # an element and an fp32 scale a slot each), q, o, the bias, the
        # tables and the offsets
        nbytes = (2 * H * live * (D * esz + (4 if int8 else 0)) + 2 * q.numel() * 2
                  + bias.numel() * 4 + bt.numel() * 4 + 8 * 4)
        b_ms, b_by = bound(4.0 * H * D * float(seen.sum()), nbytes)
        # partials bind this case's tensors: the profiler session after the
        # loop calls every case's launch
        paged = dict(block_tables=bt, offsets=off, **s6)
        for kernel, run, plain in (
                ("flash_decode_paged", partial(fa.flash_decode_paged, q, kp, vp, bias, **paged),
                 partial(fa.flash_decode_paged_plain, q, kp, vp, bias, **paged)),
                ("flash_decode", partial(fa.flash_decode, q, vk, vv, bias, offsets=off, **s5),
                 partial(fa.flash_decode_plain, q, vk, vv, bias, offsets=off, **s5))):
            got, want = run().float(), plain().float()
            err = float((got - want).abs().max())
            # both dequantize and accumulate in fp32 and round once to bf16:
            # within 2 bf16 ulps of the output's largest entry
            top = float(want.abs().max())
            limit = 2 * 2.0 ** (math.floor(math.log2(top)) - 7)
            if not err <= limit:
                fail(f"{kernel} {what}: kernel vs plain max abs err {err} over {limit} (2 bf16 "
                     f"ulps of max |out| {top})")
            out[kernel][what] = dict(max_abs_err=err, err_limit=limit, max_abs_out=top,
                                     mean_abs_out=float(want.abs().mean()),
                                     ms=time_ms(run, per_rep=200),
                                     plain_ms=time_ms(plain, per_rep=20), bound_ms=b_ms,
                                     bound_by=b_by, library_ms=lib_ms)
            # the instance's template arguments (PAGED, BF16, INT8, D, QM)
            # name its kernel events in the one profiler session below
            timed.append((kernel, what, f"<{int(kernel.endswith('paged'))}, 1, {int(int8)}, 128, "
                          f"{1 if Q == 1 else 8}>", run, live))
    _, device = profile_device(lambda: [t[3]() for t in timed], 50)
    for kernel, what, inst, _, live in timed:
        r = out[kernel][what]
        r["device_ms"] = sum(v for k, v in device.items() if "flash_decode_kernel" + inst in k) \
            or None
        say({"phase": "kernel_time", "kernel": kernel, "case": what, "instance": inst,
             "kv": "int8" if what == "int8" else "bf16", "live_slots": live, **r})
    return out


def serving_oom_phase(torch, lm) -> dict:
    """(e): a session's step on the loaded model with a ballast tensor
    holding all but 256 MiB of the card: the admission's prefill runs out
    of memory inside ``step()``, the tripwire writes the postmortem bundle
    (its kv_cache bucket the engine's own account), and the error is
    re-raised."""
    import glob

    from distributed_llms_example_tpu_torch.obs.memprof import is_resource_exhausted
    from distributed_llms_example_tpu_torch.serving.engine import ServeConfig, ServingEngine

    out = fresh_dir("serve16-oom")
    eng = ServingEngine(lm.module, lm.config, ServeConfig(
        max_slots=8, max_new_tokens=64, max_source_length=1024, paged_kv=True,
        kv_block_size=64, request_spans=False, postmortem_dir=out), is_seq2seq=False,
        device="cuda")
    sess = eng.open()
    with open(os.path.join(WORK, "llama_prompts.json")) as f:
        texts = json.load(f)
    from distributed_llms_example_tpu_torch.data.tokenizer import ByteTokenizer

    tok = ByteTokenizer()
    for t in texts[:8]:
        sess.submit(tok.encode_prompt(t, 1024))
    free_cuda()
    free, _ = torch.cuda.mem_get_info()
    ballast = torch.empty(free - (256 << 20), dtype=torch.uint8, device="cuda")
    error = None
    try:
        sess.step()
    except Exception as e:  # the tripwire re-raises what it caught
        error = e.with_traceback(None)
    account = sess._memory_account()
    del ballast
    free_cuda()
    bundles = sorted(glob.glob(os.path.join(out, "obs", "memory-postmortem-p*.json")))
    bundle = {}
    if bundles:
        with open(bundles[0]) as f:
            bundle = json.load(f)
    got = (bundle.get("account") or {}).get("buckets_bytes", {})
    line = {"phase": "serve16_oom_postmortem", "error": f"{type(error).__name__}: "
            f"{str(error)[:160]}", "recognized": error is not None and is_resource_exhausted(error),
            "bundles": [os.path.basename(b) for b in bundles], "bundle_step": bundle.get("step"),
            "bundle_kv_cache_bytes": got.get("kv_cache"),
            "engine_kv_cache_bytes": account["buckets_bytes"]["kv_cache"],
            "tmp_left": bool(glob.glob(os.path.join(out, "obs", "*.tmp")))}
    say(line)
    if error is None or not line["recognized"]:
        fail(f"serve16 (e): step() raised {error!r}, not an out-of-memory error")
    if line["bundles"] != ["memory-postmortem-p000.json"] or line["tmp_left"] \
            or bundle.get("event") != "memory_postmortem" \
            or got.get("kv_cache") != account["buckets_bytes"]["kv_cache"] \
            or got.get("params") != account["buckets_bytes"]["params"]:
        fail(f"serve16 (e): bundle {line}")
    del sess, eng
    free_cuda()
    shutil.rmtree(out, ignore_errors=True)
    return line


def llama_7b(torch):
    """llama-2-7b at full width, bf16, seed 0: the model phases 16 and 17
    share (phase 11's CLI loads draw the same weights)."""
    from distributed_llms_example_tpu_torch.models.registry import load_model

    return load_model("llama-2-7b", dtype=torch.bfloat16, device="cuda", seed=0)


def serving_features_phase(torch, fa, cli, lm) -> dict:
    """Phase 16 (above), on the loaded llama-2-7b ``lm``.  Returns the
    runs' summed launches, the kernel times of ``verify_kernel_phase`` and
    the route floor."""
    from distributed_llms_example_tpu_torch.data.tokenizer import ByteTokenizer
    from distributed_llms_example_tpu_torch.serving import spec

    t0 = time.perf_counter()
    marks = {}  # where the phase's seconds go

    def mark(what: str) -> None:
        marks[what] = time.perf_counter() - t0 - sum(marks.values())

    kernel_times = verify_kernel_phase(torch, fa)
    mark("kernels_s")
    os.makedirs(WORK, exist_ok=True)
    prompts = os.path.join(WORK, "llama_prompts.json")
    write_llama_prompts(prompts)
    chat = os.path.join(WORK, "prefix_prompts.json")
    write_prefix_prompts(chat)
    tok = ByteTokenizer()
    with open(prompts) as f:
        ids = [tok.encode_prompt(t, 1024) for t in json.load(f)[:8]]
    with open(chat) as f:
        chat_ids = [tok.encode_prompt(t, 768) for t in json.load(f)]
    draft = draft_hf_dir(torch)
    mark("setup_s")
    paged = ["--paged-kv"]
    spec_args = ["--spec-tokens", str(SPEC_K)]
    runs = {}
    for name, argv, p in (
            ("plain_paged", [*SERVE16_ARGS, *paged], prompts),
            ("int8_paged", [*SERVE16_ARGS, *paged, "--kv-cache-dtype", "int8"], prompts),
            ("int8_flat", [*SERVE16_ARGS, "--kv-cache-dtype", "int8"], prompts),
            ("spec_ngram", [*SERVE16_ARGS, *paged, *spec_args], prompts),
            ("spec_draft", [*SERVE16_ARGS, *paged, *spec_args, "--spec-draft-model", draft],
             prompts),
            ("prefix_cold", PREFIX16_ARGS, chat),
            ("prefix_warm", [*PREFIX16_ARGS, "--prefix-cache", "--prefix-cache-budget-gib", "2"],
             chat)):
        runs[name] = serve16(torch, fa, cli, lm, name, argv, p,
                             reads=ids if name in ("plain_paged", "spec_ngram", "spec_draft")
                             else None)
    # the planted fault: one more draft accepted than matched
    real = spec.acceptance_lengths
    spec.acceptance_lengths = lambda x, t, room: (real(x, t, room) + 1).clamp(max=SPEC_K)
    try:
        fault = serve16(torch, fa, cli, lm, "spec_ngram_fault_accept_one_more",
                        [*SERVE16_ARGS, *paged, *spec_args], prompts)
    finally:
        spec.acceptance_lengths = real
    mark("runs_s")
    floor = route_floor(torch, lm.module, ids)
    say({"phase": "serve16_route_floor", **floor})
    checks = {}
    for name, base, got, p in (("int8_paged_vs_int8_flat", "int8_flat", "int8_paged", ids),
                               ("spec_ngram", "plain_paged", "spec_ngram", ids),
                               ("spec_draft", "plain_paged", "spec_draft", ids),
                               ("prefix_warm", "prefix_cold", "prefix_warm", chat_ids),
                               ("int8_paged_vs_plain_paged", "plain_paged", "int8_paged", ids)):
        checks[name] = end_to_end_check(torch, lm, name, p, runs[base]["outs"],
                                        runs[got]["outs"], floor["floor"])
        say({"phase": "serve16_end_to_end", **checks[name]})
    planted = end_to_end_check(torch, lm, "spec_ngram_fault", ids, runs["plain_paged"]["outs"],
                               fault["outs"], floor["floor"])
    say({"phase": "serve16_end_to_end", "planted_fault": True, **planted})
    # kernel 6 equals kernel 5 over the same blocks bit for bit, so the
    # int8 runs' tokens must be equal; speculation and warm prefixes agree
    # with their plain runs up to rounding; the planted fault must not
    if checks["int8_paged_vs_int8_flat"]["divergences"]:
        fail(f"serve16: int8 paged and flat tokens differ: {checks['int8_paged_vs_int8_flat']}")
    for name in ("spec_ngram", "spec_draft", "prefix_warm"):
        if checks[name]["unexplained"]:
            fail(f"serve16 {name}: divergences beyond rounding: {checks[name]['unexplained']}")
    if not planted["unexplained"]:
        fail(f"serve16: accepting one more draft than matched went unseen: {planted}")
    warm, cold = runs["prefix_warm"]["stats"], runs["prefix_cold"]["stats"]
    n = len(chat_ids)
    if (warm.prefix_lookups, warm.prefix_hits, warm.prefill_tokens_saved) != \
            (n, n - 1, (n - 1) * PREFIX16_SYS):
        fail(f"serve16 prefix: lookups {warm.prefix_lookups}, hits {warm.prefix_hits}, tokens "
             f"saved {warm.prefill_tokens_saved}")
    i8, bf = runs["int8_paged"]["stats"], runs["plain_paged"]["stats"]
    say({"phase": "serve16_summary",
         "decode_tokens_per_sec": {k: r["stats"].tokens_per_sec() for k, r in runs.items()},
         "bytes_per_live_token": {k: r["stats"].bytes_per_live_token for k, r in runs.items()},
         "int8_vs_bf16_resident_bytes": bf.cache_bytes_resident / i8.cache_bytes_resident,
         "accepted_tokens_per_step": {k: runs[k]["line"]["accepted_tokens_per_step"]
                                      for k in ("spec_ngram", "spec_draft")},
         "ttft_ms_warm_vs_cold": {"warm": [x * 1e3 for x in warm.ttft_percentiles()],
                                  "cold": [x * 1e3 for x in cold.ttft_percentiles()]},
         "prefix_hit_rate": warm.prefix_hits / max(warm.prefix_lookups, 1)})
    mark("checks_s")
    oom = serving_oom_phase(torch, lm)
    free_cuda()
    mark("oom_s")
    launches = {k: sum(r["launches"][k] for r in (*runs.values(), fault))
                for k in ("flash_attention_fwd", "flash_decode", "flash_decode_paged")}
    say({"phase": "serve16_wall", "seconds": time.perf_counter() - t0, **marks,
         "launches": launches, "oom_bundle": oom["bundles"]})
    return {"launches": launches, "kernel_times": kernel_times, "floor": floor["floor"]}


# phase 17: the serving tier at llama-2-7b width.  Router runs: 2 replicas
# of 4 slots over one loaded model, 16 prompts (two waves a replica, the
# second into the slots the first freed), 32 new tokens (the open loop's
# 0.5x point alone spans twice the unfailed run's wall, so the budget sets
# the phase's time), blocks of 32 (1024 + 32 slots); the crash and the
# stall at tick 12, when every replica holds 4 requests mid-decode
ROUTER17_NEW_TOKENS = 32
ROUTER17_ARGS = ["--model-ckpt", "llama-2-7b", "--num-prompts", "16", "--max-slots", "4",
                 "--max-new-tokens", str(ROUTER17_NEW_TOKENS), "--max-source-length", "1024",
                 "--kv-block-size", "32", "--seed", "0", "--log-every-steps", "0", "--lint", "off",
                 "--paged-kv"]
CRASH17_TICK = 12
# fp32 at 2 of the 32 layers: a re-prefilled request's decode logits
# within this of the unfailed run's (the JAX package's contract: the
# re-prefill equals an unfailed run), its tokens equal
ROUTER17_FP32_ATOL = 1e-4
LOADGEN17_SEED = 17


@contextlib.contextmanager
def opened_sessions():
    """Every serving session opened inside, in order (a dead replica's
    too, which its router drops): the ledger its launches are held to."""
    from distributed_llms_example_tpu_torch.serving.engine import ServingEngine

    real = ServingEngine.open
    sessions: list = []

    def recording(self, **kw):
        sessions.append(real(self, **kw))
        return sessions[-1]

    ServingEngine.open = recording
    try:
        yield sessions
    finally:
        ServingEngine.open = real


@contextlib.contextmanager
def recovery_tick(out: dict):
    """The router tick at which the last request a failure displaced was
    dispatched again (the router stamps that instant as ``t_recovered``)."""
    from distributed_llms_example_tpu_torch.serving import router as rt

    real = rt.ReplicaRouter._dispatch

    def dispatch(self):
        before = self.t_recovered
        real(self)
        if before is None and self.t_recovered is not None:
            out["tick"] = self.ticks

    rt.ReplicaRouter._dispatch = dispatch
    try:
        yield out
    finally:
        rt.ReplicaRouter._dispatch = real


@contextlib.contextmanager
def decode_logits_by_request(model, store: dict):
    """Every decode step's fp32 logits row, by (router request id, token
    index): a forward hook on the model reads the session stepping (a
    prefill, wider than one row, is left out; a data rank's rows are its
    own slots').  A re-prefilled request's
    rows overwrite its dead replica's, so the store holds what produced
    each request's final tokens."""
    import numpy as np

    from distributed_llms_example_tpu_torch.serving import engine as eng

    stepping: list = []
    real = eng.ServeSession._step_round

    def step_round(self):
        stepping.append(self)
        try:
            return real(self)
        finally:
            stepping.pop()

    def hook(module, args, out):
        if out.shape[1] != 1 or not stepping:
            return
        sess = stepping[-1]
        lo, n = sess.eng.slot0, sess.eng.rows  # a data rank holds rows lo .. lo + n
        for s in np.nonzero(sess.active[lo:lo + n])[0]:
            rid = int(sess.slot_req[lo + s])
            store[(sess.labels[rid], int(sess.emitted[lo + s]))] = out[s, 0].float().clone()

    handle = model.register_forward_hook(hook)
    eng.ServeSession._step_round = step_round
    try:
        yield store
    finally:
        handle.remove()
        eng.ServeSession._step_round = real


@contextlib.contextmanager
def planted_keeps_partial():
    """The planted fault of phase 17 (b): a request re-dispatched after its
    replica died keeps the dead replica's partial tokens and resumes its
    decode after them (their K/V, never written on the survivor, masked
    out; its positions past them), where the re-prefill must regenerate
    from the prompt."""
    from distributed_llms_example_tpu_torch.serving import engine as eng
    from distributed_llms_example_tpu_torch.serving import router as rt

    partial: dict = {}
    real_fail, real_admit = rt.ReplicaRouter._fail_replica, eng.ServeSession._admit_row

    def fail_replica(self, r, **kw):
        for q in self.requests:
            if q.replica == r.idx and q.local is not None and r.session.outputs[q.local]:
                partial[q.rid] = list(r.session.outputs[q.local][:-1])
        return real_fail(self, r, **kw)

    def admit_row(self, rid, slot, *args, **kw):
        kept = partial.pop(self.labels[rid], [])
        self.outputs[rid].extend(kept)
        real_admit(self, rid, slot, *args, **kw)
        self.emitted[slot] += len(kept)

    rt.ReplicaRouter._fail_replica, eng.ServeSession._admit_row = fail_replica, admit_row
    try:
        yield
    finally:
        rt.ReplicaRouter._fail_replica, eng.ServeSession._admit_row = real_fail, real_admit


def router17(torch, fa, cli, lm, name: str, argv: list[str], prompts: str, *, sub="serve-router",
             obs_dir: str | None = None, logits: dict | None = None, fault: bool = False) -> dict:
    """One run of ``serve-router`` (or ``serve-loadgen``, or a bare ``serve``)
    through the CLI's entry on the loaded model: the launches of kernels 1, 5 and 6 held to
    what every session's ledger (a dead replica's too) and the layer count
    give, every pool drained with exact refcounts; with ``obs_dir`` its
    JSONL written there (and read by ``obs.report --strict``)."""
    import io

    from distributed_llms_example_tpu_torch.obs import report, sink
    from distributed_llms_example_tpu_torch.ops.mha import MultiHeadAttention

    fa.flash_attention.launches = fa.flash_decode.launches = 0
    fa.flash_decode_paged.launches = 0
    if obs_dir:
        sink.install_sink(sink.build_sink("jsonl", obs_dir))
    entry = {"serve-router": cli.serve_router, "serve-loadgen": cli.serve_loadgen,
             "serve": cli.serve}[sub]
    out = os.path.join(WORK, f"router17_{name}.jsonl")
    t0 = time.perf_counter()
    recovered: dict = {}
    with contextlib.ExitStack() as stack:
        sessions = stack.enter_context(opened_sessions())
        stack.enter_context(recovery_tick(recovered))
        if logits is not None:
            stack.enter_context(decode_logits_by_request(lm.module, logits))
        if fault:
            stack.enter_context(planted_keeps_partial())
        result, outs = entry([*argv, "--prompts-file", prompts, "--output-file", out],
                             loaded=lm)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if obs_dir:
        sink.install_sink(sink.build_sink("stdout", ""))
    launches = {"flash_attention_fwd": fa.flash_attention.launches,
                "flash_decode": fa.flash_decode.launches,
                "flash_decode_paged": fa.flash_decode_paged.launches}
    layers = sum(isinstance(m, MultiHeadAttention) for m in lm.module.modules())
    prefills = sum(s.stats.prefill_calls for s in sessions)
    steps = sum(s.stats.decode_steps for s in sessions)
    admitted = sum(t is not None for s in sessions for t in s.admit_t)
    # kernel 1 once a layer per prompt chunk (from cache slot 0), kernel 6
    # once a layer per decode round, of every session
    want = {"flash_attention_fwd": layers * prefills, "flash_decode": 0,
            "flash_decode_paged": layers * steps}
    engines = ([r.engine for r in result.replicas] if sub == "serve-router"
               else [s.eng for s in sessions])
    line = {"phase": f"router17_{name}", "wall_s": wall, "attention_modules": layers,
            "sessions": len(sessions), "prefill_chunks": prefills, "decode_rounds": steps,
            "rows_admitted": admitted, "launches": launches, "expected": want,
            "blocks_in_use_at_end": [e.pool.blocks_in_use for e in engines],
            "ref_violations": [v for e in engines for v in e.pool.ref_invariant_violations([])]}
    if sub == "serve-router":
        line["router_summary"] = result.last_stats
        line["recovered_at_tick"] = recovered.get("tick")
    say(line)
    if launches != want or any(line["blocks_in_use_at_end"]) or line["ref_violations"]:
        fail(f"phase 17 {name}: launches {launches} vs {want}, blocks left "
             f"{line['blocks_in_use_at_end']}, {line['ref_violations']}")
    rc = rep = None
    if obs_dir:
        rep = report.build_report(obs_dir)
        with contextlib.redirect_stdout(io.StringIO()):
            rc = report.main([obs_dir, "--strict"])
        rec = rep["recovery"]
        say({"phase": f"router17_{name}_report", "faults": rec["faults"],
             "organic_faults": rec["organic_faults"], "serving": rec["serving"],
             "loadgen_knee": (rep["loadgen"] or {}).get("knee_qps"), "strict_rc": rc})
        if rc != 0 or rec["organic_faults"]:
            fail(f"phase 17 {name}: obs.report --strict {rc}, organic {rec['organic_faults']}")
        shutil.rmtree(obs_dir, ignore_errors=True)
    return {"result": result, "outs": outs, "launches": launches, "line": line, "wall_s": wall,
            "admitted": admitted, "report": rep}


def reprefilled(router) -> list[int]:
    """The requests a dead replica held mid-decode (re-prefilled on a
    survivor)."""
    return [q.rid for q in router.requests if q.retries]


def llama17_fp32(torch):
    """llama-2-7b's widths at 2 of its 32 layers, fp32, seed 0 (phase 12's
    model), as a ``LoadedModel`` for the CLI's ``loaded=``."""
    import dataclasses

    from distributed_llms_example_tpu_torch.models.llama import LlamaForCausalLM
    from distributed_llms_example_tpu_torch.models.registry import LLAMA_CONFIGS, LoadedModel

    cfg = dataclasses.replace(LLAMA_CONFIGS["llama-2-7b"], num_hidden_layers=2)
    model = LlamaForCausalLM(cfg, dtype=torch.float32, param_dtype=torch.float32,
                             device="cuda").eval()
    model.init_weights(torch.Generator(device="cuda").manual_seed(0))
    return LoadedModel("llama", cfg, model, is_seq2seq=False)


def logit_err(a: dict, b: dict, rids) -> float:
    """Largest |Δ logit| over the decode rows of requests ``rids`` (inf
    where the two runs decoded different rows)."""
    worst = 0.0
    for rid in rids:
        ka = sorted(k for k in a if k[0] == rid)
        if ka != sorted(k for k in b if k[0] == rid) or not ka:
            return math.inf
        worst = max(worst, max(float((a[k] - b[k]).abs().max()) for k in ka))
    return worst


def serving_tier_phase(torch, fa, cli, lm, *, floor: float | None = None) -> dict:
    """Phase 17 (above).  ``floor``: phase 16's route floor.  Returns the
    runs' summed launches."""
    from distributed_llms_example_tpu_torch.data.tokenizer import ByteTokenizer

    t0 = time.perf_counter()
    marks = {}

    def mark(what: str) -> None:
        marks[what] = time.perf_counter() - t0 - sum(marks.values())

    os.makedirs(WORK, exist_ok=True)
    prompts = os.path.join(WORK, "llama_prompts.json")
    write_llama_prompts(prompts)
    tok = ByteTokenizer()
    with open(prompts) as f:
        ids = [tok.encode_prompt(t, 1024) for t in json.load(f)]
    bf16 = [*ROUTER17_ARGS, "--compute-dtype", "bfloat16"]
    runs = {}
    # the bare engine of the same settings, closed loop (every prompt
    # submitted at once): the oracle of (a) and (d), and the requests/s
    # that sets (d)'s grid, since (d) drives that same single engine
    runs["closed"] = router17(torch, fa, cli, lm, "closed", bf16, prompts, sub="serve")
    oracle = runs["closed"]["outs"]
    # (a) bf16, 32 layers: unfailed, then the crash
    runs["unfailed"] = router17(torch, fa, cli, lm, "unfailed", bf16, prompts)
    runs["crash"] = router17(torch, fa, cli, lm, "crash",
                             [*bf16, "--chaos", f"replica_crash@{CRASH17_TICK}"], prompts,
                             obs_dir=fresh_dir("router17-crash-obs"))
    if floor is None:
        floor = route_floor(torch, lm.module, ids[:8])["floor"]
    mark("bf16_runs_s")
    crash = runs["crash"]["result"]
    s = crash.last_stats
    again = reprefilled(crash)
    say({"phase": "router17_crash", "reprefilled": again, "retries": s["retries"],
         "crash_tick": CRASH17_TICK,
         "recovered_at_tick": runs["crash"]["line"]["recovered_at_tick"],
         "extra_ticks": s["ticks"] - runs["unfailed"]["result"].last_stats["ticks"],
         "replica_states": s["replica_states"], "completed": s["completed"],
         "shed": s["shed"], "request_mttr_s": s["request_mttr_s"], "ticks": s["ticks"],
         "t_fail_s": s.get("t_fail_s"), "t_recovered_s": s.get("t_recovered_s"),
         "ttft_ms": [s["ttft_p50_ms"], s["ttft_p95_ms"], s["ttft_p99_ms"]],
         "unfailed_ttft_ms": [runs["unfailed"]["result"].last_stats[k]
                              for k in ("ttft_p50_ms", "ttft_p95_ms", "ttft_p99_ms")]})
    if s["completed"] != 16 or s["shed"] or s["replica_states"] != {"0": "dead", "1": "live"} \
            or len(again) != 4 or runs["crash"]["admitted"] != 16 + len(again):
        fail(f"phase 17 (a): the crash run {s}, re-prefilled {again}")
    checks = {}
    for name, base, got in (("crash_vs_unfailed", runs["unfailed"]["outs"], runs["crash"]["outs"]),
                            ("crash_vs_bare", oracle, runs["crash"]["outs"]),
                            ("unfailed_vs_bare", oracle, runs["unfailed"]["outs"])):
        checks[name] = end_to_end_check(torch, lm, name, ids, base, got, floor)
        say({"phase": "router17_end_to_end", **checks[name]})
        if checks[name]["unexplained"]:
            fail(f"phase 17 (a) {name}: divergences beyond rounding: {checks[name]}")

    # (b) fp32 at 2 layers: the re-prefilled requests equal the unfailed
    # run's, tokens and decode logits; the planted fault must break both
    lm32 = llama17_fp32(torch)
    fp32 = [*ROUTER17_ARGS, "--compute-dtype", "float32"]
    logits = {k: {} for k in ("unfailed", "crash", "fault")}
    crash_args = [*fp32, "--chaos", f"replica_crash@{CRASH17_TICK}"]
    for name, argv in (("unfailed", fp32), ("crash", crash_args), ("fault", crash_args)):
        runs[f"fp32_{name}"] = router17(torch, fa, cli, lm32, f"fp32_{name}", argv, prompts,
                                        logits=logits[name], fault=name == "fault")
    want = runs["fp32_unfailed"]["outs"]
    again32 = reprefilled(runs["fp32_crash"]["result"])
    fault_again = reprefilled(runs["fp32_fault"]["result"])
    line = {"phase": "router17_fp32", "layers": 2, "reprefilled": again32,
            "tokens_equal": runs["fp32_crash"]["outs"] == want,
            "reprefilled_logits_max_abs_err": logit_err(logits["crash"], logits["unfailed"],
                                                        again32),
            "atol": ROUTER17_FP32_ATOL,
            "planted_tokens_equal": runs["fp32_fault"]["outs"] == want,
            "planted_requests_differing": [i for i, (a, b) in enumerate(
                zip(runs["fp32_fault"]["outs"], want)) if a != b],
            "planted_logits_max_abs_err": logit_err(logits["fault"], logits["unfailed"],
                                                    fault_again)}
    say(line)
    if not again32 or not line["tokens_equal"] \
            or line["reprefilled_logits_max_abs_err"] > ROUTER17_FP32_ATOL:
        fail(f"phase 17 (b): a re-prefilled request differs from the unfailed run: {line}")
    if line["planted_tokens_equal"] or not line["planted_logits_max_abs_err"] > ROUTER17_FP32_ATOL:
        fail(f"phase 17 (b): a retry keeping the dead replica's tokens went unseen: {line}")
    del logits
    mark("fp32_crash_s")

    # (c) fp32: replica_stall (suspect, then dead, from ticks alone; its
    # requests re-prefilled) and drain_replica (retired, nothing lost)
    runs["fp32_stall"] = router17(
        torch, fa, cli, lm32, "fp32_stall",
        [*fp32, "--chaos", f"replica_stall@{CRASH17_TICK}", "--suspect-after-ticks", "3",
         "--dead-after-ticks", "6"], prompts, obs_dir=fresh_dir("router17-stall-obs"))
    stall = runs["fp32_stall"]["result"]
    moves = runs["fp32_stall"]["report"]["recovery"]["serving"]["replica_transitions"]
    stall_again = reprefilled(stall)
    from distributed_llms_example_tpu_torch.serving.router import ReplicaRouter, RouterConfig

    # the drain through the library: the CLI's engines and requests, one tick,
    # then drain_replica(0)
    args = cli.build_router_parser().parse_args([*fp32, "--prompts-file", prompts])
    _, _, _, _, requests, _ = cli._serve_setup(args, lm32)
    engines = [cli._engine(args, lm32, lm32.device) for _ in range(2)]
    drain = ReplicaRouter(engines, RouterConfig(log_every_ticks=0))
    for r in requests:
        drain.submit(r)
    drain.tick()
    drain.drain_replica(0)
    drain.run_until_drained()
    drain.finalize()
    line = {"phase": "router17_fp32_stall_drain", "stall_states": stall.last_stats["replica_states"],
            "stall_transitions": [(e.get("from"), e.get("to"), e.get("cause")) for e in moves],
            "stall_reprefilled": stall_again, "stall_tokens_equal": runs["fp32_stall"]["outs"] == want,
            "drain_states": drain.last_stats["replica_states"],
            "drain_retries": drain.last_stats["retries_total"],
            "drain_completed": drain.last_stats["completed"],
            "drain_tokens_equal": [q.out for q in drain.requests] == want,
            "drain_blocks_in_use": [e.pool.blocks_in_use for e in engines],
            "drain_ref_violations": [v for e in engines
                                     for v in e.pool.ref_invariant_violations([])]}
    say(line)
    if line["stall_states"] != {"0": "dead", "1": "live"} or not stall_again \
            or ("live", "suspect", None) not in line["stall_transitions"] \
            or ("suspect", "dead", "stall") not in line["stall_transitions"] \
            or not line["stall_tokens_equal"]:
        fail(f"phase 17 (c): the stalled replica: {line}")
    if line["drain_states"] != {"0": "drained", "1": "live"} or line["drain_retries"] \
            or line["drain_completed"] != 16 or not line["drain_tokens_equal"] \
            or any(line["drain_blocks_in_use"]) or line["drain_ref_violations"]:
        fail(f"phase 17 (c): the drained replica: {line}")
    del drain, engines, stall, lm32
    free_cuda()
    mark("fp32_stall_drain_s")

    # (d) serve-loadgen --replicas 0, Poisson, 16 requests a point at 0.5x,
    # 1x and 2x the rate the bare engine's closed-loop run sustained
    rate = len(oracle) / runs["closed"]["wall_s"]
    grid = [0.5 * rate, rate, 2 * rate]
    runs["loadgen"] = router17(
        torch, fa, cli, lm, "loadgen",
        [*bf16, "--replicas", "0", "--arrival-process", "poisson", "--loadgen-seed",
         str(LOADGEN17_SEED), "--qps-grid", ",".join(f"{q:.6f}" for q in grid)], prompts,
        sub="serve-loadgen")
    summary = runs["loadgen"]["result"]
    points = summary["points"]
    say({"phase": "router17_loadgen", "closed_loop_rps": rate,
         "closed_loop_of": "serve, one engine of 4 slots, 16 prompts at once",
         "closed_loop_wall_s": runs["closed"]["wall_s"], "knee_qps": summary["knee_qps"],
         "points": [{k: p[k] for k in ("offered_qps", "offered_qps_realized", "achieved_qps",
                                       "goodput_qps", "slo_attainment", "ttft_p50_ms",
                                       "ttft_p95_ms", "ttft_p99_ms", "queue_delay_p50_ms",
                                       "queue_delay_p99_ms", "queue_growing", "completed",
                                       "wall_s")} for p in points]})
    # the grid brackets the collapse: the 0.5x point's queue is stable, the
    # 2x point's grows (the knee, printed, also reads a 16-request
    # sample's decode tail as lost tracking, so it is not the check)
    if len(points) != 3 or any(p["completed"] != 16 for p in points) \
            or points[0]["queue_growing"] or not points[2]["queue_growing"]:
        fail(f"phase 17 (d): the grid does not bracket the collapse (0.5x stable, "
             f"2x growing): {summary}")
    for i, outs in enumerate(runs["loadgen"]["outs"]):
        check = end_to_end_check(torch, lm, f"loadgen_point_{i}", ids, oracle, outs, floor)
        say({"phase": "router17_end_to_end", **check})
        if check["unexplained"]:
            fail(f"phase 17 (d): point {i}'s tokens beyond rounding of the closed loop: {check}")
    mark("loadgen_s")
    launches = {k: sum(r["launches"][k] for r in runs.values())
                for k in ("flash_attention_fwd", "flash_decode", "flash_decode_paged")}
    say({"phase": "router17_wall", "seconds": time.perf_counter() - t0, **marks,
         "launches": launches})
    return {"launches": launches}


# phase 18: Mixtral at mixtral-8x7b's published widths (hidden 4096, FFN
# 14336, 32 q heads over 8 kv heads of 128, 8 experts top-2, vocabulary
# 32000, rope theta 1e6) cut to 2 of its 32 layers (46.7 B parameters, 93.4
# GB in bf16 whole: more than the card holds), seed-0 random weights
MIXTRAL_LAYERS = 2
# mixtral-8x7b's published config.json (mistralai/Mixtral-8x7B-v0.1), depth
# cut
MIXTRAL_HF_CONFIG = {
    "architectures": ["MixtralForCausalLM"], "model_type": "mixtral", "attention_dropout": 0.0,
    "bos_token_id": 1, "eos_token_id": 2, "hidden_act": "silu", "hidden_size": 4096,
    "initializer_range": 0.02, "intermediate_size": 14336, "max_position_embeddings": 32768,
    "num_attention_heads": 32, "num_experts_per_tok": 2, "num_hidden_layers": MIXTRAL_LAYERS,
    "num_key_value_heads": 8, "num_local_experts": 8, "output_router_logits": False,
    "rms_norm_eps": 1e-05, "rope_theta": 1e6, "router_aux_loss_coef": 0.02,
    "sliding_window": None, "tie_word_embeddings": False, "torch_dtype": "bfloat16",
    "use_cache": True, "vocab_size": 32000,
}
# (c): phase 13's recipe without the eval, the training capacity asked for
# (the HF directory alone loads no-drop)
MIXTRAL_TRAIN_ARGS = [
    "--tokenizer", "byte", "--remat", "--fused-ce", "--batch-size", "8", "--num-epochs", "1",
    "--max-source-length", "1024", "--max-target-length", "128", "--compute-dtype", "bfloat16",
    "--learning-rate", "1e-4", "--warmup-steps", "0", "--seed", "0", "--log-every-steps", "1",
    "--evaluation-steps", "0", "--moe-capacity-factor", "1.25", "--save-every-steps", "0",
]
MIXTRAL_CAPACITY = 1.25
# (d): phase 11's 16 prompts, 8 slots, 32 new tokens
MIXTRAL_SERVE_ARGS = [
    "--model-ckpt", "mixtral-8x7b", "--num-prompts", str(LLAMA_SERVE_PROMPTS), "--max-slots",
    "8", "--max-new-tokens", "32", "--max-source-length", "1024", "--compute-dtype",
    "bfloat16", "--seed", "0", "--log-every-steps", "64", "--lint", "off",
]
# (a): 8 of phase 11's prompts at a 512-token bucket, a prefill + 4 decode steps
MIXTRAL_PARITY_BUCKET = 512
# kernel 8's plain version over the Mixtral table, this many elements at a
# time (an expert leaf holds 469.8 M)
MIXTRAL_PLAIN_SLICE = 1 << 26


def mixtral_config(torch, layers: int = MIXTRAL_LAYERS):
    import dataclasses

    from distributed_llms_example_tpu_torch.models.registry import LLAMA_CONFIGS

    return dataclasses.replace(LLAMA_CONFIGS["mixtral-8x7b"], num_hidden_layers=layers)


def mixtral_model(torch, *, dtype, train: bool = False):
    """mixtral-8x7b's widths at MIXTRAL_LAYERS layers on the card, seed-0
    weights: fp32 masters for training, the compute dtype for serving."""
    from distributed_llms_example_tpu_torch.models.llama import LlamaForCausalLM
    from distributed_llms_example_tpu_torch.models.registry import LoadedModel

    cfg = mixtral_config(torch)
    module = LlamaForCausalLM(cfg, dtype=dtype, param_dtype=torch.float32 if train else dtype,
                              device="cuda").train(train)
    lm = LoadedModel("llama", cfg, module, is_seq2seq=False)
    lm.init_params(0)
    return lm


def mixtral_model_flops(cfg, rows: int, width: int) -> int:
    """Model FLOPs of one Mixtral train step of ``rows`` x ``width`` tokens,
    counted by hand as obs/gauges.py's FlopCounterMode count defines them:
    every matmul of the forward (q, k, v, o, the fp32 router, the head; the
    experts' gate, up and down at the capacity-padded shape, every expert
    a full ``capacity`` of slots in every routing group; the two attention
    products over the whole S x S square) and its backward (twice each),
    no recompute."""
    from distributed_llms_example_tpu_torch.ops.moe import GROUP_SIZE, expert_capacity

    h, f, L, E = cfg.hidden_size, cfg.intermediate_size, cfg.num_hidden_layers, cfg.num_experts
    kv = cfg.head_dim * cfg.num_key_value_heads
    n = rows * width
    g = min(GROUP_SIZE, n)
    G = -(-n // g)
    cap = expert_capacity(g, E, cfg.num_experts_per_tok, cfg.moe_capacity_factor, False)
    forward = (2 * n * (L * (2 * h * h + 2 * h * kv + h * E) + h * cfg.vocab_size)
               + L * 3 * 2 * G * E * cap * h * f + L * 4 * rows * width * width * h)
    return 3 * forward


def mixtral_state_bytes(cfg) -> tuple[int, int, int]:
    """(parameters, their fp32 bytes, AdamW's two fp32 moments plus kernel
    8's float64 (leaves, STATS) table) of a Mixtral trained on one card,
    from its config alone: embeddings, the head, each layer's four
    attention matrices, router, three stacked expert matrices and two
    norms, the final norm."""
    from distributed_llms_example_tpu_torch.ops.fused_optim import STATS

    h, f, L, E, V = (cfg.hidden_size, cfg.intermediate_size, cfg.num_hidden_layers,
                     cfg.num_experts, cfg.vocab_size)
    kv = cfg.head_dim * cfg.num_key_value_heads
    n = 2 * V * h + L * (2 * h * h + 2 * h * kv + h * E + 3 * E * h * f + 2 * h) + h
    return n, 4 * n, 8 * n + (3 + 10 * L) * STATS * 8


def mixtral_hf_dir(torch) -> str:
    """<WORK>/mixtral-8x7b-<layers>l-hf: mixtral-8x7b's published config.json
    fields at MIXTRAL_LAYERS layers and seed-0 random weights, written by
    the port's HF export in bf16 (half the bytes to write and read)."""
    from distributed_llms_example_tpu_torch.models.export import save_hf_checkpoint

    path = fresh_dir(f"mixtral-8x7b-{MIXTRAL_LAYERS}l-hf")
    lm = mixtral_model(torch, dtype=torch.bfloat16)
    t0 = time.perf_counter()
    save_hf_checkpoint(path, "llama", lm.config, lm.module.state_dict(), dtype=torch.bfloat16)
    with open(os.path.join(path, "config.json")) as f:
        written = json.load(f)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump({**written, **MIXTRAL_HF_CONFIG}, f, indent=2, sort_keys=True)
    say({"phase": "mixtral_checkpoint", "dir": path, "layers": MIXTRAL_LAYERS,
         "parameters": sum(p.numel() for p in lm.module.parameters()),
         "leaves": len(list(lm.module.parameters())), "write_s": time.perf_counter() - t0,
         "bytes": tree_bytes(path), "files": sorted(os.listdir(path))})
    del lm
    free_cuda()
    return path


@contextlib.contextmanager
def no_final_state_save():
    """The CLI run's end-of-run training-state checkpoint left out: at 2
    layers Mixtral's fp32 parameters and AdamW moments are 38 GB, whose
    write and crc32 manifest would take minutes of the run's time limit;
    phases 14 (b) and 19 leave out theirs (5.6 GB at llama-2-7b's width
    and 1 layer) too (phases 5c and 13 hold the save and the restore, 15
    (b) the sharded ones)."""
    from distributed_llms_example_tpu_torch.train import trainer as trainer_mod

    real = trainer_mod.Trainer._save_checkpoint
    trainer_mod.Trainer._save_checkpoint = lambda self, step, epoch, pos: False
    try:
        yield
    finally:
        trainer_mod.Trainer._save_checkpoint = real


def mixtral_train_phase(torch, fa, fd, fo, cli) -> tuple[dict, dict]:
    """(c) The CLI's train entry on a 2-layer Mixtral HF directory, bf16
    compute and fp32 masters, --remat --fused-ce, --moe-capacity-factor
    1.25, 48 records (6 steps): finite losses, exact launches of kernels
    1/2/3/8 (kernel 1 twice a layer a step: the forward and remat's
    recompute), the export reloaded bit-equal with a mixtral config.json;
    the gauge FLOPs equal to the hand count at the capacity-padded shape,
    the memory account's state equal to the reckoning; tokens/s, step
    time, MFU, the peak against the state, the device account's shares;
    kernel 8's Mixtral tail against its plain version.  Returns (the
    launches, the first batch on the host for (b))."""
    from distributed_llms_example_tpu_torch.models.registry import load_model
    from distributed_llms_example_tpu_torch.train.trainer import batch_tokens

    ckpt = mixtral_hf_dir(torch)
    train_path = os.path.join(WORK, "mixtral_train.json")
    write_instruction_records(train_path, LLAMA_TRAIN_RECORDS, seed=0)
    out_dir = fresh_dir("mixtral-8x7b-train-out")
    zero_counters(fa, fd, fo)
    torch.cuda.reset_peak_memory_stats()
    with no_final_state_save():
        t0 = time.perf_counter()
        trainer = cli.train([*MIXTRAL_TRAIN_ARGS, "--model-ckpt", ckpt, "--train-file",
                             train_path, "--output-dir", out_dir, *BUDGET_ARGS,
                             *LLAMA_OBS_ARGS])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    budget_account("mixtral-8x7b", out_dir)
    peak = torch.cuda.max_memory_allocated()
    launches = read_counters(fa, fd, fo)
    model, cfg = trainer.model, trainer.loaded.config
    steps = len(trainer.history)
    want = expected_train_launches(model, steps)
    want["flash_attention_fwd"] *= 2  # the forward, and remat's recompute in the backward
    losses = [float(m["loss"]) for m in trainer.history]
    step_s = [b - a for a, b in zip(trainer.step_ends, trainer.step_ends[1:])]
    plan = list(trainer.batches.epoch(0))
    tokens = [batch_tokens(b, is_seq2seq=False) for b in plan]
    widths = [int(b["input_ids"].shape[1]) for b in plan]
    flops = [mixtral_model_flops(cfg, int(b["input_ids"].shape[0]), w)
             for b, w in zip(plan, widths)]
    lo, hi = LLAMA_PROFILE_WINDOW
    timed = [i + 2 for i in range(len(step_s)) if not lo <= i + 2 <= hi + 1]
    med = statistics.median(step_s[s - 2] for s in timed) if timed else float("nan")
    mean_tokens = statistics.mean(tokens[s - 1] for s in timed) if timed else float("nan")
    mean_flops = statistics.mean(flops[s - 1] for s in timed) if timed else float("nan")
    n_params, p_bytes, opt_bytes = mixtral_state_bytes(cfg)
    events = obs_events(out_dir)
    (gauges,) = [e for e in events if e.get("event") == "obs_gauges"]
    (mem,) = [e for e in events if e.get("event") == "memory_account"]
    accounts = [e for e in events if e.get("event") == "device_account"]
    mfus = [w["mfu"] for w in events if w.get("event") == "obs_window" and "mfu" in w]
    cap = mixtral_model_flops(cfg, trainer.cfg.batch_size, trainer.cfg.max_source_length)
    acct = accounts[0] if accounts else {}
    # the run's wall: the HF directory's load, then the loop (its export
    # included)
    loop = [e["wall_seconds"] for e in events if e.get("event") == "done"]
    export = [e["seconds"] for e in events if e.get("event") == "saved"]
    say({"phase": "mixtral_train", "model": "mixtral-8x7b", "layers": cfg.num_hidden_layers,
         "checkpoint": ckpt, "wall_s": wall, "loop_s": loop, "export_s": export,
         "steps": steps, "losses": losses,
         "grad_norms": [float(m["grad_norm"]) for m in trainer.history],
         "moe_capacity_factor": cfg.moe_capacity_factor, "moe_aux_weight": cfg.moe_aux_weight,
         "step_s_after_first": step_s, "timed_steps": timed, "step_s_median": med,
         "tokens_per_step": tokens, "batch_widths": widths,
         "tokens_per_sec": mean_tokens / med, "model_flops_per_step": flops,
         "mfu": mean_flops / med / PEAK_FLOPS, "window_mfu": mfus,
         "gauge_flops_per_step": gauges["flops_per_step"],
         "gauge_flops_source": gauges["flops_source"], "hand_count_flops_at_cap": cap,
         "parameters": n_params, "peak_mem_bytes": peak,
         "reckoned_state_bytes": p_bytes * 4, "peak_over_state": peak / (p_bytes * 4),
         "memory_account": mem["buckets_bytes"], "memory_measured": mem["measured"],
         "device_account_bucket_frac": acct.get("bucket_frac"),
         "device_account_buckets_ms": acct.get("buckets_ms"),
         "device_account_busy_ms": acct.get("busy_ms"), "device_account_span_ms":
         acct.get("span_ms"), "launches": launches, "expected": want,
         "tc_launches": fa.flash_attention.tc_launches,
         "final_state_checkpoint": "left out (no_final_state_save)"})
    if steps != 6 or not all(math.isfinite(x) for x in losses):
        fail(f"mixtral train: {steps} steps, losses {losses}")
    if launches != want or fa.flash_attention.tc_launches != want["flash_attention_fwd"]:
        fail(f"mixtral train launches {launches}, expected {want}, every kernel-1 launch on "
             "the tensor cores")
    if cfg.moe_capacity_factor != MIXTRAL_CAPACITY or \
            any(blk.mlp.capacity_factor != MIXTRAL_CAPACITY for blk in model.blocks):
        fail(f"mixtral train: --moe-capacity-factor did not reach the model "
             f"({cfg.moe_capacity_factor})")
    if gauges["flops_source"] != "flop_counter" or gauges["flops_per_step"] != cap:
        fail(f"mixtral gauges: {gauges['flops_source']} {gauges['flops_per_step']} FLOPs vs "
             f"the hand count {cap}")
    if mem["buckets_bytes"]["params"] != p_bytes or \
            mem["buckets_bytes"]["optimizer_state"] != opt_bytes:
        fail(f"mixtral memory account {mem['buckets_bytes']} vs params {p_bytes} B, optimizer "
             f"state {opt_bytes} B")
    if len(accounts) != 1 or not mfus or not all(math.isfinite(m) and 0 < m < 1 for m in mfus):
        fail(f"mixtral telemetry: {len(accounts)} device accounts, window MFU {mfus}")
    saved = os.path.join(out_dir, "model")
    with open(os.path.join(saved, "config.json")) as f:
        written = json.load(f)
    t1 = time.perf_counter()
    back = load_model(saved, dtype=model.dtype, device="cuda", train=True).module
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t1
    trained = dict(model.named_parameters())
    equal = [torch.equal(p, trained[n]) for n, p in back.named_parameters()]
    say({"phase": "train_export", "model": "mixtral-8x7b", "dir": saved,
         "files": sorted(os.listdir(saved)), "bytes": tree_bytes(saved), "reload_s": load_s,
         "model_type": written.get("model_type"), "parameters": len(equal),
         "bit_equal": sum(equal)})
    if len(equal) != len(trained) or not all(equal) or written.get("model_type") != "mixtral":
        fail(f"mixtral train: the export ({written.get('model_type')}) does not reload to the "
             "trained weights")
    del back
    free_cuda()
    mixtral_adamw_check(torch, fo, trainer)
    batch = plan[0]
    del trainer, model, trained
    free_cuda()
    shutil.rmtree(out_dir, ignore_errors=True)
    shutil.rmtree(ckpt, ignore_errors=True)
    return launches, batch


def mixtral_adamw_check(torch, fo, trainer) -> None:
    """Kernel 8 over the trained Mixtral's table (3.16 B elements in one
    launch, its stacked expert leaves 469.8 M each; the last step's
    gradients, tokens 1): one tail against the plain version's on host
    copies of the parameters and moments taken before it (the card holds
    the state once), each of p, mu, nu within ADAMW_RTOL and the norm
    within one fp32 ulp; the tail's time beside its bound."""
    from distributed_llms_example_tpu_torch.train import optim as toptim

    named = trainer.named_params
    state, spec = trainer.opt_state, trainer.spec
    params = [p for _, p in named]
    grads = [p.grad for p in params]
    dev = params[0].device
    ones = torch.ones((), device=dev)
    # copies of each leaf's p, mu, nu before the tail: on the card while it
    # keeps room for the plain version's temporaries (a slice of
    # MIXTRAL_PLAIN_SLICE elements at a time), on the host past that
    t0 = time.perf_counter()
    room = torch.cuda.mem_get_info(dev)[0] - 16 * MIXTRAL_PLAIN_SLICE * 4 - (2 << 30)
    copies, on_host = [], 0
    for ts in zip(params, state.mu, state.nu):
        size = 3 * ts[0].numel() * 4
        where = dev if size <= room else "cpu"
        room -= size if where == dev else 0
        on_host += size if where == "cpu" else 0
        copies.append(tuple(t.detach().to(where, copy=True) for t in ts))
    copy_s = time.perf_counter() - t0
    count = state.count
    table = fo.leaf_table(grads, params, state.mu, state.nu)
    fo.fused_adamw_leaf.launches = fo.fused_grad_prep.launches = 0
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with torch.no_grad():
        start.record()
        gnorm = toptim.fused_optimizer_apply(spec, trainer.schedule, named, state, grads, ones)
        end.record()
        torch.cuda.synchronize()
        tail_ms = start.elapsed_time(end)
        launched = fo.fused_adamw_leaf.launches + fo.fused_grad_prep.launches
        gplain = fo.grad_prep_plain(grads, ones)  # tokens 1: the gradients stay as they are
        scal = toptim.step_scalars(spec, trainer.schedule, count, gplain)
        worst = 0.0
        for i, (n, p) in enumerate(named):
            cp, cmu, cnu = (t.to(dev).view(-1) for t in copies[i])
            copies[i] = None
            wd = spec.weight_decay if toptim.decay_mask(n, p) else 0.0
            flat = [t.view(-1) for t in (p, state.mu[i], state.nu[i], grads[i])]
            # the update is elementwise: a slice at a time gives the same
            # values in a bounded working set
            for lo in range(0, p.numel(), MIXTRAL_PLAIN_SLICE):
                sl = slice(lo, lo + MIXTRAL_PLAIN_SLICE)
                want = fo.adamw_leaf_plain(cp[sl], cmu[sl], cnu[sl], flat[3][sl], scal,
                                           b1=spec.b1, b2=spec.b2, eps=spec.eps,
                                           max_norm=spec.max_grad_norm, wd=wd)[:3]
                for got, w in zip(flat[:3], want):
                    ok, err = close_enough(got[sl], w, atol=0.0, rtol=ADAMW_RTOL)
                    if not ok:
                        fail(f"fused_adamw mixtral table {n}: kernel differs from plain ({err})")
                    worst = max(worst, err)
                del want
            del cp, cmu, cnu
    n = sum(p.numel() for p in params)
    ulp = float(torch.finfo(torch.float32).eps * gplain.abs())
    norm_err = float((gnorm - gplain).abs())
    b_ms, b_by = bound(0.0, 36.0 * n)
    say({"phase": "kernel_check", "case": f"fused_grad_prep + fused_adamw mixtral-8x7b "
         f"{MIXTRAL_LAYERS}-layer table vs plain", "leaves": len(params), "elements": n,
         "largest_leaf": max(p.numel() for p in params), "launch_groups": len(table.groups),
         "work_items": int(table.groups[-1][2][-1]), "launches": launched,
         "max_abs_err": worst, "rtol": ADAMW_RTOL, "gnorm_abs_err": norm_err, "fp32_ulp": ulp,
         "tail_ms": tail_ms, "bound_ms": b_ms, "bound_by": b_by, "copy_s": copy_s,
         "copy_bytes_on_host": on_host})
    if not norm_err <= ulp or n < 2**31 or launched != 2:
        fail(f"fused_grad_prep mixtral table: norm {float(gnorm)} vs plain {float(gplain)}, "
             f"{n} elements, {launched} launches")
    del copies
    free_cuda()


@contextlib.contextmanager
def swapped_kv_groups(fa, rep: int):
    """Planted fault: the K/V that kernels 2-3 read repeated in the other
    order (query head h over kv head h mod H_kv, not h // rep), so the
    backward's K/V groups are not the forward's."""
    saved = fa._bwd_dq, fa._bwd_dkv

    def swapped(fn):
        def run(q, k, v, *a, **kw):
            h = k.shape[1]
            perm = [(i % (h // rep)) * rep for i in range(h)]
            return fn(q, k[:, perm].contiguous(), v[:, perm].contiguous(), *a, **kw)
        return run

    fa._bwd_dq, fa._bwd_dkv = map(swapped, saved)
    try:
        yield
    finally:
        fa._bwd_dq, fa._bwd_dkv = saved



def mixtral_grad_check(torch, fa, fd, batch, lm) -> None:
    """(b) fp32 at 2 layers, one batch of (c)'s recipe, moe_aux_weight 0.02,
    the capacity 1.25: kernels 1-3 inside the model against the plain path
    within GRAD_LIMITS; kernels 2-3 reading the K/V groups in the swapped
    order must break them."""
    from distributed_llms_example_tpu_torch.ops import fused_optim as fo
    from distributed_llms_example_tpu_torch.train.trainer import put_batch

    model = lm.module.train()
    batch = put_batch(batch, torch.device("cuda"))
    zero_counters(fa, fd, fo)
    kernel = loss_and_grads(torch, model, batch, is_seq2seq=False)
    launched = read_counters(fa, fd, fo)
    with plain_kernels(fa, fd):
        plain = loss_and_grads(torch, model, batch, is_seq2seq=False)
    # one gradient is 12.7 GB: at most two are kept
    k32 = grad_dist(kernel, plain)
    del kernel
    with swapped_kv_groups(fa, lm.config.num_attention_heads // lm.config.num_key_value_heads):
        fault = loss_and_grads(torch, model, batch, is_seq2seq=False)
    f32 = grad_dist(fault, plain)
    model.eval()
    say({"phase": "mixtral_grad_check", "dtype": "float32", "layers": MIXTRAL_LAYERS,
         "batch_shape": list(batch["input_ids"].shape), "moe_aux_weight": lm.config.moe_aux_weight,
         "moe_capacity_factor": lm.config.moe_capacity_factor, "kernel_vs_plain": k32,
         "planted_fault": "kernels 2-3 read the K/V groups repeated in the swapped order",
         "planted_fault_vs_plain": f32, "limits": GRAD_LIMITS, "loss": plain[0],
         "kernel_launches": launched})
    want = {"flash_attention_fwd": MIXTRAL_LAYERS, "flash_attention_bwd_dq": MIXTRAL_LAYERS,
            "flash_attention_bwd_dkv": MIXTRAL_LAYERS}
    if any(launched[k] != v for k, v in want.items()):
        fail(f"mixtral fp32 gradient check launches {launched}, expected {want}")
    for key, lim in GRAD_LIMITS.items():
        if not k32[key] <= lim:
            fail(f"mixtral fp32 gradient check: kernel path vs plain path {key} {k32[key]} > "
                 f"{lim}")
    if not any(f32[key] > lim for key, lim in GRAD_LIMITS.items()):
        fail(f"mixtral fp32 gradient check: the planted fault stays within every limit: {f32}")
    del plain, fault


@contextlib.contextmanager
def training_capacity_decode():
    """Planted fault: every MoE layer routes at its training capacity in a
    cached pass too (no_drop ignored): a decode step of 8 rows gives each
    expert ceil(2 x 8 / 8 x 1.25) = 3 slots, and choices past them drop."""
    from distributed_llms_example_tpu_torch.ops.moe import MoEMLP

    real = MoEMLP.forward
    MoEMLP.forward = lambda self, x, no_drop=False: real(self, x, no_drop=False)
    try:
        yield
    finally:
        MoEMLP.forward = real


def mixtral_serve_parity(torch, fa, lm) -> None:
    """(a) fp32 at 2 layers: 8 of phase 11's prompts at a 512 bucket, a
    prefill + 4 greedy decode steps, paged (kernel 6) and flat (kernel 5):
    the kernel path within LLAMA_FP32_ATOL of the plain path on each, the
    paged and flat greedy tokens equal, and the cached logits (the prefill's
    last and the 4 steps') within LLAMA_FP32_ATOL of an uncached forward of
    the same tokens at capacity -1 (no-drop).  Planted: a decode offset
    shifted by one (on each route) and a decode routed at the training
    capacity must each break its check."""
    import numpy as np

    from distributed_llms_example_tpu_torch.data.tokenizer import ByteTokenizer
    from distributed_llms_example_tpu_torch.evaluation.generation import causal_prefill
    from distributed_llms_example_tpu_torch.ops.moe import MoEMLP

    model, cfg = lm.module.eval(), lm.config
    prompts = os.path.join(WORK, "llama_prompts.json")
    if not os.path.exists(prompts):
        write_llama_prompts(prompts)
    with open(prompts) as f:
        texts = json.load(f)[:8]
    tok, P = ByteTokenizer(), MIXTRAL_PARITY_BUCKET
    ids = np.zeros((8, P), np.int64)
    mask = np.zeros((8, P), np.int32)
    for r, t in enumerate(texts):
        row = tok.encode_prompt(t, P)
        ids[r, : len(row)] = row
        mask[r, : len(row)] = 1
    out = {}
    with torch.inference_mode():
        chunk, full_mask, lengths, first = causal_prefill(
            model, torch.as_tensor(ids, device="cuda"), torch.as_tensor(mask, device="cuda"), 128)
        args = (torch, model, chunk, full_mask, lengths, first)
        for route, counter in (("paged", fa.flash_decode_paged), ("flat", fa.flash_decode)):
            counter.launches = 0
            kernel = decode_logits(*args, paged=route == "paged")
            launched = counter.launches
            with decode_route(fa, "plain"):
                plain = decode_logits(*args, paged=route == "paged")
            with decode_route(fa, "fault"):
                fault = decode_logits(*args, paged=route == "paged")
            out[route] = dict(kernel=kernel, launched=launched,
                              err=float((kernel - plain).abs().max()),
                              fault_err=float((fault - plain).abs().max()))
            del plain, fault
        with training_capacity_decode():
            dropped = decode_logits(*args, paged=False)
        # the uncached reference: each row's prompt, then the four tokens the
        # decode fed, one pass at capacity -1 (width padded to 640)
        fed = [first.argmax(-1)] + [s.argmax(-1) for s in out["flat"]["kernel"][:3]]
        n = lengths.long()
        seqs = torch.zeros((8, 640), dtype=torch.long, device="cuda")
        seqs[:, :P] = torch.as_tensor(ids, device="cuda")
        rows = torch.arange(8, device="cuda")
        for t, x in enumerate(fed):
            seqs[rows, n + t] = x
        seq_mask = (torch.arange(640, device="cuda")[None] < (n + 4)[:, None]).long()
        layers = [m for m in model.modules() if isinstance(m, MoEMLP)]
        for m in layers:
            m.capacity_factor = -1.0
        try:
            full = model(seqs, seq_mask).float()
        finally:
            for m in layers:
                m.capacity_factor = cfg.moe_capacity_factor
        want = torch.stack([full[rows, n - 1]] + [full[rows, n + t] for t in range(4)])
        cached = torch.cat([first.float()[None], out["flat"]["kernel"]])
        nodrop_err = float((cached - want).abs().max())
        drop_err = float((dropped - want[1:]).abs().max())
    same = bool(torch.equal(out["paged"]["kernel"].argmax(-1), out["flat"]["kernel"].argmax(-1)))
    finite = all(bool(torch.isfinite(o["kernel"]).all()) for o in out.values())
    say({"phase": "mixtral_logits_kernel_vs_plain", "layers": MIXTRAL_LAYERS, "steps": 4,
         "bucket": P, "shape": list(out["flat"]["kernel"].shape), "finite": finite,
         "fp32_atol": LLAMA_FP32_ATOL,
         **{f"{r}_{k}": v for r, o in out.items() for k, v in o.items() if k != "kernel"},
         "paged_flat_tokens_equal": same, "cached_vs_uncached_no_drop_err": nodrop_err,
         "planted_training_capacity_decode_err": drop_err,
         "max_abs_logit": float(want.abs().max())})
    for route, o in out.items():
        if o["launched"] != MIXTRAL_LAYERS * 4 or o["err"] > LLAMA_FP32_ATOL \
                or not o["fault_err"] > LLAMA_FP32_ATOL:
            fail(f"mixtral fp32 logits ({route}): {o['launched']} launches, kernel vs plain "
                 f"{o['err']}, an offset shifted by one moves them {o['fault_err']}")
    if not finite or not same or list(cached.shape) != [5, 8, cfg.vocab_size]:
        fail(f"mixtral fp32 logits: finite {finite}, paged and flat tokens equal {same}")
    if not nodrop_err <= LLAMA_FP32_ATOL or not drop_err > LLAMA_FP32_ATOL:
        fail(f"mixtral fp32: cached vs uncached no-drop {nodrop_err}; a decode at the training "
             f"capacity moves them {drop_err}")


def mixtral_serve_phase(torch, fa, cli) -> dict:
    """(d) serve --paged-kv and flat through the CLI, bf16, 2 layers, phase
    11's 16 prompts, 8 slots, 32 new tokens: exact launches of kernels 1, 5
    and 6 (``serve16``), the paged and flat greedy tokens equal; decode
    tokens/s, TTFT and the cache's bytes a token beside the reckoning.
    Returns the runs' summed launches."""
    lm = mixtral_model(torch, dtype=torch.bfloat16)
    prompts = os.path.join(WORK, "llama_prompts.json")
    if not os.path.exists(prompts):
        write_llama_prompts(prompts)
    cfg = lm.config
    reckoned = 2 * cfg.num_hidden_layers * cfg.num_key_value_heads * cfg.head_dim * 2
    runs, total = {}, {}
    for name, extra in (("paged", ["--paged-kv"]), ("flat", [])):
        r = serve16(torch, fa, cli, lm, f"mixtral_{name}", [*MIXTRAL_SERVE_ARGS, *extra],
                    prompts)
        st, line = r["stats"], r["line"]
        slots = (line["pool_blocks"] * line["kv_block_size"] if name == "paged"
                 else 8 * (1024 + 32))
        say({"phase": f"mixtral_serve_{name}", "decode_tokens_per_sec": line[
             "decode_tokens_per_sec"], "ttft_p50_ms": line["ttft_p50_ms"],
             "ttft_p95_ms": line["ttft_p95_ms"], "wall_s": line["wall_s"],
             "cache_bytes_resident": st.cache_bytes_resident,
             "cache_bytes_per_token": st.cache_bytes_resident / slots,
             "reckoned_cache_bytes_per_token": reckoned, "peak_mem_bytes": line["peak_mem_bytes"],
             "launches": r["launches"]})
        runs[name] = r["outs"]
        for k, v in r["launches"].items():
            total[k] = total.get(k, 0) + v
    same = runs["paged"] == runs["flat"]
    say({"phase": "mixtral_paged_vs_flat_tokens", "equal": same,
         "tokens": sum(len(x) for x in runs["flat"])})
    if not same:
        fail("mixtral serve: the paged and flat greedy tokens differ")
    del lm
    free_cuda()
    return total


def mixtral_decode_kernels(torch, fa) -> None:
    """(e) Kernels 5 and 6 at Mixtral's decode shape (32 q heads over 8 kv
    heads of 128; Q = 1 and the verify block's Q = 4; bf16 and fp32)
    against their plain versions, kernel 6 bit-equal to kernel 5 on the
    gathered view (repeated 8 -> 32 as the flat path repeats it); bf16
    times of both beside SDPA on the same view and each one's bound."""
    decode_kernels_at(torch, fa, H=32, KV=8, dtypes=(torch.bfloat16, torch.float32),
                      qs=(1, 4), phase="mixtral_decode_kernel", what="mixtral", seed=18)


def decode_kernels_at(torch, fa, *, H: int, KV: int, dtypes, qs, phase: str, what: str,
                      seed: int) -> None:
    """Kernels 5 and 6 at ``H`` q heads over ``KV`` kv heads of 128 on
    ``paged_case``'s cache: each against its plain version, kernel 6
    bit-equal to kernel 5 on the gathered view (repeated to ``H``), and in
    bf16 both timed beside SDPA on the same view with their bounds."""
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(seed)
    tols = {torch.bfloat16: dict(atol=2e-2, rtol=2e-2), torch.float32: dict(atol=1e-4)}
    D = 128
    for dtype in dtypes:
        for Q in qs:
            q, kp, vp, bt, off, bias, _ = paged_case(torch, fa, dtype=dtype, Q=Q, heads_kv=KV,
                                                     gen=gen, heads=H)
            o6 = fa.flash_decode_paged(q, kp, vp, bias, block_tables=bt, offsets=off)
            po = fa.flash_decode_paged_plain(q, kp, vp, bias, block_tables=bt, offsets=off)
            view_k, view_v = (fa.gather_blocks(x, bt).repeat_interleave(H // KV, dim=1)
                              for x in (kp, vp))
            o5 = fa.flash_decode(q, view_k, view_v, bias, offsets=off)
            torch.cuda.synchronize()
            case = f"{what} decode Q={Q} H={H}/{KV} d=128 {dtype}"
            e6 = check_close(f"flash_decode_paged {case}", o6, po, **tols[dtype])
            e5 = check_close(f"flash_decode (gathered, repeated) {case}", o5, po, **tols[dtype])
            vs = float((o6.float() - o5.float()).abs().max())
            line = {"phase": phase, "case": case, "kernel6_err": e6,
                    "kernel5_err": e5, "kernel6_vs_kernel5": vs}
            if vs != 0.0:
                fail(f"{case}: kernel 6 differs from kernel 5 on the gathered view ({vs})")
            if dtype == torch.bfloat16:
                row = torch.arange(Q, device="cuda")[None, None, :, None]
                k_pos = torch.arange(view_k.shape[2], device="cuda")[None, None, None, :]
                sdpa_mask = (bias > -1) & (k_pos <= off[:, None, None, None] + row)
                alloc = (bt < 72).repeat_interleave(128, dim=1) & (bias[:, 0, 0, :] > -1)
                seen = alloc[:, None, :] & (k_pos[0, 0] <= off[:, None, None] + row[0, 0])
                live = int(seen[:, -1].sum())
                flops = 4.0 * H * D * float(seen.sum())
                io = 2 * q.numel() * 2 + bias.numel() * 4 + 8 * 4
                b6 = bound(flops, 2 * KV * live * D * 2 + io + bt.numel() * 4)
                b5 = bound(flops, 2 * H * live * D * 2 + io)
                run6 = lambda: fa.flash_decode_paged(q, kp, vp, bias, block_tables=bt,  # noqa: E731
                                                     offsets=off)
                run5 = lambda: fa.flash_decode(q, view_k, view_v, bias, offsets=off)  # noqa: E731
                line.update(
                    kernel6_ms=time_ms(run6, per_rep=200), kernel6_bound_ms=b6[0],
                    kernel6_bound_by=b6[1],
                    kernel6_plain_ms=time_ms(lambda: fa.flash_decode_paged_plain(
                        q, kp, vp, bias, block_tables=bt, offsets=off), per_rep=20),
                    kernel5_ms=time_ms(run5, per_rep=200), kernel5_bound_ms=b5[0],
                    kernel5_bound_by=b5[1],
                    kernel5_plain_ms=time_ms(lambda: fa.flash_decode_plain(
                        q, view_k, view_v, bias, offsets=off), per_rep=20),
                    sdpa_ms=time_ms(lambda: F.scaled_dot_product_attention(
                        q, view_k, view_v, attn_mask=sdpa_mask), per_rep=100),
                    live_slots=live)
            say(line)
    free_cuda()


def mixtral_phase(torch, fa, fd, fo, cli) -> dict:
    """Phase 18: (e) the decode kernels at Mixtral's shape, (c) the train
    CLI and kernel 8's Mixtral tail, (b) the fp32 gradient check, (a) the
    fp32 serve parity, (d) the serve CLI, paged and flat.  Returns the
    launches of (c) and (d), the main path's runs."""
    t0 = time.perf_counter()
    mixtral_decode_kernels(torch, fa)
    trained, batch = mixtral_train_phase(torch, fa, fd, fo, cli)
    lm = mixtral_model(torch, dtype=torch.float32, train=True)
    mixtral_grad_check(torch, fa, fd, batch, lm)
    for p in lm.module.parameters():
        p.grad = None
    free_cuda()
    mixtral_serve_parity(torch, fa, lm)
    del lm
    free_cuda()
    served = mixtral_serve_phase(torch, fa, cli)
    say({"phase": "mixtral_wall", "seconds": time.perf_counter() - t0})
    return {k: trained.get(k, 0) + served.get(k, 0) for k in {*trained, *served}}


# phase 20: serving across ranks at llama-2-7b's widths, 2 of 32 layers,
# on two gloo ranks of cuda:0 (NCCL refuses two ranks on one card): (a)
# fp32, 8 prompts (one prefill chunk of 8), a prefill and 31 decode
# rounds, serve --mesh tensor=2 then data=2, flat and paged (blocks of 32:
# 512 + 32 = 17 of them), each held to its own one-rank run; (b) bf16, 16
# prompts, 64 new tokens, tensor=2 --paged-kv (blocks of 64), held to its
# one-rank run within ROUTE_FLOOR_FACTOR x the route floor; (c) the bf16
# ring at phase 19's shape; (d) Mixtral's routing across the two ranks
SM_LAYERS = 2
SM_W = 512
SM_FP32_NEW, SM_FP32_BLOCK, SM_FP32_PROMPTS = 32, 32, 8
SM_BF16_NEW, SM_BF16_BLOCK, SM_BF16_PROMPTS = 64, 64, 16
# fp32 decode logits, two ranks against one: the row-parallel sums (tensor)
# or the rows' own (data) in another order, far below what a rank reading
# its neighbour's slot rows or skipping o_proj's all-reduce moves
SM_LOGITS_ATOL = 1e-4
# (c): the bf16 ring's relative distance from fp32 plain attention at most
# this factor times plain bf16 attention's own
RING_BF16_FACTOR = 1.5
# (d): one MoEMLP at mixtral-8x7b's widths, fp32, batches whose first half
# (rank 0's rows) leans towards expert 0: (8, 1024), two groups of 4 096,
# one a rank (every weight's gradient compared); and (6, 1024), a group of
# 4 096 across the ranks and a padded one of 2 048 (the router's)
MOE_SHARD_CASES = (("aligned", (8, 1024), True), ("spanning", (6, 1024), False))
MOE_SHARD_AUX_W = 0.3
# output, input gradient and weight gradients: relative to their largest
# entry (the ranks' groups and expert rows are laid out differently, so the
# expert matmuls sum in other orders); the aux (~2.8) relative to itself
# (the ranks' shares sum their tokens' probabilities in two halves)
MOE_SHARD_REL = 1e-5
MOE_SHARD_AUX_REL = 1e-6
# phase 19 (b)'s eval under tensor=2: one batch of 8 records, beam 2
MP_VAL_RECORDS = 8
MP_EVAL_NEW = 16


def write_serve_mesh_prompts(path: str, n: int, seed: int) -> list[list[int]]:
    """``n`` byte-token prompts of 64-500 tokens; returns their ids."""
    import numpy as np

    from distributed_llms_example_tpu_torch.data.tokenizer import ByteTokenizer

    rng = np.random.RandomState(seed)
    alphabet = np.array(list("abcdefghijklmnopqrstuvwxyz      .,"))
    texts = ["".join(rng.choice(alphabet, rng.randint(64, 501))) for _ in range(n)]
    with open(path, "w") as f:
        json.dump(texts, f)
    tok = ByteTokenizer()
    return [tok.encode_prompt(t, SM_W) for t in texts]


def serve_mesh_model(torch, dtype):
    """llama-2-7b's widths at SM_LAYERS of its 32 layers, seed 0, in
    ``dtype`` (weights too), as a ``LoadedModel`` for the CLI's
    ``loaded=``: every rank and the one-rank run draw the same weights."""
    import dataclasses

    from distributed_llms_example_tpu_torch.models.llama import LlamaForCausalLM
    from distributed_llms_example_tpu_torch.models.registry import LLAMA_CONFIGS, LoadedModel

    cfg = dataclasses.replace(LLAMA_CONFIGS["llama-2-7b"], num_hidden_layers=SM_LAYERS)
    model = LlamaForCausalLM(cfg, dtype=dtype, param_dtype=dtype, device="cuda").eval()
    model.init_weights(torch.Generator(device="cuda").manual_seed(0))
    return LoadedModel("llama", cfg, model, is_seq2seq=False)


def serve_mesh_argv(prompts: str, out: str, *, new: int, dtype: str, extra=()) -> list[str]:
    return ["--tokenizer", "byte", "--max-slots", "8", "--max-source-length", str(SM_W),
            "--max-new-tokens", str(new), "--compute-dtype", dtype, "--lint", "off",
            "--log-every-steps", "0", "--prompts-file", prompts, "--output-file", out, *extra]


def sm_paged(block: int) -> list[str]:
    return ["--paged-kv", "--kv-block-size", str(block)]


@contextlib.contextmanager
def kernel_heads(torch):
    """The q heads each launch of kernels 1, 5 and 6 saw through
    ``ops/mha.py`` (by kernel counter name)."""
    from distributed_llms_example_tpu_torch.ops import mha

    seen: dict = {"flash_attention_fwd": set(), "flash_decode": set(),
                  "flash_decode_paged": set()}
    reals = {n: getattr(mha, n) for n in ("flash_attention", "flash_decode",
                                          "flash_decode_paged")}

    def wrap(name, key):
        def call(q, *a, **k):
            seen[key].add(int(q.shape[1]))
            return reals[name](q, *a, **k)
        return call

    mha.flash_attention = wrap("flash_attention", "flash_attention_fwd")
    mha.flash_decode = wrap("flash_decode", "flash_decode")
    mha.flash_decode_paged = wrap("flash_decode_paged", "flash_decode_paged")
    try:
        yield seen
    finally:
        for n, fn in reals.items():
            setattr(mha, n, fn)


def serve_mesh_one_rank(torch, cli, lm, prompts: str, argv: list[str], path: str) -> dict:
    """The one-rank run of (a): its tokens and every decode row's fp32
    logits, saved for the ranks (``path``)."""
    store: dict = {}
    with decode_logits_by_request(lm.module, store):
        engine, outs = cli.serve(argv, loaded=lm)
    torch.cuda.synchronize()
    torch.save({"outs": outs, "logits": {k: v.cpu() for k, v in store.items()}}, path)
    rows = len(store)
    del engine, store
    return {"outs": outs, "rows": rows}


def serve_mesh_rank_run(torch, fa, cli, lm, argv: list[str], base: dict) -> dict:
    """One serve run of (a) on a rank: the counters of kernels 1, 5 and 6
    zeroed just before and read just after, the heads each launch saw, the
    tokens (every rank holds every request's) and each decode row this
    rank computed against the one-rank run's (``base``): the largest
    |Δ logit| over every rank, and the rows covered by all of them."""
    from distributed_llms_example_tpu_torch.ops.mha import MultiHeadAttention

    dist = torch.distributed
    store: dict = {}
    fa.flash_attention.launches = fa.flash_decode.launches = 0
    fa.flash_decode_paged.launches = 0
    t0 = time.perf_counter()
    with kernel_heads(torch) as heads, decode_logits_by_request(lm.module, store):
        engine, outs = cli.serve(argv, loaded=lm)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"flash_attention_fwd": fa.flash_attention.launches,
                "flash_decode": fa.flash_decode.launches,
                "flash_decode_paged": fa.flash_decode_paged.launches}
    st = engine.last_stats
    layers = sum(isinstance(m, MultiHeadAttention) for m in engine.model.modules())
    # every rank prefills its rows of every chunk and steps its slot rows
    # every round: kernel 1 a layer a chunk, kernel 6 (paged) or 5 (flat) a
    # layer a round
    steps = layers * st.decode_steps
    want = {"flash_attention_fwd": layers * st.prefill_calls,
            "flash_decode": 0 if engine.paged else steps,
            "flash_decode_paged": steps if engine.paged else 0}
    err = max((float((v - base["logits"][k].to(v.device)).abs().max()) if k in base["logits"]
               else math.inf for k, v in store.items()), default=math.inf)
    worst = torch.tensor([err], dtype=torch.float64)
    dist.all_reduce(worst, op=dist.ReduceOp.MAX)
    keys = [None] * dist.get_world_size()
    dist.all_gather_object(keys, sorted(store))
    covered = set().union(*map(set, keys))
    out = {"launches": launches, "expected": want, "heads": {k: sorted(v) for k, v in
                                                               heads.items()},
           "tokens_equal": outs == base["outs"], "logit_err": float(worst[0]),
           "rows_covered": len(covered), "rows_all_covered": covered == set(base["logits"]),
           "decode_steps": st.decode_steps, "prefill_calls": st.prefill_calls,
           "wall_s": wall, "decode_tokens_per_sec": st.tokens_per_sec(),
           "cache_bytes_resident": st.cache_bytes_resident,
           "bytes_per_live_token": st.bytes_per_live_token,
           "layout": {"data": engine.layout.data, "tensor": engine.layout.tensor,
                      "rows": engine.rows}}
    if engine.paged:
        out["blocks_in_use_at_end"] = engine.pool.blocks_in_use
    del engine, store
    free_cuda()
    return out


@contextlib.contextmanager
def planted_neighbour_rows():
    """The planted fault of (a) under data: each rank reads its neighbour's
    block of the slot arrays (offsets, live flags, block tables) in place
    of its own."""
    from distributed_llms_example_tpu_torch.serving import engine as eng

    real = eng.ServingEngine.local

    def neighbour(self, a):
        if a is None or self.layout.data == 1:
            return a
        j = (self.layout.data_index + 1) % self.layout.data
        return a[j * self.rows:(j + 1) * self.rows]

    eng.ServingEngine.local = neighbour
    try:
        yield
    finally:
        eng.ServingEngine.local = real


@contextlib.contextmanager
def planted_unreduced_o_proj():
    """The planted fault of (a) under tensor: attention's o_proj output
    left un-reduced (each rank keeps its heads' partial sum; the MLP's
    all-reduce stays, so both ranks meet in every collective)."""
    from distributed_llms_example_tpu_torch.ops import mha

    real = mha.reduce_from_tensor
    mha.reduce_from_tensor = lambda x, group: x
    try:
        yield
    finally:
        mha.reduce_from_tensor = real


def ring_bf16_rank_main(torch, rank: int) -> dict:
    """(c) on one rank: phase 19 (a)'s seeded inputs and padding, the ring
    forward and backward in fp32 and in bf16, each timed over both ranks;
    rank 0 also plain attention over the whole length in fp32 (the
    reference) and in bf16: each bf16 route's distance from it, relative
    to its largest entry."""
    from distributed_llms_example_tpu_torch.ops import ring_attention as ra
    from distributed_llms_example_tpu_torch.ops.attention import (
        NEG_INF,
        dot_product_attention,
        make_causal_bias,
    )
    from distributed_llms_example_tpu_torch.parallel.activation import merge_sequence

    world = torch.distributed.get_world_size()
    group = torch.distributed.group.WORLD
    B, H, S, D = RING_SHAPE
    gen = torch.Generator(device="cuda").manual_seed(19)
    q, k, v, dout = (torch.randn(B, H, S, D, generator=gen, device="cuda") for _ in range(4))
    lens = torch.tensor([S - 37 * i for i in range(B)], device="cuda")
    bias = torch.where(torch.arange(S, device="cuda")[None, :] < lens[:, None], 0.0,
                       NEG_INF)[:, None, None, :].contiguous()
    ring = ra.Ring(group, world, rank)

    def run(dt):
        blocks = [t.chunk(world, dim=2)[rank].to(dt).clone().requires_grad_(True)
                  for t in (q, k, v)]
        out = ra.ring_attention(*blocks, bias.chunk(world, dim=-1)[rank].contiguous(),
                                ring=ring, causal=True)
        out.backward(dout.chunk(world, dim=2)[rank].to(dt))
        got = [out.detach()] + [b.grad for b in blocks]
        return [merge_sequence(t.float().contiguous(), group, world, dim=2) for t in got]

    def timed(dt):
        run(dt)  # warm
        torch.cuda.synchronize()
        torch.distributed.barrier()
        t0 = time.perf_counter()
        res = run(dt)
        torch.cuda.synchronize()
        return res, (time.perf_counter() - t0) * 1e3

    got32, ms32 = timed(torch.float32)
    del got32
    got16, ms16 = timed(torch.bfloat16)
    out = {"ring_fp32_ms": ms32, "ring_bf16_ms": ms16}
    if rank != 0:
        return out

    def plain(dt):
        leaves = [t.to(dt).clone().requires_grad_(True) for t in (q, k, v)]
        o = dot_product_attention(*leaves, bias + make_causal_bias(S, S, device="cuda"),
                                  scale=D ** -0.5, dtype=dt)
        o.backward(dout.to(dt))
        return [o.detach().float()] + [t.grad.float() for t in leaves]

    want, plain16 = plain(torch.float32), plain(torch.bfloat16)
    names = ("out", "dq", "dk", "dv")

    def rel(a):
        return {n: float((x - y).abs().max() / y.abs().max()) for n, x, y in zip(names, a, want)}

    out.update(ring_bf16_rel_err=rel(got16), plain_bf16_rel_err=rel(plain16))
    return out


def moe_shard_rank_main(torch, rank: int) -> dict:
    """(d) on one rank: one MoEMLP at mixtral-8x7b's widths, fp32, seeded
    alike on both ranks, over the ranks as ``data=2`` splits a batch whose
    first half leans towards expert 0 (``ops/moe.attach_batch_shards``),
    for each of ``MOE_SHARD_CASES``: the output and the input's gradient
    gathered, the aux shares, the dropped (token, choice) pairs and the
    router's gradient summed (with ``full``, every expert's too); each rank
    routing alone (the layer before the exchange), its output gathered and
    its aux averaged as the step weighed it.  Rank 0 then runs the whole
    batch alone and reads every difference."""
    from distributed_llms_example_tpu_torch.ops import moe

    dist = torch.distributed
    world = dist.get_world_size()
    d, ff, E = 4096, 14336, 8
    gen = torch.Generator(device="cuda").manual_seed(20)
    layer = moe.MoEMLP(d, ff, E, top_k=2, capacity_factor=1.25, device="cuda")
    with torch.no_grad():
        for p in layer.parameters():
            p.normal_(0.0, d ** -0.5, generator=gen)
    toward = layer.router.weight.detach()[0]
    drops: list = []
    route = moe.MoEMLP.route

    def counting(self, tokens, valid, capacity, exchange):
        index, combine, aux = route(self, tokens, valid, capacity, exchange)
        drops.append(((combine == 0).float() * valid[..., None]).sum())
        return index, combine, aux

    def run(xs, dy, shards, full):
        moe.attach_batch_shards(layer, shards)
        layer.zero_grad(set_to_none=True)
        xs = xs.clone().requires_grad_(True)
        drops.clear()
        t0 = time.perf_counter()
        o, aux = layer(xs)
        ((o * dy).sum() + MOE_SHARD_AUX_W * aux).backward()
        torch.cuda.synchronize()
        return {"out": o.detach(), "aux": aux.detach().reshape(1), "dx": xs.grad,
                "drops": drops[0].reshape(1), "ms": (time.perf_counter() - t0) * 1e3,
                "grads": {n: p.grad for n, p in layer.named_parameters()
                          if full or n.startswith("router")}}

    def gather(t):
        parts = [torch.empty_like(t) for _ in range(world)]
        dist.all_gather(parts, t.contiguous())
        return torch.cat(parts)

    def rel(a, b):
        return float((a - b).abs().max() / b.abs().max())

    out: dict = {}
    moe.MoEMLP.route = counting
    try:
        for name, (B, S), full in MOE_SHARD_CASES:
            x = torch.randn(B, S, d, generator=gen, device="cuda")
            x[: B // 2] += 3.0 * toward / toward.norm()
            dout = torch.randn(B, S, d, generator=gen, device="cuda")
            mine = run(x.chunk(world)[rank], dout.chunk(world)[rank],
                       moe.BatchShards(None, world, rank), full)
            with torch.no_grad():
                moe.attach_batch_shards(layer, None)
                o_alone, aux_alone = layer(x.chunk(world)[rank])
            totals = torch.cat([mine["aux"], mine["drops"], aux_alone.reshape(1) / world])
            dist.all_reduce(totals)
            for g in mine["grads"].values():
                dist.all_reduce(g)
            two = {"out": gather(mine["out"]), "dx": gather(mine["dx"]), "grads": mine["grads"]}
            alone = gather(o_alone)
            case = {"rows": [B, S], "full_gradients": full, "two_rank_fwd_bwd_ms": mine["ms"]}
            del mine, o_alone
            if rank == 0:
                one = run(x, dout, None, full)
                case.update(
                    out_rel=rel(two["out"], one["out"]), dx_rel=rel(two["dx"], one["dx"]),
                    grad_rel={n: rel(two["grads"][n], g) for n, g in one["grads"].items()},
                    aux_two=float(totals[0]), aux_one=float(one["aux"][0]),
                    drops_two=int(totals[1]), drops_one=int(one["drops"][0]),
                    tokens=B * S, alone_rel=rel(alone, one["out"]),
                    aux_alone=float(totals[2]), one_rank_fwd_bwd_ms=one["ms"])
                del one
            out[name] = case
            del two, alone, x, dout
            layer.zero_grad(set_to_none=True)
            free_cuda()
    finally:
        moe.MoEMLP.route = route
    return out


def serve_mesh_rank_main(torch, fa, fd, fo, cli, spec: dict, rank: int) -> dict:
    """Phase 20 on one rank (``chip_smoke.py --dist-rank``): (a) serve
    --mesh tensor=2 and data=2, flat and paged, fp32, each against the
    one-rank run's tokens and logits; its planted faults; (b) bf16
    tensor=2 paged; (c) the bf16 ring; (d) Mixtral's routing."""
    out: dict = {}
    base = {name: torch.load(path) for name, path in spec["baselines"].items()}
    runs = [(f"{axis}_{name}", axis, name, sm_paged(SM_FP32_BLOCK) if name == "paged" else [])
            for axis in ("tensor", "data") for name in ("flat", "paged")]
    planted = {"planted_tensor_unreduced_o_proj": ("tensor", planted_unreduced_o_proj),
               "planted_data_neighbour_rows": ("data", planted_neighbour_rows)}
    runs += [(key, axis, "flat", []) for key, (axis, _) in planted.items()]
    for key, axis, name, extra in runs:
        lm = serve_mesh_model(torch, torch.float32)
        argv = serve_mesh_argv(spec["fp32_prompts"], os.path.join(WORK, f"sm_{key}.jsonl"),
                               new=SM_FP32_NEW, dtype="float32",
                               extra=[*extra, "--mesh", f"{axis}=2"])
        fault = planted[key][1]() if key in planted else contextlib.nullcontext()
        with fault:
            out[key] = serve_mesh_rank_run(torch, fa, cli, lm, argv, base[name])
        del lm
        free_cuda()
    # (b)
    lm = serve_mesh_model(torch, torch.bfloat16)
    fa.flash_attention.launches = fa.flash_decode.launches = 0
    fa.flash_decode_paged.launches = 0
    t0 = time.perf_counter()
    engine, outs = cli.serve(serve_mesh_argv(
        spec["bf16_prompts"], os.path.join(WORK, "sm_bf16.jsonl"), new=SM_BF16_NEW,
        dtype="bfloat16", extra=[*sm_paged(SM_BF16_BLOCK), "--mesh", "tensor=2"]), loaded=lm)
    torch.cuda.synchronize()
    st = engine.last_stats
    steps = SM_LAYERS * st.decode_steps
    out["bf16_tensor_paged"] = {
        "outs": outs, "wall_s": time.perf_counter() - t0,
        "launches": {"flash_attention_fwd": fa.flash_attention.launches,
                     "flash_decode": fa.flash_decode.launches,
                     "flash_decode_paged": fa.flash_decode_paged.launches},
        "expected": {"flash_attention_fwd": SM_LAYERS * st.prefill_calls, "flash_decode": 0,
                     "flash_decode_paged": steps},
        "decode_steps": st.decode_steps, "decode_tokens_per_sec": st.tokens_per_sec(),
        "bytes_per_live_token": st.bytes_per_live_token,
        "blocks_in_use_at_end": engine.pool.blocks_in_use}
    del engine, lm
    free_cuda()
    out["ring_bf16"] = ring_bf16_rank_main(torch, rank)
    free_cuda()
    out["moe"] = moe_shard_rank_main(torch, rank)
    return out


def serve_mesh_prepare(torch, fa, cli) -> dict:
    """Phase 20's part in this process, before phase 19's rank processes
    (which run phase 20's rank parts too): the prompts, the one-rank runs
    (fp32 flat and paged, their tokens and logits saved for the ranks; bf16
    paged), the bf16 model's route floor, and kernels 5 and 6 at a tensor=2
    rank's decode shape.  Returns what ``serve_mesh_checks`` reads, with
    ``spec``, the rank processes' part of it."""
    t0 = time.perf_counter()
    os.makedirs(WORK, exist_ok=True)
    fp32_prompts = os.path.join(WORK, "sm_fp32_prompts.json")
    bf16_prompts = os.path.join(WORK, "sm_bf16_prompts.json")
    write_serve_mesh_prompts(fp32_prompts, SM_FP32_PROMPTS, seed=20)
    bf16_ids = write_serve_mesh_prompts(bf16_prompts, SM_BF16_PROMPTS, seed=21)
    lm = serve_mesh_model(torch, torch.float32)
    baselines, one = {}, {}
    for name, extra in (("flat", []), ("paged", sm_paged(SM_FP32_BLOCK))):
        baselines[name] = os.path.join(WORK, f"sm_one_{name}.pt")
        one[name] = serve_mesh_one_rank(
            torch, cli, lm, fp32_prompts, serve_mesh_argv(
                fp32_prompts, os.path.join(WORK, f"sm_one_{name}.jsonl"), new=SM_FP32_NEW,
                dtype="float32", extra=extra), baselines[name])
    del lm
    free_cuda()
    lm16 = serve_mesh_model(torch, torch.bfloat16)
    _, plain16 = cli.serve(serve_mesh_argv(
        bf16_prompts, os.path.join(WORK, "sm_one_bf16.jsonl"), new=SM_BF16_NEW,
        dtype="bfloat16", extra=sm_paged(SM_BF16_BLOCK)), loaded=lm16)
    floor = route_floor(torch, lm16.module, bf16_ids)
    # kernels 5 and 6 at a tensor=2 rank's decode shape: 16 of llama-2-7b's
    # 32 heads (its kv heads too), Q = 1, bf16
    decode_kernels_at(torch, fa, H=16, KV=16, dtypes=(torch.bfloat16,), qs=(1,),
                      phase="local_head_decode_kernel", what="tensor=2 rank", seed=20)
    return {"spec": {"phase20": True, "baselines": baselines, "fp32_prompts": fp32_prompts,
                     "bf16_prompts": bf16_prompts},
            "one": one, "lm16": lm16, "plain16": plain16, "bf16_ids": bf16_ids,
            "floor": floor, "one_rank_s": time.perf_counter() - t0}


def serve_mesh_phase(torch, fa, fd, fo, cli, ckpt: str | None = None) -> tuple[dict, dict]:
    """Phases 19 and 20 (``ckpt``: phase 14's HF directory, or phase 19
    makes its own): phase 20's one-rank part, then one pair of rank
    processes for both phases' parts, then each phase's checks.  Returns
    rank 0's launches of phase 19 and of phase 20."""
    prep = serve_mesh_prepare(torch, fa, cli)
    model_parallel = model_parallel_phase(torch, fa, fd, fo, cli, ckpt, serving=prep)
    free_cuda()
    return model_parallel, serve_mesh_checks(torch, prep)


def serve_mesh_checks(torch, prep: dict) -> dict:
    """Phase 20's checks of the rank processes' results (``prep["result"]``,
    set by phase 19's spawn).  Returns rank 0's launches of kernels 1, 5 and
    6 in the serve runs of (a) and (b), summed."""
    t_checks = time.perf_counter()
    res, one, floor, lm16 = prep["result"], prep["one"], prep["floor"], prep.pop("lm16")
    baselines = prep["spec"]["baselines"]

    # (a) fp32 serving, two ranks against one
    launches: dict = {}
    for axis in ("tensor", "data"):
        for name in ("flat", "paged"):
            r = res[f"{axis}_{name}"]
            say({"phase": f"serve_mesh_{axis}_{name}", "backend": "gloo", "device": "cuda:0",
                 "mesh": f"{axis}=2", "compute_dtype": "float32", "layers": SM_LAYERS,
                 "prompts": SM_FP32_PROMPTS, "new_tokens": SM_FP32_NEW,
                 "one_rank_decode_rows": one[name]["rows"], "logit_limit": SM_LOGITS_ATOL, **r})
            heads = 16 if axis == "tensor" else 32
            kernel = "flash_decode_paged" if name == "paged" else "flash_decode"
            if not r["tokens_equal"] or not r["logit_err"] <= SM_LOGITS_ATOL \
                    or not r["rows_all_covered"]:
                fail(f"phase 20 (a): serve --mesh {axis}=2 {name} is not the one-rank run "
                     f"(tokens equal {r['tokens_equal']}, logits {r['logit_err']}, every row "
                     f"compared {r['rows_all_covered']})")
            if r["launches"] != r["expected"] or not r["decode_steps"] \
                    or r["heads"]["flash_attention_fwd"] != [heads] \
                    or r["heads"][kernel] != [heads]:
                fail(f"phase 20 (a): {axis}=2 {name}: launches {r['launches']} vs "
                     f"{r['expected']}, heads {r['heads']} (want {heads})")
            if name == "paged" and r["blocks_in_use_at_end"]:
                fail(f"phase 20 (a): {axis}=2 paged left {r['blocks_in_use_at_end']} blocks")
            for k, n in r["launches"].items():
                launches[k] = launches.get(k, 0) + n
    for key in ("planted_tensor_unreduced_o_proj", "planted_data_neighbour_rows"):
        r = res[key]
        broke = not r["tokens_equal"] or not r["logit_err"] <= SM_LOGITS_ATOL
        say({"phase": f"serve_mesh_{key}", "tokens_equal": r["tokens_equal"],
             "logit_err": r["logit_err"], "broke": broke})
        if not broke:
            fail(f"phase 20 (a): the planted fault {key} stayed within the check")

    # (b) bf16 tensor=2 paged against one rank, within the route floor
    b = res["bf16_tensor_paged"]
    check = end_to_end_check(torch, lm16, "bf16_tensor2_paged", prep["bf16_ids"],
                             prep["plain16"], b["outs"], floor["floor"])
    say({"phase": "serve_mesh_bf16_tensor_paged", "prompts": SM_BF16_PROMPTS,
         "new_tokens": SM_BF16_NEW, "route_floor": floor, **{k: v for k, v in b.items()
                                                             if k != "outs"}, **check})
    if check["unexplained"] or b["launches"] != b["expected"] or b["blocks_in_use_at_end"]:
        fail(f"phase 20 (b): bf16 tensor=2 against one rank: unexplained {check['unexplained']}"
             f", launches {b['launches']} vs {b['expected']}")
    for k, n in b["launches"].items():
        launches[k] = launches.get(k, 0) + n
    del lm16
    free_cuda()

    # (c) the bf16 ring
    c = res["ring_bf16"]
    say({"phase": "ring_attention_bf16", "backend": "gloo", "ranks": 2,
         "shape": list(RING_SHAPE), "causal": True, "padding": True, "factor": RING_BF16_FACTOR,
         **c})
    bad = {n: e for n, e in c["ring_bf16_rel_err"].items()
           if not e <= RING_BF16_FACTOR * c["plain_bf16_rel_err"][n]}
    if bad:
        fail(f"phase 20 (c): the bf16 ring is beyond {RING_BF16_FACTOR}x plain bf16 "
             f"attention's distance from fp32 in {bad} ({c['plain_bf16_rel_err']})")

    # (d) Mixtral's routing across the ranks
    for name, m in res["moe"].items():
        say({"phase": f"moe_routing_two_ranks_{name}", "widths": [4096, 14336, 8], "top_k": 2,
             "capacity_factor": 1.25, "rel_limit": MOE_SHARD_REL,
             "aux_rel_limit": MOE_SHARD_AUX_REL, **m})
        worst = max([m["out_rel"], m["dx_rel"], *m["grad_rel"].values()])
        aux_limit = MOE_SHARD_AUX_REL * abs(m["aux_one"])
        if not worst <= MOE_SHARD_REL or abs(m["aux_two"] - m["aux_one"]) > aux_limit \
                or m["drops_two"] != m["drops_one"] or not m["drops_one"]:
            fail(f"phase 20 (d) {name}: two ranks route unlike the whole batch (worst {worst}, "
                 f"aux {m['aux_two']} vs {m['aux_one']}, drops {m['drops_two']} vs "
                 f"{m['drops_one']})")
        if m["alone_rel"] <= MOE_SHARD_REL and abs(m["aux_alone"] - m["aux_one"]) <= aux_limit:
            fail(f"phase 20 (d) {name}: each rank routing alone matched the whole batch "
                 f"(output {m['alone_rel']}, aux {m['aux_alone']} vs {m['aux_one']})")
    for path in baselines.values():
        os.remove(path)
    say({"phase": "serve_mesh_wall", "one_rank_s": prep["one_rank_s"],
         "ranks_s": res["seconds"], "checks_s": time.perf_counter() - t_checks})
    return launches


def main() -> None:
    if not os.path.isdir(os.path.join(HERE, "distributed_llms_example_tpu_torch")):
        fail("the port's package is not beside chip_smoke.py: run it from a checkout")
    sys.path.insert(0, HERE)
    import torch

    wall0 = time.perf_counter()
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
    swapped_build = start_swapped_dkv_build(cuda_build)
    secs = cuda_build.build(KERNELS, verbose=True)
    swapped_lib = swapped_build()
    say({"phase": "build", "seconds": time.perf_counter() - t0, "per_kernel_s": secs,
         "planted_fault_build_s": time.perf_counter() - t0})

    def lap(after: str) -> None:
        """The run's seconds so far, after a group of phases: where the
        time limit goes."""
        say({"phase": "elapsed", "after": after, "seconds": time.perf_counter() - wall0})
    if sys.argv[1:2] == ["--phase"]:
        # phase 13, 15, 16, 17, 18 or 19 alone (after the build), 14 and 19
        # chained (19 on 14's HF directory), or 19 and 20 chained (20 (e)
        # is 19 (b)'s eval): a quick check of the LLaMA train path and its
        # telemetry, of the sharded paths, of the elastic path, of the
        # serving features, of the serving tier, of Mixtral, of tensor and
        # sequence parallelism or of serving across ranks
        from distributed_llms_example_tpu_torch.launch import cli

        {"13": lambda: llama_train_phase(torch, fa, fd, fo, cli),
         "14": lambda: model_parallel_phase(torch, fa, fd, fo, cli,
                                            distributed_phase(torch, fa, fd, fo, cli)[2]),
         "15": lambda: elastic_phase(torch, fa, fd, fo, cli),
         "16": lambda: serving_features_phase(torch, fa, cli, llama_7b(torch)),
         "17": lambda: serving_tier_phase(torch, fa, cli, llama_7b(torch)),
         "18": lambda: mixtral_phase(torch, fa, fd, fo, cli),
         "19": lambda: model_parallel_phase(torch, fa, fd, fo, cli),
         "20": lambda: serve_mesh_phase(torch, fa, fd, fo, cli)}[sys.argv[2]]()
        say({"phase": "wall", "seconds": time.perf_counter() - wall0})
        return
    sass_phase(cuda_build)
    resource_phase(cuda_build)
    decode_resource_phase(cuda_build)

    # phase 3: kernels against their plain versions
    measured = kernel_phase(torch, fa)
    tc_err = tc_kernel_phase(torch, fa)
    measured["flash_attention_fwd"]["max_abs_err"] = max(
        measured["flash_attention_fwd"]["max_abs_err"], tc_err)
    measured.update(backward_kernel_phase(torch, fa))
    for name, err in zip(("flash_attention_bwd_dq", "flash_attention_bwd_dkv"),
                         tc_backward_phase(torch, fa).values()):
        measured[name]["max_abs_err"] = max(measured[name]["max_abs_err"], err)
    dlbias_tc_err = tc_dlbias_phase(torch, fa)
    measured.update(dropout_kernel_phase(torch, fd))
    measured.update(adamw_kernel_phase(torch, fo))
    paged, kernel5_err_d128 = paged_kernel_phase(torch, fa)
    measured.update(paged)
    measured["flash_decode"]["max_abs_err"] = max(measured["flash_decode"]["max_abs_err"],
                                                  kernel5_err_d128)
    dlbias, lbias_errs = lbias_kernel_phase(torch, fa)
    measured.update(dlbias)
    measured["flash_attention_bwd_dlbias"]["max_abs_err"] = max(
        measured["flash_attention_bwd_dlbias"]["max_abs_err"], dlbias_tc_err)
    for name, key in (("flash_attention_fwd", "fwd"), ("flash_attention_bwd_dq", "dq"),
                      ("flash_attention_bwd_dkv", "dkv")):
        measured[name]["max_abs_err"] = max(measured[name]["max_abs_err"], lbias_errs[key])
    measured.update(probs_dropout_phase(torch, fa, swapped_lib))
    lap("3")

    # phases 4-6: the main paths
    from distributed_llms_example_tpu_torch.launch import cli

    launches = serve_phase(torch, fa, cli)
    torch.cuda.empty_cache()
    lap("4")
    train_launches, trainer = train_phase(torch, fa, fd, fo, cli, budget=True)
    trainer.opt_state = None
    for p in trainer.model.parameters():
        p.grad = None
    torch.cuda.empty_cache()
    grad_check_phase(torch, fa, fd, trainer)
    del trainer
    free_cuda()

    # phases 5b-6b: bart-large-cnn fine-tuned from phase 5's saved HF
    # checkpoint with attention_dropout set: kernels 1-3's dropout instances
    # on the train path, and the fp32 gradient check with probs dropout
    ckpt = linked_checkpoint(os.path.join(WORK, "bart-large-cnn-out", "model"),
                             "bart-large-cnn-attention-dropout", attention_dropout=PROBS_DROPOUT)
    drop_train, trainer = train_phase(torch, fa, fd, fo, cli, ckpt, probs_dropout=PROBS_DROPOUT)
    trainer.opt_state = None
    for p in trainer.model.parameters():
        p.grad = None
    torch.cuda.empty_cache()
    grad_check_phase(torch, fa, fd, trainer)
    del trainer
    free_cuda()

    # phase 5c: fault tolerance (preemption and resume bit-equal, the rewind
    # on kernel 8's non-finite count, the health numerics, checkpoint costs)
    lap("5-6b")
    ft_launches = fault_tolerance_phase(torch, fa, fd, fo, cli)
    free_cuda()
    lap("5c")

    # phases 6c-6d: the eval pass (bart-large-cnn fine-tuned from phase 5's
    # checkpoint, scored with beam 2 on a validation file through kernels 1
    # and 5) and the beam search's kernel path against its plain path
    eval_launches = eval_phase(torch, fa, fd, fo, cli)
    free_cuda()
    beam_kernel_time(torch, fa)
    beam_check_phase(torch, fa)
    lap("6c-6d")

    # phases 7-10: T5 — t5-large training (7b: with attention-probs
    # dropout, kernels 1-4's dropout instances) and its gradient check,
    # flan-t5-xl serving and its fp32 logits check
    from distributed_llms_example_tpu_torch.train.trainer import put_batch

    t5_train, trainer = train_phase(torch, fa, fd, fo, cli, "t5-large",
                                    loaded=t5_large_train_model(torch), budget=True)
    batch = put_batch(next(iter(trainer.batches.epoch(0))), trainer.device)
    del trainer
    free_cuda()
    t5_drop_train, trainer = train_phase(torch, fa, fd, fo, cli, "t5-large",
                                         probs_dropout=PROBS_DROPOUT,
                                         loaded=t5_large_train_model(torch, PROBS_DROPOUT))
    del trainer
    free_cuda()
    t5_grad_check_drop = t5_grad_check_phase(torch, fa, fd, fo, batch)
    del batch
    t5_serve = t5_serve_phase(torch, fa, fd, fo, cli)
    t5_logits_phase(torch, fa)
    lap("7-10")

    # phases 11-12: llama-2-7b serving, paged and flat; fp32 logits
    llama_paged, llama_flat = llama_serve_phase(torch, fa, cli)
    llama_logits_phase(torch, fa)
    lap("11-12")

    # phase 13: llama-2-7b causal-LM fine-tuning at full width, 2 layers
    # (--remat --fused-ce, the causal eval), its 2-layer gradient, remat and
    # fused-CE checks, kernel 8 over its table; kernels 1-3 at its shape
    llama_train = llama_train_phase(torch, fa, fd, fo, cli)
    for name, err in llama_attention_time(torch, fa).items():
        key = {"fwd": "flash_attention_fwd", "dq": "flash_attention_bwd_dq",
               "dkv": "flash_attention_bwd_dkv"}[name]
        measured[key]["max_abs_err"] = max(measured[key]["max_abs_err"], err)
    lap("13")

    # phase 14: data-parallel and FSDP training (a world-1 NCCL group and
    # the FSDP-wrapped step bit-equal to the unwrapped one; kernel 8's
    # partial norm; two gloo ranks of the CLI under --mesh fsdp=2)
    dist_launches, finish, dist_ckpt = distributed_phase(torch, fa, fd, fo, cli)
    free_cuda()
    lap("14")

    # phase 15: elastic fine-tuning (host loss at bart-large-cnn widths, 2 +
    # 2 layers: a world-1 NCCL group kept through the reshard and re-created
    # by reinitialize_distributed; two gloo ranks rebuilt from data=2 onto
    # fsdp=2; each replay bit-equal to a clean resume; obs.report; the
    # telemetry's syncs at the log cadence only; 15e: the OOM postmortem)
    elastic_launches = elastic_phase(torch, fa, fd, fo, cli)
    free_cuda()
    lap("15")

    # phase 16: the serving features at llama-2-7b's full width (int8 KV
    # paged and flat, n-gram and draft-model speculation, the prefix cache
    # warm against cold, a real out-of-memory postmortem), kernels 5 and 6
    # at the verify shape and in their int8 branch
    lm = llama_7b(torch)
    features = serving_features_phase(torch, fa, cli, lm)
    served = features["launches"]

    # phase 17: the serving tier at llama-2-7b's width on the same model
    # (router crash, stall and drain; the open-loop sweep), a bare engine's
    # closed-loop run and phase 16's route floor its oracles
    tier = serving_tier_phase(torch, fa, cli, lm, floor=features["floor"])["launches"]
    del lm
    free_cuda()
    lap("16-17")

    # phase 18: Mixtral at mixtral-8x7b's widths, 2 layers (the decode
    # kernels at its GQA shape, the train CLI and kernel 8 over its 3.16 B
    # elements, the fp32 gradient and serve parity checks, the serve CLI)
    mixtral = mixtral_phase(torch, fa, fd, fo, cli)
    free_cuda()
    lap("18")

    # phase 19: tensor and sequence parallelism (ring attention alone at
    # llama-2-7b's train shape on two gloo ranks of cuda:0, with a planted
    # fault; the CLI under --mesh tensor=2 and sequence=2 against one rank,
    # launches exact, the export bit-equal)
    # phase 20: serving across ranks (serve --mesh tensor=2 and data=2 at
    # llama-2-7b's widths, 2 layers, against one rank, with planted faults;
    # bf16 tensor=2 within the route floor; the bf16 ring; Mixtral's routing
    # over two batch shards), its rank parts in phase 19's rank processes;
    # 20 (e), the eval under tensor=2, is 19 (b)'s
    model_parallel, serve_mesh = serve_mesh_phase(torch, fa, fd, fo, cli, dist_ckpt)
    free_cuda()
    lap("19-20")

    # the end: the TPU kernels with no port yet (none), the kernel list
    # (kernels 1-4 name both their sources: bf16 tensor-core, fp32),
    # then the contract line.  A kernel that runs on several main paths
    # reports the sum of their counts: kernel 1 the BART and T5 serve and
    # train runs, phase 5c's resumed and rewind runs, the BART eval, the
    # LLaMA serve runs' prompt prefills and the LLaMA train run and its
    # eval, the Mixtral train and serve runs and rank 0 of phase 19's
    # tensor=2 run; kernels 2, 3 and 8 the BART, T5, LLaMA and Mixtral
    # train runs and phase 5c's, phase 14's FSDP step, phase 15's host-loss
    # runs and rank 0 of phase 19's tensor=2 run (kernel 8 of its
    # sequence=2 run too; its finish entry phase 14's step, phase 15's
    # fsdp=2 steps and phase 19's tensor=2 steps), kernel 7 the BART and
    # T5 train runs and phases 5c's and 15's, kernel 4 the T5 train run,
    # kernel 5 the BART and flan-T5 serve runs, the flat LLaMA and Mixtral
    # serves, the BART eval and the LLaMA eval, kernel 6 the paged LLaMA and
    # Mixtral serves.
    say({"kernels_unported": []})
    src = "distributed_llms_example_tpu_torch/csrc/"
    ref = "distributed_llms_example_tpu/ops/"
    both = {k: train_launches[k] + t5_train[k] + ft_launches.get(k, 0) + llama_train.get(k, 0)
            + dist_launches.get(k, 0) + elastic_launches.get(k, 0) + mixtral.get(k, 0)
            + model_parallel.get(k, 0) for k in t5_train}
    rows = [
        dict(name="flash_attention_fwd", route="cuda", source=src + "flash_fwd_tc.cu",
             sources=[src + "flash_fwd_tc.cu", src + "flash_fwd.cu"],
             replaces=ref + "flash_attention.py:119",
             launches=(launches["flash_attention_fwd"] + both["flash_attention_fwd"]
                       + t5_serve["flash_attention_fwd"] + eval_launches["flash_attention_fwd"]
                       + llama_paged["flash_attention_fwd"]
                       + llama_flat["flash_attention_fwd"] + served["flash_attention_fwd"]
                       + tier["flash_attention_fwd"] + serve_mesh["flash_attention_fwd"]),
             **measured["flash_attention_fwd"]),
        dict(name="flash_decode", route="cuda", source=src + "flash_decode.cu",
             sources=[src + "flash_decode.cu", src + "flash_decode.cuh"],
             replaces=ref + "flash_attention.py:931",
             launches=(launches["flash_decode"] + llama_flat["flash_decode"]
                       + t5_serve["flash_decode"] + eval_launches["flash_decode"]
                       + llama_train["flash_decode"] + served["flash_decode"]
                       + tier["flash_decode"] + mixtral["flash_decode"]
                       + model_parallel.get("flash_decode", 0) + serve_mesh["flash_decode"]),
             **features["kernel_times"]["flash_decode"], **measured["flash_decode"]),
        dict(name="flash_decode_paged", route="cuda", source=src + "flash_decode_paged.cu",
             sources=[src + "flash_decode_paged.cu", src + "flash_decode.cuh"],
             replaces=ref + "flash_attention.py:1155",
             launches=(llama_paged["flash_decode_paged"] + served["flash_decode_paged"]
                       + tier["flash_decode_paged"] + mixtral["flash_decode_paged"]
                       + serve_mesh["flash_decode_paged"]),
             **features["kernel_times"]["flash_decode_paged"],
             **measured["flash_decode_paged"]),
        dict(name="flash_attention_bwd_dq", route="cuda", source=src + "flash_bwd_tc.cu",
             sources=[src + "flash_bwd_tc.cu", src + "flash_bwd.cu"],
             replaces=ref + "flash_attention.py:264",
             launches=both["flash_attention_bwd_dq"], **measured["flash_attention_bwd_dq"]),
        dict(name="flash_attention_bwd_dkv", route="cuda", source=src + "flash_bwd_tc.cu",
             sources=[src + "flash_bwd_tc.cu", src + "flash_bwd.cu"],
             replaces=ref + "flash_attention.py:328",
             launches=both["flash_attention_bwd_dkv"], **measured["flash_attention_bwd_dkv"]),
        dict(name="flash_attention_bwd_dlbias", route="cuda",
             source=src + "flash_bwd_dlbias_tc.cu",
             sources=[src + "flash_bwd_dlbias_tc.cu", src + "flash_bwd_dlbias.cu"],
             replaces=ref + "flash_attention.py:399",
             launches=both["flash_attention_bwd_dlbias"],
             **measured["flash_attention_bwd_dlbias"]),
        dict(name="fused_dropout", route="cuda", source=src + "fused_dropout.cu",
             replaces=ref + "fused_dropout.py:195",
             launches=both["fused_dropout"], **measured["fused_dropout"]),
        dict(name="fused_adamw", route="cuda", source=src + "fused_adamw.cu",
             entries=["fused_adamw", "fused_grad_prep", "fused_grad_norm_finish"],
             replaces=ref + "fused_optim.py:162",
             launches=(both["fused_adamw"] + both["fused_grad_prep"]
                       + both["fused_grad_norm_finish"]),
             entry_launches={k: both[k] for k in ("fused_adamw", "fused_grad_prep",
                                                  "fused_grad_norm_finish")},
             **finish, **measured["fused_adamw"]),
    ]
    # kernels 1-4's probs-dropout branch (csrc/dropout_hash.cuh in every
    # source), all on the tensor cores: the launches of the BART train run
    # from a checkpoint with attention_dropout and of the t5-large train
    # run with attn_dropout_rate (kernel 4's from that run alone); kernel
    # 4's fp32 CUDA-core dropout launches in the T5 gradient check beside
    for name, srcs, line in (
            ("flash_attention_fwd", ("flash_fwd_tc.cu", "flash_fwd.cu"), 173),
            ("flash_attention_bwd_dq", ("flash_bwd_tc.cu", "flash_bwd.cu"), 309),
            ("flash_attention_bwd_dkv", ("flash_bwd_tc.cu", "flash_bwd.cu"), 367),
            ("flash_attention_bwd_dlbias", ("flash_bwd_dlbias_tc.cu", "flash_bwd_dlbias.cu"), 446)):
        key = f"{name}_dropout"
        rows.append(dict(name=key, route="cuda", source=src + srcs[0],
                         sources=[src + x for x in (*srcs, "dropout_hash.cuh")],
                         replaces=f"{ref}flash_attention.py:{line}",
                         launches=drop_train[key] + t5_drop_train[key], **measured[key]))
    rows[-1]["grad_check_fp32_cuda_core_launches"] = t5_grad_check_drop
    say({"phase": "wall", "seconds": time.perf_counter() - wall0})
    say({"kernels": rows})
    say({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--dist-rank":
        dist_rank_main(sys.argv[2])
    elif sys.argv[1:] in ([], *(["--phase", n] for n in ("13", "14", "15", "16", "17", "18",
                                                          "19", "20"))):
        main()
        # every check passed and every line is out (the rank processes
        # were joined in their phases): leave without the interpreter's
        # teardown, where a native thread's destructor (a process group's,
        # a store's, the profiler's) once aborted a passing run after its
        # last line ("terminate called without an active exception", 134)
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(0)
    else:
        fail(f"usage: {sys.argv[0]} [--phase 13|14|15|16|17|18|19|20]")
