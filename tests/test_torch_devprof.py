"""The port's device-time attribution (``obs/devprof.py``) on the CPU: the
account (``build_account``) and the bandwidth join
(``join_collective_bandwidth``) equal the JAX package's on seeded random
event sets in the JAX package's event shape (collectives overlapping
compute, the lane cap's overflow); a hand-written CUDA-shaped Chrome trace
gives an exact account (an aten launch in a scope, a ctypes-style launch,
a backward op linked to its forward op by sequence number, remat's
recompute on the autograd thread with a forward op of a colliding
sequence number inside it, an NCCL all-gather overlapping compute, a
memcpy, kernel 8's two entries in the optimizer scope, an unscoped
launch); and a real ``torch.profiler`` CPU capture of a 2-layer narrow
LLaMA step (remat on, the fused CE) puts time in embed, attn, mlp, head
and optimizer, its bucket sum the event sum; the scopes are open for a
capture's length only, so no other profiler sees them."""

import json

import numpy as np
import pytest
import torch

from distributed_llms_example_tpu.obs import devprof as jax_devprof
from distributed_llms_example_tpu_torch.obs import devprof

SCOPES = ["jit(step)/blocks_0/self_attn/dot_general", "jit(step)/blocks_1/mlp/fc1/dot",
          "jit(step)/embed_tokens/gather", "jit(step)/lm_head/dot",
          "jit(step)/transpose(jvp(step))/optax/adam/mul", "jit(step)/loss/reduce",
          "fusion.7", "all-reduce.3", "all-gather-start.1", "reduce-scatter.2",
          "collective-permute-done.4", "infeed.1", "copy.9"]


def _jax_events(seed: int) -> list[dict]:
    rng = np.random.RandomState(seed)
    events = []
    for _ in range(int(rng.randint(20, 200))):
        name = SCOPES[rng.randint(len(SCOPES))]
        hlo = name if rng.rand() < 0.3 and "/" not in name else ""
        lane = int(rng.randint(3))
        events.append({"name": name, "hlo_op": hlo, "ts": float(rng.randint(0, 5000)),
                       "dur": float(rng.randint(1, 400)), "pid": 1, "tid": lane})
    return events


@pytest.mark.parametrize("seed", range(6))
def test_build_account_matches_jax(seed):
    events = _jax_events(seed)
    cap = [512, 7, 3][seed % 3]  # small caps overflow the lanes
    got = devprof.build_account(events, max_lane_slices=cap)
    want = jax_devprof.build_account(events, max_lane_slices=cap)
    assert got == want
    assert got["collectives"] and got["overlap"]["collective_ms"] > 0
    if cap < 512:
        assert got["lane_slices_dropped"] > 0
    assert devprof.build_account([]) is None


@pytest.mark.parametrize("seed", range(3))
def test_join_collective_bandwidth_matches_jax(seed):
    events = _jax_events(seed)
    rng = np.random.RandomState(100 + seed)
    comm = {op: {"count": 1, "gradient_bytes": int(rng.randint(0, 1 << 24)),
                 "activation_bytes": int(rng.randint(0, 1 << 12))}
            for op in ("all-reduce", "all-gather", "reduce-scatter")}
    comm["total_bytes"] = 1
    for steps in (0, 1, 5):
        got = devprof.join_collective_bandwidth(devprof.build_account(events), comm, steps)
        want = jax_devprof.join_collective_bandwidth(jax_devprof.build_account(events), comm,
                                                     steps)
        assert got == want
    assert any("achieved_bytes_per_sec" in s for s in got["collectives"].values())


def _x(cat, name, ts, dur, tid, pid=100, **args):
    return {"ph": "X", "cat": cat, "name": name, "pid": pid, "tid": tid, "ts": ts, "dur": dur,
            "args": args}


def cuda_trace() -> list[dict]:
    """A CUDA-shaped torch.profiler trace: host thread 1 (forward), the
    autograd thread 2 (backward), kernels on device 0's streams 7 and 13."""
    ann, op, rt = "user_annotation", "cpu_op", "cuda_runtime"
    fwd = {"Sequence number": 0, "Fwd thread id": 0}
    host = [
        # forward, thread 1: an aten matmul in self_attn, and a ctypes launch
        # there (a runtime event under no op)
        _x(ann, "dllm/blocks.0.self_attn", 0, 100, 1),
        _x(op, "aten::mm", 10, 20, 1, **{**fwd, "Sequence number": 10}),
        _x(rt, "cudaLaunchKernel", 20, 2, 1, correlation=1),
        _x(rt, "cudaLaunchKernel", 50, 2, 1, correlation=2),
        _x(ann, "dllm/blocks.0.mlp", 120, 80, 1),
        _x(op, "aten::mm", 130, 20, 1, **{**fwd, "Sequence number": 11}),
        _x(rt, "cudaLaunchKernel", 135, 2, 1, correlation=3),
        # an all-gather launched from inside the mlp scope: NCCL is
        # collective wherever it is launched
        _x(rt, "cudaLaunchKernel", 150, 2, 1, correlation=7),
        _x(rt, "cudaMemcpyAsync", 105, 2, 1, correlation=8),
        # backward, thread 2: node 11's backward (no scope on this thread)
        _x(op, "autograd::engine::evaluate_function: MmBackward0", 400, 100, 2,
           **{"Sequence number": 11, "Fwd thread id": 1}),
        _x(rt, "cudaLaunchKernel", 410, 2, 2, correlation=4),
        # remat: node 10's backward recomputes the block's forward inside it,
        # opening the scopes again on this thread; the recompute's own
        # forward op carries sequence number 10 in the mlp scope, and must
        # not be the forward op a later backward op of number 10 links to
        _x(op, "autograd::engine::evaluate_function: CheckpointFunctionBackward", 520, 180, 2,
           **{"Sequence number": 10, "Fwd thread id": 1}),
        _x(ann, "dllm/blocks.0.self_attn", 530, 20, 2),
        _x(rt, "cudaLaunchKernel", 540, 2, 2, correlation=5),
        _x(ann, "dllm/blocks.0.mlp", 555, 30, 2),
        _x(op, "aten::mm", 560, 10, 2, **{**fwd, "Sequence number": 10}),
        _x(op, "autograd::engine::evaluate_function: MmBackward0", 710, 90, 2,
           **{"Sequence number": 10, "Fwd thread id": 1}),
        _x(rt, "cudaLaunchKernel", 720, 2, 2, correlation=6),
        # the optimizer tail: kernel 8's two entries, launched through ctypes
        _x(ann, "dllm/optimizer_apply_block", 900, 100, 1),
        _x(rt, "cudaLaunchKernel", 910, 2, 1, correlation=9),
        _x(rt, "cudaLaunchKernel", 920, 2, 1, correlation=10),
        # a launch in no scope and no backward op: the loss
        _x(rt, "cudaLaunchKernel", 1090, 2, 1, correlation=11),
    ]
    dev = [
        _x("kernel", "sm90_xmma_gemm_bf16bf16_bf16f32", 200, 50, 7, pid=0, correlation=1),
        _x("kernel", "flash_fwd_tc_kernel<128, 64>", 260, 40, 7, pid=0, correlation=2),
        _x("kernel", "sm90_xmma_gemm_bf16bf16_bf16f32", 310, 30, 7, pid=0, correlation=3),
        _x("kernel", "ncclDevKernel_AllGather_RING_LL(ncclDevKernelArgsStorage<4096ul>)", 330,
           60, 13, pid=0, correlation=7),
        _x("gpu_memcpy", "Memcpy HtoD (Pinned -> Device)", 100, 10, 7, pid=0, correlation=8),
        _x("kernel", "sm90_xmma_gemm_bf16bf16_bf16f32", 600, 20, 7, pid=0, correlation=4),
        _x("kernel", "flash_fwd_tc_kernel<128, 64>", 720, 40, 7, pid=0, correlation=5),
        _x("kernel", "sm90_xmma_gemm_bf16bf16_bf16f32", 800, 10, 7, pid=0, correlation=6),
        _x("kernel", "fused_adamw_kernel", 1000, 30, 7, pid=0, correlation=9),
        _x("kernel", "fused_grad_prep_kernel", 1040, 5, 7, pid=0, correlation=10),
        _x("kernel", "vectorized_elementwise_kernel<4>", 1100, 5, 7, pid=0, correlation=11),
    ]
    meta = [{"ph": "M", "name": "process_name", "pid": 0, "args": {"name": "GPU 0"}},
            {"ph": "s", "cat": "ac2g", "id": 1, "pid": 100, "tid": 1, "ts": 20}]
    return meta + host + dev


def test_cuda_trace_gives_the_exact_account(tmp_path):
    ops = devprof.device_op_events(cuda_trace())
    by_corr = {e["ts"]: (e["kind"], e["scope"]) for e in ops}
    assert by_corr == {
        200: ("kernel", "blocks.0.self_attn"), 260: ("kernel", "blocks.0.self_attn"),
        310: ("kernel", "blocks.0.mlp"), 330: ("kernel", "blocks.0.mlp"),
        100: ("memcpy", ""), 600: ("kernel", "blocks.0.mlp"),
        720: ("kernel", "blocks.0.self_attn"), 800: ("kernel", "blocks.0.self_attn"),
        1000: ("kernel", "optimizer_apply_block"), 1040: ("kernel", "optimizer_apply_block"),
        1100: ("kernel", "")}
    path = tmp_path / "cap" / "rank0.pt.trace.json"
    path.parent.mkdir()
    path.write_text(json.dumps({"traceEvents": cuda_trace()}))
    acct = devprof.device_account_from_dir(str(tmp_path / "cap"))
    assert acct["buckets_ms"] == {"embed": 0.0, "attn": 0.14, "mlp": 0.05, "head": 0.0,
                                  "optimizer": 0.035, "collective": 0.06, "infeed": 0.01,
                                  "other": 0.005}
    assert (acct["events"], acct["span_ms"], acct["busy_ms"], acct["exposed_idle_ms"]) \
        == (11, 1.005, 0.29, 0.715)
    assert acct["collectives"] == {"all-gather": {"count": 1, "time_ms": 0.06, "wall_ms": 0.06}}
    assert acct["overlap"] == {"collective_ms": 0.06, "compute_ms": 0.24,
                               "overlapped_ms": 0.01, "exposed_collective_ms": 0.05,
                               "overlap_frac": 0.1667}
    acct = devprof.join_collective_bandwidth(acct, {"all-gather": {"gradient_bytes": 600}}, 2)
    assert acct["collectives"]["all-gather"]["achieved_bytes_per_sec"] == round(1200 / 6e-5, 1)


@pytest.mark.parametrize("name,op", [
    ("ncclDevKernel_AllReduce_Sum_f32_RING_LL(x)", "all-reduce"),
    ("ncclKernel_ReduceScatter_RING_LL_Sum_float", "reduce-scatter"),
    ("ncclDevKernel_SendRecv(x)", "collective-permute"),
    ("ncclDevKernel_Broadcast_RING_LL(x)", "collective-broadcast"),
    ("c10d::allreduce_", "all-reduce"), ("c10d::_allgather_base_", "all-gather"),
    ("ncclDevKernel_Generic", "collective"), ("sm90_gemm", None)])
def test_collective_names(name, op):
    assert devprof.collective_op(name) == op
    if op is not None:
        assert devprof.classify_event(name, "", scope="blocks.0.mlp") == "collective"


def test_cpu_capture_of_a_llama_step(tmp_path, capsys):
    from distributed_llms_example_tpu_torch.models.registry import load_model
    from distributed_llms_example_tpu_torch.obs.profile import TorchProfilerBackend
    from distributed_llms_example_tpu_torch.train.optim import (
        AdamWState,
        OptimizerSpec,
        linear_schedule_with_warmup,
    )
    from distributed_llms_example_tpu_torch.train.step import train_step

    lm = load_model("llama-test", device="cpu", train=True, remat=True, fused_ce=True)
    model = lm.module.train()
    assert lm.config.num_hidden_layers == 2
    named = list(model.named_parameters())
    state = AdamWState.zeros([p.detach() for _, p in named])
    rng = np.random.RandomState(0)
    ids = torch.from_numpy(rng.randint(3, lm.config.vocab_size, (4, 32)))
    batch = {"input_ids": ids, "attention_mask": torch.ones_like(ids),
             "labels": torch.where(torch.arange(32) < 8, -100, ids)}
    spec = OptimizerSpec(learning_rate=1e-3, weight_decay=0.01, warmup_steps=0, total_steps=4,
                         max_grad_norm=1.0)
    sched = linear_schedule_with_warmup(1e-3, 0, 4)
    train_step(model, named, state, spec, sched, batch, is_seq2seq=False)
    backend = TorchProfilerBackend("cpu", lambda: model)
    backend.start(str(tmp_path))
    train_step(model, named, state, spec, sched, batch, is_seq2seq=False)
    backend.stop()
    # the scopes lived for the capture only
    assert not any(m._forward_pre_hooks or m._forward_hooks for m in model.modules())
    acct = devprof.device_account_from_dir(str(tmp_path))
    b = acct["buckets_ms"]
    assert all(b[k] > 0 for k in ("embed", "attn", "mlp", "head", "optimizer")), b
    assert b["collective"] == b["infeed"] == 0
    ops = devprof.device_op_events(devprof.load_trace_events(
        devprof.find_trace_files(str(tmp_path))[0]))
    assert acct["events"] == len(ops)
    assert abs(sum(b.values()) - sum(e["dur"] for e in ops) / 1e3) <= 0.001 * len(b)
    assert acct["busy_ms"] <= acct["span_ms"]
    capsys.readouterr()
    assert devprof.main([str(tmp_path)]) == 0
    assert json.loads(capsys.readouterr().out)["events"] == len(ops)
    assert devprof.main([str(tmp_path / "none")]) == 2


def test_scopes_open_for_a_capture_only():
    """Outside a capture neither the module hooks nor ``scope`` open a
    ``record_function``: another profiler's trace holds no ``dllm/`` range;
    inside one both do, and closing removes every hook."""
    from distributed_llms_example_tpu_torch.models.registry import load_model

    model = load_model("llama-test", device="cpu", train=True).module
    ids = torch.zeros((1, 8), dtype=torch.long)

    def scoped_names():
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            with torch.no_grad():
                model(input_ids=ids, attention_mask=torch.ones_like(ids))
            with devprof.scope("lm_head"):
                torch.ones(2) + 1
        return {e.key for e in prof.key_averages() if e.key.startswith(devprof.SCOPE_PREFIX)}

    assert scoped_names() == set()
    handles = devprof.open_module_scopes(model)
    try:
        names = scoped_names()
    finally:
        devprof.close_module_scopes(handles)
    paths = {devprof.SCOPE_PREFIX + p for p, _ in devprof._scoped_modules(model)}
    assert names == paths | {devprof.SCOPE_PREFIX + "lm_head"}
    assert len(handles) == 2 * len(paths)
    assert not any(m._forward_pre_hooks or m._forward_hooks for m in model.modules())
    assert scoped_names() == set()
