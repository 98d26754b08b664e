"""The port's ctypes bindings, checked without a GPU.  Each CUDA wrapper is
driven once with CPU tensors, with the loader, the device check and the
stream faked; what it would pass to ``cuda_build.load`` is recorded and
held against the C source text: the named ``csrc/<lib>.cu`` exports the
symbol as ``extern "C"``, with as many parameters as the wrapper's
``argtypes``, each of the matching ctypes type, and the wrapper calls it
with that many arguments.  Every exported entry must be bound by some
wrapper.  ctypes does no such check itself: a missing argument is passed
as garbage on the card."""

import ctypes
import re

import pytest
import torch

from distributed_llms_example_tpu_torch.ops import cuda_build
from distributed_llms_example_tpu_torch.ops import flash_attention as fa
from distributed_llms_example_tpu_torch.ops import fused_dropout as fd
from distributed_llms_example_tpu_torch.ops import fused_optim as fo

C_TYPES = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p, "int": ctypes.c_int,
           "long long": ctypes.c_longlong, "float": ctypes.c_float,
           "unsigned int": ctypes.c_uint}


def c_entries() -> dict:
    """{(source stem, symbol): [ctypes type of each parameter]} of every
    ``extern "C"`` function in csrc/."""
    out = {}
    for path in sorted(cuda_build.CSRC.glob("*.cu")):
        text = path.read_text()
        for m in re.finditer(r'extern\s+"C"\s+int\s+(\w+)\s*\(([^)]*)\)', text):
            params = [" ".join(p.split()) for p in m.group(2).split(",")]
            types = []
            for p in params:
                ctype = p.rsplit(" ", 1)[0].replace(" *", "*")
                assert ctype in C_TYPES, f"{path.name}:{m.group(1)}: unmapped type in {p!r}"
                types.append(C_TYPES[ctype])
            out[(path.stem, m.group(1))] = types
    return out


def _t(*shape, dtype=torch.float32):
    return torch.zeros(*shape, dtype=dtype)


def _fwd(dtype, lb_dtype):
    q, k, v = (_t(2, 2, 80, 64, dtype=dtype) for _ in range(3))
    lb = None if lb_dtype is None else _t(1, 2, 80, 80, dtype=lb_dtype)
    fa._flash_fwd_cuda(q, k, v, _t(2, 1, 1, 80), lb, causal=False, scale=0.125)


def _bwd(entry, n_out, dtype, lb_dtype, d=32):
    q, k, v, do = (_t(2, 2, 64, d, dtype=dtype) for _ in range(4))
    lse, delta = _t(2, 2, 64), _t(2, 2, 64)
    lb = None if lb_dtype is None else _t(1, 2, 64, 64, dtype=lb_dtype)
    outs = tuple(torch.empty_like(q) for _ in range(n_out))
    return fa._bwd_cuda(entry, q, k, v, None, do, lse, delta, outs, causal=True, scale=0.125,
                        lbias=lb)


def _decode():
    q = _t(2, 2, 1, 64, dtype=torch.bfloat16)
    k, v = (_t(2, 2, 128, 64, dtype=torch.bfloat16) for _ in range(2))
    fa._flash_decode_cuda(q, k, v, None, offsets=torch.zeros(2, dtype=torch.int32),
                          k_scale=None, v_scale=None, scale=0.125)


def _paged():
    q = _t(2, 4, 1, 128, dtype=torch.bfloat16)
    pool = _t(6, 2, 16, 128, dtype=torch.bfloat16)
    fa._flash_decode_paged_cuda(q, pool, pool.clone(), None,
                                block_tables=torch.zeros(2, 3, dtype=torch.int32),
                                offsets=torch.zeros(2, dtype=torch.int32), k_scale_pool=None,
                                v_scale_pool=None, scale=0.125)


def _dropout():
    fd._dropout_cuda(_t(4, 64, dtype=torch.bfloat16), None, 7, 0.1)


def _adamw():
    p, mu, nu, g = (_t(100) for _ in range(4))
    fo._adamw_cuda(fo.leaf_table([g], [p], [mu], [nu], [True]), _t(fo.SCALARS),
                   torch.zeros(fo.STATS, dtype=torch.float64), b1=0.9, b2=0.999, eps=1e-8,
                   max_norm=1.0, wd=0.01)


def _grad_prep(partial=False):
    fo._grad_prep_cuda(fo.leaf_table([_t(100)]), _t(1), partial)


def _norm_finish():
    fo._norm_finish_cuda(torch.zeros((), dtype=torch.float64))


WRAPPERS = {
    "flash_fwd fp32": lambda: _fwd(torch.float32, torch.float32),
    "flash_fwd_tc bf16": lambda: _fwd(torch.bfloat16, None),
    "flash_fwd_tc bf16 learned bias": lambda: _fwd(torch.bfloat16, torch.bfloat16),
    "flash_bwd_dq": lambda: _bwd("flash_bwd_dq", 1, torch.float32, torch.float32),
    "flash_bwd_dkv": lambda: _bwd("flash_bwd_dkv", 2, torch.float32, None),
    "flash_bwd_dq_tc bf16": lambda: _bwd("flash_bwd_dq", 1, torch.bfloat16, None),
    "flash_bwd_dq_tc bf16 learned bias": lambda: _bwd("flash_bwd_dq", 1, torch.bfloat16,
                                                      torch.bfloat16),
    "flash_bwd_dkv_tc bf16": lambda: _bwd("flash_bwd_dkv", 2, torch.bfloat16, None),
    "flash_bwd_dkv_tc bf16 learned bias": lambda: _bwd("flash_bwd_dkv", 2, torch.bfloat16,
                                                       torch.float32),
    "flash_bwd_dlbias": lambda: _bwd("flash_bwd_dlbias", 1, torch.float32, torch.bfloat16),
    "flash_bwd_dlbias_tc bf16 learned bias": lambda: _bwd("flash_bwd_dlbias", 1, torch.bfloat16,
                                                          torch.bfloat16),
    "flash_bwd_dlbias_tc bf16 fp32 learned bias": lambda: _bwd("flash_bwd_dlbias", 1,
                                                               torch.bfloat16, torch.float32),
    "flash_decode": _decode,
    "flash_decode_paged": _paged,
    "fused_dropout": _dropout,
    "fused_adamw": _adamw,
    "fused_grad_prep": _grad_prep,
    "fused_grad_prep partial": lambda: _grad_prep(partial=True),
    "fused_grad_norm_finish": _norm_finish,
}


@pytest.fixture
def loads(monkeypatch):
    """Record every (lib, symbol, argtypes, number of call arguments)."""
    seen = []

    def fake_load(name, argtypes, symbol=None):
        def fn(*args):
            seen.append((name, symbol or name, list(argtypes), len(args)))
            return 0
        return fn

    class _Stream:
        cuda_stream = 0

    monkeypatch.setattr(cuda_build, "load", fake_load)
    monkeypatch.setattr(cuda_build, "check_inputs",
                        lambda what, tensors: next(iter(tensors.values())).device)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev=None: _Stream())
    monkeypatch.setattr(fd, "_sm_count", lambda dev: 132)
    for counter in (fa.flash_attention, fa.flash_decode, fa.flash_decode_paged,
                    fd.fused_dropout, fo.fused_adamw_leaf, fo.fused_grad_prep,
                    fo.grad_norm_finish, fa.flash_bwd_dq,
                    fa.flash_bwd_dkv, fa.flash_bwd_dlbias):
        monkeypatch.setattr(counter, "launches", counter.launches)
    for counter in (fa.flash_attention, fa.flash_bwd_dq, fa.flash_bwd_dkv, fa.flash_bwd_dlbias):
        monkeypatch.setattr(counter, "tc_launches", counter.tc_launches)
    return seen


@pytest.mark.parametrize("wrapper", list(WRAPPERS))
def test_wrapper_matches_its_c_entry(loads, wrapper):
    WRAPPERS[wrapper]()
    assert len(loads) == 1, loads
    lib, symbol, argtypes, n_args = loads[0]
    entries = c_entries()
    assert (lib, symbol) in entries, f"csrc/{lib}.cu exports no extern \"C\" {symbol}"
    assert argtypes == entries[(lib, symbol)], (lib, symbol)
    assert n_args == len(argtypes), (lib, symbol, n_args, len(argtypes))


def test_every_c_entry_is_bound(loads):
    for run in WRAPPERS.values():
        run()
    assert {(lib, symbol) for lib, symbol, _, _ in loads} == set(c_entries())


def test_bf16_forward_binds_only_the_tensor_core_entry(loads):
    """bf16 kernel-1 calls reach flash_fwd_tc at every head dim; nothing
    routes bf16 to the CUDA-core entry, and each counts as a tensor-core
    launch."""
    tc_before = fa.flash_attention.tc_launches
    for d in fa.KERNEL_HEAD_DIMS:
        for lq in (1, 200):
            q = _t(1, 2, lq, d, dtype=torch.bfloat16)
            k = v = _t(1, 2, 200, d, dtype=torch.bfloat16)
            fa._flash_fwd_cuda(q, k, v, None, None, causal=False, scale=1.0)
    assert {lib for lib, _, _, _ in loads} == {"flash_fwd_tc"}
    assert fa.flash_attention.tc_launches - tc_before == len(loads) == 8


def test_fp32_forward_binds_the_cuda_core_entry(loads):
    tc_before = fa.flash_attention.tc_launches
    _fwd(torch.float32, None)
    assert [lib for lib, _, _, _ in loads] == ["flash_fwd"]
    assert fa.flash_attention.tc_launches == tc_before


def test_bf16_backward_binds_only_the_tensor_core_entries(loads):
    """bf16 kernel-2 and kernel-3 launches reach flash_bwd_tc at every head
    dim, with or without a learned bias; nothing routes bf16 to the
    CUDA-core entries of flash_bwd."""
    for d in fa.KERNEL_HEAD_DIMS:
        for lb in (None, torch.bfloat16, torch.float32):
            for entry, n_out in (("flash_bwd_dq", 1), ("flash_bwd_dkv", 2)):
                assert _bwd(entry, n_out, torch.bfloat16, lb, d) == "flash_bwd_tc"
    assert {lib for lib, _, _, _ in loads} == {"flash_bwd_tc"}
    assert {sym for _, sym, _, _ in loads} == {"flash_bwd_dq_tc", "flash_bwd_dkv_tc"}
    assert len(loads) == 2 * 3 * len(fa.KERNEL_HEAD_DIMS)


def test_fp32_backward_binds_the_cuda_core_entries(loads):
    for entry, n_out in (("flash_bwd_dq", 1), ("flash_bwd_dkv", 2)):
        assert _bwd(entry, n_out, torch.float32, None) == "flash_bwd"
    assert [sym for _, sym, _, _ in loads] == ["flash_bwd_dq", "flash_bwd_dkv"]


def test_bf16_dlbias_binds_only_the_tensor_core_entry(loads):
    """bf16 kernel-4 launches reach flash_bwd_dlbias_tc at every head dim,
    with a bf16 or an fp32 learned bias, and each counts as a tensor-core
    launch; nothing routes bf16 to the CUDA-core entry."""
    tc_before = fa.flash_bwd_dlbias.tc_launches
    for d in fa.KERNEL_HEAD_DIMS:
        for lb in (torch.bfloat16, torch.float32):
            assert _bwd("flash_bwd_dlbias", 1, torch.bfloat16, lb, d) == "flash_bwd_dlbias_tc"
    assert {(lib, sym) for lib, sym, _, _ in loads} == {("flash_bwd_dlbias_tc",
                                                         "flash_bwd_dlbias_tc")}
    assert len(loads) == 2 * len(fa.KERNEL_HEAD_DIMS)


def test_fp32_dlbias_binds_the_cuda_core_entry(loads):
    for lb in (torch.bfloat16, torch.float32):
        assert _bwd("flash_bwd_dlbias", 1, torch.float32, lb) == "flash_bwd_dlbias"
    assert [sym for _, sym, _, _ in loads] == ["flash_bwd_dlbias"] * 2


def test_dlbias_wrapper_counts_tensor_core_launches(loads):
    """``flash_bwd_dlbias`` on tensors off the CPU (meta tensors stand in
    for CUDA ones here) launches through ``dlbias_plan``: each call adds
    one to ``launches``, and a bf16 one also to ``tc_launches``."""
    n, tc = fa.flash_bwd_dlbias.launches, fa.flash_bwd_dlbias.tc_launches
    for dtype in (torch.bfloat16, torch.float32, torch.bfloat16):
        q, k, v, do = (torch.empty(2, 2, 64, 32, dtype=dtype, device="meta") for _ in range(4))
        lse, delta = (torch.empty(2, 2, 64, device="meta") for _ in range(2))
        lb = torch.empty(1, 2, 64, 64, dtype=torch.bfloat16, device="meta")
        out = fa.flash_bwd_dlbias(q, k, v, None, lb, do, lse, delta, causal=False, scale=1.0)
        assert out.shape == lb.shape and out.dtype == lb.dtype
    assert fa.flash_bwd_dlbias.launches - n == 3
    assert fa.flash_bwd_dlbias.tc_launches - tc == 2
    assert [lib for lib, _, _, _ in loads] == ["flash_bwd_dlbias_tc", "flash_bwd_dlbias",
                                               "flash_bwd_dlbias_tc"]


def c_param_names(lib: str, symbol: str) -> list[str]:
    """The parameter names of ``csrc/<lib>.cu``'s ``extern "C"`` ``symbol``."""
    text = (cuda_build.CSRC / f"{lib}.cu").read_text()
    m = re.search(rf'extern\s+"C"\s+int\s+{symbol}\s*\(([^)]*)\)', text)
    return [" ".join(p.split()).rsplit(" ", 1)[1].lstrip("*") for p in m.group(1).split(",")]


@pytest.fixture
def calls(monkeypatch, loads):
    """Every (lib, symbol, call arguments) a wrapper would launch."""
    seen = []

    def fake_load(name, argtypes, symbol=None):
        return lambda *args: seen.append((name, symbol or name, args)) or 0

    monkeypatch.setattr(cuda_build, "load", fake_load)
    for counter in (fa.flash_attention, fa.flash_bwd_dq, fa.flash_bwd_dkv, fa.flash_bwd_dlbias):
        monkeypatch.setattr(counter, "drop_launches", counter.drop_launches)
    return seen


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("rate,seed", [(0.0, None), (0.1, 7), (0.5, -(2**31))])
def test_probs_dropout_reaches_every_kernel_entry(calls, dtype, rate, seed):
    """Kernels 1-4 in both dtypes get the probs dropout as the C entries
    name it: ``seed`` (int32), ``threshold`` (T of the JAX package's
    keep_threshold; 2^24, the instance without dropout, at rate 0) and
    ``inv_keep`` (fp32 1 / (1 - rate)); each launch with dropout adds one
    to its wrapper's ``drop_launches``."""
    from distributed_llms_example_tpu_torch.ops.fused_dropout import _inv_keep, keep_threshold

    q, k, v, do = (torch.empty(2, 2, 64, 32, dtype=dtype, device="meta") for _ in range(4))
    lse, delta = (torch.empty(2, 2, 64, device="meta") for _ in range(2))
    lb = torch.empty(1, 2, 64, 64, dtype=dtype, device="meta")
    kw = dict(dropout_rate=rate, dropout_seed=seed)
    before = [f.drop_launches for f in (fa.flash_attention, fa.flash_bwd_dq, fa.flash_bwd_dkv,
                                        fa.flash_bwd_dlbias)]
    fa.flash_attention(q, k, v, learned_bias=lb, scale=1.0, **kw)
    for fn in (fa.flash_bwd_dq, fa.flash_bwd_dkv):
        fn(q, k, v, None, do, lse, delta, lbias=lb, causal=True, scale=1.0, **kw)
    fa.flash_bwd_dlbias(q, k, v, None, lb, do, lse, delta, causal=True, scale=1.0, **kw)
    want = ((0, 1 << 24, 1.0) if rate == 0 else (seed, keep_threshold(rate), _inv_keep(rate)))
    assert len(calls) == 4
    for lib, symbol, args in calls:
        names = c_param_names(lib, symbol)
        got = tuple(args[names.index(n)] for n in ("seed", "threshold", "inv_keep"))
        assert got == want, (symbol, got)
    after = [f.drop_launches for f in (fa.flash_attention, fa.flash_bwd_dq, fa.flash_bwd_dkv,
                                       fa.flash_bwd_dlbias)]
    assert [a - b for a, b in zip(after, before)] == [int(rate > 0)] * 4


def test_cpu_tensors_never_reach_a_kernel_with_dropout(calls):
    q = torch.randn(1, 2, 16, 16)
    before = fa.flash_attention.drop_launches
    fa.flash_attention(q, q, q, dropout_rate=0.2, dropout_seed=3)
    assert calls == [] and fa.flash_attention.drop_launches == before
