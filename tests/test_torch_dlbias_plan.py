"""Kernel 4's launch plan (``dlbias_plan``), the pure-Python choice the
learned-bias gradient wrapper makes before it launches: bf16 goes to the
tensor-core entry (``csrc/flash_bwd_dlbias_tc.cu``) and fp32 to the
CUDA-core entry (``csrc/flash_bwd_dlbias.cu``) at every head dim and
learned-bias dtype; every tensor-core plan's shared memory fits in what one
H100 block may use and its grid covers every (query, key) pair of every
head, head index slowest; an unsupported head dim or dtype raises."""

import pytest
import torch

from distributed_llms_example_tpu_torch.ops import flash_attention as fa

LENS = (1, 128, 200, 1000, 1024)
MAX_SMEM_BYTES = 232_448  # dynamic shared memory one H100 block may use
LB_DTYPES = (torch.bfloat16, torch.float32)


@pytest.mark.parametrize("lb", LB_DTYPES)
@pytest.mark.parametrize("head_dim", fa.KERNEL_HEAD_DIMS)
def test_dtype_picks_the_entry(head_dim, lb):
    plan = fa.dlbias_plan(torch.float32, head_dim, 8, 16, 1024, 1024, lb)
    assert (plan["lib"], plan["entry"]) == ("flash_bwd_dlbias", "flash_bwd_dlbias")
    plan = fa.dlbias_plan(torch.bfloat16, head_dim, 8, 16, 1024, 1024, lb)
    assert (plan["lib"], plan["entry"]) == ("flash_bwd_dlbias_tc", "flash_bwd_dlbias_tc")
    assert plan["rows"] == 128 and plan["block_k"] == 64 and plan["stages"] >= 2
    assert plan["threads"] == 2 * plan["rows"]  # a warpgroup per 64 rows
    assert plan["lb_bytes"] == torch.finfo(lb).bits // 8


@pytest.mark.parametrize("lb", LB_DTYPES)
@pytest.mark.parametrize("head_dim", fa.KERNEL_HEAD_DIMS)
def test_plans_fit_and_cover_every_pair(head_dim, lb):
    H = 16
    for lq in LENS:
        for lk in LENS:
            p = fa.dlbias_plan(torch.bfloat16, head_dim, 8, H, lq, lk, lb)
            assert 0 < p["smem_bytes"] <= MAX_SMEM_BYTES, p
            gx, gy, gz = p["grid"]
            assert gz == H  # the slowest index: one head's CTAs run together
            assert gx * p["block_k"] >= lk > (gx - 1) * p["block_k"], p
            assert gy * p["rows"] >= lq > (gy - 1) * p["rows"], p
            # the fp32 entry sizes its own tiles: its plan is what it is passed
            assert fa.dlbias_plan(torch.float32, head_dim, 8, H, lq, lk, lb) == dict(
                lib="flash_bwd_dlbias", entry="flash_bwd_dlbias",
                lb_bytes=torch.finfo(lb).bits // 8)


@pytest.mark.parametrize("head_dim", fa.KERNEL_HEAD_DIMS)
@pytest.mark.parametrize("lb", LB_DTYPES)
def test_tensor_core_smem_counts_every_stage(head_dim, lb):
    """The bytes are the kernel's ``Smem``: a ring of batch rows, three
    deep (two at head dim 128, whose row is 96 KB), each of Q and dO (128
    rows), K and V (64 rows), lse and delta (128 floats), the key-bias tile
    (64 floats) and the stage's 8-byte mbarrier, or the staged output tile
    (128 rows of 64 elements padded by 16 bytes) where that is larger, plus
    1024 bytes to align the swizzle base."""
    rows, bk, d = 128, 64, head_dim
    lbb = torch.finfo(lb).bits // 8
    plan = fa.dlbias_plan(torch.bfloat16, d, 8, 16, 1024, 1024, lb)
    st = 2 if d == 128 else 3
    assert plan["stages"] == st
    ring = st * (2 * rows * d * 2 + 2 * bk * d * 2 + 2 * rows * 4 + bk * 4 + 8)
    want = max(ring, rows * (bk * lbb + 16)) + 1024
    assert plan["smem_bytes"] == want


@pytest.mark.parametrize("head_dim", (8, 48, 96, 256))
def test_unsupported_head_dim_raises(head_dim):
    for dtype in (torch.float32, torch.bfloat16):
        with pytest.raises(ValueError, match="head_dim"):
            fa.dlbias_plan(dtype, head_dim, 1, 1, 128, 128, torch.bfloat16)


def test_unsupported_dtypes_raise():
    with pytest.raises(ValueError, match="fp32 or bf16"):
        fa.dlbias_plan(torch.float16, 64, 1, 1, 128, 128, torch.bfloat16)
    with pytest.raises(ValueError, match="learned bias"):
        fa.dlbias_plan(torch.bfloat16, 64, 1, 1, 128, 128, torch.float16)
