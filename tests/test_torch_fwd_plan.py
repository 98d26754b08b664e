"""Kernel 1's launch plan (``fwd_plan``), the pure-Python choice the
forward wrapper makes before it launches: fp32 goes to the CUDA-core entry
(``csrc/flash_fwd.cu``) and bf16 to the tensor-core entry
(``csrc/flash_fwd_tc.cu``) at every head dim; every plan's shared memory
fits in what one H100 block may use; the grid covers every query row; an
unsupported head dim or dtype raises."""

import pytest
import torch

from distributed_llms_example_tpu_torch.ops import flash_attention as fa

Q_LENS = (1, 200, 1000, 1024)
MAX_SMEM_BYTES = 232_448  # dynamic shared memory one H100 block may use
LB_DTYPES = (None, torch.bfloat16, torch.float32)


@pytest.mark.parametrize("head_dim", fa.KERNEL_HEAD_DIMS)
def test_dtype_picks_the_entry(head_dim):
    assert fa.fwd_plan(torch.float32, head_dim, 8, 16, 1024)["entry"] == "flash_fwd"
    for lb in LB_DTYPES:
        plan = fa.fwd_plan(torch.bfloat16, head_dim, 8, 16, 1024, lb)
        assert plan["entry"] == "flash_fwd_tc"
        assert plan["block_k"] == 64 and plan["stages"] >= 2
        assert plan["threads"] == 2 * plan["rows"]


@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
@pytest.mark.parametrize("head_dim", fa.KERNEL_HEAD_DIMS)
def test_plans_fit_and_cover_every_row(dtype, head_dim):
    B, H = 8, 32
    for lb in LB_DTYPES:
        for lq in Q_LENS:
            plan = fa.fwd_plan(dtype, head_dim, B, H, lq, lb)
            assert 0 < plan["smem_bytes"] <= MAX_SMEM_BYTES, plan
            gx, gy = plan["grid"]
            assert gy == B * H
            assert gx * plan["rows"] >= lq > (gx - 1) * plan["rows"], plan


def test_tensor_core_rows_follow_the_query_length():
    """128 rows (two warpgroups) for long queries; the 64-row variant for
    q_len <= 64, such as decode cross-attention's single row."""
    for lq, rows in ((1, 64), (64, 64), (65, 128), (1024, 128)):
        assert fa.fwd_plan(torch.bfloat16, 64, 1, 1, lq)["rows"] == rows


def test_tensor_core_smem_counts_every_stage():
    """The bytes are Q plus two stages of K, V, learned-bias and key-bias
    tiles plus the 1024-byte alignment slack, as the kernel's ``Smem``."""
    plan = fa.fwd_plan(torch.bfloat16, 64, 8, 16, 1024, torch.bfloat16)
    rows, d, bk = 128, 64, 64
    want = rows * d * 2 + 2 * (2 * bk * d * 2 + rows * (bk + 8) * 2 + bk * 4) + 1024
    assert plan["rows"] == rows and plan["smem_bytes"] == want


@pytest.mark.parametrize("head_dim", (8, 48, 96, 256))
def test_unsupported_head_dim_raises(head_dim):
    for dtype in (torch.float32, torch.bfloat16):
        with pytest.raises(ValueError, match="head_dim"):
            fa.fwd_plan(dtype, head_dim, 1, 1, 128)


def test_unsupported_dtype_raises():
    with pytest.raises(ValueError, match="fp32 or bf16"):
        fa.fwd_plan(torch.float16, 64, 1, 1, 128)
