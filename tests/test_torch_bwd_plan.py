"""Kernels 2 and 3's launch plan (``bwd_plan``), the pure-Python choice
the backward wrappers make before they launch: bf16 goes to the
tensor-core entries (``csrc/flash_bwd_tc.cu``) and fp32 to the CUDA-core
entries (``csrc/flash_bwd.cu``) at every head dim; every plan's shared
memory fits in what one H100 block may use; the dq grid covers every query
row and the dk/dv grid every key; an unsupported head dim or dtype
raises."""

import pytest
import torch

from distributed_llms_example_tpu_torch.ops import flash_attention as fa

LENS = (1, 128, 200, 768, 1000, 1024)
MAX_SMEM_BYTES = 232_448  # dynamic shared memory one H100 block may use
LB_DTYPES = (None, torch.bfloat16, torch.float32)


@pytest.mark.parametrize("head_dim", fa.KERNEL_HEAD_DIMS)
def test_dtype_picks_the_entries(head_dim):
    plan = fa.bwd_plan(torch.float32, head_dim, 8, 16, 1024, 1024)
    assert (plan["dq"]["lib"], plan["dq"]["entry"]) == ("flash_bwd", "flash_bwd_dq")
    assert (plan["dkv"]["lib"], plan["dkv"]["entry"]) == ("flash_bwd", "flash_bwd_dkv")
    for lb in LB_DTYPES:
        plan = fa.bwd_plan(torch.bfloat16, head_dim, 8, 16, 1024, 1024, lb)
        assert (plan["dq"]["lib"], plan["dq"]["entry"]) == ("flash_bwd_tc", "flash_bwd_dq_tc")
        assert (plan["dkv"]["lib"], plan["dkv"]["entry"]) == ("flash_bwd_tc", "flash_bwd_dkv_tc")
        for p in plan.values():
            assert p["stages"] >= 2 and p["threads"] == 2 * 64 * (p["rows"] // 64)
            assert p["lb_bytes"] == (0 if lb is None else torch.finfo(lb).bits // 8)


@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
@pytest.mark.parametrize("head_dim", fa.KERNEL_HEAD_DIMS)
def test_plans_fit_and_cover_every_row_and_key(dtype, head_dim):
    B, H = 8, 16
    for lb in LB_DTYPES:
        for lq in LENS:
            for lk in LENS:
                plan = fa.bwd_plan(dtype, head_dim, B, H, lq, lk, lb)
                for which, n in (("dq", lq), ("dkv", lk)):
                    p = plan[which]
                    assert 0 < p["smem_bytes"] <= MAX_SMEM_BYTES, (which, p)
                    gx, gy = p["grid"]
                    assert gy == B * H
                    assert gx * p["rows"] >= n > (gx - 1) * p["rows"], (which, p)


def test_tensor_core_smem_counts_every_stage():
    """The bytes are the kernels' ``DqSmem`` / ``DkvSmem``: dq holds Q and
    dO plus two stages of K, V, a learned-bias tile (rows padded by 8
    elements) and a key-bias tile; dk/dv holds K and V plus two stages of
    Q, dO, a learned-bias tile (rows of 128 keys padded by 16 bytes), lse
    and delta; both add 1024 bytes to align the swizzle base.  The query
    tile of dk/dv is 32 rows at head dim 128, 64 below it."""
    rows, bk = 128, 64
    for d, bq in ((64, 64), (128, 32)):
        plan = fa.bwd_plan(torch.bfloat16, d, 8, 16, 1024, 1024, torch.bfloat16)
        dq, dkv = plan["dq"], plan["dkv"]
        assert dq["rows"] == dkv["rows"] == rows and dq["block"] == bk and dkv["block"] == bq
        assert dq["smem_bytes"] == 2 * rows * d * 2 + 2 * (
            2 * bk * d * 2 + rows * (bk + 8) * 2 + bk * 4) + 1024
        assert dkv["smem_bytes"] == 2 * rows * d * 2 + 2 * (
            2 * bq * d * 2 + bq * (rows * 2 + 16) + 2 * bq * 4) + 1024


@pytest.mark.parametrize("head_dim", (8, 48, 96, 256))
def test_unsupported_head_dim_raises(head_dim):
    for dtype in (torch.float32, torch.bfloat16):
        with pytest.raises(ValueError, match="head_dim"):
            fa.bwd_plan(dtype, head_dim, 1, 1, 128, 128)


def test_unsupported_dtype_raises():
    with pytest.raises(ValueError, match="fp32 or bf16"):
        fa.bwd_plan(torch.float16, 64, 1, 1, 128, 128)
