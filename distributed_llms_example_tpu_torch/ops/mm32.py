"""Mixed-precision products: ``a @ b`` from operands in the compute dtype,
accumulated and returned in fp32 (the JAX package's dots with
``preferred_element_type=jnp.float32``, and those whose fp32 accumulation
XLA keeps through an ``astype(float32)`` that follows them).  The ring
attention's tile products (``ops/ring_attention.py``) and the blockwise
cross entropy's chunk products (``ops/blockwise_ce.py``) take them.

On CUDA one ``torch.mm`` or ``torch.bmm`` with ``out_dtype=torch.float32``
(the tensor cores' bf16 or fp16 inputs, an fp32 accumulator), for which
PyTorch implements no backward; on the CPU, which has no mixed-dtype
product, the rounded operands widened first (a bf16 product is exact in
fp32).  The backward takes the fp32 gradient against the rounded operands
and returns each in its operand's own dtype: an fp32 operand (the ring's
K and V, its probabilities) keeps an fp32 gradient, so the sums over tiles
stay unrounded.
"""

from __future__ import annotations

import torch


class _MatMul32(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b, dtype):
        a_c, b_c = a.to(dtype), b.to(dtype)
        ctx.save_for_backward(a_c, b_c)
        ctx.shapes, ctx.dtypes = (a.shape, b.shape), (a.dtype, b.dtype)
        if not a.is_cuda:
            return torch.matmul(a_c.float(), b_c.float())
        if a.dim() == 2 and b.dim() == 2:
            return torch.mm(a_c, b_c, out_dtype=torch.float32)
        batch = torch.broadcast_shapes(a.shape[:-2], b.shape[:-2])
        out = torch.bmm(a_c.expand(*batch, *a.shape[-2:]).reshape(-1, *a.shape[-2:]),
                        b_c.expand(*batch, *b.shape[-2:]).reshape(-1, *b.shape[-2:]),
                        out_dtype=torch.float32)
        return out.view(*batch, a.shape[-2], b.shape[-1])

    @staticmethod
    def backward(ctx, g):
        a_c, b_c = ctx.saved_tensors
        (a_shape, b_shape), (a_dt, b_dt) = ctx.shapes, ctx.dtypes
        ga = torch.matmul(g, b_c.float().transpose(-1, -2)).sum_to_size(a_shape)
        gb = torch.matmul(a_c.float().transpose(-1, -2), g).sum_to_size(b_shape)
        return ga.to(a_dt), gb.to(b_dt), None


def mm32(a: torch.Tensor, b: torch.Tensor, dtype: torch.dtype | None = None) -> torch.Tensor:
    """``a @ b`` in fp32 from operands rounded to the compute ``dtype``
    (default ``a``'s): an fp32 product as it is, a narrower one
    accumulated in fp32 (``_MatMul32``)."""
    dtype = dtype or a.dtype
    if dtype == torch.float32:
        return torch.matmul(a, b)
    return _MatMul32.apply(a, b, dtype)
