"""The gradient of T5's relative-position bucket table through
``T5Stack.position_bias`` (the (1, H, q, kv) form that training hands to
the flash kernels as the learned bias), computed by the port's
deterministic reduction (sums along each diagonal of the (q, kv) grid, then
a one-hot diagonals x buckets product) instead of ``F.embedding``'s
scatter, whose CUDA backward adds by atomics in an order that changes from
run to run.  Held, for the bidirectional (encoder) and causal (decoder)
bucketing at q = kv in {5, 64, 200, 1024} and two non-square cases (one
with an offset):

- the forward is bit for bit ``F.embedding``'s lookup;
- the gradient agrees with ``F.embedding``'s within fp32 reassociation:
  both sum up to ~q·kv / 32 terms per bucket in different orders.  Against
  an fp64 reference the diagonal sums stay within 2.3e-7 of the largest
  entry at q = kv = 1024 while the CPU embedding backward's running sum
  drifts by 1.8e-5, so the two are held to 4e-5 of the largest entry and
  the reduction alone to 1e-6 of it against fp64;
- two backward passes give the same bits."""

import pytest
import torch
import torch.nn.functional as F

from distributed_llms_example_tpu_torch.models import t5
from distributed_llms_example_tpu_torch.models.registry import T5_CONFIGS

SHAPES = [(5, 5, 0), (64, 64, 0), (200, 200, 0), (1024, 1024, 0), (64, 200, 0), (1, 64, 10)]


def _stack(causal):
    cfg = T5_CONFIGS["t5-test"]
    stack = t5.T5Stack(cfg, causal=causal, dtype=torch.float32)
    torch.nn.init.normal_(stack.relative_attention_bias.weight,
                          generator=torch.Generator().manual_seed(0))
    return stack, cfg


@pytest.mark.parametrize("q,kv,offset", SHAPES)
@pytest.mark.parametrize("causal", (False, True))
def test_bucket_table_gradient_matches_embedding(causal, q, kv, offset):
    stack, cfg = _stack(causal)
    w = stack.relative_attention_bias.weight
    g = torch.randn(1, cfg.num_heads, q, kv, generator=torch.Generator().manual_seed(q + kv))
    bias = stack.position_bias(q, kv, offset)
    got = torch.autograd.grad(bias, w, g)[0]
    again = torch.autograd.grad(stack.position_bias(q, kv, offset), w, g)[0]
    assert torch.equal(got, again)

    rel = torch.arange(kv)[None, :] - (torch.arange(q)[:, None] + offset)
    buckets = t5.relative_position_bucket(
        rel, bidirectional=not causal, num_buckets=cfg.relative_attention_num_buckets,
        max_distance=cfg.relative_attention_max_distance)
    ref = F.embedding(buckets, w).permute(2, 0, 1)[None]
    assert torch.equal(bias, ref.contiguous())
    want = torch.autograd.grad(ref, w, g)[0]
    w64 = w.detach().double().requires_grad_(True)
    exact = torch.autograd.grad(F.embedding(buckets, w64).permute(2, 0, 1)[None], w64,
                                g.double())[0]
    top = float(exact.abs().max())
    assert float((got - want).abs().max()) <= 4e-5 * top
    assert float((got.double() - exact).abs().max()) <= 1e-6 * top
