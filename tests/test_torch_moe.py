"""The port's ``ops/moe.MoEMLP`` against the JAX package's on the same
weights and numpy inputs, fp32, on the CPU: 3 x 24 tokens, width 16, 4
experts of width 24, the tokens skewed towards a few experts so the
capacity 1.25 drops some of them.  Five cases: capacity 1.25 with drops,
capacity -1 (no drop on every path), ``no_drop=True``, groups of 10 (72
tokens: 8 groups, the last padded), top-1.  The output within 1e-5 and the
aux loss within 1e-6 of JAX's; the gradients of a weighted sum of the
output plus the aux loss, with respect to the tokens and to every weight,
within 1e-5 of ``jax.grad``'s.  A planted fault, the k-th choices queued
from slot 0 instead of behind every (k-1)-th choice, must break the drops
case.  The capacity rule equals JAX's, and the layer runs on the meta
device (the FLOP gauge's pass).

Across batch shards (``attach_batch_shards``, two gloo ranks, each holding
half the rows as ``data=2`` splits them): d 64, 8 experts of width 128,
top-2, capacity 1.25, a (4, 512) batch, random and with rank 0's rows
pushed towards expert 0, in one global group of 2 048 and in groups of 768
(one spanning the ranks, the last padded).  The output and the input's
gradient within 1e-5, the aux (the ranks' shares summed) within 1e-6 and
every weight's gradient (summed over the ranks) within 1e-5 of its largest
entry (sums of 2 048 tokens in two orders) of the whole batch's on one rank, the dropped (token, choice) pairs equal; each rank
routing its rows alone (the layer before the exchange) must change the
skewed case's output."""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llms_example_tpu.ops.moe import MoEMLP as JaxMoE
from distributed_llms_example_tpu_torch.ops.moe import MoEMLP, expert_capacity

D, FF, E = 16, 24, 4
OUT_ATOL, AUX_ATOL, GRAD_ATOL = 1e-5, 1e-6, 1e-5
AUX_W = 0.3  # the aux loss's weight in the gradient check's scalar

# case: (top_k, capacity_factor, no_drop, group_size)
CASES = {
    "drops_1.25": (2, 1.25, False, 4096),
    "capacity_-1": (2, -1.0, False, 4096),
    "no_drop": (2, 1.25, True, 4096),
    "ragged_groups": (2, 1.25, False, 10),
    "top1": (1, 1.25, False, 4096),
}


def _inputs(seed=0):
    rng = np.random.RandomState(seed)
    # a shared offset skews the router towards a few experts
    x = (rng.randn(3, 24, D) + 1.5 * rng.randn(D)).astype(np.float32)
    cot = rng.randn(3, 24, D).astype(np.float32)
    return x, cot


@functools.lru_cache(maxsize=None)
def _jax(case):
    """(params, no_drop, output, aux, gradients of the test's scalar with
    respect to the params and the tokens) of the JAX layer on ``_inputs``."""
    K, cf, nd, gs = CASES[case]
    x, cot = _inputs()
    mod = JaxMoE(num_experts=E, intermediate_size=FF, top_k=K, capacity_factor=cf,
                 group_size=gs)
    params = jax.device_get(mod.init(jax.random.PRNGKey(1), jnp.asarray(x))["params"])

    def run(p, xx):
        out, mut = mod.apply({"params": p}, xx, no_drop=nd, mutable=["losses"])
        return out, mut["losses"]["moe_aux"]

    def scalar(p, xx):
        out, aux = run(p, xx)
        return jnp.sum(out * cot) + AUX_W * aux

    out, aux = jax.jit(run)(params, jnp.asarray(x))
    grads = jax.jit(jax.grad(scalar, argnums=(0, 1)))(params, jnp.asarray(x))
    return params, nd, np.asarray(out), float(aux), jax.device_get(grads)


def _port(case, params, cls=MoEMLP):
    K, cf, _, gs = CASES[case]
    m = cls(D, FF, E, top_k=K, capacity_factor=cf, group_size=gs)
    with torch.no_grad():
        m.router.weight.copy_(torch.tensor(np.array(params["router"]["kernel"]).T))
        for n in ("gate_proj", "up_proj", "down_proj"):
            getattr(m, n).copy_(torch.tensor(np.array(params[n])))
    return m


def _dropped(m, x, nd):
    """Choices that found no slot (the port's routing)."""
    tokens, valid, cap, exchange, _ = m.place(torch.from_numpy(x), nd)
    index, _, _ = m.route(tokens, valid, cap, exchange)
    G, g = valid.shape
    live = valid[..., None].expand(G, g, m.top_k).reshape(G, -1) > 0
    return int(((index == m.num_experts * cap) & live).sum())


@pytest.mark.parametrize("case", list(CASES))
def test_forward_matches_jax(case):
    x, _ = _inputs()
    params, nd, want, want_aux, _ = _jax(case)
    m = _port(case, params)
    with torch.no_grad():
        got, aux = m(torch.from_numpy(x), no_drop=nd)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=OUT_ATOL)
    assert abs(float(aux) - want_aux) <= AUX_ATOL
    dropped = _dropped(m, x, nd)
    if case in ("drops_1.25", "ragged_groups", "top1"):
        assert dropped > 0, case  # the case exercises the capacity limit
    else:
        assert dropped == 0, case


@pytest.mark.parametrize("case", list(CASES))
def test_gradients_match_jax(case):
    x, cot = _inputs()
    params, nd, _, _, (gp, gx) = _jax(case)
    m = _port(case, params)
    xt = torch.from_numpy(x).requires_grad_(True)
    out, aux = m(xt, no_drop=nd)
    (torch.sum(out * torch.from_numpy(cot)) + AUX_W * aux).backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), rtol=0, atol=GRAD_ATOL)
    np.testing.assert_allclose(m.router.weight.grad.numpy(),
                               np.asarray(gp["router"]["kernel"]).T, rtol=0, atol=GRAD_ATOL)
    for n in ("gate_proj", "up_proj", "down_proj"):
        np.testing.assert_allclose(getattr(m, n).grad.numpy(), np.asarray(gp[n]), rtol=0,
                                   atol=GRAD_ATOL, err_msg=n)


class _QueueFromZero(MoEMLP):
    """Planted fault: every k-th choice is queued from slot 0 of its expert,
    not behind the (k-1)-th choices of its group (two tokens then share a
    slot, and choices that should drop keep one).  One rank: the exchange
    of the counts is not needed."""

    def route(self, tokens, valid, capacity, exchange):
        E, K = self.num_experts, self.top_k
        probs = torch.softmax(self.router(tokens.float()), dim=-1)
        gate_vals, expert_idx = torch.topk(probs, K, dim=-1)
        gate_vals = gate_vals / gate_vals.sum(dim=-1, keepdim=True)
        experts = torch.arange(E)
        counts = torch.zeros(tokens.shape[0], E)
        slots, kept = [], []
        for k in range(K):
            mask_k = (expert_idx[..., k, None] == experts).float() * valid[..., None]
            pos_k = torch.cumsum(mask_k, dim=1) - mask_k  # the fault: no + counts
            counts = counts + mask_k.sum(dim=1)
            mask_k = mask_k * (pos_k < capacity)
            keep = mask_k.sum(dim=-1)
            index = expert_idx[..., k] * capacity + (pos_k * mask_k).sum(dim=-1).long()
            slots.append(torch.where(keep > 0, index, E * capacity))
            kept.append(keep)
        n_real = torch.clamp(valid.sum(), min=1.0)
        aux = E * torch.sum(counts.sum(0) / n_real * (probs * valid[..., None]).sum((0, 1))
                            / n_real)
        return (torch.stack(slots, -1).reshape(tokens.shape[0], -1),
                gate_vals * torch.stack(kept, -1), aux)


def test_planted_queue_fault_breaks_the_drops_case():
    x, _ = _inputs()
    params, _, want, _, _ = _jax("drops_1.25")
    with torch.no_grad():
        good, _ = _port("drops_1.25", params)(torch.from_numpy(x))
        bad, _ = _port("drops_1.25", params, _QueueFromZero)(torch.from_numpy(x))
    assert np.abs(good.numpy() - want).max() <= OUT_ATOL
    assert np.abs(bad.numpy() - want).max() > 100 * OUT_ATOL


@pytest.mark.parametrize("g,K,cf", [(4096, 2, 1.25), (8192, 2, 1.25), (72, 2, 1.25), (7, 1, 0.5),
                                    (5, 2, 0.01), (64, 2, -1.0), (64, 2, 0.0)])
def test_capacity_rule_matches_jax(g, K, cf):
    want = g if cf <= 0 else max(1, math.ceil(K * g / E * cf))
    assert expert_capacity(g, E, K, cf, False) == want
    assert expert_capacity(g, E, K, cf, True) == g


def test_runs_on_meta_with_static_shapes():
    """No data-dependent shape: the layer runs on the meta device, forward
    and backward, and its expert matmuls are the capacity-padded ones."""
    from torch.utils.flop_counter import FlopCounterMode

    m = MoEMLP(D, FF, E, capacity_factor=1.25, group_size=40, device="meta")
    x = torch.empty(3, 24, D, device="meta", requires_grad=True)
    with FlopCounterMode(display=False) as counter:
        out, aux = m(x)
        (out.sum() + aux).backward()
    G, cap = 2, math.ceil(2 * 40 / E * 1.25)
    n = 3 * 24
    forward = 2 * (G * 40) * D * E + 3 * 2 * G * E * cap * D * FF  # router + experts
    assert out.shape == (3, 24, D) and counter.get_total_flops() == 3 * forward
    assert n < G * 40


SHARD_D, SHARD_FF, SHARD_E = 64, 128, 8
SHARD_AUX_W = 0.3
# name, skewed toward expert 0 on rank 0's rows, group size
SHARD_CASES = [("random", False, 4096), ("skewed", True, 4096), ("skewed_g768", True, 768)]


@pytest.fixture(scope="module")
def shard_runs(tmp_path_factory):
    """The layer, the cases' inputs, the two-rank runs and the whole batch
    on one rank (with its dropped pairs)."""
    from torch_dist_helpers import spawn

    tmp = tmp_path_factory.mktemp("moe_shards")
    torch.manual_seed(3)
    config = dict(hidden_size=SHARD_D, intermediate_size=SHARD_FF, num_experts=SHARD_E,
                  top_k=2, capacity_factor=1.25)
    layer = MoEMLP(**config)
    for p in layer.parameters():
        torch.nn.init.normal_(p, std=SHARD_D ** -0.5)
    torch.save({"config": config, "state": layer.state_dict()}, tmp / "state.pt")
    rng = np.random.RandomState(11)
    arrays = {}
    toward = layer.router.weight.detach()[0].numpy()
    for name, skew, _ in SHARD_CASES:
        x = rng.randn(4, 512, SHARD_D).astype(np.float32)
        if skew:
            x[:2] += 3.0 * toward / np.linalg.norm(toward)
        arrays[f"{name}/x"] = x
        arrays[f"{name}/dout"] = rng.randn(4, 512, SHARD_D).astype(np.float32)
    np.savez(tmp / "inputs.npz", **arrays)
    cases = [{"name": n, "group_size": g} for n, _, g in SHARD_CASES]
    spec = {"ops": {"kind": "moe", "state": str(tmp / "state.pt"),
                    "inputs": str(tmp / "inputs.npz"), "cases": cases,
                    "aux_weight": SHARD_AUX_W}}
    _, _, got = spawn(spec, 2, tmp, name="moe")
    whole = []
    for (name, _, g) in SHARD_CASES:
        m = MoEMLP(**config, group_size=g)
        m.load_state_dict(layer.state_dict())
        x = torch.from_numpy(arrays[f"{name}/x"]).requires_grad_(True)
        seen = []
        route = m.route

        def counting(*a, **kw):
            out = route(*a, **kw)
            seen.append(int(((out[1] == 0).float() * a[1][..., None]).sum()))
            return out

        m.route = counting
        out, aux = m(x)
        ((out * torch.from_numpy(arrays[f"{name}/dout"])).sum() + SHARD_AUX_W * aux).backward()
        whole.append({"out": out.detach(), "dx": x.grad, "aux": float(aux.detach()),
                      "drops": seen[0],
                      "grads": {n: p.grad for n, p in m.named_parameters()}})
    return got, whole


@pytest.mark.parametrize("case", range(len(SHARD_CASES)), ids=[c[0] for c in SHARD_CASES])
def test_two_batch_shards_route_as_the_whole_batch(shard_runs, case):
    got, whole = shard_runs
    two, one = got["cases"][case], whole[case]
    assert two["drops"] == one["drops"], (two["drops"], one["drops"])
    assert float((two["out"] - one["out"]).abs().max()) <= OUT_ATOL
    assert float((two["dx"] - one["dx"]).abs().max()) <= GRAD_ATOL
    assert abs(two["aux"] - one["aux"]) <= AUX_ATOL, (two["aux"], one["aux"])
    for name, g in one["grads"].items():
        err = float((two["grads"][name] - g).abs().max())
        assert err <= GRAD_ATOL * max(1.0, float(g.abs().max())), (name, err)
    if SHARD_CASES[case][1]:
        assert one["drops"] > 0
        # each rank alone: its own groups and capacity, so other drops
        alone = got["unsharded"][case]
        assert float((alone - one["out"]).abs().max()) > 100 * OUT_ATOL
