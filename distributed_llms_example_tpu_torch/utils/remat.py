"""Activation checkpointing (remat) of transformer blocks (port of the JAX
package's ``utils/remat.py``).

``--remat`` trades compute for memory: a block's activations are dropped
after its forward and recomputed in the backward.  The *policy* decides
what is still saved:

- ``full``: nothing; the whole block is recomputed;
- ``dots``: the outputs of the matmuls with no batch dimension (``aten.mm``
  and ``aten.addmm``: every ``Dense``), through selective checkpointing;
  the rest (norms, RoPE, attention, the elementwise glue) is recomputed.
  The counterpart of ``jax.checkpoint_policies.dots_with_no_batch_dims_saveable``.

Remat never changes the math: the recompute draws the dropout seeds of
the block's first run (``ops/fused_dropout.seed_tape``; the seeds come
from a host-side stream that ``preserve_rng_state`` does not cover), so
the backward sees the forward's masks and the loss and every gradient are
bit-equal to a run without remat.  ``torch.utils.checkpoint`` is imported
inside the functions that use it.
"""

from __future__ import annotations

import functools
from typing import Any, Callable

import torch

from distributed_llms_example_tpu_torch.ops.fused_dropout import seed_tape

REMAT_POLICIES = ("full", "dots")


def _dots_saveable(ctx, op, *args, **kwargs):
    from torch.utils.checkpoint import CheckpointPolicy

    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def maybe_checkpointed(policy: str | None, fn: Callable, *args: Any, **kwargs: Any) -> Any:
    """``fn(*args, **kwargs)``, under ``torch.utils.checkpoint`` (non-
    reentrant) with the named policy when one is set and autograd is
    recording (a no-grad eval or decode pass saves nothing to begin with).
    The dropout seeds ``fn`` draws are recorded on its first run and
    replayed on the recompute."""
    if policy is None or not torch.is_grad_enabled():
        return fn(*args, **kwargs)
    from torch.utils.checkpoint import (
        checkpoint,
        create_selective_checkpoint_contexts,
        noop_context_fn,
    )

    tape: list[int] = []
    runs = [0]

    def region(*a, **k):
        replay = runs[0] > 0
        runs[0] += 1
        with seed_tape(tape, replay=replay):
            return fn(*a, **k)

    context_fn = (functools.partial(create_selective_checkpoint_contexts, _dots_saveable)
                  if policy == "dots" else noop_context_fn)
    return checkpoint(region, *args, use_reentrant=False, preserve_rng_state=False,
                      context_fn=context_fn, **kwargs)
