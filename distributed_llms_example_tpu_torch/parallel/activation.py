"""Activations across the model-parallel mesh: what the JAX package leaves
to GSPMD and ``shard_map`` (its ``parallel/activation.py``), written out
for one process a rank.

- ``ModelParallel``: a rank's view of the tensor and sequence axes, which
  the trainer hands to the model's attention and MLP modules
  (``attach``): the tensor group and this rank's index on it, the
  sequence ring (its group and this rank's place on it) when the batch
  is sequence-sharded, and the mesh's axis sizes for the attention
  selection (``ops/mha.select_attention_impl``).
- Megatron's two conjugate functions over the tensor group:
  ``copy_to_tensor`` (identity forward, all-reduce backward) in front of a
  column-parallel layer, so the gradient of the replicated input is the
  sum of every rank's part (without it each rank would keep a partial sum
  and the norms' gradients would drift apart), and ``reduce_from_tensor``
  (all-reduce forward, identity backward) after a row-parallel layer.
- The sequence split of a batch (``split_sequence``) with the cross-shard
  label shift (``seq_shift_labels``: the JAX package's
  ``models/llama._seq_shift_labels``, position t's target is label t + 1
  across shard boundaries and the last shard's last column is padding),
  and the merge of a sequence-sharded activation (``merge_sequence``).
- ``hop``: one step of a ring, this rank's block to its left neighbour and
  the right neighbour's block back, as one ``all_to_all_single`` whose
  split sizes name the two neighbours.  NCCL runs it as a send and a
  receive; gloo takes CUDA tensors for it (staging them through host
  memory) where it refuses them for ``isend``/``irecv``, so one call
  serves a multi-GPU run and ranks sharing one card alike.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from distributed_llms_example_tpu_torch.data.batching import LABEL_PAD


@dataclasses.dataclass(frozen=True)
class ModelParallel:
    """A rank's place on the tensor and sequence axes.  ``mesh``: the axis
    sizes (data, fsdp, sequence, tensor) as the attention selection sees
    them (``sequence`` 1 when the batch is not sequence-sharded);
    ``tensor_group`` None at tensor 1; ``sequence_group`` None unless the
    batch is sequence-sharded."""

    mesh: dict
    tensor_group: Any = None
    tensor_index: int = 0
    sequence_group: Any = None
    sequence_index: int = 0

    @property
    def tensor(self) -> int:
        return int(self.mesh.get("tensor", 1))

    @property
    def sequence(self) -> int:
        return int(self.mesh.get("sequence", 1))

    @property
    def batch_shards(self) -> int:
        return int(self.mesh.get("data", 1)) * int(self.mesh.get("fsdp", 1))


def attach(model: torch.nn.Module, mp: ModelParallel | None) -> None:
    """Hand ``mp`` to every module of ``model`` that reads it (attention
    and the dense MLP carry a ``parallel`` attribute)."""
    for m in model.modules():
        if hasattr(m, "parallel"):
            m.parallel = mp


class _CopyToTensor(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        torch.distributed.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFromTensor(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        x = x.contiguous().clone()
        torch.distributed.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_tensor(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` (replicated over the tensor group) into a column-parallel
    layer: the identity forward, the gradient all-reduced (SUM) over
    ``group`` backward.  ``group`` None: ``x``."""
    return x if group is None else _CopyToTensor.apply(x, group)


def reduce_from_tensor(x: torch.Tensor, group) -> torch.Tensor:
    """A row-parallel layer's partial output summed over the tensor group
    (all-reduce forward, identity backward).  ``group`` None: ``x``."""
    return x if group is None else _ReduceFromTensor.apply(x, group)


def seq_shift_labels(labels: torch.Tensor, index: int, n: int) -> torch.Tensor:
    """The next-token targets of sequence shard ``index`` of ``n`` from
    the whole rows' ``labels`` (B, S): position t's target is label t + 1,
    the last shard's last column LABEL_PAD (the position the unsharded
    ``logits[:, :-1]`` drops), cut to the shard's columns."""
    pad = torch.full_like(labels[:, :1], LABEL_PAD)
    shifted = torch.cat([labels[:, 1:], pad], dim=1)
    t = labels.shape[1] // n
    return shifted[:, index * t:(index + 1) * t]


def split_sequence(batch: dict, index: int, n: int) -> dict:
    """A causal batch's whole rows -> sequence shard ``index`` of ``n``:
    ``input_ids`` and ``attention_mask`` cut to the shard's columns,
    ``labels`` already shifted across the shard boundaries
    (``seq_shift_labels``: the loss compares position t with labels t,
    no ``[:, :-1]``), and ``positions``, each row's global positions of
    the shard (RoPE and the causal mask see them)."""
    S = batch["input_ids"].shape[1]
    if S % n:
        raise ValueError(f"a width of {S} does not split over sequence={n}")
    t = S // n
    cols = slice(index * t, (index + 1) * t)
    ids = batch["input_ids"][:, cols]
    pos = torch.arange(index * t, (index + 1) * t, device=ids.device)
    return {"input_ids": ids, "attention_mask": batch["attention_mask"][:, cols],
            "labels": seq_shift_labels(batch["labels"], index, n),
            "positions": pos[None, :].expand(ids.shape[0], t).contiguous()}


def merge_sequence(x: torch.Tensor, group, n: int, dim: int = 1) -> torch.Tensor:
    """The whole length of a sequence-sharded ``x`` on every rank: the
    ring's shards gathered and joined along ``dim`` in ring order."""
    if group is None:
        return x
    parts = [torch.empty_like(x) for _ in range(n)]
    torch.distributed.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


def hop(x: torch.Tensor, group, n: int, index: int, *, reverse: bool = False):
    """Post one ring step of the flat contiguous ``x`` over ``group`` (``n``
    ranks, this one at ``index``): sent to the left neighbour and received
    from the right one (``reverse``: the other way round).  Returns (the
    receive buffer, the work to wait on before reading it)."""
    left, right = (index - 1) % n, (index + 1) % n
    to, frm = (right, left) if reverse else (left, right)
    numel = x.numel()
    out = torch.empty_like(x)
    work = torch.distributed.all_to_all_single(
        out, x, output_split_sizes=[numel if j == frm else 0 for j in range(n)],
        input_split_sizes=[numel if j == to else 0 for j in range(n)], group=group,
        async_op=True)
    return out, work
