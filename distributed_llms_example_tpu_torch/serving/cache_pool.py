"""Paged KV cache: a shared block pool + host-side free-list allocator
(port of the JAX package's ``serving/cache_pool.py``, without its
prefix-cache half).

A decode slot holds a block list over one pool tensor per cache leaf,
``(num_blocks, kv heads, block_size, head_dim)``: a request takes
``ceil(prompt_len / block_size)`` prompt blocks plus ``ceil(budget /
block_size)`` decode blocks, so its bytes follow its actual prompt, not the
worst case.  Allocation and free are host bookkeeping between steps
(``CachePool``); blocks are identityless, so any request whose block count
fits the free list is admissible.

On CUDA the decode step reads the pool through the per-slot block tables
inside the paged decode kernel (``ops/flash_attention.flash_decode_paged``)
and never builds a slot view; the plain path gathers one
(``gather_cache``), zeros at unallocated tiles, which the masks make
contribute nothing.  A freed block keeps its old contents, but every read
is masked to the owner's written region (``k_pos <= offset`` in the decode
tail, the attention mask in the prompt), so stale K/V is unreachable.

Trees are nested lists, tuples or dicts of tensors: 4-D K/V leaves and 3-D
int8 scale leaves.  The writes happen in place; each function also returns
the tree, as the JAX functions return theirs.  The chain-hash prefix index
(``block_hash``, refcounts, the warm LRU) joins with the prefix-cache
slice (ROADMAP.md).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Sequence

import numpy as np
import torch

from distributed_llms_example_tpu_torch.ops.flash_attention import gather_blocks


class CachePool:
    """Free-list allocator over cache blocks (pure host).  ``alloc`` grants
    whole or not at all; ``free`` returns blocks and raises on a double or
    foreign free.  ``blocks_free + blocks_in_use == num_blocks`` always."""

    def __init__(self, num_blocks: int, block_size: int):
        if num_blocks < 1:
            raise ValueError(f"num_blocks must be >= 1, got {num_blocks}")
        if block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {block_size}")
        self.num_blocks = int(num_blocks)
        self.block_size = int(block_size)
        # pop() from the end hands blocks out in ascending order, as in the
        # JAX package; correctness never depends on the order
        self._free: list[int] = list(range(self.num_blocks - 1, -1, -1))
        self._used: set[int] = set()

    @property
    def blocks_free(self) -> int:
        return len(self._free)

    @property
    def blocks_in_use(self) -> int:
        return len(self._used)

    def can_alloc(self, n: int) -> bool:
        return n <= len(self._free)

    def alloc(self, n: int) -> list[int] | None:
        """``n`` fresh blocks, or None when the free list is short (the
        caller defers admission — never a partial grant)."""
        if n < 0:
            raise ValueError(f"cannot alloc {n} blocks")
        if n > len(self._free):
            return None
        out = [self._free.pop() for _ in range(n)]
        self._used.update(out)
        return out

    def free(self, blocks: Sequence[int]) -> None:
        for b in blocks:
            if b not in self._used:
                raise ValueError(f"block {b} is not allocated (double-free or foreign id)")
            self._used.remove(b)
            self._free.append(b)


def blocks_needed(prompt_len: int, budget: int, block_size: int) -> int:
    """Blocks one request holds for its whole lifetime: prompt tiles by
    actual length + decode tiles by its token budget, allocated once at
    admission so a slot never stalls mid-decode waiting for a block."""
    return max(1, math.ceil(max(prompt_len, 1) / block_size)) + math.ceil(max(budget, 1) / block_size)


def build_block_row(n_tiles: int, blocks: Sequence[int], *, prompt_len: int, bucket_width: int,
                    budget: int, block_size: int, sentinel: int) -> np.ndarray:
    """One slot's block-table row: prompt tiles ``[0, ceil(len/bs))`` and
    decode tiles ``[bucket/bs, bucket/bs + ceil(budget/bs))`` take the
    allocated blocks in order; everything else (the gap between the prompt
    and the bucket width, the tail past the budget) stays ``sentinel``:
    reads of those tiles see nothing, writes drop."""
    if bucket_width % block_size:
        raise ValueError(
            f"bucket width {bucket_width} must be a multiple of the block size {block_size} "
            "(decode tiles must start on a tile boundary)"
        )
    row = np.full(n_tiles, sentinel, np.int32)
    prompt_tiles = max(1, math.ceil(max(prompt_len, 1) / block_size))
    decode_tile0 = bucket_width // block_size
    decode_tiles = math.ceil(max(budget, 1) / block_size)
    want = prompt_tiles + decode_tiles
    if len(blocks) != want:
        raise ValueError(f"got {len(blocks)} blocks for {want} tiles")
    row[:prompt_tiles] = blocks[:prompt_tiles]
    row[decode_tile0:decode_tile0 + decode_tiles] = blocks[prompt_tiles:]
    return row


# ------------------------------------------------------- device-side moves


def _map(fn, tree, *rest):
    if isinstance(tree, torch.Tensor):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: _map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return type(tree)(_map(fn, t, *(r[i] for r in rest)) for i, t in enumerate(tree))


def _leaves(tree) -> list[torch.Tensor]:
    out: list[torch.Tensor] = []
    _map(out.append, tree)
    return out


def pool_cache_tree(cache: Any, num_blocks: int, block_size: int):
    """Zeroed pool tree with the structure of a slot-view cache tree: every
    (slots, heads, len[, head_dim]) leaf becomes (num_blocks, heads,
    block_size[, head_dim]), same dtype and device."""

    def to_pool(x):
        return torch.zeros((num_blocks, x.shape[1], block_size, *x.shape[3:]), dtype=x.dtype,
                           device=x.device)

    return _map(to_pool, cache)


def gather_cache(pool_tree: Any, block_tables: torch.Tensor):
    """Slot-view cache tree from the pool through the block tables, zeros
    at sentinel tiles — the plain path's step transient (a paged decode
    layer off the kernel route reads through this)."""
    return _map(lambda x: gather_blocks(x, block_tables), pool_tree)


def step_write_plan(block_tables, offsets, *, num_blocks: int, block_size: int,
                    device: torch.device | str) -> tuple[torch.Tensor, ...]:
    """(rows, blocks, slots) on ``device`` for one decode step, from host
    block tables (S, n_tiles) and write offsets (S,): row s's new K/V go to
    block ``block_tables[s, offsets[s] // bs]`` at slot ``offsets[s] % bs``.
    Parked rows (offset past the view width) and sentinel tiles are left
    out, so their writes drop (the JAX package's ``mode="drop"``)."""
    bt = np.asarray(block_tables)
    off = np.asarray(offsets).astype(np.int64)
    n_tiles = bt.shape[1]
    tile = np.clip(off // block_size, 0, n_tiles - 1)
    blocks = bt[np.arange(bt.shape[0]), tile].astype(np.int64)
    blocks = np.where((off >= 0) & (off < n_tiles * block_size), blocks, num_blocks)
    keep = np.nonzero(blocks < num_blocks)[0]
    return tuple(torch.as_tensor(a, device=device)
                 for a in (keep, blocks[keep], off[keep] % block_size))


def scatter_step(pool_tree: Any, new_rows: Any, plan: tuple[torch.Tensor, ...]):
    """Write each slot's just-decoded row ((S, heads[, head_dim]) leaves of
    ``new_rows``) into its pool block by ``plan`` (``step_write_plan``);
    parked rows and sentinel tiles are absent from the plan, so they drop.
    A paged decode layer writes its step through this
    (``ops/mha.PagedKVCache.write_rows``)."""
    rows, blocks, slots = plan

    def scat(pool, new):
        pool[blocks, :, slots] = new[rows].to(pool.dtype)
        return pool

    return _map(scat, pool_tree, new_rows)


def scatter_admit(pool_tree: Any, chunk_cache: Any, admit_blocks, block_size: int):
    """Copy a prefilled admission chunk's allocated tiles into the pool.

    ``chunk_cache`` leaves are (chunk, heads, width[, head_dim]) at the
    bucket width + decode budget; ``admit_blocks`` is the host (chunk ×
    tiles,) block assignment with sentinel entries (>= num_blocks) for
    tiles that must not copy (padding rows, the prompt gap).  Decode tiles
    do copy: the chunk cache is zeros there, which scrubs whatever a freed
    block held."""
    admit = np.asarray(admit_blocks).astype(np.int64)

    def scat(pool, chunk):
        c, h, lc = chunk.shape[:3]
        nt = lc // block_size
        tiles = chunk.reshape(c, h, nt, block_size, *chunk.shape[3:]).transpose(1, 2)
        tiles = tiles.reshape(c * nt, h, block_size, *chunk.shape[3:])
        keep = np.nonzero(admit < pool.shape[0])[0]
        idx = torch.as_tensor(keep, device=pool.device)
        pool[torch.as_tensor(admit[keep], device=pool.device)] = tiles[idx].to(pool.dtype)
        return pool

    return _map(scat, pool_tree, chunk_cache)


def tree_bytes(tree: Any) -> int:
    """Static byte account of a tree of tensors (nested lists, tuples,
    dicts and dataclasses such as ``KVCache``; other leaves count 0)."""
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tree_bytes(v) for v in tree)
    if dataclasses.is_dataclass(tree):
        return sum(tree_bytes(getattr(tree, f.name)) for f in dataclasses.fields(tree))
    return 0


def block_bytes(pool_tree: Any, num_blocks: int) -> int:
    """Bytes one pool block accounts for across every cache leaf."""
    return sum(x.numel() * x.element_size() // max(num_blocks, 1)
               for x in _leaves(pool_tree) if x.dim() >= 3)
