"""Paged KV cache: a shared block pool + host-side free-list allocator
with refcounted prefix sharing (port of the JAX package's
``serving/cache_pool.py``).

A decode slot holds a block list over one pool tensor per cache leaf,
``(num_blocks, kv heads, block_size, head_dim)`` (and ``(num_blocks, kv
heads, block_size)`` fp32 scale leaves for an int8 cache): a request takes
``ceil(prompt_len / block_size)`` prompt blocks plus ``ceil(budget /
block_size)`` decode blocks, so its bytes follow its actual prompt, not the
worst case.  Allocation and free are host bookkeeping between steps
(``CachePool``); blocks are identityless, so any request whose block count
fits the free list is admissible.

Prefix caching gives a full prompt block an identity: the chain hash of
every token up to its end (``block_hash``, ``chain_hashes``).  An
admission walks the index for its longest cached chain (``match_chain``),
takes a reference on it (``acquire``) and allocates only its tail; the
first writer of a hash keeps it (``register``).  ``free`` is a refcount
decrement; a registered block reclaimed at refcount 0 parks in a warm LRU
under a block budget (``warm_capacity``), is evicted strictly oldest first
and only at refcount 0, and counts as free, so retention never refuses an
admission that would fit without it.

On CUDA the decode step reads the pool through the per-slot block tables
inside the paged decode kernel (``ops/flash_attention.flash_decode_paged``)
and never builds a slot view; the plain path gathers one
(``gather_cache``), zeros at unallocated tiles, which the masks make
contribute nothing.  A freed block keeps its old contents, but every read
is masked to the owner's written region (``k_pos <= offset`` in the decode
tail, the attention mask in the prompt), so stale K/V is unreachable.  A
speculative verify block writes its k + 1 rows a slot through the same
plan (``step_write_plan`` with ``span``), so its writes land only in
blocks the slot owns: a rejected draft returns nothing to the free list,
and the hash index never sees a speculative block.

Trees are nested lists, tuples or dicts of tensors: 4-D K/V leaves and 3-D
int8 scale leaves.  The writes happen in place; each function also returns
the tree, as the JAX functions return theirs.
"""

from __future__ import annotations

import dataclasses
import hashlib
import math
from collections import OrderedDict
from typing import Any, Iterable, Sequence

import numpy as np
import torch

from distributed_llms_example_tpu_torch.ops.flash_attention import gather_blocks


def to_device(a: Any, device: Any) -> torch.Tensor:
    """A host array on ``device``.  To a card it goes through a pinned
    staging copy, enqueued without a wait: a copy from pageable memory
    waits for the stream to drain, which would make every host input of a
    decode round a sync."""
    t = torch.as_tensor(a)
    if t.device.type != "cpu" or torch.device(device).type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def block_hash(prev_hash: str | None, tokens: Sequence[int]) -> str:
    """Chain hash of one full block: sha256 over the predecessor's hash
    (empty for the first block) and this block's token ids, so equal
    hashes at block k mean equal tokens in blocks 0..k."""
    h = hashlib.sha256()
    h.update(b"" if prev_hash is None else prev_hash.encode("ascii"))
    h.update("|".join(str(int(t)) for t in tokens).encode("ascii"))
    return h.hexdigest()


def chain_hashes(tokens: Sequence[int], block_size: int) -> list[str]:
    """Chain hashes of every full block of ``tokens`` (a partial tail
    block has no stable identity and is never shared)."""
    out: list[str] = []
    prev: str | None = None
    for start in range(0, len(tokens) // block_size * block_size, block_size):
        prev = block_hash(prev, tokens[start:start + block_size])
        out.append(prev)
    return out


class CachePool:
    """Free-list allocator over cache blocks with refcounted sharing and a
    warm LRU of finished requests' registered blocks (pure host).
    ``alloc`` grants whole or not at all, at refcount 1; ``acquire`` takes
    one more reference on a matched chain; ``free`` drops one, raising on
    a double or foreign free.  ``blocks_free + blocks_in_use ==
    num_blocks`` always (warm blocks count as free); ``warm_capacity`` 0
    (the default) turns retention off."""

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
        # _ref: each used block's refcount; _hash_of / _index: the chain-hash
        # index both ways (live or warm blocks only); _lru: the refcount-0
        # retained blocks, oldest first
        self._ref: dict[int, int] = {}
        self._hash_of: dict[int, str] = {}
        self._index: dict[str, int] = {}
        self._lru: OrderedDict[int, None] = OrderedDict()
        self.warm_capacity = 0

    @property
    def blocks_free(self) -> int:
        return len(self._free) + len(self._lru)

    @property
    def blocks_in_use(self) -> int:
        return len(self._used)

    @property
    def blocks_warm(self) -> int:
        return len(self._lru)

    def can_alloc(self, n: int) -> bool:
        return n <= self.blocks_free

    def alloc(self, n: int) -> list[int] | None:
        """``n`` fresh blocks at refcount 1, evicting the oldest warm blocks
        as needed, or None when the free list and the warm set together are
        short (the caller defers admission — never a partial grant)."""
        if n < 0:
            raise ValueError(f"cannot alloc {n} blocks")
        if n > self.blocks_free:
            return None
        while len(self._free) < n:
            self._evict_warm()
        out = [self._free.pop() for _ in range(n)]
        self._used.update(out)
        for b in out:
            self._ref[b] = 1
        return out

    def free(self, blocks: Sequence[int]) -> None:
        """Drop one reference a block; at refcount 0 a registered block
        parks warm (when retention is on), any other returns to the free
        list."""
        for b in blocks:
            if b not in self._used:
                raise ValueError(f"block {b} is not allocated (double-free or foreign id)")
            self._ref[b] -= 1
            if self._ref[b] > 0:
                continue
            self._used.remove(b)
            del self._ref[b]
            if b in self._hash_of and self.warm_capacity > 0:
                self._lru[b] = None
                self._lru.move_to_end(b)
                while len(self._lru) > self.warm_capacity:
                    self._evict_warm()
            else:
                self._unregister(b)
                self._free.append(b)

    # ------------------------------------------------- the prefix index

    def acquire(self, blocks: Sequence[int]) -> None:
        """One more reference on each block of a matched chain: a live
        block's count goes up, a warm block revives at refcount 1."""
        for b in blocks:
            if b in self._used:
                self._ref[b] += 1
            elif b in self._lru:
                del self._lru[b]
                self._used.add(b)
                self._ref[b] = 1
            else:
                raise ValueError(f"block {b} is neither live nor warm (stale chain match)")

    def register(self, blocks: Sequence[int], hashes: Sequence[str]) -> None:
        """Index a request's full prompt blocks by their chain hashes.  The
        first writer wins: a hash already indexed keeps its block, and a
        block keeps its first hash."""
        if len(blocks) != len(hashes):
            raise ValueError(f"got {len(blocks)} blocks for {len(hashes)} hashes")
        for b, h in zip(blocks, hashes):
            if b not in self._used:
                raise ValueError(f"block {b} is not allocated (cannot register)")
            if b in self._hash_of or h in self._index:
                continue
            self._hash_of[b] = h
            self._index[h] = b

    def lookup(self, h: str) -> int | None:
        return self._index.get(h)

    def match_chain(self, hashes: Sequence[str]) -> list[int]:
        """Blocks of the longest indexed prefix of ``hashes``: the walk
        stops at the first miss (a chained hash cannot match past a gap)."""
        out: list[int] = []
        for h in hashes:
            b = self._index.get(h)
            if b is None:
                break
            out.append(b)
        return out

    def drop_warm(self) -> int:
        """Evict the whole warm set (its contents are gone with the pool
        tensor that held them); returns the blocks released."""
        n = len(self._lru)
        while self._lru:
            self._evict_warm()
        return n

    def _evict_warm(self) -> None:
        b, _ = self._lru.popitem(last=False)  # strictly oldest first
        self._unregister(b)
        self._free.append(b)

    def _unregister(self, b: int) -> None:
        h = self._hash_of.pop(b, None)
        if h is not None:
            self._index.pop(h, None)

    def ref_invariant_violations(self, live_chains: Iterable[Sequence[int]]) -> list[str]:
        """Every block's refcount against its live references
        (``live_chains``: each live slot's block ids), the free/used/warm
        partition and the index's consistency; an empty list when the
        account is exact."""
        out: list[str] = []
        want: dict[int, int] = {}
        for chain in live_chains:
            for b in chain:
                want[b] = want.get(b, 0) + 1
        for b, n in sorted(want.items()):
            if self._ref.get(b) != n:
                out.append(f"block {b}: refcount {self._ref.get(b)} != {n} live references")
        for b in sorted(self._used):
            if b not in want:
                out.append(f"block {b}: in use with no live reference")
        for b in self._lru:
            if b in want:
                out.append(f"block {b}: warm but referenced by a live slot")
            if b not in self._hash_of:
                out.append(f"block {b}: warm without a registered hash")
        free, used, warm = set(self._free), self._used, set(self._lru)
        if free & used or free & warm or used & warm:
            out.append("free/used/warm sets overlap")
        if len(free) + len(used) + len(warm) != self.num_blocks:
            out.append(f"partition covers {len(free) + len(used) + len(warm)} of "
                       f"{self.num_blocks} blocks")
        for h, b in self._index.items():
            if b not in used and b not in warm:
                out.append(f"hash {h[:12]}: indexed block {b} is on the free list")
            if self._hash_of.get(b) != h:
                out.append(f"hash {h[:12]}: index and hash_of disagree on {b}")
        return out


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
                    device: torch.device | str, span: int = 1) -> tuple[torch.Tensor, ...]:
    """(rows, blocks, slots) on ``device`` for one pass writing ``span``
    rows a slot, from host block tables (S, n_tiles) and write offsets
    (S,): row j of slot s (flattened row ``s * span + j``) goes to block
    ``block_tables[s, (offsets[s] + j) // bs]`` at slot ``(offsets[s] + j)
    % bs``.  Positions past the view width (parked slots) and sentinel
    tiles are left out, so their writes drop (the JAX package's
    ``mode="drop"``; ``span`` > 1 is its ``scatter_span``, the speculative
    verify write)."""
    bt = np.asarray(block_tables)
    pos = np.asarray(offsets).astype(np.int64)[:, None] + np.arange(span)[None, :]
    n_tiles = bt.shape[1]
    tile = np.clip(pos // block_size, 0, n_tiles - 1)
    blocks = bt[np.arange(bt.shape[0])[:, None], tile].astype(np.int64)
    blocks = np.where((pos >= 0) & (pos < n_tiles * block_size), blocks, num_blocks).reshape(-1)
    keep = np.nonzero(blocks < num_blocks)[0]
    return tuple(to_device(a, device)
                 for a in (keep, blocks[keep], pos.reshape(-1)[keep] % block_size))


def scatter_step(pool_tree: Any, new_rows: Any, plan: tuple[torch.Tensor, ...]):
    """Write each slot's just-decoded rows ((S · span, heads[, head_dim])
    leaves of ``new_rows``) into its pool blocks by ``plan``
    (``step_write_plan``); parked rows and sentinel tiles are absent from
    the plan, so they drop.  A paged decode layer writes its pass through
    this (``ops/mha.PagedKVCache.write_rows``)."""
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
        idx = to_device(keep, pool.device)
        pool[to_device(admit[keep], pool.device)] = tiles[idx].to(pool.dtype)
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
