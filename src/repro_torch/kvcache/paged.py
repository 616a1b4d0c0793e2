"""Paged unique-KV cache: a block pool + ref-counted allocator.

Port of the reference ``kvcache/paged.py`` (without the host tier).
Instead of one ``(L, B, max_seq, KH, D)`` slab where every slot pays for
the worst-case prompt, the paged layout keeps a pool of fixed-size pages

    k_pool, v_pool : (L, num_blocks, block_size, KH, D)

and maps each request's tokens onto pages through a block table
(``repro_torch.kvcache.block_table``). Pages are recycled through a free
list; ref-counting lets several requests map the *same* physical page
(prefix sharing) with copy-on-write when one of them appends into a
shared page.

  * :class:`BlockPool` — host-side allocator (ids only, no device data), a
    copy of the reference's: free list, refcounts, alloc/incref/free, CoW
    arbitration, and a generation per allocation, so ``(block_id,
    generation)`` names one lifetime of a page.
  * :class:`PagedKVCache` + the ops below — the device data path. Unlike
    the reference's functional updates, ``append_layer``, ``write_blocks``
    and ``copy_block`` write into the pool in place (the counterpart of
    the reference's buffer donation); ``grow_paged_kv_cache`` returns a
    larger pool holding the old pages.
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Sequence, Union

import torch

from repro_torch.kvcache.block_table import NULL_BLOCK


class PoolExhausted(RuntimeError):
    """No free block available (after any possible eviction)."""


class BlockPool:
    """Ref-counted free-list allocator over ``num_blocks`` physical pages.

    Block ``NULL_BLOCK`` (= 0) is reserved at construction: it is never
    handed out, it absorbs the decode wave's garbage-lane writes.

    Invariants:
      * a block is either free or has refcount >= 1, never both;
      * ``len(free) + len(live) == num_blocks - 1`` at all times;
      * refcounts never go negative; freeing to refcount 0 returns the
        block to the free list exactly once.
    """

    def __init__(self, num_blocks: int):
        if num_blocks < 2:
            raise ValueError(
                f"need >= 2 blocks (one is the reserved null block), "
                f"got {num_blocks}")
        self.num_blocks = num_blocks
        # LIFO free list: recently freed pages are re-used first
        self._free: List[int] = list(range(num_blocks - 1, NULL_BLOCK, -1))
        self._ref: Dict[int, int] = {}   # block id -> refcount >= 1
        # block id -> allocation generation (bumped on every alloc)
        self._gen: Dict[int, int] = {}

    # -- introspection ---------------------------------------------------
    @property
    def capacity(self) -> int:
        """Allocatable blocks (the null block is not allocatable)."""
        return self.num_blocks - 1

    @property
    def available(self) -> int:
        return len(self._free)

    @property
    def in_use(self) -> int:
        return len(self._ref)

    def refcount(self, block_id: int) -> int:
        return self._ref.get(block_id, 0)

    def is_free(self, block_id: int) -> bool:
        return block_id not in self._ref and block_id != NULL_BLOCK

    def generation(self, block_id: int) -> int:
        """Allocation generation of ``block_id`` (0 = never allocated)."""
        return self._gen.get(block_id, 0)

    # -- allocation ------------------------------------------------------
    def alloc(self, n: int = 1) -> List[int]:
        """Allocate ``n`` blocks with refcount 1; raises PoolExhausted
        (allocating nothing) when fewer than ``n`` are free."""
        if n < 0:
            raise ValueError(f"negative allocation {n}")
        if n > len(self._free):
            raise PoolExhausted(
                f"need {n} blocks, {len(self._free)} free "
                f"(pool of {self.capacity})")
        ids = [self._free.pop() for _ in range(n)]
        for b in ids:
            self._ref[b] = 1
            self._gen[b] = self._gen.get(b, 0) + 1
        return ids

    def incref(self, block_ids: Sequence[int]) -> None:
        """Map already-live blocks into another table (prefix sharing)."""
        for b in block_ids:
            if b == NULL_BLOCK:
                continue
            if b not in self._ref:
                raise ValueError(f"incref of free block {b}")
            self._ref[b] += 1

    def free(self, block_ids: Sequence[int]) -> int:
        """Drop one reference per id; returns how many blocks actually
        returned to the free list (refcount hit 0)."""
        released = 0
        for b in block_ids:
            if b == NULL_BLOCK:
                continue
            c = self._ref.get(b)
            if c is None:
                raise ValueError(f"double free of block {b}")
            if c == 1:
                del self._ref[b]
                self._free.append(b)
                released += 1
            else:
                self._ref[b] = c - 1
        return released

    def needs_copy(self, block_id: int) -> bool:
        """True when writing into ``block_id`` requires copy-on-write
        (the page is mapped by more than one table)."""
        return self._ref.get(block_id, 0) > 1

    def grow(self, num_blocks: int) -> None:
        """Extend the pool (matches a device-side pool reallocation)."""
        if num_blocks <= self.num_blocks:
            return
        self._free.extend(range(self.num_blocks, num_blocks))
        self.num_blocks = num_blocks

    def check_invariants(self) -> None:
        """Raises AssertionError on a corrupted pool."""
        free = set(self._free)
        assert len(free) == len(self._free), "duplicate ids in free list"
        assert NULL_BLOCK not in free, "null block leaked into free list"
        assert not (free & set(self._ref)), "block both free and live"
        assert all(c >= 1 for c in self._ref.values()), "refcount < 1"
        assert len(free) + len(self._ref) == self.capacity, \
            "block conservation violated"


# ---------------------------------------------------------------------------
# device data path
# ---------------------------------------------------------------------------

BlockIds = Union[torch.Tensor, Sequence[int]]


class PagedKVCache(NamedTuple):
    """The physical page pool, layer-stacked like the slotted KVCache so
    the decoder loop takes one layer slice per step."""
    k: torch.Tensor          # (L, N, block_size, KH, D)
    v: torch.Tensor          # (L, N, block_size, KH, D)

    @property
    def num_blocks(self) -> int:
        return self.k.shape[1]

    @property
    def block_size(self) -> int:
        return self.k.shape[2]

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in self)


def init_paged_kv_cache(num_layers: int, num_blocks: int, block_size: int,
                        kv_heads: int, head_dim: int, dtype=torch.bfloat16,
                        device=None) -> PagedKVCache:
    shape = (num_layers, num_blocks, block_size, kv_heads, head_dim)
    return PagedKVCache(torch.zeros(shape, dtype=dtype, device=device),
                        torch.zeros(shape, dtype=dtype, device=device))


def grow_paged_kv_cache(pool: PagedKVCache, num_blocks: int) -> PagedKVCache:
    """Pool with more pages; existing page contents (and ids) preserved.
    The new pool is a fresh allocation (the old one is released when the
    caller drops it)."""
    L, N, bs, KH, D = pool.k.shape
    if num_blocks <= N:
        return pool
    out = []
    for t in pool:
        big = torch.zeros((L, num_blocks, bs, KH, D), dtype=t.dtype,
                          device=t.device)
        big[:, :N] = t
        out.append(big)
    return PagedKVCache(*out)


def _ids(block_ids: BlockIds, device) -> torch.Tensor:
    return torch.as_tensor(block_ids, dtype=torch.long, device=device)


def gather_layer(pool_layer: torch.Tensor,
                 table: torch.Tensor) -> torch.Tensor:
    """Rebuild a contiguous per-slot view from one layer's pool.

    pool_layer: (N, bs, KH, D); table: (B, M) int32 physical block ids.
    Returns a (B, M * bs, KH, D) copy. The paged decode kernel reads pages
    through the table directly; this view is what its plain version (and
    the tests) attend to."""
    B, M = table.shape
    N, bs, KH, D = pool_layer.shape
    return pool_layer[table.long()].reshape(B, M * bs, KH, D)


def append_layer(pool_layer: torch.Tensor, new: torch.Tensor,
                 table: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Scatter one new token per slot into its current page, in place.

    pool_layer: (N, bs, KH, D); new: (B, KH, D); lengths: (B,) — token b
    lands at ``(table[b, lengths[b] // bs], lengths[b] % bs)``. Inactive
    slots' table rows are NULL, so their garbage tokens land in the null
    page. The block index is clamped like the slotted path's append, so an
    inactive slot whose stale length keeps growing writes to its last
    table entry instead of out of bounds.
    """
    B, M = table.shape
    bs = pool_layer.shape[1]
    lens = lengths.long()
    idx = (lens // bs).clamp(0, M - 1)
    rows = torch.arange(B, device=table.device)
    blocks = table[rows, idx].long()
    pool_layer[blocks, lens % bs] = new.to(pool_layer.dtype)
    return pool_layer


def write_blocks(pool: PagedKVCache, block_ids: BlockIds,
                 k_new: torch.Tensor, v_new: torch.Tensor,
                 true_len: Optional[int] = None) -> PagedKVCache:
    """Block-granular admission write, in place: scatter a prefilled
    prefix into the pool pages named by ``block_ids``.

    k_new/v_new: (L, S, KH, D) with S a multiple of block_size;
    block_ids: (S // block_size,), NULL_BLOCK-padded past the prompt's
    last real block (those slices land in the null page). ``true_len``
    zeroes positions >= true_len first, so pages never hold bucket-pad
    garbage.
    """
    L, S, KH, D = k_new.shape
    bs = pool.block_size
    if S % bs:
        raise ValueError(f"prefix length {S} not a multiple of "
                         f"block_size {bs}")
    nb = S // bs
    ids = _ids(block_ids, pool.k.device)
    for dst, src in ((pool.k, k_new), (pool.v, v_new)):
        if true_len is not None:
            valid = torch.arange(S, device=src.device) < true_len
            src = torch.where(valid[None, :, None, None], src,
                              torch.zeros((), dtype=src.dtype,
                                          device=src.device))
        dst[:, ids] = src.reshape(L, nb, bs, KH, D).to(dst.dtype)
    return pool


def copy_block(pool: PagedKVCache, dst: int, src: int) -> PagedKVCache:
    """Copy-on-write: duplicate page ``src`` into page ``dst``, in place."""
    for t in pool:
        t[:, dst] = t[:, src]
    return pool
