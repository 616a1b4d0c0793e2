"""Host-side block tables for the paged KV cache.

A copy of the reference ``kvcache/block_table.py`` (pure numpy; the port
imports nothing of the reference package). A block table maps a request
slot's *logical* token positions onto *physical* blocks of the shared
block pool (``repro_torch.kvcache.paged``): token ``t`` of slot ``b``
lives at ``(table[b, t // block_size], t % block_size)``. Tables are small
host ``numpy`` arrays mutated by the engine between decode waves and
copied to the device as ``int32`` operands of each paged decode step.

Physical block 0 is the **null block** (``NULL_BLOCK``): table rows of
inactive slots point at it, so the decode wave's garbage lanes scatter
their writes into a sacrificial page instead of corrupting live blocks,
and padded table entries read finite garbage that the attention masks
out exactly.
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np

#: physical block id reserved as the write sink / gather filler.
NULL_BLOCK = 0


def blocks_for(n_tokens: int, block_size: int) -> int:
    """Number of blocks covering ``n_tokens`` tokens (ceil division)."""
    if n_tokens < 0:
        raise ValueError(f"negative token count {n_tokens}")
    return -(-n_tokens // block_size)


class SlotTables:
    """Per-slot block tables + lengths/offsets, host side.

    The engine mutates these between waves (admission, on-demand block
    append, copy-on-write swaps, release) and snapshots them with
    :meth:`device_args` for each decode step.
    """

    def __init__(self, num_slots: int, blocks_per_slot: int,
                 block_size: int):
        if blocks_per_slot < 1:
            raise ValueError("blocks_per_slot must be >= 1")
        self.block_size = block_size
        self.table = np.full((num_slots, blocks_per_slot), NULL_BLOCK,
                             np.int32)
        self.length = np.zeros((num_slots,), np.int32)
        self.offset = np.zeros((num_slots,), np.int32)
        # blocks actually allocated per slot (NULL padding is not counted)
        self.n_blocks = np.zeros((num_slots,), np.int32)

    @property
    def num_slots(self) -> int:
        return self.table.shape[0]

    @property
    def blocks_per_slot(self) -> int:
        return self.table.shape[1]

    @property
    def capacity_tokens(self) -> int:
        return self.blocks_per_slot * self.block_size

    # ------------------------------------------------------------------
    def assign(self, slot: int, block_ids: Sequence[int], length: int,
               offset: int) -> None:
        """Install a freshly admitted request's prompt blocks."""
        ids = list(block_ids)
        if len(ids) > self.blocks_per_slot:
            raise ValueError(
                f"{len(ids)} blocks exceed table width "
                f"{self.blocks_per_slot}")
        row = self.table[slot]
        row[:] = NULL_BLOCK
        row[:len(ids)] = ids
        self.length[slot] = length
        self.offset[slot] = offset
        self.n_blocks[slot] = len(ids)

    def append_block(self, slot: int, block_id: int) -> None:
        n = int(self.n_blocks[slot])
        if n >= self.blocks_per_slot:
            raise ValueError(f"slot {slot} table full ({n} blocks)")
        self.table[slot, n] = block_id
        self.n_blocks[slot] = n + 1

    def replace_block(self, slot: int, index: int, block_id: int) -> None:
        """Swap one mapping in place (copy-on-write)."""
        if index >= int(self.n_blocks[slot]):
            raise ValueError(f"slot {slot} has no block at index {index}")
        self.table[slot, index] = block_id

    def slot_blocks(self, slot: int) -> List[int]:
        return self.table[slot, : int(self.n_blocks[slot])].tolist()

    def prefix_blocks(self, slot: int, n_tokens: int) -> List[int]:
        """Block ids covering the slot's first ``n_tokens`` tokens — the
        prompt prefix a released request parks in the prefix cache. Empty
        when the slot maps fewer blocks than the prefix needs (e.g.
        already released)."""
        nb = blocks_for(n_tokens, self.block_size)
        if nb > int(self.n_blocks[slot]):
            return []
        return self.table[slot, :nb].tolist()

    def clear(self, slot: int) -> List[int]:
        """Release a slot's mapping; returns the block ids it held.

        The slot's ``length``/``offset`` are deliberately NOT reset: the
        decode wave keeps computing garbage for inactive slots, and for
        bit-identity with the slotted layout those lanes must see the same
        (stale) positions the slotted cache would.
        """
        ids = self.slot_blocks(slot)
        self.table[slot, :] = NULL_BLOCK
        self.n_blocks[slot] = 0
        return ids

    def block_index(self, slot: int, position: int) -> int:
        """Table index of the block holding logical token ``position``."""
        idx = position // self.block_size
        if idx >= self.blocks_per_slot:
            raise ValueError(
                f"position {position} beyond slot capacity "
                f"{self.capacity_tokens}")
        return idx

    def grow(self, blocks_per_slot: int) -> None:
        """Widen every table row (longer max request); existing mappings
        are preserved."""
        if blocks_per_slot <= self.blocks_per_slot:
            return
        pad = np.full((self.num_slots,
                       blocks_per_slot - self.blocks_per_slot),
                      NULL_BLOCK, np.int32)
        self.table = np.concatenate([self.table, pad], axis=1)

    def tick(self) -> None:
        """Advance one decode wave: every slot's length grows by one, the
        exact mirror of the slotted decode step's ``cache.length + 1``
        (inactive slots included, so their garbage lanes stay identical
        across layouts)."""
        self.length += 1

    def device_args(self):
        """(table, length, offset) copies for one decode step."""
        return (self.table.copy(), self.length.copy(), self.offset.copy())


def validate_block_size(block_size: int, max_seq: int) -> None:
    """Engine-facing constraint: the pages must tile max_seq exactly, so a
    slot's table covers the same positions as a slotted slab (this is what
    makes paged-vs-slotted bit-identical)."""
    if block_size < 1:
        raise ValueError(f"block_size must be >= 1, got {block_size}")
    if max_seq % block_size:
        raise ValueError(
            f"block_size {block_size} must divide max_seq {max_seq} "
            "(the paged gather view tiles max_seq exactly)")
