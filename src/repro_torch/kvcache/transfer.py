"""Async host->device page transfers for the paged serving hot path.

Port of the reference ``kvcache/transfer.py``. The host tier
(``HostBlockPool``) makes cold prefix hits cheap in *tokens* (swap pages
back instead of re-prefilling) but not in *time*: a swap-in still moves
the pages up, and the admission that needs them waits.
:class:`PrefetchEngine` issues those copies early — during a decode wave,
for the prefix entries the scheduler's lookahead predicts will be admitted
next — so by the time the engine admits the request, the pages are already
on the card (or at worst mid-flight, a bounded wait on the card).

Mechanics on a card, and why they are safe:

  * ``issue(key)`` peeks the host entry (non-consuming, LRU-neutral: a
    prefetch never pins an entry against eviction nor perturbs the tier's
    aging). On a dedicated side stream it waits for the entry's offload
    event (the pinned pages may still be arriving from the card), copies
    the pinned pages ``non_blocking`` into fresh device tensors allocated
    on that stream, and records a copy-done event. The host returns at
    once; the copy runs beside the decode step on the main stream.
    In-flight transfers are bounded by ``depth``.
  * ``take(key)`` hands a transfer to the current stream: that stream
    waits on the copy-done event, and the tensors are recorded as used by
    it (``record_stream``), so the caching allocator cannot hand their
    memory to the side stream again before the current stream's reads are
    done. Only then may ``insert_blocks`` read them.
  * A transfer carries the entry's generation-tagged page identity (the
    ``(block_id, generation)`` pairs stamped at offload time). Host
    entries are immutable snapshots, but the *key* can be re-offloaded
    with other pages after the tier churned. The consumer therefore
    matches generations: a mismatch means the transfer belongs to a dead
    lifetime — it is discarded and the current entry swapped in (the
    values are bit-identical either way; the generations are the proof of
    identity, not the contents).
  * ``discard``/``sweep`` only drop references. A copy still in flight
    keeps its memory: the tensors belong to the side stream, whose later
    work is ordered after the copy, and the pinned source is held by the
    caching host allocator until the copy's own event completes.

On the CPU the "transfer" is the host entry's tensors themselves: there is
no stream, nothing to wait on, and the swap-in copies them into the pool.

Degradation contract: with the engine's prefetch depth at 0 (or no host
tier) nothing here runs and the swap-in is the synchronous one. With
prefetching on, the only observable differences are timing and the
``kvcache/prefetch_{issued,hits,wasted}`` counters — generations are
bit-identical.
"""
from __future__ import annotations

import collections
from typing import List, Optional

import torch

from repro_torch.kvcache.paged import HostBlockPool


class PrefetchEngine:
    """Bounded pool of in-flight host->device page transfers, keyed like
    the prefix cache by ``(corpus fingerprint, prompt)``."""

    def __init__(self, host_pool: HostBlockPool, depth: int,
                 device: Optional[torch.device] = None):
        if depth < 0:
            raise ValueError(f"negative prefetch depth {depth}")
        self.host_pool = host_pool
        self.depth = depth
        self.device = torch.device("cpu") if device is None else device
        # the side stream of the copies, made at the first card issue
        self._stream: Optional[torch.cuda.Stream] = None
        # key -> {"k", "v": device tensors (possibly still arriving),
        #         "first": int, "gens": ((block, gen), ...), "blocks": nb,
        #         "done": copy-done event, None on the CPU}
        self._inflight: "collections.OrderedDict" = collections.OrderedDict()
        self.issued = 0
        self.resolved = 0
        self.discarded = 0

    # -- introspection ---------------------------------------------------
    @property
    def in_flight(self) -> int:
        return len(self._inflight)

    def __contains__(self, key) -> bool:
        return key in self._inflight

    def keys(self) -> List:
        return list(self._inflight)

    # -- issue / resolve -------------------------------------------------
    def issue(self, key) -> bool:
        """Start an async device copy of the host entry at ``key``.
        Returns False (no copy) when the key is already in flight, the
        depth budget is full, or the host tier has no such entry."""
        if self.depth <= 0 or key in self._inflight or \
                len(self._inflight) >= self.depth:
            return False
        entry = self.host_pool.peek(key)
        if entry is None:
            return False
        tr = {"first": entry["first"], "gens": entry["gens"],
              "blocks": entry["blocks"], "done": None}
        if self.device.type == "cuda":
            if self._stream is None:
                self._stream = torch.cuda.Stream(self.device)
            with torch.cuda.stream(self._stream):
                if entry["ready"] is not None:
                    self._stream.wait_event(entry["ready"])
                tr["k"] = entry["k"].to(self.device, non_blocking=True)
                tr["v"] = entry["v"].to(self.device, non_blocking=True)
                tr["done"] = torch.cuda.Event()
                tr["done"].record(self._stream)
        else:
            tr["k"], tr["v"] = entry["k"], entry["v"]
        self._inflight[key] = tr
        self.issued += 1
        return True

    def take(self, key) -> Optional[dict]:
        """Claim the in-flight transfer for ``key`` (None when there is
        none), handed over to the current stream. The caller owns
        generation matching: compare the returned ``gens`` against the
        host entry it fetched, and drop the transfer on mismatch (a stale
        lifetime)."""
        tr = self._inflight.pop(key, None)
        if tr is None:
            return None
        self.resolved += 1
        if tr["done"] is not None:
            cur = torch.cuda.current_stream(self.device)
            cur.wait_event(tr["done"])
            tr["k"].record_stream(cur)
            tr["v"].record_stream(cur)
        return tr

    def discard(self, key) -> bool:
        """Drop one in-flight transfer (only its references)."""
        if self._inflight.pop(key, None) is not None:
            self.discarded += 1
            return True
        return False

    def sweep(self) -> int:
        """Discard in-flight transfers whose host entry disappeared or
        was replaced (generation mismatch) since issue — they can never
        resolve to a hit. Returns how many were dropped."""
        stale = []
        for key, tr in self._inflight.items():
            entry = self.host_pool.peek(key)
            if entry is None or entry["gens"] != tr["gens"]:
                stale.append(key)
        for key in stale:
            self.discard(key)
        return len(stale)

    def clear(self) -> int:
        """Drop every in-flight transfer (engine teardown / tier reset)."""
        n = len(self._inflight)
        for key in list(self._inflight):
            self.discard(key)
        return n

    def check_invariants(self) -> None:
        """Raises AssertionError on a corrupted prefetch state."""
        assert len(self._inflight) <= max(self.depth, 0), \
            "prefetch depth exceeded"
        assert self.resolved + self.discarded + len(self._inflight) \
            == self.issued, "prefetch accounting drifted"
        for key, tr in self._inflight.items():
            assert tr["k"].shape[1] == tr["blocks"], \
                f"in-flight transfer {key!r} shape drift"
