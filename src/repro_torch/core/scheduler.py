"""Request scheduler for the MoSKA serving engine.

Slot-based continuous batching (static shapes for jit): a wave has B slots;
finished slots are refilled from the admission queue. Admission respects the
memory budget computed from the analytical model's capacity terms (unique KV
per request + resident shared stores), i.e. the scheduler enforces the
"batch scaling capability" of Fig. 4 at run time.

Chunk-level batching (queries grouped per shared chunk) happens *inside*
the attention (core/shared_attention.py); the scheduler's job is request
lifecycle + corpus affinity: requests over the same shared corpus are
steered into the same wave so the batched GEMM sees maximal N.

Under block-budget pressure the scheduler prefers **offloading** cold
resident pages over deferring work: the engine registers a cold-page
accountant + offloader (``set_page_offloader``), the budget then counts
pages held only by the device prefix cache, and an admission that would
otherwise defer first asks the engine to offload cold pages to the host
tier (or drop them when no host tier is configured). Only when stores,
cold pages, and blocks together still don't fit does the request defer
(``scheduler/admission_deferred_mem``); successful offload-funded
admissions count under ``scheduler/offload_admissions``.

A wave is **never mixed**: the decode step attends one shared store for
all slots, so every active request must be on the resident corpus
(``corpus_id=None`` counts as its own corpus — no store). Requests on a
different corpus are deferred until the resident wave drains, at which
point residency flips to the next admissible request's corpus.

Affinity is bounded: once a queue head has been skipped
``affinity_max_skips`` times in favor of resident-corpus traffic, the
scheduler stops admitting resident traffic, lets the wave drain, and then
flips residency to the head — so no corpus starves under a sustained
stream on another corpus.

Every admission/eviction decision is recorded in the process-global
metrics registry (``repro_torch.obs``) under ``scheduler/*``: admission and
release counters, slot-occupancy and memory-headroom gauges, the
corpus-affinity hit/miss/preemption counters behind the batching-density
story, and a wave batch-density histogram.
"""
from __future__ import annotations

import collections
import dataclasses
import itertools
from dataclasses import dataclass, field
from typing import Callable, Deque, Dict, List, Optional, Sequence

from repro_torch import obs
from repro_torch.kvcache.block_table import blocks_for


@dataclass
class Request:
    uid: int
    prompt: List[int]
    max_new_tokens: int
    corpus_id: Optional[str] = None      # shared KV store this request uses
    arrival: float = 0.0
    # lifecycle
    generated: List[int] = field(default_factory=list)
    slot: int = -1
    done: bool = False
    skips: int = 0                       # affinity passes while queue head

    @property
    def remaining(self) -> int:
        return self.max_new_tokens - len(self.generated)


@dataclass
class SchedulerConfig:
    max_slots: int = 8
    mem_budget_bytes: float = float("inf")
    unique_bytes_per_token: int = 0      # cfg.kv_bytes_per_token
    max_seq: int = 2048
    corpus_affinity: bool = True
    # starvation bound: force the queue head after this many affinity skips
    affinity_max_skips: int = 64
    # "slotted": every admitted request is charged max_seq tokens of unique
    # KV. "paged": charged only the blocks its prompt + generation budget
    # actually needs (block-budget accounting; admits more concurrent
    # requests at equal HBM), and prompts may exceed max_seq.
    kv_layout: str = "slotted"
    block_size: int = 16


class Scheduler:
    def __init__(self, cfg: SchedulerConfig):
        self.cfg = cfg
        self.queue: Deque[Request] = collections.deque()
        self.slots: List[Optional[Request]] = [None] * cfg.max_slots
        self.finished: List[Request] = []
        self._uid = itertools.count()
        self.resident_corpus: Optional[str] = None
        # shared-store registry: corpus_id -> {nbytes, loaded, last_use}.
        # "loaded" stores hold device HBM and count against the budget;
        # cold ones are LRU-evicted via the engine's evictor callback and
        # reloaded on demand.
        self._stores: Dict[str, dict] = {}
        self._store_clock = itertools.count()
        self._store_evictor: Optional[Callable[[str], None]] = None
        # offload admission path (paged layout): bytes of cold resident
        # pages (held only by the engine's prefix cache) and a callback
        # that offloads/drops them, returning the bytes actually freed
        self._cold_bytes: Callable[[], float] = lambda: 0.0
        self._page_offloader: Optional[Callable[[float], float]] = None

    # ------------------------------------------------------------------
    def submit(self, prompt: Sequence[int], max_new_tokens: int,
               corpus_id: Optional[str] = None) -> int:
        if max_new_tokens < 1:
            raise ValueError(
                f"max_new_tokens must be >= 1, got {max_new_tokens} "
                "(the prefill always produces one token)")
        if not prompt:
            raise ValueError("empty prompt")
        total = len(prompt) + max_new_tokens
        if self.cfg.kv_layout == "paged":
            cost = self._token_cost(total)
            if cost > self.cfg.mem_budget_bytes:
                raise ValueError(
                    f"prompt ({len(prompt)} tokens) + max_new_tokens "
                    f"({max_new_tokens}) needs "
                    f"{blocks_for(total, self.cfg.block_size)} KV blocks "
                    f"({cost:.3g} bytes), exceeding the block budget "
                    f"(mem_budget_bytes={self.cfg.mem_budget_bytes:.3g})")
        elif total > self.cfg.max_seq:
            raise ValueError(
                f"prompt ({len(prompt)} tokens) + max_new_tokens "
                f"({max_new_tokens}) exceeds max_seq={self.cfg.max_seq} "
                "for the slotted KV layout; the paged layout "
                "(EngineConfig(kv_layout='paged')) admits long prompts "
                "up to the block budget")
        uid = next(self._uid)
        self.queue.append(Request(uid, list(prompt), max_new_tokens,
                                  corpus_id))
        return uid

    # -- memory accounting ---------------------------------------------
    @property
    def shared_bytes(self) -> float:
        """Device bytes held by currently-loaded shared stores."""
        return sum(e["nbytes"] for e in self._stores.values() if e["loaded"])

    def _token_cost(self, n_tokens: int) -> float:
        bs = self.cfg.block_size
        return (blocks_for(n_tokens, bs) * bs *
                self.cfg.unique_bytes_per_token)

    def _slot_cost(self) -> float:
        return self.cfg.unique_bytes_per_token * self.cfg.max_seq

    def _request_cost(self, req: Optional[Request] = None) -> float:
        """Unique-KV bytes one request charges against the budget: a full
        max_seq slot in the slotted layout, only its own blocks in paged."""
        if self.cfg.kv_layout != "paged" or req is None:
            return self._slot_cost()
        return self._token_cost(len(req.prompt) + req.max_new_tokens)

    def _used_bytes(self) -> float:
        return self.shared_bytes + self._cold_bytes() + sum(
            self._request_cost(s) for s in self.slots if s is not None)

    def admissible(self, req: Optional[Request] = None) -> bool:
        return self._used_bytes() + self._request_cost(req) <= \
            self.cfg.mem_budget_bytes

    # -- shared-store registry / LRU eviction ---------------------------
    def set_store_evictor(self, fn: Callable[[str], None]) -> None:
        """Engine callback dropping a store's device arrays on eviction."""
        self._store_evictor = fn

    def set_page_offloader(self, cold_bytes: Callable[[], float],
                           offload: Callable[[float], float]) -> None:
        """Wire the host-tier offload admission path: ``cold_bytes()``
        reports device bytes held only by cold prefix pages (they now
        count against the budget), ``offload(need)`` offloads at least
        ``need`` of them (LRU order) and returns the bytes freed."""
        self._cold_bytes = cold_bytes
        self._page_offloader = offload

    def _offload_cold_for(self, req: Request) -> float:
        """Ask the engine to offload cold resident pages so ``req`` fits;
        returns the bytes freed (0.0 when no offloader is wired or no
        pressure exists)."""
        if self._page_offloader is None:
            return 0.0
        budget = self.cfg.mem_budget_bytes
        if budget == float("inf"):
            return 0.0
        shortfall = self._used_bytes() + self._request_cost(req) - budget
        if shortfall <= 0:
            return 0.0
        freed = self._page_offloader(shortfall)
        if freed > 0:
            reg = obs.get_registry()
            reg.inc("scheduler/page_offloads")
            reg.inc("scheduler/offload_freed_bytes", freed)
        return freed

    def register_store(self, corpus_id: str, nbytes: float) -> None:
        self._stores[corpus_id] = {"nbytes": float(nbytes), "loaded": True,
                                   "last_use": next(self._store_clock)}

    def touch_store(self, corpus_id: Optional[str]) -> None:
        e = self._stores.get(corpus_id)
        if e is not None:
            e["last_use"] = next(self._store_clock)

    def store_loaded(self, corpus_id: str) -> bool:
        e = self._stores.get(corpus_id)
        return bool(e and e["loaded"])

    def mark_store_loaded(self, corpus_id: str, loaded: bool = True) -> None:
        e = self._stores.get(corpus_id)
        if e is not None:
            e["loaded"] = loaded
            if loaded:
                e["last_use"] = next(self._store_clock)

    def _evict_stores_for(self, need_bytes: float,
                          keep: Optional[str] = None) -> bool:
        """LRU-evict cold loaded stores (never ``keep`` / the resident
        corpus) until ``need_bytes`` fits in the budget. Returns success."""
        reg = obs.get_registry()
        while self._used_bytes() + need_bytes > self.cfg.mem_budget_bytes:
            victims = [(e["last_use"], cid)
                       for cid, e in self._stores.items()
                       if e["loaded"] and cid != keep
                       and cid != self.resident_corpus]
            if not victims:
                return False
            _, cid = min(victims)
            self._stores[cid]["loaded"] = False
            reg.inc("scheduler/store_evictions")
            if self._store_evictor is not None:
                self._store_evictor(cid)
        return True

    # ------------------------------------------------------------------
    def schedule(self) -> List[Request]:
        """Fill free slots from the queue; returns newly admitted requests
        (they need a prefill before joining the decode wave)."""
        admitted: List[Request] = []
        for i, s in enumerate(self.slots):
            if s is not None or not self.queue:
                continue
            req = self._pick_next()
            if req is None:
                break
            offloaded = 0.0
            if not self.admissible(req):
                self._evict_stores_for(self._request_cost(req),
                                       keep=req.corpus_id)
            if not self.admissible(req):
                # offload-vs-defer: cold resident pages go to the host
                # tier (or are dropped) before any work is deferred
                offloaded = self._offload_cold_for(req)
            if not self.admissible(req):
                obs.get_registry().inc("scheduler/admission_deferred_mem")
                self.queue.appendleft(req)     # re-picked first next time
                break
            if offloaded > 0:
                obs.get_registry().inc("scheduler/offload_admissions")
            req.slot = i
            self.slots[i] = req
            admitted.append(req)
        self._record_wave(len(admitted))
        return admitted

    def _pick_next(self) -> Optional[Request]:
        """Pick the next request to admit, or None to defer.

        Invariant: the returned request's corpus always equals
        ``resident_corpus`` after the call — a wave never mixes corpora
        (the decode step attends exactly one shared store for all slots).
        """
        if not self.queue:
            return None
        reg = obs.get_registry()
        if not self.cfg.corpus_affinity:
            # affinity off still never mixes: admit only when the wave is
            # empty or the head matches the resident corpus
            head = self.queue[0]
            if self._wave_live() and head.corpus_id != self.resident_corpus:
                reg.inc("scheduler/affinity_deferrals")
                return None
            self.queue.popleft()
            self.resident_corpus = head.corpus_id
            return head
        head = self.queue[0]
        starved = head.skips >= self.cfg.affinity_max_skips
        if not self._wave_live():
            # empty wave: residency may flip freely
            if starved:
                if head.corpus_id != self.resident_corpus:
                    reg.inc("scheduler/affinity_preemptions")
                self.queue.popleft()
                self.resident_corpus = head.corpus_id
                return head
            for idx, r in enumerate(self.queue):
                if r.corpus_id == self.resident_corpus:
                    if idx:
                        head.skips += 1
                    del self.queue[idx]
                    reg.inc("scheduler/affinity_hits")
                    return r
            # resident corpus drained from the queue: flip to the head
            req = self.queue.popleft()
            self.resident_corpus = req.corpus_id
            reg.inc("scheduler/affinity_flips")
            return req
        # live wave on the resident corpus
        if starved and head.corpus_id != self.resident_corpus:
            # stop feeding the wave so it drains; the head preempts once
            # the last resident-corpus slot releases (bounded starvation)
            reg.inc("scheduler/affinity_drains")
            return None
        for idx, r in enumerate(self.queue):
            if r.corpus_id == self.resident_corpus:
                if idx:
                    head.skips += 1
                del self.queue[idx]
                reg.inc("scheduler/affinity_hits")
                return r
        # nothing on the resident corpus: defer rather than mix the wave
        head.skips += 1
        reg.inc("scheduler/affinity_misses")
        return None

    def lookahead(self, n: int) -> List[Request]:
        """Preview (never admit) up to ``n`` queued requests most likely
        to be admitted next — the prefetch engine's hint source.

        Mirrors ``_pick_next``'s affinity order without mutating any
        state (no skips counted, no residency flips, no queue edits):
        resident-corpus entries first in queue order, then the corpus
        residency would flip to once the wave drains (the first
        non-resident request's), again in queue order. A wrong
        prediction costs one wasted transfer, never correctness, so this
        stays deliberately simple (it ignores the starvation override; a
        starved head is the next flip target anyway)."""
        if n <= 0 or not self.queue:
            return []
        out: List[Request] = []
        for r in self.queue:
            if r.corpus_id == self.resident_corpus:
                out.append(r)
                if len(out) >= n:
                    return out
        # past the resident traffic, the next admissible corpus is the
        # one residency flips to when the wave drains
        flip = None
        for r in self.queue:
            if r.corpus_id == self.resident_corpus:
                continue
            if flip is None:
                flip = r.corpus_id
            if r.corpus_id == flip:
                out.append(r)
                if len(out) >= n:
                    break
        return out

    def _wave_live(self) -> bool:
        return any(s is not None for s in self.slots)

    def _record_wave(self, admitted: int) -> None:
        reg = obs.get_registry()
        if admitted:
            reg.inc("scheduler/admitted", admitted)
        n_active = sum(1 for s in self.slots if s is not None)
        occupancy = n_active / max(self.cfg.max_slots, 1)
        reg.set_gauge("scheduler/slot_occupancy", occupancy)
        reg.set_gauge("scheduler/queue_depth", len(self.queue))
        reg.observe("scheduler/wave_batch_density", occupancy,
                    obs.FRACTION_EDGES)
        budget = self.cfg.mem_budget_bytes
        # -1 marks an unbounded budget (inf is not JSON-portable)
        reg.set_gauge("scheduler/mem_headroom_bytes",
                      budget - self._used_bytes()
                      if budget != float("inf") else -1.0)

    # ------------------------------------------------------------------
    def active(self) -> List[Request]:
        return [s for s in self.slots if s is not None]

    def record_token(self, req: Request, token: int, eos_id: int = -1):
        req.generated.append(token)
        if req.remaining <= 0 or token == eos_id:
            req.done = True
            self.finished.append(req)
            self.slots[req.slot] = None
            req.slot = -1
            reg = obs.get_registry()
            reg.inc("scheduler/slots_released")
            reg.inc("scheduler/completed")

    @property
    def idle(self) -> bool:
        return not self.queue and all(s is None for s in self.slots)


def wave_stats(reqs: List[Request]) -> Dict[str, float]:
    """Chunk-batching diagnostics: how much GEMM batching a wave provides."""
    by_corpus = collections.Counter(r.corpus_id for r in reqs)
    return {
        "wave_size": len(reqs),
        "distinct_corpora": len(by_corpus),
        "max_corpus_batch": max(by_corpus.values()) if by_corpus else 0,
    }
