"""MoSKA serving engine: continuous batching over slot-based decode waves.

Port of the reference ``serving/engine.py``, host memory tier and async
pipeline included:

  register_corpus()  — precompute a domain corpus' KV once (prefill) and
                       chunk it into a SharedKVStore, persistent across
                       requests (the Shared-KV node state).
  submit()/run()     — the scheduler admits requests into B slots; each
                       admission prefills the prompt and writes its KV
                       into the unique-KV cache in place; each decode
                       wave runs one step where every layer routes and
                       batches shared attention across all concurrent
                       slots (the GEMM) and LSE-merges it with per-slot
                       unique attention.

Slotted layout (the default): the (L, B, S, KH, D) unique-KV batch cache
is allocated once, kept on the device across ``run()`` calls and updated
in place (so ``engine/decode_cache_bytes_copied`` reads 0). Prompt lengths
are rounded up to a small bucket set; pad positions are left out of
routing and logits, so a bucketed prefill computes what the exact-length
one would. A wave's tokens come back through one ``non_blocking`` copy
into a pinned host buffer, fenced by an event: the wave's only sync point.
Device-side dispatch metrics are read back once per wave, after it.

Paged layout (``EngineConfig(kv_layout="paged")``): unique KV lives in a
pool of ``block_size``-token pages mapped through per-slot block tables
(``repro_torch.kvcache``). Admission allocates only the prompt's blocks,
decode appends pages on demand, and identical prompts over one corpus
share pages copy-on-write (an LRU prefix cache keyed by corpus content and
prompt), so the same ``mem_budget_bytes`` admits more concurrent requests.
Each decode step's unique attention is the ``paged_decode_attention``
kernel, reading pages through the tables. Generations are bit-identical to
the slotted layout. Prompts longer than ``max_seq`` are served by chunked
prefill (``prefill_chunk``-token pieces against a growing scratch
context). When the free list runs short, cold prefix entries are evicted
first, then the pool grows by ``max_seq / block_size`` pages at a time
(unless ``num_blocks`` fixes its size).

Host memory tier (``EngineConfig(host_pool_blocks=N)``, paged layout):
prefix entries the device pool LRU-evicts are copied page-granularly into
pinned host memory (``HostBlockPool``) instead of being dropped; a later
hit on the same (corpus-fingerprint, prompt) key swaps the pages back into
free device blocks bit-exactly, skipping the prefill entirely
(``kvcache/swap_in_hits`` vs ``engine/prefill_tokens``). Only when the host
tier has also evicted the entry does the engine rebuild from tokens. The
scheduler's offload admission path moves cold pages to the tier under
block-budget pressure.

State families (SSM, hybrid; slotted layout only): the batch cache is
the model's state dict ((L, B, ...) leaves: SSM states and conv tails,
the hybrid's rings and LRU states), allocated once like the slab. An
admission prefills the exact prompt into a fresh 1-batch state, without
a store, and copies each leaf into its batch slot in place
(``write_slot_state``; ``_merge_slot_cache`` is the full-copy oracle).
They have no KV to chunk, so ``register_corpus`` refuses them; the
engine refuses the enc-dec family, whose prefill needs audio frames the
engine has no way to take (serve it through ``Model``).

Async pipeline (paged layout): ``prefetch_depth`` host->device copies of
the entries the scheduler's lookahead predicts will be admitted next run
on a side stream during the decode wave (``kvcache/transfer.py``);
``spec_append`` allocates the page a slot's next token opens during the
current wave; and ``overlap_waves`` runs the next wave's host work (table
tick, speculative appends, prefetch issue, block gauges) between the
step's launch and its token readback, never writing the page pool there.
Generations are bit-identical with each of the three on or off.
"""
from __future__ import annotations

import collections
import hashlib
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch import obs
from repro_torch.configs.base import AUDIO, HYBRID, SSM, ModelConfig
from repro_torch.core.scheduler import Request, Scheduler, SchedulerConfig
from repro_torch.core.shared_kv import (SharedKVStore, build_layered_store,
                                       build_store)
from repro_torch.kvcache.block_table import (SlotTables, blocks_for,
                                             validate_block_size)
from repro_torch.kvcache.cache import KVCache, write_slot_prefix
from repro_torch.kvcache.paged import (BlockPool, HostBlockPool,
                                       PagedKVCache, copy_block,
                                       extract_blocks, grow_paged_kv_cache,
                                       insert_blocks, write_blocks)
from repro_torch.kvcache.transfer import PrefetchEngine
from repro_torch.models import layers as L
from repro_torch.models.model import build_model

#: smallest prefill bucket; "auto" buckets are powers of two from here up
#: to 128, then multiples of 128 (the MoSKA prefill route-block size) up
#: to max_seq.
MIN_PREFILL_BUCKET = 16


def resolve_prefill_buckets(spec: Union[str, Sequence[int], None],
                            max_seq: int) -> Optional[Tuple[int, ...]]:
    """Resolve an EngineConfig.prefill_buckets spec to a sorted tuple.

    ``"auto"`` — powers of two in [16, 128], then multiples of 128, capped
    at max_seq. ``None`` or an empty sequence — bucketing off (exact
    prompt lengths). A sequence — used as-is (each bucket must be <= 128
    or a multiple of 128 for the routed shared-attention prefill to block
    evenly).
    """
    if spec is None:
        return None
    if isinstance(spec, str):
        if spec != "auto":
            raise ValueError(f"unknown prefill_buckets spec {spec!r}")
        buckets = []
        b = MIN_PREFILL_BUCKET
        while b <= min(max_seq, 128):
            buckets.append(b)
            b *= 2
        b = 256
        while b <= max_seq:
            buckets.append(b)
            b += 128
        return tuple(buckets) if buckets else None
    buckets = tuple(sorted(set(int(b) for b in spec)))
    if not buckets:
        return None
    for b in buckets:
        if b < 1 or b > max_seq:
            raise ValueError(f"prefill bucket {b} outside [1, {max_seq}]")
        if b > 128 and b % 128:
            raise ValueError(
                f"prefill bucket {b} > 128 must be a multiple of 128 "
                "(MoSKA prefill route-block size)")
    return buckets


def bucket_for(buckets: Optional[Tuple[int, ...]], n: int) -> int:
    """Smallest bucket >= n; falls back to the exact length when bucketing
    is off or n exceeds the largest bucket."""
    if buckets:
        for b in buckets:
            if b >= n:
                return b
    return n


@dataclass
class EngineConfig:
    max_slots: int = 4
    max_seq: int = 512
    eos_id: int = -1           # -1: never stop early
    mem_budget_bytes: float = float("inf")
    cache_dtype: Any = torch.bfloat16
    # "auto" | None (exact lengths) | explicit bucket sequence
    prefill_buckets: Union[str, Sequence[int], None] = "auto"
    # -- paged KV layout ------------------------------------------------
    # "slotted": one (L, B, max_seq, KH, D) slab, every slot pays max_seq.
    # "paged": block-pool unique KV with per-slot block tables
    # (dense-family caches only); bit-identical generations, less memory.
    kv_layout: str = "slotted"
    block_size: int = 16        # tokens per page; must divide max_seq
    # fixed pool size in blocks (incl. the reserved null block); None =
    # start small and grow on demand (hbm_high_water_bytes tracks demand)
    num_blocks: Optional[int] = None
    # chunk length for prompts past max_seq (a multiple of 128 keeps the
    # shared-attention route blocks aligned with the single-shot prefill)
    prefill_chunk: int = 128
    # cache completed prompts' pages and remap them (copy-on-write) into
    # later requests with an identical (corpus-content, prompt) key; LRU-
    # evicted under pool pressure
    share_prefix_blocks: bool = True
    # host memory tier (paged layout): capacity, in blocks, of the pinned
    # host pool that LRU-evicted prefix pages are offloaded to instead of
    # being dropped; a later prefix hit swaps them back into free device
    # blocks bit-exactly. 0 disables the tier (evictions rebuild from
    # tokens on the next cold hit).
    host_pool_blocks: int = 0
    # -- async serving pipeline (paged layout) --------------------------
    # in-flight budget for prefetched host->device page copies: during
    # each decode wave, prefix entries the scheduler lookahead predicts
    # will be admitted next are copied up early on a side stream, so the
    # swap-in at admission waits for no transfer (kvcache/prefetch_{issued,
    # hits,wasted}). 0 disables prefetching (synchronous swap-in).
    prefetch_depth: int = 2
    # speculative decode appends: allocate the *next* page for any slot
    # whose next token lands on a fresh page boundary during the current
    # wave, keeping allocator/eviction work off the boundary wave's
    # critical path; unused pages are reclaimed on release
    # (kvcache/spec_pages_{alloc,reclaimed}).
    spec_append: bool = True
    # wave-overlap execution: launch the decode step and its token
    # readback, run the next wave's host-side work (table tick,
    # speculative appends, prefetch issue) while the card computes, then
    # wait on the readback (engine/overlap_saved_s vs
    # engine/decode_stall_s). Off = wait right after the launch,
    # bit-identical generations.
    overlap_waves: bool = True


class ServingEngine:
    def __init__(self, cfg: ModelConfig, params, engine_cfg: EngineConfig):
        if cfg.family == AUDIO:
            raise NotImplementedError(
                f"ServingEngine cannot serve the {cfg.family!r} family: its "
                "prefill needs audio frames (frontend_embeds), which the "
                "engine has no way to pass; use Model.prefill/decode_step")
        self.cfg = cfg
        self.ecfg = engine_cfg
        self.model = build_model(cfg)
        self.params = params
        self.device = params.embed["embed"].device
        self.stores: Dict[str, SharedKVStore] = {}
        self.scheduler = Scheduler(SchedulerConfig(
            max_slots=engine_cfg.max_slots,
            mem_budget_bytes=engine_cfg.mem_budget_bytes,
            unique_bytes_per_token=cfg.kv_bytes_per_token,
            max_seq=engine_cfg.max_seq,
            kv_layout=engine_cfg.kv_layout,
            block_size=engine_cfg.block_size))
        self.scheduler.set_store_evictor(self._on_store_evicted)
        self._buckets = resolve_prefill_buckets(engine_cfg.prefill_buckets,
                                                engine_cfg.max_seq)
        # persistent batch cache: a KVCache, or a state family's dict
        self._cache: Union[KVCache, Dict[str, torch.Tensor], None] = None
        self._paged = engine_cfg.kv_layout == "paged"
        if self._paged:
            self._init_paged_state()
        elif engine_cfg.kv_layout != "slotted":
            raise ValueError(
                f"unknown kv_layout {engine_cfg.kv_layout!r} "
                "(expected 'slotted' or 'paged')")
        elif engine_cfg.host_pool_blocks:
            raise ValueError(
                "host_pool_blocks requires kv_layout='paged' (the host "
                "tier offloads pages, and the slotted layout has none)")
        # the wave's token readback: a pinned host buffer on a card
        self._tok_host = (torch.empty((engine_cfg.max_slots,),
                                      dtype=torch.long, pin_memory=True)
                          if self.device.type == "cuda" else None)
        # corpus token ids kept host-side so evicted stores can be rebuilt
        self._corpus_tokens: Dict[str, np.ndarray] = {}
        self._hbm_high_water = 0.0
        # device-side metric records, flushed once per wave
        self._rec = obs.DeviceRecorder()
        self.metrics = {"decode_steps": 0, "prefills": 0,
                        "tokens_generated": 0, "wall_s": 0.0,
                        "decode_step_s": []}
        # host-side callbacks run at the end of every decode wave (e.g. the
        # streaming metrics exporter's tick)
        self.wave_hooks: List[Any] = []

    def _init_paged_state(self) -> None:
        ecfg = self.ecfg
        self.model._require_paged("kv_layout='paged'")
        validate_block_size(ecfg.block_size, ecfg.max_seq)
        if ecfg.prefill_chunk % ecfg.block_size:
            raise ValueError(
                f"prefill_chunk {ecfg.prefill_chunk} must be a multiple "
                f"of block_size {ecfg.block_size}")
        if ecfg.prefill_chunk > 128 and ecfg.prefill_chunk % 128:
            raise ValueError(
                f"prefill_chunk {ecfg.prefill_chunk} > 128 must be a "
                "multiple of 128 (shared-attention route-block size)")
        m0 = ecfg.max_seq // ecfg.block_size
        # pool growth quantum: one slotted slot's worth of pages
        self._pool_quantum = m0
        cap = ecfg.num_blocks if ecfg.num_blocks is not None else 1 + m0
        self._block_pool = BlockPool(cap)
        self._tables = SlotTables(ecfg.max_slots, m0, ecfg.block_size)
        self._pool: Optional[PagedKVCache] = None   # device pages, lazy
        # (corpus fingerprint, prompt tuple) -> {"blocks": [...],
        # "first": token}, in LRU order
        self._prefix_cache: "collections.OrderedDict" = \
            collections.OrderedDict()
        self._corpus_fp: Dict[str, str] = {}
        # host memory tier for LRU-evicted prefix pages (capacity 0 = off)
        self._host_pool = HostBlockPool(ecfg.host_pool_blocks)
        # async swap-in: prefetched host->device copies for predicted
        # admissions (only meaningful when the host tier can hold entries
        # and prefix sharing gives them a key to hit)
        self._prefetch: Optional[PrefetchEngine] = None
        if ecfg.host_pool_blocks and ecfg.prefetch_depth and \
                ecfg.share_prefix_blocks:
            self._prefetch = PrefetchEngine(self._host_pool,
                                            ecfg.prefetch_depth, self.device)
        # speculatively appended pages not yet written: slot -> table
        # index of the pre-allocated next page (reclaimed on release)
        self._spec_pending: Dict[int, int] = {}
        # the scheduler's offload-vs-defer admission path moves cold
        # prefix pages to the host tier (or drops them with the tier off)
        self.scheduler.set_page_offloader(self._cold_page_bytes,
                                          self._offload_cold_pages)
        if ecfg.host_pool_blocks:
            self.registry.set_gauge("kvcache/host_pool_capacity_blocks",
                                    ecfg.host_pool_blocks)

    @property
    def registry(self) -> obs.MetricsRegistry:
        return obs.get_registry()

    @property
    def prefill_buckets(self) -> Optional[Tuple[int, ...]]:
        return self._buckets

    # ------------------------------------------------------------------
    def register_corpus(self, corpus_id: str, tokens: np.ndarray) -> int:
        """Precompute + chunk a shared corpus' KV. Returns #chunks."""
        if self.cfg.family in (SSM, HYBRID):
            raise NotImplementedError(
                f"register_corpus: the {self.cfg.family!r} family keeps no "
                "KV cache to chunk into a shared store (an SSM's warm start "
                "is models.ssm.shared_state, through Model.prefill)")
        C = self.cfg.moska.chunk_size
        n = (len(tokens) // C) * C
        if n == 0:
            raise ValueError("corpus shorter than one chunk")
        toks = np.asarray(tokens[:n], np.int32)
        store = self._build_store(corpus_id, toks)
        self.stores[corpus_id] = store
        self._corpus_tokens[corpus_id] = toks
        self.scheduler.register_store(corpus_id, store.nbytes)
        reg = self.registry
        reg.inc("engine/corpora_registered")
        reg.inc("engine/corpus_tokens_prefilled", n)
        reg.set_gauge(f"engine/corpus/{corpus_id}/chunks", store.num_chunks)
        return store.num_chunks

    def _build_store(self, corpus_id: str, toks: np.ndarray) -> SharedKVStore:
        C = self.cfg.moska.chunk_size
        with obs.span("engine.register_corpus", corpus_id=corpus_id,
                      tokens=len(toks)):
            cache = self.model.init_cache(1, len(toks), self.ecfg.cache_dtype,
                                          self.device)
            tok = torch.as_tensor(toks, device=self.device)[None].long()
            self.model.prefill(self.params, tok, cache)
            if self.cfg.layer_windows:
                store = build_layered_store(cache.k[:, 0], cache.v[:, 0], C,
                                            self.cfg.layer_windows)
            else:
                store = build_store(cache.k[:, 0], cache.v[:, 0], C)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            return store

    def _on_store_evicted(self, corpus_id: str) -> None:
        """Scheduler LRU eviction callback: drop the store's device tensors
        (the host token ids are kept, so it can be rebuilt on demand)."""
        self.stores.pop(corpus_id, None)
        self.registry.inc("kvcache/stores_dropped")

    def _get_store(self, corpus_id: Optional[str]) -> Optional[SharedKVStore]:
        """The corpus' device store, rebuilding it if the scheduler evicted
        it for memory; touches its LRU clock."""
        if corpus_id is None:
            return None
        store = self.stores.get(corpus_id)
        if store is None:
            if corpus_id not in self._corpus_tokens:
                raise KeyError(f"corpus {corpus_id!r} not registered")
            store = self._build_store(corpus_id,
                                      self._corpus_tokens[corpus_id])
            self.stores[corpus_id] = store
            self.scheduler.mark_store_loaded(corpus_id)
            # rebalance: reloading may push colder stores out
            self.scheduler._evict_stores_for(0.0, keep=corpus_id)
            self.registry.inc("kvcache/store_reloads")
        self.scheduler.touch_store(corpus_id)
        return store

    # ------------------------------------------------------------------
    def submit(self, prompt: Sequence[int], max_new_tokens: int,
               corpus_id: Optional[str] = None) -> int:
        if corpus_id is not None and corpus_id not in self._corpus_tokens \
                and corpus_id not in self.stores:
            raise KeyError(f"corpus {corpus_id!r} not registered")
        return self.scheduler.submit(prompt, max_new_tokens, corpus_id)

    # ------------------------------------------------------------------
    def _ensure_cache(self) -> None:
        """The persistent unique-KV cache (slotted batch cache or paged
        pool): allocated once, reused across ``run()`` calls, updated in
        place."""
        ecfg = self.ecfg
        if self._paged:
            if self._pool is None:
                self._pool = self.model.init_paged_cache(
                    self._block_pool.num_blocks, ecfg.block_size,
                    ecfg.cache_dtype, self.device)
            nbytes = self._pool.nbytes
        else:
            if self._cache is None:
                self._cache = self.model.init_cache(
                    ecfg.max_slots, ecfg.max_seq, ecfg.cache_dtype,
                    self.device)
            nbytes = _cache_nbytes(self._cache)
        self.registry.set_gauge("engine/decode_cache_bytes_copied", 0)
        self.registry.set_gauge("engine/decode_cache_bytes", nbytes)

    def _note_hbm(self, kv_nbytes: float) -> None:
        """Track the peak of (unique KV + loaded shared stores) bytes."""
        total = kv_nbytes + self.scheduler.shared_bytes
        if total > self._hbm_high_water:
            self._hbm_high_water = total
        self.registry.set_gauge("engine/hbm_high_water_bytes",
                                self._hbm_high_water)

    def _livelock(self) -> RuntimeError:
        """Nothing running, nothing admissible, queue non-empty: no wave
        can ever make progress."""
        sch = self.scheduler
        if self._paged:
            cost = ("the head request's block cost "
                    f"({sch._request_cost(sch.queue[0]):.3g} bytes")
        else:
            cost = f"one slot's cost ({sch._slot_cost():.3g} bytes"
        return RuntimeError(
            f"serving livelock: {len(sch.queue)} queued request(s) but none "
            f"admissible — mem_budget_bytes={self.ecfg.mem_budget_bytes:.3g}"
            f" is below {cost} + resident shared stores)")

    def _record_token(self, req: Request, tok: int) -> None:
        """Hand a generated token to the scheduler; a paged slot that just
        finished releases its pages at once."""
        slot = req.slot
        self.scheduler.record_token(req, tok, self.ecfg.eos_id)
        if self._paged and req.done:
            self._release_slot_paged(req, slot)
        self.metrics["tokens_generated"] += 1
        self.registry.inc("engine/tokens_generated")

    @torch.no_grad()
    def run(self, max_waves: int = 10**9) -> List[Request]:
        """Drive to completion (or max_waves); returns finished requests.

        May be called repeatedly: the batch cache (slotted) or page pool
        (paged) stays on the device between calls. Raises RuntimeError on
        a livelocked configuration (queued work that can never be admitted
        under mem_budget_bytes).
        """
        reg = self.registry
        t0 = time.perf_counter()
        tok0 = self.metrics["tokens_generated"]
        self._ensure_cache()
        slot_tokens = np.zeros((self.ecfg.max_slots,), np.int64)

        waves = 0
        with obs.span("engine.run"):
            while not self.scheduler.idle and waves < max_waves:
                with obs.span("engine.wave"):
                    self._wave(slot_tokens)
                waves += 1
        if self._paged:
            self._record_block_gauges()
        wall = time.perf_counter() - t0
        self.metrics["wall_s"] += wall
        reg.set_gauge("engine/last_run_wall_s", wall)
        reg.set_gauge("engine/last_run_tokens_per_s",
                      (self.metrics["tokens_generated"] - tok0) / wall
                      if wall > 0 else 0.0)
        return self.scheduler.finished

    def _wave(self, slot_tokens: np.ndarray) -> None:
        """One wave: admit and prefill into free slots, then one decode
        step of every active slot, its tokens' readback and bookkeeping,
        then the wave hooks. Each phase is an ``engine.*`` span."""
        B = self.ecfg.max_slots
        reg = self.registry
        with obs.span("engine.schedule"):
            admitted = self.scheduler.schedule()
        for req in admitted:
            tp = time.perf_counter()
            with obs.span("engine.prefill", uid=req.uid, slot=req.slot,
                          tokens=len(req.prompt)) as sp:
                sp.attrs["queued_s"] = sp.start_s - req.submitted_s
                k0, p0 = _attn_calls(reg)
                first = (self._prefill_slot_paged(req) if self._paged
                         else self._prefill_slot(req))
                k1, p1 = _attn_calls(reg)
                sp.attrs["attn_kernel_calls"] = k1 - k0
                sp.attrs["attn_calls"] = k1 - k0 + p1 - p0
            reg.observe("engine/prefill_latency_s",
                        time.perf_counter() - tp, obs.LATENCY_EDGES_S)
            slot_tokens[req.slot] = first
            self._record_token(req, first)
        active = self.scheduler.active()
        if not active:
            if not admitted and not self.scheduler.idle:
                raise self._livelock()
            return
        store = self._get_store(self.scheduler.resident_corpus)
        use_store = store is not None and self.cfg.moska.enabled
        store = store if use_store else None
        if self._paged:
            self._prepare_wave_blocks(active)
            self._note_hbm(self._pool.nbytes)
        else:
            self._note_hbm(_cache_nbytes(self._cache))
        reg.observe("engine/wave_batch_density",
                    len(active) / B, obs.FRACTION_EDGES)
        reg.observe("engine/wave_active_slots", len(active),
                    obs.COUNT_EDGES)
        td = time.perf_counter()
        with obs.span("engine.decode"):
            tokens = torch.as_tensor(slot_tokens, device=self.device)
            if self._paged:
                tbl, lens, offs = (torch.as_tensor(a, device=self.device)
                                   for a in self._tables.device_args())
                logits, _ = self.model.decode_step_paged(
                    self.params, tokens, self._pool, tbl, lens, offs,
                    store=store, rec=self._rec)
            else:
                logits, _ = self.model.decode_step(
                    self.params, tokens, self._cache, store=store,
                    rec=self._rec)
        with obs.span("engine.readback"):
            nxt, ready = self._read_tokens(logits)
            if self._paged:
                # the wave's host-side bookkeeping is the same either
                # way; overlap runs it while the card computes, before
                # the readback's wait. None of it writes the page pool.
                if self.ecfg.overlap_waves:
                    th = time.perf_counter()
                    self._wave_host_work(active)
                    reg.observe("engine/overlap_saved_s",
                                time.perf_counter() - th,
                                obs.LATENCY_EDGES_S)
                ts = time.perf_counter()
                if ready is not None:
                    ready.synchronize()     # the wave's only sync point
                stall = time.perf_counter() - ts
                if not self.ecfg.overlap_waves:
                    self._wave_host_work(active)
                reg.observe("engine/decode_stall_s", stall,
                            obs.LATENCY_EDGES_S)
            elif ready is not None:
                ready.synchronize()
            nxt = nxt.numpy()
        dt = time.perf_counter() - td
        with obs.span("engine.record"):
            reg.observe("engine/decode_step_latency_s", dt,
                        obs.LATENCY_EDGES_S)
            self.metrics["decode_step_s"].append(dt)
            self._flush()
            for req in list(active):
                tok = int(nxt[req.slot])
                slot_tokens[req.slot] = tok
                self._record_token(req, tok)
                reg.inc("engine/decoded_tokens")
            self.metrics["decode_steps"] += 1
            reg.inc("engine/decode_steps")
        with obs.span("engine.hooks"):
            for hook in self.wave_hooks:
                hook()

    def _read_tokens(self, logits: torch.Tensor
                     ) -> Tuple[torch.Tensor, Optional[torch.cuda.Event]]:
        """Launch the wave's greedy tokens' way to the host: ``argmax`` on
        the card, a ``non_blocking`` copy into the pinned buffer, and an
        event after it. Returns (the host tensor, the event to wait on
        before reading it; None on the CPU, where the tokens are ready)."""
        nxt = logits.argmax(dim=-1)
        if self._tok_host is None:
            return nxt, None
        self._tok_host.copy_(nxt, non_blocking=True)
        ready = torch.cuda.Event()
        ready.record(torch.cuda.current_stream(self.device))
        return self._tok_host, ready

    def _wave_host_work(self, active: List[Request]) -> None:
        """The paged wave's host-side bookkeeping: advance the tables'
        lengths, allocate the pages the next tokens open, issue prefetches,
        and read the block gauges. Host metadata and side-stream copies
        only: the decode step may still be reading the pool."""
        self._tables.tick()
        self._speculative_appends(active)
        self._issue_prefetches()
        self._record_block_gauges()

    # ------------------------------------------------------------------
    def _bucketed_prefill(self, req: Request, store: Optional[SharedKVStore],
                          start: int) -> Tuple[int, KVCache]:
        """Prefill one prompt, right-padded to its bucket, into a fresh
        1-batch cache sized to the bucket. Returns (first generated token,
        the cache)."""
        true_len = len(req.prompt)
        pad_len = bucket_for(self._buckets, true_len)
        padded = np.zeros((1, pad_len), np.int64)
        padded[0, :true_len] = req.prompt
        slot_cache = self.model.init_cache(1, pad_len, self.ecfg.cache_dtype,
                                           self.device)
        logits, slot_cache = self.model.prefill(
            self.params, torch.as_tensor(padded, device=self.device),
            slot_cache, store=store, start_pos=start, true_len=true_len,
            rec=self._rec)
        return int(logits[0].argmax()), slot_cache         # device sync

    def _flush(self) -> None:
        """Apply the model's device records to the registry. The span open
        here (an admission's ``engine.prefill``, a wave's
        ``engine.record``) keeps the counters' totals of that model call
        by name, among its attributes (the tail kernel's roofline reads
        them)."""
        totals = self._rec.flush(self.registry)
        sp = obs.current_span()
        if sp is not None and totals:
            sp.attrs.update(totals)

    def _count_prefill(self, true_len: int) -> None:
        self._flush()
        self.metrics["prefills"] += 1
        self.registry.inc("engine/prefills")
        self.registry.inc("engine/prefill_tokens", true_len)

    def _store_for(self, req: Request) -> Tuple[Optional[SharedKVStore], int]:
        """(the store the request's prefill attends, if any; the absolute
        position of its first prompt token)."""
        store = self._get_store(req.corpus_id)
        start = store.total_tokens if store is not None else 0
        use_store = store is not None and self.cfg.moska.enabled
        return (store if use_store else None), start

    def _prefill_slot(self, req: Request) -> int:
        """Slotted admission: bucket-padded prefill, then an in-place write
        into batch slot ``req.slot``. Returns the first generated token."""
        if not isinstance(self._cache, KVCache):
            return self._prefill_slot_state(req)
        store, start = self._store_for(req)
        first, slot_cache = self._bucketed_prefill(req, store, start)
        write_slot_prefix(self._cache, slot_cache, req.slot, len(req.prompt))
        self._count_prefill(len(req.prompt))
        return first

    def _prefill_slot_state(self, req: Request) -> int:
        """A state family's admission: the exact prompt into a fresh
        1-batch state (no store: these families register no corpus), the
        argmax as the first token, then each leaf's batch slot written in
        place. Counts the prefill but not its tokens, as the reference's
        fallback path does."""
        slot_cache = self.model.init_cache(1, self.ecfg.max_seq,
                                           self.ecfg.cache_dtype, self.device)
        toks = torch.as_tensor(np.asarray(req.prompt, np.int64)[None],
                               device=self.device)
        logits, slot_cache = self.model.prefill(self.params, toks, slot_cache)
        write_slot_state(self._cache, slot_cache, req.slot)
        self.metrics["prefills"] += 1
        self.registry.inc("engine/prefills")
        return int(logits[0].argmax())                     # device sync

    # -- paged KV layout ------------------------------------------------
    def _corpus_fingerprint(self, corpus_id: Optional[str]) -> Optional[str]:
        """Content fingerprint of a registered corpus: requests bound to
        *different* store ids with identical corpus tokens share one
        prefix-cache namespace (the unique KV depends only on corpus
        tokens + prompt, not the id)."""
        if corpus_id is None:
            return None
        fp = self._corpus_fp.get(corpus_id)
        if fp is None:
            toks = self._corpus_tokens[corpus_id]
            fp = hashlib.blake2b(np.ascontiguousarray(toks).tobytes(),
                                 digest_size=16).hexdigest()
            self._corpus_fp[corpus_id] = fp
        return fp

    def _prefix_key(self, req: Request):
        return (self._corpus_fingerprint(req.corpus_id), tuple(req.prompt))

    def _bytes_per_block(self) -> float:
        return self.cfg.kv_bytes_per_token * self.ecfg.block_size

    def _offload_entry(self, key, entry) -> None:
        """Copy an evicted prefix entry's pages to the host tier — only
        when every page is cold (held solely by the prefix cache; pages a
        live slot still shares stay on the card and re-park later). On a
        card the gather and the copy are queued on the current stream and
        the host does not wait for them."""
        if not self.ecfg.host_pool_blocks:
            return
        bp = self._block_pool
        blocks = entry["blocks"]
        if any(bp.refcount(b) != 1 for b in blocks):
            return
        reg = self.registry
        t0 = time.perf_counter()
        k, v = extract_blocks(self._pool, blocks)
        gens = [(b, bp.generation(b)) for b in blocks]
        evicted = self._host_pool.offload(key, k, v, entry["first"], gens)
        reg.observe("kvcache/swap_out_latency_s",
                    time.perf_counter() - t0, obs.LATENCY_EDGES_S)
        nbytes = _nbytes(k) + _nbytes(v)
        reg.inc("kvcache/offload_bytes", nbytes)
        reg.observe("kvcache/swap_bytes", nbytes, obs.BYTES_EDGES)
        reg.inc("kvcache/offloads")
        if evicted:
            reg.inc("kvcache/host_pool_evictions", len(evicted))
        reg.set_gauge("kvcache/host_pool_blocks_used",
                      self._host_pool.used_blocks)

    def _evict_prefix_entries(self, need_blocks: int) -> int:
        """Evict LRU prefix-cache entries until ``need_blocks`` pages were
        actually released (or the cache is empty), offloading each cold
        entry's pages to the host tier first; returns #released."""
        reg = self.registry
        released = 0
        while self._prefix_cache and released < need_blocks:
            key, entry = self._prefix_cache.popitem(last=False)
            self._offload_entry(key, entry)
            released += self._block_pool.free(entry["blocks"])
            reg.inc("kvcache/prefix_evictions")
        if released:
            reg.inc("kvcache/blocks_evicted", released)
        return released

    def _cold_page_bytes(self) -> float:
        """Budget charge of pages held *only* by the prefix cache — what
        the scheduler's offload admission path can reclaim."""
        bp = self._block_pool
        cold = sum(1 for e in self._prefix_cache.values()
                   for b in e["blocks"] if bp.refcount(b) == 1)
        return cold * self._bytes_per_block()

    def _offload_cold_pages(self, need_bytes: float) -> float:
        """Scheduler callback (offload-vs-defer): move at least
        ``need_bytes`` of cold prefix pages to the host tier (or drop them
        when the tier is off) so a new request can be admitted. Returns
        the bytes actually freed."""
        if self._pool is None or not self._prefix_cache:
            return 0.0
        bpb = self._bytes_per_block()
        return self._evict_prefix_entries(int(-(-need_bytes // bpb))) * bpb

    def _alloc_blocks(self, n: int, reserve: int = 0) -> List[int]:
        """Allocate ``n`` pages, evicting cold prefix entries and (in
        auto-sized mode) growing the device pool when the free list is
        short. ``reserve`` pages beyond ``n`` size the growth so a
        request's decode appends don't retrigger it."""
        bp = self._block_pool
        want = n + reserve
        if bp.available < want:
            self._evict_prefix_entries(want - bp.available)
        if bp.available < want and self.ecfg.num_blocks is None:
            q = self._pool_quantum
            new_cap = bp.num_blocks + -(-(want - bp.available) // q) * q
            self._pool = grow_paged_kv_cache(self._pool, new_cap)
            bp.grow(new_cap)
            self.registry.inc("kvcache/pool_growths")
        return bp.alloc(n)     # PoolExhausted if still short of n

    def _record_block_gauges(self) -> None:
        bp = self._block_pool
        reg = self.registry
        reg.set_gauge("kvcache/blocks_in_use", bp.in_use)
        reg.set_gauge("kvcache/blocks_free", bp.available)
        reg.set_gauge("kvcache/block_capacity", bp.capacity)
        reg.set_gauge("kvcache/block_utilization",
                      bp.in_use / max(bp.capacity, 1))

    def _prefill_slot_paged(self, req: Request) -> int:
        """Admit one request into the paged pool: a prefix-cache hit remaps
        the shared pages; a prompt up to max_seq takes the bucketed prefill
        (as the slotted layout does) and a block scatter; a longer one
        goes through chunked prefill. Returns the first generated token."""
        reg = self.registry
        bs = self.ecfg.block_size
        true_len = len(req.prompt)
        total_blocks = blocks_for(true_len + req.max_new_tokens, bs)
        if total_blocks > self._tables.blocks_per_slot:
            self._tables.grow(total_blocks)
        store, start = self._store_for(req)

        key = self._prefix_key(req)
        entry = (self._prefix_cache.get(key)
                 if self.ecfg.share_prefix_blocks else None)
        if entry is not None:
            self._prefix_cache.move_to_end(key)
            self._block_pool.incref(entry["blocks"])
            self._tables.assign(req.slot, entry["blocks"], true_len, start)
            reg.inc("kvcache/prefix_hits")
            reg.inc("kvcache/blocks_shared", len(entry["blocks"]))
            return int(entry["first"])

        nb = blocks_for(true_len, bs)
        if self.ecfg.share_prefix_blocks and key in self._host_pool:
            return self._swap_in(req, key, nb, total_blocks, start)
        if self.ecfg.host_pool_blocks and self.ecfg.share_prefix_blocks:
            # cold miss in both tiers: deterministic rebuild-from-tokens
            reg.inc("kvcache/host_pool_misses")
        ids = self._alloc_blocks(nb, reserve=total_blocks - nb)
        if true_len <= self.ecfg.max_seq:
            first, slot_cache = self._bucketed_prefill(req, store, start)
        else:
            first, slot_cache = self._prefill_chunked_prompt(req, store,
                                                             start)
        # pad or cut the prefilled prefix to exactly the prompt's pages
        k, v = slot_cache.k[:, 0], slot_cache.v[:, 0]      # (L, S, KH, D)
        S, V = k.shape[1], nb * bs
        if S >= V:
            k, v = k[:, :V], v[:, :V]
        else:
            pad = (0, 0, 0, 0, 0, V - S)
            k = torch.nn.functional.pad(k, pad)
            v = torch.nn.functional.pad(v, pad)
        write_blocks(self._pool, ids, k, v, true_len)
        self._tables.assign(req.slot, ids, true_len, start)
        self._count_prefill(true_len)
        return first

    def _swap_in(self, req: Request, key, nb: int, total_blocks: int,
                 start: int) -> int:
        """Host-tier hit: swap the offloaded pages back into freshly
        allocated device blocks — bit-exact, no prefill at all. Returns the
        first generated token the entry kept."""
        reg = self.registry
        # fetch before alloc: the alloc may evict other prefix entries
        # into the host pool, which must not push this one out
        host_entry = self._host_pool.fetch(key)
        tr = self._prefetch.take(key) if self._prefetch is not None else None
        ids = self._alloc_blocks(nb, reserve=total_blocks - nb)
        t0 = time.perf_counter()
        if tr is not None and tr["gens"] == host_entry["gens"]:
            # prefetched during an earlier wave: the pages are on the card
            # (or arriving; take() made this stream wait for the copy)
            src = tr
            reg.inc("kvcache/prefetch_hits")
        else:
            if tr is not None:
                # the tier churned since issue: this transfer names a dead
                # page lifetime — drop it and swap in the current entry
                # (bit-identical values; the generation tags are the proof)
                reg.inc("kvcache/prefetch_wasted")
            src = host_entry
            if host_entry["ready"] is not None:
                torch.cuda.current_stream(self.device).wait_event(
                    host_entry["ready"])
        insert_blocks(self._pool, ids, src["k"], src["v"])
        reg.observe("kvcache/swap_in_latency_s", time.perf_counter() - t0,
                    obs.LATENCY_EDGES_S)
        nbytes = _nbytes(host_entry["k"]) + _nbytes(host_entry["v"])
        reg.inc("kvcache/swap_in_bytes", nbytes)
        reg.observe("kvcache/swap_bytes", nbytes, obs.BYTES_EDGES)
        reg.inc("kvcache/swap_in_hits")
        reg.set_gauge("kvcache/host_pool_blocks_used",
                      self._host_pool.used_blocks)
        # the slot owns the swapped-in pages exactly as if it had rebuilt
        # them (same block pressure, no CoW on the tail); they re-park in
        # the prefix cache at release
        self._tables.assign(req.slot, ids, len(req.prompt), start)
        return int(host_entry["first"])

    def _prefill_chunked_prompt(self, req: Request,
                                store: Optional[SharedKVStore],
                                start: int) -> Tuple[int, KVCache]:
        """Long-prompt prefill in ``prefill_chunk``-token pieces against a
        growing scratch context. Returns (first generated token, context)."""
        C = self.ecfg.prefill_chunk
        true_len = len(req.prompt)
        ctx = self.model.init_cache(1, blocks_for(true_len, C) * C,
                                    self.ecfg.cache_dtype, self.device)
        for s0 in range(0, true_len, C):
            clen = min(C, true_len - s0)
            chunk = np.zeros((1, C), np.int64)
            chunk[0, :clen] = req.prompt[s0:s0 + clen]
            logits, ctx = self.model.prefill_chunk(
                self.params, torch.as_tensor(chunk, device=self.device), ctx,
                store=store, start_pos=start, chunk_len=clen, rec=self._rec)
            self.registry.inc("engine/prefill_chunks")
        self.registry.inc("engine/chunked_prefills")
        return int(logits[0].argmax()), ctx

    def _prepare_wave_blocks(self, active: List[Request]) -> None:
        """Pre-wave page maintenance: every active slot is about to append
        one token at its current length — make sure the target page exists
        and is exclusively owned (copy-on-write for prefix-shared pages)."""
        tables = self._tables
        bp = self._block_pool
        reg = self.registry
        for req in active:
            slot = req.slot
            bi = int(tables.length[slot]) // self.ecfg.block_size
            spec = self._spec_pending.get(slot)
            if spec is not None and bi >= spec:
                # the speculatively appended page is now the write target:
                # it is fresh (refcount 1, never shared), so neither the
                # append nor the CoW branch below applies — exactly the
                # state the synchronous append would have produced
                del self._spec_pending[slot]
                continue
            if bi >= int(tables.n_blocks[slot]):
                if bi >= tables.blocks_per_slot:
                    tables.grow(bi + 1)
                tables.append_block(slot, self._alloc_blocks(1)[0])
                reg.inc("kvcache/blocks_appended")
            else:
                blk = int(tables.table[slot, bi])
                if bp.needs_copy(blk):
                    new = self._alloc_blocks(1)[0]
                    copy_block(self._pool, new, blk)
                    tables.replace_block(slot, bi, new)
                    bp.free([blk])
                    reg.inc("kvcache/cow_copies")

    def _speculative_appends(self, active: List[Request]) -> None:
        """Decode-boundary page pre-allocation: any slot whose *next* token
        will land on a fresh page gets that page appended now, during the
        current wave, so the next ``_prepare_wave_blocks`` finds it already
        in the table (host metadata only — the free list and the numpy
        table; the pool is untouched, which matters because the decode
        step may still be reading it).

        Deliberately conservative: never evicts, never grows the pool,
        never raises — a full free list simply defers to the synchronous
        append path, bit-identically. A wrong speculation (the request
        finishes on the boundary token) is reclaimed in
        ``_release_slot_paged``."""
        if not self.ecfg.spec_append:
            return
        tables = self._tables
        bp = self._block_pool
        bs = self.ecfg.block_size
        reg = self.registry
        for req in active:
            slot = req.slot
            if slot in self._spec_pending:
                continue
            # lengths were just tick()'d: the slot's NEXT append lands at
            # tables.length[slot]; speculate only when that position opens
            # a page the table doesn't have yet
            bi = int(tables.length[slot]) // bs
            if bi < int(tables.n_blocks[slot]) or \
                    bi >= tables.blocks_per_slot or bp.available < 1:
                continue
            tables.append_block(slot, bp.alloc(1)[0])
            self._spec_pending[slot] = bi
            reg.inc("kvcache/spec_pages_alloc")
            reg.inc("kvcache/blocks_appended")

    def _issue_prefetches(self) -> None:
        """Prefetch host-tier entries the scheduler lookahead predicts will
        be admitted next: issue side-stream host->device copies now so the
        swap-in at admission finds the pages on the card. Also sweeps
        transfers whose host entry churned since issue (counted as
        wasted). Host metadata and side-stream copies only — safe while
        the decode step runs."""
        pf = self._prefetch
        if pf is None:
            return
        reg = self.registry
        stale = pf.sweep()
        if stale:
            reg.inc("kvcache/prefetch_wasted", stale)
        for req in self.scheduler.lookahead(pf.depth):
            key = self._prefix_key(req)
            if key in self._prefix_cache:
                continue    # on the card: admission remaps, no copy
            if pf.issue(key):
                reg.inc("kvcache/prefetch_issued")

    def _release_slot_paged(self, req: Request, slot: int) -> None:
        """Free a finished request's pages; with prefix sharing on, its
        prompt pages (incl. the partial tail — later writers copy it on
        write) are parked in the LRU prefix cache keyed by (corpus,
        prompt)."""
        tables = self._tables
        if self._spec_pending.pop(slot, None) is not None:
            # wrong speculation: the request finished before writing its
            # pre-allocated boundary page; tables.clear below frees it
            # with the rest of the slot (it is never in prefix_blocks — it
            # sits beyond the written region)
            self.registry.inc("kvcache/spec_pages_reclaimed")
        key = self._prefix_key(req)
        if self.ecfg.share_prefix_blocks and req.generated and \
                key not in self._prefix_cache:
            pblocks = tables.prefix_blocks(slot, len(req.prompt))
            if pblocks:
                self._block_pool.incref(pblocks)
                self._prefix_cache[key] = {"blocks": pblocks,
                                           "first": req.generated[0]}
        self._block_pool.free(tables.clear(slot))
        self.registry.inc("kvcache/slots_released")


def _attn_calls(reg: obs.MetricsRegistry) -> Tuple[int, int]:
    """``layers.flash_attention``'s calls so far, (by the kernel, by the
    plain version): an admission's deltas go on its ``engine.prefill``
    span."""
    return (int(reg.counter(L.KERNEL_CALLS).value),
            int(reg.counter(L.PLAIN_CALLS).value))


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _cache_nbytes(cache) -> int:
    if isinstance(cache, KVCache):
        return cache.nbytes
    return sum(_nbytes(t) for t in cache.values())


def write_slot_state(cache: Dict[str, torch.Tensor],
                     slot_cache: Dict[str, torch.Tensor], slot: int) -> None:
    """Copy a 1-batch state dict into batch slot ``slot`` of ``cache``, in
    place: a (B,) leaf takes element 0; an (L, B, ...) leaf takes the
    (L, 1, ...) source over the leading corner of the slot (the
    reference's ``dynamic_update_slice`` at (0, slot, 0, ...)), so no
    other slot is touched or copied."""
    for name, dst in cache.items():
        src = slot_cache[name]
        if dst.dim() == 1:
            dst[slot] = src[0]
        else:
            corner = tuple(slice(0, n) for n in src.shape[2:])
            dst[(slice(None), slot) + corner] = src[:, 0]


def _merge_slot_cache(cache: Dict[str, torch.Tensor],
                      slot_cache: Dict[str, torch.Tensor],
                      slot: int) -> Dict[str, torch.Tensor]:
    """The full-copy merge of a 1-batch state dict into batch slot
    ``slot``: a new dict, ``cache`` untouched. The test oracle of
    ``write_slot_state``, as the reference's ``_merge_slot_cache``."""
    out = {}
    for name, dst in cache.items():
        src, new = slot_cache[name], dst.clone()
        if dst.dim() == 1:
            new[slot] = src[0]
        elif src.shape[0] == dst.shape[0] and src.shape[1] == 1 and \
                src.shape[2] <= dst.shape[2]:
            new[:, slot, :src.shape[2]] = src[:, 0]
        else:
            raise ValueError(f"unmergeable cache leaf {tuple(dst.shape)} <- "
                             f"{tuple(src.shape)}")
        out[name] = new
    return out
