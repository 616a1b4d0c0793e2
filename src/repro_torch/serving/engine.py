"""MoSKA serving engine: continuous batching over slot-based decode waves.

Port of the slotted path of the reference ``serving/engine.py``:

  register_corpus()  — precompute a domain corpus' KV once (prefill) and
                       chunk it into a SharedKVStore, persistent across
                       requests (the Shared-KV node state).
  submit()/run()     — the scheduler admits requests into B slots; each
                       admission prefills into a fresh slot cache and is
                       written into the batch cache in place; each decode
                       wave runs one step where every layer routes and
                       batches shared attention across all concurrent
                       slots (the GEMM) and LSE-merges it with per-slot
                       unique attention.

The (L, B, S, KH, D) unique-KV batch cache is allocated once, kept on the
device across ``run()`` calls and updated in place (so
``engine/decode_cache_bytes_copied`` reads 0). Prompt lengths are rounded
up to a small bucket set; pad positions are left out of routing and
logits, so a bucketed prefill computes what the exact-length one would.
Device-side dispatch metrics are read back once per wave, after the token
readback. The paged layout is ported in a later slice.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch import obs
from repro_torch.configs.base import ModelConfig
from repro_torch.core.scheduler import Request, Scheduler, SchedulerConfig
from repro_torch.core.shared_kv import SharedKVStore, build_store
from repro_torch.kvcache.cache import KVCache, write_slot_prefix
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
    # "slotted": one (L, B, max_seq, KH, D) slab; "paged" is a later slice
    kv_layout: str = "slotted"


class ServingEngine:
    def __init__(self, cfg: ModelConfig, params, engine_cfg: EngineConfig):
        if engine_cfg.kv_layout == "paged":
            raise NotImplementedError(
                "kv_layout='paged' (block pool + paged_decode_attention) is "
                "ported in a later slice of the port")
        if engine_cfg.kv_layout != "slotted":
            raise ValueError(f"unknown kv_layout {engine_cfg.kv_layout!r} "
                             "(expected 'slotted')")
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
            kv_layout=engine_cfg.kv_layout))
        self.scheduler.set_store_evictor(self._on_store_evicted)
        self._buckets = resolve_prefill_buckets(engine_cfg.prefill_buckets,
                                                engine_cfg.max_seq)
        self._cache: Optional[KVCache] = None   # persistent batch cache
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

    @property
    def registry(self) -> obs.MetricsRegistry:
        return obs.get_registry()

    @property
    def prefill_buckets(self) -> Optional[Tuple[int, ...]]:
        return self._buckets

    # ------------------------------------------------------------------
    def register_corpus(self, corpus_id: str, tokens: np.ndarray) -> int:
        """Precompute + chunk a shared corpus' KV. Returns #chunks."""
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
    def _ensure_cache(self) -> KVCache:
        """The persistent batch cache: allocated once, reused across
        ``run()`` calls, updated in place."""
        if self._cache is None:
            self._cache = self.model.init_cache(
                self.ecfg.max_slots, self.ecfg.max_seq,
                self.ecfg.cache_dtype, self.device)
        nbytes = self._cache.nbytes
        self.registry.set_gauge("engine/decode_cache_bytes_copied", 0)
        self.registry.set_gauge("engine/decode_cache_bytes", nbytes)
        return self._cache

    def _note_hbm(self, kv_nbytes: float) -> None:
        """Track the peak of (unique KV + loaded shared stores) bytes."""
        total = kv_nbytes + self.scheduler.shared_bytes
        if total > self._hbm_high_water:
            self._hbm_high_water = total
        self.registry.set_gauge("engine/hbm_high_water_bytes",
                                self._hbm_high_water)

    @torch.no_grad()
    def run(self, max_waves: int = 10**9) -> List[Request]:
        """Drive to completion (or max_waves); returns finished requests.

        May be called repeatedly: the batch cache stays on the device
        between calls. Raises RuntimeError on a livelocked configuration
        (queued work that can never be admitted under mem_budget_bytes).
        """
        B = self.ecfg.max_slots
        reg = self.registry
        t0 = time.perf_counter()
        tok0 = self.metrics["tokens_generated"]
        cache = self._ensure_cache()
        slot_tokens = np.zeros((B,), np.int64)

        waves = 0
        with obs.span("engine.run"):
            while not self.scheduler.idle and waves < max_waves:
                admitted = self.scheduler.schedule()
                for req in admitted:
                    tp = time.perf_counter()
                    first = self._prefill_slot(cache, req)
                    reg.observe("engine/prefill_latency_s",
                                time.perf_counter() - tp,
                                obs.LATENCY_EDGES_S)
                    slot_tokens[req.slot] = first
                    self.scheduler.record_token(req, first, self.ecfg.eos_id)
                    self.metrics["tokens_generated"] += 1
                    reg.inc("engine/tokens_generated")
                active = self.scheduler.active()
                if not active:
                    if not admitted and not self.scheduler.idle:
                        raise RuntimeError(
                            "serving livelock: "
                            f"{len(self.scheduler.queue)} queued "
                            "request(s) but none admissible — "
                            f"mem_budget_bytes="
                            f"{self.ecfg.mem_budget_bytes:.3g} is below "
                            "one slot's cost "
                            f"({self.scheduler._slot_cost():.3g} bytes "
                            "+ resident shared stores)")
                    waves += 1
                    continue
                store = self._get_store(self.scheduler.resident_corpus)
                use_store = store is not None and self.cfg.moska.enabled
                self._note_hbm(cache.nbytes)
                reg.observe("engine/wave_batch_density",
                            len(active) / B, obs.FRACTION_EDGES)
                reg.observe("engine/wave_active_slots", len(active),
                            obs.COUNT_EDGES)
                td = time.perf_counter()
                logits, _ = self.model.decode_step(
                    self.params, torch.as_tensor(slot_tokens,
                                                 device=self.device),
                    cache, store=store if use_store else None, rec=self._rec)
                nxt = logits.argmax(dim=-1).cpu().numpy()  # device sync
                dt = time.perf_counter() - td
                reg.observe("engine/decode_step_latency_s", dt,
                            obs.LATENCY_EDGES_S)
                self.metrics["decode_step_s"].append(dt)
                self._rec.flush(reg)
                for req in list(active):
                    tok = int(nxt[req.slot])
                    slot_tokens[req.slot] = tok
                    self.scheduler.record_token(req, tok, self.ecfg.eos_id)
                    self.metrics["tokens_generated"] += 1
                    reg.inc("engine/tokens_generated")
                    reg.inc("engine/decoded_tokens")
                self.metrics["decode_steps"] += 1
                reg.inc("engine/decode_steps")
                for hook in self.wave_hooks:
                    hook()
                waves += 1
        wall = time.perf_counter() - t0
        self.metrics["wall_s"] += wall
        reg.set_gauge("engine/last_run_wall_s", wall)
        reg.set_gauge("engine/last_run_tokens_per_s",
                      (self.metrics["tokens_generated"] - tok0) / wall
                      if wall > 0 else 0.0)
        return self.scheduler.finished

    # ------------------------------------------------------------------
    def _prefill_slot(self, cache: KVCache, req: Request) -> int:
        """Prefill one slot: bucket-padded prefill into a fresh 1-batch
        cache, then an in-place write into batch slot ``req.slot``.
        Returns the first generated token."""
        store = self._get_store(req.corpus_id)
        true_len = len(req.prompt)
        pad_len = bucket_for(self._buckets, true_len)
        padded = np.zeros((1, pad_len), np.int64)
        padded[0, :true_len] = req.prompt
        start = store.total_tokens if store is not None else 0
        use_store = store is not None and self.cfg.moska.enabled
        slot_cache = self.model.init_cache(1, pad_len, self.ecfg.cache_dtype,
                                           self.device)
        logits, slot_cache = self.model.prefill(
            self.params, torch.as_tensor(padded, device=self.device),
            slot_cache, store=store if use_store else None, start_pos=start,
            true_len=true_len, rec=self._rec)
        write_slot_prefix(cache, slot_cache, req.slot, true_len)
        first = int(logits[0].argmax())                     # device sync
        self._rec.flush(self.registry)
        self.metrics["prefills"] += 1
        self.registry.inc("engine/prefills")
        self.registry.inc("engine/prefill_tokens", true_len)
        return first
