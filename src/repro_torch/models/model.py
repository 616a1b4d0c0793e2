"""Model facade: one API over the family implementations.

Port of the reference ``models/model.py``, every family: dense, VLM and
MoE (``models/dense.py``, with the slotted and the paged unique-KV
layouts), SSM (``models/ssm.py``), hybrid (``models/hybrid.py``) and
enc-dec audio (``models/encdec.py``). The dense family's cache is a
``KVCache``; the others' are dicts of tensors (their states, rings and
cross caches). Every entry point writes the cache in place and returns
it.

    model = build_model(cfg)
    params = model.init(torch.Generator(device).manual_seed(0), device)
    loss, metrics = model.train_loss(params, batch, remat=True)
    cache = model.init_cache(batch_size, max_seq, device=device)
    logits, cache = model.prefill(params, tokens, cache, store=...)
    logits, cache = model.prefill(params, tokens, cache,
                                  frontend_embeds=...)     # VLM, AUDIO
    logits, cache = model.decode_step(params, tokens, cache, store=...)
    pool = model.init_paged_cache(num_blocks, block_size, device=device)
    logits, pool = model.decode_step_paged(params, tokens, pool, table,
                                           lengths, offsets, store=...)
    logits, ctx = model.prefill_chunk(params, chunk, ctx, store=...,
                                      start_pos=..., chunk_len=...)

``store`` is a ``SharedKVStore`` (dense family; enc-dec: the chunked
cross-attention KV of one audio), or the SSM's warm-start state
{"state": ...}; the hybrid takes none (MoSKA is off in its config).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import (AUDIO, DENSE, HYBRID, MOE, SSM, VLM,
                                      ModelConfig)
from repro_torch.kvcache.cache import init_kv_cache
from repro_torch.kvcache.paged import init_paged_kv_cache
from repro_torch.models import dense, encdec, hybrid, ssm
from repro_torch.models.params import ParamTree

_DENSE_FAMILY = (DENSE, VLM, MOE)
_IMPL = {DENSE: dense, VLM: dense, MOE: dense, SSM: ssm, HYBRID: hybrid,
         AUDIO: encdec}


def empty_params(cfg: ModelConfig, device=None):
    """The family's parameter module with unset values."""
    if cfg.family in _DENSE_FAMILY:
        return dense.DenseLM(cfg, device)
    return ParamTree(_IMPL[cfg.family].param_spec(cfg), device)


class Model:
    def __init__(self, cfg: ModelConfig):
        if cfg.family not in _IMPL:
            raise ValueError(cfg.family)
        self.cfg = cfg
        self._impl = _IMPL[cfg.family]

    def init(self, generator: torch.Generator, device=None):
        return self._impl.init_params(self.cfg, generator, device)

    def train_loss(self, params, batch, *, remat: bool = True):
        """(loss, {"ce_loss", "moe_aux"}) of one batch of tensors on the
        parameters' device (``training.train_loop.to_device``), under
        autograd: "tokens"/"targets" (B, S) int64, "mask" (B, S), and the
        VLM's patches or the audio model's frames as "frontend_embeds"."""
        return self._impl.train_loss(self.cfg, params, batch, remat=remat)

    def init_cache(self, batch: int, max_seq: int, dtype=torch.bfloat16,
                   device=None):
        cfg = self.cfg
        if cfg.family in _DENSE_FAMILY:
            return init_kv_cache(cfg.num_layers, batch, max_seq,
                                 cfg.num_kv_heads, cfg.head_dim, dtype,
                                 device)
        return self._impl.init_cache(cfg, batch, max_seq, dtype, device)

    def prefill(self, params, tokens, cache, store=None,
                frontend_embeds=None, start_pos: int = 0, true_len=None,
                rec=None):
        """frontend_embeds: the VLM's stub patch embeddings (B, P,
        d_model), or the audio model's stub frames (B, F, d_model).
        true_len (bucket-padded serving prefill) and rec: the dense family
        only."""
        cfg = self.cfg
        if cfg.family in _DENSE_FAMILY:
            return dense.prefill(
                cfg, params, tokens, cache, store=store,
                frontend_embeds=frontend_embeds if cfg.family == VLM
                else None, start_pos=start_pos, true_len=true_len, rec=rec)
        if true_len is not None:
            raise ValueError(f"true_len: the {cfg.family} family prefills "
                             "exact lengths")
        if cfg.family == AUDIO:
            return encdec.prefill(cfg, params, tokens, cache,
                                  frontend_embeds, start_pos=start_pos)
        if cfg.family == SSM:
            return ssm.prefill(cfg, params, tokens, cache, store=store,
                               start_pos=start_pos)
        return hybrid.prefill(cfg, params, tokens, cache,
                              start_pos=start_pos)

    def decode_step(self, params, tokens, cache, store=None, positions=None,
                    rec=None):
        """positions: the dense family's and the hybrid's and enc-dec's
        absolute positions of the new tokens (default: from the cache)."""
        cfg = self.cfg
        if cfg.family in _DENSE_FAMILY:
            return dense.decode_step(cfg, params, tokens, cache, store=store,
                                     positions=positions, rec=rec)
        if cfg.family == AUDIO:
            return encdec.decode_step(cfg, params, tokens, cache,
                                      store=store, positions=positions,
                                      rec=rec)
        if cfg.family == SSM:
            return ssm.decode_step(cfg, params, tokens, cache)
        return hybrid.decode_step(cfg, params, tokens, cache,
                                  positions=positions)

    # -- paged KV layout (dense-family only) ---------------------------
    def _require_paged(self, what: str):
        if self.cfg.family not in _DENSE_FAMILY:
            raise NotImplementedError(
                f"{what} requires the paged KV layout, which only the "
                f"dense-family caches support (family={self.cfg.family!r}; "
                "use kv_layout='slotted')")

    def init_paged_cache(self, num_blocks: int, block_size: int,
                         dtype=torch.bfloat16, device=None):
        self._require_paged("init_paged_cache")
        cfg = self.cfg
        return init_paged_kv_cache(cfg.num_layers, num_blocks, block_size,
                                   cfg.num_kv_heads, cfg.head_dim, dtype,
                                   device)

    def decode_step_paged(self, params, tokens, pool, table, lengths,
                          offsets, store=None, rec=None):
        self._require_paged("decode_step_paged")
        return dense.decode_step_paged(self.cfg, params, tokens, pool, table,
                                       lengths, offsets, store=store, rec=rec)

    def prefill_chunk(self, params, tokens, cache, store=None, start_pos=0,
                      chunk_len=None, rec=None):
        self._require_paged("prefill_chunk")
        return dense.prefill_chunk(self.cfg, params, tokens, cache,
                                   store=store, start_pos=start_pos,
                                   chunk_len=chunk_len, rec=rec)


def build_model(cfg: ModelConfig) -> Model:
    return Model(cfg)
