"""Model facade: one API over the family implementations.

Port of the reference ``models/model.py``. The port carries the dense
family (dense, VLM and MoE, all in ``models/dense.py``), with the slotted
and the paged unique-KV layouts. The other families (SSM, hybrid,
enc-dec) come in later slices of the port.

    model = build_model(cfg)
    params = model.init(torch.Generator(device).manual_seed(0), device)
    cache = model.init_cache(batch_size, max_seq, device=device)
    logits, cache = model.prefill(params, tokens, cache, store=...)
    logits, cache = model.prefill(params, tokens, cache,
                                  frontend_embeds=...)     # VLM
    logits, cache = model.decode_step(params, tokens, cache, store=...)
    pool = model.init_paged_cache(num_blocks, block_size, device=device)
    logits, pool = model.decode_step_paged(params, tokens, pool, table,
                                           lengths, offsets, store=...)
    logits, ctx = model.prefill_chunk(params, chunk, ctx, store=...,
                                      start_pos=..., chunk_len=...)
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import DENSE, MOE, VLM, ModelConfig
from repro_torch.kvcache.cache import init_kv_cache
from repro_torch.kvcache.paged import init_paged_kv_cache
from repro_torch.models import dense


class Model:
    def __init__(self, cfg: ModelConfig):
        if cfg.family not in (DENSE, VLM, MOE):
            raise NotImplementedError(
                f"family {cfg.family!r} is ported in a later slice of the "
                "port; the port serves the dense family (dense, VLM, MoE)")
        self.cfg = cfg

    def init(self, generator: torch.Generator, device=None) -> dense.DenseLM:
        return dense.init_params(self.cfg, generator, device)

    def init_cache(self, batch: int, max_seq: int, dtype=torch.bfloat16,
                   device=None):
        cfg = self.cfg
        return init_kv_cache(cfg.num_layers, batch, max_seq,
                             cfg.num_kv_heads, cfg.head_dim, dtype, device)

    def prefill(self, params, tokens, cache, store=None,
                frontend_embeds=None, start_pos: int = 0, true_len=None,
                rec=None):
        # frontend_embeds: the VLM's stub patch embeddings (B, P, d_model)
        if self.cfg.family != VLM:
            frontend_embeds = None
        return dense.prefill(self.cfg, params, tokens, cache, store=store,
                             frontend_embeds=frontend_embeds,
                             start_pos=start_pos, true_len=true_len, rec=rec)

    def decode_step(self, params, tokens, cache, store=None, positions=None,
                    rec=None):
        return dense.decode_step(self.cfg, params, tokens, cache, store=store,
                                 positions=positions, rec=rec)

    # -- paged KV layout (dense-family only) ---------------------------
    def _require_paged(self, what: str):
        if self.cfg.family not in (DENSE, VLM, MOE):
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
