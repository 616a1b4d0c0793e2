"""Dense / GQA decoder: prefill and decode with the MoSKA mixture.

Port of the dense branch of the reference ``models/dense.py``: pre-norm
transformer with RoPE, GQA attention and a SwiGLU FFN. Parameters live in
a :class:`DenseLM` module (an ``nn.ModuleList`` of layers); the layers run
as a Python loop. When a ``SharedKVStore`` is attached, each layer routes
its queries over that layer's shared chunks and merges the batched shared
partial with the unique partial (``core/moska_attention.py``).

Caches are written in place: ``prefill`` and ``decode_step`` return the
cache they were given, updated.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

from repro_torch import obs
from repro_torch.configs.base import ModelConfig
from repro_torch.core import moska_attention as MA
from repro_torch.core import router as router_lib
from repro_torch.core.shared_kv import SharedKVStore
from repro_torch.kvcache.cache import KVCache, append_token, write_prefix
from repro_torch.models import layers as L


def torch_dtype(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[name]


def _param(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


class DenseLayer(nn.Module):
    """One decoder layer's parameters, under the reference's names."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        dt = torch_dtype(cfg.dtype)
        d, f = cfg.d_model, cfg.d_ff
        hq, hkv = cfg.num_heads * cfg.head_dim, cfg.num_kv_heads * cfg.head_dim
        self.ln1 = nn.ParameterDict({"scale": _param((d,), dt, device)})
        self.ln2 = nn.ParameterDict({"scale": _param((d,), dt, device)})
        attn = {"wq": _param((d, hq), dt, device),
                "wk": _param((d, hkv), dt, device),
                "wv": _param((d, hkv), dt, device),
                "wo": _param((hq, d), dt, device)}
        if cfg.qkv_bias:
            attn.update(bq=_param((hq,), dt, device),
                        bk=_param((hkv,), dt, device),
                        bv=_param((hkv,), dt, device))
        self.attn = nn.ParameterDict(attn)
        self.mlp = nn.ParameterDict({"w_gate": _param((d, f), dt, device),
                                     "w_up": _param((d, f), dt, device),
                                     "w_down": _param((f, d), dt, device)})


class DenseLM(nn.Module):
    """Embedding, layer stack, final norm and (untied) unembedding."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        if cfg.moe.enabled:
            raise NotImplementedError(
                "MoE FFNs are ported in a later slice of the port")
        dt = torch_dtype(cfg.dtype)
        V, d = cfg.vocab_size, cfg.d_model
        self.embed = nn.ParameterDict({"embed": _param((V, d), dt, device)})
        self.layers = nn.ModuleList(DenseLayer(cfg, device)
                                    for _ in range(cfg.num_layers))
        self.final_norm = nn.ParameterDict({"scale": _param((d,), dt, device)})
        self.unembed = (None if cfg.tie_embeddings else nn.ParameterDict(
            {"unembed": _param((V, d), dt, device)}))

    def unembed_matrix(self) -> torch.Tensor:
        if self.unembed is None:
            return self.embed["embed"]
        return self.unembed["unembed"]


@torch.no_grad()
def init_params(cfg: ModelConfig, generator: torch.Generator,
                device=None) -> DenseLM:
    """Random weights with the reference's distributions: normal
    embeddings and projections scaled by 1/sqrt(fan_in), zero norms and
    biases. ``generator`` must live on ``device``."""
    model = DenseLM(cfg, device)
    d, f = cfg.d_model, cfg.d_ff

    def normal_(p: torch.Tensor, std: float) -> None:
        p.copy_(torch.randn(p.shape, generator=generator, device=p.device,
                            dtype=torch.float32) * std)

    normal_(model.embed["embed"], 1 / math.sqrt(d))
    for lp in model.layers:
        lp.ln1["scale"].zero_()
        lp.ln2["scale"].zero_()
        for name, p in lp.attn.items():
            if name.startswith("b"):
                p.zero_()
            else:
                normal_(p, 1 / math.sqrt(d))
        normal_(lp.mlp["w_gate"], 1 / math.sqrt(d))
        normal_(lp.mlp["w_up"], 1 / math.sqrt(d))
        normal_(lp.mlp["w_down"], 1 / math.sqrt(f))
    model.final_norm["scale"].zero_()
    if model.unembed is not None:
        normal_(model.unembed["unembed"], 1 / math.sqrt(d))
    return model


# ---------------------------------------------------------------------------
# layer bodies
# ---------------------------------------------------------------------------

def _attn_out_proj(o: torch.Tensor, lp: DenseLayer) -> torch.Tensor:
    """o: (B, S, H, D) or (B, H, D) -> project back to d_model."""
    return o.reshape(*o.shape[:-2], -1) @ lp.attn["wo"]


def _shared_layer(store: SharedKVStore, i: int, dtype: torch.dtype):
    """Layer i's store slices; an int8 store is dequantized to the
    activation dtype first."""
    sk, sv, semb = store.k[i], store.v[i], store.emb[i]
    if store.quantized:
        sk = sk.to(dtype) * store.k_scale[i][..., None].to(dtype)
        sv = sv.to(dtype) * store.v_scale[i][..., None].to(dtype)
    return sk, sv, semb


def _layer_prefill(cfg: ModelConfig, x: torch.Tensor, lp: DenseLayer,
                   positions: torch.Tensor, kc: torch.Tensor,
                   vc: torch.Tensor, shared, q_offset: int,
                   true_len: Optional[int] = None,
                   layer_idx: Optional[int] = None,
                   rec: Optional[obs.DeviceRecorder] = None) -> torch.Tensor:
    """Prefill layer: causal attention + cache write + optional MoSKA path.

    ``true_len``: the real prompt length when the sequence is right-padded
    to a prefill bucket. Pad queries are left out of the router pooling,
    so routing (and every real row's output) matches the exact-length
    prefill; pad rows compute values the caller discards.
    """
    h = L.rms_norm(x, lp.ln1["scale"], cfg.rms_eps)
    q, k, v = L.qkv_project(h, lp.attn, cfg.num_heads, cfg.num_kv_heads,
                            cfg.head_dim)
    q = L.apply_rope(q, positions, cfg.rope_theta)
    k = L.apply_rope(k, positions, cfg.rope_theta)
    write_prefix(kc, vc, k, v)

    if shared is not None:
        sk, sv, semb = shared
        B, S, H, D = q.shape
        rb = min(128, S)
        nb = S // rb
        if true_len is None:
            pooled = q.reshape(B * nb, rb, H, D).mean(dim=1)
        else:
            valid = (torch.arange(S, device=q.device) < true_len).to(q.dtype)
            qs = (q * valid[None, :, None, None]).reshape(B, nb, rb, H, D)
            cnt = valid.reshape(nb, rb).sum(dim=1).clamp_min(1.0)
            pooled = (qs.sum(dim=2) /
                      cnt[None, :, None, None]).reshape(B * nb, H, D)
        routing = router_lib.route(pooled, semb, cfg.moska.top_k_chunks)
        ctx = MA.MoskaLayerContext(sk, sv, routing)
        o = MA.moska_prefill_attention(
            q, k, v, ctx, cfg.moska, q_offset=q_offset,
            window=cfg.attn_window, route_block=rb, layer_idx=layer_idx,
            rec=rec)
    else:
        o = L.flash_attention(q, k, v, causal=True, q_offset=q_offset,
                              kv_offset=q_offset, window=cfg.attn_window)
    x = x + _attn_out_proj(o, lp)
    h2 = L.rms_norm(x, lp.ln2["scale"], cfg.rms_eps)
    return x + L.swiglu_mlp(h2, lp.mlp)


def _layer_decode(cfg: ModelConfig, x: torch.Tensor, lp: DenseLayer,
                  positions: torch.Tensor, kc: torch.Tensor,
                  vc: torch.Tensor, lengths: torch.Tensor, shared,
                  layer_idx: Optional[int] = None,
                  rec: Optional[obs.DeviceRecorder] = None) -> torch.Tensor:
    """Decode layer: one token per request. x: (B, d); positions: (B,)
    absolute position of the new token; the new K/V are appended to the
    layer's cache slices in place."""
    h = L.rms_norm(x, lp.ln1["scale"], cfg.rms_eps)
    q, k, v = L.qkv_project(h[:, None], lp.attn, cfg.num_heads,
                            cfg.num_kv_heads, cfg.head_dim)
    q = L.apply_rope(q, positions[:, None], cfg.rope_theta)[:, 0]  # (B,H,D)
    k = L.apply_rope(k, positions[:, None], cfg.rope_theta)[:, 0]
    append_token(kc, vc, k, v[:, 0], lengths)
    new_len = lengths + 1

    ctx = None
    if shared is not None:
        sk, sv, semb = shared
        routing = router_lib.route(q, semb, cfg.moska.top_k_chunks)
        ctx = MA.MoskaLayerContext(sk, sv, routing)
    o = MA.moska_decode_attention(q, kc, vc, new_len, ctx, cfg.moska,
                                  window=cfg.attn_window,
                                  layer_idx=layer_idx, rec=rec)
    x = x + _attn_out_proj(o, lp)
    h2 = L.rms_norm(x, lp.ln2["scale"], cfg.rms_eps)
    return x + L.swiglu_mlp(h2, lp.mlp)


# ---------------------------------------------------------------------------
# full-model forwards
# ---------------------------------------------------------------------------

def _logits(cfg: ModelConfig, params: DenseLM, x: torch.Tensor
            ) -> torch.Tensor:
    """fp32 logits of the final-normed hidden state (the reference's
    preferred_element_type=float32 unembedding)."""
    x = L.rms_norm(x, params.final_norm["scale"], cfg.rms_eps)
    return x.float() @ params.unembed_matrix().float().T


@torch.no_grad()
def prefill(cfg: ModelConfig, params: DenseLM, tokens: torch.Tensor,
            cache: KVCache, store: Optional[SharedKVStore] = None,
            start_pos: int = 0, true_len: Optional[int] = None,
            rec: Optional[obs.DeviceRecorder] = None
            ) -> Tuple[torch.Tensor, KVCache]:
    """Process the unique prefix; returns (last-token logits, cache).

    ``true_len``: real prompt length when ``tokens`` is right-padded to a
    prefill bucket — logits are taken at position ``true_len - 1`` and the
    cache lengths record ``true_len``.
    """
    x = params.embed["embed"][tokens]
    B, S, _ = x.shape
    positions = start_pos + torch.arange(S, device=x.device)
    use_store = store is not None and cfg.moska.enabled
    for i, lp in enumerate(params.layers):
        sh = _shared_layer(store, i, x.dtype) if use_store else None
        x = _layer_prefill(cfg, x, lp, positions, cache.k[i], cache.v[i], sh,
                           start_pos, true_len=true_len, layer_idx=i,
                           rec=rec)
    n_valid = S if true_len is None else int(true_len)
    logits = _logits(cfg, params, x[:, n_valid - 1])
    cache.length.fill_(n_valid)
    cache.offset.fill_(start_pos)
    return logits, cache


@torch.no_grad()
def decode_step(cfg: ModelConfig, params: DenseLM, tokens: torch.Tensor,
                cache: KVCache, store: Optional[SharedKVStore] = None,
                positions: Optional[torch.Tensor] = None,
                rec: Optional[obs.DeviceRecorder] = None
                ) -> Tuple[torch.Tensor, KVCache]:
    """One decode step. tokens: (B,). Returns (logits (B, V) fp32, cache)
    with the new token's K/V appended and the lengths advanced, in place."""
    x = params.embed["embed"][tokens]                      # (B, d)
    if positions is None:
        positions = cache.positions                        # absolute (RoPE)
    use_store = store is not None and cfg.moska.enabled
    for i, lp in enumerate(params.layers):
        sh = _shared_layer(store, i, x.dtype) if use_store else None
        x = _layer_decode(cfg, x, lp, positions, cache.k[i], cache.v[i],
                          cache.length, sh, layer_idx=i, rec=rec)
    logits = _logits(cfg, params, x)
    cache.length.add_(1)
    return logits, cache
