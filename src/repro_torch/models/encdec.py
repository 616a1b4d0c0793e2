"""Whisper-style encoder-decoder (audio family) [arXiv:2212.04356].

Port of the reference ``models/encdec.py``. The mel-spectrogram + conv1d
frontend is a stub: the caller hands ``prefill(frontend_embeds=)`` frame
embeddings (B, F, d_model). Positions are sinusoidal, computed on the fly
(the reference's deviation from Whisper's learned decoder positions).

Serving: ``prefill`` encodes the frames, keeps each decoder layer's
cross-attention K/V of them in the cache, and runs the prompt. Each
``decode_step`` appends to the self-attention cache and attends it
through the ``decode_attention`` kernel. Its cross-attention either
reads the request's own cross cache (``decode_attention`` over the F
frames) or, when many requests transcribe against one shared audio,
routes each request's query to its top-k chunks of a ``SharedKVStore``
built from that audio's cross K/V (``router_scores``,
``shared_chunk_attention``, and ``lse_merge``'s routed entry): MoSKA's
mechanism with the encoder output as the shared corpus. The routed
partial is the cross-attention's whole output: there is no unique part
to merge with.

Weights are layer-stacked (``enc_layers``/``dec_layers`` leaves are
``(L, ...)``); the layers run as a Python loop. Cache: {"self_k"/
"self_v": (Ld, B, S, KH, D), "cross_k"/"cross_v": (Ld, B, F, H, D),
"length": (B,) int32}, written in place and returned.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch import obs
from repro_torch.configs.base import ModelConfig
from repro_torch.core import router as router_lib
from repro_torch.core import shared_attention as sa
from repro_torch.core.shared_kv import SharedKVStore
from repro_torch.kvcache.cache import append_token, write_prefix
from repro_torch.models import layers as L
from repro_torch.models import params as P_
from repro_torch.models.dense import torch_dtype
from repro_torch.models.params import ParamTree

Cache = Dict[str, torch.Tensor]


def sinusoid_pos(positions: torch.Tensor, d: int) -> torch.Tensor:
    half = d // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(
        half, dtype=torch.float32, device=positions.device) / max(half - 1, 1))
    ang = positions[..., None].float() * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def param_spec(cfg: ModelConfig) -> P_.Spec:
    d, H, D, dt = cfg.d_model, cfg.num_heads, cfg.head_dim, \
        torch_dtype(cfg.dtype)

    def ln():
        return {"scale": ((d,), dt), "bias": ((d,), dt)}

    def attn(kv_heads):
        return P_.attn_spec(d, H, kv_heads, D, cfg.qkv_bias, dt)

    mlp = P_.mlp_spec(d, cfg.d_ff, dt, gated=False)
    enc = {"ln1": ln(), "ln2": ln(), "attn": attn(H), "mlp": mlp}
    dec = {"ln1": ln(), "ln_x": ln(), "ln2": ln(),
           "attn": attn(cfg.num_kv_heads), "xattn": attn(H), "mlp": mlp}
    return {"embed": {"embed": ((cfg.vocab_size, d), dt)},
            "enc_layers": P_.stacked(enc, cfg.encoder.num_layers),
            "enc_norm": ln(),
            "dec_layers": P_.stacked(dec, cfg.num_layers),
            "final_norm": ln()}


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device=None) -> ParamTree:
    """Random weights with the reference's distributions (LayerNorm scales
    1, biases 0). ``generator`` must live on ``device``."""
    zero = P_.const(0.0)
    return P_.fill(ParamTree(param_spec(cfg), device), generator, {
        "embed": P_.fan_in(cfg.d_model), "scale": P_.const(1.0),
        "bias": zero, **dict.fromkeys(("bq", "bk", "bv"), zero),
        **dict.fromkeys(("wq", "wk", "wv", "wo", "w_up"),
                        P_.fan_in(cfg.d_model)),
        "w_down": P_.fan_in(cfg.d_ff)})


def _ln(x: torch.Tensor, p) -> torch.Tensor:
    return L.layer_norm(x, p["scale"], p["bias"])


def _out(x: torch.Tensor, o: torch.Tensor, p) -> torch.Tensor:
    """Residual output projection of an attention output (..., H, D)."""
    return x + o.reshape(*o.shape[:-2], -1) @ p["wo"]


# ---------------------------------------------------------------------------
# encoder
# ---------------------------------------------------------------------------

def encode(cfg: ModelConfig, params: ParamTree,
           frames: torch.Tensor) -> torch.Tensor:
    """frames: (B, F, d) stub frontend embeddings -> (B, F, d)."""
    F_ = frames.shape[1]
    x = frames + sinusoid_pos(torch.arange(F_, device=frames.device),
                              cfg.d_model)[None].to(frames.dtype)
    H = cfg.num_heads
    for i in range(cfg.encoder.num_layers):
        lp = P_.select(params["enc_layers"], i)
        q, k, v = L.qkv_project(_ln(x, lp["ln1"]), lp["attn"], H, H,
                                cfg.head_dim)
        x = _out(x, L.flash_attention(q, k, v, causal=False), lp["attn"])
        x = x + L.gelu_mlp(_ln(x, lp["ln2"]), lp["mlp"])
    return _ln(x, params["enc_norm"])


# ---------------------------------------------------------------------------
# serving: prefill / decode with a self cache and the cross K/V
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               dtype=torch.bfloat16, device=None) -> Cache:
    Ld, F_ = cfg.num_layers, cfg.encoder.frontend_seq
    H, KH, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim

    def zeros(shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=device)

    return {"self_k": zeros((Ld, batch, max_seq, KH, D)),
            "self_v": zeros((Ld, batch, max_seq, KH, D)),
            "cross_k": zeros((Ld, batch, F_, H, D)),
            "cross_v": zeros((Ld, batch, F_, H, D)),
            "length": zeros((batch,), torch.int32)}


def _cross_kv(cfg: ModelConfig, lp, enc_out: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """A decoder layer's cross-attention K/V of the encoder output (B, F,
    d) -> (B, F, H, D) each."""
    p = lp["xattn"]
    k, v = enc_out @ p["wk"], enc_out @ p["wv"]
    if "bk" in p:
        k, v = k + p["bk"], v + p["bv"]
    shape = (*enc_out.shape[:-1], cfg.num_heads, cfg.head_dim)
    return k.reshape(shape), v.reshape(shape)


def _logits(params: ParamTree, x: torch.Tensor) -> torch.Tensor:
    return L.unembed(_ln(x, params["final_norm"]), params["embed"]["embed"])


def _embed(cfg: ModelConfig, params: ParamTree, tokens: torch.Tensor,
           positions: torch.Tensor) -> torch.Tensor:
    x = params["embed"]["embed"][tokens]
    return x + sinusoid_pos(positions, cfg.d_model).to(x.dtype)


@torch.no_grad()
def prefill(cfg: ModelConfig, params: ParamTree, tokens: torch.Tensor,
            cache: Cache, frontend_embeds: torch.Tensor,
            start_pos: int = 0) -> Tuple[torch.Tensor, Cache]:
    """Encode the frames, keep each layer's cross K/V of them, and run the
    decoder prefix. tokens: (B, S); frontend_embeds: (B, F, d). The cache
    length is S, as the reference's (``start_pos`` only moves the
    positional embedding)."""
    enc_out = encode(cfg, params, frontend_embeds)
    S = tokens.shape[1]
    H, KH, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    x = _embed(cfg, params, tokens,
               start_pos + torch.arange(S, device=tokens.device))
    for i in range(cfg.num_layers):
        lp = P_.select(params["dec_layers"], i)
        xk, xv = _cross_kv(cfg, lp, enc_out)
        q, k, v = L.qkv_project(_ln(x, lp["ln1"]), lp["attn"], H, KH, D)
        write_prefix(cache["self_k"][i], cache["self_v"][i], k, v)
        x = _out(x, L.flash_attention(q, k, v, causal=True), lp["attn"])
        qx, _, _ = L.qkv_project(_ln(x, lp["ln_x"]), lp["xattn"], H, H, D)
        x = _out(x, L.flash_attention(qx, xk, xv, causal=False), lp["xattn"])
        x = x + L.gelu_mlp(_ln(x, lp["ln2"]), lp["mlp"])
        cache["cross_k"][i] = xk
        cache["cross_v"][i] = xv
    cache["length"].fill_(S)
    return _logits(params, x[:, -1]), cache


@torch.no_grad()
def decode_step(cfg: ModelConfig, params: ParamTree, tokens: torch.Tensor,
                cache: Cache, store: Optional[SharedKVStore] = None,
                positions: Optional[torch.Tensor] = None,
                rec: Optional[obs.DeviceRecorder] = None
                ) -> Tuple[torch.Tensor, Cache]:
    """One decode token per request. tokens: (B,). With ``store`` (a
    ``SharedKVStore`` of the shared audio's cross K/V, layer-stacked) and
    MoSKA on, the cross-attention routes over its chunks instead of
    reading the per-request cross caches. Returns (logits (B, V) fp32,
    cache) with the self caches and lengths advanced in place."""
    B = tokens.shape[0]
    H, KH, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    lengths = cache["length"]
    x = _embed(cfg, params, tokens,
               lengths if positions is None else positions)
    use_store = store is not None and cfg.moska.enabled
    full = torch.full((B,), cfg.encoder.frontend_seq, dtype=torch.int32,
                      device=x.device)
    for i in range(cfg.num_layers):
        lp = P_.select(params["dec_layers"], i)
        q, k, v = (t[:, 0] for t in L.qkv_project(
            _ln(x, lp["ln1"])[:, None], lp["attn"], H, KH, D))
        kc, vc = cache["self_k"][i], cache["self_v"][i]
        append_token(kc, vc, k, v, lengths)
        x = _out(x, L.decode_attention(q, kc, vc, lengths + 1), lp["attn"])
        qx = L.qkv_project(_ln(x, lp["ln_x"])[:, None], lp["xattn"], H, H,
                           D)[0][:, 0]
        if use_store:
            routing = router_lib.route(qx, store.emb[i],
                                       cfg.moska.top_k_chunks)
            ox = sa.shared_attention_batched(
                qx[:, None], store.k[i], store.v[i], routing, layer_idx=i,
                rec=rec).out[:, 0]
        else:
            ox = L.decode_attention(qx, cache["cross_k"][i],
                                    cache["cross_v"][i], full)
        x = _out(x, ox, lp["xattn"])
        x = x + L.gelu_mlp(_ln(x, lp["ln2"]), lp["mlp"])
    lengths.add_(1)
    return _logits(params, x), cache
