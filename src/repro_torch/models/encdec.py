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

Under a mesh (``sharding/tensor_parallel.py``) the same entry points run
tensor parallel over ``model`` through the dense family's meshed helpers:
the encoder's and the decoder's attention by heads, the GELU MLPs by
columns, the tied unembedding by vocab rows where the rules split them
(whisper-tiny's 6 heads and 51,865-row vocabulary stay whole over a
``model`` axis of 16). The cross K/V come out split by head and are
re-placed as the cross cache's rules place it (by position) before the
write. The decode step's self-attention, its cross-attention over the
cross cache and its routed cross-attention over a chunk-sharded store go
through ``core/disagg.meshed_decode_attention``.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch import obs
from repro_torch.configs.base import ModelConfig
from repro_torch.core import disagg
from repro_torch.core import router as router_lib
from repro_torch.core import shared_attention as sa
from repro_torch.core.shared_kv import SharedKVStore
from repro_torch.kvcache.cache import append_token, write_prefix
from repro_torch.models import layers as L
from repro_torch.models import params as P_
from repro_torch.models.dense import (_act, _causal_attention, _embed,
                                      _merge_heads, _shared_layer, lm_loss,
                                      torch_dtype)
from repro_torch.models.params import ParamTree
from repro_torch.sharding import tensor_parallel as tp
from repro_torch.sharding.specs import lsc

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
    return _act(x + _act(_merge_heads(o) @ tp.gather_weight(p["wo"])))


def _mlp(x: torch.Tensor, lp) -> torch.Tensor:
    """The residual GELU MLP block."""
    return _act(x + _act(L.gelu_mlp(_ln(x, lp["ln2"]),
                                    tp.gather_weights(lp["mlp"]))))


def _qkv(x: torch.Tensor, p, H: int, KH: int, D: int):
    """q (..., H, D), k and v (..., KH, D) of x; on a mesh pinned by
    heads."""
    q, k, v = L.qkv_project(x, tp.gather_weights(p), H, KH, D)
    seq = ("seq",)[:x.ndim - 2]
    return (lsc(q, "batch", *seq, "heads", None),
            lsc(k, "batch", *seq, "kv_heads", None),
            lsc(v, "batch", *seq, "kv_heads", None))


def _plus_positions(x: torch.Tensor, positions: torch.Tensor, d: int
                    ) -> torch.Tensor:
    """x + the sinusoidal embeddings of ``positions`` (broadcast over x's
    leading dims); a ``DTensor`` on its local rows."""
    def add(t, pos):
        return t + sinusoid_pos(pos, d).to(t.dtype)
    if not tp.is_meshed(x):
        return add(x, positions)
    return tp.local_call(add, (x, positions), x.placements, x.device_mesh)


# ---------------------------------------------------------------------------
# encoder
# ---------------------------------------------------------------------------

def encode(cfg: ModelConfig, params: ParamTree,
           frames: torch.Tensor) -> torch.Tensor:
    """frames: (B, F, d) stub frontend embeddings -> (B, F, d)."""
    F_ = frames.shape[1]
    x = _act(_plus_positions(frames, torch.arange(F_, device=frames.device),
                             cfg.d_model))
    H = cfg.num_heads
    for i in range(cfg.encoder.num_layers):
        lp = P_.select(params["enc_layers"], i)
        q, k, v = _qkv(_ln(x, lp["ln1"]), lp["attn"], H, H, cfg.head_dim)
        x = _out(x, _causal_attention(cfg, q, k, v, causal=False),
                 lp["attn"])
        x = _mlp(x, lp)
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
    p = tp.gather_weights(lp["xattn"])
    k, v = enc_out @ p["wk"], enc_out @ p["wv"]
    if "bk" in p:
        k, v = k + p["bk"], v + p["bv"]
    H, D = cfg.num_heads, cfg.head_dim
    return (lsc(tp.split_heads(k, H, D), "batch", "seq", "heads", None),
            lsc(tp.split_heads(v, H, D), "batch", "seq", "heads", None))


def _logits(params: ParamTree, x: torch.Tensor) -> torch.Tensor:
    return L.unembed(_ln(x, params["final_norm"]),
                     tp.gather_weight(params["embed"]["embed"]))


def _embed_at(cfg: ModelConfig, params: ParamTree, tokens: torch.Tensor,
              positions: torch.Tensor) -> torch.Tensor:
    return _act(_plus_positions(_embed(params, tokens), positions,
                                cfg.d_model))


# ---------------------------------------------------------------------------
# training: teacher forcing
# ---------------------------------------------------------------------------

def _dec_layer_full(cfg: ModelConfig, lp, x: torch.Tensor,
                    positions: torch.Tensor, xk: torch.Tensor,
                    xv: torch.Tensor) -> torch.Tensor:
    """Teacher-forced decoder layer. x: (B, S, d); xk/xv: (B, F, H, D)."""
    H, KH, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q, k, v = _qkv(_ln(x, lp["ln1"]), lp["attn"], H, KH, D)
    x = _out(x, _causal_attention(cfg, q, k, v, causal=True), lp["attn"])
    qx = _qkv(_ln(x, lp["ln_x"]), lp["xattn"], H, H, D)[0]
    x = _out(x, _causal_attention(cfg, qx, xk, xv, causal=False),
             lp["xattn"])
    return _mlp(x, lp)


def forward_teacher_forced(cfg: ModelConfig, params: ParamTree,
                           frames: torch.Tensor, tokens: torch.Tensor, *,
                           remat: bool = True) -> torch.Tensor:
    """Encode ``frames`` (B, F, d) and run the decoder over ``tokens``
    (B, S), each decoder layer rematerialized when ``remat`` (its cross
    K/V computed outside). Returns the final-normed hidden (B, S, d)."""
    enc_out = encode(cfg, params, frames)
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    x = _embed_at(cfg, params, tokens, positions)
    body = L.remat(_dec_layer_full, "nothing" if remat else "none")
    for i in range(cfg.num_layers):
        lp = P_.select(params["dec_layers"], i)
        xk, xv = _cross_kv(cfg, lp, enc_out)
        x = body(cfg, lp, x, positions, xk, xv)
    return _ln(x, params["final_norm"])


def train_loss(cfg: ModelConfig, params: ParamTree, batch, *,
               remat: bool = True):
    """batch: the dense family's, with "frontend_embeds" (B, F, d) stub
    frames, cast to the weights' dtype. Returns (loss, {"ce_loss",
    "moe_aux": 0})."""
    W = params["embed"]["embed"]
    hidden = forward_teacher_forced(
        cfg, params, batch["frontend_embeds"].to(W.dtype), batch["tokens"],
        remat=remat)
    loss = lm_loss(cfg, params, hidden, batch["targets"], batch["mask"])
    return loss, {"ce_loss": loss,
                  "moe_aux": hidden.new_zeros((), dtype=torch.float32)}


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
    x = _embed_at(cfg, params, tokens,
                  start_pos + torch.arange(S, device=tokens.device))
    meshed = tp.is_meshed(x)
    for i in range(cfg.num_layers):
        lp = P_.select(params["dec_layers"], i)
        xk, xv = _cross_kv(cfg, lp, enc_out)
        q, k, v = _qkv(_ln(x, lp["ln1"]), lp["attn"], H, KH, D)
        (tp.write_prefix_meshed if meshed else write_prefix)(
            cache["self_k"][i], cache["self_v"][i], k, v)
        x = _out(x, _causal_attention(cfg, q, k, v, causal=True),
                 lp["attn"])
        qx = _qkv(_ln(x, lp["ln_x"]), lp["xattn"], H, H, D)[0]
        x = _out(x, _causal_attention(cfg, qx, xk, xv, causal=False),
                 lp["xattn"])
        x = _mlp(x, lp)
        for name, t in (("cross_k", xk), ("cross_v", xv)):
            if meshed:        # re-placed as the cross cache: by position
                dst = cache[name][i]
                dst.to_local().copy_(tp.redistribute(
                    t, dst.placements).to_local())
            else:
                cache[name][i] = t
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
    x = _embed_at(cfg, params, tokens,
                  lengths if positions is None else positions)
    use_store = store is not None and cfg.moska.enabled
    meshed = tp.is_meshed(x)
    full = torch.full((B,), cfg.encoder.frontend_seq, dtype=torch.int32,
                      device=x.device)
    for i in range(cfg.num_layers):
        lp = P_.select(params["dec_layers"], i)
        q, k, v = (t[:, 0] for t in _qkv(_ln(x, lp["ln1"])[:, None],
                                          lp["attn"], H, KH, D))
        kc, vc = cache["self_k"][i], cache["self_v"][i]
        if meshed:
            o = disagg.meshed_decode_attention(q, k, v, kc, vc, lengths,
                                               None, cfg.moska)
        else:
            append_token(kc, vc, k, v, lengths)
            o = L.decode_attention(q, kc, vc, lengths + 1)
        x = _out(x, o, lp["attn"])
        qx = _qkv(_ln(x, lp["ln_x"])[:, None], lp["xattn"], H, H, D)[0][:, 0]
        if meshed:
            sh = _shared_layer(store, i) if use_store else None
            ck, cv = (None, None) if use_store else (cache["cross_k"][i],
                                                     cache["cross_v"][i])
            ox = disagg.meshed_decode_attention(qx, None, None, ck, cv, None,
                                                sh, cfg.moska)
        elif use_store:
            routing = router_lib.route(qx, store.emb[i],
                                       cfg.moska.top_k_chunks)
            ox = sa.shared_attention_batched(
                qx[:, None], store.k[i], store.v[i], routing, layer_idx=i,
                rec=rec).out[:, 0]
        else:
            ox = L.decode_attention(qx, cache["cross_k"][i],
                                    cache["cross_v"][i], full)
        x = _out(x, ox, lp["xattn"])
        x = _mlp(x, lp)
    lengths.add_(1)
    return _logits(params, x), cache
