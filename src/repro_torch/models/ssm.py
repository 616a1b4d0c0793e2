"""Mamba-2 (SSD — state-space duality) blocks [arXiv:2405.21060].

Port of the reference ``models/ssm.py``. Attention-free: MoSKA's shared
KV does not apply, and no kernel of the port runs here. The analogue is
``shared_state``: the SSM state after a shared prefix, installed as the
prefill's initial state (``prefill(store={"state": ...})``); it
summarizes the corpus rather than indexing it, so there is no routed
path.

The chunked SSD algorithm (block decomposition of the semiseparable
matrix): an intra-chunk quadratic part and an inter-chunk state
recurrence, carried across chunks by a Python loop (the reference's
``lax.scan``); a single-step recurrence for decode. Weights are
layer-stacked (``params["layers"]`` leaves are ``(L, ...)``) and the
layers run as a Python loop.

Cache: {"conv": (L, B, W-1, conv_dim), "state": (L, B, NH, P, N) fp32,
"length": (B,) int32}, written in place by ``prefill`` and
``decode_step``, which return the cache they were given.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.dense import torch_dtype
from repro_torch.models import params as P_
from repro_torch.models.params import ParamTree

Cache = Dict[str, torch.Tensor]
NEG_INF = -1e30


def _dims(cfg: ModelConfig) -> Tuple[int, int, int, int, int]:
    d_inner = cfg.d_model * cfg.ssm.expand
    P = cfg.ssm.head_dim
    NH = d_inner // P
    N = cfg.ssm.state_dim
    conv_dim = d_inner + 2 * N          # conv over [x, B, C]
    return d_inner, P, NH, N, conv_dim


def param_spec(cfg: ModelConfig) -> P_.Spec:
    d = cfg.d_model
    di, _, NH, N, conv_dim = _dims(cfg)
    dt, f32 = torch_dtype(cfg.dtype), torch.float32
    layer = {
        "ln1": {"scale": ((d,), dt)},
        "in_proj": ((d, 2 * di + 2 * N + NH), dt),     # z, x, B, C, dt
        "conv_w": ((cfg.ssm.conv_width, conv_dim), dt),
        "conv_b": ((conv_dim,), dt),
        "a_log": ((NH,), f32),
        "d_skip": ((NH,), f32),
        "dt_bias": ((NH,), f32),
        "gate_norm": {"scale": ((di,), dt)},
        "out_proj": ((di, d), dt),
    }
    return {"embed": {"embed": ((cfg.vocab_size, d), dt)},
            "layers": P_.stacked(layer, cfg.num_layers),
            "final_norm": {"scale": ((d,), dt)}}


def _a_log(p: torch.Tensor, g: torch.Generator) -> None:
    NH = p.shape[-1]
    p.copy_(torch.log(torch.linspace(1.0, 16.0, NH, device=p.device))
            .expand(p.shape))


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device=None) -> ParamTree:
    """Random weights with the reference's distributions. ``generator``
    must live on ``device``."""
    di = _dims(cfg)[0]
    return P_.fill(ParamTree(param_spec(cfg), device), generator, {
        "embed": P_.fan_in(cfg.d_model), "in_proj": P_.fan_in(cfg.d_model),
        "conv_w": P_.normal(0.1), "conv_b": P_.const(0.0),
        "a_log": _a_log, "d_skip": P_.const(1.0),
        "dt_bias": P_.const(math.log(math.e - 1)),
        "scale": P_.const(0.0), "out_proj": P_.fan_in(di)})


# ---------------------------------------------------------------------------
# SSD core
# ---------------------------------------------------------------------------

def _ssd_chunked(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                 Bm: torch.Tensor, Cm: torch.Tensor, h0: torch.Tensor,
                 chunk: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan, fp32.

    x: (B, S, NH, P); dt: (B, S, NH) (post-softplus); A: (NH,) negative;
    Bm/Cm: (B, S, N); h0: (B, NH, P, N). Returns (y (B, S, NH, P),
    h_final). S is padded to a multiple of ``chunk`` with dt = 0 steps:
    a = exp(0) = 1 leaves the state as it is, and they contribute 0.
    """
    S = x.shape[1]
    pad = -S % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt, Bm, Cm = (F.pad(t, (0, 0, 0, pad)) for t in (dt, Bm, Cm))
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=x.device))
    h, ys = h0, []
    for c0 in range(0, S + pad, chunk):
        xq, dtq, Bq, Cq = (t[:, c0:c0 + chunk] for t in (x, dt, Bm, Cm))
        s_cum = torch.cumsum(dtq * A, dim=1)               # (B, Q, NH) <= 0
        # inter-chunk: y_t += C_t . exp(s_t) h_prev
        y_inter = (torch.einsum("bqn,bhpn->bqhp", Cq, h)
                   * torch.exp(s_cum)[..., None])
        # intra-chunk: y_t += sum_{s<=t} exp(s_t - s_s) dt_s (C_t.B_s) x_s,
        # masked BEFORE the exp: entries above the diagonal have a
        # positive exponent and would overflow
        diff = s_cum[:, :, None, :] - s_cum[:, None, :, :]  # (B, Q, Q, NH)
        Lmat = torch.exp(torch.where(tri[None, :, :, None], diff,
                                     torch.full_like(diff, NEG_INF)))
        cb = torch.einsum("bqn,bsn->bqs", Cq, Bq)
        att = cb[..., None] * Lmat * dtq[:, None, :, :]    # (B, Q, Q, NH)
        y_intra = torch.einsum("bqsh,bshp->bqhp", att, xq)
        # state: h = exp(s_Q) h + sum_s exp(s_Q - s_s) dt_s B_s x_s
        w = dtq * torch.exp(s_cum[:, -1:, :] - s_cum)     # (B, Q, NH)
        dh = torch.einsum("bqhp,bqn->bhpn", xq * w[..., None], Bq)
        h = h * torch.exp(s_cum[:, -1])[..., None, None] + dh
        ys.append(y_inter + y_intra)
    return torch.cat(ys, dim=1)[:, :S], h


def _ssd_step(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
              Bm: torch.Tensor, Cm: torch.Tensor, h: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-token recurrence. x: (B, NH, P); dt: (B, NH); Bm/Cm: (B, N)."""
    a = torch.exp(dt * A[None, :])                         # (B, NH)
    dh = torch.einsum("bh,bn,bhp->bhpn", dt, Bm, x)
    h_new = h * a[..., None, None] + dh
    return torch.einsum("bn,bhpn->bhp", Cm, h_new), h_new


# ---------------------------------------------------------------------------
# block forward
# ---------------------------------------------------------------------------

def _split_proj(cfg: ModelConfig, proj: torch.Tensor):
    di, _, NH, N, _ = _dims(cfg)
    return proj.split([di, di + 2 * N, NH], dim=-1)       # z, xbc, dt


def _conv_step(x_t: torch.Tensor, conv_state: torch.Tensor,
               w: torch.Tensor, b: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x_t: (B, C); conv_state: (B, W-1, C) past inputs."""
    full = torch.cat([conv_state, x_t[:, None]], dim=1)   # (B, W, C)
    out = torch.einsum("bwc,wc->bc", full, w) + b[None]
    return F.silu(out), full[:, 1:]


def _ssd_inputs(cfg: ModelConfig, lp, xbc: torch.Tensor, dt: torch.Tensor):
    """Post-conv [x, B, C] and the raw dt -> the SSD's fp32 inputs (x as
    heads, dt after softplus, A, B, C)."""
    di, P, NH, N, _ = _dims(cfg)
    xs, Bm, Cm = xbc.split([di, N, N], dim=-1)
    dt = F.softplus(dt.float() + lp["dt_bias"])
    A = -torch.exp(lp["a_log"])
    xh = xs.reshape(*xs.shape[:-1], NH, P).float()
    return xh, dt, A, Bm.float(), Cm.float()


def _gated_out(cfg: ModelConfig, lp, y: torch.Tensor, xh: torch.Tensor,
               z: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    y = y + xh * lp["d_skip"][:, None]
    y = y.reshape(*y.shape[:-2], -1).to(dtype)
    y = L.rms_norm(y * F.silu(z), lp["gate_norm"]["scale"], cfg.rms_eps)
    return y @ lp["out_proj"]


def _block_full(cfg: ModelConfig, lp, x: torch.Tensor, h0: torch.Tensor):
    """x: (B, S, d). Returns (out, h_final, the pre-conv [x, B, C] rows)."""
    h = L.rms_norm(x, lp["ln1"]["scale"], cfg.rms_eps)
    z, xbc_in, dt = _split_proj(cfg, h @ lp["in_proj"])
    xbc = F.silu(L.causal_conv(xbc_in, lp["conv_w"], lp["conv_b"]))
    xh, dt, A, Bm, Cm = _ssd_inputs(cfg, lp, xbc, dt)
    y, h_fin = _ssd_chunked(xh, dt, A, Bm, Cm, h0, cfg.ssm.chunk_size)
    return _gated_out(cfg, lp, y, xh, z, x.dtype), h_fin, xbc_in


def _block_step(cfg: ModelConfig, lp, x: torch.Tensor,
                conv_state: torch.Tensor, h: torch.Tensor):
    """x: (B, d) one token. Returns (out, new_conv_state, new_h)."""
    hn = L.rms_norm(x, lp["ln1"]["scale"], cfg.rms_eps)
    z, xbc, dt = _split_proj(cfg, hn @ lp["in_proj"])
    xbc, conv_state = _conv_step(xbc, conv_state, lp["conv_w"], lp["conv_b"])
    xh, dt, A, Bm, Cm = _ssd_inputs(cfg, lp, xbc, dt)
    y, h = _ssd_step(xh, dt, A, Bm, Cm, h)
    return _gated_out(cfg, lp, y, xh, z, x.dtype), conv_state, h


# ---------------------------------------------------------------------------
# model-level API
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               dtype=torch.bfloat16, device=None) -> Cache:
    """``max_seq`` is taken for the API's sake: the state is O(1) in
    context length."""
    _, P, NH, N, conv_dim = _dims(cfg)
    Lr, W = cfg.num_layers, cfg.ssm.conv_width
    return {
        "conv": torch.zeros((Lr, batch, W - 1, conv_dim), dtype=dtype,
                            device=device),
        "state": torch.zeros((Lr, batch, NH, P, N), dtype=torch.float32,
                             device=device),
        "length": torch.zeros((batch,), dtype=torch.int32, device=device),
    }


def _logits(cfg: ModelConfig, params: ParamTree,
            x: torch.Tensor) -> torch.Tensor:
    """fp32 logits of the final-normed hidden state over the tied
    embedding."""
    return L.unembed(L.rms_norm(x, params["final_norm"]["scale"],
                                cfg.rms_eps), params["embed"]["embed"])


@torch.no_grad()
def prefill(cfg: ModelConfig, params: ParamTree, tokens: torch.Tensor,
            cache: Cache, store: Optional[Cache] = None,
            start_pos: int = 0) -> Tuple[torch.Tensor, Cache]:
    """Run the prompt, leaving each layer's final state and conv tail in
    ``cache`` for decode.

    ``store`` may be a shared warm-start state {"state": (L, B, NH, P,
    N)}, the SSM analogue of a shared corpus (``shared_state``, tiled to
    the batch by the caller). Each layer's conv tail is its last W - 1
    pre-conv inputs, left-padded with zeros below W - 1 tokens (the
    zeros the prefill's own conv pads with).
    """
    x = params["embed"]["embed"][tokens]
    B, S, _ = x.shape
    if store is not None and store["state"].shape[1] != B:
        raise ValueError(
            f"shared state of batch {store['state'].shape[1]} for a prefill "
            f"of batch {B}: tile it to the batch")
    W = cfg.ssm.conv_width
    h0 = torch.zeros(cache["state"].shape[1:], dtype=torch.float32,
                     device=x.device)
    for i in range(cfg.num_layers):
        lp = P_.select(params["layers"], i)
        y, h_fin, xbc = _block_full(
            cfg, lp, x, h0 if store is None else store["state"][i])
        tail = xbc[:, -(W - 1):]
        cache["conv"][i] = F.pad(tail, (0, 0, W - 1 - tail.shape[1], 0))
        cache["state"][i] = h_fin
        x = x + y
    cache["length"].fill_(start_pos + S)
    return _logits(cfg, params, x[:, -1]), cache


@torch.no_grad()
def decode_step(cfg: ModelConfig, params: ParamTree, tokens: torch.Tensor,
                cache: Cache) -> Tuple[torch.Tensor, Cache]:
    """One token per request. tokens: (B,). Returns (logits (B, V) fp32,
    cache) with the states and lengths advanced in place."""
    x = params["embed"]["embed"][tokens]
    for i in range(cfg.num_layers):
        y, conv_s, h = _block_step(cfg, P_.select(params["layers"], i), x,
                                   cache["conv"][i], cache["state"][i])
        cache["conv"][i] = conv_s
        cache["state"][i] = h
        x = x + y
    cache["length"].add_(1)
    return _logits(cfg, params, x), cache


@torch.no_grad()
def shared_state(cfg: ModelConfig, params: ParamTree,
                 corpus_tokens: torch.Tensor) -> Cache:
    """The shared-prefix warm-start state (the MoSKA analogue), of the
    corpus call's batch: the caller tiles it to a prefill's batch."""
    B, S = corpus_tokens.shape
    cache = init_cache(cfg, B, S, params["embed"]["embed"].dtype,
                       corpus_tokens.device)
    prefill(cfg, params, corpus_tokens, cache)
    return {"state": cache["state"]}
