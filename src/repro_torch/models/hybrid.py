"""RecurrentGemma / Griffin hybrid: RG-LRU recurrent blocks and local
(MQA, sliding-window) attention in a 2:1 pattern [arXiv:2402.19427].

Port of the reference ``models/hybrid.py``. The decode state is O(1) in
context length: a ring buffer of the last ``window`` keys and values per
attention layer, and an LRU state and conv tail per recurrent layer.
MoSKA is off in the config, and no kernel of the port runs here: the
ring's attention (KH = 1, D = 256) is plain PyTorch, as the reference's
is jnp code.

Weights keep the reference's superblock layout: ``params["super"]["rec"]``
and ``["attn"]`` stack each pattern cycle's recurrent and attention
layers, leaves ``(n_superblocks, per_cycle, ...)``, and ``params["tail"]``
holds the layers past the last whole cycle (recurrentgemma-9b: 12 cycles
of (rglru, rglru, attn) and a tail of (rglru, rglru)). The layers run as
a Python loop in layer order.

Cache: {"ring_k"/"ring_v": (n_attn, B, W, KH, D), "ring_pos": (n_attn,
B, W) int32 absolute positions (-1: empty slot), "lru": (n_rec, B, lw)
fp32, "conv": (n_rec, B, 3, lw), "length": (B,) int32}, written in place
by ``prefill`` and ``decode_step``, which return the cache they were
given.
"""
from __future__ import annotations

import math
from typing import Dict, Iterator, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import params as P_
from repro_torch.models.dense import lm_loss, torch_dtype
from repro_torch.models.params import ParamTree

Cache = Dict[str, torch.Tensor]
_LRU_C = 8.0
_CONV_W = 4             # the recurrent branch's conv taps


def _lru_width(cfg: ModelConfig) -> int:
    return cfg.hybrid.lru_width or cfg.d_model


def _layout(cfg: ModelConfig):
    """(n_superblocks, tail kinds): layers = nsb whole cycles + tail."""
    cyc = cfg.hybrid.pattern
    return cfg.num_layers // len(cyc), cyc[: cfg.num_layers % len(cyc)]


def _rec_spec(cfg: ModelConfig) -> P_.Spec:
    d, lw, dt = cfg.d_model, _lru_width(cfg), torch_dtype(cfg.dtype)
    return {"ln1": {"scale": ((d,), dt)}, "ln2": {"scale": ((d,), dt)},
            "lru_in": ((d, 2 * lw), dt),
            "conv_w": ((_CONV_W, lw), dt), "conv_b": ((lw,), dt),
            "lru_gate_w": ((lw, 2 * lw), dt), "lru_gate_b": ((2 * lw,), dt),
            "lru_a": ((lw,), torch.float32),
            "lru_out": ((lw, d), dt),
            "mlp": P_.mlp_spec(d, cfg.d_ff, dt)}


def _attn_spec(cfg: ModelConfig) -> P_.Spec:
    d, dt = cfg.d_model, torch_dtype(cfg.dtype)
    return {"ln1": {"scale": ((d,), dt)}, "ln2": {"scale": ((d,), dt)},
            "attn": P_.attn_spec(d, cfg.num_heads, cfg.num_kv_heads,
                                 cfg.head_dim, cfg.qkv_bias, dt),
            "mlp": P_.mlp_spec(d, cfg.d_ff, dt)}


def param_spec(cfg: ModelConfig) -> P_.Spec:
    nsb, tail = _layout(cfg)
    cyc = cfg.hybrid.pattern
    n_attn = sum(k == "attn" for k in cyc)
    stack = {"rec": _rec_spec(cfg), "attn": _attn_spec(cfg)}
    per = {"rec": len(cyc) - n_attn, "attn": n_attn}
    dt = torch_dtype(cfg.dtype)
    return {
        "embed": {"embed": ((cfg.vocab_size, cfg.d_model), dt)},
        "super": {kind: P_.stacked(spec, nsb, per[kind]) if per[kind] else {}
                  for kind, spec in stack.items()},
        "tail": [_attn_spec(cfg) if k == "attn" else _rec_spec(cfg)
                 for k in tail],
        "final_norm": {"scale": ((cfg.d_model,), dt)},
    }


def _lru_a(p: torch.Tensor, g: torch.Generator) -> None:
    """Lambda such that a^c spans (0.9, 0.999), as in Griffin."""
    a = torch.linspace(0.9, 0.999, p.shape[-1], device=p.device)
    p.copy_(torch.log(torch.expm1(-torch.log(a) / _LRU_C)).expand(p.shape))


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device=None) -> ParamTree:
    """Random weights with the reference's distributions. ``generator``
    must live on ``device``."""
    d, lw = cfg.d_model, _lru_width(cfg)
    zero = P_.const(0.0)
    return P_.fill(ParamTree(param_spec(cfg), device), generator, {
        "embed": P_.fan_in(d), "scale": zero,
        "lru_in": P_.fan_in(d), "conv_w": P_.normal(0.1), "conv_b": zero,
        "lru_gate_w": P_.fan_in(lw), "lru_gate_b": zero, "lru_a": _lru_a,
        "lru_out": P_.fan_in(lw),
        **dict.fromkeys(("wq", "wk", "wv", "wo", "w_gate", "w_up"),
                        P_.fan_in(d)),
        **dict.fromkeys(("bq", "bk", "bv"), zero),
        "w_down": P_.fan_in(cfg.d_ff)})


def _layers(cfg: ModelConfig, params: ParamTree
            ) -> Iterator[Tuple[str, dict, int]]:
    """(kind, layer parameters, index among the layers of its kind) in
    layer order: the caches stack attention and recurrent layers apart,
    each in layer order."""
    nsb, tail = _layout(cfg)
    n = {"attn": 0, "rec": 0}
    for s in range(nsb):
        within = {"attn": 0, "rec": 0}
        for kind in cfg.hybrid.pattern:
            kind = "attn" if kind == "attn" else "rec"
            yield kind, P_.select(params["super"][kind], (s, within[kind])), \
                n[kind]
            within[kind] += 1
            n[kind] += 1
    for lp, kind in zip(params["tail"], tail):
        kind = "attn" if kind == "attn" else "rec"
        yield kind, lp, n[kind]
        n[kind] += 1


# ---------------------------------------------------------------------------
# RG-LRU
# ---------------------------------------------------------------------------

def _rglru_gates(x: torch.Tensor, lp):
    """x: (..., lw) post-conv branch input -> (log_a, gated input), fp32."""
    gates = x @ lp["lru_gate_w"] + lp["lru_gate_b"]
    r, i = torch.sigmoid(gates.float()).chunk(2, dim=-1)
    log_a = -_LRU_C * F.softplus(lp["lru_a"]) * r           # (..., lw) <= 0
    a2 = torch.exp(2.0 * log_a)
    gated = torch.sqrt(torch.clamp_min(1.0 - a2, 1e-12)) * (i * x.float())
    return log_a, gated


def _rglru_full(x: torch.Tensor, lp, h0: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """h_t = a_t h_{t-1} + b_t over the sequence. x: (B, S, lw); h0:
    (B, lw). Returns (h in x's dtype, h_S fp32).

    The reference runs ``lax.associative_scan``; here a log-depth
    doubling scan (Hillis-Steele) of the same combine, (a1, b1) . (a2, b2)
    = (a1 a2, a2 b1 + b2): ceil(log2 S) rounds of elementwise work over
    the whole (B, S, lw) tensor, where a loop over S would launch S rounds
    of tiny ones (2,040 for a long recurrentgemma prompt, in each of its 26
    recurrent layers). Both are exact in exact arithmetic; in fp32 they
    round in another order, within 1e-6 of each other.
    """
    log_a, b = _rglru_gates(x, lp)
    a = torch.exp(log_a)
    b = b.clone()
    b[:, 0] += a[:, 0] * h0                  # h_1 = a_1 h0 + b_1
    S, k = x.shape[1], 1
    while k < S:
        b = torch.cat([b[:, :k], a[:, k:] * b[:, :-k] + b[:, k:]], dim=1)
        a = torch.cat([a[:, :k], a[:, k:] * a[:, :-k]], dim=1)
        k *= 2
    return b.to(x.dtype), b[:, -1]


def _rglru_step(x: torch.Tensor, lp, h: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, lw); h: (B, lw)."""
    log_a, b = _rglru_gates(x, lp)
    h_new = torch.exp(log_a) * h + b
    return h_new.to(x.dtype), h_new


def _rec_block_full(cfg: ModelConfig, lp, x: torch.Tensor,
                    h0: torch.Tensor):
    """x: (B, S, d) -> (out, (conv_tail, h_final))."""
    h = L.rms_norm(x, lp["ln1"]["scale"], cfg.rms_eps)
    xa, xb = (h @ lp["lru_in"]).chunk(2, dim=-1)
    y, h_fin = _rglru_full(L.causal_conv(xa, lp["conv_w"], lp["conv_b"]), lp,
                           h0)
    x = x + (y * L.gelu(xb)) @ lp["lru_out"]
    h2 = L.rms_norm(x, lp["ln2"]["scale"], cfg.rms_eps)
    x = x + L.geglu_mlp(h2, lp["mlp"])
    return x, (xa[:, -(_CONV_W - 1):], h_fin)


def _rec_block_step(cfg: ModelConfig, lp, x: torch.Tensor,
                    conv_state: torch.Tensor, h: torch.Tensor):
    """x: (B, d). Returns (out, new_conv_state, new_h)."""
    hn = L.rms_norm(x, lp["ln1"]["scale"], cfg.rms_eps)
    xa, xb = (hn @ lp["lru_in"]).chunk(2, dim=-1)
    full = torch.cat([conv_state, xa[:, None].to(conv_state.dtype)], dim=1)
    xa_conv = (torch.einsum("bwl,wl->bl", full, lp["conv_w"])
               + lp["conv_b"]).to(xa.dtype)
    y, h = _rglru_step(xa_conv, lp, h)
    x = x + (y * L.gelu(xb)) @ lp["lru_out"]
    h2 = L.rms_norm(x, lp["ln2"]["scale"], cfg.rms_eps)
    x = x + L.geglu_mlp(h2, lp["mlp"])
    return x, full[:, 1:], h


# ---------------------------------------------------------------------------
# local attention with a ring-buffer window cache
# ---------------------------------------------------------------------------

def _attn_out_mlp(cfg: ModelConfig, lp, x: torch.Tensor,
                  o: torch.Tensor) -> torch.Tensor:
    x = x + o.reshape(*o.shape[:-2], -1) @ lp["attn"]["wo"]
    h2 = L.rms_norm(x, lp["ln2"]["scale"], cfg.rms_eps)
    return x + L.geglu_mlp(h2, lp["mlp"])


def _attn_block_full(cfg: ModelConfig, lp, x: torch.Tensor,
                     positions: torch.Tensor):
    h = L.rms_norm(x, lp["ln1"]["scale"], cfg.rms_eps)
    q, k, v = L.qkv_project(h, lp["attn"], cfg.num_heads, cfg.num_kv_heads,
                            cfg.head_dim)
    q = L.apply_rope(q, positions, cfg.rope_theta)
    k = L.apply_rope(k, positions, cfg.rope_theta)
    W = cfg.hybrid.window
    o = L.flash_attention(q, k, v, causal=True, window=W,
                          block_k=min(L.DEFAULT_BLOCK_K, W))
    return _attn_out_mlp(cfg, lp, x, o), (k, v)


def _ring_write(rk: torch.Tensor, rv: torch.Tensor, rpos: torch.Tensor,
                k: torch.Tensor, v: torch.Tensor,
                positions: torch.Tensor) -> None:
    """Write (B, S, KH, D) keys and values at slots ``positions % W`` of
    the (B, W, ...) ring, in place; positions: (B, S) absolute, S <= W."""
    slots = positions.long() % rk.shape[1]
    rows = torch.arange(rk.shape[0], device=rk.device)[:, None]
    rk[rows, slots] = k.to(rk.dtype)
    rv[rows, slots] = v.to(rv.dtype)
    rpos[rows, slots] = positions.to(rpos.dtype)


def _ring_attend(q: torch.Tensor, rk: torch.Tensor, rv: torch.Tensor,
                 rpos: torch.Tensor, q_pos: torch.Tensor,
                 window: int) -> torch.Tensor:
    """q: (B, H, D); ring (B, W, KH, D); rpos: (B, W) absolute positions
    (-1: empty); q_pos: (B,). Windowed GQA attention over the ring, fp32
    scores, p cast to v's dtype before PV, as the reference. Returns
    (B, H, D)."""
    B, H, D = q.shape
    KH = rk.shape[2]
    qg = q.reshape(B, KH, H // KH, D)
    s = torch.einsum("bhgd,bwhd->bhgw", qg.float(), rk.float()) / math.sqrt(D)
    qp = q_pos[:, None]
    valid = (rpos >= 0) & (rpos <= qp) & (rpos > qp - window)
    s = torch.where(valid[:, None, None], s, torch.full_like(s, L.NEG_INF))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1)
    o = torch.einsum("bhgw,bwhd->bhgd", p.to(rv.dtype).float(), rv.float())
    return (o / l.clamp_min(1e-37)[..., None]).reshape(B, H, D).to(q.dtype)


def _attn_block_step(cfg: ModelConfig, lp, x: torch.Tensor,
                     rk: torch.Tensor, rv: torch.Tensor, rpos: torch.Tensor,
                     q_pos: torch.Tensor) -> torch.Tensor:
    """x: (B, d); q_pos: (B,) absolute position of the new token, whose
    key and value are written into the ring (in place) before attending."""
    h = L.rms_norm(x, lp["ln1"]["scale"], cfg.rms_eps)
    q, k, v = L.qkv_project(h[:, None], lp["attn"], cfg.num_heads,
                            cfg.num_kv_heads, cfg.head_dim)
    pos = q_pos[:, None]
    q = L.apply_rope(q, pos, cfg.rope_theta)[:, 0]
    k = L.apply_rope(k, pos, cfg.rope_theta)
    _ring_write(rk, rv, rpos, k, v, pos)
    o = _ring_attend(q, rk, rv, rpos, q_pos, cfg.hybrid.window)
    return _attn_out_mlp(cfg, lp, x, o)


# ---------------------------------------------------------------------------
# model-level API
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               dtype=torch.bfloat16, device=None) -> Cache:
    """``max_seq`` is taken for the API's sake: the state is O(window)."""
    nsb, tail = _layout(cfg)
    kinds = list(cfg.hybrid.pattern) * nsb + list(tail)
    n_attn = kinds.count("attn")
    n_rec = len(kinds) - n_attn
    W, KH, D, lw = (cfg.hybrid.window, cfg.num_kv_heads, cfg.head_dim,
                    _lru_width(cfg))

    def zeros(shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=device)

    return {
        "ring_k": zeros((n_attn, batch, W, KH, D)),
        "ring_v": zeros((n_attn, batch, W, KH, D)),
        "ring_pos": torch.full((n_attn, batch, W), -1, dtype=torch.int32,
                               device=device),
        "lru": zeros((n_rec, batch, lw), torch.float32),
        "conv": zeros((n_rec, batch, _CONV_W - 1, lw)),
        "length": zeros((batch,), torch.int32),
    }


def _logits(cfg: ModelConfig, params: ParamTree,
            x: torch.Tensor) -> torch.Tensor:
    return L.unembed(L.rms_norm(x, params["final_norm"]["scale"],
                                cfg.rms_eps), params["embed"]["embed"])


def _run_layers(cfg: ModelConfig, layers, x: torch.Tensor,
                positions: torch.Tensor, h0: torch.Tensor) -> torch.Tensor:
    """Full-sequence blocks over ``layers`` ((kind, parameters) pairs)
    from zero states."""
    for kind, lp in layers:
        if kind == "attn":
            x = _attn_block_full(cfg, lp, x, positions)[0]
        else:
            x = _rec_block_full(cfg, lp, x, h0)[0]
    return x


def forward_hidden(cfg: ModelConfig, params: ParamTree, x: torch.Tensor,
                   positions: torch.Tensor, *, remat: bool = True
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run the layers from zero states (the training path): each super
    block (one pattern cycle) rematerialized when ``remat``, then the tail
    layers as they are, as the reference's layout. Returns (final-normed
    hidden, 0: no aux loss)."""
    h0 = torch.zeros((x.shape[0], _lru_width(cfg)), dtype=torch.float32,
                     device=x.device)
    layers = [(kind, lp) for kind, lp, _ in _layers(cfg, params)]
    per = len(cfg.hybrid.pattern)
    nsb = _layout(cfg)[0]
    body = L.remat(_run_layers, "nothing" if remat else "none")
    for s in range(nsb):
        x = body(cfg, layers[s * per:(s + 1) * per], x, positions, h0)
    x = _run_layers(cfg, layers[nsb * per:], x, positions, h0)
    x = L.rms_norm(x, params["final_norm"]["scale"], cfg.rms_eps)
    return x, x.new_zeros((), dtype=torch.float32)


def train_loss(cfg: ModelConfig, params: ParamTree, batch, *,
               remat: bool = True):
    """Next-token cross-entropy over the tied embedding; batch as the
    dense family's. Returns (loss, {"ce_loss", "moe_aux": 0})."""
    tokens = batch["tokens"]
    x = params["embed"]["embed"][tokens]
    positions = torch.arange(tokens.shape[1], device=x.device)
    hidden, zero = forward_hidden(cfg, params, x, positions, remat=remat)
    loss = lm_loss(cfg, params, hidden, batch["targets"], batch["mask"])
    return loss, {"ce_loss": loss, "moe_aux": zero}


@torch.no_grad()
def prefill(cfg: ModelConfig, params: ParamTree, tokens: torch.Tensor,
            cache: Cache, start_pos: int = 0) -> Tuple[torch.Tensor, Cache]:
    """Run the prompt with windowed causal attention; each attention layer
    writes its last min(W, S) keys into its ring, each recurrent layer
    its LRU state and conv tail (left-padded with zeros below 3 tokens)."""
    x = params["embed"]["embed"][tokens]
    B, S, _ = x.shape
    positions = start_pos + torch.arange(S, device=x.device)
    n = min(cfg.hybrid.window, S)
    tail_pos = positions[-n:].expand(B, n)
    h0 = torch.zeros((B, _lru_width(cfg)), dtype=torch.float32,
                     device=x.device)
    for kind, lp, j in _layers(cfg, params):
        if kind == "attn":
            x, (k, v) = _attn_block_full(cfg, lp, x, positions)
            _ring_write(cache["ring_k"][j], cache["ring_v"][j],
                        cache["ring_pos"][j], k[:, -n:], v[:, -n:], tail_pos)
        else:
            x, (ct, h) = _rec_block_full(cfg, lp, x, h0)
            cache["conv"][j] = F.pad(ct, (0, 0, _CONV_W - 1 - ct.shape[1], 0))
            cache["lru"][j] = h
    cache["length"].fill_(start_pos + S)
    return _logits(cfg, params, x[:, -1]), cache


@torch.no_grad()
def decode_step(cfg: ModelConfig, params: ParamTree, tokens: torch.Tensor,
                cache: Cache, positions: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Cache]:
    """One token per request. tokens: (B,); positions: (B,) absolute
    (default: the cache lengths). Returns (logits (B, V) fp32, cache) with
    rings, states and lengths advanced in place."""
    x = params["embed"]["embed"][tokens]
    q_pos = cache["length"] if positions is None else positions
    for kind, lp, j in _layers(cfg, params):
        if kind == "attn":
            x = _attn_block_step(cfg, lp, x, cache["ring_k"][j],
                                 cache["ring_v"][j], cache["ring_pos"][j],
                                 q_pos)
        else:
            x, conv_s, h = _rec_block_step(cfg, lp, x, cache["conv"][j],
                                           cache["lru"][j])
            cache["conv"][j] = conv_s
            cache["lru"][j] = h
    cache["length"].add_(1)
    return _logits(cfg, params, x), cache
