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

Under a mesh (``sharding/tensor_parallel.py``) the same entry points run
tensor parallel over ``model``: the attention layers and every MLP
through the dense family's meshed helpers (heads and FFN columns split,
MQA's single kv head read whole by each rank's query heads), the RG-LRU
branch on local tensors (``_rec_branch_meshed``): each rank convolves and
scans its own channels of the LRU width (the rules' split), the
concatenated ``lru_in`` (xa | xb) and gate (r | i) products are gathered
whole before each rank takes its channels of each part, and
``lru_out``'s rows reduce over ``model``. The ring's slots are split over
``model`` (``ring_pos`` whole): a token is written on the rank that owns
its slot, and each rank's partial attention over its slots joins the
others' by the exact LSE all-reduce of ``core/disagg.py``.
"""
from __future__ import annotations

import math
from typing import Dict, Iterator, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core.disagg import lse_combine
from repro_torch.models import layers as L
from repro_torch.models import params as P_
from repro_torch.models.dense import (_act, _causal_attention, _embed,
                                      _merge_heads, _qkv_rope, lm_loss,
                                      torch_dtype)
from repro_torch.models.params import ParamTree
from repro_torch.sharding import tensor_parallel as tp
from repro_torch.sharding.specs import lsc

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
        yield kind, P_.select(lp), n[kind]
        n[kind] += 1


# ---------------------------------------------------------------------------
# RG-LRU
# ---------------------------------------------------------------------------

def _rglru_gates(x: torch.Tensor, lp):
    """x: (..., lw) post-conv branch input -> (log_a, gated input), fp32."""
    gates = x @ lp["lru_gate_w"] + lp["lru_gate_b"]
    r, i = torch.sigmoid(gates.float()).chunk(2, dim=-1)
    return _rglru_inputs(x, r, i, lp["lru_a"])


def _rglru_inputs(x: torch.Tensor, r: torch.Tensor, i: torch.Tensor,
                  lru_a: torch.Tensor):
    """The gates r and i (fp32) of the branch input x -> (log_a, gated
    input): a = exp(log_a), the input scaled by sqrt(1 - a^2)."""
    log_a = -_LRU_C * F.softplus(lru_a) * r                  # (..., lw) <= 0
    a2 = torch.exp(2.0 * log_a)
    gated = torch.sqrt(torch.clamp_min(1.0 - a2, 1e-12)) * (i * x.float())
    return log_a, gated


def _rglru_full(x: torch.Tensor, lp, h0: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """h_t = a_t h_{t-1} + b_t over the sequence. x: (B, S, lw); h0:
    (B, lw). Returns (h in x's dtype, h_S fp32)."""
    return _rglru_scan(*_rglru_gates(x, lp), h0, x.dtype)


def _rglru_scan(log_a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor,
                dtype: torch.dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """The recurrence over (B, S, lw) gates from h0 (B, lw).

    The reference runs ``lax.associative_scan``; here a log-depth
    doubling scan (Hillis-Steele) of the same combine, (a1, b1) . (a2, b2)
    = (a1 a2, a2 b1 + b2): ceil(log2 S) rounds of elementwise work over
    the whole (B, S, lw) tensor, where a loop over S would launch S rounds
    of tiny ones (2,040 for a long recurrentgemma prompt, in each of its 26
    recurrent layers). Both are exact in exact arithmetic; in fp32 they
    round in another order, within 1e-6 of each other.
    """
    a = torch.exp(log_a)
    b = b.clone()
    b[:, 0] += a[:, 0] * h0                  # h_1 = a_1 h0 + b_1
    S, k = b.shape[1], 1
    while k < S:
        b = torch.cat([b[:, :k], a[:, k:] * b[:, :-k] + b[:, k:]], dim=1)
        a = torch.cat([a[:, :k], a[:, k:] * a[:, :-k]], dim=1)
        k *= 2
    return b.to(dtype), b[:, -1]


def _rglru_step(x: torch.Tensor, lp, h: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, lw); h: (B, lw)."""
    log_a, b = _rglru_gates(x, lp)
    h_new = torch.exp(log_a) * h + b
    return h_new.to(x.dtype), h_new


def _mlp_block(cfg: ModelConfig, lp, x: torch.Tensor) -> torch.Tensor:
    """The residual GeGLU block (on a mesh its columns over ``model``)."""
    h2 = L.rms_norm(x, lp["ln2"]["scale"], cfg.rms_eps)
    return _act(x + _act(L.geglu_mlp(h2, tp.gather_weights(lp["mlp"]))))


def _rec_branch_meshed(cfg: ModelConfig, lp, x: torch.Tensor,
                       conv: Optional[torch.Tensor] = None,
                       lru: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The recurrent branch's output (the LRU's gated output through
    ``lru_out``) on a mesh, tensor parallel over ``model``
    (``tp.block_call``). x: (B, S, d), or (B, d) for a decode step, which
    advances its layer's ``conv`` (B, 3, lw) and ``lru`` (B, lw) cache in
    place; a prefill given them writes its conv tail and final state.

    Each rank takes its channels of the LRU width (the rules' split of
    ``conv_w``, ``lru_a`` and ``lru_out``'s rows; every channel where
    they leave them whole): ``lru_in``'s product (xa | xb, split
    contiguously) is gathered whole and cut into the rank's channels of
    each half; the gate product contracts over every channel, so the
    convolved input is gathered whole, and its product (r | i) gathered
    and cut as ``lru_in``'s."""
    mesh = x.device_mesh
    lw = _lru_width(cfg)
    cols = tp.model_piece(lp["lru_in"], 1)
    l0, nl, _ = ch = tp.model_piece(lp["lru_a"], 0)
    gcols = tp.model_piece(lp["lru_gate_w"], 1)
    rows = tp.model_share(lp["lru_out"], 0)
    cache = [None if t is None else t.to_local() for t in (conv, lru)]
    cpiece = None if conv is None else tp.model_piece(conv, 2)
    hpiece = None if lru is None else tp.model_piece(lru, 1)
    names = ("ln1", "lru_in", "conv_w", "conv_b", "lru_gate_w",
             "lru_gate_b", "lru_a", "lru_out")
    leaves = [lp["ln1"]["scale"]] + [lp[k] for k in names[1:]]

    def branch(xl, w):
        conv_l, lru_l = cache
        hn = L.rms_norm(xl, w["ln1"], cfg.rms_eps)
        xin = tp.concat_whole(hn @ w["lru_in"], cols, (lw, lw), mesh)
        xa, xb = xin[..., l0:l0 + nl], xin[..., lw + l0:lw + l0 + nl]
        cw, cb = tp.own_piece(w["conv_w"], 1, ch), tp.own_piece(
            w["conv_b"], 0, ch)
        if xl.ndim == 2:
            full = torch.cat([tp.own_piece(conv_l, -1, cpiece),
                              xa[:, None].to(conv_l.dtype)], dim=1)
            xc = (torch.einsum("bwl,wl->bl", full, cw) + cb).to(xa.dtype)
            _put(conv_l, full[:, 1:], cpiece, ch, lw, mesh)
        else:
            if conv_l is not None:
                tail = xa[:, -(_CONV_W - 1):]
                _put(conv_l, F.pad(tail, (0, 0, _CONV_W - 1 - tail.shape[1],
                                          0)), cpiece, ch, lw, mesh)
            xc = L.causal_conv(xa, cw, cb)
        gates = tp.concat_whole(
            tp.whole_over_model(xc, -1, ch, lw, mesh) @ w["lru_gate_w"]
            + w["lru_gate_b"], gcols, (lw, lw), mesh)
        gates = torch.sigmoid(gates.float())
        log_a, b = _rglru_inputs(xc, gates[..., l0:l0 + nl],
                                 gates[..., lw + l0:lw + l0 + nl],
                                 tp.own_piece(w["lru_a"], 0, ch))
        if xl.ndim == 2:
            h = torch.exp(log_a) * tp.own_piece(lru_l, -1, hpiece) + b
            y = h.to(xc.dtype)
        else:
            h0 = xc.new_zeros((xc.shape[0], nl), dtype=torch.float32)
            y, h = _rglru_scan(log_a, b, h0, xc.dtype)
        if lru_l is not None:
            _put(lru_l, h, hpiece, ch, lw, mesh)
        y = tp.own_piece(y * L.gelu(xb), -1, _within(rows, ch))
        out = y @ tp.own_piece(w["lru_out"], 0, rows)
        return tp.SumOver.apply(out, mesh, ("model",), False)

    return tp.block_call(branch, x, dict(zip(names, leaves)))


def _within(rows, ch):
    """``rows`` (a share of the LRU width) relative to the channels ``ch``
    that the rank computed (the same piece where both are split)."""
    if rows[2]:
        return 0, rows[1], True
    return rows[0] - ch[0], rows[1], False


def _put(cache_l: torch.Tensor, value: torch.Tensor, piece, ch, lw: int,
         mesh) -> None:
    """Write this rank's channels ``ch`` of a recurrent state into its
    local cache, which holds the cache's ``piece`` of the LRU width (the
    channels gathered whole where the cache is whole and the channels
    split)."""
    if ch[2] and not piece[2]:
        value = tp.all_gather_dim(value, value.ndim - 1, mesh, "model", lw)
    cache_l.copy_(value)


def _rec_block_full(cfg: ModelConfig, lp, x: torch.Tensor,
                    h0: torch.Tensor):
    """x: (B, S, d) -> (out, (conv_tail, h_final))."""
    if tp.is_meshed(x):
        x = _act(x + _rec_branch_meshed(cfg, lp, x))
        return _mlp_block(cfg, lp, x), None
    h = L.rms_norm(x, lp["ln1"]["scale"], cfg.rms_eps)
    xa, xb = (h @ lp["lru_in"]).chunk(2, dim=-1)
    y, h_fin = _rglru_full(L.causal_conv(xa, lp["conv_w"], lp["conv_b"]), lp,
                           h0)
    x = x + (y * L.gelu(xb)) @ lp["lru_out"]
    return _mlp_block(cfg, lp, x), (xa[:, -(_CONV_W - 1):], h_fin)


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
    return _mlp_block(cfg, lp, x), full[:, 1:], h


# ---------------------------------------------------------------------------
# local attention with a ring-buffer window cache
# ---------------------------------------------------------------------------

def _attn_out_mlp(cfg: ModelConfig, lp, x: torch.Tensor,
                  o: torch.Tensor) -> torch.Tensor:
    wo = tp.gather_weight(lp["attn"]["wo"])
    return _mlp_block(cfg, lp, _act(x + _act(_merge_heads(o) @ wo)))


def _attn_block_full(cfg: ModelConfig, lp, x: torch.Tensor,
                     positions: torch.Tensor):
    """Windowed causal attention block (on a mesh its query heads over
    ``model``). Returns (out, (k, v))."""
    q, k, v = _qkv_rope(cfg, x, lp, positions)
    q = lsc(q, "batch", "seq", "heads", None)
    k = lsc(k, "batch", "seq", "kv_heads", None)
    v = lsc(v, "batch", "seq", "kv_heads", None)
    W = cfg.hybrid.window
    o = _causal_attention(cfg, q, k, v, causal=True, window=W,
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


def _ring_write_meshed(rk: torch.Tensor, rv: torch.Tensor,
                       rpos: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       positions: torch.Tensor, W: int) -> None:
    """``_ring_write`` on a mesh: ring ``DTensor`` values (B, W, KH, D)
    split by slot over ``model``, ``rpos`` (B, W) whole; keys and values
    (B, S, KH, D) whole over ``model``; positions: (S,) absolute, the
    same for every row (S <= W), or (B,) one token a row. Each rank
    writes the tokens whose slots it holds, and every rank the whole
    ``rpos``; (S,) positions are consecutive (a prompt's tail)."""
    w0, nw = tp.local_range(rk, 1)
    kl, vl = (t.to_local() for t in (k, v))
    rkl, rvl, rposl = (t.to_local() for t in (rk, rv, rpos))
    pos = positions.to_local() if tp.is_meshed(positions) else positions
    if kl.ndim == 3:                          # one token a row (decode)
        slots = pos.long() % W
        rows = torch.arange(rkl.shape[0], device=rkl.device)
        rposl[rows, slots] = pos.to(rposl.dtype)
        mine = ((slots >= w0) & (slots < w0 + nw))[:, None, None]
        at = (slots - w0).clamp(0, nw - 1)
        for cl, new in ((rkl, kl), (rvl, vl)):
            cl[rows, at] = torch.where(mine, new.to(cl.dtype), cl[rows, at])
        return
    # consecutive positions p0 .. p0 + n - 1: slot j holds token
    # (j - p0) mod W where that is below n (no shape follows the values)
    n = kl.shape[1]
    t = (torch.arange(W, device=rkl.device) - pos[0].long()) % W
    fill = t < n
    rposl.copy_(torch.where(fill, (pos[0] + t).to(rposl.dtype), rposl))
    t, fill = t[w0:w0 + nw], fill[w0:w0 + nw, None, None]
    for cl, new in ((rkl, kl), (rvl, vl)):
        cl.copy_(torch.where(fill, new[:, t.clamp(max=n - 1)].to(cl.dtype),
                             cl))


def _ring_scores(q: torch.Tensor, rk: torch.Tensor, rpos: torch.Tensor,
                 q_pos: torch.Tensor, window: int):
    """fp32 scores (B, KH, G, W) of q (B, H, D) against the ring's keys,
    -1e30 outside the window, and the mask of valid slots (B, W)."""
    B, H, D = q.shape
    KH = rk.shape[2]
    qg = q.reshape(B, KH, H // KH, D)
    s = torch.einsum("bhgd,bwhd->bhgw", qg.float(), rk.float()) / math.sqrt(D)
    qp = q_pos[:, None]
    valid = (rpos >= 0) & (rpos <= qp) & (rpos > qp - window)
    return torch.where(valid[:, None, None], s,
                       torch.full_like(s, L.NEG_INF)), valid


def _ring_attend(q: torch.Tensor, rk: torch.Tensor, rv: torch.Tensor,
                 rpos: torch.Tensor, q_pos: torch.Tensor,
                 window: int) -> torch.Tensor:
    """q: (B, H, D); ring (B, W, KH, D); rpos: (B, W) absolute positions
    (-1: empty); q_pos: (B,). Windowed GQA attention over the ring, fp32
    scores, p cast to v's dtype before PV, as the reference. Returns
    (B, H, D)."""
    B, H, D = q.shape
    s, _ = _ring_scores(q, rk, rpos, q_pos, window)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1)
    o = torch.einsum("bhgw,bwhd->bhgd", p.to(rv.dtype).float(), rv.float())
    return (o / l.clamp_min(1e-37)[..., None]).reshape(B, H, D).to(q.dtype)


def _ring_partial(q: torch.Tensor, rk: torch.Tensor, rv: torch.Tensor,
                  rpos: torch.Tensor, q_pos: torch.Tensor, window: int):
    """``_ring_attend`` over some of the ring's slots, as a partial: (o
    (B, H, D) fp32, lse (B, H); -1e30 where no slot of these is valid)."""
    B, H, D = q.shape
    s, valid = _ring_scores(q, rk, rpos, q_pos, window)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1)
    o = torch.einsum("bhgw,bwhd->bhgd", p.to(rv.dtype).float(), rv.float())
    o = o / l.clamp_min(1e-37)[..., None]
    lse = torch.where(valid.any(-1)[:, None, None], m[..., 0] + torch.log(l),
                      torch.full_like(l, L.NEG_INF))
    return o.reshape(B, H, D), lse.reshape(B, H)


def _attn_block_step(cfg: ModelConfig, lp, x: torch.Tensor,
                     rk: torch.Tensor, rv: torch.Tensor, rpos: torch.Tensor,
                     q_pos: torch.Tensor) -> torch.Tensor:
    """x: (B, d); q_pos: (B,) absolute position of the new token, whose
    key and value are written into the ring (in place) before attending.
    On a mesh each rank attends every query head over its slots and the
    partials join by the LSE all-reduce over the ring's slot axes."""
    q, k, v = (t[:, 0] for t in _qkv_rope(cfg, x[:, None], lp,
                                          q_pos[:, None]))
    W = cfg.hybrid.window
    if not tp.is_meshed(q):
        _ring_write(rk, rv, rpos, k[:, None], v[:, None], q_pos[:, None])
        return _attn_out_mlp(cfg, lp, x,
                             _ring_attend(q, rk, rv, rpos, q_pos, W))
    q = lsc(q, "batch", "heads", None)
    keep = tp.split_axes(q, 0)
    q, k, v = (tp.keep_shards(t, keep) for t in (q, k, v))
    _ring_write_meshed(rk, rv, rpos, k, v, q_pos, W)
    w0, nw = tp.local_range(rk, 1)
    mesh, slot_axes = q.device_mesh, tp.split_axes(rk, 1)

    def body(ql, rkl, rvl, rposl, qp):
        o, lse = _ring_partial(ql, rkl, rvl, rposl[:, w0:w0 + nw], qp, W)
        return lse_combine(o, lse, mesh, slot_axes)[0].to(ql.dtype)

    o = tp.local_call(body, (q, rk, rv, rpos, q_pos), q.placements, mesh)
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
                                cfg.rms_eps),
                     tp.gather_weight(params["embed"]["embed"]))


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
    x = _embed(params, tokens)
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
    x = _embed(params, tokens)
    B, S, _ = x.shape
    positions = start_pos + torch.arange(S, device=x.device)
    n = min(cfg.hybrid.window, S)
    tail_pos = positions[-n:].expand(B, n)
    h0 = torch.zeros((B, _lru_width(cfg)), dtype=torch.float32,
                     device=x.device)
    for kind, lp, j in _layers(cfg, params):
        if tp.is_meshed(x) and kind == "attn":
            x, (k, v) = _attn_block_full(cfg, lp, x, positions)
            _ring_write_meshed(cache["ring_k"][j], cache["ring_v"][j],
                               cache["ring_pos"][j], k[:, -n:], v[:, -n:],
                               positions[-n:], cfg.hybrid.window)
        elif tp.is_meshed(x):
            x = _mlp_block(cfg, lp, _act(x + _rec_branch_meshed(
                cfg, lp, x, cache["conv"][j], cache["lru"][j])))
        elif kind == "attn":
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
    x = _embed(params, tokens)
    q_pos = cache["length"] if positions is None else positions
    for kind, lp, j in _layers(cfg, params):
        if kind == "attn":
            x = _attn_block_step(cfg, lp, x, cache["ring_k"][j],
                                 cache["ring_v"][j], cache["ring_pos"][j],
                                 q_pos)
        elif tp.is_meshed(x):
            x = _mlp_block(cfg, lp, _act(x + _rec_branch_meshed(
                cfg, lp, x, cache["conv"][j], cache["lru"][j])))
        else:
            x, conv_s, h = _rec_block_step(cfg, lp, x, cache["conv"][j],
                                           cache["lru"][j])
            cache["conv"][j] = conv_s
            cache["lru"][j] = h
    cache["length"].add_(1)
    return _logits(cfg, params, x), cache
