"""Dense / GQA decoder: prefill and decode with the MoSKA mixture; covers
the dense, VLM and MoE families.

Port of the reference ``models/dense.py``: pre-norm transformer with
RoPE, GQA attention and a SwiGLU FFN, or the capacity-dispatch MoE FFN of
``models/moe.py`` (with Arctic's dense residual beside it). VLM
(internvl2): the stub vision frontend's patch embeddings (B, P, d_model)
are put in front of the token embeddings (``prefill(frontend_embeds=)``);
no cross-attention. Parameters live in
a :class:`DenseLM` module (an ``nn.ModuleList`` of layers); the layers run
as a Python loop. When a ``SharedKVStore`` is attached, each layer routes
its queries over that layer's shared chunks and merges the batched shared
partial with the unique partial (``core/moska_attention.py``). An int8
store reaches the shared attention as int8 plus its scales (the
``shared_chunk_attention_q8`` kernel dequantizes in its loads).

Two unique-KV layouts: the slotted slab (``prefill``, ``decode_step``)
and the paged pool (``decode_step_paged``, whose unique partial is the
``paged_decode_attention`` kernel reading pages through the block table;
``prefill_chunk`` prefills prompts past ``max_seq`` in pieces against a
growing scratch context). Caches and pools are written in place: every
entry point returns the cache it was given, updated.

Under a mesh (``sharding/tensor_parallel.py``) the parameters, the tokens,
the cache and the store are ``DTensor`` values placed by the rules, and
the same entry points run tensor parallel over ``model``: ``train_loss``,
``prefill`` without a store, and ``decode_step`` with or without one (the
store chunk-sharded, the unique cache split by position,
``core/disagg.meshed_decode_attention``), the MoE FFN expert parallel
(``models/moe.py``). ``lsc`` pins the activations at the reference's
points; it is the identity on plain tensors, so the unmeshed path is what
it was.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import Partial, Shard

from repro_torch import obs
from repro_torch.configs.base import ModelConfig
from repro_torch.core import moska_attention as MA
from repro_torch.core import router as router_lib
from repro_torch.core import disagg
from repro_torch.core import shared_attention as sa
from repro_torch.core.shared_kv import SharedKVStore
from repro_torch.kernels import ops
from repro_torch.kvcache.cache import KVCache, append_token, write_prefix
from repro_torch.kvcache.paged import (PagedKVCache, append_index,
                                      append_layer)
from repro_torch.models import layers as L
from repro_torch.models import moe as moe_lib
from repro_torch.sharding import data_parallel as dp
from repro_torch.sharding import tensor_parallel as tp
from repro_torch.sharding.specs import lsc


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
        if cfg.moe.enabled:
            E = cfg.moe.num_experts
            self.moe = nn.ParameterDict({
                "router": _param((d, E), torch.float32, device),
                "e_gate": _param((E, d, f), dt, device),
                "e_up": _param((E, d, f), dt, device),
                "e_down": _param((E, f, d), dt, device)})
        if not cfg.moe.enabled or cfg.moe.dense_residual:
            self.mlp = nn.ParameterDict({"w_gate": _param((d, f), dt, device),
                                         "w_up": _param((d, f), dt, device),
                                         "w_down": _param((f, d), dt, device)})


class DenseLM(nn.Module):
    """Embedding, layer stack, final norm and (untied) unembedding."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
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
    embeddings and projections scaled by 1/sqrt(fan_in) (the MoE router
    fp32), zero norms and biases. ``generator`` must live on ``device``."""
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
        if cfg.moe.enabled:
            moe_lib.moe_init(lp.moe, generator, d, f)
        if hasattr(lp, "mlp"):
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

def _rope(cfg: ModelConfig, x: torch.Tensor, positions: torch.Tensor
          ) -> torch.Tensor:
    """RoPE of x (..., S, heads, D); a ``DTensor`` on its local heads and
    rows (positions: plain, or a ``DTensor`` split as x's rows)."""
    if not tp.is_meshed(x):
        return L.apply_rope(x, positions, cfg.rope_theta)
    return tp.local_call(lambda t, pos: L.apply_rope(t, pos, cfg.rope_theta),
                         (x, positions), x.placements, x.device_mesh)


def _qkv_rope(cfg: ModelConfig, x: torch.Tensor, lp: DenseLayer,
              positions: torch.Tensor):
    """Pre-norm QKV projection with RoPE on q and k. x: (B, S, d);
    positions: (S,) or (B, S). Returns q (B, S, H, D), k, v (B, S, KH, D)."""
    # a sequence-parallel residual (the seqpar variant) is gathered
    h = _act(L.rms_norm(x, lp.ln1["scale"], cfg.rms_eps))
    q, k, v = L.qkv_project(h, tp.gather_weights(lp.attn), cfg.num_heads,
                            cfg.num_kv_heads, cfg.head_dim)
    return _rope(cfg, q, positions), _rope(cfg, k, positions), v


def _act(x: torch.Tensor, seq: str = "seq") -> torch.Tensor:
    """The residual stream (B, S, d) or (B, d) pinned: rows over the batch
    axes, d_model whole (a row-parallel product's partial sums reduced)."""
    return lsc(x, *("batch", seq)[:x.ndim - 1], None)


def _causal_attention(cfg: ModelConfig, q: torch.Tensor, k: torch.Tensor,
                      v: torch.Tensor, **kw) -> torch.Tensor:
    """``flash_attention``; on a mesh, each rank's query heads against the
    kv heads they read (the whole of k and v when the kv heads do not
    split over the model axis: their gradient is then a partial sum of
    the ranks')."""
    if not tp.is_meshed(q):
        return L.flash_attention(q, k, v, **kw)
    q_first, q_count = tp.local_range(q, 2)
    k_first, _ = tp.local_range(k, 2)
    G = cfg.num_heads // cfg.num_kv_heads

    def body(ql, kl, vl):
        return L.flash_attention(
            ql, tp.kv_for_heads(kl, k_first, q_first, q_count, G),
            tp.kv_for_heads(vl, k_first, q_first, q_count, G), **kw)

    grad = tuple(Partial() if isinstance(pq, Shard) and pq.dim == 2
                 and not isinstance(pk, Shard) else pk
                 for pq, pk in zip(q.placements, k.placements))
    return tp.local_call(body, (q, k, v), q.placements, q.device_mesh,
                         grad_placements=(None, grad, grad))


def _merge_heads(o: torch.Tensor) -> torch.Tensor:
    """(..., H, D) -> (..., H * D). On a mesh the merge runs on the local
    tensor: the output projection's backward hands it a gradient split
    over ``model`` on H * D, which DTensor cannot view back onto heads
    that the axis does not divide (arctic's 56 over 16); the local merge
    gathers that gradient to o's placement instead."""
    if not tp.is_meshed(o):
        return o.reshape(*o.shape[:-2], -1)
    return tp.local_call(lambda t: t.reshape(*t.shape[:-2], -1), (o,),
                         o.placements, o.device_mesh)


#: the profiler range around each MoE FFN call (``obs.profiled_span``:
#: opened only while a profiler runs)
MOE_RANGE = "moe_ffn"


def _ffn(cfg: ModelConfig, lp: DenseLayer, x: torch.Tensor,
         rec: Optional[obs.DeviceRecorder] = None) -> torch.Tensor:
    """x: (..., d) -> the FFN's output: SwiGLU, or the MoE FFN over every
    row handed in as one batch of tokens (its capacity counts them all),
    plus Arctic's dense residual. Serving drops the MoE aux loss, so it is
    not computed."""
    if not cfg.moe.enabled:
        with obs.profiled_span("layer.ffn"):
            return L.swiglu_mlp(x, tp.gather_weights(lp.mlp))
    with obs.profiled_span(MOE_RANGE):
        y, _ = moe_lib.moe_ffn(x.reshape(-1, x.shape[-1]), lp.moe, cfg.moe,
                               rec=rec, with_aux=False)
    y = y.view(x.shape)
    if cfg.moe.dense_residual:
        with obs.profiled_span("layer.ffn"):
            y = y + L.swiglu_mlp(x, tp.gather_weights(lp.mlp))
    return y


def _attn_out_mlp(cfg: ModelConfig, x: torch.Tensor, o: torch.Tensor,
                  lp: DenseLayer,
                  rec: Optional[obs.DeviceRecorder] = None) -> torch.Tensor:
    """Residual output projection of the attention o ((B, S, H, D) or
    (B, H, D)), then the residual FFN block."""
    wo = tp.gather_weight(lp.attn["wo"])
    x = x + _act(o.reshape(*o.shape[:-2], -1) @ wo)
    h2 = L.rms_norm(x, lp.ln2["scale"], cfg.rms_eps)
    return x + _act(_ffn(cfg, lp, h2, rec))


class SharedLayer(NamedTuple):
    """Layer i's slices of a shared store; scales only for an int8 store
    (the int8 K/V are not dequantized here: the kernel does it)."""
    k: torch.Tensor                       # (E, C, KH, D)
    v: torch.Tensor
    emb: torch.Tensor                     # (E, KH, D)
    k_scale: Optional[torch.Tensor]       # (E, C, KH) f32, or None
    v_scale: Optional[torch.Tensor]

    def context(self, routing) -> MA.MoskaLayerContext:
        return MA.MoskaLayerContext(self.k, self.v, routing, self.k_scale,
                                    self.v_scale)


def _shared_layer(store: SharedKVStore, i: int) -> SharedLayer:
    if store.quantized:
        return SharedLayer(store.k[i], store.v[i], store.emb[i],
                           store.k_scale[i], store.v_scale[i])
    return SharedLayer(store.k[i], store.v[i], store.emb[i], None, None)


def _pooled_queries(q: torch.Tensor, n_valid: Optional[int],
                    rb: int) -> torch.Tensor:
    """Mean-pool (B, S, H, D) queries in blocks of ``rb`` for routing,
    leaving positions >= ``n_valid`` (bucket or chunk padding) out."""
    B, S, H, D = q.shape
    nb = S // rb
    if n_valid is None:
        return q.reshape(B * nb, rb, H, D).mean(dim=1)
    valid = (torch.arange(S, device=q.device) < n_valid).to(q.dtype)
    qs = (q * valid[None, :, None, None]).reshape(B, nb, rb, H, D)
    cnt = valid.reshape(nb, rb).sum(dim=1).clamp_min(1.0)
    return (qs.sum(dim=2) / cnt[None, :, None, None]).reshape(B * nb, H, D)


def _decode_context(cfg: ModelConfig, q: torch.Tensor,
                    shared: Optional[SharedLayer]
                    ) -> Optional[MA.MoskaLayerContext]:
    """Route each request's decode query (B, H, D) over the layer's chunks."""
    if shared is None:
        return None
    with obs.profiled_span("layer.route"):
        routing = router_lib.route(q, shared.emb, cfg.moska.top_k_chunks)
    return shared.context(routing)


def _layer_prefill(cfg: ModelConfig, x: torch.Tensor, lp: DenseLayer,
                   positions: torch.Tensor, kc: torch.Tensor,
                   vc: torch.Tensor, shared: Optional[SharedLayer],
                   q_offset: int, true_len: Optional[int] = None,
                   rec: Optional[obs.DeviceRecorder] = None) -> torch.Tensor:
    """Prefill layer: causal attention + cache write + optional MoSKA path.

    ``true_len``: the real prompt length when the sequence is right-padded
    to a prefill bucket. Pad queries are left out of the router pooling,
    so routing (and every real row's output) matches the exact-length
    prefill; pad rows compute values the caller discards.
    """
    q, k, v = _qkv_rope(cfg, x, lp, positions)
    q = lsc(q, "batch", "seq", "heads", None)
    if tp.is_meshed(q):
        if shared is not None:
            raise NotImplementedError("a routed prefill (with a store) "
                                      "under a mesh")
        # a projection whose d_model dim the rules split over model (the
        # expert_resident variant) leaves k and v partial sums
        k = lsc(k, "batch", "seq", "kv_heads", None)
        v = lsc(v, "batch", "seq", "kv_heads", None)
        tp.write_prefix_meshed(kc, vc, k, v)
        o = _causal_attention(cfg, q, k, v, causal=True, q_offset=q_offset,
                              kv_offset=q_offset, window=cfg.attn_window)
        return _attn_out_mlp(cfg, x, o, lp, rec)
    write_prefix(kc, vc, k, v)

    if shared is not None:
        rb = min(128, q.shape[1])
        with obs.profiled_span("layer.route"):
            routing = router_lib.route(_pooled_queries(q, true_len, rb),
                                       shared.emb, cfg.moska.top_k_chunks)
        o = MA.moska_prefill_attention(
            q, k, v, shared.context(routing), cfg.moska, q_offset=q_offset,
            window=cfg.attn_window, route_block=rb, rec=rec)
    else:
        with obs.profiled_span("layer.unique_attention"):
            o = L.flash_attention(q, k, v, causal=True, q_offset=q_offset,
                                  kv_offset=q_offset, window=cfg.attn_window)
    return _attn_out_mlp(cfg, x, o, lp, rec)


def _layer_decode(cfg: ModelConfig, x: torch.Tensor, lp: DenseLayer,
                  positions: torch.Tensor, kc: torch.Tensor,
                  vc: torch.Tensor, lengths: torch.Tensor,
                  shared: Optional[SharedLayer],
                  rec: Optional[obs.DeviceRecorder] = None) -> torch.Tensor:
    """Decode layer: one token per request. x: (B, d); positions: (B,)
    absolute position of the new token; the new K/V are appended to the
    layer's cache slices in place."""
    q, k, v = (t[:, 0] for t in _qkv_rope(cfg, x[:, None], lp,
                                          positions[:, None]))
    q = lsc(q, "batch", "heads", None)
    if tp.is_meshed(q):
        o = disagg.meshed_decode_attention(
            q, k, v, kc, vc, lengths, shared, cfg.moska,
            window=cfg.attn_window)
        return _attn_out_mlp(cfg, x, o, lp, rec)
    append_token(kc, vc, k, v, lengths)
    o = MA.moska_decode_attention(q, kc, vc, lengths + 1,
                                  _decode_context(cfg, q, shared), cfg.moska,
                                  window=cfg.attn_window, rec=rec)
    return _attn_out_mlp(cfg, x, o, lp, rec)


def _layer_decode_paged(cfg: ModelConfig, x: torch.Tensor, lp: DenseLayer,
                        positions: torch.Tensor, kp: torch.Tensor,
                        vp: torch.Tensor, table: torch.Tensor,
                        lengths: torch.Tensor, index,
                        shared: Optional[SharedLayer],
                        rec: Optional[obs.DeviceRecorder] = None
                        ) -> torch.Tensor:
    """Paged decode layer: ``_layer_decode``'s math with the unique KV in a
    page pool. kp/vp: (N, bs, KH, D) one layer's pages, written in place;
    table: (B, M) int32; lengths: (B,); index: the step's
    ``append_index``. The new token is scattered into its page, then the
    ``paged_decode_attention`` kernel reads each request's pages through
    the table (no gathered copy) and its partial is merged with the routed
    shared partial, as the slotted layer merges the ``decode_attention``
    partial."""
    q, k, v = (t[:, 0] for t in _qkv_rope(cfg, x[:, None], lp,
                                          positions[:, None]))
    q = lsc(q, "batch", "heads", None)
    append_layer(kp, k, index)
    append_layer(vp, v, index)
    with obs.profiled_span("layer.unique_attention"):
        o_u, lse_u = ops.paged_decode_attention(q, kp, vp, table,
                                                lengths + 1,
                                                window=cfg.attn_window)
    o = MA.moska_decode_merge(q, o_u, lse_u, _decode_context(cfg, q, shared),
                              cfg.moska, rec=rec)
    return _attn_out_mlp(cfg, x, o, lp, rec)


def _layer_prefill_chunk(cfg: ModelConfig, x: torch.Tensor, lp: DenseLayer,
                         positions: torch.Tensor, kc: torch.Tensor,
                         vc: torch.Tensor, base: int, chunk_len: int,
                         shared: Optional[SharedLayer], start_pos: int,
                         rec: Optional[obs.DeviceRecorder] = None
                         ) -> torch.Tensor:
    """One chunk of a long prompt against the growing context view.

    x: (B, C, d) chunk activations (right-padded; ``chunk_len`` real);
    kc/vc: (B, V, KH, D) scratch context holding ``base`` earlier tokens;
    the chunk's fresh keys are written at ``base`` (in place) and causal
    attention runs over the whole view with ``kv_len = base + chunk_len``.
    """
    q, k, v = _qkv_rope(cfg, x, lp, positions)
    q = lsc(q, "batch", "seq", "heads", None)
    B, C, H, D = q.shape
    # the reference's dynamic_update_slice clamps the start into the view
    b0 = max(0, min(base, kc.shape[1] - C))
    kc[:, b0:b0 + C] = k.to(kc.dtype)
    vc[:, b0:b0 + C] = v.to(vc.dtype)
    attn = dict(causal=True, q_offset=start_pos + base, kv_offset=start_pos,
                kv_len=base + chunk_len, window=cfg.attn_window)
    if shared is None:
        with obs.profiled_span("layer.unique_attention"):
            o = L.flash_attention(q, kc, vc, **attn)
        return _attn_out_mlp(cfg, x, o, lp, rec)
    rb = min(128, C)
    with obs.profiled_span("layer.route"):
        routing = router_lib.route(_pooled_queries(q, chunk_len, rb),
                                   shared.emb, cfg.moska.top_k_chunks)
    with obs.profiled_span("layer.unique_attention"):
        o_u, lse_u = L.flash_attention(q, kc, vc, return_lse=True, **attn)
    part = sa.shared_attention_batched(
        q.reshape(B * (C // rb), rb, H, D), shared.k, shared.v, routing,
        capacity_factor=cfg.moska.query_capacity_factor,
        k_scale=shared.k_scale, v_scale=shared.v_scale, rec=rec)
    with obs.profiled_span("layer.merge"):
        o, _ = L.merge_partial_attention([o_u, part.out.reshape(B, C, H, D)],
                                         [lse_u, part.lse.reshape(B, C, H)])
    return _attn_out_mlp(cfg, x, o, lp, rec)


def _layer_train(cfg: ModelConfig, x: torch.Tensor, lp: DenseLayer,
                 positions: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence causal layer (the training path: no cache, no store).

    x: (B, S, d); positions: (S,). Returns (x_out, moe_aux): the MoE FFN's
    Switch aux loss (fp32), 0 for a dense FFN.
    """
    q, k, v = _qkv_rope(cfg, x, lp, positions)
    q = lsc(q, "batch", "seq", "heads", None)
    k = lsc(k, "batch", "seq", "kv_heads", None)
    v = lsc(v, "batch", "seq", "kv_heads", None)
    o = _causal_attention(cfg, q, k, v, causal=True, window=cfg.attn_window,
                          block_k=cfg.attn_block_k)
    wo = tp.gather_weight(lp.attn["wo"])
    x = _act(x + _act(_merge_heads(o) @ wo, "seq_res"),
             "seq_res")
    h2 = _act(L.rms_norm(x, lp.ln2["scale"], cfg.rms_eps))
    if not cfg.moe.enabled:
        zero = torch.zeros((), dtype=torch.float32, device=x.device)
        y = _act(L.swiglu_mlp(h2, tp.gather_weights(lp.mlp)), "seq_res")
        return _act(x + y, "seq_res"), zero
    B, S, d = h2.shape
    y, aux = moe_lib.moe_ffn(h2.reshape(B * S, d), lp.moe, cfg.moe)
    y = y.view(B, S, d)
    if cfg.moe.dense_residual:
        y = y + L.swiglu_mlp(h2, tp.gather_weights(lp.mlp))
    return _act(x + _act(y, "seq_res"), "seq_res"), aux


# ---------------------------------------------------------------------------
# full-model forwards
# ---------------------------------------------------------------------------

def _logits(cfg: ModelConfig, params: DenseLM, x: torch.Tensor
            ) -> torch.Tensor:
    """fp32 logits of the final-normed hidden state (the reference's
    preferred_element_type=float32 unembedding)."""
    with obs.profiled_span("unembed"):
        x = L.rms_norm(x, params.final_norm["scale"], cfg.rms_eps)
        return L.unembed(x, tp.gather_weight(params.unembed_matrix()))


def _embed(params: DenseLM, tokens: torch.Tensor) -> torch.Tensor:
    """The tokens' rows of the embedding table; on a mesh a lookup in the
    vocab-sharded table (each rank's rows, summed over the model axis)."""
    table = params.embed["embed"]
    if not tp.is_meshed(table):
        return table[tokens]
    return _act(F.embedding(tokens, tp.gather_weight(table)))


def embed_inputs(cfg: ModelConfig, params: DenseLM, tokens: torch.Tensor,
                 frontend_embeds: Optional[torch.Tensor] = None
                 ) -> torch.Tensor:
    """Token embeddings (B, S, d), with the frontend's (B, P, d) patch
    embeddings in front when given: (B, P + S, d)."""
    x = _embed(params, tokens)
    if frontend_embeds is not None:
        x = torch.cat([frontend_embeds.to(x.dtype), x], dim=1)
    return _act(x)


@torch.no_grad()
def prefill(cfg: ModelConfig, params: DenseLM, tokens: torch.Tensor,
            cache: KVCache, store: Optional[SharedKVStore] = None,
            frontend_embeds: Optional[torch.Tensor] = None,
            start_pos: int = 0, true_len: Optional[int] = None,
            rec: Optional[obs.DeviceRecorder] = None
            ) -> Tuple[torch.Tensor, KVCache]:
    """Process the unique prefix; returns (last-token logits, cache).

    ``true_len``: real prompt length when ``tokens`` is right-padded to a
    prefill bucket — logits are taken at position ``true_len - 1`` and the
    cache lengths record ``true_len``. Not supported together with
    ``frontend_embeds``, whose P patches take positions ``start_pos ..
    start_pos + P - 1`` ahead of the tokens (the cache holds P + S).
    """
    if true_len is not None and frontend_embeds is not None:
        raise ValueError("true_len is not supported with frontend_embeds")
    x = embed_inputs(cfg, params, tokens, frontend_embeds)
    B, S, _ = x.shape
    positions = start_pos + torch.arange(S, device=x.device)
    use_store = store is not None and cfg.moska.enabled
    for i, lp in enumerate(params.layers):
        sh = _shared_layer(store, i) if use_store else None
        with obs.profiled_span("layer"):
            x = _layer_prefill(cfg, x, lp, positions, cache.k[i], cache.v[i],
                               sh, start_pos, true_len=true_len, rec=rec)
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
    x = _embed(params, tokens)                             # (B, d)
    if positions is None:
        positions = cache.positions                        # absolute (RoPE)
    use_store = store is not None and cfg.moska.enabled
    for i, lp in enumerate(params.layers):
        sh = _shared_layer(store, i) if use_store else None
        with obs.profiled_span("layer"):
            x = _layer_decode(cfg, x, lp, positions, cache.k[i], cache.v[i],
                              cache.length, sh, rec=rec)
    logits = _logits(cfg, params, x)
    cache.length.add_(1)
    return logits, cache


@torch.no_grad()
def decode_step_paged(cfg: ModelConfig, params: DenseLM,
                      tokens: torch.Tensor, pool: PagedKVCache,
                      table: torch.Tensor, lengths: torch.Tensor,
                      offsets: torch.Tensor,
                      store: Optional[SharedKVStore] = None,
                      rec: Optional[obs.DeviceRecorder] = None
                      ) -> Tuple[torch.Tensor, PagedKVCache]:
    """One decode step over the paged unique-KV pool.

    tokens: (B,); pool: pages (L, N, bs, KH, D), written in place; table:
    (B, M) int32 block tables; lengths/offsets: (B,) int32 — the device
    copy of the host-side ``SlotTables`` length/offset vectors. Returns
    (logits (B, V) fp32, pool). The caller advances lengths (``tick``).
    """
    x = _embed(params, tokens)                             # (B, d)
    positions = offsets + lengths                          # absolute (RoPE)
    index = append_index(table, lengths, pool.block_size)
    use_store = store is not None and cfg.moska.enabled
    for i, lp in enumerate(params.layers):
        sh = _shared_layer(store, i) if use_store else None
        with obs.profiled_span("layer"):
            x = _layer_decode_paged(cfg, x, lp, positions, pool.k[i],
                                    pool.v[i], table, lengths, index, sh,
                                    rec=rec)
    return _logits(cfg, params, x), pool


@torch.no_grad()
def prefill_chunk(cfg: ModelConfig, params: DenseLM, tokens: torch.Tensor,
                  cache: KVCache, store: Optional[SharedKVStore] = None,
                  start_pos: int = 0, chunk_len: Optional[int] = None,
                  rec: Optional[obs.DeviceRecorder] = None
                  ) -> Tuple[torch.Tensor, KVCache]:
    """Process one chunk of a long prompt; call repeatedly to prefill
    prompts past the largest bucket.

    tokens: (B, C) the chunk, right-padded; ``chunk_len`` is the number of
    real tokens in it. ``cache`` is the scratch context (L, B, V, KH, D)
    already holding ``cache.length`` earlier tokens; it is extended in
    place by ``chunk_len``. Returns (logits at the chunk's last real
    token, cache). Numerically equivalent to the single-shot prefill
    (allclose), not bitwise (other contraction shapes).
    """
    x = _embed(params, tokens)
    B, C, _ = x.shape
    base = int(cache.length[0])
    chunk_len = C if chunk_len is None else int(chunk_len)
    positions = start_pos + base + torch.arange(C, device=x.device)
    use_store = store is not None and cfg.moska.enabled
    for i, lp in enumerate(params.layers):
        sh = _shared_layer(store, i) if use_store else None
        with obs.profiled_span("layer"):
            x = _layer_prefill_chunk(cfg, x, lp, positions, cache.k[i],
                                     cache.v[i], base, chunk_len, sh,
                                     start_pos, rec=rec)
    logits = _logits(cfg, params, x[:, chunk_len - 1])
    cache.length.add_(chunk_len)
    cache.offset.fill_(start_pos)
    return logits, cache


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def forward_hidden(cfg: ModelConfig, params: DenseLM, x: torch.Tensor,
                   positions: torch.Tensor, *, remat: bool = True
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run the layer stack (the training path), each layer under
    ``cfg.remat_policy`` when ``remat``. Returns (final-normed hidden,
    the layers' summed MoE aux loss)."""
    body = L.remat(_layer_train, cfg.remat_policy if remat else "none")
    auxs = []
    for lp in params.layers:
        x, aux = body(cfg, x, lp, positions)
        auxs.append(aux)
    x = L.rms_norm(x, params.final_norm["scale"], cfg.rms_eps)
    return x, torch.stack(auxs).sum()


def _chunk_ce(h: torch.Tensor, t: torch.Tensor, m: torch.Tensor,
              W: torch.Tensor) -> torch.Tensor:
    """Summed masked cross-entropy of one sequence chunk; the logits are
    fp32 products of the operands (bf16 ones are exact in fp32). On a mesh
    the vocab stays sharded: the log-sum-exp reduces each rank's max and
    sum of exponentials over the model axis."""
    logits = lsc(L.unembed(h, W), "batch", "seq", "vocab")
    if not tp.is_meshed(logits):
        lse = torch.logsumexp(logits, dim=-1)
        ll = logits.gather(-1, t[..., None])[..., 0]
        return torch.sum((lse - ll) * m)
    # each token's terms whole on every rank of the model axis: a row
    # split there would send the logits' gradient through an all-to-all
    mx = lsc(logits.detach().amax(dim=-1, keepdim=True), "batch", "seq",
             None)
    lse = torch.log(lsc(torch.exp(logits - mx).sum(dim=-1), "batch",
                        "seq")) + mx[..., 0]
    # the target's logit from its row of the table (a gather of the
    # sharded logits would gather them whole over the model axis)
    wt = lsc(F.embedding(t, W), "batch", "seq", None)
    ll = (h.float() * wt.float()).sum(dim=-1)
    return torch.sum((lse - ll) * m)


def lm_loss(cfg: ModelConfig, params, hidden: torch.Tensor,
            targets: torch.Tensor, mask: torch.Tensor, *,
            seq_chunk: int = 512) -> torch.Tensor:
    """Chunked cross-entropy, mean over the mask: the (B, S, V) logits
    never live at once. hidden: (B, S, d); targets (int64) and mask:
    (B, S). Under autograd, with more than one chunk, each chunk's logits
    are recomputed in the backward pass rather than kept. ``params``: a
    ``DenseLM``, or a family's tree whose tied embedding unembeds. In a
    data-parallel step the sum over this rank's rows is divided by the
    mask count of the global batch: the ranks' losses add up to the
    global mean."""
    S = hidden.shape[1]
    W = tp.gather_weight(params.unembed_matrix()
                         if isinstance(params, DenseLM)
                         else params["embed"]["embed"])
    pieces = [(a, min(a + seq_chunk, S)) for a in range(0, S, seq_chunk)]
    ce = L.remat(_chunk_ce, "nothing" if len(pieces) > 1
                 and torch.is_grad_enabled() else "none")
    total = hidden.new_zeros((), dtype=torch.float32)
    for a, b in pieces:
        total = total + ce(hidden[:, a:b], targets[:, a:b], mask[:, a:b], W)
    return total / torch.clamp(dp.global_sum(mask.sum()), min=1.0)


def train_loss(cfg: ModelConfig, params: DenseLM, batch, *,
               remat: bool = True):
    """batch: "tokens", "targets" (B, S) int64, "mask" (B, S) fp32, and
    for the VLM "frontend_embeds" (B, P, d), whose positions carry no
    loss. Returns (ce_loss + moe_aux, {"ce_loss", "moe_aux"})."""
    tokens = batch["tokens"]
    x = embed_inputs(cfg, params, tokens, batch.get("frontend_embeds"))
    S = x.shape[1]
    positions = torch.arange(S, device=x.device)
    hidden, aux = forward_hidden(cfg, params, x, positions, remat=remat)
    P = S - tokens.shape[1]
    loss = lm_loss(cfg, params, hidden[:, P:], batch["targets"],
                   batch["mask"])
    return loss + aux, {"ce_loss": loss, "moe_aux": aux}
