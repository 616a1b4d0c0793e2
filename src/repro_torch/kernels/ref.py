"""Plain PyTorch versions of the hand-written kernels in this package.

Each function computes what its kernel computes, in fp32, on any device.
The wrappers in ``repro_torch.kernels.ops`` take these for tensors that lie
on the CPU; ``chip_smoke.py`` holds every kernel against them on the card.
They are ports of the reference package's jnp oracles (``kernels/ref.py``).
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

from repro_torch.kvcache.paged import gather_layer

NEG_INF = -1e30


def shared_chunk_attention_ref(qd: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, qmask: torch.Tensor
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The batched per-chunk GEMM attention (paper Fig. 2a).

    qd: (E, cap, H, D) dispatched queries; k/v: (E, C, KH, D);
    qmask: (E, cap) bool. Non-causal. Returns (out (E, cap, H, D) in
    qd.dtype, lse (E, cap, H) fp32); rows where qmask is False get out 0
    and lse -1e30.
    """
    E, cap, H, D = qd.shape
    KH = k.shape[2]
    G = H // KH
    scale = 1.0 / math.sqrt(D)
    qg = qd.reshape(E, cap, KH, G, D).float()
    s = torch.einsum("eckgd,eskd->eckgs", qg, k.float()) * scale
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1)
    o = torch.einsum("eckgs,eskd->eckgd", p, v.float())
    o = o / l.clamp_min(1e-37)[..., None]
    lse = m + torch.log(l.clamp_min(1e-37))
    valid = qmask.bool()[:, :, None, None]
    lse = torch.where(valid, lse, torch.full_like(lse, NEG_INF))
    out = torch.where(valid[..., None], o, torch.zeros_like(o))
    return out.reshape(E, cap, H, D).to(qd.dtype), lse.reshape(E, cap, H)


def decode_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         kv_len: torch.Tensor, window: int = 0
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Unique-KV decode GEMV. q: (B, H, D); k/v: (B, S, KH, D);
    kv_len: (B,). Returns (out (B, H, D) in q.dtype, lse (B, H) fp32).

    ``window > 0`` also masks positions before ``kv_len - window``
    (sliding-window archs), as the kernel does."""
    B, H, D = q.shape
    S, KH = k.shape[1], k.shape[2]
    G = H // KH
    scale = 1.0 / math.sqrt(D)
    qg = q.reshape(B, KH, G, D).float()
    s = torch.einsum("bkgd,bskd->bkgs", qg, k.float()) * scale
    pos = torch.arange(S, device=q.device)[None]
    lens = kv_len.to(q.device)[:, None]
    mask = pos < lens
    if window:
        mask &= pos >= lens - window
    s = torch.where(mask[:, None, None], s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1)
    o = torch.einsum("bkgs,bskd->bkgd", p, v.float())
    o = o / l.clamp_min(1e-37)[..., None]
    lse = m + torch.log(l.clamp_min(1e-37))
    return o.reshape(B, H, D).to(q.dtype), lse.reshape(B, H)


def shared_chunk_attention_q8_ref(qd: torch.Tensor, k: torch.Tensor,
                                  v: torch.Tensor, k_scale: torch.Tensor,
                                  v_scale: torch.Tensor, qmask: torch.Tensor
                                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``shared_chunk_attention_ref`` over an int8 store: k/v (E, C, KH, D)
    int8 are dequantized in fp32 with their (E, C, KH) f32 scales first.
    Returns (out in qd.dtype, lse fp32)."""
    kd = k.float() * k_scale.float()[..., None]
    vd = v.float() * v_scale.float()[..., None]
    return shared_chunk_attention_ref(qd, kd, vd, qmask)


def paged_decode_attention_ref(q: torch.Tensor, k_pool: torch.Tensor,
                               v_pool: torch.Tensor, table: torch.Tensor,
                               kv_len: torch.Tensor, window: int = 0
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Paged unique-KV decode: gather the pages ``table`` (B, M) names out
    of the pools (N, bs, KH, D) into a contiguous (B, M * bs, KH, D) view,
    then ``decode_attention_ref``. Returns (out (B, H, D) in q.dtype,
    lse (B, H) fp32)."""
    k = gather_layer(k_pool, table)
    v = gather_layer(v_pool, table)
    return decode_attention_ref(q, k, v, kv_len, window=window)


def lse_merge_ref(outs: torch.Tensor, lses: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Merge P partial attentions. outs: (P, N, H, D); lses: (P, N, H).
    Exact: equals softmax over the union of key sets. Returns
    (out (N, H, D) in outs.dtype, lse (N, H) fp32)."""
    lses = lses.float().clamp_min(NEG_INF)
    m = lses.amax(dim=0)
    w = torch.exp(lses - m[None])
    denom = w.sum(dim=0)
    out = (outs.float() * w[..., None]).sum(dim=0)
    out = out / denom.clamp_min(1e-37)[..., None]
    lse = torch.where(denom > 0, m + torch.log(denom.clamp_min(1e-37)),
                      torch.full_like(m, NEG_INF))
    return out.to(outs.dtype), lse


def lse_merge_pair_ref(o0: torch.Tensor, l0: torch.Tensor, o1: torch.Tensor,
                       l1: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``lse_merge_ref`` of the two partials stacked, o0 first. o0/o1:
    (N, H, D); l0/l1: (N, H)."""
    return lse_merge_ref(torch.stack([o0, o1]), torch.stack([l0, l1]))


def routed_partials(od: torch.Tensor, lsed: torch.Tensor, lin: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The dense partials of the K-chunk merge: partial k of group g is row
    ``lin[g, k]`` of od (R, Q, H, D) / lsed (R, Q, H), and a row outside
    [0, R) is empty (out 0, lse -1e30), as the reference's gather with
    ``mode="fill"``. Returns (outs (K, G * Q, H, D), lses (K, G * Q, H))."""
    R, Q, H, D = od.shape
    G, K = lin.shape
    keep = ((lin >= 0) & (lin < R)).reshape(-1)
    src = torch.where(keep, lin.reshape(-1), 0)
    o = torch.where(keep[:, None, None, None], od[src], 0)
    l = torch.where(keep[:, None, None], lsed[src], NEG_INF)
    outs = o.view(G, K, Q * H, D).transpose(0, 1).reshape(K, G * Q, H, D)
    lses = l.view(G, K, Q * H).transpose(0, 1).reshape(K, G * Q, H)
    return outs.contiguous(), lses.contiguous()


def lse_merge_routed_ref(od: torch.Tensor, lsed: torch.Tensor,
                         lin: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The K-chunk merge over the routed rows of od (R, Q, H, D) and
    lsed (R, Q, H), lin (G, K): ``lse_merge_ref`` of ``routed_partials``.
    Returns (out (G * Q, H, D) in od.dtype, lse (G * Q, H) fp32)."""
    return lse_merge_ref(*routed_partials(od, lsed, lin))


def router_scores_ref(q: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
    """q: (G, H, D); emb: (E, KH, D) -> (G, E) fp32 relevance scores: each
    q head scores its kv head's embedding, summed over heads, over √D."""
    G, H, D = q.shape
    E, KH, _ = emb.shape
    qg = q.reshape(G, KH, H // KH, D).float()
    return torch.einsum("gkhd,ekd->ge", qg, emb.float()) / math.sqrt(D)
