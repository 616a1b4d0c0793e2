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
#: the blocks of ``flash_prefill_attention_ref``'s loop, over queries and keys
FLASH_BLOCK = 1024


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


def shared_tail_attention_ref(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, first: torch.Tensor
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every row's attention over one shared tail of keys: q (N, H, D)
    against k/v (T, KH, D), row n seeing keys ``first[n]`` .. T - 1 (a
    sliding-window layer's view of the end of a shared document).
    Returns (out (N, H, D) in q.dtype, lse (N, H) fp32); a row that sees
    no key gets out 0 and lse -inf."""
    N, H, D = q.shape
    T, KH = k.shape[0], k.shape[1]
    G = H // KH
    scale = 1.0 / math.sqrt(D)
    qg = q.reshape(N, KH, G, D).float()
    s = torch.einsum("nkgd,tkd->nkgt", qg, k.float()) * scale
    seen = (torch.arange(T, device=q.device)[None]
            >= first.to(q.device).long()[:, None])                # (N, T)
    s = s.masked_fill(~seen[:, None, None], -math.inf)
    m = s.amax(dim=-1)
    any_ = seen.any(dim=1)[:, None, None]
    p = torch.exp(s - torch.where(any_, m, torch.zeros_like(m))[..., None])
    l = p.sum(dim=-1)
    o = torch.einsum("nkgt,tkd->nkgd", p, v.float())
    o = o / l.clamp_min(1e-37)[..., None]
    lse = torch.where(any_, m + torch.log(l.clamp_min(1e-37)),
                      torch.full_like(m, -math.inf))
    o = torch.where(any_[..., None], o, torch.zeros_like(o))
    return o.reshape(N, H, D).to(q.dtype), lse.reshape(N, H)


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


def flash_prefill_attention_ref(q: torch.Tensor, k: torch.Tensor,
                                v: torch.Tensor, causal: bool = True,
                                q_offset: int = 0, kv_offset: int = 0,
                                kv_len=None, window: int = 0,
                                block_q: int = FLASH_BLOCK,
                                block_k: int = FLASH_BLOCK
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Online-softmax attention blocked over queries and keys: the port's
    ``layers.flash_attention`` for every input the kernel does not take.

    q: (B, Sq, H, D); k/v: (B, Sk, KH, D). Same masks and arithmetic as
    the reference (finite -1e30 masking, p cast to v.dtype before PV,
    1e-37 clamps). The reference blocks only over keys; blocking over
    queries as well keeps the live score block at (B, H, block_q,
    block_k) fp32, so a 64K-token corpus prefill stays within a few GB.
    Key blocks that lie wholly after a query block's last position are
    skipped under causal masking: every row has already seen a valid key
    in the first block, so they would add exactly zero. Returns (out
    (B, Sq, H, D) in q.dtype, lse (B, Sq, H) fp32).
    """
    B, Sq, H, D = q.shape
    _, Sk, KH, _ = k.shape
    G = H // KH
    scale = 1.0 / math.sqrt(D)
    valid_len = Sk if kv_len is None else kv_len
    dev = q.device
    qg = q.reshape(B, Sq, KH, G, D)
    outs, lses = [], []
    for q0 in range(0, Sq, block_q):
        qb = qg[:, q0:q0 + block_q]
        nq = qb.shape[1]
        q_pos = q_offset + q0 + torch.arange(nq, device=dev)
        m = torch.full((B, KH, G, nq), NEG_INF, dtype=torch.float32,
                       device=dev)
        l = torch.zeros_like(m)
        acc = torch.zeros((B, KH, G, nq, D), dtype=torch.float32, device=dev)
        for k0 in range(0, Sk, block_k):
            if causal and kv_offset + k0 > q_offset + q0 + nq - 1:
                break
            kb = k[:, k0:k0 + block_k]
            vb = v[:, k0:k0 + block_k]
            nk = kb.shape[1]
            k_idx = k0 + torch.arange(nk, device=dev)
            k_pos = kv_offset + k_idx
            s = torch.einsum("bqkgd,bskd->bkgqs", qb.float(),
                             kb.float()) * scale
            if causal:
                mask = k_pos[None, :] <= q_pos[:, None]
            else:
                mask = torch.ones((nq, nk), dtype=torch.bool, device=dev)
            if window:
                mask &= k_pos[None, :] > (q_pos[:, None] - window)
            mask &= (k_idx < valid_len)[None, :]
            s = torch.where(mask, s, torch.full_like(s, NEG_INF))
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            pv = torch.einsum("bkgqs,bskd->bkgqd", p.to(vb.dtype).float(),
                              vb.float())
            acc = acc * corr[..., None] + pv
            m = m_new
        l_safe = l.clamp_min(1e-37)
        outs.append((acc / l_safe[..., None]).permute(0, 3, 1, 2, 4)
                    .reshape(B, nq, H, D))
        lses.append((m + torch.log(l_safe)).permute(0, 3, 1, 2)
                    .reshape(B, nq, H))
    return torch.cat(outs, dim=1).to(q.dtype), torch.cat(lses, dim=1)


def router_scores_ref(q: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
    """q: (G, H, D); emb: (E, KH, D) -> (G, E) fp32 relevance scores: each
    q head scores its kv head's embedding, summed over heads, over √D."""
    G, H, D = q.shape
    E, KH, _ = emb.shape
    qg = q.reshape(G, KH, H // KH, D).float()
    return torch.einsum("gkhd,ekd->ge", qg, emb.float()) / math.sqrt(D)
