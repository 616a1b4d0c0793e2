"""Shared building blocks: norms, RoPE, attention, SwiGLU/GeGLU/GELU MLPs.

Port of the reference ``models/layers.py``. Parameters are mappings
(``nn.ParameterDict`` or plain dicts of tensors) with the reference names.
Activations keep the parameter dtype with fp32 softmax/norm accumulation.
``decode_attention`` and ``merge_partial_attention`` go through the
hand-written kernels (``repro_torch.kernels.ops``); ``flash_attention`` is
plain PyTorch, as the reference's is jnp code.
"""
from __future__ import annotations

import functools
import math
from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils import checkpoint as ckpt

from repro_torch.kernels import ops

DEFAULT_BLOCK_K = 1024
DEFAULT_BLOCK_Q = 1024
NEG_INF = -1e30


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float())).to(x.dtype)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def swiglu_mlp(x: torch.Tensor, p) -> torch.Tensor:
    h = F.silu(x @ p["w_gate"]) * (x @ p["w_up"])
    return h @ p["w_down"]


def geglu_mlp(x: torch.Tensor, p) -> torch.Tensor:
    return (gelu(x @ p["w_gate"]) * (x @ p["w_up"])) @ p["w_down"]


def gelu_mlp(x: torch.Tensor, p) -> torch.Tensor:
    return gelu(x @ p["w_up"]) @ p["w_down"]


def unembed(x: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """fp32 logits (..., V) of hidden states (..., d) over a (V, d) table:
    the reference's ``preferred_element_type=float32`` unembedding."""
    return x.float() @ table.float().T


def causal_conv(x: torch.Tensor, w: torch.Tensor,
                b: torch.Tensor) -> torch.Tensor:
    """Causal depthwise conv over (B, S, C) with a (W, C) kernel and a (C,)
    bias: W - 1 zeros padded in front, the taps summed in order."""
    W, S = w.shape[0], x.shape[1]
    pad = F.pad(x, (0, 0, W - 1, 0))
    return sum(pad[:, i:i + S] * w[i][None, None]
               for i in range(W)) + b[None, None]


def rope_freqs(head_dim: int, theta: float,
               device: Optional[torch.device] = None) -> torch.Tensor:
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=device) / head_dim
    return 1.0 / (theta ** exponent)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: (..., seq). Split-half
    rotation (not interleaved)."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)
    angles = positions[..., :, None].float() * freqs
    cos = torch.cos(angles)[..., :, None, :]
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def qkv_project(x: torch.Tensor, p, num_heads: int, num_kv_heads: int,
                head_dim: int
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if "bq" in p:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    lead = x.shape[:-1]
    return (q.reshape(*lead, num_heads, head_dim),
            k.reshape(*lead, num_kv_heads, head_dim),
            v.reshape(*lead, num_kv_heads, head_dim))


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, q_offset: int = 0,
                    kv_offset: int = 0, kv_len=None, window: int = 0,
                    block_k: int = DEFAULT_BLOCK_K,
                    block_q: int = DEFAULT_BLOCK_Q,
                    return_lse: bool = False):
    """Online-softmax attention blocked over queries and keys.

    q: (B, Sq, H, D); k/v: (B, Sk, KH, D). Same masks and arithmetic as
    the reference (finite -1e30 masking, p cast to v.dtype before PV,
    1e-37 clamps). The reference blocks only over keys; blocking over
    queries as well keeps the live score block at (B, H, block_q,
    block_k) fp32, so a 64K-token corpus prefill stays within a few GB.
    Key blocks that lie wholly after a query block's last position are
    skipped under causal masking: every row has already seen a valid key
    in the first block, so they would add exactly zero.
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
    out = torch.cat(outs, dim=1).to(q.dtype)
    if return_lse:
        return out, torch.cat(lses, dim=1)
    return out


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, kv_len: torch.Tensor, *,
                     window: int = 0, return_lse: bool = False):
    """Single-token decode attention over the per-request (unique) cache:
    the paper's memory-bound GEMV path, through the ``decode_attention``
    kernel. q: (B, H, D); caches (B, S, KH, D); kv_len: (B,) int32."""
    out, lse = ops.decode_attention(q, k_cache, v_cache, kv_len,
                                    window=window)
    return (out, lse) if return_lse else out


def merge_partial_attention(outs, lses):
    """Exact merge of flash-decoding partials, through the ``lse_merge``
    kernel: lists of (..., H, D) outs and (..., H) lses. Two partials (the
    unique and the shared one of a MoSKA layer) go to its pair entry,
    which reads them where they lie; other counts are stacked."""
    shape = outs[0].shape
    o = [x.reshape(-1, *shape[-2:]).contiguous() for x in outs]
    l = [x.reshape(-1, shape[-2]).float().contiguous() for x in lses]
    if len(o) == 2:
        out, lse = ops.lse_merge_pair(o[0], l[0], o[1], l[1])
    else:
        out, lse = ops.lse_merge(torch.stack(o), torch.stack(l))
    return out.reshape(shape), lse.reshape(shape[:-1])


# ---------------------------------------------------------------------------
# training: rematerialization
# ---------------------------------------------------------------------------

#: matmuls without batch dimensions (JAX's
#: ``dots_with_no_batch_dims_saveable``): ``x @ W`` runs as ``mm``, while
#: attention's and the experts' batched products run as ``bmm``
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return (ckpt.CheckpointPolicy.MUST_SAVE if op in _DOTS
            else ckpt.CheckpointPolicy.PREFER_RECOMPUTE)


def remat(fn: Callable, policy: str = "nothing") -> Callable:
    """``fn`` under activation checkpointing: ``"nothing"`` saves only its
    inputs and recomputes the rest in the backward pass, ``"dots"`` also
    keeps the outputs of its unbatched matmuls, ``"none"`` returns ``fn``
    as it is (the reference's ``jax.checkpoint`` policies)."""
    if policy == "none":
        return fn
    if policy == "nothing":
        context_fn = ckpt.noop_context_fn
    elif policy == "dots":
        context_fn = functools.partial(
            ckpt.create_selective_checkpoint_contexts, _save_dots)
    else:
        raise ValueError(f"remat policy {policy!r}: nothing | dots | none")

    def wrapped(*args):
        return ckpt.checkpoint(fn, *args, use_reentrant=False,
                               context_fn=context_fn)
    return wrapped
