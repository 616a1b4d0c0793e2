"""Plain reference of the afmoe architecture (arcee-ai's Trinity models):
the full forward pass of one token sequence, in float32, written from the
model's equations with no cache, no batching, no store and no kernel.

It imports nothing of the port and nothing of JAX. The CPU tests hold the
port's prefill and decode over a shared document (``repro_torch``'s store,
tail and routed chunks) against this forward over document + prompt + fed
tokens.

The equations (Hugging Face transformers ``models/afmoe/modeling_afmoe.py``
and the published ``config.json``):

- x = embed[tokens] * sqrt(d_model) (``mup_enabled``);
- per layer: h = RMSNorm_in(x); q = h Wq, k = h Wk, v = h Wv in heads of
  D; q and k each RMS-normed over D (``q_norm``, ``k_norm``); RoPE
  (split-half) on sliding layers only, none on full layers; softmax of
  q.k / sqrt(D) over the causal keys, a sliding layer's query at P
  seeing keys j with P - j < window; GQA; o = attn * sigmoid(h Wg); x =
  x + RMSNorm_post_attn(o Wo); then x = x + RMSNorm_post_mlp(FFN(
  RMSNorm_pre_mlp(x)));
- FFN: a SwiGLU on the first ``num_dense_layers``; after them the MoE:
  s = sigmoid(x Wr), the top k experts by s + expert_bias, weights the
  chosen s over their sum (+1e-20) times ``route_scale``, FFN(x) =
  shared(x) + sum_e w_e expert_e(x), every expert and the shared one a
  SwiGLU;
- logits = RMSNorm_final(x) Wu^T (untied).

RMSNorm is x * rsqrt(mean(x^2) + eps) * w. Departures, each noted: TF32 is
off for every product (``torch.backends`` flags set here); RoPE angles
are computed in float64; the MoE has no capacity (every chosen expert
takes its token), so a program that drops tokens by capacity matches only
where it drops none; ``full_visible`` lets a full layer's queries see only
the document chunks a MoSKA router chose for them (the program's choices,
handed in), and is off by default (every key visible).
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps) * w


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """x (S, heads, D) at positions pos (S,), split-half rotation."""
    D = x.shape[-1]
    freqs = 1.0 / theta ** (torch.arange(0, D, 2, dtype=torch.float64) / D)
    ang = pos.double()[:, None] * freqs
    cos, sin = torch.cos(ang).float()[:, None], torch.sin(ang).float()[:, None]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def swiglu(x, gate, up, down):
    return (F.silu(x @ gate) * (x @ up)) @ down


class AfmoeReference:
    """``spec``: num_layers, d_model, num_heads, num_kv_heads, head_dim,
    vocab_size, rope_theta, rms_eps, layer_types ("sliding" | "full" per
    layer), sliding_window, num_dense_layers, num_experts, top_k,
    route_norm, route_scale, mup_enabled. ``w``: float32 tensors named
    ``embed``, ``unembed``, ``final_norm`` and per layer ``layers.{i}.``
    ``input_norm``, ``q_proj``, ``k_proj``, ``v_proj``, ``gate_proj`` (all
    (d, out), applied as x @ W), ``o_proj``, ``q_norm``, ``k_norm``,
    ``post_attn_norm``, ``pre_mlp_norm``, ``post_mlp_norm``, and either
    ``mlp.gate``/``mlp.up``/``mlp.down`` or ``router`` (d, E),
    ``expert_bias`` (E,), ``experts.gate``/``experts.up`` (E, d, f),
    ``experts.down`` (E, f, d) and ``shared.gate``/``shared.up``/
    ``shared.down``."""

    def __init__(self, spec: dict, w: Dict[str, torch.Tensor]):
        self.s = spec
        self.w = {k: t.float() for k, t in w.items()}

    def _attention(self, i: int, h: torch.Tensor, pos: torch.Tensor,
                   visible: Optional[torch.Tensor]) -> torch.Tensor:
        s, w, p = self.s, self.w, f"layers.{i}."
        S = h.shape[0]
        H, KH, D = s["num_heads"], s["num_kv_heads"], s["head_dim"]
        eps = s["rms_eps"]
        q = rms_norm((h @ w[p + "q_proj"]).view(S, H, D), w[p + "q_norm"], eps)
        k = rms_norm((h @ w[p + "k_proj"]).view(S, KH, D), w[p + "k_norm"],
                     eps)
        v = (h @ w[p + "v_proj"]).view(S, KH, D)
        sliding = s["layer_types"][i] == "sliding"
        if sliding:
            q, k = rope(q, pos, s["rope_theta"]), rope(k, pos, s["rope_theta"])
        k = k.repeat_interleave(H // KH, dim=1)
        v = v.repeat_interleave(H // KH, dim=1)
        scores = torch.einsum("qhd,khd->hqk", q, k) / math.sqrt(D)
        qi = pos[:, None]
        kj = pos[None, :]
        mask = kj <= qi
        if sliding:
            mask &= qi - kj < s["sliding_window"]
        elif visible is not None:
            mask &= visible
        scores = scores.masked_fill(~mask[None], -math.inf)
        o = torch.einsum("hqk,khd->qhd", torch.softmax(scores, dim=-1), v)
        o = o.reshape(S, H * D) * torch.sigmoid(h @ w[p + "gate_proj"])
        return o @ w[p + "o_proj"]

    def _ffn(self, i: int, x: torch.Tensor) -> torch.Tensor:
        s, w, p = self.s, self.w, f"layers.{i}."
        if i < s["num_dense_layers"]:
            return swiglu(x, w[p + "mlp.gate"], w[p + "mlp.up"],
                          w[p + "mlp.down"])
        scores = torch.sigmoid(x @ w[p + "router"])
        _, ids = torch.topk(scores + w[p + "expert_bias"], s["top_k"], dim=-1)
        wts = scores.gather(-1, ids)
        if s["route_norm"]:
            wts = wts / (wts.sum(dim=-1, keepdim=True) + 1e-20)
        wts = wts * s["route_scale"]
        y = swiglu(x, w[p + "shared.gate"], w[p + "shared.up"],
                   w[p + "shared.down"])
        for n in range(x.shape[0]):
            for j in range(s["top_k"]):
                e = int(ids[n, j])
                y[n] += wts[n, j] * swiglu(
                    x[n], w[p + "experts.gate"][e], w[p + "experts.up"][e],
                    w[p + "experts.down"][e])
        return y

    @torch.no_grad()
    def forward(self, tokens: List[int],
                full_visible: Optional[Dict[int, torch.Tensor]] = None
                ) -> torch.Tensor:
        """Logits (S, V) of every position. ``full_visible``: per full
        layer i, an (S, S) bool mask of the keys each query may see besides
        causality (the program's routed chunks), or None."""
        s, w = self.s, self.w
        tok = torch.as_tensor(tokens, dtype=torch.long)
        pos = torch.arange(tok.numel())
        x = w["embed"][tok]
        if s["mup_enabled"]:
            x = x * math.sqrt(s["d_model"])
        eps = s["rms_eps"]
        for i in range(s["num_layers"]):
            p = f"layers.{i}."
            vis = (full_visible or {}).get(i)
            a = self._attention(i, rms_norm(x, w[p + "input_norm"], eps), pos,
                                vis)
            x = x + rms_norm(a, w[p + "post_attn_norm"], eps)
            y = self._ffn(i, rms_norm(x, w[p + "pre_mlp_norm"], eps))
            x = x + rms_norm(y, w[p + "post_mlp_norm"], eps)
        return rms_norm(x, w["final_norm"], eps) @ w["unembed"].T
