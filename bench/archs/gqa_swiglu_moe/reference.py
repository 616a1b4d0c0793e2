"""Plain PyTorch reference of the served model and of MoSKA's attention.

It imports nothing of the program. It takes the benchmark's own weights
(the same bfloat16 tensors the program serves) and tokens, and works out
again everything the program derives from them: the corpus' keys and
values and its chunks' mean-key embeddings, each query group's top-k
chunks, the capacity dispatch with its drops, the attention over the
unique keys and the chosen chunks as one softmax, the SwiGLU or the
capacity-dropping MoE FFN, and the logits.

The model: pre-norm decoder, RMSNorm ``x * rsqrt(mean(x^2) + eps) * (1 +
scale)``, split-half RoPE at absolute positions (a request's positions
follow the corpus), grouped-query attention, SwiGLU, untied or tied
unembedding. The MoE FFN scores every row with a float32 router, takes
the top k by a stable descending sort, renormalises the gates, and keeps
a row's slot in an expert only while that expert has fewer than
``capacity`` earlier slots (rows in order, a row's k choices in order).

MoSKA: a prefill routes each block of ``min(128, bucket)`` prompt
positions by its mean query over the block's real positions; a decode
token routes by its own query. A group's chunk score is the sum over kv
heads of the kv head's summed query heads dotted with the chunk's mean
key; the top ``top_k_chunks`` chunks (stable sort) are chosen. In a decode
wave the groups are the batch's slots in order, and a chunk keeps at most
``capacity`` of them (the earlier slots win), where the capacity is the
program's configured ``ceil(G*K/E * cf)``, at least min(G, 8), rounded
up to 8 and at most G*K. A query attends its own earlier keys and every
key of its kept chunks, one softmax over all of them.

Precision: activations are float32 throughout, the matrix products run in
TF32 (operands rounded to 19 bits, far finer than the bfloat16 the program
computes in), RoPE angles are float64. ``precision="fp8"`` is the control:
every product's operands, and the queries, keys and values of attention,
are rounded to float8 e4m3 with a scale per row (weights: per output
column) first.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F

from moska_bench.reference import (chunk_capacity, first_slots, fp8_round,
                                   margin, moe_capacity, tf32, top_k)

ROUTE_BLOCK = 128
#: elements of a score block (queries x heads x keys) held at once
SCORE_BLOCK = 1 << 28
#: rows of a dense FFN computed at once
FFN_ROWS = 8192


class Store:
    """The reference's own store: per layer (E, C, KH, D) keys and values,
    and (E, KH, D) mean keys, float32."""

    def __init__(self, k: List[torch.Tensor], v: List[torch.Tensor],
                 chunk: int):
        self.chunk = chunk
        self.k = [t.view(-1, chunk, *t.shape[1:]) for t in k]
        self.v = [t.view(-1, chunk, *t.shape[1:]) for t in v]
        self.emb = [t.mean(dim=1) for t in self.k]

    @property
    def chunks(self) -> int:
        return self.k[0].shape[0]

    @property
    def tokens(self) -> int:
        return self.chunks * self.chunk


class Reference:
    def __init__(self, model: dict, weights: Dict[str, torch.Tensor],
                 precision: str = "tf32"):
        if precision not in ("tf32", "fp8"):
            raise ValueError(f"precision {precision!r}: tf32 | fp8")
        self.m = model
        self.w = weights
        self.fp8 = precision == "fp8"
        self.H, self.KH = model["num_heads"], model["num_kv_heads"]
        self.D = model["head_dim"]
        self.moe = model.get("moe")
        self.moska = model["moska"]
        self._layer = None
        self._fw: Dict[str, torch.Tensor] = {}
        self._begin(None)

    # -- operands --------------------------------------------------------
    def _W(self, name: str) -> torch.Tensor:
        """A weight in float32 (the control: rounded per output column);
        the current layer's are kept until the next layer starts."""
        if name not in self._fw:
            t = self.w[name].float()
            self._fw[name] = fp8_round(t, -2) if self.fp8 else t
        return self._fw[name]

    def _enter(self, i: int) -> None:
        if self._layer != i:
            self._fw.clear()
            self._layer = i

    def _mm(self, x: torch.Tensor, name: str) -> torch.Tensor:
        return (fp8_round(x, -1) if self.fp8 else x) @ self._W(name)

    def _act(self, t: torch.Tensor) -> torch.Tensor:
        """Attention operands (queries, keys, values) as the control holds
        them."""
        return fp8_round(t, -1) if self.fp8 else t

    def _norm(self, x: torch.Tensor, name: str) -> torch.Tensor:
        var = (x * x).mean(dim=-1, keepdim=True)
        return x * torch.rsqrt(var + self.m["rms_eps"]) * (
            1.0 + self.w[name].float())

    def _rope(self, x: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
        """x (N, heads, D) at absolute positions pos (N,)."""
        D = x.shape[-1]
        freqs = 1.0 / (self.m["rope_theta"] ** (
            torch.arange(0, D, 2, dtype=torch.float64, device=x.device) / D))
        ang = pos.double()[:, None] * freqs
        cos = torch.cos(ang).float()[:, None]
        sin = torch.sin(ang).float()[:, None]
        x1, x2 = x.chunk(2, dim=-1)
        return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)

    def _embed(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.w["embed"][tokens].float()

    def _qkv(self, i: int, x: torch.Tensor, pos: torch.Tensor):
        p = f"layers.{i}."
        h = self._norm(x, p + "ln1")
        N = x.shape[0]
        q = self._mm(h, p + "wq").view(N, self.H, self.D)
        k = self._mm(h, p + "wk").view(N, self.KH, self.D)
        v = self._mm(h, p + "wv").view(N, self.KH, self.D)
        return self._rope(q, pos), self._rope(k, pos), v

    def _ffn(self, i: int, x: torch.Tensor, capacity: Optional[int]
             ) -> torch.Tensor:
        p = f"layers.{i}."
        if not self.moe:
            out = []
            for a in range(0, x.shape[0], FFN_ROWS):
                xb = x[a:a + FFN_ROWS]
                g = F.silu(self._mm(xb, p + "w_gate")) * self._mm(
                    xb, p + "w_up")
                out.append(self._mm(g, p + "w_down"))
            return torch.cat(out)
        E, K = self.moe["num_experts"], self.moe["top_k"]
        logits = x @ self.w[p + "router"].float()
        self.expert_margin = margin(logits, K)
        probs = torch.softmax(logits, dim=-1)
        ids = self._choice("expert", i, logits, K)
        gates = probs.gather(-1, ids)
        gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
        keep = (first_slots(ids, E, capacity) if capacity is not None
                else torch.ones_like(ids, dtype=torch.bool))
        y = torch.zeros_like(x)
        flat, gflat, kflat = ids.reshape(-1), gates.reshape(-1), \
            keep.reshape(-1)
        wg, wu, wd = (self._W(p + n) for n in ("e_gate", "e_up", "e_down"))
        for e in range(E):
            slots = torch.nonzero((flat == e) & kflat).flatten()
            if slots.numel() == 0:
                continue
            rows = slots // K
            xe = x[rows]
            if self.fp8:
                xe = fp8_round(xe, -1)
            he = F.silu(xe @ wg[e]) * (xe @ wu[e])
            if self.fp8:
                he = fp8_round(he, -1)
            y.index_add_(0, rows, (he @ wd[e]) * gflat[slots, None])
        return y

    def _route(self, i: int, q: torch.Tensor, store: Store) -> torch.Tensor:
        """q (G, H, D) pooled queries -> (G, K) chosen chunks."""
        G = q.shape[0]
        folded = q.view(G, self.KH, -1, self.D).sum(dim=2)
        scores = torch.einsum("gkd,ekd->ge", folded, store.emb[i])
        K = min(self.moska["top_k_chunks"], store.chunks)
        self.route_margin = margin(scores, K)
        return self._choice("route", i, scores, K)

    def _choice(self, kind: str, i: int, scores: torch.Tensor, k: int
                ) -> torch.Tensor:
        """The top-k ids of ``scores`` (G, E), or, where the caller forced
        layer i's choices of this kind, those (their first G rows), with
        how far they fall short of the reference's own top k: the k-th
        best score less the worst chosen one, over the row's standard
        deviation (0 when the sets agree), kept as the largest so far."""
        forced = (self.forced or {}).get(kind)
        if forced is None:
            ids = top_k(scores, k)[1]
        else:
            ids = forced[i][:scores.shape[0]].to(scores.device).long()
            kth = torch.sort(scores, dim=-1, descending=True).values[:, k - 1]
            worst = scores.gather(-1, ids).min(dim=-1).values
            short = ((kth - worst) / scores.std(dim=-1).clamp_min(1e-30))
            self.regret[kind] = max(self.regret[kind],
                                    float(short.clamp_min(0).max()))
        self.chosen[kind].append(ids)
        return ids

    def _attend(self, q, ku, vu, lim, ks, vs, mask_s) -> torch.Tensor:
        """One softmax over unique and shared keys for N queries q (N, H,
        D). ku/vu: (M, KH, D) common to all queries or (N, M, KH, D) one
        set each; query n attends unique rows below ``lim[n]``. ks/vs:
        (E*C, KH, D) the flat store with mask_s (N, E*C), or None."""
        N, H, D = q.shape
        G = H // self.KH
        scale = 1.0 / math.sqrt(D)
        common = ku.dim() == 3
        sub = "mkd" if common else "nmkd"
        out = []
        a = 0
        while a < N:
            keys = ku.shape[-3] + (0 if ks is None else ks.shape[0])
            step = max(1, SCORE_BLOCK // (H * keys))
            b = min(N, a + step)
            M = int(lim[a:b].max())
            kb = ku[:M] if common else ku[a:b, :M]
            vb = vu[:M] if common else vu[a:b, :M]
            qb = self._act(q[a:b]).view(-1, self.KH, G, D)
            kb, vb = self._act(kb), self._act(vb)
            s = torch.einsum(f"nkgd,{sub}->nkgm", qb, kb)
            m_u = (torch.arange(M, device=q.device)[None, :]
                   < lim[a:b, None])
            parts = [s.masked_fill(~m_u[:, None, None], -math.inf)]
            if ks is not None:
                ss = torch.einsum("nkgd,mkd->nkgm", qb, self._act(ks))
                parts.append(ss.masked_fill(~mask_s[a:b, None, None],
                                            -math.inf))
            p = torch.softmax(torch.cat(parts, dim=-1) * scale, dim=-1)
            o = torch.einsum(f"nkgm,{sub}->nkgd", p[..., :M], vb)
            if ks is not None:
                o = o + torch.einsum("nkgm,mkd->nkgd", p[..., M:],
                                     self._act(vs))
            out.append(o.reshape(-1, H, D))
            a = b
        return torch.cat(out)

    def _out(self, i: int, x, o, capacity) -> torch.Tensor:
        p = f"layers.{i}."
        x = x + self._mm(o.reshape(o.shape[0], -1), p + "wo")
        return x + self._ffn(i, self._norm(x, p + "ln2"), capacity)

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        h = self._norm(x, "final_norm")
        u = self.w.get("unembed", self.w["embed"]).float()
        if self.fp8:
            h, u = fp8_round(h, -1), fp8_round(u, -1)
        return h @ u.T

    # -- a whole sequence ----------------------------------------------
    @torch.no_grad()
    def _begin(self, forced: Optional[dict]) -> None:
        self.forced = forced
        self.chosen = {"route": [], "expert": []}
        self.regret = {"route": 0.0, "expert": 0.0}

    def sequence(self, tokens: Sequence[int], start: int, prompt_len: int,
                 bucket: int, store: Optional[Store] = None,
                 logits_from: Optional[int] = None, keep_kv: bool = False,
                 forced: Optional[dict] = None):
        """One request (or the corpus) through every layer.

        ``tokens``: its prompt of ``prompt_len`` tokens, then the tokens it
        was served but the last; position ``j`` is ``start + j``. The
        prompt is prefilled as in a bucket of ``bucket`` positions (its
        route blocks and its MoE capacity); each later token is a decode
        step of its own (routed alone; no other row shares its capacity).
        ``forced``: per kind ("route", "expert") the program's choices of
        a prompt-only prefill, layer by layer, followed and judged
        (``regret``). Returns (logits of positions ``logits_from`` on, or
        None; per layer (k, v) of every position if ``keep_kv``)."""
        self._begin(forced)
        dev = self.w["embed"].device
        tok = torch.as_tensor(list(tokens), dtype=torch.long, device=dev)
        S, p = tok.numel(), prompt_len
        pos = start + torch.arange(S, device=dev)
        x = self._embed(tok)
        causal = torch.arange(1, S + 1, device=dev)
        cap = (moe_capacity(bucket, self.moe["top_k"],
                            self.moe["num_experts"],
                            self.moe["capacity_factor"])
               if self.moe else None)
        kvs = []
        self.margins = {"route": torch.full((S,), math.inf, device=dev),
                        "expert": torch.full((S,), math.inf, device=dev)}
        with tf32():
            for i in range(self.m["num_layers"]):
                self._enter(i)
                q, k, v = self._qkv(i, x, pos)
                if keep_kv:
                    kvs.append((k, v))
                ks = vs = mask_s = None
                if store is not None:
                    mask_s = self._chunk_mask(i, q, p, bucket, store)
                    ks = store.k[i].reshape(-1, self.KH, self.D)
                    vs = store.v[i].reshape(-1, self.KH, self.D)
                o = self._attend(q, k, v, causal, ks, vs, mask_s)
                if self.moe and S > p:
                    parts, em = [self._out(i, x[:p], o[:p], cap)], [
                        self.expert_margin]
                    for j in range(p, S):
                        parts.append(self._out(i, x[j:j + 1], o[j:j + 1],
                                               None))
                        em.append(self.expert_margin)
                    x = torch.cat(parts)
                    self._low("expert", torch.cat(em))
                else:
                    x = self._out(i, x, o, cap)
                    if self.moe:
                        self._low("expert", self.expert_margin)
            logits = (self._logits(x[logits_from:])
                      if logits_from is not None else None)
        self._enter(None)
        return logits, kvs

    def _low(self, kind: str, m: torch.Tensor) -> None:
        """Keep, per position (or slot), the nearest tie of any choice that
        it depended on directly."""
        self.margins[kind] = torch.minimum(self.margins[kind], m)

    def _chunk_mask(self, i: int, q: torch.Tensor, p: int, bucket: int,
                    store: Store) -> torch.Tensor:
        """(S, E*C) keys of the chunks each position's group chose."""
        S = q.shape[0]
        rb = min(ROUTE_BLOCK, bucket)
        blocks = -(-p // rb)
        groups = [q[b * rb:min((b + 1) * rb, p)].mean(dim=0)
                  for b in range(blocks)]
        pooled = torch.stack(groups + [q[j] for j in range(p, S)])
        ids = self._route(i, pooled, store)
        sel = torch.zeros(pooled.shape[0], store.chunks, dtype=torch.bool,
                          device=q.device)
        sel.scatter_(1, ids, True)
        group_of = torch.cat([
            torch.arange(p, device=q.device) // rb,
            blocks + torch.arange(S - p, device=q.device)])
        self._low("route", self.route_margin[group_of])
        return sel[group_of].repeat_interleave(store.chunk, dim=1)

    @torch.no_grad()
    def corpus(self, tokens: Sequence[int]) -> Store:
        """The corpus prefilled alone (no store): its keys and values,
        chunked, with their mean keys."""
        n = len(tokens)
        _, kvs = self.sequence(tokens, 0, n, n, keep_kv=True)
        C = self.moska["chunk_size"]
        return Store([k for k, _ in kvs], [v for _, v in kvs], C)

    @torch.no_grad()
    def first_kv(self, tokens: torch.Tensor, positions: torch.Tensor):
        """Layer 0's keys and values of ``tokens`` at ``positions``: what a
        cache's first layer holds for them, whatever else the batch did."""
        self._enter(0)
        with tf32():
            _, k, v = self._qkv(0, self._embed(tokens.long()), positions)
        self._enter(None)
        return k, v

    # -- one decode wave of the whole batch -----------------------------
    @torch.no_grad()
    def wave(self, tokens: torch.Tensor, positions: torch.Tensor,
             lengths: torch.Tensor, cache_k: torch.Tensor,
             cache_v: torch.Tensor, store: Optional[Store] = None,
             forced: Optional[dict] = None):
        """The batch's decode step from the unique keys and values that
        earlier steps left: slot b feeds ``tokens[b]`` at ``positions[b]``
        and attends rows ``[0, lengths[b])`` of ``cache_k[i, b]`` (a
        layer's (B, S, KH, D) rows, the program's state) and its own new
        key, which takes row ``lengths[b]``. ``forced``: the choices to
        follow and judge, as for ``sequence``; the choices made either way
        are left in ``chosen``. Returns (logits (B, V), per layer the new
        (k, v) (B, KH, D))."""
        self._begin(forced)
        B = tokens.numel()
        S = cache_k.shape[2]
        dev = tokens.device
        x = self._embed(tokens.long())
        cap = (moe_capacity(B, self.moe["top_k"], self.moe["num_experts"],
                            self.moe["capacity_factor"])
               if self.moe else None)
        new = []
        self.margins = {"route": torch.full((B,), math.inf, device=dev),
                        "expert": torch.full((B,), math.inf, device=dev)}
        with tf32():
            for i in range(self.m["num_layers"]):
                self._enter(i)
                q, k, v = self._qkv(i, x, positions)
                new.append((k, v))
                ks = vs = mask_s = None
                if store is not None:
                    ids = self._route(i, q, store)
                    self._low("route", self.route_margin)
                    K = ids.shape[1]
                    keep = first_slots(ids, store.chunks, chunk_capacity(
                        B, K, store.chunks,
                        self.moska["query_capacity_factor"]))
                    sel = torch.zeros(B, store.chunks, dtype=torch.bool,
                                      device=dev)
                    sel.scatter_(1, ids, keep)
                    mask_s = sel.repeat_interleave(store.chunk, dim=1)
                    ks = store.k[i].reshape(-1, self.KH, self.D)
                    vs = store.v[i].reshape(-1, self.KH, self.D)
                o = []
                step = max(1, SCORE_BLOCK // (self.H * S) // 4)
                for a in range(0, B, step):
                    b = slice(a, a + step)
                    n = min(step, B - a)
                    # copies: the program's rows are only read
                    ku = cache_k[i, b].to(torch.float32, copy=True)
                    vu = cache_v[i, b].to(torch.float32, copy=True)
                    at = torch.arange(n, device=dev)
                    ku[at, lengths[b]] = k[b]
                    vu[at, lengths[b]] = v[b]
                    o.append(self._attend(
                        q[b], ku, vu, lengths[b] + 1, ks, vs,
                        None if mask_s is None else mask_s[b]))
                x = self._out(i, x, torch.cat(o), cap)
                if self.moe:
                    self._low("expert", self.expert_margin)
            logits = self._logits(x)
        self._enter(None)
        return logits, new
