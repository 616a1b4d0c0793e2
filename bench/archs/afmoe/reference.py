"""Plain PyTorch reference of the served afmoe model (arcee-ai's Trinity)
and of MoSKA's attention over its layers.

It imports nothing of the program. It takes the benchmark's own weights
(the same bfloat16 tensors the program serves) and tokens, and works out
again everything the program derives from them: the document's keys and
values (a full layer's chunks with their mean keys, a sliding layer's
tail), each full layer's top-k chunks, the experts with their capacity
drops, the attention over the unique keys, the tail and the chosen
chunks as one softmax, and the logits.

The model (the equations of ``tests/afmoe_reference.py``): embeddings
times ``embed_scale``; per layer h = RMSNorm_in(x), q, k, v, each q and k
head RMS-normed over D, split-half RoPE at absolute positions on sliding
layers only (a request's positions follow the document), softmax over the
keys a query sees (a sliding layer's query at P: keys j with P - j <
window), o times sigmoid(h Wg), x += RMSNorm(o Wo), x += RMSNorm(FFN(
RMSNorm(x))). The first ``num_dense_layers`` take a SwiGLU; the others
score every row with sigmoid(x Wr) in float32, take the top k by score
plus ``expert_bias`` (stable descending sort), weigh them by the chosen
scores over their sum (+1e-20) times ``route_scale``, keep a row's slot
in an expert only while that expert has fewer than ``capacity`` earlier
slots (rows in order, a row's k choices in order), and add the shared
expert. RMSNorm is ``x * rsqrt(mean(x^2) + eps) * (1 + scale)``.

MoSKA: a full layer routes as the dense block's reference does (a prefill
by blocks of ``min(128, bucket)`` prompt positions, each by its mean
query over its real positions; a decode token by its own query; a chunk's
score the kv heads' folded queries dotted with its mean key; the top
``top_k_chunks``; in a decode wave a chunk keeps at most the configured
capacity of the batch's slots, the earlier slots winning). A sliding
layer never routes: its queries see the document's last window - 1 keys,
the tail, each from the first key its window reaches.

Precision: activations float32 throughout, products in TF32, RoPE angles
in float64; a weight is widened to float32 one expert or one block of the
vocabulary at a time, so that the reference fits beside the program's
weights and cache. ``precision="fp8"`` is the control: every product's
operands, and the queries, keys and values of attention, are rounded to
float8 e4m3 with a scale per row (weights: per output column) first.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F

from moska_bench.reference import (chunk_capacity, first_slots, fp8_round,
                                   margin, moe_capacity, tf32, top_k)

ROUTE_BLOCK = 128
#: elements of a score block (queries x heads x keys) held at once: 256 MiB
#: of float32, so that a few of them fit beside the program's 52 GB of
#: weights and 17 GB of cache, which the judge keeps
SCORE_BLOCK = 1 << 26
#: rows of a dense FFN, and of the vocabulary, computed at once
ROWS = 8192


class Store:
    """The reference's own store, float32: per layer (E, C, KH, D) keys and
    values and (E, KH, D) mean keys: a full layer's chunks, a sliding
    layer's one tail of its last ``window - 1`` keys."""

    def __init__(self, k: List[torch.Tensor], v: List[torch.Tensor],
                 chunk: int, tokens: int):
        self.chunk, self.tokens = chunk, tokens
        self.k, self.v = k, v
        self.emb = [t.mean(dim=1) for t in k]

    @property
    def chunks(self) -> int:
        return self.tokens // self.chunk


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
        self.moe = model["moe"]
        self.moska = model["moska"]
        self.windows = list(model["layer_windows"])
        self.full = [i for i, w in enumerate(self.windows) if not w]
        self._layer = None
        self._fw: Dict[str, torch.Tensor] = {}
        self._begin(None)

    # -- operands --------------------------------------------------------
    def _round_w(self, t: torch.Tensor) -> torch.Tensor:
        t = t.float()
        return fp8_round(t, -2) if self.fp8 else t

    def _W(self, name: str) -> torch.Tensor:
        """A weight in float32 (the control: rounded per output column);
        the current layer's are kept until the next layer starts."""
        if name not in self._fw:
            self._fw[name] = self._round_w(self.w[name])
        return self._fw[name]

    def _enter(self, i) -> None:
        if self._layer != i:
            self._fw.clear()
            self._layer = i

    def _x(self, x: torch.Tensor) -> torch.Tensor:
        return fp8_round(x, -1) if self.fp8 else x

    def _mm(self, x: torch.Tensor, name: str) -> torch.Tensor:
        return self._x(x) @ self._W(name)

    def _act(self, t: torch.Tensor) -> torch.Tensor:
        """Attention operands (queries, keys, values) as the control holds
        them."""
        return fp8_round(t, -1) if self.fp8 else t

    def _norm(self, x: torch.Tensor, name: str) -> torch.Tensor:
        var = (x * x).mean(dim=-1, keepdim=True)
        return (x * torch.rsqrt(var + self.m["rms_eps"])).mul_(
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
        return self.w["embed"][tokens].float() * self.m["embed_scale"]

    def _qkv(self, i: int, x: torch.Tensor, pos: torch.Tensor):
        """q, k, v of layer i and its output gate sigmoid(h Wg)."""
        p = f"layers.{i}."
        h = self._norm(x, p + "ln1")
        N = x.shape[0]
        q = self._norm(self._mm(h, p + "wq").view(N, self.H, self.D),
                       p + "q_norm")
        k = self._norm(self._mm(h, p + "wk").view(N, self.KH, self.D),
                       p + "k_norm")
        v = self._mm(h, p + "wv").view(N, self.KH, self.D)
        if self.windows[i]:
            q, k = self._rope(q, pos), self._rope(k, pos)
        return q, k, v, torch.sigmoid(self._mm(h, p + "wg"))

    def _swiglu(self, x, gate, up, down) -> torch.Tensor:
        x = self._x(x)
        return self._x(F.silu(x @ gate) * (x @ up)) @ down

    def _ffn(self, i: int, x: torch.Tensor, capacity: Optional[int]
             ) -> torch.Tensor:
        p = f"layers.{i}."
        if i < self.m["num_dense_layers"]:
            return torch.cat([self._swiglu(
                x[a:a + ROWS], self._W(p + "w_gate"), self._W(p + "w_up"),
                self._W(p + "w_down")) for a in range(0, x.shape[0], ROWS)])
        E, K = self.moe["num_experts"], self.moe["top_k"]
        scores = torch.sigmoid(x @ self.w[p + "router"].float())
        pick = scores + self.w[p + "expert_bias"].float()
        self.expert_margin = margin(pick, K)
        ids = self._choice("expert", i - self.m["num_dense_layers"], pick, K)
        gates = scores.gather(-1, ids)
        if self.moe["route_norm"]:
            gates = gates / (gates.sum(-1, keepdim=True) + 1e-20)
        gates = gates * self.moe["route_scale"]
        keep = (first_slots(ids, E, capacity) if capacity is not None
                else torch.ones_like(ids, dtype=torch.bool))
        y = torch.cat([self._swiglu(
            x[a:a + ROWS], self._W(p + "sh_gate"), self._W(p + "sh_up"),
            self._W(p + "sh_down")) for a in range(0, x.shape[0], ROWS)])
        # the kept slots grouped by expert (one read of the counts a layer)
        flat, gflat = ids.reshape(-1), gates.reshape(-1)
        kept = torch.nonzero(keep.reshape(-1)).flatten()
        kept = kept[torch.argsort(flat[kept], stable=True)]
        counts = torch.bincount(flat[kept], minlength=E).tolist()
        a = 0
        for e, n in enumerate(counts):
            if n == 0:
                continue
            slots = kept[a:a + n]
            a += n
            rows = slots // K
            ye = self._swiglu(x[rows], *(self._round_w(self.w[p + n][e])
                                         for n in ("e_gate", "e_up",
                                                   "e_down")))
            y.index_add_(0, rows, ye * gflat[slots, None])
        return y

    def _route(self, i: int, q: torch.Tensor, store: Store) -> torch.Tensor:
        """q (G, H, D) pooled queries -> (G, K) chosen chunks."""
        G = q.shape[0]
        folded = q.view(G, self.KH, -1, self.D).sum(dim=2)
        scores = torch.einsum("gkd,ekd->ge", folded, store.emb[i])
        K = min(self.moska["top_k_chunks"], store.chunks)
        self.route_margin = margin(scores, K)
        return self._choice("route", self.full.index(i), scores, K)

    def _choice(self, kind: str, idx: int, scores: torch.Tensor, k: int
                ) -> torch.Tensor:
        """The top-k ids of ``scores`` (G, E), or, where the caller forced
        this kind's choices, the program's ``idx``-th call's (its first G
        rows: the full layers' routes and the MoE layers' experts in
        layer order), with how far they fall short of the reference's own
        top k: the k-th best score less the worst chosen one, over the
        row's standard deviation (0 when the sets agree), the largest so
        far."""
        forced = (self.forced or {}).get(kind)
        if forced is None:
            ids = top_k(scores, k)[1]
        else:
            ids = forced[idx][:scores.shape[0]].to(scores.device).long()
            kth = torch.sort(scores, dim=-1, descending=True).values[:, k - 1]
            worst = scores.gather(-1, ids).min(dim=-1).values
            short = ((kth - worst) / scores.std(dim=-1).clamp_min(1e-30))
            self.regret[kind] = max(self.regret[kind],
                                    float(short.clamp_min(0).max()))
        self.chosen[kind].append(ids)
        return ids

    def _attend(self, q, ku, vu, lo, hi, ks=None, vs=None, mask_s=None
                ) -> torch.Tensor:
        """One softmax over unique and shared keys for N queries q (N, H,
        D). ku/vu: (M, KH, D) common to all queries or (N, M, KH, D) one
        set each; query n attends unique rows [lo[n], hi[n]). ks/vs: (Ks,
        KH, D) shared keys with mask_s (N, Ks), or None."""
        N, H, D = q.shape
        G = H // self.KH
        scale = 1.0 / math.sqrt(D)
        common = ku.dim() == 3
        # a block of rows reads at most its rows' widest range of unique
        # keys plus the block's length (a band), and every shared key
        width = int((hi - lo).max()) + (0 if ks is None else ks.shape[0])
        step = max(1, SCORE_BLOCK // (H * max(width, 1)) // 2)
        out = []
        a = 0
        while a < N:
            b = min(N, a + step)
            k0, k1 = int(lo[a:b].min()), int(hi[a:b].max())
            kb = ku[k0:k1] if common else ku[a:b, k0:k1]
            vb = vu[k0:k1] if common else vu[a:b, k0:k1]
            sub = "mkd" if common else "nmkd"
            qb = self._act(q[a:b]).view(-1, self.KH, G, D)
            kb, vb = self._act(kb), self._act(vb)
            s = torch.einsum(f"nkgd,{sub}->nkgm", qb, kb)
            idx = torch.arange(k0, k1, device=q.device)[None, :]
            m_u = (idx >= lo[a:b, None]) & (idx < hi[a:b, None])
            s.masked_fill_(~m_u[:, None, None], -math.inf)
            if ks is not None:
                ss = torch.einsum("nkgd,mkd->nkgm", qb, self._act(ks))
                ss.masked_fill_(~mask_s[a:b, None, None], -math.inf)
                s = torch.cat([s, ss], dim=-1)
                del ss
            p = torch.softmax(s.mul_(scale), dim=-1)
            del s
            M = k1 - k0
            o = torch.einsum(f"nkgm,{sub}->nkgd", p[..., :M], vb)
            if ks is not None:
                o = o + torch.einsum("nkgm,mkd->nkgd", p[..., M:],
                                     self._act(vs))
            out.append(o.reshape(-1, H, D))
            a = b
        return torch.cat(out)

    def _attn_out(self, i: int, x, o, gate) -> torch.Tensor:
        """x plus the gated attention's normed output projection."""
        a = self._mm(o.reshape(o.shape[0], -1) * gate, f"layers.{i}.wo")
        return x + self._norm(a, f"layers.{i}.post_attn")

    def _ffn_out(self, i: int, x, capacity) -> torch.Tensor:
        p = f"layers.{i}."
        y = self._ffn(i, self._norm(x, p + "ln2"), capacity)
        return x + self._norm(y, p + "post_mlp")

    def _out(self, i: int, x, o, gate, capacity) -> torch.Tensor:
        return self._ffn_out(i, self._attn_out(i, x, o, gate), capacity)

    def _attn_rows(self, i: int, x, pos, lo, hi):
        """Layer i's attention half for a sequence on its own (the
        document, no store), ``ROWS`` queries at a time so that only the
        keys and values are held whole: returns (k, v, x plus the
        attention's output)."""
        p = f"layers.{i}."
        h = self._norm(x, p + "ln1")
        N = x.shape[0]
        k = self._norm(self._mm(h, p + "wk").view(N, self.KH, self.D),
                       p + "k_norm")
        v = self._mm(h, p + "wv").view(N, self.KH, self.D)
        if self.windows[i]:
            k = self._rope(k, pos)
        out = torch.empty_like(x)
        for a in range(0, N, ROWS):
            b = slice(a, a + ROWS)
            n = x[b].shape[0]
            q = self._norm(self._mm(h[b], p + "wq").view(n, self.H, self.D),
                           p + "q_norm")
            if self.windows[i]:
                q = self._rope(q, pos[b])
            o = self._attend(q, k, v, lo[b], hi[b])
            out[b] = self._attn_out(i, x[b], o, torch.sigmoid(
                self._mm(h[b], p + "wg")))
        return k, v, out

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        h = self._x(self._norm(x, "final_norm"))
        u = self.w["unembed"]
        return torch.cat([h @ self._x(u[a:a + ROWS].float()).T
                          for a in range(0, u.shape[0], ROWS)], dim=-1)

    def _tail_mask(self, i: int, pos: torch.Tensor, store: Store
                   ) -> torch.Tensor:
        """(N, T) which tail keys each query at ``pos`` sees: tail key j
        lies at position tokens - T + j, inside the window when pos - that
        < window."""
        T = store.k[i].shape[1]
        kpos = store.tokens - T + torch.arange(T, device=pos.device)
        return (pos[:, None] - kpos[None, :]) < self.windows[i]

    # -- a whole sequence ----------------------------------------------
    def _begin(self, forced: Optional[dict]) -> None:
        self.forced = forced
        self.chosen = {"route": [], "expert": []}
        self.regret = {"route": 0.0, "expert": 0.0}

    @torch.no_grad()
    def sequence(self, tokens: Sequence[int], start: int, prompt_len: int,
                 bucket: int, store: Optional[Store] = None,
                 logits_from: Optional[int] = None, keep_kv: bool = False,
                 forced: Optional[dict] = None, keep=None):
        """One request (or the document) through every layer.

        ``tokens``: its prompt of ``prompt_len`` tokens, then the tokens it
        was served but the last; position ``j`` is ``start + j``. The
        prompt is prefilled as in a bucket of ``bucket`` positions (its
        route blocks and its MoE capacity); each later token is a decode
        step of its own (routed alone; no other row shares its capacity).
        ``forced``: per kind ("route", "expert") the program's choices of
        a prompt-only prefill, call by call, followed and judged
        (``regret``). ``keep``: per layer, which rows of its (k, v) to
        return (default all, with ``keep_kv``). Returns (logits of
        positions ``logits_from`` on, or None; per layer (k, v) if
        ``keep_kv``)."""
        self._begin(forced)
        dev = self.w["embed"].device
        tok = torch.as_tensor(list(tokens), dtype=torch.long, device=dev)
        S, p = tok.numel(), prompt_len
        pos = start + torch.arange(S, device=dev)
        x = self._embed(tok)
        idx = torch.arange(S, device=dev)
        cap = moe_capacity(bucket, self.moe["top_k"],
                           self.moe["num_experts"],
                           self.moe["capacity_factor"])
        kvs = []
        self.margins = {"route": torch.full((S,), math.inf, device=dev),
                        "expert": torch.full((S,), math.inf, device=dev)}
        with tf32():
            for i in range(self.m["num_layers"]):
                self._enter(i)
                w = self.windows[i]
                lo = (idx - w + 1).clamp_min(0) if w else torch.zeros_like(
                    idx)
                if store is None:
                    k, v, x = self._attn_rows(i, x, pos, lo, idx + 1)
                else:
                    q, k, v, gate = self._qkv(i, x, pos)
                    if w:
                        ks, vs = store.k[i][0], store.v[i][0]
                        mask_s = self._tail_mask(i, pos, store)
                    else:
                        mask_s = self._chunk_mask(i, q, p, bucket, store)
                        ks = store.k[i].reshape(-1, self.KH, self.D)
                        vs = store.v[i].reshape(-1, self.KH, self.D)
                    o = self._attend(q, k, v, lo, idx + 1, ks, vs, mask_s)
                    x = self._attn_out(i, x, o, gate)
                    del q, o, gate, mask_s
                if keep_kv:
                    rows = slice(None) if keep is None else keep(i)
                    kvs.append((k[rows], v[rows]))
                del k, v
                moe = i >= self.m["num_dense_layers"]
                if moe and S > p:
                    parts = [self._ffn_out(i, x[:p], cap)]
                    em = [self.expert_margin]
                    for j in range(p, S):
                        parts.append(self._ffn_out(i, x[j:j + 1], None))
                        em.append(self.expert_margin)
                    x = torch.cat(parts)
                    self._low("expert", torch.cat(em))
                else:
                    x = self._ffn_out(i, x, cap)
                    if moe:
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
        """The document prefilled alone (no store): a full layer's keys and
        values, chunked, and a sliding layer's last ``window - 1``."""
        n = len(tokens)
        tails = {i: min(w - 1, n) for i, w in enumerate(self.windows) if w}
        _, kvs = self.sequence(tokens, 0, n, n, keep_kv=True,
                               keep=lambda i: slice(n - tails[i], n)
                               if i in tails else slice(None))
        C = self.moska["chunk_size"]
        ks = [k.view(1 if i in tails else -1, -1 if i in tails else C,
                     *k.shape[1:]) for i, (k, _) in enumerate(kvs)]
        vs = [v.view(1 if i in tails else -1, -1 if i in tails else C,
                     *v.shape[1:]) for i, (_, v) in enumerate(kvs)]
        return Store(ks, vs, C, n)

    @torch.no_grad()
    def first_kv(self, tokens: torch.Tensor, positions: torch.Tensor):
        """Layer 0's keys and values of ``tokens`` at ``positions``: what a
        cache's first layer holds for them, whatever else the batch did."""
        self._enter(0)
        with tf32():
            _, k, v, _ = self._qkv(0, self._embed(tokens.long()), positions)
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
        layer's (B, S, KH, D) rows, the program's state; a sliding layer
        those inside its window) and its own new key, which takes row
        ``lengths[b]``. ``forced``: the choices to follow and judge, as
        for ``sequence``; the choices made either way are left in
        ``chosen``. Returns (logits (B, V), per layer the new (k, v) (B,
        KH, D))."""
        self._begin(forced)
        B = tokens.numel()
        S = cache_k.shape[2]
        dev = tokens.device
        x = self._embed(tokens.long())
        cap = moe_capacity(B, self.moe["top_k"], self.moe["num_experts"],
                           self.moe["capacity_factor"])
        new = []
        self.margins = {"route": torch.full((B,), math.inf, device=dev),
                        "expert": torch.full((B,), math.inf, device=dev)}
        with tf32():
            for i in range(self.m["num_layers"]):
                self._enter(i)
                q, k, v, gate = self._qkv(i, x, positions)
                new.append((k, v))
                w = self.windows[i]
                ks = vs = mask_s = None
                if store is not None and w:
                    ks, vs = store.k[i][0], store.v[i][0]
                    mask_s = self._tail_mask(i, positions, store)
                elif store is not None:
                    ids = self._route(i, q, store)
                    self._low("route", self.route_margin)
                    K = ids.shape[1]
                    kept = first_slots(ids, store.chunks, chunk_capacity(
                        B, K, store.chunks,
                        self.moska["query_capacity_factor"]))
                    sel = torch.zeros(B, store.chunks, dtype=torch.bool,
                                      device=dev)
                    sel.scatter_(1, ids, kept)
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
                    hi = lengths[b] + 1
                    lo = (hi - w).clamp_min(0) if w else torch.zeros_like(hi)
                    o.append(self._attend(
                        q[b], ku, vu, lo, hi, ks, vs,
                        None if mask_s is None else mask_s[b]))
                x = self._out(i, x, torch.cat(o), gate, cap)
                if i >= self.m["num_dense_layers"]:
                    self._low("expert", self.expert_margin)
            logits = self._logits(x)
        self._enter(None)
        return logits, new
