"""How ``correct`` is decided: what the timed path produced, judged by the
configuration's plain reference (``bench/archs/<arch>/reference.py``) once
the window has closed.

The numbers (the cell's ``bench/limits/<cell>.json`` names those it
compares; every number is printed):

  served_gap        the widest gap, in logits, by which a served token's
                    reference logit lies below the reference's best at its
                    position, over a sample of requests finished in the
                    window (the longest in it), each teacher-forced alone:
                    every token they were served, or, in a batch-coupled
                    cell, their first tokens only;
  served_gap_mean,  the mean of those gaps, and the share of those tokens
  served_miss_pct   that are not the reference's first choice;
  wave_gap, ...     the same over one decode wave of the whole batch, run
                    after the window in a batch-coupled cell, and the
                    first tokens of its admissions;
  route_regret,     in that wave, how far the program's chunk and expert
  expert_regret     choices fall short of the reference's own top k (the
                    k-th best score less the worst chosen, in standard
                    deviations of the row's scores; 0 when they agree);
  store_err(_p90)   the registered store against the reference's own
                    corpus prefill: the largest relative error (Frobenius,
                    or the 90th percentile over tokens) of a layer's keys,
                    values or mean keys;
  cache_err(_p90)   the same of the keys and values the checked wave
                    appended, of its admissions' prompt rows, and of
                    layer 0's rows of every slot's history (its prompt
                    and every token earlier steps fed it), which no
                    other slot's choices touch.

A cell is batch-coupled where a decode step's outputs depend on the other
slots (the layout's ``batch_coupled``): an MoE FFN's expert capacity, or a
chunk capacity below the batch (``store_coupled``).
There the wave is recomputed from the program's own unique-KV rows (its
state), following the chunk and expert choices the program made
(``capture.py``, at the program's ``CHOICES``) and judging them by their
regret: a near-tied top-k
choice flips between any two arithmetics, and under a capacity it moves
every later slot's place, so a recomputation with its own choices would
disagree with a sound program on many tokens. What that skips is checked
apart: the store, the admissions' prompt rows and first tokens, the
wave's own appended rows, and layer 0's rows of every earlier step: they
hold the tokens each slot was fed, at their positions, and follow from
the weights alone. (The deeper layers' rows of earlier steps hang on
capacity drops in batches that are gone; the wave reads them as its
state.)

The control (``control=True``) puts the reference in the program's place
at float8 precision, with its own store and its own choices; the
reference follows those choices to judge its tokens and rows.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

NUMBERS = ("served_gap", "served_gap_mean", "served_miss_pct", "wave_gap",
           "wave_gap_mean", "wave_miss_pct", "route_regret", "expert_regret",
           "store_err", "store_err_p90", "cache_err", "cache_err_p90")
#: prompt rows checked in a batch-coupled wave
PROMPT_ROW_SLOTS = 4
#: requests whose first token a batch-coupled cell judges, per request
#: of ``check_requests``
FIRST_TOKENS_PER_REQUEST = 8


def prefill_bucket(n: int, max_seq: int) -> int:
    """The engine's "auto" prefill bucket of an n-token prompt: powers of
    two from 16 to 128, then multiples of 128 up to max_seq."""
    b = 16
    while b <= min(max_seq, 128):
        if b >= n:
            return b
        b *= 2
    b = 256
    while b <= max_seq:
        if b >= n:
            return b
        b += 128
    return n


def store_coupled(model: dict, chunks: int) -> bool:
    """Whether, with a store of ``chunks`` chunks, a decode step's chunk
    capacity ``ceil(G*K/E*cf)`` can fall below its G slots, which happens
    exactly when K*cf < E: then a slot's attention depends on the others."""
    ms = model["moska"]
    k = min(ms["top_k_chunks"], chunks)
    return chunks > 0 and k * ms["query_capacity_factor"] < chunks


def relerr(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.float(), b.float()
    return float(torch.linalg.vector_norm(a - b)
                 / torch.linalg.vector_norm(b).clamp_min(1e-30))


def row_p90(a: torch.Tensor, b: torch.Tensor) -> float:
    """The 90th percentile over tokens (the leading dims but the last two)
    of each token's relative error: robust to the few tokens whose near-
    tied expert or chunk choice went the other way, not to an error that
    touches many."""
    a = a.float().flatten(0, -3).flatten(1)
    b = b.float().flatten(0, -3).flatten(1)
    e = torch.linalg.vector_norm(a - b, dim=1) / torch.linalg.vector_norm(
        b, dim=1).clamp_min(1e-30)
    return float(torch.quantile(e.cpu(), 0.9))


def gaps(ref_logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Per row: the reference's best logit minus its logit of ``tokens``."""
    best = ref_logits.max(dim=-1).values
    return best - ref_logits.gather(-1, tokens[:, None].long())[:, 0]


@dataclass
class Served:
    """A request as the judge needs it."""
    prompt: List[int]
    served: List[int]


@dataclass
class WaveState:
    """One decode wave of the whole batch: per slot the token fed, the
    rows before it, the token served; the program's cache after it."""
    tokens: torch.Tensor         # (B,)
    lengths: torch.Tensor        # (B,) rows before the wave
    served: torch.Tensor         # (B,)
    #: per slot the tokens of its rows before the wave: its prompt, then
    #: every token it was fed (a slot admitted in the wave: its prompt)
    rows: List[List[int]]
    cache_k: torch.Tensor        # (L, B, S, KH, D)
    cache_v: torch.Tensor
    #: the decode step's chunk and expert ids, per kind and layer
    choices: Dict[str, List[torch.Tensor]]
    #: each slot admitted in the wave: its prefill's ids
    admitted: Dict[int, Dict[str, List[torch.Tensor]]]


@dataclass
class Verdict:
    numbers: Dict[str, float] = field(default_factory=dict)
    control: Dict[str, float] = field(default_factory=dict)
    detail: Dict[str, float] = field(default_factory=dict)
    _gaps: Dict[str, list] = field(default_factory=dict)
    ties: list = field(default_factory=list)

    def put(self, key: str, value: float, control: Optional[float],
            part: str) -> None:
        self.numbers[key] = max(self.numbers.get(key, 0.0), value)
        self.detail[part] = max(self.detail.get(part, 0.0), value)
        if control is not None:
            self.control[key] = max(self.control.get(key, 0.0), control)
            self.detail["control." + part] = max(
                self.detail.get("control." + part, 0.0), control)

    def gaps(self, kind: str, g: torch.Tensor,
             control: Optional[torch.Tensor], part: str,
             margins: Optional[Dict[str, torch.Tensor]] = None) -> None:
        """The gaps of judged tokens of a kind ("served": requests judged
        one at a time; "wave": the checked wave), and of the control's at
        the same positions, with the reference's nearest tie of a chunk or
        expert choice each token depended on."""
        self._gaps.setdefault(kind, []).append(g.float().cpu())
        if margins is not None:
            self.ties.append(torch.stack([g.float().cpu()] + [
                margins[k].float().cpu() for k in ("route", "expert")], 1))
        if control is not None:
            self._gaps.setdefault("control." + kind, []).append(
                control.float().cpu())
        self.put(f"{kind}_gap", float(g.max()),
                 None if control is None else float(control.max()), part)

    def finish(self) -> "Verdict":
        """Per kind, the mean gap and the share of judged tokens that are
        not the reference's first choice, from every gap kept; and how near
        to a tie the tokens with the widest gaps stood against the rest."""
        for key, g in self._gaps.items():
            out, kind = ((self.control, key[8:]) if key.startswith(
                "control.") else (self.numbers, key))
            g = torch.cat(g)
            out[f"{kind}_gap_mean"] = float(g.mean())
            out[f"{kind}_miss_pct"] = 100.0 * float((g > 0).float().mean())
            if out is self.numbers:
                self.detail[f"{kind}_tokens"] = float(g.numel())
        if self.ties:
            t = torch.cat(self.ties)
            tie = torch.minimum(t[:, 1], t[:, 2])
            wide = t[:, 0] > 0.1
            self.detail["tie_median_all"] = float(tie.median())
            if wide.any():
                self.detail["tie_median_gap_over_0.1"] = float(
                    tie[wide].median())
                self.detail["tokens_gap_over_0.1"] = float(wide.sum())
        return self

    def widest(self, n: int = 8) -> List[List[float]]:
        """The n widest gaps, each with the nearest route and expert tie
        (in standard deviations of the scores) of its token."""
        if not self.ties:
            return []
        t = torch.cat(self.ties)
        top = torch.argsort(t[:, 0], descending=True)[:n]
        return t[top].tolist()


def pick(requests: List[Served], n: int, seed: int) -> List[Served]:
    """A sample of n drawn from the seed, with the longest request in it."""
    if len(requests) <= n:
        return list(requests)
    longest = max(range(len(requests)),
                  key=lambda i: len(requests[i].prompt)
                  + len(requests[i].served))
    rng = np.random.Generator(np.random.PCG64(seed))
    rest = [i for i in rng.permutation(len(requests)) if i != longest]
    return [requests[i] for i in [longest] + rest[:n - 1]]


def judge(reference, model: dict, weights: Dict[str, torch.Tensor],
          max_seq: int, corpus: Optional[np.ndarray], program_store,
          sample: List[Served], wave: Optional[WaveState], coupled: bool,
          control: bool = False) -> Verdict:
    """Every number, and with ``control`` the control's.

    ``reference``: the architecture's ``Reference`` class, built as
    ``reference(model, weights, precision)`` ("tf32", or "fp8" for the
    control). The judge calls its ``corpus(tokens)`` (a store of
    per-layer ``k``, ``v``, ``emb`` and its ``tokens``), ``sequence``,
    ``wave`` and ``first_kv``, and reads its ``margins`` (per kind of
    choice, each position's nearest tie), ``regret`` and ``chosen``."""
    ref = reference(model, weights, "tf32")
    low = reference(model, weights, "fp8") if control else None
    v = Verdict()
    store = low_store = None
    start = 0
    if corpus is not None:
        store = ref.corpus(corpus.tolist())
        start = store.tokens
        if low is not None:
            low_store = low.corpus(corpus.tolist())
        for i in range(model["num_layers"]):
            for name, mine, theirs, other in (
                    ("k", program_store.k[i], store.k[i],
                     low_store and low_store.k[i]),
                    ("v", program_store.v[i], store.v[i],
                     low_store and low_store.v[i]),
                    ("emb", program_store.emb[i], store.emb[i],
                     low_store and low_store.emb[i])):
                v.put("store_err", relerr(mine, theirs),
                      None if other is None else relerr(other, theirs),
                      f"store_{name}")
                if name != "emb":
                    v.put("store_err_p90", row_p90(mine, theirs),
                          None if other is None else row_p90(other, theirs),
                          f"store_{name}_p90")
    dev = next(iter(weights.values())).device
    for r in sample:
        p = len(r.prompt)
        bucket = prefill_bucket(p, max_seq)
        fed = r.prompt if coupled else r.prompt + r.served[:-1]
        served = torch.as_tensor(r.served[:len(fed) - p + 1], device=dev)
        logits, _ = ref.sequence(fed, start, p, bucket, store,
                                 logits_from=p - 1)
        lo = None
        if low is not None:
            lo_logits, _ = low.sequence(fed, start, p, bucket, low_store,
                                        logits_from=p - 1)
            lo = gaps(logits, lo_logits.argmax(-1))
        judged = slice(p - 1, len(fed))
        v.gaps("served", gaps(logits, served), lo,
               "first_gap" if coupled else "request_gap",
               {k: m[judged] for k, m in ref.margins.items()})
    if wave is not None:
        _judge_wave(v, ref, low, wave, store, low_store, start, max_seq)
        _judge_history(v, ref, low, wave, start)
    return v.finish()


def _judge_history(v: Verdict, ref, low, wave: WaveState, start: int
                   ) -> None:
    """Layer 0's rows of every slot before the wave against the reference's
    own from the slot's tokens (and the control's against the reference's):
    the relative error over all of them, and its 90th percentile over rows.
    """
    dev = wave.tokens.device
    sums = {}
    rows = {}

    def add(name, mine, theirs):
        d = (mine.float() - theirs).flatten(1)
        e = torch.linalg.vector_norm(d, dim=1)
        n = torch.linalg.vector_norm(theirs.flatten(1), dim=1)
        a, b = sums.get(name, (0.0, 0.0))
        sums[name] = (a + float((e * e).sum()), b + float((n * n).sum()))
        rows.setdefault(name, []).append((e / n.clamp_min(1e-30)).cpu())

    for b, toks in enumerate(wave.rows):
        n = len(toks)
        t = torch.as_tensor(toks, device=dev)
        pos = start + torch.arange(n, device=dev)
        k, val = ref.first_kv(t, pos)
        add("k", wave.cache_k[0, b, :n], k)
        add("v", wave.cache_v[0, b, :n], val)
        if low is not None:
            lk, lv = low.first_kv(t, pos)
            add("control.k", lk, k)
            add("control.v", lv, val)
    for name in ("k", "v"):
        ctl = f"control.{name}" in sums

        def err(key):
            a, b = sums[key]
            return math.sqrt(a) / max(math.sqrt(b), 1e-30)

        def p90(key):
            return float(torch.quantile(torch.cat(rows[key]), 0.9))
        v.put("cache_err", err(name),
              err(f"control.{name}") if ctl else None, f"history_{name}")
        v.put("cache_err_p90", p90(name),
              p90(f"control.{name}") if ctl else None,
              f"history_{name}_p90")


def _judge_wave(v: Verdict, ref, low, wave: WaveState, store, low_store,
                start: int, max_seq: int) -> None:
    """The checked wave, following the program's chunk and expert choices
    (judged by ``route_regret``, ``expert_regret``); the control makes its
    own, and the reference follows those to judge its tokens and rows."""
    positions = start + wave.lengths
    args = (wave.tokens, positions, wave.lengths, wave.cache_k,
            wave.cache_v)
    forced = {k: x for k, x in wave.choices.items() if x}
    logits, new = ref.wave(*args, store, forced=forced)
    regret, margins = dict(ref.regret), ref.margins
    lo = lo_new = lo_regret = None
    if low is not None:
        lo_logits, lo_new = low.wave(*args, low_store)
        c_logits, c_new = ref.wave(*args, store, forced=low.chosen)
        lo = gaps(c_logits, lo_logits.argmax(-1))
        lo_regret = dict(ref.regret)
        lo_new = [(lo_new[i], c_new[i]) for i in range(len(new))]
    v.gaps("wave", gaps(logits, wave.served), lo, "wave_gap", margins)
    for kind in forced:
        v.put(f"{kind}_regret", regret[kind],
              None if lo_regret is None else lo_regret[kind],
              f"{kind}_regret")
    B = wave.tokens.numel()
    at = torch.arange(B, device=wave.tokens.device)
    for i, (k, val) in enumerate(new):
        for name, mine, theirs, j in (
                ("k", wave.cache_k[i, at, wave.lengths], k, 0),
                ("v", wave.cache_v[i, at, wave.lengths], val, 1)):
            other = base = None
            if lo_new is not None:
                other, base = lo_new[i][0][j], lo_new[i][1][j]
            v.put("cache_err", relerr(mine, theirs),
                  None if other is None else relerr(other, base),
                  f"append_{name}")
            v.put("cache_err_p90", row_p90(mine, theirs),
                  None if other is None else row_p90(other, base),
                  f"append_{name}_p90")
    dev = wave.tokens.device
    for b, choices in list(wave.admitted.items())[:PROMPT_ROW_SLOTS]:
        prompt = wave.rows[b]
        p = len(prompt)
        bucket = prefill_bucket(p, max_seq)
        forced = {k: x for k, x in choices.items() if x}
        first = torch.as_tensor([int(wave.tokens[b])], device=dev)
        logits, kv = ref.sequence(prompt, start, p, bucket, store,
                                  logits_from=p - 1, keep_kv=True,
                                  forced=forced)
        regret = dict(ref.regret)
        lo_kv = lo = lo_regret = None
        if low is not None:
            lo_logits, lo_kv = low.sequence(prompt, start, p, bucket,
                                            low_store, logits_from=p - 1,
                                            keep_kv=True)
            c_logits, c_kv = ref.sequence(prompt, start, p, bucket, store,
                                          logits_from=p - 1, keep_kv=True,
                                          forced=low.chosen)
            lo = gaps(c_logits, lo_logits.argmax(-1))
            lo_regret = dict(ref.regret)
            lo_kv = [(lo_kv[i], c_kv[i]) for i in range(len(kv))]
        v.gaps("wave", gaps(logits, first), lo, "wave_first_gap")
        for kind in forced:
            v.put(f"{kind}_regret", regret[kind],
                  None if lo_regret is None else lo_regret[kind],
                  f"prefill_{kind}_regret")
        for i, (k, val) in enumerate(kv):
            for name, mine, theirs, j in (
                    ("k", wave.cache_k[i, b, :p], k, 0),
                    ("v", wave.cache_v[i, b, :p], val, 1)):
                other = base = None
                if lo_kv is not None:
                    other, base = lo_kv[i][0][j], lo_kv[i][1][j]
                v.put("cache_err", relerr(mine, theirs),
                      None if other is None else relerr(other, base),
                      f"prompt_{name}")
                v.put("cache_err_p90", row_p90(mine, theirs),
                      None if other is None else row_p90(other, base),
                      f"prompt_{name}_p90")


def verdict_lines(numbers: Dict[str, float], limits: Dict[str, float]
                  ) -> Dict[str, Dict[str, float]]:
    """Each number compared (those the cell's limits name) beside its
    limit, in a fixed order."""
    return {k: {"value": numbers[k], "limit": limits[k]}
            for k in NUMBERS if k in limits and k in numbers}


def passes(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every number the limits name was computed, is finite and is within
    its limit."""
    unknown = [k for k in limits if k not in NUMBERS]
    if unknown:
        raise KeyError(f"limits for numbers the judge has not: {unknown}")
    return all(k in numbers and math.isfinite(numbers[k])
               and numbers[k] <= lim for k, lim in limits.items())
