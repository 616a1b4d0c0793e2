"""The one traffic generator: a closed loop of clients drawn from a mix file.

A mix file (``bench/traffic/<name>.json``) holds only parameters:

  clients         concurrent clients, each with one request in flight
  max_seq         the engine's slot length (prompt + output must fit)
  corpus_tokens   length of the shared document registered in set-up
                  (0: no document, every request is unshared)
  prompt_tokens   [lo, hi] range of the unique prompt, log-uniform
  output_tokens   [lo, hi] range of the output, log-uniform
  warm_waves      decode waves run after the batch is full, before the
                  window opens
  profile_waves   waves of the window that a ``--trace 1`` run profiles
  check_requests  finished requests the reference judges after the window
  order           optional: "fixed" (the default) or "seeded"

Lengths are the quantiles ``(i + 0.5) / n`` of their law, stratified per
block of ``clients`` requests and shuffled within the block, so the first
block, which fills the batch, reaches every prefill bucket of the range.
Under ``"fixed"`` every seed serves them in the same order, shuffled by a
fixed schedule (``SCHEDULE``), and the seed draws only the token ids (and
the weights): the work of a run does not change with its seed. (When the
seed also drew the order, the tails moved by 8-18 % from seed to seed
against 1-5 % between two runs of one seed: in a closed loop the order
decides which completions, and so which admissions, fall into one wave.)
Under ``"seeded"`` the seed draws the order within each block as well.

The first ``clients`` requests are pre-aged: their output lengths follow
the residual life of the output law (a client met at a random moment is
part-way through a request), so completions are staggered from the start.
"""
from __future__ import annotations

import json
import math
from dataclasses import dataclass
from pathlib import Path
from typing import List

import numpy as np
import torch

#: the seed of the lengths' order under ``"fixed"``, the same for every run
SCHEDULE = 20251018
KEYS = ("clients", "max_seq", "corpus_tokens", "prompt_tokens",
        "output_tokens", "warm_waves", "profile_waves", "check_requests")
ORDERS = ("fixed", "seeded")


@dataclass(frozen=True)
class Mix:
    name: str
    clients: int
    max_seq: int
    corpus_tokens: int
    prompt_tokens: tuple
    output_tokens: tuple
    warm_waves: int
    profile_waves: int
    check_requests: int
    order: str = "fixed"

    @property
    def shared(self) -> bool:
        return self.corpus_tokens > 0


def load_mix(path: Path) -> Mix:
    """Read a mix file; every key of ``KEYS`` must be there."""
    raw = json.loads(Path(path).read_text())
    missing = [k for k in KEYS if k not in raw]
    if missing:
        raise ValueError(f"{path}: traffic keys missing: {missing}")
    mix = Mix(name=Path(path).stem, order=raw.get("order", "fixed"),
              **{k: raw[k] for k in KEYS})
    if mix.order not in ORDERS:
        raise ValueError(f"{path}: order {mix.order!r} is not one of "
                         f"{ORDERS}")
    lo, hi = mix.prompt_tokens
    olo, ohi = mix.output_tokens
    if not (1 <= lo <= hi and 1 <= olo <= ohi):
        raise ValueError(f"{path}: bad length ranges")
    if hi + ohi > mix.max_seq:
        raise ValueError(f"{path}: prompt {hi} + output {ohi} exceeds "
                         f"max_seq {mix.max_seq}")
    return mix


def log_uniform_quantiles(lo: int, hi: int, n: int) -> np.ndarray:
    """Integer lengths at the quantiles (i + 0.5) / n of a log-uniform law
    on [lo, hi]."""
    u = (np.arange(n) + 0.5) / n
    x = np.exp(math.log(lo) + u * (math.log(hi + 1) - math.log(lo)))
    return np.clip(np.floor(x), lo, hi).astype(np.int64)


def residual_quantiles(lo: int, hi: int, n: int) -> np.ndarray:
    """Lengths at the quantiles (i + 0.5) / n of the residual life of a
    log-uniform law on [lo, hi]: density proportional to P(L >= r)."""
    r = np.arange(1, hi + 1, dtype=np.float64)
    surv = np.where(r <= lo, 1.0,
                    (math.log(hi + 1) - np.log(r)) /
                    (math.log(hi + 1) - math.log(lo)))
    cdf = np.cumsum(surv) / surv.sum()
    u = (np.arange(n) + 0.5) / n
    return (np.searchsorted(cdf, u) + 1).astype(np.int64)


@dataclass
class Traffic:
    """What one run serves: the corpus and the stream of requests."""
    corpus: np.ndarray            # (corpus_tokens,) int32; empty if none
    prompts: List[List[int]]      # request i's prompt
    outputs: np.ndarray           # request i's max_new_tokens


def generate(mix: Mix, vocab: int, seed: int, pool: int,
             device: torch.device) -> Traffic:
    """``pool`` requests (a multiple of ``clients`` is used) and the corpus.
    Token ids are uniform over the vocabulary, drawn from ``seed`` on
    ``device`` in two calls; the lengths' order is the fixed schedule's
    or, under ``"seeded"``, drawn from ``seed``."""
    B = mix.clients
    blocks = max(1, -(-pool // B))
    rng = np.random.Generator(np.random.PCG64(
        SCHEDULE if mix.order == "fixed" else seed))
    plens = log_uniform_quantiles(*mix.prompt_tokens, B)
    outs = log_uniform_quantiles(*mix.output_tokens, B)
    first = residual_quantiles(*mix.output_tokens, B)
    p_all, o_all = [], []
    for b in range(blocks):
        p_all.append(rng.permutation(plens))
        o_all.append(rng.permutation(first if b == 0 else outs))
    plen = np.concatenate(p_all)
    out = np.concatenate(o_all)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    corpus = torch.randint(0, vocab, (mix.corpus_tokens,), generator=gen,
                           device=device, dtype=torch.int32)
    ids = torch.randint(0, vocab, (len(plen), mix.prompt_tokens[1]),
                        generator=gen, device=device, dtype=torch.int32)
    ids = ids.cpu().numpy()
    prompts = [ids[i, :n].tolist() for i, n in enumerate(plen)]
    return Traffic(corpus.cpu().numpy(), prompts, out)
