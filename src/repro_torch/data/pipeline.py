"""Synthetic shared corpora for MoSKA serving.

A copy of the corpus half of the reference data pipeline: long token
streams whose KV is precomputed into SharedKVStores (the paper's
"domain-specific documents"). Zipfian tokens with local structure so
routing is non-degenerate (chunks have distinguishable key statistics).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class CorpusSpec:
    corpus_id: str
    num_tokens: int
    vocab_size: int
    seed: int = 0
    zipf_a: float = 1.2


def synthesize_corpus(spec: CorpusSpec) -> np.ndarray:
    """Zipfian tokens with drifting local bigram flavour per 1K segment."""
    rng = np.random.default_rng(spec.seed)
    n = spec.num_tokens
    base = rng.zipf(spec.zipf_a, size=n).astype(np.int64)
    base = base % spec.vocab_size
    # per-segment additive offset -> segments (and hence chunks) differ
    seg = 1024
    offs = rng.integers(0, spec.vocab_size, size=(n + seg - 1) // seg)
    idx = np.arange(n) // seg
    return ((base + offs[idx]) % spec.vocab_size).astype(np.int32)
