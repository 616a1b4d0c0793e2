"""Data pipeline: synthetic corpora and a deterministic LM batch stream.

A copy of the reference data pipeline, with its two roles:
  * training batches for the train loop (tokens/targets/mask, and stub
    frontend embeddings for the VLM and audio families);
  * *shared corpora* for MoSKA serving: long token streams whose KV is
    precomputed into SharedKVStores (the paper's "domain-specific
    documents").

Synthetic text is a Zipfian token process with local structure, so
routing is non-degenerate (chunks have distinguishable key statistics).
Batches stay numpy, drawn from the reference's ``np.random.default_rng``
seeds in the reference's order, so both packages see the same stream.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, Optional

import numpy as np

from repro_torch.configs.base import AUDIO, VLM, ModelConfig


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


class SyntheticLMDataset:
    """Deterministic, restartable token stream chunked into training rows."""

    def __init__(self, vocab_size: int, seq_len: int, seed: int = 0):
        self.vocab_size = vocab_size
        self.seq_len = seq_len
        self.seed = seed

    def batches(self, batch_size: int, num_batches: Optional[int] = None
                ) -> Iterator[Dict[str, np.ndarray]]:
        rng = np.random.default_rng(self.seed)
        i = 0
        while num_batches is None or i < num_batches:
            # Zipfian unigrams (learnable marginals => loss descends fast)
            rows = rng.zipf(1.3, size=(batch_size, self.seq_len + 1))
            rows = (rows % self.vocab_size).astype(np.int32)
            # plus copy structure (longer-horizon signal: induction)
            half = self.seq_len // 2
            rows[:, half:half * 2] = rows[:, :half]
            yield {
                "tokens": rows[:, :-1],
                "targets": rows[:, 1:],
                "mask": np.ones((batch_size, self.seq_len), np.float32),
            }
            i += 1


def make_train_batches(cfg: ModelConfig, batch_size: int, seq_len: int,
                       num_batches: Optional[int] = None, seed: int = 0
                       ) -> Iterator[Dict[str, np.ndarray]]:
    """Family-aware batches: stub frontend embeddings for the VLM (its P
    patches take text positions: the tokens are ``seq_len - P`` long) and
    audio (F frames beside ``seq_len`` tokens) families."""
    rng = np.random.default_rng(seed + 17)
    if cfg.family == VLM:
        P = min(cfg.encoder.frontend_seq, seq_len // 2)
        ds = SyntheticLMDataset(cfg.vocab_size, seq_len - P, seed)
        for b in ds.batches(batch_size, num_batches):
            b["frontend_embeds"] = rng.standard_normal(
                (batch_size, P, cfg.encoder.frontend_dim)).astype(np.float32)
            yield b
    elif cfg.family == AUDIO:
        F = cfg.encoder.frontend_seq
        ds = SyntheticLMDataset(cfg.vocab_size, seq_len, seed)
        for b in ds.batches(batch_size, num_batches):
            b["frontend_embeds"] = rng.standard_normal(
                (batch_size, F, cfg.encoder.frontend_dim)).astype(np.float32)
            yield b
    else:
        yield from SyntheticLMDataset(cfg.vocab_size, seq_len,
                                      seed).batches(batch_size, num_batches)
