"""Quickstart: the MoSKA mechanism in ~70 lines, on the port.

Builds a small dense model, precomputes a shared corpus' KV chunks,
and shows that routed Shared-KV-Attention decode (a) matches monolithic
attention under full routing, and (b) reads only top-k chunks when sparse.
On the card every attention kernel is the hand-written CUDA one; with
``--device cpu`` they take their plain PyTorch versions.

    PYTHONPATH=src python -m repro_torch.examples.quickstart
    PYTHONPATH=src python -m repro_torch.examples.quickstart --device cpu
"""
from __future__ import annotations

import argparse
import dataclasses

import torch

from repro_torch.configs import get_config
from repro_torch.core.shared_kv import build_store
from repro_torch.kvcache import init_kv_cache
from repro_torch.models import dense

E2E_TOL = 1e-3          # full routing vs the monolithic context


def main(argv=None) -> float:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is present")
    dev = torch.device(args.device)

    cfg = dataclasses.replace(get_config("tinyllama-1.1b").reduced(),
                              dtype="float32")
    gen = torch.Generator(device=dev).manual_seed(0)
    params = dense.init_params(cfg, gen, dev)
    print(f"model: {cfg.name} ({cfg.num_layers}L d={cfg.d_model}) on {dev}")

    def cache(batch, max_seq):
        return init_kv_cache(cfg.num_layers, batch, max_seq,
                             cfg.num_kv_heads, cfg.head_dim, torch.float32,
                             dev)

    # --- 1. precompute the shared corpus KV once (the persistent asset) --
    corpus_len = 256
    corpus = torch.randint(0, cfg.vocab_size, (1, corpus_len), generator=gen,
                           device=dev)
    ccache = cache(1, corpus_len)
    dense.prefill(cfg, params, corpus, ccache)
    store = build_store(ccache.k[:, 0], ccache.v[:, 0], cfg.moska.chunk_size)
    print(f"shared store: {store.num_chunks} chunks x {store.chunk_size} "
          "tokens")

    # --- 2. concurrent requests decode against the shared store ----------
    B, S = 4, 12
    prompts = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                            device=dev)
    c1 = cache(B, S + 8)
    logits, _ = dense.prefill(cfg, params, prompts, c1, store=store,
                              start_pos=corpus_len)
    logits, _ = dense.decode_step(cfg, params, logits.argmax(-1), c1,
                                  store=store)
    print("sparse routed decode logits[0,:4] =", logits[0, :4].tolist())

    # --- 3. exactness: full routing == monolithic context -----------------
    full = dataclasses.replace(cfg, moska=dataclasses.replace(
        cfg.moska, top_k_chunks=store.num_chunks))
    c2 = cache(B, S + 8)
    lg, _ = dense.prefill(full, params, prompts, c2, store=store,
                          start_pos=corpus_len)
    nxt2 = lg.argmax(-1)
    lg, _ = dense.decode_step(full, params, nxt2, c2, store=store)

    mono = torch.cat([corpus.repeat(B, 1), prompts, nxt2[:, None]], dim=1)
    lm, _ = dense.prefill(cfg, params, mono, cache(B, mono.shape[1] + 4))
    err = float((lg - lm).abs().max())
    print("full-routing decode vs monolithic-context decode: "
          f"max|diff|={err:.2e}")
    if not err < E2E_TOL:
        raise RuntimeError(f"full routing differs from the monolithic "
                           f"context by {err:.2e} (bound {E2E_TOL:g})")
    print("OK — Shared KV Attention is exact under full routing.")
    return err


if __name__ == "__main__":
    main()
