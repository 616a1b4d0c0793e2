"""End-to-end serving example on the port: a MoSKA engine serving batched
requests over two registered domain corpora with continuous batching +
corpus-affinity scheduling. This is the paper's deployment story at
reduced scale: corpora's KV precomputed once, concurrent requests'
queries routed and GEMM-batched against the shared chunks.

    PYTHONPATH=src python -m repro_torch.examples.serve_shared_corpus
    PYTHONPATH=src python -m repro_torch.examples.serve_shared_corpus \\
        --device cpu
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core.scheduler import wave_stats
from repro_torch.data.pipeline import CorpusSpec, synthesize_corpus
from repro_torch.models.model import build_model
from repro_torch.serving.engine import EngineConfig, ServingEngine


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is present")
    dev = torch.device(args.device)

    cfg = get_config("qwen1.5-0.5b").reduced()
    model = build_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0), dev)
    eng = ServingEngine(cfg, params, EngineConfig(max_slots=4, max_seq=96))

    for cid, seed in (("laws", 1), ("medical", 2)):
        corpus = synthesize_corpus(CorpusSpec(cid, 512, cfg.vocab_size, seed))
        t0 = time.perf_counter()
        n = eng.register_corpus(cid, corpus)
        print(f"registered corpus {cid!r}: {n} chunks "
              f"({time.perf_counter() - t0:.1f}s, one-time)")

    rng = np.random.default_rng(0)
    for i in range(10):
        cid = "laws" if i % 3 else "medical"
        eng.submit(rng.integers(0, cfg.vocab_size, 10).tolist(),
                   max_new_tokens=8, corpus_id=cid)

    t0 = time.perf_counter()
    done = list(eng.run())
    wall = time.perf_counter() - t0
    m = eng.metrics
    print(f"finished {len(done)} requests in {wall:.1f}s — "
          f"{m['tokens_generated']} tokens, {m['decode_steps']} decode waves "
          f"(batched {m['tokens_generated'] / m['decode_steps']:.1f} "
          "tok/wave)")
    print("wave stats:", wave_stats(done))
    reg = eng.registry
    print(f"in-place hot path: decode cache bytes copied/wave = "
          f"{int(reg.gauge('engine/decode_cache_bytes_copied').value)} "
          f"(cache {int(reg.gauge('engine/decode_cache_bytes').value)}B), "
          f"{m['prefills']} prefills padded to buckets "
          f"{list(eng.prefill_buckets or ())}")
    for r in done[:3]:
        print(f"  req {r.uid} [{r.corpus_id}]: {r.generated}")
    return done


if __name__ == "__main__":
    main()
