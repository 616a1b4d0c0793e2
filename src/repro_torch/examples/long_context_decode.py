"""Long-context decode via MoSKA routing (the long_500k mechanism at
reduced scale), on the port: a context far larger than what full
attention would read per step is registered as shared chunks; each decode
step reads only the routed top-k — sub-quadratic in context length.

Also holds the decode step's kernels against their plain versions: the
same step on the card (the hand-written CUDA kernels) and on the CPU (the
plain PyTorch versions), from copies of the same cache.

    PYTHONPATH=src python -m repro_torch.examples.long_context_decode
    PYTHONPATH=src python -m repro_torch.examples.long_context_decode \\
        --device cpu
"""
from __future__ import annotations

import argparse
import copy
import dataclasses
import time
from typing import Tuple

import torch

from repro_torch.configs import get_config
from repro_torch.core.shared_kv import build_store
from repro_torch.kvcache import KVCache, init_kv_cache
from repro_torch.models import dense

KERNEL_TOL = 1e-3       # the decode step's logits, kernels vs plain versions
B = 2                   # requests


def setup(dev: torch.device):
    """The example's model and inputs, drawn from seed 0 on ``dev``: (cfg,
    the weights, the context (1, 16 chunks), the prompts (B, 8))."""
    cfg = dataclasses.replace(get_config("llama3-8b").reduced(),
                              dtype="float32")
    gen = torch.Generator(device=dev).manual_seed(0)
    params = dense.init_params(cfg, gen, dev)
    # a "long" context: 16 chunks; decode reads top-2 => 8x fewer tokens/step
    ctx = torch.randint(0, cfg.vocab_size, (1, 16 * cfg.moska.chunk_size),
                        generator=gen, device=dev)
    prompt = torch.randint(0, cfg.vocab_size, (B, 8), generator=gen,
                           device=dev)
    return cfg, params, ctx, prompt


def main(argv=None) -> Tuple[torch.Tensor, float]:
    """Returns (the 8 greedy tokens of each request, (8, B) on the CPU, and
    the decode step's max |kernels - plain versions|)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is present")
    dev = torch.device(args.device)

    cfg, params, ctx, prompt = setup(dev)
    ctx_len = ctx.shape[1]
    ccache = init_kv_cache(cfg.num_layers, 1, ctx_len, cfg.num_kv_heads,
                           cfg.head_dim, torch.float32, dev)
    dense.prefill(cfg, params, ctx, ccache)
    store = build_store(ccache.k[:, 0], ccache.v[:, 0], cfg.moska.chunk_size)
    print(f"context: {ctx_len} tokens as {store.num_chunks} chunks; "
          f"router reads top-{cfg.moska.top_k_chunks} per step "
          f"({100 * cfg.moska.top_k_chunks / store.num_chunks:.0f}% of "
          "context)")

    cache = init_kv_cache(cfg.num_layers, B, 64, cfg.num_kv_heads,
                          cfg.head_dim, torch.float32, dev)
    logits, _ = dense.prefill(cfg, params, prompt, cache, store=store,
                              start_pos=ctx_len)
    tok = logits.argmax(-1)

    toks = []
    t0 = time.perf_counter()
    for _ in range(8):
        logits, _ = dense.decode_step(cfg, params, tok, cache, store=store)
        tok = logits.argmax(-1)
        toks.append(tok)
    toks = torch.stack(toks).cpu()
    print(f"decoded 8 tokens x {B} requests in "
          f"{time.perf_counter() - t0:.1f}s: {toks[:, 0].tolist()}")

    # kernel-path parity: this device's step against the plain versions
    cpu = torch.device("cpu")
    l_dev, _ = dense.decode_step(cfg, params, tok, KVCache(
        *(t.clone() for t in cache)), store=store)
    store_cpu = type(store)(*[t.to(cpu) if isinstance(t, torch.Tensor)
                              else t for t in store])
    l_cpu, _ = dense.decode_step(
        cfg, copy.deepcopy(params).to(cpu), tok.cpu(),
        KVCache(*(t.to(cpu, copy=True) for t in cache)), store=store_cpu)
    err = float((l_dev.cpu() - l_cpu).abs().max())
    print(f"{dev.type}-kernels-vs-plain decode max|diff| = {err:.2e}")
    if not err < KERNEL_TOL:
        raise RuntimeError(f"the decode step's kernels differ from their "
                           f"plain versions by {err:.2e}")
    print("OK")
    return toks, err


if __name__ == "__main__":
    main()
