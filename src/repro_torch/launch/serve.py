"""Serving launcher: the MoSKA engine over a shared corpus, on the card.

    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \\
        --kv-layout paged --block-size 16
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \\
        --kv-layout paged --num-blocks 9 --host-pool-blocks auto
    PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b \\
        --full --corpus-tokens 65536 --requests 128 --slots 64 \\
        --max-seq 512 --prompt-len 256 --new-tokens 32

Registers a synthetic domain corpus (precomputed shared KV chunks),
submits a stream of requests against it, and reports throughput, latency,
memory, kernel-launch counts, for an MoE arch the expert slots kept and
dropped, and, with the paged layout, the host tier's and the async
pipeline's counters. The default is the reduced config; pass
``--full`` for the unreduced architecture. ``--device cuda`` (the default)
fails when no card is present. Weights are random, from ``--seed``.
"""
from __future__ import annotations

import argparse
import json
from typing import List, Tuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.configs import get_config
from repro_torch.core.analytical import size_host_pool_blocks
from repro_torch.core.scheduler import Request, wave_stats
from repro_torch.data.pipeline import CorpusSpec, synthesize_corpus
from repro_torch.kernels import ops
from repro_torch.models.dense import torch_dtype
from repro_torch.models.model import build_model
from repro_torch.serving.engine import EngineConfig, ServingEngine


def main(argv=None) -> dict:
    """Run the launcher on ``argv``; returns its summary."""
    return serve(argv)[0]


def serve(argv=None) -> Tuple[dict, List[Request]]:
    """Run the launcher on ``argv``; returns (its summary, the finished
    requests with their generations)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--full", action="store_true",
                    help="run the unreduced architecture (default: reduced)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--corpus-tokens", type=int, default=None,
                    help="shared corpus length (default: 512, or one chunk "
                         "when a chunk is longer)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--prefill-buckets", default="auto", metavar="SPEC",
                    help="'auto' (default), 'none' (exact lengths), or a "
                         "comma-separated bucket list, e.g. '16,32,64'")
    ap.add_argument("--kv-layout", default="slotted",
                    choices=["slotted", "paged"],
                    help="unique-KV layout: 'slotted' (per-slot max_seq "
                         "slab) or 'paged' (block pool + block tables; "
                         "bit-identical generations, less HBM)")
    ap.add_argument("--block-size", type=int, default=16,
                    help="tokens per KV page (paged layout; must divide "
                         "max-seq)")
    ap.add_argument("--num-blocks", type=int, default=None,
                    help="fixed page-pool size (paged layout; default: "
                         "grow on demand)")
    ap.add_argument("--host-pool-blocks", default="0", metavar="N|auto",
                    help="host memory tier capacity in blocks (paged "
                         "layout): LRU-evicted prefix pages are offloaded "
                         "to pinned host memory and swapped back on a "
                         "later hit instead of being rebuilt; 0 disables "
                         "the tier; 'auto' sizes it from the workload's "
                         "prefix working set via core.analytical."
                         "size_host_pool_blocks")
    ap.add_argument("--prefetch-depth", type=int, default=2,
                    help="max in-flight host->device prefetch transfers "
                         "for predicted next-wave admissions (paged layout "
                         "with a host tier); 0 disables prefetching")
    ap.add_argument("--no-spec-append", action="store_true",
                    help="disable speculative decode-boundary page "
                         "allocation (paged layout; generations are "
                         "identical either way)")
    ap.add_argument("--no-overlap", action="store_true",
                    help="run the wave's host-side bookkeeping after the "
                         "token readback's wait instead of while the card "
                         "computes (a stall-measurement baseline)")
    ap.add_argument("--metrics-out", default=None, metavar="PATH",
                    help="dump the metrics registry (JSON; .lp/.txt for "
                         "line protocol) at exit")
    ap.add_argument("--metrics-flush-every", type=int, default=0,
                    metavar="N",
                    help="also rewrite --metrics-out atomically every N "
                         "decode waves; 0 disables")
    args = ap.parse_args(argv)
    if args.metrics_flush_every and not args.metrics_out:
        ap.error("--metrics-flush-every requires --metrics-out")
    if args.host_pool_blocks == "auto":
        if args.kv_layout != "paged":
            ap.error("--host-pool-blocks auto requires --kv-layout paged")
        host_pool_blocks = size_host_pool_blocks(
            workset_tokens=args.requests * args.prompt_len,
            block_size=args.block_size,
            device_pool_blocks=args.num_blocks,
            active_tokens=args.slots * (args.prompt_len + args.new_tokens))
    else:
        host_pool_blocks = int(args.host_pool_blocks)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is present")
    device = torch.device(args.device)

    cfg = get_config(args.arch)
    if not args.full:
        cfg = cfg.reduced()
    C = cfg.moska.chunk_size
    corpus_tokens = (max(512, C) if args.corpus_tokens is None
                     else args.corpus_tokens)
    if corpus_tokens < C:
        ap.error(f"--corpus-tokens {corpus_tokens} is shorter than one "
                 f"{C}-token chunk of {cfg.name}")

    if args.prefill_buckets == "none":
        buckets = None
    elif args.prefill_buckets == "auto":
        buckets = "auto"
    else:
        buckets = [int(b) for b in args.prefill_buckets.split(",")]

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    with obs.span("serve.init", arch=args.arch):
        gen = torch.Generator(device=device).manual_seed(args.seed)
        params = build_model(cfg).init(gen, device)
        eng = ServingEngine(cfg, params, EngineConfig(
            max_slots=args.slots, max_seq=args.max_seq,
            prefill_buckets=buckets, cache_dtype=torch_dtype(cfg.dtype),
            kv_layout=args.kv_layout, block_size=args.block_size,
            num_blocks=args.num_blocks, host_pool_blocks=host_pool_blocks,
            prefetch_depth=args.prefetch_depth,
            spec_append=not args.no_spec_append,
            overlap_waves=not args.no_overlap))

    exporter = None
    if args.metrics_flush_every:
        exporter = obs.StreamingExporter(args.metrics_out,
                                         every=args.metrics_flush_every)
        eng.wave_hooks.append(exporter.tick)

    corpus = synthesize_corpus(CorpusSpec(
        "domain-0", corpus_tokens, cfg.vocab_size, seed=args.seed))
    nchunks = eng.register_corpus("domain-0", corpus)
    reg_span = next(s for s in reversed(eng.registry.spans)
                    if s.name == "engine.register_corpus")
    print(f"registered corpus domain-0: {nchunks} chunks "
          f"({reg_span.duration_s:.1f}s)")

    rng = np.random.default_rng(args.seed)
    for _ in range(args.requests):
        eng.submit(rng.integers(0, cfg.vocab_size,
                                args.prompt_len).tolist(),
                   max_new_tokens=args.new_tokens, corpus_id="domain-0")

    done = eng.run()

    reg = eng.registry
    steps = eng.metrics["decode_step_s"]
    summary = {
        "device": str(device),
        "arch": cfg.name,
        "finished": len(done),
        "tokens": int(reg.counter("engine/tokens_generated").value),
        "decode_steps": int(reg.counter("engine/decode_steps").value),
        "prefills": int(reg.counter("engine/prefills").value),
        "tokens_per_s": reg.gauge("engine/last_run_tokens_per_s").value,
        "decode_step_p50_s": float(np.median(steps)) if steps else 0.0,
        "corpus_chunks": nchunks,
        "corpus_register_s": reg_span.duration_s,
        "slot_occupancy": reg.gauge("scheduler/slot_occupancy").value,
        "affinity_hits": reg.counter("scheduler/affinity_hits").value,
        "prefill_buckets": list(eng.prefill_buckets or ()),
        "decode_cache_bytes_copied":
            reg.gauge("engine/decode_cache_bytes_copied").value,
        "kv_layout": args.kv_layout,
        "hbm_high_water_bytes":
            reg.gauge("engine/hbm_high_water_bytes").value,
        "peak_device_memory_bytes": (torch.cuda.max_memory_allocated(device)
                                     if device.type == "cuda" else None),
        "kernel_launches": ops.launch_counts(),
        "wave": wave_stats(done),
    }
    if cfg.moe.enabled:
        kept = int(reg.counter("moe/dispatched_slots").value)
        summary["moe_dispatched_slots"] = kept
        summary["moe_dropped_slots"] = int(
            reg.counter("moe/routed_slots").value) - kept
    if args.kv_layout == "paged":
        for name in ("kvcache/prefix_hits", "kvcache/cow_copies",
                     "kvcache/blocks_appended", "kvcache/pool_growths",
                     "engine/chunked_prefills"):
            summary[name.split("/")[1]] = int(reg.counter(name).value)
        summary["block_capacity"] = int(
            reg.gauge("kvcache/block_capacity").value)
        summary["host_pool_blocks"] = host_pool_blocks
        for name in ("kvcache/swap_in_hits", "kvcache/offload_bytes",
                     "kvcache/swap_in_bytes", "kvcache/host_pool_misses",
                     "kvcache/host_pool_evictions",
                     "scheduler/offload_admissions",
                     "kvcache/prefetch_issued", "kvcache/prefetch_hits",
                     "kvcache/prefetch_wasted", "kvcache/spec_pages_alloc"):
            summary[name.split("/")[1]] = int(reg.counter(name).value)
        summary["decode_stall_sum_s"] = reg.histogram(
            "engine/decode_stall_s", obs.LATENCY_EDGES_S).sum
    if exporter is not None:
        summary["metrics_flushes"] = exporter.flushes
    print(json.dumps(summary, indent=1))
    if args.metrics_out:
        obs.dump(args.metrics_out, reg)
        print(f"metrics registry -> {args.metrics_out}")
    return summary, list(done)


if __name__ == "__main__":
    main()
