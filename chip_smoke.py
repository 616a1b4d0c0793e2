#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printed as it runs; any failure exits non-zero:

  1. build  compile the hand-written kernels (``kernels/csrc/*.cu``, nvcc,
            sm_90a) and print ptxas' registers, shared memory and spills.
  2. check  hold each kernel against its plain PyTorch version on the card,
            at the main path's shapes and at one ragged shape, in bf16
            (tolerance 2e-2) and fp32 (2e-5), the bounds of
            ``tests/test_kernels.py``.
  3. serve  ``repro_torch.launch.serve.main``: tinyllama-1.1b at full width
            and depth, random weights from a seed, a 65,536-token shared
            corpus (32 chunks of 2,048; top-8 routing), 128 requests of 256
            prompt tokens and 32 new tokens on 64 slots. Every kernel's
            launch count must equal what the layer and step counts predict.
  4. agree  one decode step of 8 slots on the card, and the same step on the
            CPU (plain versions) from copies of the same weights, store and
            cache, in fp32: logits within 1e-3 and equal greedy tokens.
  5. time   each kernel, its plain version and, where one exists, the one
            PyTorch call that computes the same function (``library_ms``),
            at the decode step's shapes, with CUDA events and the L2 cache
            flushed before every launch.
  6. profile one decode step at the served shapes under torch.profiler:
            device time by kernel, and the device's idle share.

It then prints the kernels' JSON line, the card's name and power limit, and,
as the last line, the device JSON. Without a card it exits 1 and prints no
result.
"""
from __future__ import annotations

import copy
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12        # H100 SXM data sheet
BF16_FLOP_PER_S = 989e12         # H100 SXM dense bf16 tensor-core peak
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
E2E_TOL = 1e-3                   # the quickstart's exactness bound
SPIN_CYCLES = 1_000_000          # ~0.5 ms at the H100's 1.98 GHz boost clock

# the main path's workload
ARCH = "tinyllama-1.1b"
REQUESTS, NEW_TOKENS, SLOTS, PROMPT = 128, 32, 64, 256
SERVE_ARGV = ["--arch", ARCH, "--full", "--device", "cuda",
              "--corpus-tokens", "65536", "--requests", str(REQUESTS),
              "--slots", str(SLOTS), "--max-seq", "512",
              "--prompt-len", str(PROMPT), "--new-tokens", str(NEW_TOKENS)]

SOURCES = {
    "shared_chunk_attention": ("src/repro_torch/kernels/csrc/shared_chunk_attn.cu",
                               "src/repro/kernels/shared_chunk_attn.py:82"),
    "decode_attention": ("src/repro_torch/kernels/csrc/decode_attn.cu",
                         "src/repro/kernels/decode_attn.py:68"),
    "lse_merge": ("src/repro_torch/kernels/csrc/lse_merge.cu",
                  "src/repro/kernels/lse_merge.py:41"),
    "router_scores": ("src/repro_torch/kernels/csrc/router_score.cu",
                      "src/repro/kernels/router_score.py:31"),
}


def say(*parts) -> None:
    print(*parts, flush=True)


def check(ok: bool, what) -> None:
    """Fail the run (an assert would vanish under ``python -O``)."""
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


# ---------------------------------------------------------------------------
# inputs at the main path's shapes
# ---------------------------------------------------------------------------

def path_inputs(cfg, dtype, dev, seed=0):
    """Inputs of each kernel as one decode step of the served workload
    gives them: 64 slots, 32 chunks of 2,048 tokens, top-8 routing,
    capacity 32, unique caches of 257..288 tokens in a 512-token slab."""
    from repro_torch.core import router

    g = torch.Generator(device=dev).manual_seed(seed)
    H, KH, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    C, K = cfg.moska.chunk_size, cfg.moska.top_k_chunks
    E = 65536 // C

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(dtype)

    cap = router.required_capacity(SLOTS, K, E, cfg.moska.query_capacity_factor)
    ids = router.top_k(torch.rand((SLOTS, E), generator=g, device=dev), K)[1]
    _, pos, keep = router.dispatch_plan(ids, E, cap)
    flat = ids.reshape(-1)
    qmask = torch.zeros((E, cap), dtype=torch.bool, device=dev)
    qmask[flat[keep], pos[keep]] = True
    lens = torch.randint(PROMPT + 1, PROMPT + 33, (SLOTS,), generator=g,
                         device=dev, dtype=torch.int32)
    lses = torch.randn((K, SLOTS, H), generator=g, device=dev) * 3
    return {
        "shared_chunk_attention": (randn(E, cap, H, D), randn(E, C, KH, D),
                                   randn(E, C, KH, D), qmask),
        "decode_attention": (randn(SLOTS, H, D), randn(SLOTS, 512, KH, D),
                             randn(SLOTS, 512, KH, D), lens),
        "lse_merge": (randn(K, SLOTS, H, D), lses),
        "router_scores": (randn(SLOTS, H, D), randn(E, KH, D, scale=0.2)),
    }


def ragged_inputs(dtype, dev, seed=1):
    """One shape per kernel that is ragged against its tiles."""
    g = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    lses = torch.randn((3, 7, 2), generator=g, device=dev) * 3
    lses[:, 0] = -1e30                     # a row no partial attended
    return {
        "shared_chunk_attention": (randn(3, 37, 6, 32), randn(3, 100, 2, 32),
                                   randn(3, 100, 2, 32),
                                   torch.rand((3, 37), generator=g,
                                              device=dev) < 0.7),
        "decode_attention": (randn(3, 8, 128), randn(3, 100, 2, 128),
                             randn(3, 100, 2, 128),
                             torch.tensor([1, 63, 100], dtype=torch.int32,
                                          device=dev)),
        "lse_merge": (randn(3, 7, 2, 16), lses),
        "router_scores": (randn(5, 4, 16), randn(7, 2, 16)),
    }


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_build():
    from repro_torch.kernels import build
    info = build.build_info()
    say(f"[build] {build.LIB_NAME}: {info.seconds:.1f} s "
        f"({'cached' if info.cached else 'compiled'}) at {info.path}")
    for src, line in info.ptxas_lines():
        say(f"[build] {src}: {line}")


def phase_check(cfg, dev):
    """max |kernel - plain| per kernel over the path's shapes in bf16 (the
    number the kernels' JSON line reports) and every check's pass/fail."""
    from repro_torch.kernels import ops, ref
    plain = {"shared_chunk_attention": ref.shared_chunk_attention_ref,
             "decode_attention": ref.decode_attention_ref,
             "lse_merge": ref.lse_merge_ref,
             "router_scores": ref.router_scores_ref}
    errs = {}
    for dtype in (torch.bfloat16, torch.float32):
        for label, inputs in (("path", path_inputs(cfg, dtype, dev)),
                              ("ragged", ragged_inputs(dtype, dev))):
            for name, args in inputs.items():
                got = getattr(ops, name)(*args)
                torch.cuda.synchronize()
                want = plain[name](*args)
                got = got if isinstance(got, tuple) else (got,)
                want = want if isinstance(want, tuple) else (want,)
                err = max(float((a.float() - b.float()).abs().max())
                          for a, b in zip(got, want))
                tol = 2e-5 if name == "router_scores" else TOL[dtype]
                for a, b in zip(got, want):
                    torch.testing.assert_close(a.float(), b.float(),
                                               rtol=tol, atol=tol)
                say(f"[check] {name:24s} {label:6s} {str(dtype)[6:]:8s} "
                    f"max_abs_err={err:.3e} tol={tol:g} ok")
                if label == "path" and dtype == torch.bfloat16:
                    errs[name] = err
    return errs


def phase_serve(cfg, argv=SERVE_ARGV, requests=REQUESTS,
                new_tokens=NEW_TOKENS):
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    ops.reset_launches()
    summary = serve.main(argv)
    counts = ops.launch_counts()
    L = cfg.num_layers
    steps, prefills = summary["decode_steps"], summary["prefills"]
    # per layer: a decode step launches each kernel once and lse_merge twice
    # (K-chunk merge, unique + shared merge); a routed prefill launches all
    # but decode_attention
    want = {"shared_chunk_attention": L * (steps + prefills),
            "decode_attention": L * steps,
            "lse_merge": 2 * L * (steps + prefills),
            "router_scores": L * (steps + prefills)}
    say(f"[serve] launches {json.dumps(counts)}")
    say(f"[serve] expected {json.dumps(want)}")
    check(summary["finished"] == requests, ("finished", summary["finished"]))
    check(summary["tokens"] == requests * new_tokens,
          ("tokens", summary["tokens"]))
    check(all(n > 0 for n in counts.values()), ("a kernel never ran", counts))
    check(counts == want, ("launch counts", counts, want))
    say(f"[serve] finished={summary['finished']} tokens={summary['tokens']} "
        f"tokens_per_s={summary['tokens_per_s']:.1f} "
        f"decode_step_p50_s={summary['decode_step_p50_s']:.4f} "
        f"corpus_register_s={summary['corpus_register_s']:.2f} "
        f"peak_device_memory_bytes={summary['peak_device_memory_bytes']}")
    return counts


def phase_agree(cfg, dev, corpus_len=32768):
    """One decode step of 8 slots on the card and on the CPU, fp32. The
    32,768-token corpus is 16 chunks, so top-8 routing still selects."""
    from repro_torch.core.shared_kv import SharedKVStore, build_store
    from repro_torch.data.pipeline import CorpusSpec, synthesize_corpus
    from repro_torch.kvcache.cache import KVCache, init_kv_cache
    from repro_torch.models import dense

    cfg = dataclasses.replace(cfg, dtype="float32")
    B = 8
    params = dense.init_params(cfg, torch.Generator(device=dev).manual_seed(1),
                               dev)

    def cache(batch, max_seq):
        return init_kv_cache(cfg.num_layers, batch, max_seq, cfg.num_kv_heads,
                             cfg.head_dim, torch.float32, dev)

    corpus = torch.from_numpy(synthesize_corpus(CorpusSpec(
        "agree", corpus_len, cfg.vocab_size, seed=1))).long().to(dev)[None]
    cc = cache(1, corpus_len)
    dense.prefill(cfg, params, corpus, cc)
    store = build_store(cc.k[:, 0], cc.v[:, 0], cfg.moska.chunk_size)
    prompts = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (B, PROMPT))).to(dev)
    uc = cache(B, 512)
    logits, _ = dense.prefill(cfg, params, prompts, uc, store=store,
                              start_pos=corpus_len)
    tokens = logits.argmax(-1)

    cpu = torch.device("cpu")
    params_cpu = copy.deepcopy(params).to(cpu)
    store_cpu = SharedKVStore(*[t.to(cpu) if t is not None else None
                                for t in store])
    uc_cpu = KVCache(*[t.to(cpu, copy=True) for t in uc])
    lg_card, _ = dense.decode_step(cfg, params, tokens, uc, store=store)
    lg_card = lg_card.cpu()
    lg_cpu, _ = dense.decode_step(cfg, params_cpu, tokens.cpu(), uc_cpu,
                                  store=store_cpu)
    err = float((lg_card - lg_cpu).abs().max())
    same = bool((lg_card.argmax(-1) == lg_cpu.argmax(-1)).all())
    say(f"[agree] 8-slot fp32 decode step, card vs cpu: logits max_abs_err="
        f"{err:.3e} (tol {E2E_TOL:g}), |logits| max={float(lg_cpu.abs().max()):.3f}, "
        f"greedy tokens equal={same}")
    check(err <= E2E_TOL and same, ("card vs cpu decode step", err, same))


def _time_ms(fn, n=30):
    """Mean device time of ``fn`` over n calls. Before each call a 128 MB
    write empties the L2 cache (the path meets every layer's inputs cold)
    and a spin kernel of about 0.5 ms keeps the card busy while the host
    records the start event and enqueues ``fn``: the events then bracket
    the device work alone, not the wrapper's host-side time."""
    flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(n):
        flush.zero_()
        torch.cuda._sleep(SPIN_CYCLES)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        total += a.elapsed_time(b)
    return total / n


def _bound(name, args):
    """(bound_ms, bound_by): the larger of bytes over the HBM rate and
    operations over the bf16 tensor peak, counting what these inputs need
    (each input read once, each output written once)."""
    def nb(t):
        return t.numel() * t.element_size()

    if name == "shared_chunk_attention":
        qd, k, v, qmask = args
        E, cap, H, D = qd.shape
        C, KH = k.shape[1], k.shape[2]
        valid = int(qmask.sum())
        active = int(qmask.any(dim=1).sum())       # chunks with a query
        byts = (valid * H * D * qd.element_size()
                + 2 * active * C * KH * D * k.element_size()
                + nb(qmask) + nb(qd) + E * cap * H * 4)
        ops_ = 4 * valid * H * C * D
    elif name == "decode_attention":
        q, k, v, lens = args
        B, H, D = q.shape
        KH = k.shape[2]
        tokens = int(lens.clamp(max=k.shape[1]).sum())
        byts = (2 * nb(q) + 2 * tokens * KH * D * k.element_size()
                + nb(lens) + B * H * 4)
        ops_ = 4 * tokens * H * D
    elif name == "lse_merge":
        outs, lses = args
        byts = nb(outs) + nb(lses) + nb(outs[0]) + nb(lses[0])
        ops_ = 2 * outs.numel()
    else:
        q, emb = args
        G, H, D = q.shape
        E = emb.shape[0]
        byts = nb(q) + nb(emb) + G * E * 4
        ops_ = 2 * G * E * H * D
    t_bytes = byts / HBM_BYTES_PER_S * 1e3
    t_ops = ops_ / BF16_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _library_call(name, args):
    """The one PyTorch call that computes the same function, on inputs laid
    out for it beforehand; None where there is none."""
    if name == "shared_chunk_attention":
        qd, k, v, _ = args
        q4, k4, v4 = (x.transpose(1, 2).contiguous() for x in (qd, k, v))
        return lambda: F.scaled_dot_product_attention(q4, k4, v4,
                                                      enable_gqa=True)
    if name == "decode_attention":
        q, k, v, lens = args
        q4 = q[:, :, None]
        k4, v4 = (x.transpose(1, 2).contiguous() for x in (k, v))
        mask = (torch.arange(k.shape[1], device=q.device)[None]
                < lens[:, None])[:, None, None]
        return lambda: F.scaled_dot_product_attention(q4, k4, v4,
                                                      attn_mask=mask,
                                                      enable_gqa=True)
    if name == "router_scores":
        q, emb = args
        G, H, D = q.shape
        KH = emb.shape[1]
        qg = q.view(G, KH, H // KH, D)
        return lambda: torch.einsum("gkhd,ekd->ge", qg, emb)
    return None


def phase_time(cfg, dev, counts, errs):
    from repro_torch.kernels import ops, ref
    plain = {"shared_chunk_attention": ref.shared_chunk_attention_ref,
             "decode_attention": ref.decode_attention_ref,
             "lse_merge": ref.lse_merge_ref,
             "router_scores": ref.router_scores_ref}
    rows = []
    for name, args in path_inputs(cfg, torch.bfloat16, dev, seed=2).items():
        kern = getattr(ops, name)
        ms = _time_ms(lambda: kern(*args))
        plain_ms = _time_ms(lambda: plain[name](*args), n=10)
        lib = _library_call(name, args)
        lib_ms = _time_ms(lib) if lib is not None else None
        bound_ms, bound_by = _bound(name, args)
        src, replaces = SOURCES[name]
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": replaces, "launches": counts[name],
                     "max_abs_err": errs[name], "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": bound_ms, "bound_by": bound_by,
                     "library_ms": lib_ms})
        say(f"[time] {name:24s} ms={ms:.4f} plain_ms={plain_ms:.4f} "
            f"library_ms={lib_ms if lib_ms is None else round(lib_ms, 4)} "
            f"bound_ms={bound_ms:.4f} ({bound_by}) "
            f"shapes={[tuple(a.shape) for a in args]}")
    return rows


def phase_profile(cfg, dev):
    """Device time of one decode step at the served shapes, by kernel, from
    torch.profiler: 64 slots holding 256..287 tokens, a 32-chunk store of
    random K/V (values change routing, not the work), bf16. Also the step's
    wall time unprofiled, and the device's idle share of the profiled step."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.shared_kv import build_store
    from repro_torch.kvcache.cache import init_kv_cache
    from repro_torch.models import dense

    g = torch.Generator(device=dev).manual_seed(3)
    L, KH, D = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim
    params = dense.init_params(cfg, g, dev)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)

    store = build_store(randn(L, 65536, KH, D), randn(L, 65536, KH, D),
                        cfg.moska.chunk_size)
    cache = init_kv_cache(L, SLOTS, 512, KH, D, torch.bfloat16, dev)
    cache.k.copy_(randn(*cache.k.shape))
    cache.v.copy_(randn(*cache.v.shape))
    cache.length.copy_(torch.randint(PROMPT, PROMPT + 32, (SLOTS,),
                                     generator=g, device=dev))
    cache.offset.fill_(65536)
    tokens = torch.randint(0, cfg.vocab_size, (SLOTS,), generator=g,
                           device=dev)

    def step():
        cache.length.clamp_(max=PROMPT + 32)      # stay inside the slab
        dense.decode_step(cfg, params, tokens, cache, store=store)

    for _ in range(3):
        step()
    torch.cuda.synchronize()
    walls = []
    for _ in range(5):
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages()
               if e.device_type.name == "CUDA" and e.self_device_time_total > 0]
    busy_us = sum(e.self_device_time_total for e in kernels)
    say(f"[profile] decode step, 64 slots, unprofiled wall "
        f"median={sorted(walls)[2] * 1e3:.2f} ms; profiled wall="
        f"{prof_wall * 1e3:.2f} ms, device busy={busy_us / 1e3:.2f} ms, "
        f"idle share={1 - busy_us / 1e6 / prof_wall:.3f}, "
        f"{sum(e.count for e in kernels)} kernel launches")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]:
        say(f"[profile] {e.self_device_time_total / 1e3:9.3f} ms "
            f"{e.count:5d}x  {e.key[:90]}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is present", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False    # fp32 means fp32
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.configs import get_config
    cfg = get_config(ARCH)
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    say(f"[env] torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")
    phase_build()
    errs = phase_check(cfg, dev)
    counts = phase_serve(cfg)
    torch.cuda.empty_cache()
    phase_agree(cfg, dev)
    torch.cuda.empty_cache()
    rows = phase_time(cfg, dev, counts, errs)
    torch.cuda.empty_cache()
    phase_profile(cfg, dev)
    say(f"[done] {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": rows}))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip()
    print(smi.splitlines()[0])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
