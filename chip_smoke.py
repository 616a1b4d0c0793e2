#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printed as it runs; any failure exits non-zero:

  1. build  compile the hand-written kernels (``kernels/csrc/*.cu``, nvcc,
            sm_90a) and print ptxas' registers, shared memory and spills.
  2. check  hold each kernel against its plain PyTorch version on the card,
            at the main path's shapes (the decode step's, and for the
            routed kernels also the routed prefill's) and at one
            ragged shape, in bf16 (tolerance 2e-2) and fp32 (2e-5), the
            bounds of ``tests/test_kernels.py``; masked rows of the shared
            kernels must hold 0 and -1e30; the paged decode kernel
            against the slotted one on the same logical cache, bit for bit;
            and the merge's pair and routed entries against their plain
            versions and, bit for bit, against its dense entry on the same
            partials stacked or gathered (routes dropped, and at the decode
            and ragged shapes a group with every route dropped). Both
            decode kernels also with a sliding window (``WINDOWS``: lengths
            below, at and past it, a window of one key), against their
            plain versions and paged == slotted bit for bit. The prefill
            attention kernel against its plain version
            (``PREFILL_ATTN_CHECKS``: tinyllama's admission after the
            corpus and a prefill chunk, granite's and mistral-large's
            heads, whisper's encoder, a sliding window, rows with no valid
            key), bf16 (2e-2). The shared tail kernel against its plain
            version at trinity-mini's heads and tail (``TAIL_*``: 256 and
            512 rows, H 32 over KH 4, D 128, 2,047 keys, first keys over
            0-2,100), bf16 (2e-2); a row that sees no key holds 0 and
            -inf.
  3. serve  ``repro_torch.launch.serve.serve``: tinyllama-1.1b at full width
            and depth, random weights from a seed, a 65,536-token shared
            corpus (32 chunks of 2,048; top-8 routing), 128 requests of 256
            prompt tokens and 32 new tokens on 64 slots. Every kernel's
            launch count must equal what the layer and step counts predict.
  3b. paged the same model, weights and corpus through ``ServingEngine``
            with ``kv_layout="paged"`` (pages of 16 tokens): 128 requests of
            250 prompt tokens (the second 64 repeat the first 64's prompts:
            prefix hits and copy-on-write), then 2 prompts of 1,000 tokens
            (past max_seq 512: chunked prefill). Launch counts as predicted,
            with ``paged_decode_attention`` on every decode step and no
            ``decode_attention``; the first 128 generations equal a slotted
            engine's on the same stream. Then the chunked prefill's logits
            against a single-shot prefill of the same 1,000 tokens.
  3h. tier  the host memory tier and the async pipeline at full width and
            depth: the same model and weights over a 16,384-token corpus (8
            chunks, so top-8 routing reads all of them), 128 distinct
            prompts of 250 tokens, 32 new tokens each, submitted twice, on
            64 slots and a fixed pool of 1 + 64 x 18 pages (what 64 live
            requests need: every parked prefix is evicted before pass 2).
            Engine A has a 2,048-page host tier with the async defaults
            (prefetch 2, speculative appends, wave overlap), B no tier, C
            the tier with all three off. Generations of A, B and C must be
            equal bit for bit in both passes; A and C swap in all 128
            prefixes in pass 2 and prefill nothing, B prefills all 128
            again; every pass's launch counts are the predicted ones (a
            swap-in launches no kernel); A must take at least one prefetch
            hit and one speculative page, and keep its prefetch accounting.
            Printed: bytes moved each way, the engine's swap latencies (host
            time to queue), each direction's device time and GB/s for one
            prompt's pages, the host link's rate (one 256 MB pinned copy
            each way), each pass's wall and prefill tokens, the decode
            stalls of A against C, and the decode step's p50.
  3c. q8    an int8 store built from the registered store's K/V: prefill of
            64 prompts and 32 decode steps through ``dense.prefill`` /
            ``dense.decode_step``, all shared attention in
            ``shared_chunk_attention_q8``; first-step logits within 0.1 of
            the bf16 store's.
  3m. moe   granite-moe-1b-a400m at full width and depth (24 layers, 32
            experts top-8, G = 2, seeded bf16 weights): every kernel of the
            phase against its plain version at each shape the phase gives
            it (the served decode step and 256-row prefill, the fp32 step's
            prefill of 8 and decode), the merge's routed and pair entries
            too; phase 3's stream (128 requests of 256 tokens, 32 new, 64
            slots) over a 32,768-token corpus (16 chunks) through
            ``serve.serve``, slotted and then paged (pages of 16), each with
            exact launch counts and the expert slots kept and dropped; the
            paged generations must equal the slotted ones (both layouts
            prefill a prompt as one bucket and every wave holds 64 live
            slots, so the MoE FFN gets the same rows); an fp32 decode step
            of 8 slots card vs CPU (logits within 1e-3, equal greedy
            tokens); one decode step profiled as in phase 6, and its MoE
            FFN's device time by stage.
  3w. widths qwen1.5-0.5b (full depth; MHA, QKV bias), mistral-large-123b
            (2 layers; G = 12, D = 128) and internvl2-76b (2 layers; G = 8,
            D = 128, 256 stub patch embeddings in front of each prompt) at
            full width, bf16, over a 16,384-token corpus: every kernel at
            the arch's shapes against its plain version (the prefill of 16
            sequences of P + 256 rows, P the patches, the decode steps,
            and the fp32 step's prefill of 4 and decode); a prefill
            of 16 requests and 16 decode steps through ``Model`` with exact
            launch counts; an fp32 decode step of 4 slots card vs CPU
            (mistral and internvl2 with 1 layer).
  3f. families the SSM, hybrid and enc-dec families at full width and
            depth, bf16, seeded weights: mamba2-130m (24 layers, d_model
            768) serves phase 3's 128 requests through ``ServingEngine``
            with no corpus, then a ``shared_state`` warm start from 16,384
            corpus tokens tiled to 64 requests, prefilled and decoded 16
            steps; recurrentgemma-9b (38 layers, d_model 4,096, 9.57 B
            parameters) serves 64 requests of 256 and 2,040 prompt tokens,
            32 new each (its 2,048-key rings wrap); whisper-tiny: 64
            requests of 16 tokens behind one audio's 1,500 stub frames, 32
            decode steps with the cross-attention routed over a store of
            that audio's cross K/V (4 chunks of 375, top-2) and 32 without
            it, after each of its kernels was held against its plain
            version at those shapes (C 375, E 4, H = KH = 6, decode over
            1,500 frames). Launches exact (none for mamba2 and
            recurrentgemma); an fp32 decode step of each on the card
            against the CPU within 1e-3, equal greedy tokens
            (recurrentgemma with one cycle of 3 layers). One decode step of
            each family profiled as in phase 6 (whisper's with and without
            the store).
  4. agree  one decode step of 8 slots on the card, and the same step on the
            CPU (plain versions) from copies of the same weights, store and
            cache, in fp32: logits within 1e-3 and equal greedy tokens; the
            same over an int8 store, and as a paged step.
  5. time   each kernel, its plain version and, where one exists, the one
            PyTorch call that computes the same function (``library_ms``),
            at the decode step's shapes, with CUDA events and the L2 cache
            flushed before every launch (the decode kernels also with the
            L2 emptied by a read, beside the floors of the timing: a tiny
            kernel and a sum over as many bytes); then the two shared-chunk
            entries, ``lse_merge`` and ``router_scores`` at the routed
            prefill's shapes beside their bound (and SDPA or ``einsum``);
            the dense ``lse_merge`` beside ``outs.sum(dim=0)`` (the same
            bytes read, an output of the same size written); the routed
            merge beside the gather chain it replaced, and the pair merge
            beside stack + dense merge, each chain timed as one; the
            int8 entry at phase 3c's served prefill, qd (32, 8,192, 32, 64);
            and the prefill attention kernel at 896 and 2,048 tokens (96
            heads over 8, D 128), 896 (16 over 8, D 64) and a 32,768-token
            registration, beside its bound, its plain version and SDPA on
            K/V expanded to every head (a yardstick the port never calls);
            the shared tail kernel at phase 2's two shapes beside its
            bound (the visible pairs), its plain version and masked SDPA
            (a yardstick).
  6. profile one decode step at the served shapes under torch.profiler:
            device time by kernel, and the device's idle share; then one
            paged decode step. Both must run the bf16 tensor-core shared
            kernel and not the fp32 one, the split-KV decode kernel of
            their layout (``decode_slab_kernel``, ``decode_pages_kernel``)
            and not the old tile kernels, in the exact launch counts of
            ``STEP_LAUNCHES`` (printed beside 2,547 and 2,787, the counts
            before the merge's routed and pair entries).

  7. train the port's training on the card, bf16, through its own
            ``training.train_loop.train`` with the reference loop's lr
            3e-4 and 10 warmup steps, batches of 8 x 256 from the
            synthetic stream, TF32 asserted off, and no kernel of the port
            launched (the training path is plain PyTorch under autograd):
            tinyllama-1.1b at full width and depth, 20 steps with remat,
            whose loss must descend; a save at step 10 and a fresh
            ``train`` resuming from it (tinyllama at full width and 2
            layers: a full-depth checkpoint is 13.2 GB of npz), whose
            steps 10-19 must match the uninterrupted run within 1e-3
            relative; mamba2-130m at full width and depth through
            ``repro_torch.examples.train_tiny`` (batch 4 x 256, cut from its
            200 steps to 100), ending with the example's descent assert;
            granite-moe-1b-a400m at full width and depth, 10 steps,
            ``moe_aux`` finite and above 0; recurrentgemma-9b at full width
            cut to 3 layers (its full-depth fp32 moments alone take 75 GB)
            and whisper-tiny at full width and depth, 5 steps each, losses
            finite. Each run prints its step p50, training tokens/s, peak
            device memory and first and last loss, beside the card's name
            and power limit; one more step of tinyllama, whisper and
            mamba2 is profiled as in phase 6 (device time by kernel, idle
            share, host time, synchronizing calls).

  8. disagg the disaggregated shared-KV pool (``core/disagg.py``) and
            training under ``--host-mesh``: (a) ``router_scores``,
            ``shared_chunk_attention`` and the routed ``lse_merge`` at
            moska-llama3.1-8b's heads (32 over 8, D = 128) against their
            plain versions, 64 decode queries over 64 chunks and over one
            owner's 16, bf16 (2e-2) and fp32 (2e-5), masked rows 0 and
            -1e30; (b) ``disaggregated_shared_attention`` in a world of one
            over NCCL against ``shared_attention_batched`` with global
            routing (fp32 3e-5, bf16 1e-3); (c) four owners spawned on the
            one card over gloo (NCCL refuses two ranks on one device),
            each owning 16 chunks of a one-layer 131,072-token store at
            that width (512 MiB of bf16 K and V), 64 queries top-8 over
            each owner's chunks: rank 0's merged output against the four
            owners' partials composed here with the reference's combine
            (bf16 1e-3, fp32 2e-5); printed: the call's wall (median of
            8), its two all-reduces alone, and one process's batched
            attention over all 64 chunks; (d) ``launch.train.run`` with
            and without ``--host-mesh`` (FSDP over a world of one),
            tinyllama-1.1b at full width and depth, bf16, 8 x 256, 10
            steps: losses within 1e-3 relative, the largest gap, step p50
            and peak memory printed. The launches of (b) and (c), every
            rank's, count in the kernels' line.

  9. launch the launch tools: (a) a meshed checkpoint in a gloo world of 2
            on the one card (tinyllama reduced, fp32, deterministic
            algorithms): 5 steps saved at step 3, a fresh run resumed from
            that save, its losses and every parameter and moment shard bit
            for bit the uninterrupted run's; (b) the dry run's record of
            tinyllama-1.1b x decode_32k on the 16x16 mesh traced on fake
            CUDA tensors and on fake CPU tensors: flops, traffic,
            collective bytes and peak equal; (c) phase 6's slotted decode
            step traced by the dry run's counter: its flops, traffic and
            bound beside phase 6's measured device busy and wall.
  10. ep    expert parallelism: (a) granite-moe-1b-a400m at full width and
            depth, fp32 (TF32 off), in a gloo world of 2 on the one card, a
            (1, 2) mesh (the experts over ``model``): 3 training steps of
            4 x 256, then a prefill of 16 prompts of 256 tokens and one
            decode step routed over a 32,768-token store (16 chunks of
            2,048, top-8) split by chunk position over ``model``, each
            against rank 0's one-process run of the same before it: losses
            within 1e-5 relative (the aux loss at the first step), the
            first update's gradients within 1e-5 of each leaf's largest
            and their global norm within 1e-5 relative; the prefill's
            logits within 2e-5 and the decode step's within 1e-3 (the
            whole-model fp32 bound: its rounding grows with depth) of the
            one-process run given the meshed run's expert choices (fp32
            noise flips near-ties of the top-8 among 4,096 rows x 24
            layers; the rows apart are counted and printed), and the same
            greedy tokens as with its own. The kernels at a rank's decode
            shapes against their plain versions first (fp32); each rank's
            launches count in the kernels' line, and each of the four
            decode kernels must have launched. Printed: the MoE layers' collective bytes by
            kind, as the dry run's counter counts them (a model of the
            card, not a measurement). (b) the dry run's record of
            granite-moe-1b-a400m x decode_32k on the 16x16 mesh traced on
            fake CUDA and on fake CPU tensors: the two equal.

  11. tp families  tensor parallelism of the SSM, hybrid and enc-dec
            families: (a) in a gloo world of 2 on the one card, a (1, 2)
            mesh, fp32 (TF32 off), each arch against rank 0's one-process
            run of the same before it (run first, then freed):
            mamba2-130m at full size and recurrentgemma-9b at full width
            cut to one pattern cycle (3 layers), 3 training steps of
            4 x 256, a prefill of 16 prompts of 256 tokens and one decode
            step; whisper-tiny at full size, 3 training steps, the
            prefill of 16 prompts behind one audio's 1,500 frames and one
            decode step routed over a store of that audio (4 chunks of
            375, top-2; its 6 kv heads split over the two ranks, as its
            self cache's), its four kernels first held against their
            plain versions at a rank's shapes (H = KH = 3, fp32). Losses
            within 1e-5 relative, prefill logits within 1e-4 and decode
            logits within 1e-3 (the whole-model fp32 bounds: at full
            width the ranks' sums round at 2e-5 to 3e-5, past the CPU
            tests' 2e-5 at reduced width, and one process on the card
            and on the CPU differ by 4e-5 to 5e-5), the same greedy
            tokens; the
            first update's gradients and global norm printed beside one
            process's; recurrentgemma's training peak memory a rank
            printed; whisper's decode launches count in the kernels'
            line, and each of its four kernels must have launched on each
            rank. (b) one dry-run record of each family
            (decode_32k, 16x16) on fake CUDA and on fake CPU tensors: the
            two equal.

  3t. trinity trinity-mini at full width and depth (32 layers, 24 of them
            sliding, 128 experts top-8 + a shared expert, 26.1 B
            parameters, seeded bf16 weights) through ``ServingEngine``:
            its 32,768-token document registered as a per-layer store,
            then 64 prompts of 256 tokens, 16 new each, on 64 slots, with
            the counts zeroed after the registration: every admission
            prefill and decode step launches the tail kernel once in each
            sliding layer (24 x (prefills + steps)) and the routed kernels
            once in each full layer, launches exact; the engine's tail
            counters count the same calls. Run last: its weights take 52
            GB of the card.

Phases 3m, 3w, 3f, 7, 8, 9, 10, 11 and 3t run last, after phase 6, so that
phases 1-6 run as they ran before them (cuBLAS picks GEMM kernels by what
the process ran earlier, and phase 6 counts kernels exactly). Each phase
prints its seconds. It then prints the kernels' JSON line (each
kernel's launches summed over every phase), the card's name and power
limit, and, as the last line, the device JSON. Without a card it exits 1 and prints no
result.
"""
from __future__ import annotations

import collections
import contextlib
import copy
import dataclasses
import gc
import json
import subprocess
import sys
import time
import warnings
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
CORPUS = 65536                   # shared corpus tokens: 32 chunks of 2,048
SERVE_ARGV = ["--arch", ARCH, "--full", "--device", "cuda",
              "--corpus-tokens", str(CORPUS), "--requests", str(REQUESTS),
              "--slots", str(SLOTS), "--max-seq", "512",
              "--prompt-len", str(PROMPT), "--new-tokens", str(NEW_TOKENS)]

# phase 6: each profiled step's unique decode kernel, and its launches
STEP_DECODE_KERNEL = {"decode step": "decode_slab_kernel",
                      "paged decode step": "decode_pages_kernel"}
STEP_LAUNCHES = {"decode step": 2283, "paged decode step": 2272}
# the same steps before the merge read its partials where they lie
STEP_LAUNCHES_GATHERED = {"decode step": 2547, "paged decode step": 2787}

# the paged phase's stream: prompts end mid-page, and two exceed max_seq
PAGED_PROMPT, LONG_PROMPT, BLOCK = 250, 1000, 16
M_PAGES = 512 // BLOCK                 # table width of a 512-token slot

# phase 2's sliding windows, by input label: multiples of neither 32 nor
# the page size, and a window of one key
WINDOWS = {"path": (100,), "ragged": (37, 1)}

# phase 3m: granite-moe-1b-a400m at full width and depth, the main path's
# stream over a 32,768-token corpus (16 chunks; top-8 reads half)
MOE_ARCH, MOE_CORPUS = "granite-moe-1b-a400m", 32768
MOE_ARGV = ["--arch", MOE_ARCH] + SERVE_ARGV[2:]
MOE_ARGV[MOE_ARGV.index("--corpus-tokens") + 1] = str(MOE_CORPUS)

# phase 3w: the other dense-family members at full width (depth: None =
# the arch's own; 2 = cut to two layers for one card's memory)
WIDTH_ARCHS = (("qwen1.5-0.5b", None), ("mistral-large-123b", 2),
               ("internvl2-76b", 2))
WIDTH_CORPUS, WIDTH_REQUESTS, WIDTH_STEPS = 16384, 16, 16

# phase 3f: the SSM, hybrid and enc-dec families at full width and depth
SSM_ARCH, HYBRID_ARCH, AUDIO_ARCH = ("mamba2-130m", "recurrentgemma-9b",
                                     "whisper-tiny")
SSM_REQUESTS, SSM_CORPUS, SSM_WARM_STEPS = 128, 16384, 16
HYBRID_REQUESTS, HYBRID_PROMPTS = 64, (256, 2040)
AUDIO_REQUESTS, AUDIO_PROMPT, AUDIO_STEPS = 64, 16, 32

# phase 7: training at full width, bf16, the reference loop's lr 3e-4 and
# 10 warmup steps. tinyllama at full depth; its save-and-resume check at
# 2 layers (a full-depth checkpoint is 13.2 GB of npz); mamba2 through
# the training example at its batch 4 x 256; granite at full depth;
# recurrentgemma cut to 3 layers (its full-depth fp32 moments alone take
# 75 GB) and whisper at full depth
TRAIN_BATCH, TRAIN_SEQ = 8, 256
TRAIN_STEPS, RESUME_AT, RESUME_LAYERS = 20, 10, 2
TINY_STEPS, TINY_BATCH, TINY_SEQ = 100, 4, 256   # the example: 200 steps
MOE_TRAIN_STEPS, FAMILY_TRAIN_STEPS = 10, 5
FAMILY_TRAIN = (("recurrentgemma-9b", 3), ("whisper-tiny", None))
RESUME_TOL = 1e-3                      # relative, steps after the resume

# phase 8: the disaggregated shared-KV pool at moska-llama3.1-8b's width
# (32 heads over 8 kv heads, D = 128): a one-layer store of 131,072 tokens
# (64 chunks of 2,048, bf16: 512 MiB of K and V) split over 4 owners on
# the one card, 64 decode queries routed top-8 over each owner's 16
# chunks; then tinyllama trained under --host-mesh against the unmeshed
# launcher
DISAGG_ARCH, DISAGG_CORPUS, DISAGG_QUERIES = "moska-llama3.1-8b", 131072, 64
DISAGG_OWNERS, DISAGG_REPS = 4, 8
DISAGG_DEADLINE = 300                  # seconds for the spawned owners
# bf16 errors measured 0 (one owner) and 6.1e-5 (four): a merged output
# is ~1e-2, so a combine off by a factor or a missing sum fails 1e-3
DISAGG_TOL = {torch.float32: 3e-5, torch.bfloat16: 1e-3}   # one owner
OWNERS_TOL = {torch.float32: 2e-5, torch.bfloat16: 1e-3}   # four owners
MESH_STEPS, MESH_TOL = 10, 1e-3        # relative, meshed vs unmeshed

# phase 9: the launch tools. (a) a meshed checkpoint in a gloo world of 2
# on the one card: tinyllama reduced, fp32, LAUNCH_STEPS steps saved at
# LAUNCH_SAVE and resumed from there; (b) one dry-run record on the card
# machine and the same traced on the CPU; (c) the served decode step's
# traced work (phase 6's step) against its measured time
LAUNCH_STEPS, LAUNCH_SAVE, LAUNCH_BATCH, LAUNCH_SEQ = 5, 3, 4, 64
LAUNCH_DEADLINE = 240                  # seconds for the spawned ranks
DRY_ARCH, DRY_SHAPE = "tinyllama-1.1b", "decode_32k"
DRY_KEYS = ("flops_per_chip", "bytes_per_chip", "collective_bytes_per_chip",
            "peak_mem_per_chip", "collectives")

# phase 10: expert parallelism, granite at full width and depth in fp32 on
# a (1, 2) mesh of two ranks on the one card; rank 0 runs the one-process
# reference first. The loss, gradient and prefill bounds are the card
# tests' tensor-parallel ones (tests/test_torch_gpu.py: TP_LOSS_REL,
# TP_GRAD_REL, TP_LOGIT_TOL)
EP_ARCH, EP_SHAPE = MOE_ARCH, (1, 2)
EP_STEPS, EP_BATCH, EP_SEQ = 3, 4, 256
EP_PROMPTS, EP_PROMPT, EP_MAX_SEQ, EP_CORPUS = 16, 256, 512, 32768
EP_DEADLINE = 600                      # seconds for the spawned ranks
EP_LOSS_REL, EP_GRAD_REL, EP_LOGIT_TOL = 1e-5, 1e-5, 2e-5
# the full-depth decode step (24 layers over the 32,768-token store) gathers
# fp32 rounding with depth: 1.144e-05 at 4 layers (full width, the CPU) and
# 5.999e-05 at 24 on the card, with no expert choice apart; it is held at
# the whole-model fp32 bound of phases 3m and 4, the prefill at 2e-5
EP_DECODE_TOL = E2E_TOL
# the aux loss counts each token's top-1 expert: once AdamW has turned the
# reduction-order noise into parameter gaps, one token's flip moves it by
# ~1e-4 relative (PERF.md), so it is held at the first step only
EP_KERNELS = ("shared_chunk_attention", "decode_attention", "lse_merge",
              "router_scores")

# phase 11: tensor parallelism of the SSM, hybrid and enc-dec families, fp32
# on a (1, 2) mesh of two ranks on the one card against rank 0's
# one-process run of the same before it: (arch, depth or None for the
# config's). whisper's self cache holds the prompt and the new token (257
# positions, which do not split over ``model``: the rules split it by kv
# head, 3 of its 6 a rank), and its decode step routes the cross-attention
# over a store of the one audio's 1,500 frames (4 chunks of 375, which do
# not split either: the store too is split by kv head)
TPS_SHAPE = (1, 2)
TPS_ARCHS = ((SSM_ARCH, None), (HYBRID_ARCH, 3), (AUDIO_ARCH, None))
TPS_STEPS, TPS_BATCH, TPS_SEQ = 3, 4, 256
TPS_PROMPTS, TPS_PROMPT = 16, 256
TPS_MAX_SEQ = TPS_PROMPT + 1
TPS_DEADLINE = 900                     # seconds for the spawned ranks
# logits: at full width the fp32 sums of the 1,536- to 12,288-long
# contractions run in another order on a rank than in one process, and
# the prefill's logits came 2.623e-05 (mamba2, 24 layers) and 2.956e-05
# (recurrentgemma, d 4,096) apart on the card (the decode step's
# 1.4e-05 to 2.3e-05), past the CPU tests' 2e-5 at reduced width. Two
# fp32 orders of one process differ as much: the card's and the CPU's
# prefill logits at these widths and shapes came 5.132e-05 (mamba2) and
# 4.053e-05 (recurrentgemma) apart (the full-width cases of
# tests/test_torch_gpu.py::test_family_steps_card_match_cpu). So the
# prefill is held at 1e-4, that test's bound and the fp32 bound of the
# whole-model parity tests (tests/test_torch_encdec.py), the decode step
# at the whole-model card bound 1e-3 of phases 3f, 4 and 10
TPS_LOSS_REL, TPS_LOGIT_TOL, TPS_DECODE_TOL = 1e-5, 1e-4, E2E_TOL
TPS_KERNELS = EP_KERNELS

# phase 3h: the host tier's stream, pool and tier
TIER_CORPUS, TIER_PROMPTS = 16384, 128
TIER_PAGES = 1 + SLOTS * -(-(PAGED_PROMPT + NEW_TOKENS) // BLOCK)  # 1,153
TIER_HOST_PAGES = 2048
LINK_BYTES = 256 << 20                 # the host link yardstick's copy

SOURCES = {
    "shared_chunk_attention": ("src/repro_torch/kernels/csrc/shared_chunk_attn.cu",
                               "src/repro/kernels/shared_chunk_attn.py:82"),
    "decode_attention": ("src/repro_torch/kernels/csrc/decode_attn.cu",
                         "src/repro/kernels/decode_attn.py:68"),
    "lse_merge": ("src/repro_torch/kernels/csrc/lse_merge.cu",
                  "src/repro/kernels/lse_merge.py:41"),
    "router_scores": ("src/repro_torch/kernels/csrc/router_score.cu",
                      "src/repro/kernels/router_score.py:31"),
    "paged_decode_attention": (
        "src/repro_torch/kernels/csrc/paged_decode_attn.cu",
        "src/repro/kernels/paged_decode_attn.py:96"),
    "shared_chunk_attention_q8": (
        "src/repro_torch/kernels/csrc/shared_chunk_attn.cu",
        "src/repro/kernels/shared_chunk_attn.py:188"),
    "flash_prefill_attention": (
        "src/repro_torch/kernels/csrc/flash_prefill_attn.cu",
        "none (src/repro/models/layers.py::flash_attention is jnp)"),
    "shared_tail_attention": (
        "src/repro_torch/kernels/csrc/shared_chunk_attn.cu",
        "none (the reference has no sliding-window layer over a store)"),
}

# phase 2's checks of the prefill kernel: (label, B, Sq, Sk, H, KH, D,
# causal, q_offset, kv_offset, kv_len, window): tinyllama's admission
# after the corpus and a prefill chunk against its context, granite's and
# mistral-large's heads, whisper's encoder (non-causal), a sliding window,
# and rows with no valid key (queries before every key)
PREFILL_ATTN_CHECKS = (
    ("admission", 1, PROMPT, PROMPT, 32, 4, 64, True, CORPUS, CORPUS, None,
     0),
    ("chunk", 1, 512, 1024, 32, 4, 64, True, CORPUS + 512, CORPUS, 1000, 0),
    ("granite", 2, 896, 896, 16, 8, 64, True, 0, 0, None, 0),
    ("mistral-large", 1, 896, 896, 96, 8, 128, True, 0, 0, None, 0),
    ("whisper encoder", 2, 1500, 1500, 6, 6, 64, False, 0, 0, None, 0),
    ("window", 2, 300, 300, 32, 8, 128, True, 0, 0, None, 100),
    ("no valid key", 2, 70, 70, 8, 2, 64, True, 0, 20, None, 0),
)
# phase 5's rows of the prefill kernel: (label, Sq, H, KH, D), one causal
# sequence; the 2,048-token row is the kernels' JSON line's
PREFILL_ATTN_TIMES = (("mistral-large, 896 tokens", 896, 96, 8, 128),
                      ("mistral-large, 2,048 tokens", 2048, 96, 8, 128),
                      ("granite, 896 tokens", 896, 16, 8, 64),
                      ("registration, 32,768 tokens", 32768, 96, 8, 128))
PREFILL_ATTN_ROW = 1


# the shared tail kernel at trinity-mini's heads and tail (H 32 over KH 4,
# D 128, the window's 2,047 keys): the cell's decode step of 256 rows and a
# prefill's 512, each row's first visible key drawn over 0-2,100 (past the
# tail's end a row sees nothing)
TAIL_HEADS, TAIL_KV_HEADS, TAIL_DIM, TAIL_KEYS = 32, 4, 128, 2047
TAIL_ROWS = (("decode", 256), ("prefill", 512))
TAIL_FIRST_MAX = 2100
# phase 3t: trinity-mini at full width and depth, bf16, over the cell's
# 32,768-token document: 64 prompts of 256 tokens, 16 new each, 64 slots
TRINITY_ARCH, TRINITY_CORPUS = "trinity-mini", 32768
TRINITY_REQUESTS, TRINITY_NEW = 64, 16


def plain_versions():
    from repro_torch.kernels import ref
    return {name: getattr(ref, f"{name}_ref") for name in SOURCES}


def say(*parts) -> None:
    print(*parts, flush=True)


def check(ok: bool, what) -> None:
    """Fail the run (an assert would vanish under ``python -O``)."""
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


# ---------------------------------------------------------------------------
# inputs at the main path's shapes
# ---------------------------------------------------------------------------

def path_inputs(cfg, dtype, dev, seed=0, corpus=CORPUS, slots=SLOTS,
                slab=512, lens=(PROMPT + 1, PROMPT + 33)):
    """Inputs of each kernel as one decode step of the served workload
    gives them: 64 slots, 32 chunks of 2,048 tokens, top-8 routing,
    capacity 32, unique caches of 257..288 tokens in a 512-token slab (or
    ``slots`` over ``corpus`` tokens, caches of lens[0] .. lens[1] - 1
    tokens in a ``slab``-token slab, at ``cfg``'s heads)."""
    from repro_torch.core import router

    g = torch.Generator(device=dev).manual_seed(seed)
    H, KH, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    C, E = cfg.moska.chunk_size, corpus // cfg.moska.chunk_size
    K, M = min(cfg.moska.top_k_chunks, E), -(-slab // BLOCK)

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(dtype)

    from repro_torch.core.shared_kv import _quantize
    cap = min(router.required_capacity(slots, K, E,
                                       cfg.moska.query_capacity_factor),
              slots * K)
    ids = router.top_k(torch.rand((slots, E), generator=g, device=dev), K)[1]
    _, pos, keep = router.dispatch_plan(ids, E, cap)
    flat = ids.reshape(-1)
    qmask = torch.zeros((E, cap), dtype=torch.bool, device=dev)
    qmask[flat[keep], pos[keep]] = True
    lens = torch.randint(*lens, (slots,), generator=g, device=dev,
                         dtype=torch.int32)
    lses = torch.randn((K, slots, H), generator=g, device=dev) * 3
    # the slots' tables over a pool of slots * M pages plus the null page,
    # in scrambled order, so no slot's pages are contiguous
    n_pages = slots * M + 1
    table = (torch.randperm(n_pages - 1, generator=g, device=dev) + 1
             ).view(slots, M).to(torch.int32)
    kq, ks = _quantize(torch.randn((E, C, KH, D), generator=g, device=dev))
    vq, vs = _quantize(torch.randn((E, C, KH, D), generator=g, device=dev))
    return {
        "shared_chunk_attention": (randn(E, cap, H, D), randn(E, C, KH, D),
                                   randn(E, C, KH, D), qmask),
        "decode_attention": (randn(slots, H, D), randn(slots, slab, KH, D),
                             randn(slots, slab, KH, D), lens),
        "lse_merge": (randn(K, slots, H, D), lses),
        "router_scores": (randn(slots, H, D), randn(E, KH, D, scale=0.2)),
        "paged_decode_attention": (randn(slots, H, D),
                                   randn(n_pages, BLOCK, KH, D),
                                   randn(n_pages, BLOCK, KH, D), table, lens),
        "shared_chunk_attention_q8": (randn(E, cap, H, D), kq, vq, ks, vs,
                                      qmask),
    }


def prefill_inputs(cfg, dtype, dev, seed=0, corpus=CORPUS, batch=1,
                   rows=PROMPT):
    """The routed kernels' inputs as one routed prefill of a 256-token
    prompt gives them (``models/dense.py``): 2 groups of 128 queries, each
    routed to its top-8 of 32 chunks at capacity 8 slots, each slot 128
    query rows, so qd is (32, 1024, 32, 64) with each chunk's first 0-2
    slots valid (16 routes in all); the router scores the 2 groups' mean
    queries, q (2, 32, 64), and the K-chunk merge takes 8 partials of the
    256 tokens, (8, 256, 32, 64). Or a prefill of ``batch`` sequences of
    ``rows`` rows over ``corpus`` tokens, at ``cfg``'s heads: one routing
    group a min(128, rows) rows, as ``dense.prefill`` routes."""
    from repro_torch.core.shared_kv import _quantize

    g = torch.Generator(device=dev).manual_seed(seed)
    H, KH, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    C, E = cfg.moska.chunk_size, corpus // cfg.moska.chunk_size
    K, N, rb = min(cfg.moska.top_k_chunks, E), batch * rows, min(128, rows)
    check(rows % rb == 0, ("routed prefill rows", rows))
    qmask = routed_slots(cfg, g, dev, N // rb, rb=rb, corpus=corpus)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    kq, ks = _quantize(torch.randn((E, C, KH, D), generator=g, device=dev))
    vq, vs = _quantize(torch.randn((E, C, KH, D), generator=g, device=dev))
    lses = torch.randn((K, N, H), generator=g, device=dev) * 3
    return {
        "lse_merge": (randn(K, N, H, D), lses),
        "router_scores": (randn(N // rb, H, D), randn(E, KH, D) * 0.2),
        "shared_chunk_attention": (randn(E, qmask.shape[1], H, D),
                                   randn(E, C, KH, D), randn(E, C, KH, D),
                                   qmask),
        "shared_chunk_attention_q8": (randn(E, qmask.shape[1], H, D), kq, vq,
                                      ks, vs, qmask),
    }


def routed_slots(cfg, g, dev, groups, rb=128, corpus=CORPUS):
    """The shared kernels' qmask (E, cap * rb) of a routed prefill of
    ``groups`` groups of rb queries over ``corpus`` tokens: each group's
    top-8 chunks by random scores, dispatched at the path's capacity, each
    slot rb query rows."""
    from repro_torch.core import router
    E = corpus // cfg.moska.chunk_size
    K = min(cfg.moska.top_k_chunks, E)
    cap = min(router.required_capacity(groups, K, E,
                                       cfg.moska.query_capacity_factor),
              groups * K)
    ids = router.top_k(torch.rand((groups, E), generator=g, device=dev), K)[1]
    _, pos, keep = router.dispatch_plan(ids, E, cap)
    slots = torch.zeros((E, cap), dtype=torch.bool, device=dev)
    slots[ids.reshape(-1)[keep], pos[keep]] = True
    return slots.repeat_interleave(rb, dim=1).contiguous()


def plain_by_chunk(plain, args, rows=2048):
    """A shared kernel's plain version one chunk and at most ``rows`` query
    rows at a time (chunks and query rows are independent): at the routed
    prefill's shape the whole fp32 score tensor would be 8.6 GB, at
    internvl2's batch of 16 prefills 69 GB."""
    last = len(args) - 1                 # qd first and qmask last hold rows

    def piece(e, r):
        return plain(*(a[e:e + 1, r:r + rows] if i in (0, last)
                       else a[e:e + 1] for i, a in enumerate(args)))

    parts = [tuple(torch.cat(p, dim=1) for p in zip(*(
        piece(e, r) for r in range(0, args[0].shape[1], rows))))
        for e in range(len(args[0]))]
    return tuple(torch.cat(p) for p in zip(*parts))


def ragged_inputs(dtype, dev, seed=1):
    """One shape per kernel that is ragged against its tiles."""
    g = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    from repro_torch.core.shared_kv import _quantize
    lses = torch.randn((3, 7, 2), generator=g, device=dev) * 3
    lses[:, 0] = -1e30                     # a row no partial attended
    # kv_len 1, and lengths that are multiples of neither 16 nor 64
    table = (torch.randperm(29, generator=g, device=dev)[:24] + 1
             ).view(3, 8).to(torch.int32)
    kq, ks = _quantize(torch.randn((3, 100, 2, 32), generator=g, device=dev))
    vq, vs = _quantize(torch.randn((3, 100, 2, 32), generator=g, device=dev))
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
        "paged_decode_attention": (randn(3, 8, 128), randn(30, 16, 2, 128),
                                   randn(30, 16, 2, 128), table,
                                   torch.tensor([1, 37, 100],
                                                dtype=torch.int32,
                                                device=dev)),
        "shared_chunk_attention_q8": (randn(3, 37, 6, 32), kq, vq, ks, vs,
                                      torch.rand((3, 37), generator=g,
                                                 device=dev) < 0.7),
    }


def merge_inputs(cfg, dtype, dev, label, seed=0, corpus=CORPUS,
                 groups=None, rb=128):
    """The merge's pair and routed entries' inputs. routed: (od, lsed, lin)
    as the K-chunk merge of ``shared_attention_batched`` gets them, od
    (R, Q, H, D) the shared kernel's rows and lin (G, K) each route's row,
    R (the trash row) for a dropped one: at the decode step's shape (64
    groups, top-8 of 32 chunks at capacity 32, every fifth route and all
    of group 0's dropped), the routed prefill's (2 groups of 128 queries
    at capacity 8, every third route dropped), and a ragged one (every
    third and all of group 1's). pair: (o0, l0, o1, l1), the unique and
    shared partials of the decode step (64 rows), of the prefill (256)
    and ragged (7 rows, one that neither attended, one -inf). Or
    ``groups`` decode slots or groups of ``rb`` prefill queries over
    ``corpus`` tokens, at ``cfg``'s heads."""
    from repro_torch.core import router

    g = torch.Generator(device=dev).manual_seed(seed)
    H, D = cfg.num_heads, cfg.head_dim
    E = corpus // cfg.moska.chunk_size
    K = min(cfg.moska.top_k_chunks, E)

    def randn(*shape, scale=1.0, dt=dtype):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(dt)

    if label == "ragged":
        R, Q, H, D, G, K, N = 10, 3, 2, 16, 4, 3, 7
        lin = torch.stack([torch.randperm(R, generator=g, device=dev)[:K]
                           for _ in range(G)])
        lin.view(-1)[::3] = R
        lin[1] = R
    else:
        G, Q = ((groups or SLOTS, 1) if label == "path"
                else (groups or PROMPT // rb, rb))
        N = G * Q
        cap = min(router.required_capacity(G, K, E,
                                           cfg.moska.query_capacity_factor),
                  G * K)
        R = E * cap                                # the trash row
        ids = router.top_k(torch.rand((G, E), generator=g, device=dev), K)[1]
        flat, pos, keep = router.dispatch_plan(ids, E, cap)
        lin = torch.where(keep, flat * cap + pos, R).view(G, K)
        lin.view(-1)[::5 if label == "path" else 3] = R
        if label == "path":
            lin[0] = R
    lses = randn(2, N, H, scale=3.0, dt=torch.float32)
    if label == "ragged":
        lses[:, 0] = -1e30
        lses[1, 1] = float("-inf")
    return {"routed": (randn(R, Q, H, D),
                       randn(R, Q, H, scale=3.0, dt=torch.float32), lin),
            "pair": (randn(N, H, D), lses[0], randn(N, H, D), lses[1])}


def merge_chains():
    """What the merge's pair and routed entries replaced, through its dense
    entry: stack the pair; gather, fill and transpose the routed rows."""
    from repro_torch.kernels import ops, ref
    return {
        "pair": lambda o0, l0, o1, l1: ops.lse_merge(
            torch.stack([o0, o1]), torch.stack([l0, l1])),
        "routed": lambda od, lsed, lin: ops.lse_merge(
            *ref.routed_partials(od, lsed, lin)),
    }


def check_merge_entries(cfg, dev, dtype, label, tag="check", **shape):
    """The pair and routed entries against their plain versions (bf16
    2e-2, fp32 2e-5, lse 2e-5) and, bit for bit, against the dense entry
    on the same partials stacked or gathered; ``shape``: merge_inputs'
    ``corpus``, ``groups`` and ``rb``."""
    from repro_torch.kernels import ops, ref
    chains = merge_chains()
    for entry, args in merge_inputs(cfg, dtype, dev, label,
                                    **shape).items():
        got = getattr(ops, f"lse_merge_{entry}")(*args)
        chained = chains[entry](*args)
        want = getattr(ref, f"lse_merge_{entry}_ref")(*args)
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(got, chained))
        err = float((got[0].float() - want[0].float()).abs().max())
        torch.testing.assert_close(got[0].float(), want[0].float(),
                                   rtol=TOL[dtype], atol=TOL[dtype])
        torch.testing.assert_close(got[1], want[1], rtol=2e-5, atol=2e-5)
        if entry == "routed":           # groups with every route dropped
            od, _, lin = args
            G = lin.shape[0]
            empty = (lin >= od.shape[0]).all(dim=1)
            check(bool((got[1].view(G, -1)[empty] == -1e30).all()) and
                  bool((got[0].view(G, -1)[empty] == 0).all()),
                  ("empty routed groups", label, dtype))
        say(f"[{tag}] lse_merge {entry:6s} entry {label:7s} "
            f"{str(dtype)[6:]:8s} max_abs_err={err:.3e} "
            f"== dense entry on the {'stacked' if entry == 'pair' else 'gathered'} "
            f"partials bitwise={same}")
        check(same, (f"lse_merge {entry} entry vs dense", label, dtype))


def slotted_view(q, k_pool, v_pool, table, lens):
    """The slotted decode kernel's inputs holding the same logical cache as
    the paged inputs: each slot's pages in order, zeros past its length."""
    B, M = table.shape
    _, bs, KH, D = k_pool.shape
    live = (torch.arange(M * bs, device=q.device)[None, :, None, None]
            < lens[:, None, None, None])
    k, v = (torch.where(live, p[table.long()].view(B, M * bs, KH, D), 0)
            for p in (k_pool, v_pool))
    return q, k.contiguous(), v.contiguous(), lens


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
    from repro_torch.kernels import ops
    errs = {}
    for dtype in (torch.bfloat16, torch.float32):
        for label, inputs in (("path", path_inputs(cfg, dtype, dev)),
                              ("prefill", prefill_inputs(cfg, dtype, dev)),
                              ("ragged", ragged_inputs(dtype, dev))):
            if "paged_decode_attention" in inputs:
                paged = inputs["paged_decode_attention"]
                got = ops.paged_decode_attention(*paged)
                want = ops.decode_attention(*slotted_view(*paged))
                torch.cuda.synchronize()
                same = all(torch.equal(a, b) for a, b in zip(got, want))
                say(f"[check] paged == slotted decode kernel {label:7s} "
                    f"{str(dtype)[6:]:8s} bitwise={same}")
                check(same, ("paged vs slotted decode kernel", label, dtype))
            check_merge_entries(cfg, dev, dtype, label)
            for window in WINDOWS.get(label, ()):
                err = check_window(inputs, dtype, label, window)
                if label == "path" and dtype == torch.bfloat16:
                    for name, e in err.items():
                        errs[name] = max(errs.get(name, 0.0), e)
            for name, err in check_kernels(inputs, dtype, label).items():
                if label != "ragged" and dtype == torch.bfloat16:
                    errs[name] = max(errs.get(name, 0.0), err)
    errs["flash_prefill_attention"] = check_prefill_attention(dev)
    errs["shared_tail_attention"] = check_shared_tail(dev)
    return errs


def prefill_attention_inputs(dev, B, Sq, Sk, H, KH, D, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    return tuple(torch.randn(shape, generator=g, device=dev)
                 .to(torch.bfloat16) for shape in
                 ((B, Sq, H, D), (B, Sk, KH, D), (B, Sk, KH, D)))


def check_prefill_attention(dev):
    """The prefill kernel against its plain version at each of
    ``PREFILL_ATTN_CHECKS``, bf16 (2e-2), out and lse; a row with no valid
    key must hold lse -1e30 in both. Returns the largest error."""
    from repro_torch.kernels import ops, ref
    worst = 0.0
    for label, B, Sq, Sk, H, KH, D, causal, qo, ko, n, w in \
            PREFILL_ATTN_CHECKS:
        q, k, v = prefill_attention_inputs(dev, B, Sq, Sk, H, KH, D)
        args = (q, k, v, causal, qo, ko, n, w)
        got = ops.flash_prefill_attention(*args)
        torch.cuda.synchronize()
        want = ref.flash_prefill_attention_ref(*args)
        err = max(float((a.float() - b.float()).abs().max())
                  for a, b in zip(got, want))
        for a, b in zip(got, want):
            torch.testing.assert_close(a.float(), b.float(), rtol=2e-2,
                                       atol=2e-2)
        none = int((want[1] == -1e30).sum())
        check(bool((got[1] == -1e30).eq(want[1] == -1e30).all()),
              ("prefill kernel: rows with no valid key", label))
        say(f"[check] flash_prefill_attention {label:15s} bfloat16 "
            f"max_abs_err={err:.3e} tol=0.02 ok (q {tuple(q.shape)}, k "
            f"{tuple(k.shape)}, causal={causal}, q_offset={qo}, "
            f"kv_offset={ko}, kv_len={n}, window={w}; rows with no valid "
            f"key {none})")
        worst = max(worst, err)
        del q, k, v, got, want
    torch.cuda.empty_cache()
    return worst


def tail_inputs(dev, rows, seed=0):
    """``shared_tail_attention``'s inputs at ``TAIL_*``: ``rows`` queries,
    one tail, first keys drawn over 0 .. ``TAIL_FIRST_MAX``, rows 0, 1 and
    2 at the tail's first key, its last and past its end."""
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((rows, TAIL_HEADS, TAIL_DIM), generator=g, device=dev)
    k, v = (torch.randn((TAIL_KEYS, TAIL_KV_HEADS, TAIL_DIM), generator=g,
                        device=dev) for _ in range(2))
    first = torch.randint(0, TAIL_FIRST_MAX + 1, (rows,), generator=g,
                          device=dev, dtype=torch.int32)
    first[:3] = torch.tensor([0, TAIL_KEYS - 1, TAIL_KEYS], device=dev)
    return (q.to(torch.bfloat16), k.to(torch.bfloat16), v.to(torch.bfloat16),
            first)


def check_shared_tail(dev):
    """The tail kernel against its plain version at each of ``TAIL_ROWS``,
    bf16 (2e-2), out and lse; a row that sees no key must hold out 0 and
    lse -inf in both. Returns the largest error over the rows that see a
    key."""
    from repro_torch.kernels import ops, ref
    worst = 0.0
    for label, rows in TAIL_ROWS:
        args = tail_inputs(dev, rows)
        got = ops.shared_tail_attention(*args)
        torch.cuda.synchronize()
        want = ref.shared_tail_attention_ref(*args)
        blind = args[3] >= TAIL_KEYS
        for a, b in zip(got, want):
            torch.testing.assert_close(a.float(), b.float(), rtol=2e-2,
                                       atol=2e-2)
        check(bool((got[0][blind] == 0).all()) and
              bool(torch.isneginf(got[1][blind]).all()),
              ("tail kernel: rows that see no key", label))
        err = max(float((a[~blind].float() - b[~blind].float()).abs().max())
                  for a, b in zip(got, want))
        say(f"[check] shared_tail_attention    {label:7s} bfloat16 "
            f"max_abs_err={err:.3e} tol=0.02 ok (q {tuple(args[0].shape)}, "
            f"k {tuple(args[1].shape)}, first 0..{TAIL_FIRST_MAX}; rows that "
            f"see no key {int(blind.sum())})")
        worst = max(worst, err)
    return worst


def check_kernels(inputs, dtype, label, tag="check"):
    """Each kernel against its plain version on ``inputs`` (masked rows of
    the shared kernels must hold 0 and -1e30); returns max |kernel -
    plain| by kernel."""
    from repro_torch.kernels import ops
    plain = plain_versions()
    errs = {}
    for name, args in inputs.items():
        got = getattr(ops, name)(*args)
        torch.cuda.synchronize()
        want = (plain_by_chunk(plain[name], args)
                if label == "prefill" and name.startswith("shared")
                else plain[name](*args))
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        err = max(float((a.float() - b.float()).abs().max())
                  for a, b in zip(got, want))
        tol = 2e-5 if name == "router_scores" else TOL[dtype]
        for a, b in zip(got, want):
            torch.testing.assert_close(a.float(), b.float(),
                                       rtol=tol, atol=tol)
        if name.startswith("shared_chunk_attention"):
            rows = ~args[-1]              # masked rows: 0 and -1e30
            check(bool((got[0][rows] == 0).all()) and
                  bool((got[1][rows] == -1e30).all()),
                  ("masked rows", name, label, dtype))
        say(f"[{tag}] {name:24s} {label:7s} {str(dtype)[6:]:8s} "
            f"max_abs_err={err:.3e} tol={tol:g} ok")
        errs[name] = err
    return errs


def check_window(inputs, dtype, label, window):
    """Both decode kernels with a sliding window against their plain
    versions, and paged == slotted bit for bit; returns max |kernel -
    plain| by kernel."""
    from repro_torch.kernels import ops
    plain = plain_versions()
    errs = {}
    for name in ("decode_attention", "paged_decode_attention"):
        args = inputs[name]
        got = getattr(ops, name)(*args, window=window)
        want = plain[name](*args, window=window)
        torch.cuda.synchronize()
        errs[name] = max(float((a.float() - b.float()).abs().max())
                         for a, b in zip(got, want))
        for a, b in zip(got, want):
            torch.testing.assert_close(a.float(), b.float(), rtol=TOL[dtype],
                                       atol=TOL[dtype])
        say(f"[check] {name:24s} {label:7s} {str(dtype)[6:]:8s} "
            f"window={window} max_abs_err={errs[name]:.3e} ok")
    paged = inputs["paged_decode_attention"]
    got = ops.paged_decode_attention(*paged, window=window)
    want = ops.decode_attention(*slotted_view(*paged), window=window)
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(got, want))
    say(f"[check] paged == slotted decode kernel {label:7s} "
        f"{str(dtype)[6:]:8s} window={window} bitwise={same}")
    check(same, ("paged vs slotted decode kernel, window", label, dtype))
    return errs


def expected_launches(L, steps, routed, unique,
                      shared="shared_chunk_attention", prefills=0):
    """Launch counts a run must show: per layer, every call with a routed
    shared partial (decode step, bucketed prefill, prefill chunk) launches
    router_scores and the shared kernel once and lse_merge twice (K-chunk
    merge, unique + shared merge); every decode step also launches the
    unique decode kernel of its layout once; each of the ``prefills``
    prefill calls (bucketed prefill, prefill chunk, corpus registration)
    launches the prefill attention kernel once."""
    want = dict.fromkeys(SOURCES, 0)
    want.update({"router_scores": L * routed, "lse_merge": 2 * L * routed,
                 shared: L * routed, unique: L * steps,
                 "flash_prefill_attention": L * prefills})
    return want


def phase_serve(cfg, argv=SERVE_ARGV, requests=REQUESTS,
                new_tokens=NEW_TOKENS, tag="serve", unique="decode_attention"):
    """``serve.serve(argv)`` on a registry of its own, with exact launch
    counts; returns (counts, summary, the finished requests)."""
    from repro_torch import obs
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    gc.collect()            # an earlier engine's cycles hold card memory
    torch.cuda.empty_cache()
    prev = obs.set_registry(obs.MetricsRegistry())
    try:
        ops.reset_launches()
        summary, done = serve.serve(argv)
        counts = ops.launch_counts()
    finally:
        obs.set_registry(prev)
    L = cfg.num_layers
    steps, prefills = summary["decode_steps"], summary["prefills"]
    # per layer: a decode step launches each kernel once and lse_merge twice
    # (K-chunk merge, unique + shared merge); a routed prefill launches all
    # but the unique decode kernel, and the prefill attention kernel, as
    # the corpus registration does
    want = expected_launches(L, steps, routed=steps + prefills,
                             unique=unique, prefills=prefills + 1)
    say(f"[{tag}] launches {json.dumps(counts)}")
    say(f"[{tag}] expected {json.dumps(want)}")
    check(summary["finished"] == requests, ("finished", summary["finished"]))
    check(summary["tokens"] == requests * new_tokens,
          ("tokens", summary["tokens"]))
    check(all(counts[k] > 0 for k, n in want.items() if n),
          ("a kernel of the path never ran", counts))
    check(counts == want, ("launch counts", counts, want))
    say(f"[{tag}] finished={summary['finished']} tokens={summary['tokens']} "
        f"tokens_per_s={summary['tokens_per_s']:.1f} "
        f"decode_step_p50_s={summary['decode_step_p50_s']:.4f} "
        f"corpus_register_s={summary['corpus_register_s']:.2f} "
        f"peak_device_memory_bytes={summary['peak_device_memory_bytes']}")
    return counts, summary, done


def phase_paged(cfg, dev):
    """Phase 3's model, weights (seed 0) and corpus, served with the paged
    layout through ``ServingEngine``: 64 prompts of 250 tokens, the same 64
    again (prefix hits, copy-on-write of the partial tail page), then 2
    prompts of 1,000 tokens (chunked prefill). The first 128 are served
    again on a slotted engine; their generations must be equal. Returns
    (paged run's launch counts, params, the registered store)."""
    from repro_torch import obs
    from repro_torch.data.pipeline import CorpusSpec, synthesize_corpus
    from repro_torch.kernels import ops
    from repro_torch.models.model import build_model
    from repro_torch.serving.engine import EngineConfig, ServingEngine

    params = build_model(cfg).init(torch.Generator(device=dev).manual_seed(0),
                                   dev)
    corpus = synthesize_corpus(CorpusSpec("domain-0", CORPUS, cfg.vocab_size,
                                          seed=0))
    rng = np.random.default_rng(0)
    half = [rng.integers(0, cfg.vocab_size, PAGED_PROMPT).tolist()
            for _ in range(REQUESTS // 2)]
    longs = [rng.integers(0, cfg.vocab_size, LONG_PROMPT).tolist()
             for _ in range(2)]

    def serve(layout, prompts):
        reg = obs.MetricsRegistry()
        prev = obs.set_registry(reg)
        try:
            eng = ServingEngine(cfg, params, EngineConfig(
                max_slots=SLOTS, max_seq=512, cache_dtype=torch.bfloat16,
                kv_layout=layout, block_size=BLOCK))
            eng.register_corpus("domain-0", corpus)
            for prompt in prompts:
                eng.submit(prompt, NEW_TOKENS, corpus_id="domain-0")
            ops.reset_launches()
            done = eng.run()
            counts = ops.launch_counts()
        finally:
            obs.set_registry(prev)
        c = {name: int(reg.counter(name).value) for name in (
            "engine/decode_steps", "engine/prefills", "engine/prefill_chunks",
            "engine/chunked_prefills", "kvcache/prefix_hits",
            "kvcache/cow_copies", "kvcache/blocks_appended",
            "kvcache/pool_growths", "moska/dropped_queries")}
        c["hbm_high_water_bytes"] = int(
            reg.gauge("engine/hbm_high_water_bytes").value)
        c["decode_step_p50_s"] = float(np.median(eng.metrics["decode_step_s"]))
        c["tokens_per_s"] = reg.gauge("engine/last_run_tokens_per_s").value
        say(f"[paged] {layout}: {json.dumps(c)}")
        check(len(done) == len(prompts) and
              all(len(r.generated) == NEW_TOKENS for r in done),
              (layout, "unfinished requests"))
        return eng, c, counts, {r.uid: r.generated for r in done}

    eng, c, counts, gens = serve("paged", half + half + longs)
    store = eng.stores["domain-0"]
    del eng
    L = cfg.num_layers
    steps = c["engine/decode_steps"]
    routed = (steps + c["engine/prefills"] - c["engine/chunked_prefills"]
              + c["engine/prefill_chunks"])
    want = expected_launches(L, steps, routed, unique="paged_decode_attention",
                             prefills=routed - steps)
    say(f"[paged] launches {json.dumps(counts)}")
    say(f"[paged] expected {json.dumps(want)}")
    check(c["kvcache/prefix_hits"] >= REQUESTS // 2 and
          c["kvcache/cow_copies"] >= REQUESTS // 2, ("prefix sharing", c))
    check(c["engine/chunked_prefills"] == 2, ("chunked prefills", c))
    check(counts == want, ("paged launch counts", counts, want))
    torch.cuda.empty_cache()

    eng, c_s, _, gens_s = serve("slotted", half + half)
    del eng
    torch.cuda.empty_cache()
    same = all(gens[u] == gens_s[u] for u in gens_s)
    say(f"[paged] first {REQUESTS} generations equal the slotted engine's: "
        f"{same} (dropped queries paged={c['moska/dropped_queries']} "
        f"slotted={c_s['moska/dropped_queries']}); hbm_high_water_bytes "
        f"paged={c['hbm_high_water_bytes']} "
        f"slotted={c_s['hbm_high_water_bytes']}; decode_step_p50_s "
        f"paged={c['decode_step_p50_s']:.4f} "
        f"slotted={c_s['decode_step_p50_s']:.4f}")
    check(same, "paged generations differ from slotted")
    chunked_vs_single_shot(cfg, params, store, longs[0], dev)
    return counts, params, store


TIER_COUNTERS = ("engine/decode_steps", "engine/prefills",
                 "engine/prefill_tokens", "kvcache/swap_in_hits",
                 "kvcache/swap_in_bytes", "kvcache/offloads",
                 "kvcache/offload_bytes", "kvcache/host_pool_evictions",
                 "kvcache/prefix_hits", "kvcache/prefetch_issued",
                 "kvcache/prefetch_hits", "kvcache/prefetch_wasted",
                 "kvcache/spec_pages_alloc", "kvcache/spec_pages_reclaimed")


def phase_tier(cfg, dev, params):
    """Phase 3h: engines A (host tier, async defaults), B (no tier) and C
    (tier, async off) over the same two passes of 128 prompts; see the
    head of this file. Returns the launch counts of every pass, summed."""
    from repro_torch import obs
    from repro_torch.data.pipeline import CorpusSpec, synthesize_corpus
    from repro_torch.kernels import ops
    from repro_torch.serving.engine import EngineConfig, ServingEngine

    corpus = synthesize_corpus(CorpusSpec("tier", TIER_CORPUS,
                                          cfg.vocab_size, seed=0))
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab_size, PAGED_PROMPT).tolist()
               for _ in range(TIER_PROMPTS)]
    check(len({tuple(p) for p in prompts}) == TIER_PROMPTS,
          "tier prompts are not distinct")
    L = cfg.num_layers
    sync = dict(prefetch_depth=0, spec_append=False, overlap_waves=False)
    engines = {"A": dict(host_pool_blocks=TIER_HOST_PAGES),
               "B": dict(host_pool_blocks=0),
               "C": dict(host_pool_blocks=TIER_HOST_PAGES, **sync)}
    gens, res = {}, {}
    total = collections.Counter()
    for name, kw in engines.items():
        reg = obs.MetricsRegistry()
        prev = obs.set_registry(reg)
        try:
            eng = ServingEngine(cfg, params, EngineConfig(
                max_slots=SLOTS, max_seq=512, cache_dtype=torch.bfloat16,
                kv_layout="paged", block_size=BLOCK, num_blocks=TIER_PAGES,
                **kw))
            eng.register_corpus("tier", corpus)
            stall = reg.histogram("engine/decode_stall_s",
                                  obs.LATENCY_EDGES_S)
            for p in (1, 2):
                before = {c: reg.counter(c).value for c in TIER_COUNTERS}
                stall0, steps0 = stall.sum, len(eng.metrics["decode_step_s"])
                for prompt in prompts:
                    eng.submit(prompt, NEW_TOKENS, corpus_id="tier")
                ops.reset_launches()
                t0 = time.perf_counter()
                done = list(eng.run())
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                counts = ops.launch_counts()
                total.update(counts)
                eng.scheduler.finished.clear()
                d = {c.split("/")[1]: int(reg.counter(c).value - before[c])
                     for c in TIER_COUNTERS}
                d["wall_s"] = wall
                d["decode_step_p50_s"] = float(np.median(
                    eng.metrics["decode_step_s"][steps0:]))
                d["decode_stall_sum_s"] = stall.sum - stall0
                res[name, p] = d
                gens[name, p] = {tuple(r.prompt): tuple(r.generated)
                                 for r in done}
                want = expected_launches(
                    L, d["decode_steps"], d["decode_steps"] + d["prefills"],
                    unique="paged_decode_attention", prefills=d["prefills"])
                say(f"[tier] {name} pass {p}: {json.dumps(d)}")
                check(len(done) == TIER_PROMPTS and
                      all(len(r.generated) == NEW_TOKENS for r in done),
                      (name, p, "unfinished requests"))
                check(counts == want, (name, p, "launch counts", counts,
                                       want))
            lat = {h: reg.histogram(f"kvcache/{h}", obs.LATENCY_EDGES_S)
                   for h in ("swap_out_latency_s", "swap_in_latency_s")}
            say(f"[tier] {name}: engine swap latencies, host time to queue "
                "(the copies run on the card afterwards): " + ", ".join(
                    f"{h} n={x.count} mean={x.mean * 1e3:.4f} ms "
                    f"min={(x.min or 0) * 1e3:.4f} ms "
                    f"max={(x.max or 0) * 1e3:.4f} ms "
                    f"bucket p50<={x.quantile(0.5) * 1e3:.4f} ms"
                    for h, x in lat.items()))
            if name == "A":
                eng._prefetch.check_invariants()
                pf = eng._prefetch
                say(f"[tier] A prefetch accounting: issued={pf.issued} "
                    f"resolved={pf.resolved} discarded={pf.discarded} "
                    f"in_flight={pf.in_flight}")
        finally:
            obs.set_registry(prev)
        del eng
        torch.cuda.empty_cache()
    for p in (1, 2):
        same = gens["A", p] == gens["B", p] == gens["C", p]
        say(f"[tier] pass {p}: generations of A, B and C equal bit for bit: "
            f"{same}")
        check(same, ("tier generations differ", p))
    for name in ("A", "C"):
        d = res[name, 2]
        check(d["swap_in_hits"] == TIER_PROMPTS and d["prefills"] == 0,
              (name, "pass 2 must swap in every prefix", d))
    check(res["B", 2]["prefills"] == TIER_PROMPTS and
          res["B", 2]["prefill_tokens"] == TIER_PROMPTS * PAGED_PROMPT,
          ("B pass 2 must rebuild every prefix", res["B", 2]))
    a = {k: res["A", 1][k] + res["A", 2][k] for k in res["A", 1]}
    check(a["prefetch_hits"] >= 1 and a["spec_pages_alloc"] >= 1,
          ("A took no prefetch hit or no speculative page", a))
    c_stall = sum(res["C", p]["decode_stall_sum_s"] for p in (1, 2))
    say("[tier] decode_stall_sum_s, both passes: "
        f"A={a['decode_stall_sum_s']:.6f} C={c_stall:.6f}; "
        "pass 2 wall (s) " + " ".join(
            f"{n}={res[n, 2]['wall_s']:.3f}" for n in engines) +
        "; pass 2 prefill_tokens " + " ".join(
            f"{n}={res[n, 2]['prefill_tokens']}" for n in engines))
    time_swaps(cfg, dev)
    return dict(total)


def time_swaps(cfg, dev, entries=16):
    """One prompt's pages (16 pages x 22 layers, bf16) each way through the
    engine's calls: swap-out = ``extract_blocks`` + a pinned
    ``HostBlockPool.offload``, swap-in = a wait on the offload's event +
    ``insert_blocks`` from pinned memory. First the host's time to queue
    each offload as the engine calls it (block ids as a list), in two
    rounds: the second finds the first round's pinned blocks freed and
    cached by the allocator. Then the device time of each call's copies:
    CUDA events behind a spin kernel that keeps the card busy while the
    host queues (block ids already on the card, the pinned allocator
    warm); median over ``entries``, and GB/s. Then the host link itself:
    one 256 MB pinned copy each way."""
    from repro_torch.kvcache import paged as tpg

    nb = -(-PAGED_PROMPT // BLOCK)
    g = torch.Generator(device=dev).manual_seed(4)
    shape = (cfg.num_layers, 1 + entries * nb, BLOCK, cfg.num_kv_heads,
             cfg.head_dim)
    pool = tpg.PagedKVCache(*(torch.randn(shape, generator=g, device=dev)
                              .to(torch.bfloat16) for _ in range(2)))
    lists = [list(range(1 + i * nb, 1 + (i + 1) * nb))
             for i in range(entries)]
    ids = [torch.tensor(x, device=dev) for x in lists]
    gens = [(b, 1) for b in range(nb)]
    nbytes = 2 * nb * pool.k[:, 0].numel() * pool.k.element_size()
    cur = torch.cuda.current_stream()
    for rnd in ("first", "second"):
        host = tpg.HostBlockPool(entries * nb)
        torch.cuda.synchronize()
        t = []
        for i in range(entries):
            t0 = time.perf_counter()
            host.offload(i, *tpg.extract_blocks(pool, lists[i]), 0, gens)
            t.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
        say(f"[tier] swap-out of one prompt's pages, host time to queue "
            f"({rnd} round, ids as a list): p50 "
            f"{float(np.median(t)) * 1e3:.4f} ms, max {max(t) * 1e3:.4f} ms")
        del host
    host = tpg.HostBlockPool(entries * nb)

    def on_card(fn):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        a.record()
        fn()
        b.record()
        return a, b

    def swap_in(i):
        entry = host.peek(i)
        cur.wait_event(entry["ready"])
        tpg.insert_blocks(pool, ids[(i + 1) % entries], entry["k"],
                          entry["v"])

    outs = [on_card(lambda i=i: host.offload(
        i, *tpg.extract_blocks(pool, ids[i]), 0, gens))
        for i in range(entries)]
    want = [t[:, lists[0]].clone() for t in pool]
    ins = [on_card(lambda i=i: swap_in(i)) for i in range(entries)]
    torch.cuda.synchronize()
    check(all(torch.equal(t[:, lists[1]], w) for t, w in zip(pool, want)),
          "swap round trip changed the pages")
    for label, ev in (("swap-out (gather + D2H)", outs),
                      ("swap-in (H2D + scatter)", ins)):
        ms = float(np.median([a.elapsed_time(b) for a, b in ev]))
        say(f"[tier] {label} of one prompt's pages ({nbytes} B): device "
            f"p50 {ms:.4f} ms over {entries}, {nbytes / ms / 1e6:.2f} GB/s")
    dev_buf = torch.empty(LINK_BYTES, dtype=torch.uint8, device=dev)
    host_buf = torch.empty(LINK_BYTES, dtype=torch.uint8, pin_memory=True)
    for label, dst, src in (("H2D", dev_buf, host_buf),
                            ("D2H", host_buf, dev_buf)):
        dst.copy_(src, non_blocking=True)            # warm
        a, b = on_card(lambda: dst.copy_(src, non_blocking=True))
        b.synchronize()
        ms = a.elapsed_time(b)
        say(f"[tier] host link {label}, one pinned {LINK_BYTES} B copy: "
            f"{ms:.4f} ms, {LINK_BYTES / ms / 1e6:.2f} GB/s")
    del dev_buf, host_buf, pool, host


def chunked_vs_single_shot(cfg, params, store, prompt, dev):
    """Last-token logits of a 1,000-token prompt prefilled in 128-token
    chunks, against one bucket-padded prefill of the same tokens: within
    2e-2 of the largest logit (other contraction shapes, bf16)."""
    from repro_torch.kvcache.cache import init_kv_cache
    from repro_torch.models import dense

    n, C, V = len(prompt), 128, -(-len(prompt) // 128) * 128
    start = store.total_tokens
    toks = torch.zeros((1, V), dtype=torch.long, device=dev)
    toks[0, :n] = torch.tensor(prompt, device=dev)

    def cache():
        return init_kv_cache(cfg.num_layers, 1, V, cfg.num_kv_heads,
                             cfg.head_dim, torch.bfloat16, dev)

    ctx = cache()
    for s0 in range(0, n, C):
        lc, ctx = dense.prefill_chunk(cfg, params, toks[:, s0:s0 + C], ctx,
                                      store=store, start_pos=start,
                                      chunk_len=min(C, n - s0))
    ls, _ = dense.prefill(cfg, params, toks, cache(), store=store,
                          start_pos=start, true_len=n)
    err = float((lc - ls).abs().max())
    scale = float(ls.abs().max())
    say(f"[paged] chunked vs single-shot prefill of {n} tokens: last-token "
        f"logits max_abs_err={err:.3e}, |logits| max={scale:.3f} "
        f"(bound {2e-2 * scale:.3e}); greedy equal="
        f"{bool((lc.argmax(-1) == ls.argmax(-1)).all())}")
    check(err <= 2e-2 * scale, ("chunked vs single-shot prefill", err))


def phase_q8(cfg, dev, params, store):
    """The registered store's K/V quantized to int8 (per token and kv head):
    one prefill of 64 prompts and 32 decode steps at full width, every
    shared partial through ``shared_chunk_attention_q8``. Then the first
    step again over the int8 and over the bf16 store, from the same cache:
    with the served top-8 routing (reported: a small change in one layer's
    output can flip a later layer's routing for a few rows) and with every
    chunk routed, where the logits must agree within 0.1 (the bound of
    ``tests/test_kernels.py``'s int8 end-to-end test). Returns the run's
    launch counts."""
    from repro_torch.core.shared_kv import build_store
    from repro_torch.kernels import ops
    from repro_torch.kvcache.cache import KVCache, init_kv_cache
    from repro_torch.models import dense

    L, E, C, KH, D = store.k.shape
    q8 = build_store(store.k.reshape(L, E * C, KH, D),
                     store.v.reshape(L, E * C, KH, D), C, quantize=True)
    batch = SLOTS
    prompts = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (batch, PROMPT))).to(dev)
    cache = init_kv_cache(L, batch, 512, KH, D, torch.bfloat16, dev)
    ops.reset_launches()
    logits, _ = dense.prefill(cfg, params, prompts, cache, store=q8,
                              start_pos=q8.total_tokens)
    tok0 = logits.argmax(-1)
    before = KVCache(*(t.clone() for t in cache))
    tok = tok0
    for _ in range(NEW_TOKENS):
        lg, _ = dense.decode_step(cfg, params, tok, cache, store=q8)
        tok = lg.argmax(-1)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    want = expected_launches(L, NEW_TOKENS, routed=NEW_TOKENS + 1,
                             unique="decode_attention",
                             shared="shared_chunk_attention_q8", prefills=1)
    say(f"[q8] launches {json.dumps(counts)}")
    say(f"[q8] expected {json.dumps(want)}")
    check(counts == want, ("q8 launch counts", counts, want))
    del cache

    every = dataclasses.replace(cfg, moska=dataclasses.replace(
        cfg.moska, top_k_chunks=E))
    for label, c in (("top-8 routing", cfg), ("every chunk routed", every)):
        lq, lf = (dense.decode_step(c, params, tok0, KVCache(
            *(t.clone() for t in before)), store=st)[0] for st in (q8, store))
        err = float((lq - lf).abs().max())
        ok = torch.allclose(lq, lf, rtol=0.1, atol=0.1)
        rows = int(torch.isclose(lq, lf, rtol=0.1, atol=0.1).all(-1).sum())
        say(f"[q8] first step, {label}: int8 store ({q8.nbytes} B) vs bf16 "
            f"store ({store.nbytes} B) logits max_abs_err={err:.3e}, "
            f"|logits| max={float(lf.abs().max()):.3f}, rows within "
            f"rtol=atol=0.1: {rows}/{batch}, greedy equal on "
            f"{int((lq.argmax(-1) == lf.argmax(-1)).sum())}/{batch}")
    check(ok, ("int8 vs bf16 store logits, every chunk routed", err))
    return counts


def phase_agree(cfg, dev, corpus_len=32768):
    """One decode step of 8 slots on the card and on the CPU, fp32: over
    the store, over the store quantized to int8, and as a paged step. The
    32,768-token corpus is 16 chunks, so top-8 routing still selects."""
    from repro_torch.core.shared_kv import build_store
    from repro_torch.data.pipeline import CorpusSpec, synthesize_corpus
    from repro_torch.kvcache.cache import init_kv_cache
    from repro_torch.kvcache.paged import PagedKVCache
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

    def agree(label, step):
        card_vs_cpu(f"8-slot fp32 {label}", step, params, params_cpu, tokens,
                    uc, dev)

    q8 = build_store(cc.k[:, 0], cc.v[:, 0], cfg.moska.chunk_size,
                     quantize=True)
    stores = {dev: (store, q8), cpu: (on(cpu, store), on(cpu, q8))}
    agree("decode step", lambda p, t, c, d: dense.decode_step(
        cfg, p, t, c, store=stores[d][0])[0])
    agree("decode step over an int8 store", lambda p, t, c, d:
          dense.decode_step(cfg, p, t, c, store=stores[d][1])[0])

    # the same cache in scrambled pages of 16 tokens
    M = M_PAGES
    table = (torch.from_numpy(np.random.default_rng(1).permutation(B * M))
             .view(B, M).to(torch.int32) + 1)

    def paged_step(p, t, c, d):
        L, _, _, KH, D = c.k.shape
        pool = PagedKVCache(*(torch.zeros((L, B * M + 1, BLOCK, KH, D),
                                          device=d) for _ in range(2)))
        tbl = table.to(d)
        pool.k[:, tbl.long()] = c.k.view(L, B, M, BLOCK, KH, D)
        pool.v[:, tbl.long()] = c.v.view(L, B, M, BLOCK, KH, D)
        return dense.decode_step_paged(cfg, p, t, pool, tbl, c.length,
                                       c.offset, store=stores[d][0])[0]

    agree("paged decode step", paged_step)


# the kernels that phases 3m and 3w run (no int8 store there; 3w no pages)
MOE_KERNELS = ("shared_chunk_attention", "decode_attention",
               "paged_decode_attention", "lse_merge", "router_scores")
WIDTH_KERNELS = MOE_KERNELS[:2] + MOE_KERNELS[3:]


def phase_moe(dev, errs):
    """Phase 3m: granite-moe-1b-a400m at full width and depth through
    ``serve.serve``, slotted then paged, each with exact launch counts; the
    paged generations must equal the slotted ones (both engines prefill a
    prompt as one 256-row bucket, and every wave of this stream holds 64
    live slots, so both hand the MoE FFN the same rows); a card-vs-CPU
    fp32 decode step; then one decode step profiled. Before them, every
    kernel of the phase at its shapes against its plain version: the
    served decode step, the served prefill, and the card-vs-CPU step's
    prefill and decode; ``errs`` takes the bf16 errors. Returns the two
    runs' launch counts."""
    from repro_torch.configs import get_config
    cfg = get_config(MOE_ARCH)
    bf16, fp32 = torch.bfloat16, torch.float32
    agree = dict(corpus=MOE_CORPUS, slots=8, slab=PROMPT + 8,
                 lens=(PROMPT + 1, PROMPT + 2))
    check_kernels_at(
        cfg, dev, "moe", errs, MOE_KERNELS,
        decodes=[(bf16, dict(corpus=MOE_CORPUS)),
                 (fp32, dict(corpus=MOE_CORPUS)), (fp32, agree)],
        prefills=[(bf16, dict(corpus=MOE_CORPUS)),
                  (fp32, dict(corpus=MOE_CORPUS, batch=8))])
    runs = {}
    for layout, unique in (("slotted", "decode_attention"),
                           ("paged", "paged_decode_attention")):
        counts, summary, done = phase_serve(
            cfg, argv=MOE_ARGV + ["--kv-layout", layout],
            requests=REQUESTS, new_tokens=NEW_TOKENS, tag="moe",
            unique=unique)
        runs[layout] = counts, summary, {r.uid: tuple(r.generated)
                                         for r in done}
        say(f"[moe] {layout}: expert slots dispatched="
            f"{summary['moe_dispatched_slots']} dropped="
            f"{summary['moe_dropped_slots']}; hbm_high_water_bytes="
            f"{summary['hbm_high_water_bytes']}")
        del done
        torch.cuda.empty_cache()
    gs, gp = runs["slotted"][2], runs["paged"][2]
    check(sorted(gs) == sorted(gp) and len(gs) == REQUESTS,
          "moe: the two runs served other requests")
    same = sum(gs[u] == gp[u] for u in gs)
    say(f"[moe] paged generations equal the slotted engine's on {same}/"
        f"{len(gs)} requests")
    check(same == len(gs), ("moe: paged vs slotted generations", same))
    agree_arch(cfg, dev, 8, MOE_CORPUS, "moe")
    torch.cuda.empty_cache()
    profile_moe_step(cfg, dev)
    return runs["slotted"][0], runs["paged"][0]


def check_kernels_at(cfg, dev, tag, errs, kernels, decodes=(), prefills=()):
    """Each kernel in ``kernels`` at ``cfg``'s heads against its plain
    version, at each (dtype, ``path_inputs`` keywords) of ``decodes`` and
    each (dtype, ``prefill_inputs`` keywords) of ``prefills``; the merge's
    routed and pair entries too, at the same groups. ``errs`` keeps the
    largest bf16 error by kernel."""
    for label, make, shapes in (("path", path_inputs, decodes),
                                ("prefill", prefill_inputs, prefills)):
        for dtype, kw in shapes:
            say(f"[{tag}] {cfg.name} {label} {str(dtype)[6:]} "
                f"{json.dumps({k: v for k, v in kw.items()})}")
            inputs = {n: a for n, a in make(cfg, dtype, dev, **kw).items()
                      if n in kernels}
            got = check_kernels(inputs, dtype, label, tag=tag)
            del inputs
            rows = kw.get("rows", PROMPT)
            rb = min(128, rows)
            groups = (kw.get("slots", SLOTS) if label == "path" else
                      kw.get("batch", 1) * rows // rb)
            check_merge_entries(cfg, dev, dtype, label, tag=tag,
                                corpus=kw["corpus"], groups=groups, rb=rb)
            torch.cuda.empty_cache()
            if dtype == torch.bfloat16:
                for name, e in got.items():
                    errs[name] = max(errs.get(name, 0.0), e)


def registered_store(cfg, model, params, corpus):
    """The shared store of ``corpus`` (1, n) as the engine registers it."""
    from repro_torch.core.shared_kv import build_store
    cc = model.init_cache(1, corpus.shape[1], cfg_dtype(cfg), corpus.device)
    model.prefill(params, corpus, cc)
    return build_store(cc.k[:, 0], cc.v[:, 0], cfg.moska.chunk_size)


def cfg_dtype(cfg):
    from repro_torch.models.dense import torch_dtype
    return torch_dtype(cfg.dtype)


def profile_moe_step(cfg, dev):
    """One decode step of granite at the served shapes (64 slots of
    256..287 tokens, a 16-chunk store of random K/V, bf16) under
    torch.profiler, as phase 6 profiles tinyllama's; then the same step
    again, to split the MoE FFN's device time by stage, and once more to
    count its dropped expert slots."""
    from repro_torch import obs
    from repro_torch.core.shared_kv import build_store
    from repro_torch.kvcache.cache import init_kv_cache
    from repro_torch.models import dense
    from repro_torch.models.moe import moe_capacity

    g = torch.Generator(device=dev).manual_seed(3)
    L, KH, D = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim
    params = dense.init_params(cfg, g, dev)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)

    store = build_store(randn(L, MOE_CORPUS, KH, D),
                        randn(L, MOE_CORPUS, KH, D), cfg.moska.chunk_size)
    cache = init_kv_cache(L, SLOTS, 512, KH, D, torch.bfloat16, dev)
    cache.k.copy_(randn(*cache.k.shape))
    cache.v.copy_(randn(*cache.v.shape))
    cache.length.copy_(torch.randint(PROMPT, PROMPT + 32, (SLOTS,),
                                     generator=g, device=dev))
    cache.offset.fill_(MOE_CORPUS)
    tokens = torch.randint(0, cfg.vocab_size, (SLOTS,), generator=g,
                           device=dev)

    def step():
        cache.length.clamp_(max=PROMPT + 32)      # stay inside the slab
        dense.decode_step(cfg, params, tokens, cache, store=store)

    for _ in range(3):
        step()
    torch.cuda.synchronize()
    walls = []
    for _ in range(8):
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    wall = float(np.median(walls))
    names, launches = _profile_step("moe decode step", step, wall)
    mma = [n for n in names if "shared_chunk_mma_kernel" in n]
    slab = [n for n in names if "decode_slab_kernel" in n]
    say(f"[profile] moe decode step: {launches} launches (tinyllama's step: "
        f"{STEP_LAUNCHES['decode step']}); tensor-core shared kernel "
        f"launched: {bool(mma)}; decode_slab_kernel launched: {bool(slab)}")
    check(mma and slab, ("moe decode step kernels", mma, slab))
    moe_stages(step)
    rec, reg = obs.DeviceRecorder(), obs.MetricsRegistry()
    cache.length.clamp_(max=PROMPT + 32)
    dense.decode_step(cfg, params, tokens, cache, store=store, rec=rec)
    rec.flush(reg)
    routed = int(reg.counter("moe/routed_slots").value)
    check(routed == SLOTS * cfg.moe.top_k * L, ("routed expert slots", routed))
    say(f"[profile] moe decode step: expert slots dropped "
        f"{routed - int(reg.counter('moe/dispatched_slots').value)} of "
        f"{routed} (capacity "
        f"{moe_capacity(SLOTS, cfg.moe)} slots for each of "
        f"{cfg.moe.num_experts} experts)")


# the MoE FFN's stages, by the outermost ATen op of ``moe_ffn`` that a
# kernel ran under; ops not named here are the elementwise rest (SiLU x up,
# the gate normalisation and weighted sum, dtype casts)
MOE_STAGES = {
    "aten::bmm": "expert GEMMs",
    **dict.fromkeys(("aten::matmul", "aten::mm", "aten::softmax"),
                    "router (fp32 GEMM, softmax)"),
    "aten::sort": "top-k (sort)",
    **dict.fromkeys(("aten::one_hot", "aten::cumsum", "aten::sub",
                     "aten::mul_", "aten::lt", "aten::where"),
                    "one-hot/cumsum"),
    **dict.fromkeys(("aten::new_zeros", "aten::index_put_", "aten::index",
                     "aten::reshape", "aten::pad"), "scatter/gather"),
}


def _moe_op(e, moe_range):
    """(whether ``moe_ffn`` ran this profiled op, its outermost ATen op
    below the ``moe_range`` range that ``dense._ffn`` opens around it)."""
    top, p = e.name, e.cpu_parent
    while p is not None:
        if p.name == moe_range:
            return True, top
        if p.name.startswith("aten::"):
            top = p.name
        p = p.cpu_parent
    return False, top


def moe_stages(step):
    """Device time of one profiled ``step`` by the MoE FFN's stage: each
    op's own kernels, by the outermost op ``moe_ffn`` called (under a
    profiler, ``dense._ffn`` wraps each ``moe_ffn`` call in a
    ``record_function`` range). The rest of the step's device time is the
    busy time less the MoE FFN's."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models.dense import MOE_RANGE
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    # the range's own spans on the card's timeline are not kernels
    busy = sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type.name == "CUDA" and e.key != MOE_RANGE)
    by = collections.Counter()
    for e in prof.events():
        if e.device_type.name != "CPU" or e.self_device_time_total <= 0:
            continue
        in_moe, top = _moe_op(e, MOE_RANGE)
        if in_moe:
            by[MOE_STAGES.get(top, "elementwise rest")] += \
                e.self_device_time_total
    moe_us = sum(by.values())
    say(f"[profile] moe decode step by stage: device busy {busy / 1e3:.3f} "
        f"ms, the MoE FFN {moe_us / 1e3:.3f} ms = "
        f"{moe_us / max(busy, 1e-9):.3f} of it")
    check(moe_us > 0, "moe decode step: no op attributed to moe_ffn")
    for name, us in by.most_common():
        say(f"[profile]   {us / 1e3:9.3f} ms  {name}")


def phase_widths(dev, errs):
    """Phase 3w: qwen1.5-0.5b at full width and depth, mistral-large-123b
    and internvl2-76b at full width and 2 layers (the one card's memory),
    bf16 over a 16,384-token corpus: every kernel at the arch's heads
    against its plain version; a prefill of 16 requests (internvl2's with
    256 stub patch embeddings in front) and 16 decode steps with exact
    launch counts; then an fp32 decode step of 4 slots on the card and on
    the CPU (internvl2 and mistral with 1 layer). Returns the launch
    counts, summed."""
    from repro_torch.configs import get_config
    total = collections.Counter()
    for arch, layers in WIDTH_ARCHS:
        cfg = get_config(arch)
        if layers is not None:
            cfg = dataclasses.replace(cfg, num_layers=layers)
        t0 = time.perf_counter()
        check_width_kernels(cfg, dev, errs)
        total.update(serve_width(cfg, dev))
        torch.cuda.empty_cache()
        agree_arch(dataclasses.replace(
            cfg, num_layers=cfg.num_layers if layers is None else 1), dev, 4,
            WIDTH_CORPUS, "widths")
        torch.cuda.empty_cache()
        say(f"[widths] {arch}: {time.perf_counter() - t0:.1f} s")
    return dict(total)


def check_width_kernels(cfg, dev, errs):
    """Phase 3w's kernels against their plain versions at ``cfg``'s
    shapes: ``serve_width``'s prefill of 16 sequences of P + 256 rows and
    its decode steps (caches of P + 257 .. P + 272 tokens in a P + 272
    slab), and the card-vs-CPU step's prefill of 4 and its decode."""
    n = width_patches(cfg) + PROMPT
    served = dict(corpus=WIDTH_CORPUS, slots=WIDTH_REQUESTS,
                  slab=n + WIDTH_STEPS, lens=(n + 1, n + WIDTH_STEPS + 1))
    agree = dict(corpus=WIDTH_CORPUS, slots=4, slab=n + 8,
                 lens=(n + 1, n + 2))
    bf16, fp32 = torch.bfloat16, torch.float32
    check_kernels_at(
        cfg, dev, "widths", errs, WIDTH_KERNELS,
        decodes=[(bf16, served), (fp32, served), (fp32, agree)],
        prefills=[(bf16, dict(corpus=WIDTH_CORPUS, batch=WIDTH_REQUESTS,
                              rows=n)),
                  (fp32, dict(corpus=WIDTH_CORPUS, batch=4, rows=n))])


def width_patches(cfg):
    """P: a VLM's stub frontend patches in front of each prompt, else 0."""
    from repro_torch.configs import VLM
    return cfg.encoder.frontend_seq if cfg.family == VLM else 0


def prompt_inputs(cfg, dev, batch, seed):
    """(prompts (batch, 256), patches (batch, P, d) or None, P): a VLM's
    stub frontend gives P = ``frontend_seq`` patch embeddings, drawn at
    the token embeddings' scale; P + 256 is a multiple of 128, as routed
    prefill blocks need."""
    g = torch.Generator(device=dev).manual_seed(seed)
    prompts = torch.randint(0, cfg.vocab_size, (batch, PROMPT), generator=g,
                            device=dev)
    P = width_patches(cfg)
    if not P:
        return prompts, None, 0
    check((P + PROMPT) % 128 == 0, ("frontend patches", P))
    patches = torch.randn((batch, P, cfg.d_model), generator=g, device=dev,
                          dtype=torch.float32) / cfg.d_model ** 0.5
    return prompts, patches.to(cfg_dtype(cfg)), P


def serve_width(cfg, dev):
    """Register the corpus, prefill 16 requests through ``Model.prefill``
    and take 16 decode steps; returns the launch counts of prefill and
    steps, which must be the predicted ones."""
    from repro_torch.data.pipeline import CorpusSpec, synthesize_corpus
    from repro_torch.kernels import ops
    from repro_torch.models.model import build_model

    B, steps = WIDTH_REQUESTS, WIDTH_STEPS
    model = build_model(cfg)
    torch.cuda.reset_peak_memory_stats(dev)
    params = model.init(torch.Generator(device=dev).manual_seed(0), dev)
    corpus = torch.from_numpy(synthesize_corpus(CorpusSpec(
        cfg.name, WIDTH_CORPUS, cfg.vocab_size, seed=0))).long().to(dev)[None]
    t0 = time.perf_counter()
    store = registered_store(cfg, model, params, corpus)
    torch.cuda.synchronize()
    reg_s = time.perf_counter() - t0
    prompts, patches, P = prompt_inputs(cfg, dev, B, seed=2)
    cache = model.init_cache(B, P + PROMPT + steps, cfg_dtype(cfg), dev)
    ops.reset_launches()
    t0 = time.perf_counter()
    logits, _ = model.prefill(params, prompts, cache, store=store,
                              frontend_embeds=patches,
                              start_pos=store.total_tokens)
    tok = logits.argmax(-1)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    check(cache.length.tolist() == [P + PROMPT] * B, ("cache length", P))
    walls = []
    for _ in range(steps):
        t0 = time.perf_counter()
        logits, _ = model.decode_step(params, tok, cache, store=store)
        tok = logits.argmax(-1)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    counts = ops.launch_counts()
    want = expected_launches(cfg.num_layers, steps, routed=steps + 1,
                             unique="decode_attention", prefills=1)
    say(f"[widths] {cfg.name} ({cfg.num_layers} layers, {cfg.num_heads} "
        f"heads over {cfg.num_kv_heads}, D {cfg.head_dim}, d_model "
        f"{cfg.d_model}): launches {json.dumps(counts)}")
    check(counts == want, (cfg.name, "launch counts", counts, want))
    check(bool(torch.isfinite(logits).all()) and
          tuple(logits.shape) == (B, cfg.vocab_size),
          (cfg.name, "logits", tuple(logits.shape)))
    say(f"[widths] {cfg.name}: corpus {WIDTH_CORPUS} tokens registered in "
        f"{reg_s:.2f} s; prefill of {B} x ({P} patches + {PROMPT} tokens) "
        f"{prefill_s:.3f} s; decode step p50 {np.median(walls):.4f} s; "
        f"peak device memory {torch.cuda.max_memory_allocated(dev)} B")
    return counts


def agree_arch(cfg, dev, B, corpus_len, tag):
    """One fp32 decode step of B slots on the card and on the CPU, after
    a prefill of B prompts (a VLM's behind its frontend patches) over a
    ``corpus_len``-token store; ``cfg`` is taken in fp32."""
    from repro_torch.data.pipeline import CorpusSpec, synthesize_corpus
    from repro_torch.models import dense
    from repro_torch.models.model import build_model

    cfg = dataclasses.replace(cfg, dtype="float32")
    model = build_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(1), dev)
    corpus = torch.from_numpy(synthesize_corpus(CorpusSpec(
        "agree", corpus_len, cfg.vocab_size, seed=1))).long().to(dev)[None]
    store = registered_store(cfg, model, params, corpus)
    prompts, patches, P = prompt_inputs(cfg, dev, B, seed=3)
    uc = model.init_cache(B, P + PROMPT + 8, torch.float32, dev)
    logits, _ = model.prefill(params, prompts, uc, store=store,
                              frontend_embeds=patches, start_pos=corpus_len)
    stores = {dev: store, torch.device("cpu"): on(torch.device("cpu"), store)}
    card_vs_cpu(f"{cfg.name} ({cfg.num_layers} layers) {B}-slot fp32 decode "
                "step", lambda p, t, c, d:
                dense.decode_step(cfg, p, t, c, store=stores[d])[0],
                params, params_on_cpu(cfg, params), logits.argmax(-1), uc,
                dev, tag=tag)


def phase_trinity(dev):
    """Phase 3t: trinity-mini at full width and depth through
    ``ServingEngine``: its 32,768-token document registered (a
    ``LayeredStore``: 16 chunks in each full layer, the last 2,047 keys in
    each sliding one), then 64 prompts of 256 tokens, 16 new each, on 64
    slots. With the counts zeroed after the registration, every admission
    prefill and decode step must launch the tail kernel once in each of
    the 24 sliding layers and the routed kernels once in each of the 8
    full layers, and the engine's tail counters must count each of those
    calls. Returns the run's launch counts."""
    from repro_torch import obs
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import CorpusSpec, synthesize_corpus
    from repro_torch.kernels import ops
    from repro_torch.models.model import build_model
    from repro_torch.serving.engine import EngineConfig, ServingEngine

    gc.collect()
    torch.cuda.empty_cache()
    cfg = get_config(TRINITY_ARCH)
    L = cfg.num_layers
    tails = sum(1 for i in range(L) if cfg.window(i))
    full = L - tails
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = build_model(cfg).init(torch.Generator(device=dev).manual_seed(0),
                                   dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    corpus = synthesize_corpus(CorpusSpec("doc", TRINITY_CORPUS,
                                          cfg.vocab_size, seed=0))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, PROMPT).tolist()
               for _ in range(TRINITY_REQUESTS)]
    reg = obs.MetricsRegistry()
    prev = obs.set_registry(reg)
    try:
        eng = ServingEngine(cfg, params, EngineConfig(
            max_slots=TRINITY_REQUESTS, max_seq=512,
            cache_dtype=torch.bfloat16))
        t0 = time.perf_counter()
        eng.register_corpus("doc", corpus)
        reg_s = time.perf_counter() - t0
        for prompt in prompts:
            eng.submit(prompt, TRINITY_NEW, corpus_id="doc")
        ops.reset_launches()
        done = eng.run()
        counts = ops.launch_counts()
        walls = list(eng.metrics["decode_step_s"])
    finally:
        obs.set_registry(prev)
    steps = int(reg.counter("engine/decode_steps").value)
    prefills = int(reg.counter("engine/prefills").value)
    calls = steps + prefills
    want = dict.fromkeys(SOURCES, 0)
    want.update({"shared_tail_attention": tails * calls,
                 "router_scores": full * calls,
                 "shared_chunk_attention": full * calls,
                 "lse_merge": (2 * full + tails) * calls,
                 "decode_attention": L * steps,
                 "flash_prefill_attention": L * prefills})
    tail = {k: int(reg.counter(f"moska/tail_{k}").value)
            for k in ("calls", "query_rows", "rows", "keys")}
    say(f"[trinity] {cfg.name} ({L} layers, {tails} sliding, {full} full; "
        f"{cfg.num_heads} heads over {cfg.num_kv_heads}, D {cfg.head_dim}, "
        f"{cfg.moe.num_experts} experts top-{cfg.moe.top_k} + shared): "
        f"{prefills} prefills, {steps} decode steps")
    say(f"[trinity] launches {json.dumps(counts)}")
    say(f"[trinity] expected {json.dumps(want)}")
    say(f"[trinity] tail counters {json.dumps(tail)}")
    check(len(done) == TRINITY_REQUESTS and
          all(len(r.generated) == TRINITY_NEW for r in done),
          ("trinity: unfinished requests", len(done)))
    check(counts == want, ("trinity launch counts", counts, want))
    check(tail["calls"] == tails * calls and tail["rows"] > 0 and
          tail["keys"] >= tail["rows"], ("trinity tail counters", tail,
                                         tails, calls))
    say(f"[trinity] weights {init_s:.2f} s; corpus {TRINITY_CORPUS} tokens "
        f"registered in {reg_s:.2f} s; decode step p50 "
        f"{np.median(walls):.4f} s; peak device memory "
        f"{torch.cuda.max_memory_allocated(dev)} B")
    del eng, params, done
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def phase_families(dev, errs):
    """Phase 3f: the SSM, hybrid and enc-dec families at full width and
    depth, bf16 with seeded random weights. mamba2-130m: 128 requests of
    256 tokens (32 new, 64 slots) through ``ServingEngine``, then a
    ``shared_state`` warm start from a 16,384-token corpus tiled to 64
    requests, prefilled and decoded 16 steps through ``Model``.
    recurrentgemma-9b: 64 requests through ``ServingEngine``, half of 256
    and half of 2,040 prompt tokens, 32 new each (the ring wraps in
    decode). whisper-tiny: one audio's 1,500 stub frames behind 64
    requests of 16 tokens, 32 decode steps through ``Model`` with the
    cross-attention routed over a store of that audio's cross K/V (4
    chunks of 375, top-2), and again without the store. Every kernel's
    launches are exact (none for mamba2 and recurrentgemma); whisper's
    kernels are held against their plain versions at its shapes first;
    each arch ends with an fp32 decode step on the card against the CPU
    (recurrentgemma with one cycle of its 38 layers). ``errs`` takes the
    bf16 errors. Returns the launch counts, summed."""
    from repro_torch.configs import get_config
    total = collections.Counter()
    for arch, run_arch in ((SSM_ARCH, family_ssm),
                           (HYBRID_ARCH, family_hybrid),
                           (AUDIO_ARCH, family_audio)):
        t0 = time.perf_counter()
        gc.collect()
        torch.cuda.empty_cache()
        total.update(run_arch(get_config(arch), dev, errs))
        torch.cuda.empty_cache()
        say(f"[families] {arch}: {time.perf_counter() - t0:.1f} s")
    return dict(total)


def serve_state_family(cfg, dev, prompts, max_seq):
    """``ServingEngine`` (slotted, no corpus) over ``prompts``, NEW_TOKENS
    new tokens each on SLOTS slots, with no kernel launched; then one
    decode step of the engine's batch state profiled as in phase 6.
    Returns (model, params)."""
    from repro_torch import obs
    from repro_torch.kernels import ops
    from repro_torch.models.model import build_model
    from repro_torch.serving.engine import EngineConfig, ServingEngine

    model = build_model(cfg)
    torch.cuda.reset_peak_memory_stats(dev)
    params = model.init(torch.Generator(device=dev).manual_seed(0), dev)
    reg = obs.MetricsRegistry()
    prev = obs.set_registry(reg)
    try:
        eng = ServingEngine(cfg, params, EngineConfig(
            max_slots=SLOTS, max_seq=max_seq, cache_dtype=torch.bfloat16))
        for p in prompts:
            eng.submit(p, max_new_tokens=NEW_TOKENS)
        ops.reset_launches()
        done = list(eng.run())
        counts = ops.launch_counts()
    finally:
        obs.set_registry(prev)
    say(f"[families] {cfg.name} served: launches {json.dumps(counts)}")
    check(not any(counts.values()), (cfg.name, "launches", counts))
    check(len(done) == len(prompts) and
          all(len(r.generated) == NEW_TOKENS and
              all(0 <= t < cfg.vocab_size for t in r.generated)
              for r in done), (cfg.name, "served", len(done)))
    say(f"[families] {cfg.name} ({cfg.num_layers} layers, d_model "
        f"{cfg.d_model}): {len(done)} requests of "
        f"{sorted({len(p) for p in prompts})} prompt tokens, {NEW_TOKENS} "
        f"new, {SLOTS} slots: decode steps {eng.metrics['decode_steps']}, "
        f"decode step p50 {np.median(eng.metrics['decode_step_s']):.4f} s, "
        f"tokens/s {reg.gauge('engine/last_run_tokens_per_s').value:.1f}, "
        f"wall {eng.metrics['wall_s']:.2f} s, batch state "
        f"{int(reg.gauge('engine/decode_cache_bytes').value)} B, peak device "
        f"memory {torch.cuda.max_memory_allocated(dev)} B")
    tokens = torch.randint(0, cfg.vocab_size, (SLOTS,), device=dev)
    profile_family_step(f"{cfg.name} decode step", lambda: model.decode_step(
        params, tokens, eng._cache))
    return model, params


def profile_family_step(label, step, what="64 slots"):
    """``_profile_step`` of one decode step of a family (its unprofiled
    wall the median of 8)."""
    for _ in range(2):
        step()
    walls = []
    for _ in range(8):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    _profile_step(label, step, float(np.median(walls)), what)


def family_ssm(cfg, dev, errs):
    """mamba2-130m: served, then the warm start through ``Model``, then the
    fp32 card-vs-CPU step."""
    from repro_torch.data.pipeline import CorpusSpec, synthesize_corpus
    from repro_torch.kernels import ops
    from repro_torch.models import ssm

    g = torch.Generator(device=dev).manual_seed(2)
    prompts = torch.randint(0, cfg.vocab_size, (SSM_REQUESTS, PROMPT),
                            generator=g, device=dev).tolist()
    model, params = serve_state_family(cfg, dev, prompts, 512)
    corpus = torch.from_numpy(synthesize_corpus(CorpusSpec(
        cfg.name, SSM_CORPUS, cfg.vocab_size, seed=0))).long().to(dev)[None]
    ops.reset_launches()
    t0 = time.perf_counter()
    state = ssm.shared_state(cfg, params, corpus)["state"]
    torch.cuda.synchronize()
    corpus_s = time.perf_counter() - t0
    warm = {"state": state.expand(-1, SLOTS, -1, -1, -1).contiguous()}
    prompts = torch.tensor(prompts[:SLOTS], device=dev)
    cache = model.init_cache(SLOTS, PROMPT + SSM_WARM_STEPS, torch.bfloat16,
                             dev)
    logits, _ = model.prefill(params, prompts, cache, store=warm,
                              start_pos=SSM_CORPUS)
    walls = []
    for _ in range(SSM_WARM_STEPS):
        t0 = time.perf_counter()
        logits, _ = model.decode_step(params, logits.argmax(-1), cache)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    counts = ops.launch_counts()
    check(not any(counts.values()), ("ssm warm start launches", counts))
    check(bool(torch.isfinite(logits).all()) and
          tuple(logits.shape) == (SLOTS, cfg.vocab_size),
          ("ssm warm start logits", tuple(logits.shape)))
    say(f"[families] {cfg.name} warm start: shared_state of {SSM_CORPUS} "
        f"corpus tokens {corpus_s:.2f} s, state "
        f"{state.numel() * state.element_size()} B, tiled to {SLOTS}; "
        f"{SSM_WARM_STEPS} decode steps p50 {np.median(walls):.4f} s")
    del params, cache, warm
    torch.cuda.empty_cache()
    agree_family(cfg, dev, 8, PROMPT)
    return counts


def family_hybrid(cfg, dev, errs):
    """recurrentgemma-9b: served (prompts of 256 and 2,040 tokens), then
    the fp32 card-vs-CPU step with one cycle of layers."""
    g = torch.Generator(device=dev).manual_seed(2)
    n = HYBRID_REQUESTS // 2
    prompts = [torch.randint(0, cfg.vocab_size, (length,), generator=g,
                             device=dev).tolist()
               for length in [HYBRID_PROMPTS[0]] * n + [HYBRID_PROMPTS[1]] * n]
    max_seq = HYBRID_PROMPTS[1] + NEW_TOKENS + 8
    check(HYBRID_PROMPTS[1] + NEW_TOKENS > cfg.hybrid.window,
          ("the ring does not wrap", HYBRID_PROMPTS))
    _, params = serve_state_family(cfg, dev, prompts, max_seq)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    agree_family(dataclasses.replace(cfg, num_layers=len(cfg.hybrid.pattern)),
                 dev, 4, PROMPT)
    return dict.fromkeys(SOURCES, 0)


def family_audio(cfg, dev, errs):
    """whisper-tiny through ``Model``: its kernels at its shapes, the
    prefill of 64 requests behind one audio, 32 decode steps routed over
    the audio's store and 32 without it, each with exact launches; then
    the fp32 card-vs-CPU step over the store."""
    from repro_torch.core.shared_kv import build_store
    from repro_torch.kernels import ops
    from repro_torch.models.model import build_model

    F_, B, S, steps = (cfg.encoder.frontend_seq, AUDIO_REQUESTS,
                       AUDIO_PROMPT, AUDIO_STEPS)
    bf16, fp32 = torch.bfloat16, torch.float32
    slab = S + steps
    self_attn = dict(corpus=F_, slots=B, slab=slab, lens=(S + 1, slab + 1))
    cross = dict(corpus=F_, slots=B, slab=F_, lens=(F_, F_ + 1))
    agree = dict(corpus=F_, slots=8, slab=S + 8, lens=(S + 1, S + 2))
    check_kernels_at(cfg, dev, "families", errs, WIDTH_KERNELS,
                     decodes=[(bf16, self_attn), (bf16, cross),
                              (fp32, self_attn), (fp32, cross),
                              (fp32, agree), (fp32, dict(agree, slab=F_,
                                                         lens=(F_, F_ + 1)))])
    model = build_model(cfg)
    torch.cuda.reset_peak_memory_stats(dev)
    params = model.init(torch.Generator(device=dev).manual_seed(0), dev)
    frames, prompts = audio_inputs(cfg, dev, B, S, seed=2)
    cache = model.init_cache(B, slab, bf16, dev)
    ops.reset_launches()
    t0 = time.perf_counter()
    logits, _ = model.prefill(params, prompts, cache, frontend_embeds=frames)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    # the prefill attention kernel, once in each encoder layer and twice in
    # each decoder layer (self and cross); nothing else
    want = dict.fromkeys(SOURCES, 0)
    want["flash_prefill_attention"] = (cfg.encoder.num_layers
                                       + 2 * cfg.num_layers)
    check(ops.launch_counts() == want,
          ("whisper prefill launches", ops.launch_counts(), want))
    store = build_store(cache["cross_k"][:, 0], cache["cross_v"][:, 0],
                        cfg.moska.chunk_size)
    check(store.num_chunks == F_ // cfg.moska.chunk_size and
          all(store.k[i].is_contiguous() and store.v[i].is_contiguous()
              for i in range(cfg.num_layers)), "whisper store layout")
    no_store_cache = {k: t.clone() for k, t in cache.items()}
    total = collections.Counter()
    L = cfg.num_layers
    for label, st, c in (("store", store, cache),
                         ("no store", None, no_store_cache)):
        ops.reset_launches()
        tok, walls = logits.argmax(-1), []
        for _ in range(steps):
            t0 = time.perf_counter()
            out, _ = model.decode_step(params, tok, c, store=st)
            tok = out.argmax(-1)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        counts = ops.launch_counts()
        want = dict.fromkeys(SOURCES, 0)
        if st is None:
            want["decode_attention"] = 2 * L * steps
        else:
            want.update({k: L * steps for k in WIDTH_KERNELS})
        say(f"[families] {cfg.name} {label}: launches {json.dumps(counts)}")
        check(counts == want, (cfg.name, label, "launches", counts, want))
        check(bool(torch.isfinite(out).all()) and
              tuple(out.shape) == (B, cfg.vocab_size),
              (cfg.name, label, "logits"))
        say(f"[families] {cfg.name} {label}: {B} requests x {steps} decode "
            f"steps, p50 {np.median(walls):.4f} s, tokens/s "
            f"{B / np.median(walls):.1f}")
        total.update(counts)
        profile_family_step(f"{cfg.name} decode step ({label})",
                            lambda: model.decode_step(params, tok, c,
                                                      store=st))
    say(f"[families] {cfg.name}: prefill of {B} x ({F_} frames + {S} "
        f"tokens) {prefill_s:.3f} s; store {store.num_chunks} chunks of "
        f"{store.chunk_size} ({store.nbytes} B); peak device memory "
        f"{torch.cuda.max_memory_allocated(dev)} B")
    del params, cache, no_store_cache, store
    torch.cuda.empty_cache()
    agree_family(cfg, dev, 8, S, audio=True)
    return dict(total)


def audio_inputs(cfg, dev, batch, prompt, seed):
    """(one audio's stub frames (1, F, d) expanded to ``batch`` requests,
    prompts (batch, prompt))."""
    g = torch.Generator(device=dev).manual_seed(seed)
    F_, d = cfg.encoder.frontend_seq, cfg.d_model
    frames = torch.randn((1, F_, d), generator=g, device=dev)
    prompts = torch.randint(0, cfg.vocab_size, (batch, prompt), generator=g,
                            device=dev)
    return frames.to(cfg_dtype(cfg)).expand(batch, -1, -1), prompts


def agree_family(cfg, dev, B, S, audio=False):
    """One fp32 decode step of B requests on the card and on the CPU after
    a prefill of B prompts of S tokens on the card (whisper's behind one
    audio, its decode routed over the audio's store): logits within 1e-3,
    equal greedy tokens."""
    from repro_torch.core.shared_kv import build_store
    from repro_torch.models.model import build_model

    cfg = dataclasses.replace(cfg, dtype="float32")
    model = build_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(1), dev)
    cache = model.init_cache(B, S + 8, torch.float32, dev)
    stores = {dev: None, torch.device("cpu"): None}
    if audio:
        frames, prompts = audio_inputs(cfg, dev, B, S, seed=3)
        logits, _ = model.prefill(params, prompts, cache,
                                  frontend_embeds=frames)
        store = build_store(cache["cross_k"][:, 0], cache["cross_v"][:, 0],
                            cfg.moska.chunk_size)
        stores = {dev: store, torch.device("cpu"): on(torch.device("cpu"),
                                                      store)}
    else:
        prompts = torch.randint(0, cfg.vocab_size, (B, S), device=dev,
                                generator=torch.Generator(device=dev)
                                .manual_seed(3))
        logits, _ = model.prefill(params, prompts, cache)
    card_vs_cpu(f"{cfg.name} ({cfg.num_layers} layers) {B}-request fp32 "
                f"decode step{' over the store' if audio else ''}",
                lambda p, t, c, d: model.decode_step(p, t, c,
                                                     store=stores[d])[0],
                params, params_on_cpu(cfg, params), logits.argmax(-1), cache,
                dev, tag="families")


def on(device, tensors):
    """A copy of a cache or store (a NamedTuple of tensors, or a state
    family's dict) on ``device``."""
    if isinstance(tensors, dict):
        return {k: t.to(device, copy=True) for k, t in tensors.items()}
    return type(tensors)(*[t.to(device, copy=True) if t is not None
                           else None for t in tensors])


def card_vs_cpu(label, step, params, params_cpu, tokens, cache, dev,
                tag="agree"):
    """step(params, tokens, cache, device) -> logits, on the card and on
    the CPU (plain versions), each side from its own copy of the prefilled
    ``cache``: logits within ``E2E_TOL`` and equal greedy tokens."""
    cpu = torch.device("cpu")
    lg_card = step(params, tokens, on(dev, cache), dev).cpu()
    lg_cpu = step(params_cpu, tokens.cpu(), on(cpu, cache), cpu)
    err = float((lg_card - lg_cpu).abs().max())
    same = bool((lg_card.argmax(-1) == lg_cpu.argmax(-1)).all())
    say(f"[{tag}] {label}, card vs cpu: logits max_abs_err="
        f"{err:.3e} (tol {E2E_TOL:g}), |logits| max="
        f"{float(lg_cpu.abs().max()):.3f}, greedy tokens equal={same}")
    check(err <= E2E_TOL and same, (f"card vs cpu {label}", err, same))


def params_on_cpu(cfg, params):
    """A CPU copy of the card's weights, built without a second card copy
    (a deep copy would hold both on the card)."""
    from repro_torch.models.model import empty_params
    out = empty_params(cfg, torch.device("cpu"))
    out.load_state_dict({k: v.cpu() for k, v in params.state_dict().items()})
    return out


def _time_ms(fn, n=30, read_flush=False):
    """Mean device time of ``fn`` over n calls. Before each call a 128 MB
    write empties the L2 cache (the path meets every layer's inputs cold)
    and a spin kernel of about 0.5 ms keeps the card busy while the host
    records the start event and enqueues ``fn``: the events then bracket
    the device work alone, not the wrapper's host-side time. The write
    leaves the L2 full of dirty lines, which ``fn``'s reads must write back
    as they evict them; ``read_flush`` empties it by a 128 MB read instead."""
    flush = torch.zeros(128 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(n):
        if read_flush:
            flush.sum()
        else:
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
    (each input read once, each output written once): the kernel's work
    as ``kernels/work.py`` counts it (the dry run's counter reads the same
    function), with the counts that these inputs' data give (the
    dispatched slots and the chunks with a query, the cached tokens)."""
    from repro_torch.kernels import work
    counts = {}
    if name in ("shared_chunk_attention", "shared_chunk_attention_q8"):
        qmask = args[-1]
        counts = dict(valid=int(qmask.sum()),
                      active=int(qmask.any(dim=1).sum()))
    elif name in ("decode_attention", "paged_decode_attention"):
        k, lens = args[1], args[-1]
        paged = name == "paged_decode_attention"
        cap = args[3].shape[1] * k.shape[1] if paged else k.shape[1]
        counts = dict(tokens=int(lens.clamp(max=cap).sum()))
    elif name == "shared_tail_attention":
        T, first = args[1].shape[0], args[3]
        counts = dict(keys=int((T - first.long()).clamp(0, T).sum()))
    ops_, byts = work.WORK[name](*args, **counts)
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
    if name == "shared_tail_attention":
        q, k, v, first = args
        q4 = q.transpose(0, 1)[None].contiguous()
        k4, v4 = (x.transpose(0, 1)[None].contiguous() for x in (k, v))
        mask = (torch.arange(k.shape[0], device=q.device)[None]
                >= first.long()[:, None])[None, None]
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


def _two_calls(name, args):
    """No one PyTorch call computes the paged or the int8 kernel's function:
    each needs a gather or a dequantization first. These are the two-call
    comparisons (gather + SDPA, dequantize + SDPA), timed as one; None for
    the other kernels."""
    if name == "paged_decode_attention":
        q, k_pool, v_pool, table, lens = args
        B, M = table.shape
        _, bs, KH, D = k_pool.shape
        mask = (torch.arange(M * bs, device=q.device)[None]
                < lens[:, None])[:, None, None]

        def gather_sdpa():
            k, v = (p[table.long()].view(B, M * bs, KH, D).transpose(1, 2)
                    for p in (k_pool, v_pool))
            return F.scaled_dot_product_attention(
                q[:, :, None], k, v, attn_mask=mask, enable_gqa=True)
        return gather_sdpa
    if name == "shared_chunk_attention_q8":
        qd, k, v, ks, vs, _ = args
        q4 = qd.transpose(1, 2).contiguous()

        def dequant_sdpa():
            k4, v4 = ((x.to(qd.dtype) * s[..., None].to(qd.dtype))
                      .transpose(1, 2) for x, s in ((k, ks), (v, vs)))
            return F.scaled_dot_product_attention(q4, k4, v4,
                                                  enable_gqa=True)
        return dequant_sdpa
    return None


def phase_time(cfg, dev, counts, errs):
    """``counts``: each kernel's launches in the run of its path."""
    from repro_torch.kernels import ops
    plain = plain_versions()
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
        if name == "lse_merge":
            _time_sum_yardstick(name, "decode", args[0])
        two = _two_calls(name, args)
        if two is not None:
            label = ("gather + SDPA" if name == "paged_decode_attention"
                     else "dequantize + SDPA")
            say(f"[time] {name:24s} two-call comparison ({label}, not one "
                f"library call) ms={_time_ms(two):.4f}")
        if name.endswith("decode_attention"):
            rf_ms = _time_ms(lambda: kern(*args), read_flush=True)
            say(f"[time] {name:24s} with the L2 emptied by a read (no dirty "
                f"lines) ms={rf_ms:.4f}")
    time_floors(path_inputs(cfg, torch.bfloat16, dev, seed=2)
                ["decode_attention"])
    time_prefill(cfg, dev)
    time_q8_served_prefill(cfg, dev)
    time_merge_entries(cfg, dev)
    rows.append(time_prefill_attention(dev, counts, errs))
    rows.append(time_shared_tail(dev, counts, errs))
    return rows


def time_shared_tail(dev, counts, errs):
    """The tail kernel at each of ``TAIL_ROWS``, beside its bound (the
    visible pairs these first keys give), its plain version and, as a
    yardstick, SDPA under the same mask (rows that see no key give NaN
    there); returns the kernels' JSON row of the decode step's shape."""
    from repro_torch.kernels import ops, ref
    name = "shared_tail_attention"
    row = None
    for label, n in TAIL_ROWS:
        args = tail_inputs(dev, n, seed=2)
        ms = _time_ms(lambda: ops.shared_tail_attention(*args))
        plain_ms = _time_ms(lambda: ref.shared_tail_attention_ref(*args),
                            n=10)
        lib_ms = _time_ms(_library_call(name, args))
        bound_ms, bound_by = _bound(name, args)
        say(f"[time] {name:24s} {label} ({n} rows) ms={ms:.4f} "
            f"plain_ms={plain_ms:.4f} library_ms={lib_ms:.4f} (SDPA, "
            f"masked) bound_ms={bound_ms:.4f} ({bound_by}), "
            f"{100 * bound_ms / ms:.1f} % of bound "
            f"shapes={[tuple(a.shape) for a in args]}")
        if row is None:
            src, replaces = SOURCES[name]
            row = {"name": name, "route": "cuda", "source": src,
                   "replaces": replaces, "launches": counts[name],
                   "max_abs_err": errs[name], "ms": ms, "plain_ms": plain_ms,
                   "bound_ms": bound_ms, "bound_by": bound_by,
                   "library_ms": lib_ms}
    return row


def time_prefill_attention(dev, counts, errs):
    """The prefill kernel at each of ``PREFILL_ATTN_TIMES`` (one causal
    sequence), beside its bound, its plain version and, as a yardstick
    only (the port never calls it), SDPA on K/V expanded to every query
    head beforehand; returns the kernels' JSON row of the 2,048-token
    shape."""
    from repro_torch.kernels import ops, ref
    name = "flash_prefill_attention"
    out = None
    for i, (label, S, H, KH, D) in enumerate(PREFILL_ATTN_TIMES):
        q, k, v = prefill_attention_inputs(dev, 1, S, S, H, KH, D, seed=2)
        ms = _time_ms(lambda: ops.flash_prefill_attention(q, k, v))
        plain_ms = _time_ms(lambda: ref.flash_prefill_attention_ref(q, k, v),
                            n=2 if S > 4096 else 10)
        q4, k4, v4 = (x.transpose(1, 2).repeat_interleave(H // x.shape[2],
                                                          dim=1).contiguous()
                      for x in (q, k, v))
        sdpa_ms = _time_ms(lambda: F.scaled_dot_product_attention(
            q4, k4, v4, is_causal=True))
        bound_ms, bound_by = _bound(name, (q, k, v))
        say(f"[time] {name} {label}: ms={ms:.4f} bound_ms={bound_ms:.4f} "
            f"({bound_by}, {100 * bound_ms / ms:.1f} % of it) plain_ms="
            f"{plain_ms:.4f} SDPA_ms={sdpa_ms:.4f} (yardstick, K/V expanded "
            f"to {H} heads) shapes={[tuple(a.shape) for a in (q, k, v)]}")
        if i == PREFILL_ATTN_ROW:
            src, replaces = SOURCES[name]
            out = {"name": name, "route": "cuda", "source": src,
                   "replaces": replaces, "launches": counts[name],
                   "max_abs_err": errs[name], "ms": ms,
                   "plain_ms": plain_ms, "bound_ms": bound_ms,
                   "bound_by": bound_by, "library_ms": sdpa_ms}
        del q, k, v, q4, k4, v4
        torch.cuda.empty_cache()
    return out


def time_q8_served_prefill(cfg, dev):
    """``shared_chunk_attention_q8`` at phase 3c's prefill, its 22 launches
    of the served run: 64 prompts of 256 tokens routed in 128 groups of 128
    queries, top-8 of 32 chunks at capacity 64 slots, so qd is (32, 8,192,
    32, 64) bf16; beside its bound and dequantize + SDPA timed as one."""
    from repro_torch.core.shared_kv import _quantize
    from repro_torch.kernels import ops

    g = torch.Generator(device=dev).manual_seed(2)
    H, KH, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    C, E = cfg.moska.chunk_size, CORPUS // cfg.moska.chunk_size
    qmask = routed_slots(cfg, g, dev, SLOTS * PROMPT // 128)
    qd = torch.randn((E, qmask.shape[1], H, D), generator=g, device=dev
                     ).to(torch.bfloat16)
    kq, ks = _quantize(torch.randn((E, C, KH, D), generator=g, device=dev))
    vq, vs = _quantize(torch.randn((E, C, KH, D), generator=g, device=dev))
    args = (qd, kq, vq, ks, vs, qmask)
    name = "shared_chunk_attention_q8"
    ms = _time_ms(lambda: ops.shared_chunk_attention_q8(*args))
    bound_ms, bound_by = _bound(name, args)
    two_ms = _time_ms(_two_calls(name, args))
    say(f"[time] {name:24s} served prefill (phase 3c) ms={ms:.4f} "
        f"bound_ms={bound_ms:.4f} ({bound_by}) dequantize+SDPA_ms="
        f"{two_ms:.4f} valid_rows={int(qmask.sum())}/{qmask.numel()} "
        f"shapes={[tuple(a.shape) for a in args]}")


def _time_sum_yardstick(name, label, outs):
    """``outs.sum(dim=0)`` reads the partials a merge reads and writes an
    output of the merge's size: a yardstick of the bandwidth, not a call
    that computes the merge."""
    say(f"[time] {name:24s} {label} outs.sum(dim=0) over the same "
        f"{tuple(outs.shape)} ms={_time_ms(lambda: outs.sum(dim=0)):.4f}")


def _merge_entry_bound(entry, args):
    """Bytes over the HBM rate: the rows the entry reads (for the routed
    entry only the routes kept) and its outputs; a few flops an element."""
    def nb(t):
        return t.numel() * t.element_size()

    if entry == "pair":
        o0, l0, o1, l1 = args
        byts = 3 * nb(o0) + 3 * nb(l0)
    else:
        od, lsed, lin = args
        row = nb(od[0]) + nb(lsed[0])
        byts = (int((lin < od.shape[0]).sum()) + lin.shape[0]) * row \
            + nb(lin)
    return byts / HBM_BYTES_PER_S * 1e3


def time_merge_entries(cfg, dev):
    """The merge's routed and pair entries at the decode step's and the
    routed prefill's shapes (bf16), beside what each replaced through the
    dense entry (gather + fill + transposes, or two stacks), timed as one."""
    from repro_torch.kernels import ops
    chains = merge_chains()
    for label in ("path", "prefill"):
        inputs = merge_inputs(cfg, torch.bfloat16, dev, label, seed=2)
        for entry, args in inputs.items():
            kern = getattr(ops, f"lse_merge_{entry}")
            ms = _time_ms(lambda: kern(*args))
            chain_ms = _time_ms(lambda: chains[entry](*args))
            what = ("stack + dense merge" if entry == "pair"
                    else "gather chain + dense merge")
            say(f"[time] lse_merge {entry:6s} entry "
                f"{'decode' if label == 'path' else 'prefill'} ms={ms:.4f} "
                f"{what} (as one) ms={chain_ms:.4f} "
                f"bound_ms={_merge_entry_bound(entry, args):.4f} (bytes) "
                f"shapes={[tuple(a.shape) for a in args]}")


def time_floors(decode_args):
    """What ``_time_ms`` reads for almost no work, and for a plain read of
    as many bytes as the decode kernels' K/V at the decode shape (one
    ``sum`` over a bf16 tensor of that size), with each of the two flushes:
    the floor that a kernel's time is read against."""
    q, k, _, lens = decode_args
    byts = 2 * int(lens.sum()) * k.shape[2] * k.shape[3] * k.element_size()
    x = torch.ones(byts // 2, dtype=torch.bfloat16, device=q.device)
    z = torch.zeros(1, device=q.device)
    for rf in (False, True):
        tiny = _time_ms(lambda: z.add_(1), read_flush=rf)
        read = _time_ms(lambda: x.sum(dtype=torch.float32), read_flush=rf)
        say(f"[time] floors, L2 emptied by a {'read' if rf else 'write'}: "
            f"one tiny kernel ms={tiny:.4f}, a sum over {byts} bytes "
            f"ms={read:.4f}")


def time_prefill(cfg, dev):
    """The routed kernels at the routed prefill's shape (most of their
    launches in a served run), beside their bound. The shared kernels also
    beside SDPA with GQA over every row (for the int8 store on K/V
    dequantized beforehand) and, for the int8 entry, dequantize + SDPA
    timed as one; ``router_scores`` beside its ``einsum``."""
    from repro_torch.kernels import ops
    for name, args in prefill_inputs(cfg, torch.bfloat16, dev,
                                     seed=2).items():
        kern = getattr(ops, name)
        ms = _time_ms(lambda: kern(*args))
        bound_ms, bound_by = _bound(name, args)
        shapes = [tuple(a.shape) for a in args]
        if not name.startswith("shared"):
            lib = _library_call(name, args)
            extra = "" if lib is None else f" library_ms={_time_ms(lib):.4f}"
            say(f"[time] {name:24s} prefill ms={ms:.4f} bound_ms="
                f"{bound_ms:.4f} ({bound_by}){extra} shapes={shapes}")
            if name == "lse_merge":
                _time_sum_yardstick(name, "prefill", args[0])
            continue
        if name == "shared_chunk_attention":
            sdpa_args = args
        else:
            qd, k, v, ks, vs, qmask = args
            sdpa_args = (qd, (k * ks[..., None]).to(qd.dtype),
                         (v * vs[..., None]).to(qd.dtype), qmask)
        sdpa_ms = _time_ms(_library_call("shared_chunk_attention", sdpa_args))
        two = _two_calls(name, args)
        extra = "" if two is None else \
            f" dequantize+SDPA_ms={_time_ms(two):.4f}"
        say(f"[time] {name:24s} prefill ms={ms:.4f} bound_ms={bound_ms:.4f} "
            f"({bound_by}) SDPA_ms={sdpa_ms:.4f}{extra} valid_rows="
            f"{int(args[-1].sum())}/{args[-1].numel()} shapes={shapes}")


def phase_profile(cfg, dev):
    """Device time of one decode step at the served shapes, by kernel, from
    torch.profiler: 64 slots holding 256..287 tokens, a 32-chunk store of
    random K/V (values change routing, not the work), bf16. Also the step's
    wall time unprofiled, and the device's idle share of the profiled step.
    The same for one paged decode step over the same cache in pages; the
    two steps' unprofiled walls are taken in turns."""
    from repro_torch.core.shared_kv import build_store
    from repro_torch.kvcache.cache import init_kv_cache
    from repro_torch.kvcache.paged import PagedKVCache
    from repro_torch.models import dense

    g = torch.Generator(device=dev).manual_seed(3)
    L, KH, D = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim
    params = dense.init_params(cfg, g, dev)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)

    store = build_store(randn(L, CORPUS, KH, D), randn(L, CORPUS, KH, D),
                        cfg.moska.chunk_size)
    cache = init_kv_cache(L, SLOTS, 512, KH, D, torch.bfloat16, dev)
    cache.k.copy_(randn(*cache.k.shape))
    cache.v.copy_(randn(*cache.v.shape))
    cache.length.copy_(torch.randint(PROMPT, PROMPT + 32, (SLOTS,),
                                     generator=g, device=dev))
    cache.offset.fill_(CORPUS)
    tokens = torch.randint(0, cfg.vocab_size, (SLOTS,), generator=g,
                           device=dev)

    def step():
        cache.length.clamp_(max=PROMPT + 32)      # stay inside the slab
        dense.decode_step(cfg, params, tokens, cache, store=store)

    # the same cache in scrambled pages, for one paged decode step
    M = M_PAGES
    table = (torch.randperm(SLOTS * M, generator=g, device=dev) + 1
             ).view(SLOTS, M).to(torch.int32)
    pool = PagedKVCache(*(torch.zeros((L, SLOTS * M + 1, BLOCK, KH, D),
                                      dtype=torch.bfloat16, device=dev)
                          for _ in range(2)))
    pool.k[:, table.long()] = cache.k.view(L, SLOTS, M, BLOCK, KH, D)
    pool.v[:, table.long()] = cache.v.view(L, SLOTS, M, BLOCK, KH, D)
    lens = cache.length.clone()
    offs = cache.offset.clone()
    steps = {"decode step": step,
             "paged decode step": lambda: dense.decode_step_paged(
                 cfg, params, tokens, pool, table, lens, offs, store=store)}

    # unprofiled walls in turns (A B, B A, ...): the host is shared, and
    # its speed drifts more than the two steps differ
    for fn in list(steps.values()) * 3:
        fn()
    torch.cuda.synchronize()
    walls = {label: [] for label in steps}
    for r in range(8):
        for label in (list(steps) if r % 2 == 0 else list(steps)[::-1]):
            t0 = time.perf_counter()
            steps[label]()
            torch.cuda.synchronize()
            walls[label].append(time.perf_counter() - t0)
    for label, fn in steps.items():
        names, launches = _profile_step(label, fn,
                                        float(np.median(walls[label])))
        # bf16 shared attention runs on the tensor-core kernel, and the
        # fp32 CUDA-core kernel is for fp32 queries only
        mma = [n for n in names if "shared_chunk_mma_kernel" in n]
        fp32 = [n for n in names if "shared_chunk_attn_kernel" in n]
        say(f"[profile] {label}: tensor-core shared kernel launched: "
            f"{bool(mma)}; fp32 shared kernel launched: {bool(fp32)}")
        check(mma and not fp32, (label, "shared kernels", mma, fp32))
        # the unique decode attention runs the split-KV kernel of its
        # layout, not the tile kernels it replaced
        unique = [n for n in names if STEP_DECODE_KERNEL[label] in n]
        old = [n for n in names if "decode_attn_kernel" in n]
        say(f"[profile] {label}: {STEP_DECODE_KERNEL[label]} launched: "
            f"{bool(unique)}; old decode kernel launched: {bool(old)}; "
            f"{launches} launches (expected {STEP_LAUNCHES[label]}; with "
            f"the merge partials gathered and stacked: "
            f"{STEP_LAUNCHES_GATHERED[label]})")
        check(unique and not old, (label, "decode kernels", unique, old))
        check(launches == STEP_LAUNCHES[label], (label, "launches", launches))


#: each profiled step's (unprofiled wall, device busy) in seconds, by label
PROFILED = {}


def _profile_step(label, step, wall, what="64 slots"):
    """One profiled run of ``step`` (its unprofiled median ``wall`` given,
    ``what`` it runs named in the report):
    device time by kernel, the device's idle share, the host operations
    that took the most host time, and every call in the step that made the
    host wait for the card (``torch.cuda.set_sync_debug_mode``). Returns
    the names of the kernels that ran on the card and their launches."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models.dense import MOE_RANGE
    torch.cuda.set_sync_debug_mode("warn")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        step()
    torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    syncs = collections.Counter(
        f"{Path(w.filename).name}:{w.lineno}" for w in caught
        if "synchroniz" in str(w.message))
    say(f"[profile] {label}: {sum(syncs.values())} synchronizing calls "
        f"{json.dumps(dict(syncs))}")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t0
    # the MoE FFN's profiler range has spans of its own on the card's
    # timeline: they are not kernels
    kernels = [e for e in prof.key_averages()
               if e.device_type.name == "CUDA" and e.self_device_time_total > 0
               and e.key != MOE_RANGE]
    busy_us = sum(e.self_device_time_total for e in kernels)
    PROFILED[label] = (wall, busy_us / 1e6)
    say(f"[profile] {label}, {what}, unprofiled wall (8 runs in turns) "
        f"median={wall * 1e3:.2f} ms; profiled wall="
        f"{prof_wall * 1e3:.2f} ms, device busy={busy_us / 1e3:.2f} ms, "
        f"idle share={1 - busy_us / 1e6 / prof_wall:.3f} "
        f"(of the unprofiled wall {1 - busy_us / 1e6 / wall:.3f}), "
        f"{sum(e.count for e in kernels)} kernel launches")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]:
        say(f"[profile] {e.self_device_time_total / 1e3:9.3f} ms "
            f"{e.count:5d}x  {e.key[:90]}")
    host = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)
    for e in host[:8]:
        say(f"[profile] host {e.self_cpu_time_total / 1e3:9.3f} ms "
            f"{e.count:5d}x  {e.key[:80]}")
    return [e.key for e in kernels], sum(e.count for e in kernels)


# ---------------------------------------------------------------------------
# phase 7: training
# ---------------------------------------------------------------------------

def card_name_and_limit() -> str:
    """``nvidia-smi``'s name and power limit of the card."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], check=True,
                          capture_output=True,
                          text=True).stdout.strip().splitlines()[0]


def train_report(label, hist, batch, seq):
    """Check a run's losses are finite, then print its step p50 (each
    logged interval's seconds a step, the first step's lazy set-up left
    out), training tokens/s, peak device memory, and first and last
    loss. Returns the step p50 in seconds."""
    losses = [h["loss"] for h in hist]
    check(all(np.isfinite(losses)), (label, "losses", losses))
    per = [(b["elapsed_s"] - a["elapsed_s"]) / (b["step"] - a["step"])
           for a, b in zip(hist, hist[1:])]
    p50 = float(np.median(per))
    say(f"[train] {label}: {hist[-1]['step'] + 1} steps of {batch} x "
        f"{seq}, step p50 {p50 * 1e3:.2f} ms, "
        f"{batch * seq / p50:.1f} tokens/s, peak "
        f"{torch.cuda.max_memory_allocated()} B, loss {losses[0]:.4f} -> "
        f"{losses[-1]:.4f}")
    return p50


def train_run(cfg, dev, steps, batches=None, **loop):
    """``train`` on the card from the loop's seeded init, every step
    logged; no kernel of the port launches (the training path is plain
    PyTorch under autograd, as the reference's is jnp)."""
    from repro_torch.kernels import ops
    from repro_torch.training.train_loop import TrainLoopConfig, train
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    n0 = ops.launch_counts()
    out = train(cfg, TrainLoopConfig(num_steps=steps, log_every=1, **loop),
                batches, device=dev)
    check(ops.launch_counts() == n0, (cfg.name, "kernel launches"))
    check(all(p.is_cuda for p in out["params"].parameters()),
          (cfg.name, "parameters on the card"))
    return out


def profile_train_step(cfg, out, dev, batch, seq):
    """``profile_family_step`` of one more training step (loss, backward,
    AdamW) of a run's parameters and state, on one batch of the stream:
    device time by kernel, idle share, host time, synchronizing calls."""
    from repro_torch.data.pipeline import make_train_batches
    from repro_torch.models.model import build_model
    from repro_torch.training import train_loop as tl
    loop = tl.TrainLoopConfig(batch_size=batch, seq_len=seq)
    step_fn = tl.make_train_step(build_model(cfg), loop)
    b = tl.to_device(next(make_train_batches(cfg, batch, seq)), dev)
    state = [out["params"], out["opt_state"]]

    def step():
        state[0], state[1], _ = step_fn(state[0], state[1], b)
    with tl.trainable(out["params"]):
        profile_family_step(f"{cfg.name} train step", step,
                            f"{batch} x {seq} tokens")


def train_resume(cfg, dev):
    """tinyllama at full width, RESUME_LAYERS layers: TRAIN_STEPS steps in
    one run that saves at RESUME_AT, against a fresh ``train`` that
    resumes from that checkpoint (hard links of its files) for the
    remaining steps on the same batches. Card atomics (the embedding's
    and the experts' backward scatter-adds) may order sums otherwise, so
    the losses after the resume are held within RESUME_TOL relative; the
    step-RESUME_AT loss, computed by the forward pass from the restored
    weights, is printed beside whether it is bit-equal."""
    import os
    import shutil
    import tempfile
    from repro_torch.data.pipeline import make_train_batches
    cfg = dataclasses.replace(cfg, num_layers=RESUME_LAYERS)
    batches = list(make_train_batches(cfg, TRAIN_BATCH, TRAIN_SEQ,
                                      num_batches=TRAIN_STEPS))
    with tempfile.TemporaryDirectory() as tmp:
        full, part = os.path.join(tmp, "full"), os.path.join(tmp, "part")
        loop = dict(ckpt_every=RESUME_AT, batch_size=TRAIN_BATCH,
                    seq_len=TRAIN_SEQ)
        t = time.perf_counter()
        a = train_run(cfg, dev, TRAIN_STEPS, ckpt_dir=full,
                      batches=iter(batches), **loop)
        t_full = time.perf_counter() - t
        name = f"step_{RESUME_AT:08d}"
        shutil.copytree(os.path.join(full, name), os.path.join(part, name),
                        copy_function=os.link)
        with open(os.path.join(part, "LATEST"), "w") as f:
            f.write(name)
        size = sum(os.path.getsize(os.path.join(full, name, n))
                   for n in os.listdir(os.path.join(full, name)))
        t = time.perf_counter()
        b = train_run(cfg, dev, TRAIN_STEPS, ckpt_dir=part,
                      batches=iter(batches[RESUME_AT:]), **loop)
        t_part = time.perf_counter() - t
    ha, hb = a["history"][RESUME_AT:], b["history"]
    check([h["step"] for h in hb] == list(range(RESUME_AT, TRAIN_STEPS)),
          ("resume steps", [h["step"] for h in hb]))
    rel = max(abs(x["loss"] - y["loss"]) / abs(x["loss"])
              for x, y in zip(ha, hb))
    check(rel <= RESUME_TOL, ("resumed losses", rel))
    dp = max(float((x.float() - y.float()).abs().max())
             for x, y in zip(a["params"].parameters(),
                             b["params"].parameters()))
    check(b["opt_state"].step == a["opt_state"].step == TRAIN_STEPS,
          "resumed optimizer step")
    say(f"[train] resume ({RESUME_LAYERS} layers, checkpoint {size} B at "
        f"step {RESUME_AT}): steps {RESUME_AT}-{TRAIN_STEPS - 1} "
        f"within {rel:.3e} relative of the uninterrupted run (tolerance "
        f"{RESUME_TOL}); step-{RESUME_AT} loss bit-equal: "
        f"{ha[0]['loss'] == hb[0]['loss']}; final parameters differ by at "
        f"most {dp:.3e}; the uninterrupted run with its 2 saves "
        f"{t_full:.1f} s, the resumed run with its restore and 1 save "
        f"{t_part:.1f} s")


def phase_train(dev):
    """Phase 7: the port's training on the card, bf16, through its own
    ``train`` (and ``examples/train_tiny.py``), with the reference loop's
    lr 3e-4 and 10 warmup steps, batches of TRAIN_BATCH x TRAIN_SEQ.
    tinyllama-1.1b at full width and depth for TRAIN_STEPS steps (remat
    on): the loss must descend; then its save-and-resume check
    (``train_resume``). mamba2-130m at full width and depth through the
    example, cut from its 200 steps to TINY_STEPS, ending with the
    example's own descent assert. granite-moe-1b-a400m at full width and
    depth for MOE_TRAIN_STEPS steps: ``moe_aux`` finite and above 0 at
    every step. recurrentgemma-9b at full width and 3 layers, whisper-tiny
    at full width and depth: FAMILY_TRAIN_STEPS steps each, losses
    finite. TF32 must be off. Each run prints its step p50, tokens/s,
    peak memory and first and last loss; one more step of tinyllama,
    whisper and mamba2 (batch 4 x 256, as the example) is profiled."""
    from repro_torch.configs import get_config
    from repro_torch.examples import train_tiny
    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 is on")
    say(f"[train] card: {card_name_and_limit()}")
    cfg = get_config(ARCH)
    out = train_run(cfg, dev, TRAIN_STEPS)
    hist = out["history"]
    train_report(f"{ARCH} ({cfg.num_layers} layers)", hist, TRAIN_BATCH,
                 TRAIN_SEQ)
    check(hist[-1]["loss"] < hist[0]["loss"], (ARCH, "loss did not descend"))
    profile_train_step(cfg, out, dev, TRAIN_BATCH, TRAIN_SEQ)
    del out
    train_resume(cfg, dev)

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    hist = train_tiny.main(["--steps", str(TINY_STEPS), "--batch",
                            str(TINY_BATCH), "--seq", str(TINY_SEQ)])
    train_report(f"{SSM_ARCH} (train_tiny, {TINY_STEPS} of its 200 steps)",
                 hist, TINY_BATCH, TINY_SEQ)

    out = train_run(get_config(MOE_ARCH), dev, MOE_TRAIN_STEPS)
    aux = [h["moe_aux"] for h in out["history"]]
    check(all(np.isfinite(aux)) and min(aux) > 0, (MOE_ARCH, "moe_aux", aux))
    train_report(MOE_ARCH, out["history"], TRAIN_BATCH, TRAIN_SEQ)
    say(f"[train] {MOE_ARCH}: moe_aux {aux[0]:.4f} -> {aux[-1]:.4f}")
    del out

    for arch, layers in FAMILY_TRAIN:
        cfg = get_config(arch)
        if layers:
            cfg = dataclasses.replace(cfg, num_layers=layers)
        out = train_run(cfg, dev, FAMILY_TRAIN_STEPS)
        train_report(f"{arch} ({cfg.num_layers} layers)", out["history"],
                     TRAIN_BATCH, TRAIN_SEQ)
        if arch == AUDIO_ARCH:
            profile_train_step(cfg, out, dev, TRAIN_BATCH, TRAIN_SEQ)
        del out
    # the example keeps its run to itself: one step of mamba2 to profile
    cfg = get_config(SSM_ARCH)
    profile_train_step(cfg, train_run(cfg, dev, 1, batch_size=TINY_BATCH,
                                      seq_len=TINY_SEQ),
                       dev, TINY_BATCH, TINY_SEQ)
    gc.collect()
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 8: the disaggregated shared-KV pool, and training under a mesh
# ---------------------------------------------------------------------------

def disagg_inputs(cfg, dtype, dev, seed=0, corpus=None, queries=None):
    """q (queries, H, D) and a one-layer store of ``corpus`` tokens
    (default: DISAGG_QUERIES and DISAGG_CORPUS), (E, C, KH, D) K and V and
    their mean-key embeddings, drawn on the device from ``seed`` (every
    rank draws the same)."""
    corpus, queries = corpus or DISAGG_CORPUS, queries or DISAGG_QUERIES
    from repro_torch.core.shared_kv import chunk_embeddings
    g = torch.Generator(device=dev).manual_seed(seed)
    H, KH, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    C = cfg.moska.chunk_size
    E = corpus // C

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev).to(dtype)
    q, k, v = (randn(queries, H, D), randn(E, C, KH, D),
               randn(E, C, KH, D))
    return q, k, v, chunk_embeddings(k[None])[0]


def combine_partials(outs, lses):
    """The reference's cross-owner combine, in fp32, of the owners'
    partials outs (P, B, H, D) and lses (P, B, H): weights exp(lse - max)
    where an owner attended, 0 where it did not."""
    m = lses.max(dim=0).values
    w = torch.where(lses > -1e30 / 2, torch.exp(lses - m),
                    torch.zeros_like(lses))
    den = w.sum(dim=0)
    out = (outs.float() * w[..., None]).sum(dim=0) \
        / den.clamp_min(1e-37)[..., None]
    lse = torch.where(den > 0, m + torch.log(den.clamp_min(1e-37)),
                      torch.full_like(m, -1e30))
    return out, lse


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


def _wall_ms(fn, dev, sync_all=None, n=DISAGG_REPS):
    """Median host wall of ``fn`` to its device end over n calls after two
    warm-ups (``sync_all``: a barrier over the ranks before each)."""
    for _ in range(2):
        fn()
    walls = []
    for _ in range(n):
        if sync_all:
            sync_all()
        _sync(dev)
        t = time.perf_counter()
        fn()
        _sync(dev)
        walls.append((time.perf_counter() - t) * 1e3)
    return float(np.median(walls))


def _disagg_rank(rank, world, tmp, cfg, dev, shape, backend):
    """One owner of phase 8(c): gloo over CUDA tensors on the one card
    (NCCL refuses two ranks on one device), or NCCL with a card a rank.
    Draws the whole store (``shape``: disagg_inputs' corpus and queries),
    keeps its chunk range, and runs ``disaggregated_shared_attention`` in
    bf16 and fp32; times the call and its two all-reduces alone; writes
    its launch counts, and rank 0 its outputs and times."""
    import datetime
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.core import disagg
    from repro_torch.kernels import ops
    if dev.type == "cuda":
        dev = torch.device("cuda", rank if backend == "nccl" else 0)
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=f"file://{tmp}/rdzv",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=300))
    try:
        mesh = init_device_mesh(dev.type, (world,),
                                mesh_dim_names=("data",))
        ops.reset_launches()
        res = {}
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v, emb = disagg_inputs(cfg, dtype, dev, **shape)
            kl, vl, el = disagg.local_chunks(k, v, emb, mesh)

            def call():
                return disagg.disaggregated_shared_attention(
                    q, kl, vl, el, cfg.moska, mesh)
            out, lse = call()
            _sync(dev)
            tag = str(dtype)[6:]
            res[f"{tag}/out"], res[f"{tag}/lse"] = out.cpu(), lse.cpu()
            res[f"{tag}/ms"] = _wall_ms(call, dev, dist.barrier)
            B, H, D = q.shape
            m = torch.zeros((B, H), device=dev)
            buf = torch.zeros(B * H * D + B * H, device=dev)

            def reduce():
                dist.all_reduce(m, op=dist.ReduceOp.MAX)
                dist.all_reduce(buf)
            res[f"{tag}/allreduce_ms"] = _wall_ms(reduce, dev, dist.barrier)
            del q, k, v, emb, kl, vl, el
        res["launches"] = ops.launch_counts()
        torch.save(res if rank == 0 else {"launches": res["launches"]},
                   f"{tmp}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def disagg_one_rank(cfg, dev, mesh, counts):
    """8(b): a world of one over NCCL: the owner of every chunk must equal
    ``shared_attention_batched`` with global routing (the reference
    test's check): fp32 within 3e-5, bf16 within 1e-3."""
    from repro_torch.core import disagg, router
    from repro_torch.core.shared_attention import shared_attention_batched
    from repro_torch.kernels import ops
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v, emb = disagg_inputs(cfg, dtype, dev)
        ops.reset_launches()
        out, lse = disagg.disaggregated_shared_attention(q, k, v, emb,
                                                         cfg.moska, mesh)
        counts.update(ops.launch_counts())
        part = shared_attention_batched(
            q[:, None], k, v, router.route(q, emb, cfg.moska.top_k_chunks),
            capacity_factor=cfg.moska.query_capacity_factor)
        torch.cuda.synchronize()
        tol = DISAGG_TOL[dtype]
        err = max(float((a.float() - b.float()).abs().max()) for a, b in
                  ((out, part.out[:, 0]), (lse, part.lse[:, 0])))
        say(f"[disagg] one rank (nccl) {str(dtype)[6:]:8s} vs batched "
            f"attention, global routing: max_abs_err={err:.3e} tol={tol:g}")
        check(err <= tol, ("disagg one rank", dtype, err))
        del q, k, v, emb, part
        torch.cuda.empty_cache()


def disagg_owners(cfg, dev, counts, backend="gloo"):
    """8(c): DISAGG_OWNERS ranks on the one card over gloo (or over NCCL,
    a card a rank), each owning E / 4 chunks; rank 0's merged output
    against the same owners' partials composed here (route + batched
    attention per shard, the reference's combine in fp32); the four-rank
    call's wall, the all-reduces' share of it, and one process's batched
    attention over all chunks (global routing)."""
    import tempfile
    from repro_torch.core import router
    from repro_torch.core.shared_attention import shared_attention_batched
    torch.cuda.empty_cache()
    shape = dict(corpus=DISAGG_CORPUS, queries=DISAGG_QUERIES)
    with tempfile.TemporaryDirectory() as tmp:
        ctx = torch.multiprocessing.start_processes(
            _disagg_rank, args=(DISAGG_OWNERS, tmp, cfg, dev, shape,
                                 backend),
            nprocs=DISAGG_OWNERS, join=False, start_method="spawn")
        deadline = time.monotonic() + DISAGG_DEADLINE
        while not ctx.join(timeout=1):        # raises if a rank failed
            if time.monotonic() > deadline:
                for proc in ctx.processes:
                    proc.kill()
                check(False, ("disagg ranks outlasted", DISAGG_DEADLINE))
        ranks = [torch.load(f"{tmp}/rank{r}.pt")
                 for r in range(DISAGG_OWNERS)]
    for r in ranks:
        counts.update(r["launches"])
    res = ranks[0]
    K, cf = cfg.moska.top_k_chunks, cfg.moska.query_capacity_factor
    for dtype in (torch.bfloat16, torch.float32):
        tag = str(dtype)[6:]
        q, k, v, emb = disagg_inputs(cfg, dtype, dev)
        E = k.shape[0] // DISAGG_OWNERS
        parts = [shared_attention_batched(
            q[:, None], k[s:s + E], v[s:s + E],
            router.route(q, emb[s:s + E], min(K, E)), capacity_factor=cf)
            for s in range(0, k.shape[0], E)]
        out, lse = combine_partials(
            torch.stack([p.out[:, 0] for p in parts]),
            torch.stack([p.lse[:, 0] for p in parts]))
        tol = OWNERS_TOL[dtype]
        err = max(float((a.float() - b.float().to(dev)).abs().max())
                  for a, b in ((out.to(dtype), res[f"{tag}/out"]),
                               (lse, res[f"{tag}/lse"])))
        say(f"[disagg] {DISAGG_OWNERS} owners ({backend}) {tag:8s} vs their "
            f"partials combined here: max_abs_err={err:.3e} tol={tol:g}")
        check(err <= tol, ("disagg owners", dtype, err))

        def batched():
            return shared_attention_batched(
                q[:, None], k, v, router.route(q, emb, K),
                capacity_factor=cf)
        one = _wall_ms(batched, dev)
        ms, ar = res[f"{tag}/ms"], res[f"{tag}/allreduce_ms"]
        byts = 2 * k.numel() * k.element_size()
        say(f"[disagg] {tag}: {DISAGG_OWNERS}-owner call {ms:.3f} ms "
            f"(median of {DISAGG_REPS}), its two all-reduces alone "
            f"{ar:.3f} ms ({ar / ms:.1%}); one process over all "
            f"{k.shape[0]} chunks {one:.3f} ms; the store's "
            f"{byts} B at {HBM_BYTES_PER_S / 1e12:g} TB/s: "
            f"{byts / HBM_BYTES_PER_S * 1e3:.3f} ms")
        del q, k, v, emb, parts
        torch.cuda.empty_cache()


def mesh_train(dev):
    """8(d): ``launch.train.run`` with and without ``--host-mesh`` (a world
    of one over NCCL: FSDP over the data axis), tinyllama-1.1b at full
    width and depth, bf16, TRAIN_BATCH x TRAIN_SEQ, MESH_STEPS steps:
    every step's loss within MESH_TOL relative (bit for bit expected but
    for the card's atomic scatter-adds); step p50 and peak memory of each;
    no kernel of the port launched."""
    from repro_torch.kernels import ops
    from repro_torch.launch import train as launch
    argv = ["--arch", ARCH, "--steps", str(MESH_STEPS), "--batch",
            str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ), "--device", dev.type]
    hist = {}
    for label, extra in (("unmeshed", []), ("--host-mesh", ["--host-mesh"])):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        n0 = ops.launch_counts()
        hist[label] = launch.run(argv + extra, log_every=1)
        check(ops.launch_counts() == n0, (label, "kernel launches"))
        train_report(f"{ARCH} {label}", hist[label], TRAIN_BATCH, TRAIN_SEQ)
    a, b = ([h["loss"] for h in hist[k]] for k in hist)
    check(len(a) == len(b) == MESH_STEPS, ("mesh train steps", a, b))
    gap = max(abs(x - y) / abs(x) for x, y in zip(a, b))
    say(f"[disagg] --host-mesh vs unmeshed, {MESH_STEPS} steps: largest "
        f"loss gap {gap:.3e} relative (tolerance {MESH_TOL}), bit for bit: "
        f"{a == b}")
    check(gap <= MESH_TOL, ("mesh train losses", gap))


def phase_disagg(dev, errs):
    """Phase 8: (a) the three kernels of the disaggregated path at
    moska-llama3.1-8b's heads (G = 4, D = 128) against their plain
    versions, at the single process's 64 chunks and at one owner's 16,
    bf16 and fp32; (b) the path in a world of one over NCCL; (c) four
    owners on the one card over gloo; (d) training under --host-mesh.
    Returns the launches of (b) and (c)."""
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import init_distributed, make_host_mesh
    cfg = get_config(DISAGG_ARCH)
    bf16, fp32 = torch.bfloat16, torch.float32
    owner = DISAGG_CORPUS // DISAGG_OWNERS
    check_kernels_at(
        cfg, dev, "disagg", errs,
        ("shared_chunk_attention", "lse_merge", "router_scores"),
        decodes=[(dt, dict(corpus=c, slots=DISAGG_QUERIES))
                 for dt in (bf16, fp32) for c in (DISAGG_CORPUS, owner)])
    counts = collections.Counter()
    created = init_distributed(dev.type)
    try:
        disagg_one_rank(cfg, dev, make_host_mesh(device=dev.type), counts)
        disagg_owners(cfg, dev, counts)
        mesh_train(dev)
    finally:
        if created:
            dist.destroy_process_group()
    say(f"[disagg] launches: {dict(counts)}")
    for name in ("shared_chunk_attention", "lse_merge", "router_scores"):
        check(counts[name] > 0, ("disagg path launched no", name))
    return counts


# ---------------------------------------------------------------------------
# phase 9: the launch tools
# ---------------------------------------------------------------------------

def _launch_cfg():
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(ARCH).reduced(), dtype="float32")


def _ckpt_rank(rank, world, tmp):
    """9(a): one rank of a gloo world on the one card, deterministic
    algorithms on: ``train`` under the host mesh (FSDP over ``data``),
    saving at LAUNCH_SAVE; rank 0 copies that save alone into a second
    directory, from which a fresh ``train`` resumes to LAUNCH_STEPS. Each
    rank writes both runs' losses and whether its parameter and moment
    shards are equal bit for bit."""
    import datetime
    import os
    import shutil
    import torch.distributed as dist
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.set_device(0)
    from repro_torch.data.pipeline import make_train_batches
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.sharding import TRAIN_RULES, use_rules
    from repro_torch.training.train_loop import TrainLoopConfig, train
    dist.init_process_group("gloo", init_method=f"file://{tmp}/rdzv",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=120))
    try:
        cfg = _launch_cfg()
        mesh = make_host_mesh(device="cuda")

        def run(ckpt, every, skip):
            batches = make_train_batches(cfg, LAUNCH_BATCH, LAUNCH_SEQ)
            for _ in range(skip):           # read from their start
                next(batches)
            loop = TrainLoopConfig(num_steps=LAUNCH_STEPS,
                                   batch_size=LAUNCH_BATCH,
                                   seq_len=LAUNCH_SEQ, log_every=1,
                                   ckpt_dir=f"{tmp}/{ckpt}",
                                   ckpt_every=every)
            with use_rules(TRAIN_RULES):
                return train(cfg, loop, batches, device="cuda", mesh=mesh)
        full = run("full", LAUNCH_SAVE, 0)
        if rank == 0:
            name = f"step_{LAUNCH_SAVE:08d}"
            shutil.copytree(f"{tmp}/full/{name}", f"{tmp}/part/{name}")
            with open(f"{tmp}/part/LATEST", "w") as f:
                f.write(name)
        dist.barrier()
        resumed = run("part", 0, LAUNCH_SAVE)

        def shards(out):
            st = out["opt_state"]
            return [t.to_local() if hasattr(t, "to_local") else t
                    for t in [p for p in out["params"].parameters()]
                    + list(st.mu.values()) + list(st.nu.values())]
        same = all(torch.equal(a, b) for a, b in zip(shards(full),
                                                     shards(resumed)))
        torch.save({"full": [h["loss"] for h in full["history"]],
                    "resumed": [(h["step"], h["loss"])
                                for h in resumed["history"]],
                    "same": same}, f"{tmp}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def launch_checkpoint():
    """9(a): the repaired meshed checkpoint on the card. Both ranks' runs:
    the resumed steps' losses and every shard of the parameters and the
    moments bit for bit those of the uninterrupted run."""
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        ctx = torch.multiprocessing.start_processes(
            _ckpt_rank, args=(2, tmp), nprocs=2, join=False,
            start_method="spawn")
        deadline = time.monotonic() + LAUNCH_DEADLINE
        while not ctx.join(timeout=1):        # raises if a rank failed
            if time.monotonic() > deadline:
                for proc in ctx.processes:
                    proc.kill()
                check(False, ("checkpoint ranks outlasted", LAUNCH_DEADLINE))
        ranks = [torch.load(f"{tmp}/rank{r}.pt") for r in range(2)]
    for r, res in enumerate(ranks):
        tail = [loss for _, loss in res["resumed"]]
        steps = [s for s, _ in res["resumed"]]
        equal = tail == res["full"][LAUNCH_SAVE:]
        say(f"[launch] (a) rank {r} of a gloo world of 2 on the card: "
            f"{LAUNCH_STEPS} steps saved at {LAUNCH_SAVE}, resumed steps "
            f"{steps}: losses bit for bit {equal}, parameter and moment "
            f"shards bit for bit {res['same']}")
        check(equal and res["same"] and steps == list(
            range(LAUNCH_SAVE, LAUNCH_STEPS)), ("meshed resume", r, res))


def launch_dryrun(arch=DRY_ARCH, shape=DRY_SHAPE, tag="[launch] (b)"):
    """9(b) (and 10(b)): the dry run's record of ``arch`` x ``shape`` on
    the 16x16 mesh, traced on fake CUDA tensors and on fake CPU tensors in
    this one process: flops, traffic, collective bytes and peak must be
    equal."""
    import torch.distributed as dist
    from repro_torch.launch import dryrun
    out = str(ROOT / "build" / "dryrun_torch")
    try:
        recs = {d: dryrun.run_one(arch, shape, False, out, verbose=False,
                                  device=d)
                for d in ("cuda", "cpu")}
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    for d, rec in recs.items():
        check(rec["status"] == "ok", ("dry run", d, rec))
        r = rec["roofline"]
        say(f"{tag} dry run {arch} x {shape} x 16x16 on "
            f"fake {d} tensors: flops/chip={r['flops_per_chip']:.6e} "
            f"bytes/chip={r['bytes_per_chip']:.6e} collective/chip="
            f"{r['collective_bytes_per_chip']:.6e} peak/chip="
            f"{r['peak_mem_per_chip'] / 2**30:.3f} GiB, terms (a model of "
            f"the card): compute {r['compute_s']:.3e} s memory "
            f"{r['memory_s']:.3e} s collective {r['collective_s']:.3e} s, "
            f"trace {rec['trace_s']:.1f} s")
    same = all(recs["cuda"]["roofline"][k] == recs["cpu"]["roofline"][k]
               for k in DRY_KEYS)
    say(f"{tag} the card's record equals the CPU-traced one: {same}")
    check(same, ("dry run cuda vs cpu", arch, recs))


def launch_step_roofline(cfg, dev):
    """9(c): phase 6's slotted decode step (SLOTS slots of a 512-token
    slab, a CORPUS-token store, bf16, a world of one) traced by the dry
    run's counter on fake tensors, against phase 6's measured step."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.core.shared_kv import abstract_store
    from repro_torch.launch.op_cost import analyze_ops
    from repro_torch.models import dense
    from repro_torch.models.model import build_model, empty_params
    with FakeTensorMode(allow_non_fake_inputs=True):
        params = empty_params(cfg, dev)
        store = abstract_store(cfg, CORPUS, device=dev)
        cache = build_model(cfg).init_cache(SLOTS, 512, device=dev,
                                            abstract=True)
        tokens = torch.empty((SLOTS,), dtype=torch.int64, device=dev)
        cost, peak = analyze_ops(lambda: dense.decode_step(
            cfg, params, tokens, cache, store=store))
    bound = max(cost.flops / BF16_FLOP_PER_S, cost.traffic / HBM_BYTES_PER_S)
    wall, busy = PROFILED["decode step"]
    say(f"[launch] (c) the served decode step ({SLOTS} slots, slab 512, "
        f"{CORPUS // cfg.moska.chunk_size} chunks, bf16, a world of one), "
        f"traced: flops={cost.flops:.6e} traffic={cost.traffic:.6e} B "
        f"(kernels at capacity: every slot's 512 positions, every "
        f"dispatch slot), bound max(flops / {BF16_FLOP_PER_S:.3g}, "
        f"traffic / {HBM_BYTES_PER_S:.3g}) = {bound * 1e3:.4f} ms; phase 6 "
        f"measured device busy {busy * 1e3:.4f} ms, unprofiled wall "
        f"{wall * 1e3:.4f} ms: the bound's share {bound / busy:.3f} of "
        f"busy, {bound / wall:.3f} of the wall; on {card_name_and_limit()}")
    check(cost.flops > 0 and cost.traffic > 0, ("step roofline", cost))


def phase_launch(cfg, dev):
    """Phase 9: (a) the meshed checkpoint, (b) the dry-run record, (c)
    the decode step's traced work against its measured time."""
    launch_checkpoint()
    launch_dryrun()
    launch_step_roofline(cfg, dev)


# ---------------------------------------------------------------------------
# phase 10: expert parallelism
# ---------------------------------------------------------------------------

def _empty_cache(dev):
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def _ep_cfg():
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(EP_ARCH), dtype="float32")


@contextlib.contextmanager
def _ep_first_update(ref=None):
    """Records the first AdamW update's gradients: with ``ref`` (the
    one-process run's whole gradients, on the card) each leaf's largest
    gap to it over that leaf's largest, else the gradients themselves;
    and their ``global_norm``. A meshed gradient is gathered whole, a
    collective that every rank joins."""
    from repro_torch.sharding.tensor_parallel import full_tensor, is_meshed
    from repro_torch.training import train_loop
    from repro_torch.training.optimizer import global_norm
    real, seen = train_loop.adamw_update, {}

    def update(grads, state, params, **kw):
        if not seen:
            seen["gnorm"] = float(global_norm(grads))
            seen["grads"], seen["gaps"] = {}, {}
            for n, g in grads.items():
                g = full_tensor(g) if is_meshed(g) else g.detach().clone()
                if ref is None:
                    seen["grads"][n] = g
                elif n in ref:
                    seen["gaps"][n] = float((g - ref[n]).abs().max()
                                            / ref[n].abs().max())
        return real(grads, state, params, **kw)

    train_loop.adamw_update = update
    try:
        yield seen
    finally:
        train_loop.adamw_update = real


@contextlib.contextmanager
def _ep_routes(force=None):
    """Records each MoE call's expert choices (the ids of ``top_k`` in
    ``models/moe.py``, this rank's rows); with ``force`` (a run's record)
    the calls take those choices instead, their gates read from their own
    probabilities."""
    from repro_torch.models import moe
    real, seen = moe.top_k, []

    def top_k(probs, k):
        vals, ids = real(probs, k)
        if force is not None:
            ids = force[len(seen)].to(ids.device)
            vals = probs.gather(-1, ids)
        seen.append(ids.detach().clone())
        return vals, ids

    moe.top_k = top_k
    try:
        yield seen
    finally:
        moe.top_k = real


def _ep_decode(cfg, dev, mesh=None):
    """Prefill of EP_PROMPTS prompts (no store) and one decode step routed
    over an EP_CORPUS-token store, inputs from seeds; with ``mesh`` both
    on inputs placed by the serving rules (the store split by chunk
    position over ``model``), and the MoE layer's collective bytes by kind
    counted at the prefill's and the decode's rows. Returns ({"prefill",
    "decode"}: logits whole on the CPU, collective bytes or None)."""
    from repro_torch.core.shared_kv import build_store
    from repro_torch.launch.input_specs import _CACHE_AXES, _STORE_AXES
    from repro_torch.models.model import build_model
    from repro_torch.sharding import SERVE_RULES, use_rules
    from repro_torch.sharding.tensor_parallel import (full_tensor, place,
                                                      place_fields)
    from repro_torch.training.train_loop import tensor_parallel
    model = build_model(cfg)
    params = model.init(torch.Generator(dev).manual_seed(1), dev)
    g = torch.Generator(dev).manual_seed(5)
    L, KH, D = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim
    store = build_store(*(torch.randn((L, EP_CORPUS, KH, D), generator=g,
                                      device=dev) for _ in range(2)),
                        cfg.moska.chunk_size)
    tokens = torch.randint(0, cfg.vocab_size, (EP_PROMPTS, EP_PROMPT),
                           generator=g, device=dev)
    nxt = torch.randint(0, cfg.vocab_size, (EP_PROMPTS,), generator=g,
                        device=dev)
    cache = model.init_cache(EP_PROMPTS, EP_MAX_SEQ, dtype=torch.float32,
                             device=dev)
    if mesh is None:
        lp, cache = model.prefill(params, tokens, cache)
        ld, _ = model.decode_step(params, nxt, cache, store=store)
        return {"prefill": lp.cpu(), "decode": ld.cpu()}, None
    with use_rules(SERVE_RULES):
        tensor_parallel(model, params, mesh)
        cache = place_fields(cache, _CACHE_AXES, SERVE_RULES, mesh)
        store = place_fields(store, _STORE_AXES, SERVE_RULES, mesh)
        tokens, nxt = (place(t, ("batch",), SERVE_RULES, mesh)
                       for t in (tokens, nxt))
        lp, cache = model.prefill(params, tokens, cache)
        ld, _ = model.decode_step(params, nxt, cache, store=store)
        out = {"prefill": full_tensor(lp).cpu(),
               "decode": full_tensor(ld).cpu()}
        _sync(dev)
        coll = _ep_collectives(cfg, dev, mesh, params.layers[0].moe)
    return out, coll


def _ep_collectives(cfg, dev, mesh, moe_params):
    """The collective bytes by kind of one MoE layer on this rank, its
    output's reduction over ``model`` (the residual's pin) included, as
    the dry run's counter (``launch/op_cost.py``) counts them: forward at
    the prefill's rows and at the decode step's (serving rules), forward
    and backward at a training step's (training rules)."""
    from repro_torch.launch.op_cost import analyze_ops
    from repro_torch.models.moe import moe_ffn
    from repro_torch.sharding import (SERVE_RULES, TRAIN_RULES, lsc,
                                      use_rules)
    from repro_torch.sharding.tensor_parallel import place

    def layer(x, **kw):
        y, aux = moe_ffn(x, moe_params, cfg.moe, **kw)
        return lsc(y, "batch", None), aux
    out = {}
    for label, rows, rules in (("prefill", EP_PROMPTS * EP_PROMPT,
                                SERVE_RULES),
                               ("decode", EP_PROMPTS, SERVE_RULES),
                               ("train", EP_BATCH * EP_SEQ, TRAIN_RULES)):
        x = torch.randn((rows, cfg.d_model), device=dev)
        with use_rules(rules):
            x = place(x, ("batch", None), rules, mesh)
            if label == "train":
                x.requires_grad_(True)

                def step():
                    y, aux = layer(x)
                    (y.to_local().square().sum() + aux.to_local()).backward()
                cost, _ = analyze_ops(step)
            else:
                with torch.no_grad():
                    cost, _ = analyze_ops(layer, x, with_aux=False)
        out[label] = dict(cost.per_collective)
    return out


def _ep_rank(rank, world, tmp, device="cuda"):
    """One rank of phase 10(a) on the one card, over gloo: rank 0 first
    runs the one-process training and decode (the reference, gradients
    kept on the card), then both ranks run them on the (1, 2) mesh, rank
    0 holding the first update's gradients against the reference's. Each
    rank writes its results and its decode step's kernel launches."""
    import datetime
    import faulthandler
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.data.pipeline import make_train_batches
    from repro_torch.kernels import ops
    from repro_torch.sharding import TRAIN_RULES, use_rules
    from repro_torch.training.train_loop import TrainLoopConfig, train
    faulthandler.enable()                 # a crashed rank prints its stack
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        dev = torch.device("cuda", 0)
        torch.cuda.set_device(dev)
    cfg = _ep_cfg()
    loop = TrainLoopConfig(num_steps=EP_STEPS, batch_size=EP_BATCH,
                           seq_len=EP_SEQ, log_every=1)

    def history(out):
        return {k: [h[k] for h in out["history"]]
                for k in ("loss", "moe_aux")}
    res, ref = {}, None
    if rank == 0:                       # the one-process reference
        with _ep_first_update() as first:
            out = train(cfg, loop, make_train_batches(cfg, EP_BATCH, EP_SEQ),
                        device=dev.type)
        ref = first["grads"]
        res["ref"] = dict(history(out), gnorm=first["gnorm"])
        del out, first
        _empty_cache(dev)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/rdzv",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=EP_DEADLINE))
    try:
        mesh = init_device_mesh(dev.type, EP_SHAPE,
                                mesh_dim_names=("data", "model"))
        t = time.perf_counter()
        with use_rules(TRAIN_RULES), _ep_first_update(ref) as first:
            out = train(cfg, loop, make_train_batches(cfg, EP_BATCH, EP_SEQ),
                        device=dev.type, mesh=mesh)
        res["train_s"] = time.perf_counter() - t
        res.update(history(out), gnorm=first["gnorm"], gaps=first["gaps"])
        del out, first, ref
        _empty_cache(dev)
        ops.reset_launches()
        with _ep_routes() as routes:
            res["logits"], res["collectives"] = _ep_decode(cfg, dev, mesh)
        res["launches"] = ops.launch_counts()
        res["peak_gb"] = (torch.cuda.max_memory_allocated() / 1e9
                          if dev.type == "cuda" else float("nan"))
    finally:
        dist.destroy_process_group()
    if rank == 0:
        # one process: with its own routing, then with the meshed run's
        _empty_cache(dev)
        with _ep_routes() as own:
            res["ref"]["logits"] = _ep_decode(cfg, dev)[0]
        res["flips"] = [int((a != b.to(a.device)).any(-1).sum())
                        for a, b in zip(own, routes)]
        with _ep_routes(force=routes):
            res["ref"]["forced"] = _ep_decode(cfg, dev)[0]
    torch.save(res, f"{tmp}/rank{rank}.pt")


def ep_ranks(dev):
    """10(a): spawn the two ranks and hold the meshed runs to rank 0's
    one-process runs. Returns the ranks' decode launches, summed."""
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        ctx = torch.multiprocessing.start_processes(
            _ep_rank, args=(2, tmp, dev.type), nprocs=2, join=False,
            start_method="spawn")
        deadline = time.monotonic() + EP_DEADLINE
        while not ctx.join(timeout=1):        # raises if a rank failed
            if time.monotonic() > deadline:
                for proc in ctx.processes:
                    proc.kill()
                check(False, ("expert-parallel ranks outlasted",
                              EP_DEADLINE))
        ranks = [torch.load(f"{tmp}/rank{r}.pt") for r in range(2)]
    got, ref = ranks[0], ranks[0]["ref"]
    for key in ("loss", "moe_aux"):
        gaps = [abs(a - b) / abs(b) for a, b in zip(got[key], ref[key])]
        say(f"[ep] (a) {EP_STEPS} training steps on the {EP_SHAPE} mesh vs "
            f"one process: {key} {got[key]} vs {ref[key]}, gaps "
            f"{['%.3e' % g for g in gaps]} relative (tolerance "
            f"{EP_LOSS_REL}: the loss every step, the aux loss at the "
            f"first, from the same weights)")
        held = gaps if key == "loss" else gaps[:1]
        check(len(got[key]) == EP_STEPS and max(held) <= EP_LOSS_REL,
              ("ep", key, got[key], ref[key]))
    worst = max(got["gaps"], key=got["gaps"].get)
    gn, gw = got["gnorm"], ref["gnorm"]
    say(f"[ep] (a) first update: largest gradient gap "
        f"{got['gaps'][worst]:.3e} of its leaf's largest ({worst}, "
        f"{len(got['gaps'])} leaves); global norm {gn:.8e} vs {gw:.8e}")
    check(got["gaps"][worst] <= EP_GRAD_REL and
          abs(gn - gw) <= EP_GRAD_REL * gw, ("ep gradients", worst, gn, gw))
    layers = len(got["flips"]) // 2       # a prefill's calls, a decode's
    say(f"[ep] (a) rows whose expert choices differ between the one-process "
        f"run and the meshed one ({EP_PROMPTS * EP_PROMPT} rows a prefill "
        f"layer, {EP_PROMPTS} a decode layer): prefill "
        f"{got['flips'][:layers]}, decode {got['flips'][layers:]}")
    for key, tol in (("prefill", EP_LOGIT_TOL), ("decode", EP_DECODE_TOL)):
        a = got["logits"][key]
        errs_by = {w: float((a - ref[w][key]).abs().max())
                   for w in ("logits", "forced")}
        same = torch.equal(a.argmax(-1), ref["logits"][key].argmax(-1))
        say(f"[ep] (a) {key} logits ({tuple(a.shape)}, |logits| max "
            f"{float(a.abs().max()):.3f}) vs one process: with the meshed "
            f"run's expert choices max_abs_err={errs_by['forced']:.3e} "
            f"(tolerance {tol:g}); with its own {errs_by['logits']:.3e}, "
            f"same greedy tokens {same}")
        check(errs_by["forced"] <= tol and same,
              ("ep logits", key, errs_by, same))
    counts = collections.Counter()
    for r, res in enumerate(ranks):
        say(f"[ep] (a) rank {r}: meshed training {res['train_s']:.1f} s, "
            f"peak {res['peak_gb']:.2f} GB; decode step launches "
            f"{dict(res['launches'])}")
        counts.update(res["launches"])
        for name in EP_KERNELS:
            check(res["launches"].get(name, 0) > 0,
                  ("ep rank", r, "launched no", name))
    for label, by_kind in ranks[0]["collectives"].items():
        say(f"[ep] (a) one MoE layer's collective bytes a rank, {label} "
            f"(counted by launch/op_cost.py, a model of the card, not a "
            f"measurement): " + ", ".join(
                f"{k} {v:.6e}" for k, v in sorted(by_kind.items())))
    return counts


def phase_ep(dev, errs):
    """Phase 10: (a) expert parallelism on the card against one process,
    the decode kernels first checked at a rank's shapes; (b) the MoE
    dry-run record on fake CUDA and CPU tensors. Returns (a)'s launches."""
    cfg = _ep_cfg()
    half = dataclasses.replace(cfg, moska=dataclasses.replace(
        cfg.moska, chunk_size=cfg.moska.chunk_size // EP_SHAPE[1]))
    check_kernels_at(
        half, dev, "ep", errs, EP_KERNELS,
        decodes=[(torch.float32, dict(
            corpus=EP_CORPUS // EP_SHAPE[1], slots=EP_PROMPTS,
            slab=EP_MAX_SEQ // EP_SHAPE[1], lens=(1, EP_PROMPT + 1)))])
    counts = ep_ranks(dev)
    launch_dryrun(EP_ARCH, "decode_32k", tag="[ep] (b)")
    return counts


# ---------------------------------------------------------------------------
# phase 11: tensor parallelism of the SSM, hybrid and enc-dec families
# ---------------------------------------------------------------------------

def _tps_cfg(arch, layers):
    from repro_torch.configs import get_config
    cfg = dataclasses.replace(get_config(arch), dtype="float32")
    return cfg if layers is None else dataclasses.replace(cfg,
                                                          num_layers=layers)


def _tps_serve(cfg, dev, mesh=None):
    """Prefill of TPS_PROMPTS prompts (whisper's behind one audio's
    frames) and one decode step (whisper's routed over a store of the
    audio's cross K/V, built from the run's own cross cache), inputs from
    seeds; with ``mesh`` on inputs placed by the serving rules. Returns
    {"prefill", "decode"}: logits whole on the CPU, and the decode step's
    kernel launches."""
    from repro_torch.core.shared_kv import build_store
    from repro_torch.kernels import ops
    from repro_torch.launch.input_specs import _CACHE_AXES, _STORE_AXES
    from repro_torch.models.model import build_model
    from repro_torch.sharding import SERVE_RULES, use_rules
    from repro_torch.sharding.tensor_parallel import (full_tensor, place,
                                                      place_fields)
    from repro_torch.training.train_loop import tensor_parallel
    model = build_model(cfg)
    params = model.init(torch.Generator(dev).manual_seed(1), dev)
    g = torch.Generator(dev).manual_seed(5)
    tokens = torch.randint(0, cfg.vocab_size, (TPS_PROMPTS, TPS_PROMPT),
                           generator=g, device=dev)
    nxt = torch.randint(0, cfg.vocab_size, (TPS_PROMPTS,), generator=g,
                        device=dev)
    frames = None
    if cfg.encoder.enabled:
        F_ = cfg.encoder.frontend_seq
        frames = torch.randn((1, F_, cfg.d_model), generator=g, device=dev
                             ).expand(TPS_PROMPTS, -1, -1).contiguous()
    cache = model.init_cache(TPS_PROMPTS, TPS_MAX_SEQ, dtype=torch.float32,
                             device=dev)
    whole = (lambda t: t) if mesh is None else full_tensor
    with use_rules(None if mesh is None else SERVE_RULES):
        if mesh is not None:
            tensor_parallel(model, params, mesh)
            cache = place_fields(cache, _CACHE_AXES, SERVE_RULES, mesh)
            tokens, nxt, frames = (None if t is None else place(
                t, ("batch",), SERVE_RULES, mesh)
                for t in (tokens, nxt, frames))
        lp, cache = model.prefill(params, tokens, cache,
                                  frontend_embeds=frames)
        store = None
        if cfg.encoder.enabled:
            store = build_store(whole(cache["cross_k"])[:, 0],
                                whole(cache["cross_v"])[:, 0],
                                cfg.moska.chunk_size)
            if mesh is not None:
                store = place_fields(store, _STORE_AXES, SERVE_RULES, mesh)
        _sync(dev)
        ops.reset_launches()
        ld, _ = model.decode_step(params, nxt, cache, store=store)
        _sync(dev)
        launches = ops.launch_counts()
        out = {"prefill": whole(lp).cpu(), "decode": whole(ld).cpu()}
    return out, launches


def _tps_rank(rank, world, tmp, device="cuda"):
    """One rank of phase 11(a) on the one card, over gloo: for each arch,
    rank 0 first runs the one-process training and serving steps (the
    reference, its first gradients kept on the card) while rank 1 waits,
    then both ranks run them on the (1, 2) mesh. Each rank writes its
    results and its decode steps' kernel launches."""
    import datetime
    import faulthandler
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.data.pipeline import make_train_batches
    from repro_torch.sharding import TRAIN_RULES, use_rules
    from repro_torch.training.train_loop import TrainLoopConfig, train
    faulthandler.enable()
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        dev = torch.device("cuda", 0)
        torch.cuda.set_device(dev)
    loop = TrainLoopConfig(num_steps=TPS_STEPS, batch_size=TPS_BATCH,
                           seq_len=TPS_SEQ, log_every=1)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/rdzv",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=TPS_DEADLINE))
    res = {}
    try:
        mesh = init_device_mesh(dev.type, TPS_SHAPE,
                                mesh_dim_names=("data", "model"))
        for arch, layers in TPS_ARCHS:
            cfg, got, ref = _tps_cfg(arch, layers), {}, None
            batches = make_train_batches(cfg, TPS_BATCH, TPS_SEQ)
            if rank == 0:                     # the one-process reference
                with _ep_first_update() as first:
                    out = train(cfg, loop, batches, device=dev.type)
                ref = first["grads"]
                got["ref"] = {"loss": [h["loss"] for h in out["history"]],
                              "gnorm": first["gnorm"]}
                del out, first
                _empty_cache(dev)
                got["ref"]["logits"] = _tps_serve(cfg, dev)[0]
                _empty_cache(dev)
            dist.barrier()
            if dev.type == "cuda":
                torch.cuda.reset_peak_memory_stats(dev)
            t = time.perf_counter()
            with use_rules(TRAIN_RULES), _ep_first_update(ref) as first:
                out = train(cfg, loop, make_train_batches(
                    cfg, TPS_BATCH, TPS_SEQ), device=dev.type, mesh=mesh)
            got["train_s"] = time.perf_counter() - t
            got["peak_gb"] = (torch.cuda.max_memory_allocated(dev) / 1e9
                              if dev.type == "cuda" else float("nan"))
            got.update(loss=[h["loss"] for h in out["history"]],
                       gnorm=first["gnorm"], gaps=first["gaps"])
            del out, first, ref
            _empty_cache(dev)
            got["logits"], got["launches"] = _tps_serve(cfg, dev, mesh)
            _empty_cache(dev)
            res[arch] = got
            dist.barrier()
    finally:
        dist.destroy_process_group()
    torch.save(res, f"{tmp}/rank{rank}.pt")


def tps_ranks(dev):
    """11(a): spawn the two ranks and hold each arch's meshed runs to rank
    0's one-process runs. Returns the ranks' decode launches, summed."""
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        ctx = torch.multiprocessing.start_processes(
            _tps_rank, args=(2, tmp, dev.type), nprocs=2, join=False,
            start_method="spawn")
        deadline = time.monotonic() + TPS_DEADLINE
        while not ctx.join(timeout=1):        # raises if a rank failed
            if time.monotonic() > deadline:
                for proc in ctx.processes:
                    proc.kill()
                check(False, ("state-family ranks outlasted",
                              TPS_DEADLINE))
        ranks = [torch.load(f"{tmp}/rank{r}.pt") for r in range(2)]
    counts, failed = collections.Counter(), []
    for arch, layers in TPS_ARCHS:
        got, ref = ranks[0][arch], ranks[0][arch]["ref"]
        tag = f"[tp-state] (a) {arch}" + ("" if layers is None
                                          else f" ({layers} layers)")
        gaps = [abs(a - b) / abs(b) for a, b in zip(got["loss"],
                                                     ref["loss"])]
        say(f"{tag}: {TPS_STEPS} training steps on the {TPS_SHAPE} mesh "
            f"vs one process: losses {got['loss']} vs {ref['loss']}, gaps "
            f"{['%.3e' % g for g in gaps]} relative (tolerance "
            f"{TPS_LOSS_REL})")
        if not (len(got["loss"]) == TPS_STEPS and
                max(gaps) <= TPS_LOSS_REL):
            failed.append((arch, "loss", got["loss"], ref["loss"]))
        # a key bias's gradient is 0 in exact arithmetic (softmax does not
        # see a bias added to every key): its gap is one of rounding noises
        held = {n: g for n, g in got["gaps"].items()
                if not n.endswith(".bk")}
        worst = max(held, key=held.get)
        say(f"{tag}: first update: largest gradient gap "
            f"{held[worst]:.3e} of its leaf's largest ({worst}, "
            f"{len(held)} leaves besides the key biases; printed, not "
            f"held); global norm {got['gnorm']:.8e} vs {ref['gnorm']:.8e}")
        for key, tol in (("prefill", TPS_LOGIT_TOL),
                         ("decode", TPS_DECODE_TOL)):
            a, b = got["logits"][key], ref["logits"][key]
            err = float((a - b).abs().max())
            same = torch.equal(a.argmax(-1), b.argmax(-1))
            say(f"{tag}: {key} logits ({tuple(a.shape)}, |logits| max "
                f"{float(a.abs().max()):.3f}) vs one process: max_abs_err="
                f"{err:.3e} (tolerance {tol:g}), same greedy tokens {same}")
            failed += [] if (bool(torch.isfinite(a).all()) and err <= tol
                             and same) else [(arch, key, err, same)]
        for r, res in enumerate(ranks):
            mine = res[arch]
            say(f"{tag}: rank {r}: meshed training {mine['train_s']:.1f} s, "
                f"peak {mine['peak_gb']:.2f} GB; decode step launches "
                f"{dict(mine['launches'])}")
            counts.update(res[arch]["launches"])
            if arch == AUDIO_ARCH:
                failed += [(r, "launched no", name) for name in TPS_KERNELS
                           if not res[arch]["launches"].get(name, 0)]
    check(not failed, ("tp-state", failed))
    return counts


def phase_tp_state(dev, errs):
    """Phase 11: (a) the state families tensor parallel on the card
    against one process, whisper's kernels first checked at a rank's
    shapes; (b) a dry-run record of each family on fake CUDA and CPU
    tensors. Returns (a)'s launches."""
    cfg = _tps_cfg(AUDIO_ARCH, None)
    per = cfg.num_heads // TPS_SHAPE[1]
    half = dataclasses.replace(cfg, num_heads=per, num_kv_heads=per)
    F_ = cfg.encoder.frontend_seq
    check_kernels_at(
        half, dev, "tp-state", errs, TPS_KERNELS,
        decodes=[(torch.float32, dict(
            corpus=F_, slots=TPS_PROMPTS, slab=TPS_MAX_SEQ,
            lens=(TPS_MAX_SEQ, TPS_MAX_SEQ + 1)))])
    counts = tps_ranks(dev)
    for arch, _ in TPS_ARCHS:
        launch_dryrun(arch, "decode_32k", tag="[tp-state] (b)")
    return counts


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

    def run(phase, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        torch.cuda.empty_cache()
        say(f"[phase] {phase}: {time.perf_counter() - t:.1f} s")
        return out

    # every phase's launches of each kernel, summed for the JSON line
    launches = collections.Counter()
    run("1 build", phase_build)
    errs = run("2 check", phase_check, cfg, dev)
    launches.update(run("3 serve", phase_serve, cfg)[0])
    paged_counts, params, store = run("3b paged", phase_paged, cfg, dev)
    launches.update(paged_counts)
    launches.update(run("3h tier", phase_tier, cfg, dev, params))
    launches.update(run("3c q8", phase_q8, cfg, dev, params, store))
    del params, store
    run("4 agree", phase_agree, cfg, dev)
    rows = run("5 time", phase_time, cfg, dev, launches, errs)
    run("6 profile", phase_profile, cfg, dev)
    # the dense family's other members and the other families run last,
    # so that phases 1-6 run as they did before them: cuBLAS picks its GEMM kernels by what the
    # process ran before, and phase 6 counts the step's kernels exactly
    for counts in run("3m moe", phase_moe, dev, errs):
        launches.update(counts)
    launches.update(run("3w widths", phase_widths, dev, errs))
    launches.update(run("3f families", phase_families, dev, errs))
    run("7 train", phase_train, dev)
    launches.update(run("8 disagg", phase_disagg, dev, errs))
    run("9 launch", phase_launch, cfg, dev)
    launches.update(run("10 ep", phase_ep, dev, errs))
    launches.update(run("11 tp families", phase_tp_state, dev, errs))
    launches.update(run("3t trinity", phase_trinity, dev))
    for row in rows:
        row["launches"] = launches[row["name"]]
        row["max_abs_err"] = errs[row["name"]]
    say(f"[done] {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(card_name_and_limit())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
