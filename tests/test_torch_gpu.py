"""Card tests of the port: each hand-written CUDA kernel against its plain
PyTorch version on the same CUDA tensors, over the shape and dtype sweeps
of ``tests/test_kernels.py`` (the decode kernels also with a sliding
window, the paged kernel also bit for bit against the slotted one on the
same logical cache, and the merge's pair and routed entries bit for bit
against its dense entry), plus dense decode steps on the card (slotted,
paged, over an int8 store) against the same steps on the CPU, and the
host tier on the card: a pinned offload, side-stream prefetch and swap-in
round trip, and a host-tier engine whose generations equal the tier-off
engine's; whisper-tiny's shapes in every kernel it runs, and a prefill
and decode step of each of the SSM, hybrid and enc-dec families on the
card against the same on the CPU; and training on the card: one fp32
training step of tinyllama-1.1b at full width against the same step on
the CPU, and a checkpoint saved from the card and restored onto it.

These tests need an NVIDIA card with the CUDA toolkit; elsewhere they skip.
This file imports no JAX, so it also runs where JAX is not installed:

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_gpu.py
"""
import copy
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core.shared_kv import build_store
from repro_torch.kernels import ops, ref
from repro_torch.kvcache.cache import KVCache, init_kv_cache
from repro_torch.models import dense
from repro_torch.models.model import build_model

pytestmark = pytest.mark.gpu

TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _randn(gen, shape, dtype, device, scale=1.0):
    x = torch.from_numpy(gen.standard_normal(shape).astype(np.float32))
    return (x * scale).to(device=device, dtype=dtype)


def _close(got, want, tol):
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


# Shapes of the shared-chunk kernels (both entries): the first five are
# small sweeps; then the decode step's shape (64 slots x top-8 over 32
# chunks, capacity 32, tinyllama's 32 heads over 4 kv heads), the routed
# prefill's (2 groups of 128 queries x top-8, capacity 8 slots of 128
# rows), a case with a chunk of no valid slot and a chunk of a single one,
# and D = 16 and 128 with C not a multiple of the 64-key tile; then the
# dense family's served groupings at small E and C: granite's (16 heads
# over 8 kv heads, G = 2), qwen's (MHA, G = 1), internvl2's (G = 8 at
# D = 128) and mistral-large's (G = 12 at D = 128); whisper-tiny's routed
# cross-attention (4 chunks of 375 frames, 6 heads over 6, capacity 64 of
# a top-2 over 64 queries).
SHARED_SHAPES = [
    (3, 8, 4, 2, 32, 64),
    (2, 16, 8, 8, 64, 128),
    (1, 4, 2, 1, 16, 32),
    (4, 8, 6, 2, 64, 48),       # C not a multiple of the 64-key tile
    (2, 8, 4, 4, 128, 256),
    (2, 40, 16, 2, 64, 100),    # several row tiles per (chunk, kv head)
    (32, 32, 32, 4, 64, 2048),  # the decode step
    (32, 1024, 32, 4, 64, 2048),  # the routed prefill
    (3, 8, 8, 2, 64, 100),      # chunks of 0, 1 and 2 valid slots
    (3, 24, 8, 2, 16, 100),
    (2, 16, 8, 2, 128, 200),
    (4, 16, 16, 8, 64, 128),    # granite, G = 2
    (4, 16, 16, 16, 64, 128),   # qwen, G = 1
    (3, 8, 64, 8, 128, 100),    # internvl2, G = 8, D = 128
    (3, 8, 96, 8, 128, 100),    # mistral-large, G = 12, D = 128
    (4, 64, 6, 6, 64, 375),     # whisper-tiny, C = 375
]
# Where a shape is named here, chunk e has its first (e % 3) * width slots
# valid and no other (the routed prefill fills each chunk's slots from 0:
# 0, 1 or 2 groups of 128 queries); elsewhere slots are valid at random.
PREFIX_SLOTS = {(32, 1024, 32, 4, 64, 2048): 128, (3, 8, 8, 2, 64, 100): 1}


def _qmask(g, E, cap, H, KH, D, C, device):
    width = PREFIX_SLOTS.get((E, cap, H, KH, D, C))
    if width is None:
        return torch.from_numpy(g.random((E, cap)) < 0.7).to(device)
    n = (torch.arange(E, device=device) % 3 * width)[:, None]
    return torch.arange(cap, device=device)[None] < n


def _by_chunk(plain, *args):
    """The plain version one chunk at a time (chunks are independent): at
    the prefill shape the whole score tensor would be 8.6 GB in fp32."""
    parts = [plain(*(a[e:e + 1] for a in args)) for e in range(len(args[0]))]
    return tuple(torch.cat(p) for p in zip(*parts))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("E,cap,H,KH,D,C", SHARED_SHAPES)
def test_shared_chunk_attention_kernel(cuda, dtype, E, cap, H, KH, D, C):
    g = np.random.default_rng(0)
    qd = _randn(g, (E, cap, H, D), dtype, cuda)
    k = _randn(g, (E, C, KH, D), dtype, cuda)
    v = _randn(g, (E, C, KH, D), dtype, cuda)
    qm = _qmask(g, E, cap, H, KH, D, C, cuda)
    n0 = ops.shared_chunk_attention.launches
    o1, l1 = ops.shared_chunk_attention(qd, k, v, qm)
    torch.cuda.synchronize()
    assert ops.shared_chunk_attention.launches == n0 + 1
    o2, l2 = _by_chunk(ref.shared_chunk_attention_ref, qd, k, v, qm)
    _close(o1, o2, TOL[dtype])
    _close(l1, l2, TOL[dtype])
    assert o1.dtype == dtype and l1.dtype == torch.float32
    assert bool((l1[~qm] < -1e29).all()) and bool((o1[~qm] == 0).all())


# Where a decode shape is named here, its kv lengths are these and not
# random: every 32-key tile edge and 128-key round edge of the split-KV
# kernels (4 warps x 32 keys), and the full slab.
DECODE_LENS = {
    (7, 32, 4, 64, 512): [1, 64, 65, 128, 129, 257, 512],
    (5, 8, 2, 64, 160): [1, 31, 32, 33, 160],
    (2, 32, 4, 64, 4096): [4096, 3001],
    (64, 6, 6, 64, 1500): [1500] * 64,   # whisper's cross cache, F frames
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,KH,D,S", [
    (4, 8, 2, 32, 100),
    (2, 4, 4, 64, 256),
    (3, 2, 1, 16, 33),
    (1, 16, 8, 128, 512),
    (5, 32, 4, 64, 300),        # tinyllama's grouping, G = 8
    (7, 32, 4, 64, 512),        # every split and tile edge, and S
    (5, 8, 2, 64, 160),
    (2, 32, 4, 64, 4096),       # a long cache
    (3, 32, 8, 128, 300),       # llama3's grouping, G = 4, D = 128
    (2, 64, 4, 64, 200),        # G = 16: two blocks per kv head
    (2, 64, 1, 32, 70),         # G = 64, the most the kernels take
    (3, 6, 2, 32, 70),          # G = 3: a masked row in the block
    (3, 16, 8, 64, 100),        # granite, G = 2
    (3, 16, 16, 64, 100),       # qwen, G = 1
    (2, 64, 8, 128, 130),       # internvl2, G = 8, D = 128
    (2, 96, 8, 128, 130),       # mistral-large, G = 12: a second block
                                # per kv head with 4 of 8 heads live
    (64, 6, 6, 64, 48),         # whisper's self-attention, G = 1
    (64, 6, 6, 64, 1500),       # whisper's cross-attention without a store
])
def test_decode_attention_kernel(cuda, dtype, B, H, KH, D, S):
    g = np.random.default_rng(1)
    q = _randn(g, (B, H, D), dtype, cuda)
    k = _randn(g, (B, S, KH, D), dtype, cuda)
    v = _randn(g, (B, S, KH, D), dtype, cuda)
    lens = DECODE_LENS.get((B, H, KH, D, S))
    lens = (g.integers(1, S + 1, B) if lens is None else np.array(lens))
    lens = torch.from_numpy(lens.astype(np.int32)).to(cuda)
    n0 = ops.decode_attention.launches
    o1, l1 = ops.decode_attention(q, k, v, lens)
    torch.cuda.synchronize()
    assert ops.decode_attention.launches == n0 + 1
    o2, l2 = ref.decode_attention_ref(q, k, v, lens)
    _close(o1, o2, TOL[dtype])
    _close(l1, l2, TOL[dtype])


# Sliding-window cases (B, H, KH, D, S, kv lengths or None for random,
# window): kv_len below the window (lo = 0), a window of one key, windows
# that are multiples of neither 32 nor the page size, a window that leaves
# one live tile (the other warps own none), ragged random lengths, and
# D = 128 with G = 4 and G = 3 (a masked row in the block).
WINDOW_CASES = [
    (4, 32, 4, 64, 300, [300, 17, 100, 257], 64),
    (3, 8, 2, 32, 100, [1, 50, 100], 1),
    (5, 32, 4, 64, 512, [1, 36, 37, 38, 512], 37),
    (3, 32, 4, 64, 512, [512, 300, 33], 20),
    (6, 32, 4, 64, 400, None, 45),
    (3, 32, 8, 128, 300, None, 129),
    (3, 6, 2, 32, 70, None, 19),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,KH,D,S,lens,window", WINDOW_CASES)
def test_decode_attention_kernel_window(cuda, dtype, B, H, KH, D, S, lens,
                                        window):
    """With a sliding window, against the plain version's mask
    ``pos >= kv_len - window``."""
    g = np.random.default_rng(9)
    q = _randn(g, (B, H, D), dtype, cuda)
    k = _randn(g, (B, S, KH, D), dtype, cuda)
    v = _randn(g, (B, S, KH, D), dtype, cuda)
    lens = g.integers(1, S + 1, B) if lens is None else np.array(lens)
    lens = torch.from_numpy(lens.astype(np.int32)).to(cuda)
    n0 = ops.decode_attention.launches
    o1, l1 = ops.decode_attention(q, k, v, lens, window=window)
    torch.cuda.synchronize()
    assert ops.decode_attention.launches == n0 + 1
    o2, l2 = ref.decode_attention_ref(q, k, v, lens, window=window)
    _close(o1, o2, TOL[dtype])
    _close(l1, l2, TOL[dtype])


def _paged_inputs(g, B, H, KH, D, N, bs, M, dtype, device):
    """Pools of random pages, distinct scrambled pages per request, and
    lengths from 1 to the full table (one request at exactly M * bs), or
    those ``PAGED_LENS`` names."""
    q = _randn(g, (B, H, D), dtype, device)
    kp = _randn(g, (N, bs, KH, D), dtype, device)
    vp = _randn(g, (N, bs, KH, D), dtype, device)
    table = (g.permutation(N - 1)[:B * M] + 1).reshape(B, M)
    lens = g.integers(1, M * bs + 1, B)
    lens[0] = M * bs
    lens[-1] = 1
    lens = np.array(PAGED_LENS.get((B, H, KH, D, N, bs, M), lens))
    as_i32 = lambda a: torch.from_numpy(a.astype(np.int32)).to(device)
    return q, kp, vp, as_i32(table), as_i32(lens)


# Where a paged shape is named in PAGED_LENS, its kv lengths are these;
# in SLAB_LEN, the slotted kernel it is held to bit for bit gets a slab of
# this many positions (zeros past the table's reach) instead of M * bs.
PAGED_LENS = {
    (7, 32, 4, 64, 240, 16, 32): [1, 64, 65, 128, 129, 300, 512],
    (2, 32, 4, 64, 520, 16, 256): [4096, 3001],
}
SLAB_LEN = {
    (5, 32, 4, 64, 64, 16, 9): 512,
    (7, 32, 4, 64, 240, 16, 32): 600,
    (3, 32, 8, 128, 40, 16, 8): 300,
    (4, 2, 1, 16, 40, 5, 7): 36,
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,KH,D,N,bs,M", [
    (3, 8, 2, 32, 16, 16, 4),
    (2, 4, 4, 64, 9, 32, 3),
    (1, 16, 8, 128, 32, 8, 8),
    (5, 32, 4, 64, 64, 16, 9),     # tinyllama's grouping, 144 = 4.5 tiles
    (4, 2, 1, 16, 40, 5, 7),       # pages not dividing the 32-key tile
    (7, 32, 4, 64, 240, 16, 32),   # every split and tile edge, and M * bs
    (2, 32, 4, 64, 520, 16, 256),  # a long cache: 4,096 positions
    (3, 32, 8, 128, 40, 16, 8),    # llama3's grouping, G = 4, D = 128
    (3, 16, 8, 64, 20, 16, 6),     # granite, G = 2
    (3, 16, 16, 64, 20, 16, 6),    # qwen, G = 1
    (2, 64, 8, 128, 20, 16, 8),    # internvl2, G = 8, D = 128
    (2, 96, 8, 128, 20, 16, 8),    # mistral-large, G = 12, D = 128
])
def test_paged_decode_attention_kernel(cuda, dtype, B, H, KH, D, N, bs, M):
    """Against the plain version (gather + decode), and bit for bit
    against the slotted kernel on the same logical cache, whose slab may
    be longer than the table's reach (M * bs)."""
    g = np.random.default_rng(5)
    q, kp, vp, table, lens = _paged_inputs(g, B, H, KH, D, N, bs, M, dtype,
                                           cuda)
    n0 = ops.paged_decode_attention.launches
    o1, l1 = ops.paged_decode_attention(q, kp, vp, table, lens)
    torch.cuda.synchronize()
    assert ops.paged_decode_attention.launches == n0 + 1
    o2, l2 = ref.paged_decode_attention_ref(q, kp, vp, table, lens)
    _close(o1, o2, TOL[dtype])
    _close(l1, l2, TOL[dtype])
    S = SLAB_LEN.get((B, H, KH, D, N, bs, M), M * bs)
    assert S >= int(lens.max())
    live = (torch.arange(M * bs, device=cuda)[None, :, None, None]
            < lens[:, None, None, None])
    ks = torch.zeros((B, max(S, M * bs), KH, D), dtype=dtype, device=cuda)
    vs = torch.zeros_like(ks)
    ks[:, :M * bs] = torch.where(live, kp[table.long()].reshape(
        B, M * bs, KH, D), 0)
    vs[:, :M * bs] = torch.where(live, vp[table.long()].reshape(
        B, M * bs, KH, D), 0)
    o3, l3 = ops.decode_attention(q, ks[:, :S].contiguous(),
                                  vs[:, :S].contiguous(), lens)
    torch.cuda.synchronize()
    assert torch.equal(o1, o3) and torch.equal(l1, l3)


# Paged sliding-window cases (B, H, KH, D, N, bs, M, window): windows
# that are multiples of neither 32 nor the page size, of one key, of one
# page, longer than some requests, and pages not dividing the 32-key tile.
PAGED_WINDOW_CASES = [
    (7, 32, 4, 64, 240, 16, 32, 37),
    (5, 32, 4, 64, 64, 16, 9, 1),
    (5, 32, 4, 64, 64, 16, 9, 16),
    (3, 32, 8, 128, 40, 16, 8, 100),
    (4, 2, 1, 16, 40, 5, 7, 11),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,KH,D,N,bs,M,window", PAGED_WINDOW_CASES)
def test_paged_decode_attention_kernel_window(cuda, dtype, B, H, KH, D, N,
                                              bs, M, window):
    """With a sliding window: against the plain version, and bit for bit
    against the slotted kernel with the same window on the same logical
    cache (the tiles and their owners depend on (lo, n) only)."""
    g = np.random.default_rng(10)
    q, kp, vp, table, lens = _paged_inputs(g, B, H, KH, D, N, bs, M, dtype,
                                           cuda)
    o1, l1 = ops.paged_decode_attention(q, kp, vp, table, lens,
                                        window=window)
    torch.cuda.synchronize()
    o2, l2 = ref.paged_decode_attention_ref(q, kp, vp, table, lens,
                                            window=window)
    _close(o1, o2, TOL[dtype])
    _close(l1, l2, TOL[dtype])
    ks, vs = (p[table.long()].reshape(B, M * bs, KH, D) for p in (kp, vp))
    o3, l3 = ops.decode_attention(q, ks.contiguous(), vs.contiguous(), lens,
                                  window=window)
    torch.cuda.synchronize()
    assert torch.equal(o1, o3) and torch.equal(l1, l3)


def test_paged_decode_attention_kernel_rejects(cuda):
    g = np.random.default_rng(6)
    q, kp, vp, table, lens = _paged_inputs(g, 2, 4, 2, 16, 8, 4, 2,
                                           torch.float32, cuda)
    with pytest.raises(ValueError, match="negative window"):
        ops.paged_decode_attention(q, kp, vp, table, lens, window=-1)
    with pytest.raises(TypeError):
        ops.paged_decode_attention(q, kp, vp, table.long(), lens)
    with pytest.raises(ValueError):
        ops.paged_decode_attention(q, kp, vp, table[:1], lens)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("E,cap,H,KH,D,C", [
    (3, 8, 4, 2, 32, 64),
    (2, 8, 8, 8, 64, 96),
    (4, 8, 6, 2, 64, 48),
    (2, 40, 16, 2, 64, 100),
    (2, 8, 4, 4, 128, 256),
] + SHARED_SHAPES[6:])
def test_shared_chunk_attention_q8_kernel(cuda, dtype, E, cap, H, KH, D, C):
    """The int8 kernel against its plain version (fp32 dequant + the fp
    reference); output in qd's dtype."""
    from repro_torch.core.shared_kv import _quantize
    g = np.random.default_rng(7)
    qd = _randn(g, (E, cap, H, D), dtype, cuda)
    kq, ks = _quantize(_randn(g, (E, C, KH, D), torch.float32, cuda))
    vq, vs = _quantize(_randn(g, (E, C, KH, D), torch.float32, cuda))
    qm = _qmask(g, E, cap, H, KH, D, C, cuda)
    n0 = ops.shared_chunk_attention_q8.launches
    o1, l1 = ops.shared_chunk_attention_q8(qd, kq, vq, ks, vs, qm)
    torch.cuda.synchronize()
    assert ops.shared_chunk_attention_q8.launches == n0 + 1
    o2, l2 = _by_chunk(ref.shared_chunk_attention_q8_ref, qd, kq, vq, ks, vs,
                       qm)
    _close(o1, o2, TOL[dtype])
    _close(l1, l2, TOL[dtype])
    assert o1.dtype == dtype and l1.dtype == torch.float32
    assert bool((l1[~qm] < -1e29).all()) and bool((o1[~qm] == 0).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("P,N,H,D", [(2, 64, 4, 32), (3, 7, 2, 16),
                                     (4, 128, 8, 64), (8, 64, 32, 64),
                                     # granite's and qwen's 16 heads of
                                     # 64, internvl2's and mistral's
                                     (8, 16, 16, 64), (8, 8, 64, 128),
                                     (8, 8, 96, 128)])
def test_lse_merge_kernel(cuda, dtype, P, N, H, D):
    """The dense entry against its plain version; the pair entry on the
    first two partials equals the dense entry on them stacked, bitwise."""
    g = np.random.default_rng(2)
    outs = _randn(g, (P, N, H, D), dtype, cuda)
    lses = _randn(g, (P, N, H), torch.float32, cuda, scale=3.0)
    lses[:, 0] = -1e30                      # a row no partial attended
    lses[0, 1] = float("-inf")              # a genuine -inf sentinel
    n0 = ops.lse_merge.launches
    o1, l1 = ops.lse_merge(outs, lses)
    torch.cuda.synchronize()
    o2, l2 = ref.lse_merge_ref(outs, lses)
    _close(o1, o2, TOL[dtype])
    _close(l1, l2, 2e-5)
    assert bool((l1[0] == -1e30).all())
    op, lp = ops.lse_merge_pair(outs[0], lses[0], outs[1], lses[1])
    od, ld = ops.lse_merge(outs[:2].contiguous(), lses[:2].contiguous())
    torch.cuda.synchronize()
    assert torch.equal(op, od) and torch.equal(lp, ld)
    assert ops.lse_merge.launches == n0 + 3


# (R, Q, H, D, G, K) of the routed merge: the decode step's (64 groups x
# top-8 over 32 chunks at capacity 32), the routed prefill's (2 groups of
# 128 queries at capacity 8), llama3's D 128, and ragged small shapes
ROUTED_SHAPES = [
    (1024, 1, 32, 64, 64, 8),
    (256, 128, 32, 64, 2, 8),
    (64, 1, 32, 128, 16, 8),
    (10, 3, 2, 16, 4, 3),
    (7, 1, 6, 32, 5, 9),          # K > 8: two batches of partials
    (192, 1, 16, 64, 16, 8),      # granite's and qwen's heads
    (48, 1, 64, 128, 4, 8),       # internvl2's
    (48, 1, 96, 128, 4, 8),       # mistral-large's
    (256, 1, 6, 64, 64, 2),       # whisper's: 64 queries, top-2 of 4 chunks
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("R,Q,H,D,G,K", ROUTED_SHAPES)
def test_lse_merge_routed_kernel(cuda, dtype, R, Q, H, D, G, K):
    """The routed entry equals the gather chain it replaces (gather, fill,
    dense entry) bit for bit, and its plain version within tolerance, with
    every third route dropped and every route of group 1 dropped."""
    g = np.random.default_rng(5)
    od = _randn(g, (R, Q, H, D), dtype, cuda)
    lsed = _randn(g, (R, Q, H), torch.float32, cuda, scale=3.0)
    lin = np.stack([g.integers(0, R, K) for _ in range(G)]).astype(np.int64)
    lin.reshape(-1)[::3] = R                # the trash row: dropped
    lin[1] = R
    lin = torch.from_numpy(lin).to(cuda)
    o1, l1 = ops.lse_merge_routed(od, lsed, lin)
    o2, l2 = ops.lse_merge(*ref.routed_partials(od, lsed, lin))
    torch.cuda.synchronize()
    assert torch.equal(o1, o2) and torch.equal(l1, l2)
    o3, l3 = ref.lse_merge_routed_ref(od, lsed, lin)
    _close(o1, o3, TOL[dtype])
    _close(l1, l3, 2e-5)
    assert bool((l1.view(G, Q * H)[1] == -1e30).all())
    assert bool((o1.view(G, Q * H, D)[1] == 0).all())


# router shapes: small sweeps; the decode step's (64 slots, tinyllama), a
# corpus-scale E, G = 1, KH = H, every head_dim; shapes named in
# ROUTER_OFFSET take q and emb one element past a 16-byte boundary (the
# kernel's scalar load path)
ROUTER_SHAPES = [
    (8, 8, 2, 32, 16), (5, 4, 4, 16, 7), (128, 8, 8, 64, 512),
    (64, 32, 4, 64, 32),
    (64, 32, 4, 64, 8192),      # corpus scale: a loop over E in each block
    (1, 32, 4, 64, 32),         # G = 1
    (6, 8, 8, 32, 40),          # KH = H
    (16, 8, 2, 16, 24), (16, 32, 8, 128, 64),
    (7, 8, 2, 16, 9),           # misaligned: scalar loads
    (16, 16, 8, 64, 16),        # granite, G = 2
    (16, 16, 16, 64, 16),       # qwen, G = 1
    (8, 64, 8, 128, 8),         # internvl2, G = 8, D = 128
    (8, 96, 8, 128, 8),         # mistral-large, G = 12, D = 128
    (64, 6, 6, 64, 4),          # whisper-tiny, E = 4
]
ROUTER_OFFSET = {(7, 8, 2, 16, 9)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("G,H,KH,D,E", ROUTER_SHAPES)
def test_router_scores_kernel(cuda, dtype, G, H, KH, D, E):
    g = np.random.default_rng(3)
    q = _randn(g, (G, H, D), dtype, cuda)
    emb = _randn(g, (E, KH, D), dtype, cuda)
    if (G, H, KH, D, E) in ROUTER_OFFSET:
        q = torch.cat([q.new_zeros(1), q.reshape(-1)])[1:].view(G, H, D)
        emb = torch.cat([emb.new_zeros(1), emb.reshape(-1)])[1:].view(E, KH, D)
        assert q.data_ptr() % 16 and emb.data_ptr() % 16
    n0 = ops.router_scores.launches
    s1 = ops.router_scores(q, emb)
    torch.cuda.synchronize()
    _close(s1, ref.router_scores_ref(q, emb), 2e-5)
    assert ops.router_scores.launches == n0 + 1


def test_dense_decode_step_card_matches_cpu(cuda):
    """Prefill + one MoSKA decode step of a reduced fp32 model with G = 4:
    the card (kernels) and the CPU (plain versions) give the same logits."""
    base = get_config("llama3-8b").reduced()
    cfg = dataclasses.replace(base, dtype="float32", num_kv_heads=1,
                              moska=dataclasses.replace(base.moska,
                                                        top_k_chunks=3))
    params = dense.init_params(cfg, torch.Generator().manual_seed(0))
    g = np.random.default_rng(4)
    corpus = torch.from_numpy(g.integers(0, cfg.vocab_size, (1, 384)))
    prompts = torch.from_numpy(g.integers(0, cfg.vocab_size, (3, 20)))

    def run(device):
        p = copy.deepcopy(params).to(device)

        def cache(batch, max_seq):
            return init_kv_cache(cfg.num_layers, batch, max_seq,
                                 cfg.num_kv_heads, cfg.head_dim,
                                 torch.float32, device)

        cc = cache(1, 384)
        dense.prefill(cfg, p, corpus.to(device), cc)
        store = build_store(cc.k[:, 0], cc.v[:, 0], cfg.moska.chunk_size)
        c = cache(3, 32)
        lg, _ = dense.prefill(cfg, p, prompts.to(device), c, store=store,
                              start_pos=384)
        lg2, _ = dense.decode_step(cfg, p, lg.argmax(-1), c, store=store)
        return lg.cpu(), lg2.cpu()

    n0 = ops.launch_counts()
    on_card = run(cuda)
    path = ("shared_chunk_attention", "decode_attention", "lse_merge",
            "router_scores")
    assert all(ops.launch_counts()[k] > n0[k] for k in path)
    on_cpu = run(torch.device("cpu"))
    for a, b in zip(on_card, on_cpu):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "arctic-480b"])
def test_moe_decode_step_card_matches_cpu(cuda, arch):
    """A reduced fp32 MoE model with granite's G = 2 (Arctic: its dense
    residual beside the experts): prefill and two MoSKA decode steps on
    the card (kernels, the expert dispatch on the card) and on the CPU
    (plain versions) give the same logits and greedy tokens."""
    base = get_config(arch).reduced()
    cfg = dataclasses.replace(base, dtype="float32", num_kv_heads=2)
    params = dense.init_params(cfg, torch.Generator().manual_seed(1))
    g = np.random.default_rng(6)
    corpus = torch.from_numpy(g.integers(0, cfg.vocab_size, (1, 256)))
    prompts = torch.from_numpy(g.integers(0, cfg.vocab_size, (4, 24)))

    def run(device):
        p = copy.deepcopy(params).to(device)

        def cache(batch, max_seq):
            return init_kv_cache(cfg.num_layers, batch, max_seq,
                                 cfg.num_kv_heads, cfg.head_dim,
                                 torch.float32, device)

        cc = cache(1, 256)
        dense.prefill(cfg, p, corpus.to(device), cc)
        store = build_store(cc.k[:, 0], cc.v[:, 0], cfg.moska.chunk_size)
        c = cache(4, 32)
        out = [dense.prefill(cfg, p, prompts.to(device), c, store=store,
                             start_pos=256)[0]]
        for _ in range(2):
            out.append(dense.decode_step(cfg, p, out[-1].argmax(-1), c,
                                         store=store)[0])
        return [x.cpu() for x in out]

    on_card = run(cuda)
    on_cpu = run(torch.device("cpu"))
    for a, b in zip(on_card, on_cpu):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)
        assert torch.equal(a.argmax(-1), b.argmax(-1))


def test_paged_decode_step_and_int8_store_card_match_cpu(cuda):
    """A paged decode step (pages in scrambled order) and a slotted step
    over an int8 store, of a reduced fp32 model with G = 4: the card
    (kernels) and the CPU (plain versions) give the same logits, and the
    paged step's logits on the card equal the slotted step's. Both sides
    get the int8 values quantized on the card: quantizing each side's own
    corpus prefill (which differ by 1e-6) can move values by a whole
    quantization step."""
    from repro_torch.kvcache.paged import PagedKVCache
    base = get_config("llama3-8b").reduced()
    cfg = dataclasses.replace(base, dtype="float32", num_kv_heads=1,
                              moska=dataclasses.replace(base.moska,
                                                        top_k_chunks=3))
    params = dense.init_params(cfg, torch.Generator().manual_seed(0))
    g = np.random.default_rng(8)
    corpus = torch.from_numpy(g.integers(0, cfg.vocab_size, (1, 384)))
    prompts = torch.from_numpy(g.integers(0, cfg.vocab_size, (3, 20)))
    B, bs, M = 3, 8, 4
    table = (g.permutation(B * M + 4)[:B * M] + 1).reshape(B, M)

    q8_card = []

    def run(device):
        p = copy.deepcopy(params).to(device)
        L_, KH, D = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim

        def cache(batch, max_seq):
            return init_kv_cache(L_, batch, max_seq, KH, D, torch.float32,
                                 device)

        cc = cache(1, 384)
        dense.prefill(cfg, p, corpus.to(device), cc)
        store = build_store(cc.k[:, 0], cc.v[:, 0], cfg.moska.chunk_size)
        if not q8_card:
            q8_card.append(build_store(cc.k[:, 0], cc.v[:, 0],
                                       cfg.moska.chunk_size, quantize=True))
        q8 = type(store)(*(t.to(device) if t is not None else None
                           for t in q8_card[0]))
        c = cache(B, bs * M)
        lg, _ = dense.prefill(cfg, p, prompts.to(device), c, store=store,
                              start_pos=384)
        nxt = lg.argmax(-1)
        pool = PagedKVCache(torch.zeros((L_, B * M + 5, bs, KH, D),
                                        device=device),
                            torch.zeros((L_, B * M + 5, bs, KH, D),
                                        device=device))
        tbl = torch.from_numpy(table.astype(np.int32)).to(device)
        for t_pool, t_cache in ((pool.k, c.k), (pool.v, c.v)):
            t_pool[:, tbl.long()] = t_cache.reshape(L_, B, M, bs, KH, D)
        lens = torch.full((B,), 20, dtype=torch.int32, device=device)
        offs = torch.full((B,), 384, dtype=torch.int32, device=device)
        lp, _ = dense.decode_step_paged(cfg, p, nxt, pool, tbl, lens, offs,
                                        store=store)
        c8 = KVCache(*(t.clone() for t in c))
        lq, _ = dense.decode_step(cfg, p, nxt, c8, store=q8)
        ls, _ = dense.decode_step(cfg, p, nxt, c, store=store)
        assert torch.equal(lp, ls)
        return lp.cpu(), lq.cpu()

    n0 = ops.launch_counts()
    on_card = run(cuda)
    n1 = ops.launch_counts()
    assert n1["paged_decode_attention"] == n0["paged_decode_attention"] + \
        cfg.num_layers
    assert n1["shared_chunk_attention_q8"] == \
        n0["shared_chunk_attention_q8"] + cfg.num_layers
    on_cpu = run(torch.device("cpu"))
    for a, b in zip(on_card, on_cpu):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


def test_host_tier_round_trip_on_card(cuda):
    """Pages offloaded into pinned host memory (a non_blocking copy fenced
    by an event), brought back by a side-stream prefetch and swapped in,
    equal a synchronous swap-in of the same entry bit for bit, and the
    source pages as they were at the offload, although the source pages
    are overwritten on the stream right after it."""
    from repro_torch.kvcache import paged as tpg
    from repro_torch.kvcache.transfer import PrefetchEngine
    g = np.random.default_rng(11)
    L_, N, bs, KH, D = 3, 24, 16, 4, 64
    pool = tpg.PagedKVCache(*(_randn(g, (L_, N, bs, KH, D), torch.bfloat16,
                                     cuda) for _ in range(2)))
    src, dst = [5, 2, 17, 9], [20, 1, 11, 6]
    want = [t[:, src].clone() for t in pool]
    host = tpg.HostBlockPool(8)
    host.offload("key", *tpg.extract_blocks(pool, src), first=7,
                 gens=[(b, 1) for b in src])
    for t in pool:
        t[:, src] = 0                   # queued after the offload's copy
    entry = host.peek("key")
    assert entry["k"].is_pinned() and entry["ready"] is not None
    pf = PrefetchEngine(host, 2, cuda)
    assert pf.issue("key")
    tr = pf.take("key")
    synced = tpg.PagedKVCache(*(t.clone() for t in pool))
    tpg.insert_blocks(pool, dst, tr["k"], tr["v"])
    torch.cuda.current_stream().wait_event(entry["ready"])
    tpg.insert_blocks(synced, dst, entry["k"], entry["v"])
    torch.cuda.synchronize()
    for a, b, w in zip(pool, synced, want):
        assert torch.equal(a, b)
        assert torch.equal(a[:, dst], w)
    pf.check_invariants()
    host.check_invariants()
    assert pf.resolved == pf.issued == 1


def test_host_tier_engine_on_card(cuda):
    """A reduced bf16 model served on the card over a 256-token corpus,
    on a 3-usable-page pool, two passes of 6 short prompts: with a host
    tier (async defaults, and all async off) pass 2 swaps every prefix
    back and prefills nothing; without it every prefix is rebuilt. The
    three engines generate the same tokens, through the paged decode
    kernel."""
    from repro_torch import obs
    from repro_torch.data.pipeline import CorpusSpec, synthesize_corpus
    from repro_torch.models.model import build_model
    from repro_torch.serving.engine import EngineConfig, ServingEngine
    cfg = get_config("tinyllama-1.1b").reduced()
    params = build_model(cfg).init(torch.Generator(device=cuda).manual_seed(0),
                                   cuda)
    corpus = synthesize_corpus(CorpusSpec("c", 256, cfg.vocab_size))
    prompts = [[20 + i] * 8 for i in range(6)]
    sync = dict(prefetch_depth=0, spec_append=False, overlap_waves=False)

    def serve(**kw):
        reg = obs.MetricsRegistry()
        prev = obs.set_registry(reg)
        try:
            eng = ServingEngine(cfg, params, EngineConfig(
                max_slots=2, max_seq=64, kv_layout="paged", block_size=16,
                num_blocks=4, cache_dtype=torch.bfloat16, **kw))
            eng.register_corpus("c", corpus)
            gens = {}
            for i in range(2):
                for p in prompts:
                    eng.submit(p, max_new_tokens=4, corpus_id="c")
                for r in eng.run():
                    gens[(i, tuple(r.prompt))] = tuple(r.generated)
                eng.scheduler.finished.clear()
            torch.cuda.synchronize()
        finally:
            obs.set_registry(prev)
        return gens, {n: int(reg.counter(n).value) for n in (
            "engine/prefill_tokens", "kvcache/swap_in_hits",
            "kvcache/prefetch_hits")}

    n0 = ops.paged_decode_attention.launches
    on, c_on = serve(host_pool_blocks=16)
    off, c_off = serve(host_pool_blocks=0)
    on_sync, c_sync = serve(host_pool_blocks=16, **sync)
    assert on == off == on_sync and len(on) == 12
    assert c_on["kvcache/swap_in_hits"] == c_sync["kvcache/swap_in_hits"] == 6
    assert c_on["engine/prefill_tokens"] == 48
    assert c_off["engine/prefill_tokens"] == 96
    assert c_on["kvcache/prefetch_hits"] >= 1
    assert ops.paged_decode_attention.launches > n0



def _family_steps(cfg, params, device, B, S, steps, frames=None,
                  store_chunk=None):
    """Prefill B prompts of S tokens (behind ``frames`` for the enc-dec
    model) and ``steps`` greedy decode steps on ``device``; with
    ``store_chunk`` the decode routes the cross-attention over a store of
    the first request's cross K/V. Returns every step's logits on the
    CPU."""
    model = build_model(cfg)
    p = copy.deepcopy(params).to(device)
    g = np.random.default_rng(9)
    toks = torch.from_numpy(g.integers(0, cfg.vocab_size, (B, S)))
    cache = model.init_cache(B, S + steps, torch.float32, device)
    kw = {} if frames is None else {"frontend_embeds": frames.to(device)}
    out = [model.prefill(p, toks.to(device), cache, **kw)[0]]
    store = None
    if store_chunk is not None:
        store = build_store(cache["cross_k"][:, 0], cache["cross_v"][:, 0],
                            store_chunk)
    for _ in range(steps):
        out.append(model.decode_step(p, out[-1].argmax(-1), cache,
                                     store=store)[0])
    return [x.cpu() for x in out]


@pytest.mark.parametrize("arch", ["mamba2-130m", "recurrentgemma-9b",
                                  "whisper-tiny"])
def test_family_steps_card_match_cpu(cuda, arch):
    """A reduced fp32 model of each family: a prefill (the hybrid's past
    its 64-key window) and three decode steps on the card and on the CPU
    give the same logits and greedy tokens. whisper-tiny routes its
    cross-attention over 4 chunks of its 256 frames on the card through
    ``router_scores``, ``shared_chunk_attention``, the routed
    ``lse_merge`` and ``decode_attention``; SSM and hybrid run no kernel."""
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
    frames = chunk = None
    if arch == "whisper-tiny":
        cfg = dataclasses.replace(cfg, encoder=dataclasses.replace(
            cfg.encoder, frontend_seq=256))
        g = np.random.default_rng(10)
        frames = torch.from_numpy(np.broadcast_to(
            g.standard_normal((1, 256, cfg.d_model)),
            (6, 256, cfg.d_model)).astype(np.float32).copy())
        chunk = cfg.moska.chunk_size
    params = build_model(cfg).init(torch.Generator().manual_seed(2))
    S = 80 if arch == "recurrentgemma-9b" else 20
    n0 = ops.launch_counts()
    on_card = _family_steps(cfg, params, cuda, 6, S, 3, frames, chunk)
    n1 = ops.launch_counts()
    L_ = cfg.num_layers
    want = {k: 0 for k in n0}
    if arch == "whisper-tiny":
        want.update(decode_attention=3 * L_, router_scores=3 * L_,
                    shared_chunk_attention=3 * L_, lse_merge=3 * L_)
    assert {k: n1[k] - n0[k] for k in n0} == want
    on_cpu = _family_steps(cfg, params, torch.device("cpu"), 6, S, 3,
                           frames, chunk)
    for a, b in zip(on_card, on_cpu):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)
        assert torch.equal(a.argmax(-1), b.argmax(-1))


def test_train_step_card_matches_cpu(cuda):
    """tinyllama-1.1b at full width, 2 layers, fp32, TF32 off: the loss and
    every gradient leaf of one training step on the card equal the CPU's
    within the CPU parity tests' tolerances (the loss within 2e-5, each
    leaf within 1e-4 of its largest magnitude); and an AdamW update of the
    card's parameters by the CPU's gradients equals the CPU's update
    within 2e-6."""
    from repro_torch.data.pipeline import make_train_batches
    from repro_torch.training import optimizer as opt
    from repro_torch.training import train_loop as tl
    assert not torch.backends.cuda.matmul.allow_tf32
    cfg = dataclasses.replace(get_config("tinyllama-1.1b"), num_layers=2,
                              dtype="float32")
    model = build_model(cfg)
    cpu = torch.device("cpu")
    batch = next(make_train_batches(cfg, 2, 64, seed=4))
    runs = {}
    for dev in (cuda, cpu):
        params = model.init(torch.Generator().manual_seed(3)).to(dev)
        with tl.trainable(params):
            loss, _ = model.train_loss(params, tl.to_device(batch, dev))
            loss.backward()
            grads = {n: p.grad.detach().clone()
                     for n, p in params.named_parameters()}
        runs[dev.type] = (params, loss.item(), grads)
    (pc, lc, gc), (pp, lp, gp) = runs["cuda"], runs["cpu"]
    assert abs(lc - lp) <= 2e-5
    for n, g in gp.items():
        tol = 1e-4 * float(g.abs().max())
        torch.testing.assert_close(gc[n].cpu(), g, rtol=0, atol=tol)
    sc, sp = opt.adamw_init(pc), opt.adamw_init(pp)
    opt.adamw_update({n: g.to(cuda) for n, g in gp.items()}, sc, pc,
                     lr=1e-3)
    opt.adamw_update(gp, sp, pp, lr=1e-3)
    for (n, a), (_, b) in zip(pc.named_parameters(), pp.named_parameters()):
        torch.testing.assert_close(a.detach().cpu(), b.detach(), rtol=2e-6,
                                   atol=2e-6)


def test_checkpoint_round_trip_on_card(cuda, tmp_path):
    """bf16 parameters and fp32 moments on the card, saved and restored
    into fresh templates on the card: equal bit for bit."""
    from repro_torch.training import checkpoint as ck
    from repro_torch.training import optimizer as opt
    cfg = get_config("granite-moe-1b-a400m").reduced()
    model = build_model(cfg)
    params = model.init(torch.Generator(cuda).manual_seed(0), cuda)
    grads = {n: torch.randn(p.shape, device=cuda).to(p.dtype)
             for n, p in params.named_parameters()}
    params, state = opt.adamw_update(grads, opt.adamw_init(params), params,
                                     lr=1e-3)
    path = ck.save_checkpoint(str(tmp_path), 1, params, state)
    tmpl = model.init(torch.Generator(cuda).manual_seed(1), cuda)
    step, p2, s2 = ck.restore_checkpoint(path, tmpl, opt.adamw_init(tmpl))
    assert step == 1 and s2.step == 1
    for (n, a), (_, b) in zip(params.state_dict().items(),
                              p2.state_dict().items()):
        assert b.is_cuda and torch.equal(a, b), n
    for n, m in state.mu.items():
        assert torch.equal(s2.mu[n], m) and torch.equal(s2.nu[n],
                                                        state.nu[n]), n
