"""The port's plain kernel versions (``repro_torch.kernels.ref``, what the
wrappers in ``repro_torch.kernels.ops`` run for CPU tensors) against the
reference package's jnp oracles and its Pallas kernels in interpret mode,
over the shape sweeps of ``tests/test_kernels.py``. fp32 within 2e-5, bf16
within 2e-2. CPU calls never count as kernel launches."""
import ast
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from torch_parity import assert_close, both, randn

DTYPES = ["float32", "bfloat16"]
ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def no_launches():
    before = tops.launch_counts()
    yield
    assert tops.launch_counts() == before


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("E,cap,H,KH,D,C,blk", [
    (3, 8, 4, 2, 32, 64, 16),
    (2, 16, 8, 8, 64, 128, 128),
    (1, 4, 2, 1, 16, 32, 32),
    (4, 8, 6, 2, 64, 48, 16),     # ragged C vs blk
    (2, 8, 4, 4, 128, 256, 512),  # blk > C
])
def test_shared_chunk_attention(dtype, E, cap, H, KH, D, C, blk):
    qj, qt = both(randn(1, (E, cap, H, D)), dtype)
    kj, kt = both(randn(2, (E, C, KH, D)), dtype)
    vj, vt = both(randn(3, (E, C, KH, D)), dtype)
    mj, mt = both(np.random.default_rng(4).random((E, cap)) < 0.7)
    o1, l1 = tops.shared_chunk_attention(qt, kt, vt, mt)
    assert o1.dtype == qt.dtype
    for o2, l2 in (jref.shared_chunk_attention_ref(qj, kj, vj, mj),
                   jops.shared_chunk_attention(qj, kj, vj, mj, block_c=blk)):
        assert_close(o1, o2, dtype)
        assert_close(l1, l2, dtype)
    assert np.all(l1.numpy()[~mt.numpy()] < -1e29)
    assert np.all(o1.float().numpy()[~mt.numpy()] == 0.0)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,H,KH,D,S,blk", [
    (4, 8, 2, 32, 100, 32),
    (2, 4, 4, 64, 256, 256),
    (3, 2, 1, 16, 33, 16),
    (1, 16, 8, 128, 512, 128),
])
def test_decode_attention(dtype, B, H, KH, D, S, blk):
    qj, qt = both(randn(5, (B, H, D)), dtype)
    kj, kt = both(randn(6, (B, S, KH, D)), dtype)
    vj, vt = both(randn(7, (B, S, KH, D)), dtype)
    lj, lt = both(np.random.default_rng(8).integers(1, S + 1, B)
                  .astype(np.int32))
    o1, l1 = tops.decode_attention(qt, kt, vt, lt)
    for o2, l2 in (jref.decode_attention_ref(qj, kj, vj, lj),
                   jops.decode_attention(qj, kj, vj, lj, block_s=blk)):
        assert_close(o1, o2, dtype)
        assert_close(l1, l2, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,H,KH,D,N,bs,M", [
    (3, 8, 2, 32, 16, 16, 4),
    (2, 4, 4, 64, 9, 32, 3),
    (1, 16, 8, 128, 32, 8, 8),
])
def test_paged_decode_attention(dtype, B, H, KH, D, N, bs, M):
    """The plain paged version against the reference's Pallas kernel
    (interpret mode) and its gather oracle, over distinct scrambled pages;
    and bitwise against the plain slotted version on the same logical
    cache (zeros past each length there, the pool's garbage here)."""
    from repro.kernels.paged_decode_attn import paged_decode_attention_ref
    qj, qt = both(randn(20, (B, H, D)), dtype)
    kj, kt = both(randn(21, (N, bs, KH, D)), dtype)
    vj, vt = both(randn(22, (N, bs, KH, D)), dtype)
    g = np.random.default_rng(23)
    table = (g.permutation(N - 1)[:B * M] + 1).reshape(B, M).astype(np.int32)
    lens = g.integers(1, M * bs + 1, B).astype(np.int32)
    lens[0] = M * bs                      # one full table
    tj, tt = both(table)
    lj, lt = both(lens)
    o1, l1 = tops.paged_decode_attention(qt, kt, vt, tt, lt)
    assert o1.dtype == qt.dtype
    for o2, l2 in (jops.paged_decode_attention(qj, kj, vj, tj, lj),
                   paged_decode_attention_ref(qj, kj, vj, tj, lj)):
        assert_close(o1, o2, dtype)
        assert_close(l1, l2, dtype)
    live = torch.arange(M * bs)[None, :, None, None] < lt[:, None, None, None]
    ks = torch.where(live, kt[tt.long()].reshape(B, M * bs, KH, D), 0)
    vs = torch.where(live, vt[tt.long()].reshape(B, M * bs, KH, D), 0)
    o3, l3 = tops.decode_attention(qt, ks.contiguous(), vs.contiguous(), lt)
    assert torch.equal(o1, o3) and torch.equal(l1, l3)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("E,cap,H,KH,D,C,blk", [
    (3, 8, 4, 2, 32, 64, 16), (2, 8, 8, 8, 64, 96, 64),
])
def test_shared_chunk_attention_q8(dtype, E, cap, H, KH, D, C, blk):
    """The plain int8 version against the reference's Pallas q8 kernel
    (interpret mode), on the same int8 values and scales. The reference
    kernel always writes bf16 (the port writes qd's dtype), so the output
    is held to 2e-2; the fp32 lse to 2e-5. With fp32 queries the plain
    version also equals the fp reference on the fp32 dequantized store."""
    from repro.core.shared_kv import _quantize
    from repro.kernels.shared_chunk_attn import shared_chunk_attention_q8
    qj, qt = both(randn(24, (E, cap, H, D)), dtype)
    kq, ks = _quantize(jnp.asarray(randn(25, (E, C, KH, D))))
    vq, vs = _quantize(jnp.asarray(randn(26, (E, C, KH, D))))
    (kqj, kqt), (vqj, vqt) = both(np.array(kq)), both(np.array(vq))
    (ksj, kst), (vsj, vst) = both(np.array(ks)), both(np.array(vs))
    mj, mt = both(np.random.default_rng(27).random((E, cap)) < 0.7)
    o1, l1 = tops.shared_chunk_attention_q8(qt, kqt, vqt, kst, vst, mt)
    assert o1.dtype == qt.dtype and kqt.dtype == torch.int8
    o2, l2 = shared_chunk_attention_q8(qj, kqj, vqj, ksj, vsj, mj,
                                       block_c=blk)
    assert_close(o1, o2, tol=2e-2)
    assert_close(l1, l2, tol=2e-5)
    assert np.all(l1.numpy()[~mt.numpy()] < -1e29)
    if dtype == "float32":
        kd = kqt.float() * kst[..., None]
        vd = vqt.float() * vst[..., None]
        o3, l3 = tops.shared_chunk_attention(qt, kd, vd, mt)
        assert torch.equal(o1, o3) and torch.equal(l1, l3)


def _mma_numerics(qd, k, v, qmask, k_scale=None, v_scale=None):
    """What the bf16 tensor-core kernel (csrc/mma_tile.cuh) computes, in
    plain torch: 64-key tiles; exact products of bf16 (or int8) values
    summed in fp32; scores scaled by log2(e)/sqrt(D) (and k_scale) in fp32;
    online softmax in log2 units with exp2; the denominator sums the fp32
    p; only P (times v_scale) is rounded to bf16 for P V; lse = m ln 2 +
    ln l. Returns (out in bf16, lse fp32) like the kernel."""
    E, cap, H, D = qd.shape
    C, KH = k.shape[1], k.shape[2]
    G = H // KH
    q = qd.float().reshape(E, cap, KH, G, D)
    scale_log2 = np.float32(np.log2(np.e) / np.sqrt(D))
    m = torch.full((E, cap, KH, G), -1e30)
    l = torch.zeros((E, cap, KH, G))
    o = torch.zeros((E, cap, KH, G, D))
    for t0 in range(0, C, 64):
        kt, vt = k[:, t0:t0 + 64].float(), v[:, t0:t0 + 64].float()
        x = torch.einsum("eckgd,eskd->eckgs", q, kt) * scale_log2
        if k_scale is not None:
            x = x * k_scale[:, t0:t0 + 64].permute(0, 2, 1)[:, None, :, None]
        m_new = torch.maximum(m, x.amax(-1))
        corr = torch.exp2(m - m_new)
        p = torch.exp2(x - m_new[..., None])
        l = l * corr + p.sum(-1)
        if v_scale is not None:
            p = p * v_scale[:, t0:t0 + 64].permute(0, 2, 1)[:, None, :, None]
        p = p.to(torch.bfloat16).float()
        o = o * corr[..., None] + torch.einsum("eckgs,eskd->eckgd", p, vt)
        m = m_new
    valid = qmask[:, :, None, None]
    out = torch.where(valid[..., None], o / l[..., None], 0.0)
    lse = torch.where(valid, m * np.float32(np.log(2)) + torch.log(l), -1e30)
    return (out.reshape(E, cap, H, D).to(torch.bfloat16),
            lse.reshape(E, cap, H))


@pytest.mark.parametrize("store", ["bf16", "int8"])
@pytest.mark.parametrize("E,cap,H,KH,D,C", [
    (3, 8, 16, 2, 64, 2048),      # the path's widths: C 2,048, D 64, G 8
    (3, 5, 6, 2, 32, 100),        # ragged: C not a multiple of 64, G 3
])
def test_shared_chunk_mma_rounding(store, E, cap, H, KH, D, C):
    """The tensor-core kernel's rounding scheme (bf16 P for P V; for the
    int8 store the scales folded into the score columns and into P),
    emulated on the CPU, stays within 2e-2 of the plain fp32 versions that
    the kernel is held to on the card."""
    from repro_torch.core.shared_kv import _quantize
    qd = torch.from_numpy(randn(30, (E, cap, H, D))).to(torch.bfloat16)
    qmask = torch.from_numpy(np.random.default_rng(31).random((E, cap)) < 0.7)
    kf = torch.from_numpy(randn(32, (E, C, KH, D)))
    vf = torch.from_numpy(randn(33, (E, C, KH, D)))
    if store == "bf16":
        k, v = kf.to(torch.bfloat16), vf.to(torch.bfloat16)
        got = _mma_numerics(qd, k, v, qmask)
        want = tref.shared_chunk_attention_ref(qd, k, v, qmask)
    else:
        (k, ks), (v, vs) = _quantize(kf), _quantize(vf)
        got = _mma_numerics(qd, k, v, qmask, ks, vs)
        want = tref.shared_chunk_attention_q8_ref(qd, k, v, ks, vs, qmask)
    for a, b in zip(got, want):
        assert_close(a, b, tol=2e-2)
    assert np.all(got[1].numpy()[~qmask.numpy()] < -1e29)
    assert np.all(got[0].float().numpy()[~qmask.numpy()] == 0.0)


def _split_decode_numerics(q, load, lens, warps=4, tile=32):
    """What the split-KV decode kernels (csrc/decode_tile.cuh) compute, in
    plain torch: [0, n) cut into 32-key tiles, tile t to warp t % 4; each
    warp an online softmax in fp32 over its tiles (keys past n score
    -1e30 and have zero V); the 4 partials merged warp 0 first. With bf16
    inputs P is rounded to bf16 for P V, as the tensor-core body does (the
    denominator sums the fp32 p). K/V come through ``load(b, pos)``,
    (len(pos), KH, D) rows of request b, as the kernels' loaders give
    them. Returns (out in q's dtype, lse fp32)."""
    B, H, D = q.shape
    outs, lses = [], []
    for b in range(B):
        n = int(lens[b])
        parts = []
        for w in range(warps):
            m = l = o = None
            for t0 in range(w * tile, n, warps * tile):
                pos = torch.arange(t0, t0 + tile)
                k, v = (x.float() * (pos < n)[:, None, None]
                        for x in load(b, pos.clamp(max=n - 1)))
                KH = k.shape[1]
                qg = q[b].float().reshape(KH, H // KH, D)
                s = torch.einsum("kgd,tkd->kgt", qg, k) / np.sqrt(D)
                s = torch.where(pos < n, s, torch.tensor(-1e30))
                if m is None:
                    m = torch.full(s.shape[:2], -1e30)
                    l = torch.zeros(s.shape[:2])
                    o = torch.zeros(s.shape[:2] + (D,))
                m_new = torch.maximum(m, s.amax(-1))
                c = torch.exp(m - m_new)
                p = torch.exp(s - m_new[..., None])
                l = l * c + p.sum(-1)
                if q.dtype == torch.bfloat16:
                    p = p.to(torch.bfloat16).float()      # for P V only
                o = o * c[..., None] + torch.einsum("kgt,tkd->kgd", p, v)
                m = m_new
            if m is not None:
                parts.append((m, l, o))
        mx = torch.stack([p[0] for p in parts]).amax(0)
        den = torch.zeros_like(mx)
        num = torch.zeros_like(parts[0][2])
        for m, l, o in parts:                   # warp 0 first
            den = den + l * torch.exp(m - mx)
            num = num + o * torch.exp(m - mx)[..., None]
        outs.append((num / den.clamp_min(1e-37)[..., None]).reshape(H, D))
        lses.append((mx + torch.log(den.clamp_min(1e-37))).reshape(H))
    return torch.stack(outs).to(q.dtype), torch.stack(lses)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("H,KH,D,lens,slab", [
    (32, 4, 64, [257, 271, 288], 288),      # the path's widths: G 8, D 64
    (16, 2, 64, [1, 63, 65, 100], 100),     # ragged against the tiles
])
def test_decode_split_partition(dtype, H, KH, D, lens, slab):
    """The split-KV decode kernels' partition and merge, emulated on the
    CPU: within tolerance of the reference's Pallas decode kernels
    (interpret mode), slotted and paged, and bit for bit the same whether
    the K/V sit in a 512-token slab, a slab as long as the longest
    request, or scrambled pages of 16 tokens of the same logical cache."""
    B, bs = len(lens), 16
    M = -(-slab // bs)
    qj, qt = both(randn(40, (B, H, D)), dtype)
    k512 = randn(41, (B, 512, KH, D))
    v512 = randn(42, (B, 512, KH, D))
    live = np.arange(512)[None, :, None, None] < np.array(lens)[:, None,
                                                                 None, None]
    k512, v512 = k512 * live, v512 * live     # zeros past each length
    table = (np.random.default_rng(43).permutation(B * M) + 1).reshape(
        B, M).astype(np.int32)
    kp = np.zeros((B * M + 1, bs, KH, D), np.float32)
    vp = np.zeros_like(kp)
    kp[table] = k512[:, :M * bs].reshape(B, M, bs, KH, D)
    vp[table] = v512[:, :M * bs].reshape(B, M, bs, KH, D)
    (kj, kt), (vj, vt) = both(k512, dtype), both(v512, dtype)
    (kpj, kpt), (vpj, vpt) = both(kp, dtype), both(vp, dtype)
    (lj, _), (tj, tt) = both(np.array(lens, np.int32)), both(table)
    ks, vs = kt[:, :slab].contiguous(), vt[:, :slab].contiguous()
    layouts = {
        "slab 512": lambda b, pos: (kt[b, pos], vt[b, pos]),
        f"slab {slab}": lambda b, pos: (ks[b, pos], vs[b, pos]),
        "pages": lambda b, pos: (kpt[tt[b, pos // bs].long(), pos % bs],
                                 vpt[tt[b, pos // bs].long(), pos % bs]),
    }
    got = {name: _split_decode_numerics(qt, load, lens)
           for name, load in layouts.items()}
    first = got["slab 512"]
    for o, l in got.values():
        assert torch.equal(o, first[0]) and torch.equal(l, first[1])
    for o2, l2 in (jops.decode_attention(qj, kj, vj, lj, block_s=128),
                   jops.paged_decode_attention(qj, kpj, vpj, tj, lj)):
        assert_close(first[0], o2, dtype)
        assert_close(first[1], l2, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("P,N,H,D,blk", [
    (2, 64, 4, 32, 16), (3, 7, 2, 16, 8), (4, 128, 8, 64, 128),
])
def test_lse_merge(dtype, P, N, H, D, blk):
    oj, ot = both(randn(9, (P, N, H, D)), dtype)
    lse = randn(10, (P, N, H), 3.0)
    lse[:, 0] = -1e30                 # a row no partial attended
    lse[0, 1] = -np.inf               # a genuine -inf sentinel
    lj, lt = both(lse)
    o1, l1 = tops.lse_merge(ot, lt)
    assert o1.dtype == ot.dtype
    o2, l2 = jops.lse_merge(oj, lj, block_n=blk)
    assert_close(o1, o2, dtype)
    assert_close(l1, l2)
    assert np.all(l1.numpy()[0] == -1e30)
    # the reference's jnp oracle agrees wherever it has no -inf input
    o3, l3 = jref.lse_merge_ref(oj[:, 2:], lj[:, 2:])
    assert_close(o1[2:], o3, dtype)
    assert_close(l1[2:], l3)


@pytest.mark.parametrize("G,H,KH,D,E", [
    (8, 8, 2, 32, 16), (5, 4, 4, 16, 7), (128, 8, 8, 64, 512),
])
def test_router_scores(G, H, KH, D, E):
    qj, qt = both(randn(11, (G, H, D)))
    ej, et = both(randn(12, (E, KH, D)))
    s1 = tops.router_scores(qt, et)
    assert_close(s1, jref.router_scores_ref(qj, ej))
    assert_close(s1, jops.router_scores(qj, ej))


def _router_fold_dot(q, emb, warps=4):
    """The router kernel's arithmetic in fp32 (csrc/router_score.cu): the
    gq query heads of each kv head summed in head order into qbar; then
    warp w of ``warps`` sums every ``warps``-th 4-feature granule from w
    into four accumulators, one per feature of the granule; a lane adds
    its four as (a0 + a1) + (a2 + a3), and the warps' partials are added
    in warp order; times 1 / sqrt(D) in fp32. Products and sums are
    rounded apart here (the kernel fuses them), which moves the result by
    a few fp32 ulps."""
    G, H, D = q.shape
    E, KH, _ = emb.shape
    qh = q.float().reshape(G, KH, H // KH, D)
    qbar = qh[:, :, 0]
    for j in range(1, H // KH):
        qbar = qbar + qh[:, :, j]
    F = KH * D
    F4 = -(-F // 4) * 4
    qg = torch.nn.functional.pad(qbar.reshape(G, F), (0, F4 - F))
    eg = torch.nn.functional.pad(emb.float().reshape(E, F), (0, F4 - F))
    qg, eg = qg.view(G, F4 // 4, 4), eg.view(E, F4 // 4, 4)
    total = None
    for w in range(warps):
        acc = torch.zeros((G, E, 4))
        for t in range(w, F4 // 4, warps):
            acc = acc + qg[:, None, t] * eg[None, :, t]
        part = (acc[..., 0] + acc[..., 1]) + (acc[..., 2] + acc[..., 3])
        total = part if total is None else total + part
    scale = torch.tensor(1.0) / torch.sqrt(torch.tensor(float(D)))
    return total * scale


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("G,H,KH,D,E", [
    (64, 32, 4, 64, 32),     # the decode step's widths (tinyllama)
    (5, 6, 6, 16, 7),        # ragged against the 4 x 8 tile, KH = H
])
def test_router_fold_order(dtype, G, H, KH, D, E):
    """Folding q over each GQA group before the dot, in the kernel's order,
    stays within 2e-5 of the JAX kernel (interpret mode), which multiplies
    every query head by its kv head's repeated embedding."""
    qj, qt = both(randn(40, (G, H, D)), dtype)
    ej, et = both(randn(41, (E, KH, D)), dtype)
    s1 = _router_fold_dot(qt, et)
    assert_close(s1, jops.router_scores(qj, ej))
    assert_close(s1, tops.router_scores(qt, et))


def _routed_case(R, G, K, seed):
    """lin (G, K) int64 rows in [0, R) with dropped routes (R, the trash
    row): every third route, and all of group 1's."""
    g = np.random.default_rng(seed)
    lin = np.stack([g.permutation(R)[:K] for _ in range(G)]).astype(np.int64)
    lin.reshape(-1)[::3] = R
    lin[1] = R
    return torch.from_numpy(lin)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("R,Q,H,D,G,K", [
    (12, 1, 4, 16, 5, 3),    # decode: one query per group
    (6, 4, 2, 32, 3, 2),     # prefill blocks: Q > 1
])
def test_lse_merge_routed(dtype, R, Q, H, D, G, K):
    """The routed merge's plain version equals the plain dense merge of the
    partials gathered by hand, bit for bit (a dropped route is out 0, lse
    -1e30; group 1 lost every route), and the JAX kernel's merge of those
    partials within tolerance."""
    _, od = both(randn(42, (R, Q, H, D)), dtype)
    lsed = torch.from_numpy(randn(43, (R, Q, H), 3.0))
    lin = _routed_case(R, G, K, 44)
    outs = torch.zeros((K, G, Q, H, D), dtype=od.dtype)
    lses = torch.full((K, G, Q, H), -1e30)
    for g in range(G):
        for k in range(K):
            if lin[g, k] < R:
                outs[k, g] = od[lin[g, k]]
                lses[k, g] = lsed[lin[g, k]]
    outs, lses = outs.view(K, G * Q, H, D), lses.view(K, G * Q, H)
    o1, l1 = tops.lse_merge_routed(od, lsed, lin)
    o2, l2 = tref.lse_merge_ref(outs, lses)
    assert o1.dtype == od.dtype and o1.shape == (G * Q, H, D)
    assert torch.equal(o1, o2) and torch.equal(l1, l2)
    assert bool((l1.view(G, Q * H)[1] == -1e30).all())
    assert bool((o1.view(G, Q * H, D)[1] == 0).all())
    oj, lj = jops.lse_merge(both(outs.float().numpy(), dtype)[0],
                            both(lses.numpy())[0])
    assert_close(o1, oj, dtype)
    assert_close(l1, lj)


@pytest.mark.parametrize("dtype", DTYPES)
def test_lse_merge_pair(dtype):
    """The pair merge's plain version equals the dense merge of the stacked
    pair bit for bit, and the JAX kernel within tolerance, with a row that
    neither partial attended and a -inf sentinel."""
    oj, ot = both(randn(45, (2, 9, 4, 16)), dtype)
    lse = randn(46, (2, 9, 4), 3.0)
    lse[:, 0] = -1e30
    lse[1, 2] = -np.inf
    lj, lt = both(lse)
    o1, l1 = tops.lse_merge_pair(ot[0], lt[0], ot[1], lt[1])
    o2, l2 = tops.lse_merge(ot, lt)
    assert torch.equal(o1, o2) and torch.equal(l1, l2)
    o3, l3 = jops.lse_merge(oj, lj)
    assert_close(o1, o3, dtype)
    assert_close(l1, l3)


def test_merge_of_decode_splits_equals_joint():
    """Flash-decoding invariant through the port's wrappers: decode over
    split caches + lse_merge == decode over the whole cache."""
    B, H, KH, D, S = 3, 8, 2, 32, 128
    _, q = both(randn(13, (B, H, D)))
    _, k = both(randn(14, (B, S, KH, D)))
    _, v = both(randn(15, (B, S, KH, D)))
    full = torch.full((B,), S, dtype=torch.int32)
    half = torch.full((B,), S // 2, dtype=torch.int32)
    oj, _ = tops.decode_attention(q, k, v, full)
    o1, l1 = tops.decode_attention(q, k[:, :S // 2].contiguous(),
                                   v[:, :S // 2].contiguous(), half)
    o2, l2 = tops.decode_attention(q, k[:, S // 2:].contiguous(),
                                   v[:, S // 2:].contiguous(), half)
    om, _ = tops.lse_merge(torch.stack([o1, o2]), torch.stack([l1, l2]))
    assert_close(om, oj)


@pytest.mark.parametrize("N,H,KH,D,T", [(9, 4, 2, 16, 21), (5, 8, 8, 32, 64),
                                         (3, 6, 2, 16, 1)])
def test_shared_tail_attention_plain_version_is_a_masked_softmax(N, H, KH,
                                                                 D, T):
    """Each row's softmax over tail keys first[n] .. T - 1 alone, row by
    row; a row that sees none gets out 0 and lse -inf; the CPU launches
    nothing."""
    g = torch.Generator().manual_seed(N)
    q = torch.randn(N, H, D, generator=g)
    k = torch.randn(T, KH, D, generator=g)
    v = torch.randn(T, KH, D, generator=g)
    first = torch.randint(0, T + 3, (N,), generator=g, dtype=torch.int32)
    first[0], first[-1] = 0, T          # the whole tail, and none of it
    out, lse = tops.shared_tail_attention(q, k, v, first)
    G = H // KH
    for n in range(N):
        a = int(first[n])
        if a >= T:
            assert torch.isinf(lse[n]).all() and (lse[n] < 0).all()
            assert (out[n] == 0).all()
            continue
        kk = k[a:].repeat_interleave(G, dim=1)
        vv = v[a:].repeat_interleave(G, dim=1)
        s = torch.einsum("hd,thd->ht", q[n], kk) / D ** 0.5
        torch.testing.assert_close(lse[n], torch.logsumexp(s, -1),
                                   rtol=2e-5, atol=2e-5)
        torch.testing.assert_close(
            out[n], torch.einsum("ht,thd->hd", s.softmax(-1), vv),
            rtol=2e-5, atol=2e-5)


def test_every_kernel_has_source_plain_version_and_counter():
    """Each wrapper names a CUDA source whose note names the TPU kernel it
    replaces (the prefill and tail kernels, which replace none: the
    function they compute) and what bounds it; each has a plain version
    and a count."""
    notes = {"shared_chunk_attention": "shared_chunk_attn",
             "decode_attention": "decode_attn",
             "lse_merge": "lse_merge",
             "router_scores": "router_score",
             "paged_decode_attention": "paged_decode_attn",
             "shared_chunk_attention_q8": "shared_chunk_attn",
             "flash_prefill_attention": "flash_prefill_attn",
             "shared_tail_attention": "shared_chunk_attn"}
    computes = {"flash_prefill_attention":
                "src/repro/models/layers.py::flash_attention",
                "shared_tail_attention":
                "kernels/ref.py::shared_tail_attention_ref"}
    csrc = ROOT / "src/repro_torch/kernels/csrc"
    assert sorted(fn.__name__ for fn in tops.KERNELS) == sorted(notes)
    for fn in tops.KERNELS:
        stem = notes[fn.__name__]
        text = (csrc / f"{stem}.cu").read_text()
        assert computes.get(fn.__name__,
                            f"src/repro/kernels/{stem}.py") in text
        assert fn.__name__ in text            # the TPU function it replaces
        assert "What bounds it on the H100" in text
        assert isinstance(fn.launches, int)
        assert callable(getattr(tref, f"{fn.__name__}_ref"))


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_neither_jax_nor_the_reference():
    files = sorted((ROOT / "src/repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 20
    # the new modules of the dense family's slice, examples included, and
    # of the disaggregation slice
    for rel in ("models/moe.py", "examples/quickstart.py",
                "examples/serve_shared_corpus.py",
                "examples/long_context_decode.py",
                "configs/granite_moe_1b_a400m.py", "core/disagg.py",
                "sharding/specs.py", "sharding/data_parallel.py",
                "launch/mesh.py",
                # the launch analysis tools and tensor parallelism
                "launch/roofline.py", "launch/op_cost.py",
                "launch/input_specs.py", "launch/dryrun.py",
                "kernels/work.py", "sharding/tensor_parallel.py"):
        assert ROOT / "src/repro_torch" / rel in files, rel
    for path in files:
        for mod in _imports(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), (path, mod)
