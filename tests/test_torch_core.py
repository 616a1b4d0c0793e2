"""Parity of the port's MoSKA core (router, shared KV store, shared-KV
attention, mixture attention) with the reference package's, on the CPU.

Routing and dispatch are integers and must match exactly, including
routes past capacity and tied scores (``lax.top_k`` puts the lower index
first). Attention outputs: fp32 within 2e-5, bf16 within 2e-2."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import MoSKAConfig as JMoSKAConfig
from repro.core import moska_attention as JMA
from repro.core import router as jrouter
from repro.core import shared_attention as jsa
from repro.core import shared_kv as jkv
from repro_torch.configs.base import MoSKAConfig as TMoSKAConfig
from repro_torch.core import moska_attention as TMA
from repro_torch.core import router as trouter
from repro_torch.core import shared_attention as tsa
from repro_torch.core import shared_kv as tkv
from torch_parity import assert_close, both, randn


def _exact(a, b):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# ---------------------------------------------------------------------------
# router
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("G,H,KH,D,E,k", [(6, 8, 2, 16, 12, 3),
                                          (5, 4, 4, 64, 9, 4),
                                          (3, 8, 1, 16, 4, 8)])
def test_route_ties_match_lax_top_k(G, H, KH, D, E, k):
    """Integer-valued inputs make the scores exact in both packages, so the
    many tied scores must be broken the same way (lower index first)."""
    g = np.random.default_rng(G * 10 + E)
    qj, qt = both(g.integers(-1, 2, (G, H, D)).astype(np.float32))
    emb = g.integers(-1, 2, (E, KH, D)).astype(np.float32)
    emb[E // 2] = emb[0]                   # two chunks with one embedding
    ej, et = both(emb)
    rj, rt = jrouter.route(qj, ej, k), trouter.route(qt, et, k)
    _exact(rt.full_scores.numpy(), rj.full_scores)
    assert len(np.unique(rt.full_scores.numpy())) < G * E   # ties exist
    _exact(rt.chunk_ids.numpy(), rj.chunk_ids)
    _exact(rt.scores.numpy(), rj.scores)


def test_route_and_route_blocks_random():
    qj, qt = both(randn(1, (40, 8, 16)))
    ej, et = both(randn(2, (10, 2, 16)))
    rj, rt = jrouter.route(qj[:7], ej, 3), trouter.route(qt[:7], et, 3)
    _exact(rt.chunk_ids.numpy(), rj.chunk_ids)
    assert_close(rt.scores, rj.scores)
    assert_close(rt.full_scores, rj.full_scores)
    bj = jrouter.route_blocks(qj, ej, 4, block=16)
    bt = trouter.route_blocks(qt, et, 4, block=16)
    _exact(bt.chunk_ids.numpy(), bj.chunk_ids)
    assert_close(bt.scores, bj.scores)


@pytest.mark.parametrize("G,K,E,cap,seed", [
    (12, 4, 8, 3, 0), (5, 3, 4, 1, 1), (9, 2, 3, 4, 2), (1, 1, 1, 1, 3),
    (20, 8, 32, 2, 4),
])
def test_dispatch_plan_exact_past_capacity(G, K, E, cap, seed):
    ids = np.random.default_rng(seed).integers(0, E, (G, K)).astype(np.int32)
    jf, jp, jk = jrouter.dispatch_plan(jnp.asarray(ids), E, cap)
    tf, tp, tk = trouter.dispatch_plan(torch.from_numpy(ids).long(), E, cap)
    _exact(tf.numpy(), jf)
    _exact(tp.numpy(), jp)
    _exact(tk.numpy(), jk)


@pytest.mark.parametrize("args", [(256, 8, 64, 2.0), (64, 8, 32, 2.0),
                                  (2, 8, 32, 2.0), (3, 2, 5, 1.5),
                                  (1, 1, 0, 2.0)])
def test_required_capacity(args):
    assert trouter.required_capacity(*args) == jrouter.required_capacity(*args)


# ---------------------------------------------------------------------------
# shared KV store
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("quantize", [False, True])
def test_build_store(quantize):
    kj, kt = both(randn(3, (2, 48, 2, 16)))
    vj, vt = both(randn(4, (2, 48, 2, 16)))
    sj = jkv.build_store(kj, vj, 16, start_position=100, quantize=quantize)
    st = tkv.build_store(kt, vt, 16, start_position=100, quantize=quantize)
    assert st.num_chunks == 3 and st.chunk_size == 16 and st.num_layers == 2
    assert st.total_tokens == sj.total_tokens
    assert st.quantized == quantize
    _exact(st.chunk_positions.numpy(), sj.chunk_positions)
    assert_close(st.emb, sj.emb)
    if quantize:
        assert st.k.dtype == torch.int8
        _exact(st.k.numpy(), sj.k)
        _exact(st.v.numpy(), sj.v)
        assert_close(st.k_scale, sj.k_scale)
        assert_close(st.v_scale, sj.v_scale)
        for i in range(2):
            for a, b in zip(st.dequantize_layer(i), sj.dequantize_layer(i)):
                assert a.dtype == torch.bfloat16
                assert_close(a, b, "bfloat16")
    else:
        _exact(st.k.numpy(), sj.k)
        assert st.layer(1).k.shape == (3, 16, 2, 16)
    with pytest.raises(ValueError):
        tkv.build_store(kt[:, :40], vt[:, :40], 16)


def test_chunk_embeddings_bf16():
    xj, xt = both(randn(5, (3, 32, 2, 16)), "bfloat16")
    e = tkv.chunk_embeddings(xt)
    assert e.dtype == torch.bfloat16
    assert_close(e, jkv.chunk_embeddings(xj), "bfloat16")


# ---------------------------------------------------------------------------
# shared-KV attention
# ---------------------------------------------------------------------------

def _routings(ids, E):
    ids = np.asarray(ids, np.int32)
    G, K = ids.shape
    zj, zt = np.zeros((G, K), np.float32), np.zeros((G, E), np.float32)
    return (jrouter.Routing(jnp.asarray(ids), jnp.asarray(zj),
                            jnp.asarray(zt)),
            trouter.Routing(torch.from_numpy(ids).long(),
                            torch.from_numpy(zj), torch.from_numpy(zt)))


def _distinct_ids(G, K, E, seed):
    g = np.random.default_rng(seed)
    return np.stack([g.permutation(E)[:K] for _ in range(G)])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("G,Q,K,E,C,H,KH,D,cap", [
    (6, 1, 3, 8, 16, 8, 2, 32, None),    # decode-shaped, default capacity
    (4, 8, 2, 8, 16, 8, 2, 32, 8),       # prefill blocks
    (1, 1, 1, 4, 8, 4, 4, 16, 1),        # single query group, MHA
    (1, 4, 8, 8, 8, 4, 1, 16, 8),        # one group routed everywhere, MQA
    (5, 1, 2, 3, 24, 8, 2, 32, 10),      # C not tile-aligned
    (12, 1, 3, 4, 16, 8, 2, 32, 2),      # capacity overflow: routes dropped
])
def test_shared_attention_batched(dtype, G, Q, K, E, C, H, KH, D, cap):
    kj, kt = both(randn(6, (E, C, KH, D)), dtype)
    vj, vt = both(randn(7, (E, C, KH, D)), dtype)
    qj, qt = both(randn(8, (G, Q, H, D)), dtype)
    rj, rt = _routings(_distinct_ids(G, K, E, G + K), E)
    pt = tsa.shared_attention_batched(qt, kt, vt, rt, capacity=cap)
    # the Pallas kernel runs in interpret mode: once per shape, in fp32
    kernels = (None, "pallas") if dtype == "float32" else (None,)
    for kernel in kernels:
        pj = jsa.shared_attention_batched(qj, kj, vj, rj, capacity=cap,
                                          kernel=kernel)
        assert_close(pt.out, pj.out, dtype)
        assert_close(pt.lse, pj.lse, dtype)
    if cap is not None and cap < G * K // E:
        assert (pt.lse.numpy() < -1e29).any()      # some groups lost routes
    gj = jsa.shared_attention_gather_ref(qj, kj, vj, rj)
    gt = tsa.shared_attention_gather_ref(qt, kt, vt, rt)
    assert_close(gt.out, gj.out, dtype)
    assert_close(gt.lse, gj.lse, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("Q,cap", [(1, None), (8, 8), (1, 2)])
def test_shared_attention_batched_int8_store(dtype, Q, cap):
    """An int8 store with its scales goes through the q8 kernel's plain
    version, dequantized in fp32: it matches the reference's batched path
    on the fp32-dequantized store (2e-5 fp32, 2e-2 bf16), and with fp32
    queries the port's own fp path on that store bit for bit. Capacity 2
    drops routes."""
    G, K, E, C, H, KH, D = 6, 3, 8, 16, 8, 2, 32
    kq, ks = tkv._quantize(torch.from_numpy(randn(30, (E, C, KH, D))))
    vq, vs = tkv._quantize(torch.from_numpy(randn(31, (E, C, KH, D))))
    kd = kq.float() * ks[..., None]
    vd = vq.float() * vs[..., None]
    qj, qt = both(randn(32, (G, Q, H, D)), dtype)
    rj, rt = _routings(_distinct_ids(G, K, E, 33), E)
    pt = tsa.shared_attention_batched(qt, kq, vq, rt, capacity=cap,
                                      k_scale=ks, v_scale=vs)
    assert pt.out.dtype == qt.dtype
    pj = jsa.shared_attention_batched(qj, jnp.asarray(kd.numpy()),
                                      jnp.asarray(vd.numpy()), rj,
                                      capacity=cap)
    assert_close(pt.out, pj.out, dtype)
    assert_close(pt.lse, pj.lse, dtype)
    if dtype == "float32":
        pf = tsa.shared_attention_batched(qt, kd, vd, rt, capacity=cap)
        assert torch.equal(pt.out, pf.out) and torch.equal(pt.lse, pf.lse)


def test_shared_attention_empty_chunks_and_records():
    """Chunks no group routed to stay empty; the device recorder queues the
    dispatch metrics and flushes them in one readback."""
    from repro_torch import obs
    E, C, KH, D, H = 6, 8, 2, 16, 4
    kj, kt = both(randn(9, (E, C, KH, D)))
    vj, vt = both(randn(10, (E, C, KH, D)))
    qj, qt = both(randn(11, (3, 1, H, D)))
    rj, rt = _routings([[0, 2], [2, 0], [0, 2]], E)
    rec, reg = obs.DeviceRecorder(), obs.MetricsRegistry()
    pt = tsa.shared_attention_batched(qt, kt, vt, rt, capacity=2, rec=rec)
    pj = jsa.shared_attention_batched(qj, kj, vj, rj, capacity=2)
    assert_close(pt.out, pj.out)
    assert_close(pt.lse, pj.lse)
    assert len(rec) == 3
    rec.flush(reg)
    assert len(rec) == 0
    assert reg.counter("moska/dispatched_queries").value == 4
    assert reg.counter("moska/dropped_queries").value == 2
    util = reg.histogram("moska/dispatch_capacity_utilization",
                         obs.FRACTION_EDGES)
    assert util.count == 1 and abs(util.sum - 4 / 12) < 1e-6


# ---------------------------------------------------------------------------
# mixture attention
# ---------------------------------------------------------------------------

def _ctx(E, C, KH, D, ids, dtype, seed):
    kj, kt = both(randn(seed, (E, C, KH, D)), dtype)
    vj, vt = both(randn(seed + 1, (E, C, KH, D)), dtype)
    rj, rt = _routings(ids, E)
    return (JMA.MoskaLayerContext(kj, vj, rj),
            TMA.MoskaLayerContext(kt, vt, rt))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("H,KH", [(4, 4), (8, 2)])
def test_moska_decode_attention(dtype, H, KH):
    B, S, D, E, C = 5, 20, 16, 6, 16
    qj, qt = both(randn(12, (B, H, D)), dtype)
    kj, kt = both(randn(13, (B, S, KH, D)), dtype)
    vj, vt = both(randn(14, (B, S, KH, D)), dtype)
    lj, lt = both(np.array([1, 5, 20, 11, 3], np.int32))
    cj, ct = _ctx(E, C, KH, D, _distinct_ids(B, 2, E, 5), dtype, 15)
    mj, mt = JMoSKAConfig(), TMoSKAConfig()
    oj = JMA.moska_decode_attention(qj, kj, vj, lj, cj, mj)
    ot = TMA.moska_decode_attention(qt, kt, vt, lt, ct, mt)
    assert_close(ot, oj, dtype)
    # no store, or MoSKA off: the unique partial alone
    uj = JMA.moska_decode_attention(qj, kj, vj, lj, None, mj)
    assert_close(TMA.moska_decode_attention(qt, kt, vt, lt, None, mt), uj,
                 dtype)
    off = dataclasses.replace(mt, enabled=False)
    assert_close(TMA.moska_decode_attention(qt, kt, vt, lt, ct, off), uj,
                 dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moska_prefill_attention(dtype):
    B, S, H, KH, D, E, C, rb = 2, 16, 8, 2, 16, 5, 8, 8
    qj, qt = both(randn(16, (B, S, H, D)), dtype)
    kj, kt = both(randn(17, (B, S, KH, D)), dtype)
    vj, vt = both(randn(18, (B, S, KH, D)), dtype)
    cj, ct = _ctx(E, C, KH, D, _distinct_ids(B * S // rb, 3, E, 6), dtype,
                  19)
    oj = JMA.moska_prefill_attention(qj, kj, vj, cj, JMoSKAConfig(),
                                     q_offset=40, route_block=rb)
    ot = TMA.moska_prefill_attention(qt, kt, vt, ct, TMoSKAConfig(),
                                     q_offset=40, route_block=rb)
    assert_close(ot, oj, dtype)
