"""The port's paged KV layout against the reference's, on the CPU.

Host side: ``BlockPool`` and ``SlotTables`` walks must leave both packages
in the same states. Device ops: ``write_blocks``, ``gather_layer``,
``append_layer``, ``copy_block`` and ``grow`` must give the reference's
values bit for bit. Engine: the port's paged engine must generate the
reference paged engine's greedy tokens (reference with
``spec_append=False, overlap_waves=False``, its exact counterpart) with
the same paged counters, on the streams of ``tests/test_paged_serving.py``,
and the same tokens as its own slotted layout; the ``paged_vs_slotted``
scenario of ``benchmarks/bench_serving.py`` must give equal high-water
bytes and deferred admissions in both packages."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import obs as jobs
from repro.configs import get_config as jget
from repro.kvcache import block_table as jbt
from repro.kvcache import paged as jpg
from repro.models.model import build_model as jbuild_model
from repro.serving import engine as je
from repro_torch import obs as tobs
from repro_torch.configs import get_config as tget
from repro_torch.convert import from_reference_params
from repro_torch.data.pipeline import CorpusSpec, synthesize_corpus
from repro_torch.kernels import ops
from repro_torch.kvcache import block_table as tbt
from repro_torch.kvcache import paged as tpg
from repro_torch.serving import engine as te
from torch_parity import both, randn, to_np

KEY = jax.random.PRNGKey(0)


def _exact(a, b):
    np.testing.assert_array_equal(to_np(a), to_np(b))


# ---------------------------------------------------------------------------
# host side: allocator and tables
# ---------------------------------------------------------------------------

def _pool_state(p):
    return (list(p._free), dict(p._ref), dict(p._gen), p.num_blocks,
            p.available, p.in_use, p.capacity)


def _both_do(fn_j, fn_t):
    """Run one operation on both packages: the same result, or errors of
    the same name (each package has its own ``PoolExhausted``)."""
    try:
        want = fn_j()
    except Exception as e:                      # noqa: BLE001
        with pytest.raises(Exception) as got:
            fn_t()
        assert type(got.value).__name__ == type(e).__name__
        return None
    assert fn_t() == want
    return want


@pytest.mark.parametrize("num_blocks,seed", [(16, 0), (3, 1), (9, 2)])
def test_block_pool_walk_matches_reference(num_blocks, seed):
    """alloc / incref / free / CoW / grow walk with exhaustion and double
    frees: both allocators end every step in the same state."""
    pj, pt = jpg.BlockPool(num_blocks), tpg.BlockPool(num_blocks)
    rng = np.random.default_rng(seed)
    tables = []
    for _ in range(250):
        op = int(rng.integers(0, 6))
        if op == 0:
            n = int(rng.integers(0, 4))
            ids = _both_do(lambda: pj.alloc(n), lambda: pt.alloc(n))
            if ids:
                tables.append(ids)
        elif op == 1 and tables:
            src = tables[int(rng.integers(0, len(tables)))]
            _both_do(lambda: pj.incref(src), lambda: pt.incref(src))
            tables.append(list(src))
        elif op == 2 and tables:
            t = tables.pop(int(rng.integers(0, len(tables))))
            _both_do(lambda: pj.free(t), lambda: pt.free(t))
        elif op == 3 and tables:
            t = tables[int(rng.integers(0, len(tables)))]
            b = t[int(rng.integers(0, len(t)))]
            assert pt.needs_copy(b) == pj.needs_copy(b)
            assert pt.refcount(b) == pj.refcount(b)
            assert pt.generation(b) == pj.generation(b)
            assert pt.is_free(b) == pj.is_free(b)
        elif op == 4:
            # a double free or a free of a never-allocated block raises
            b = int(rng.integers(0, pj.num_blocks))
            if pj.refcount(b) == 0:
                _both_do(lambda: pj.free([b]), lambda: pt.free([b]))
        elif op == 5 and rng.random() < 0.1:
            n = pj.num_blocks + int(rng.integers(0, 4))
            pj.grow(n)
            pt.grow(n)
        assert _pool_state(pt) == _pool_state(pj)
        pt.check_invariants()
    with pytest.raises(ValueError):
        tpg.BlockPool(1)


def test_slot_tables_walk_matches_reference():
    tj, tt = jbt.SlotTables(3, 4, 16), tbt.SlotTables(3, 4, 16)

    def same():
        for name in ("table", "length", "offset", "n_blocks"):
            _exact(getattr(tt, name), getattr(tj, name))
        assert tt.capacity_tokens == tj.capacity_tokens
        for a, b in zip(tt.device_args(), tj.device_args()):
            _exact(a, b)

    steps = [
        lambda t: t.assign(0, [3, 5], 20, 7),
        lambda t: t.assign(2, [1], 4, 0),
        lambda t: t.append_block(0, 9),
        lambda t: t.replace_block(0, 1, 6),
        lambda t: t.replace_block(1, 0, 6),          # no block: raises
        lambda t: t.tick(),
        lambda t: t.prefix_blocks(0, 17),
        lambda t: t.prefix_blocks(2, 40),             # beyond: empty
        lambda t: t.block_index(0, 63),
        lambda t: t.block_index(0, 64),               # beyond: raises
        lambda t: t.clear(0),
        lambda t: t.grow(6),
        lambda t: t.assign(1, list(range(1, 7)), 90, 3),
        lambda t: t.append_block(1, 8),               # full: raises
        lambda t: t.assign(1, list(range(8)), 10, 0),  # too wide: raises
        lambda t: t.slot_blocks(1),
        lambda t: t.tick(),
    ]
    for step in steps:
        _both_do(lambda: step(tj), lambda: step(tt))
        same()
    for n, bs in ((0, 16), (1, 16), (16, 16), (17, 16), (33, 8)):
        assert tbt.blocks_for(n, bs) == jbt.blocks_for(n, bs)
    for bs, max_seq in ((16, 64), (24, 64), (0, 64)):
        _both_do(lambda: jbt.validate_block_size(bs, max_seq),
                 lambda: tbt.validate_block_size(bs, max_seq))


# ---------------------------------------------------------------------------
# device ops
# ---------------------------------------------------------------------------

L, N, BS, KH, D = 2, 8, 4, 2, 8


def _pools(dtype, seed=0):
    """Both packages' pools, holding the same random pages."""
    k, v = randn(seed, (L, N, BS, KH, D)), randn(seed + 1, (L, N, BS, KH, D))
    (kj, kt), (vj, vt) = both(k, dtype), both(v, dtype)
    return jpg.PagedKVCache(kj, vj), tpg.PagedKVCache(kt, vt)


def _same_pool(pt, pj, pages=slice(None)):
    _exact(pt.k[:, pages], pj.k[:, pages])
    _exact(pt.v[:, pages], pj.v[:, pages])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("true_len", [None, 10, 1])
def test_write_blocks_and_gather_match_reference(dtype, true_len):
    pj, pt = _pools(dtype)
    (kj, kt), (vj, vt) = (both(randn(s, (L, 12, KH, D)), dtype)
                          for s in (5, 6))
    ids = [3, 1, 5]
    pj = jpg.write_blocks(pj, jnp.asarray(ids, jnp.int32), kj, vj,
                          true_len=true_len)
    ptr = pt.k.data_ptr()
    tpg.write_blocks(pt, ids, kt, vt, true_len=true_len)
    assert pt.k.data_ptr() == ptr                     # in place
    _same_pool(pt, pj)
    table = np.array([[3, 1, 5, 0], [7, 7, 2, 4]], np.int32)
    tj, tt = both(table)
    for layer in range(L):
        _exact(tpg.gather_layer(pt.k[layer], tt),
               jpg.gather_layer(pj.k[layer], tj))
    with pytest.raises(ValueError, match="multiple"):
        tpg.write_blocks(pt, [1], kt[:, :3], vt[:, :3])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_append_layer_matches_reference(dtype):
    """One token per slot at (table[b, len // bs], len % bs); the block
    index clamps at the table's end; an inactive (NULL) row writes into
    the null page, which both packages then hold garbage in."""
    pj, pt = _pools(dtype, seed=2)
    table = np.array([[2, 3], [5, 6], [0, 0]], np.int32)
    for lengths in ([5, 0, 9], [7, 12, 3], [1, 4, 6]):
        (nj, nt) = both(randn(len(lengths), (3, KH, D)), dtype)
        (tj, tt), (lj, lt) = both(table), both(np.int32(lengths))
        kl = jpg.append_layer(pj.k[0], nj, tj, lj)
        pj = jpg.PagedKVCache(pj.k.at[0].set(kl), pj.v)
        tpg.append_layer(pt.k[0], nt, tt, lt)
        _same_pool(pt, pj)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_copy_block_and_grow_match_reference(dtype):
    pj, pt = _pools(dtype, seed=3)
    pj = jpg.copy_block(pj, 6, 2)
    tpg.copy_block(pt, 6, 2)
    _same_pool(pt, pj)
    gj, gt = jpg.grow_paged_kv_cache(pj, 12), tpg.grow_paged_kv_cache(pt, 12)
    assert gt.num_blocks == gj.num_blocks == 12
    assert gt.block_size == BS and gt.nbytes == gj.nbytes
    _same_pool(gt, gj)
    assert tpg.grow_paged_kv_cache(pt, 4) is pt
    ij = jpg.init_paged_kv_cache(L, 5, BS, KH, D, jnp.bfloat16)
    it = tpg.init_paged_kv_cache(L, 5, BS, KH, D, torch.bfloat16)
    _same_pool(it, ij)
    assert it.nbytes == ij.nbytes


# ---------------------------------------------------------------------------
# the paged engine against the reference's
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny():
    jcfg, tcfg = (dataclasses.replace(get("tinyllama-1.1b").reduced(),
                                      dtype="float32") for get in (jget, tget))
    pj = jbuild_model(jcfg).init(KEY)
    pt = from_reference_params(tcfg, jax.tree.map(np.asarray, pj))
    corpus = synthesize_corpus(CorpusSpec("laws", 256, jcfg.vocab_size))
    return jcfg, tcfg, pj, pt, corpus


def _serve(engine_mod, obs_mod, cfg, params, requests, corpus, **ecfg):
    """Serve ``requests`` [(prompt, new_tokens)] on a fresh engine and
    registry; returns ({uid: (slot, tokens)}, registry, engine)."""
    reg = obs_mod.MetricsRegistry()
    prev = obs_mod.set_registry(reg)
    try:
        eng = engine_mod.ServingEngine(cfg, params, engine_mod.EngineConfig(
            **ecfg))
        cid = None
        if corpus is not None:
            eng.register_corpus("laws", corpus)
            cid = "laws"
        for prompt, new in requests:
            eng.submit(prompt, max_new_tokens=new, corpus_id=cid)
        done = eng.run()
        return ({r.uid: (r.slot, tuple(r.generated)) for r in done}, reg,
                eng)
    finally:
        obs_mod.set_registry(prev)


def _jax(cfg, params, requests, corpus, **ecfg):
    return _serve(je, jobs, cfg, params, requests, corpus,
                  cache_dtype=jnp.float32, spec_append=False,
                  overlap_waves=False, **ecfg)


def _torch(cfg, params, requests, corpus, **ecfg):
    return _serve(te, tobs, cfg, params, requests, corpus,
                  cache_dtype=torch.float32, **ecfg)


PAGED_COUNTERS = ("engine/prefills", "engine/decode_steps",
                  "engine/tokens_generated", "engine/prefill_tokens",
                  "kvcache/prefix_hits", "kvcache/blocks_shared",
                  "kvcache/cow_copies", "kvcache/blocks_appended",
                  "kvcache/pool_growths", "kvcache/prefix_evictions",
                  "kvcache/slots_released", "engine/chunked_prefills",
                  "engine/prefill_chunks", "moska/dispatched_queries",
                  "moska/dropped_queries")

# the streams of tests/test_paged_serving.py: (requests, engine config)
STREAMS = {
    # ragged lengths + a duplicate prompt: prefix-cache hit + CoW
    "duplicates-cow": ([([1 + i] * (5 + 3 * i), 4) for i in range(5)]
                       + [([1] * 5, 4)],
                       dict(max_slots=3, max_seq=64, num_blocks=64)),
    # skewed lengths on an auto-sized pool: appends and pool growth
    "skewed": ([([2] * 40, 4), ([3] * 15, 4)]
               + [([4 + i] * 6, 4) for i in range(3)],
               dict(max_slots=3, max_seq=64)),
    # a prompt past max_seq: chunked prefill (200 tokens in 128 chunks)
    "long-prompt": ([(list(range(1, 201)), 4)],
                    dict(max_slots=2, max_seq=64)),
}


@pytest.mark.parametrize("stream", sorted(STREAMS))
def test_paged_engine_matches_reference(tiny, stream):
    jcfg, tcfg, pj, pt, corpus = tiny
    requests, ecfg = STREAMS[stream]
    ecfg = dict(ecfg, kv_layout="paged", block_size=16)
    gen_j, reg_j, _ = _jax(jcfg, pj, requests, corpus, **ecfg)
    gen_t, reg_t, eng = _torch(tcfg, pt, requests, corpus, **ecfg)
    assert len(gen_t) == len(requests)
    assert gen_t == gen_j
    for name in PAGED_COUNTERS:
        assert reg_t.counter(name).value == reg_j.counter(name).value, name
    for name in ("engine/hbm_high_water_bytes", "engine/decode_cache_bytes",
                 "kvcache/blocks_in_use", "kvcache/block_capacity"):
        assert reg_t.gauge(name).value == reg_j.gauge(name).value, name
    eng._block_pool.check_invariants()
    if stream == "duplicates-cow":
        assert reg_t.counter("kvcache/prefix_hits").value >= 1
        assert reg_t.counter("kvcache/cow_copies").value >= 1
    if stream == "long-prompt":
        assert reg_t.counter("engine/chunked_prefills").value == 1
        assert reg_t.counter("engine/prefill_chunks").value == 2
    else:
        # within the port, paged generations equal the slotted layout's
        slotted, _, _ = _torch(tcfg, pt, requests, corpus,
                               **dict(ecfg, kv_layout="slotted"))
        assert {u: g for u, (_, g) in gen_t.items()} == \
            {u: g for u, (_, g) in slotted.items()}
    assert all(n == 0 for n in ops.launch_counts().values())


def test_paged_vs_slotted_scenario_matches_reference(tiny):
    """``bench_serving.py``'s paged_vs_slotted record, live: a skewed mix
    under a 3-slot budget. Paged admits the whole mix at once and peaks
    lower; both packages agree on every number."""
    jcfg, tcfg, pj, pt, _ = tiny
    skew = [[2] * 40, [3] * 15] + [[4 + i] * 6 for i in range(4)]
    budget = 3 * 64 * jcfg.kv_bytes_per_token
    requests = [(p, 4) for p in skew]
    got = {}
    for layout in ("slotted", "paged"):
        ecfg = dict(max_slots=6, max_seq=64, kv_layout=layout,
                    mem_budget_bytes=budget)
        gen_j, reg_j, _ = _jax(jcfg, pj, requests, None, **ecfg)
        gen_t, reg_t, _ = _torch(tcfg, pt, requests, None, **ecfg)
        assert gen_t == gen_j
        rec = {}
        for name in ("scheduler/admission_deferred_mem",
                     "engine/decode_steps", "engine/tokens_generated"):
            rec[name] = reg_t.counter(name).value
            assert rec[name] == reg_j.counter(name).value, (layout, name)
        name = "engine/hbm_high_water_bytes"
        rec[name] = reg_t.gauge(name).value
        assert rec[name] == reg_j.gauge(name).value, layout
        got[layout] = (rec, {u: g for u, (_, g) in gen_t.items()})
    assert got["paged"][1] == got["slotted"][1]
    assert got["paged"][0]["engine/hbm_high_water_bytes"] < \
        got["slotted"][0]["engine/hbm_high_water_bytes"]
    assert got["paged"][0]["scheduler/admission_deferred_mem"] < \
        got["slotted"][0]["scheduler/admission_deferred_mem"]


def test_paged_engine_reuses_pool_and_drains(tiny):
    """A second run() on the same engine keeps its pool (grown in place of
    the old one only when it must), and every page returns to the free
    list or the prefix cache."""
    _, tcfg, _, pt, corpus = tiny
    eng = te.ServingEngine(tcfg, pt, te.EngineConfig(
        max_slots=2, max_seq=64, kv_layout="paged", block_size=16,
        cache_dtype=torch.float32))
    eng.register_corpus("laws", corpus)
    eng.submit([5] * 30, max_new_tokens=3, corpus_id="laws")
    eng.run()
    ptr = eng._pool.k.data_ptr()
    eng.submit([5] * 30, max_new_tokens=3, corpus_id="laws")   # prefix hit
    done = eng.run()
    assert eng._pool.k.data_ptr() == ptr
    assert done[0].generated == done[1].generated
    bp = eng._block_pool
    parked = sum(len(e["blocks"]) for e in eng._prefix_cache.values())
    assert bp.in_use == parked == 2
    bp.check_invariants()
