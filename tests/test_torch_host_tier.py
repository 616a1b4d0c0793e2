"""The port's host memory tier and async serving pipeline against the
reference's, on the CPU.

Host side: ``HostBlockPool`` and ``PrefetchEngine`` walks (offload, fetch,
peek, refresh, LRU evictions and rejects; issue, take, discard, sweep
under host churn) must leave both packages in the same states.
``extract_blocks`` / ``insert_blocks`` must round-trip pages bit for bit
and equal the reference's. Engine: the ``offload_vs_rebuild`` and
``overlap_vs_sync`` scenarios of ``benchmarks/bench_serving.py`` and the
stale-prefetch stream of ``tests/test_async_serving.py`` must give the
JAX engine's greedy tokens and host-tier counters. The launchers resolve
``--host-pool-blocks auto`` to the same number, and a decode step with a
sliding window equals the reference's within 2e-5 (fp32), slotted and
paged."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import obs as jobs
from repro.configs import get_config as jget
from repro.core.shared_kv import build_store as jbuild
from repro.kvcache import cache as jcache
from repro.kvcache import paged as jpg
from repro.kvcache import transfer as jtr
from repro.launch import serve as jserve
from repro.models import dense as jd
from repro.models.model import build_model as jbuild_model
from repro.serving import engine as je
from repro_torch import obs as tobs
from repro_torch.configs import get_config as tget
from repro_torch.convert import from_reference_params
from repro_torch.core.shared_kv import build_store as tbuild
from repro_torch.kernels import ops
from repro_torch.kvcache import cache as tcache
from repro_torch.kvcache import paged as tpg
from repro_torch.kvcache import transfer as ttr
from repro_torch.launch import serve as tserve
from repro_torch.models import dense as td
from repro_torch.serving import engine as te
from torch_parity import assert_close, both, randn, to_np

L, BS, KH, D = 2, 4, 2, 8


def _exact(a, b):
    np.testing.assert_array_equal(to_np(a), to_np(b))


def _pages(seed, nb, dtype="float32"):
    """(L, nb, bs, KH, D) k and v pages of both packages, equal values."""
    return (both(randn(seed, (L, nb, BS, KH, D)), dtype),
            both(randn(seed + 1, (L, nb, BS, KH, D)), dtype))


def _same_entry(got, want):
    if want is None:
        assert got is None
        return
    for name in ("first", "gens", "blocks"):
        assert got[name] == want[name], name
    _exact(got["k"], want["k"])
    _exact(got["v"], want["v"])


# ---------------------------------------------------------------------------
# host side: the host pool and the prefetch engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("capacity,seed", [(8, 0), (3, 1), (12, 2)])
def test_host_block_pool_walk_matches_reference(capacity, seed):
    """offload (fitting, evicting, refreshing, empty, wider than the pool)
    / fetch / peek / touch: the same results and states in both pools."""
    hj, ht = jpg.HostBlockPool(capacity), tpg.HostBlockPool(capacity)
    rng = np.random.default_rng(seed)
    for step in range(120):
        op = int(rng.integers(0, 4))
        key = ("fp", (int(rng.integers(0, 6)),))
        if op == 0:
            nb = int(rng.integers(0, capacity + 2))
            (kj, kt), (vj, vt) = _pages(step, nb)
            gens = [(int(b), step) for b in rng.integers(1, 50, nb)]
            first = int(rng.integers(0, 100))
            assert ht.offload(key, kt, vt, first, gens) == \
                hj.offload(key, kj, vj, first, gens)
        elif op == 1:
            _same_entry(ht.fetch(key), hj.fetch(key))
        elif op == 2:
            _same_entry(ht.peek(key), hj.peek(key))
        else:
            assert ht.touch(key) == hj.touch(key)
        assert ht.keys() == hj.keys()
        for name in ("used_blocks", "num_entries", "offloads", "evictions",
                     "rejected"):
            assert getattr(ht, name) == getattr(hj, name), name
        ht.check_invariants()
    assert ht.evictions > 0 and ht.rejected > 0
    with pytest.raises(ValueError):
        tpg.HostBlockPool(-1)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_extract_insert_round_trip_matches_reference(dtype):
    """Pages gathered out of a pool, through the host tier, and written
    back at other ids: bit for bit within the port, and the reference's
    values."""
    N = 10
    (kj, kt), (vj, vt) = (both(randn(s, (L, N, BS, KH, D)), dtype)
                          for s in (3, 4))
    pj, pt = jpg.PagedKVCache(kj, vj), tpg.PagedKVCache(kt, vt)
    src, dst = [4, 1, 7], [2, 9, 5]
    ej, et = jpg.extract_blocks(pj, src), tpg.extract_blocks(pt, src)
    for a, b in zip(et, ej):
        _exact(a, b)
    host = tpg.HostBlockPool(8)
    host.offload("key", *et, first=3, gens=[(b, 1) for b in src])
    entry = host.fetch("key")
    assert entry["ready"] is None and entry["k"].data_ptr() != \
        et[0].data_ptr()
    ptr = pt.k.data_ptr()
    tpg.insert_blocks(pt, dst, entry["k"], entry["v"])
    assert pt.k.data_ptr() == ptr                     # in place
    pj = jpg.insert_blocks(pj, jnp.asarray(dst, jnp.int32), *ej)
    assert torch.equal(pt.k[:, dst], pt.k[:, src])
    assert torch.equal(pt.v[:, dst], pt.v[:, src])
    _exact(pt.k, pj.k)
    _exact(pt.v, pj.v)


def test_prefetch_engine_walk_matches_reference():
    """issue / take / discard / sweep against a host tier that churns
    (entries evicted, keys re-offloaded with new generations): the same
    results, states and accounting in both packages, and
    ``resolved + discarded + in_flight == issued`` after every step."""
    hj, ht = jpg.HostBlockPool(6), tpg.HostBlockPool(6)
    fj, ft = jtr.PrefetchEngine(hj, 2), ttr.PrefetchEngine(ht, 2)
    rng = np.random.default_rng(4)
    for step in range(150):
        op = int(rng.integers(0, 6))
        key = ("fp", (int(rng.integers(0, 5)),))
        if op <= 1:                         # host churn: (re-)offload
            nb = int(rng.integers(1, 4))
            (kj, kt), (vj, vt) = _pages(100 + step, nb)
            gens = [(b, step) for b in range(nb)]
            assert ht.offload(key, kt, vt, step, gens) == \
                hj.offload(key, kj, vj, step, gens)
        elif op == 2:
            assert ft.issue(key) == fj.issue(key)
        elif op == 3:
            _same_entry(ft.take(key), fj.take(key))
        elif op == 4:
            assert ft.sweep() == fj.sweep()
        else:
            assert ft.discard(key) == fj.discard(key)
        assert ft.keys() == fj.keys()
        for name in ("in_flight", "issued", "resolved", "discarded"):
            assert getattr(ft, name) == getattr(fj, name), name
        ft.check_invariants()
        assert ft.resolved + ft.discarded + ft.in_flight == ft.issued
    assert ft.discarded > 0 and ft.resolved > 0
    assert ft.clear() == fj.clear()
    ft.check_invariants()
    with pytest.raises(ValueError):
        ttr.PrefetchEngine(ht, -1)


# ---------------------------------------------------------------------------
# the engine against the reference's
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny():
    jcfg, tcfg = (dataclasses.replace(get("tinyllama-1.1b").reduced(),
                                      dtype="float32") for get in (jget, tget))
    pj = jbuild_model(jcfg).init(jax.random.PRNGKey(0))
    pt = from_reference_params(tcfg, jax.tree.map(np.asarray, pj))
    return jcfg, tcfg, pj, pt


def _passes(engine_mod, obs_mod, cfg, params, prompts, passes=2,
            reverse_odd=False, max_new=4, **ecfg):
    """``passes`` runs of ``prompts`` on one fresh engine and registry (the
    odd passes reversed with ``reverse_odd``); returns ((pass, prompt) ->
    tokens, registry, engine)."""
    reg = obs_mod.MetricsRegistry()
    prev = obs_mod.set_registry(reg)
    try:
        eng = engine_mod.ServingEngine(cfg, params, engine_mod.EngineConfig(
            max_slots=2, max_seq=64, kv_layout="paged", block_size=16,
            **ecfg))
        gens = {}
        for i in range(passes):
            for p in (prompts[::-1] if reverse_odd and i % 2 else prompts):
                eng.submit(p, max_new_tokens=max_new)
            for r in eng.run():
                gens[(i, tuple(r.prompt))] = tuple(r.generated)
            eng.scheduler.finished.clear()
        return gens, reg, eng
    finally:
        obs_mod.set_registry(prev)


def _both(tiny, prompts, **kw):
    """The same stream on the JAX engine and on the port's (fp32 caches):
    their generations must be equal. Returns (generations, JAX registry,
    port registry, port engine)."""
    jcfg, tcfg, pj, pt = tiny
    gen_j, reg_j, _ = _passes(je, jobs, jcfg, pj, prompts,
                              cache_dtype=jnp.float32, **kw)
    gen_t, reg_t, eng = _passes(te, tobs, tcfg, pt, prompts,
                                cache_dtype=torch.float32, **kw)
    assert gen_t == gen_j
    eng._block_pool.check_invariants()
    eng._host_pool.check_invariants()
    return gen_t, reg_j, reg_t, eng


def _same_counters(reg_t, reg_j, names):
    for name in names:
        assert reg_t.counter(name).value == reg_j.counter(name).value, name


COLD = [[20 + i] * 8 for i in range(6)]
TIER_COUNTERS = ("engine/prefill_tokens", "engine/prefills",
                 "kvcache/swap_in_hits", "kvcache/swap_in_bytes",
                 "kvcache/offloads", "kvcache/offload_bytes",
                 "kvcache/host_pool_evictions", "kvcache/host_pool_misses",
                 "kvcache/prefix_evictions", "kvcache/prefix_hits",
                 "kvcache/blocks_appended")
ASYNC_COUNTERS = ("kvcache/prefetch_issued", "kvcache/prefetch_hits",
                  "kvcache/prefetch_wasted", "kvcache/spec_pages_alloc",
                  "kvcache/spec_pages_reclaimed", "kvcache/swap_in_hits")


def test_offload_vs_rebuild_matches_reference(tiny):
    """``bench_serving.py``'s offload_vs_rebuild: a 3-usable-block pool
    evicts every parked prefix between passes. With a 16-block host tier
    pass 2 swaps all 6 prefixes back (48 prefill tokens in all); without
    it every one is rebuilt (96); the generations are the same, and both
    packages agree on every counter."""
    got = {}
    for name, host in (("swap_in", 16), ("rebuild", 0)):
        gens, reg_j, reg_t, _ = _both(tiny, COLD, num_blocks=4,
                                      host_pool_blocks=host)
        _same_counters(reg_t, reg_j, TIER_COUNTERS)
        got[name] = (gens, {n: reg_t.counter(n).value
                            for n in TIER_COUNTERS})
    assert got["swap_in"][0] == got["rebuild"][0]
    swap, rebuild = got["swap_in"][1], got["rebuild"][1]
    assert swap["engine/prefill_tokens"] == 48
    assert rebuild["engine/prefill_tokens"] == 96
    assert swap["kvcache/swap_in_hits"] == 6
    assert swap["kvcache/offload_bytes"] > 0
    assert rebuild["kvcache/offload_bytes"] == 0
    assert all(n == 0 for n in ops.launch_counts().values())


def test_overlap_vs_sync_matches_reference(tiny):
    """``bench_serving.py``'s overlap_vs_sync: the same cold stream with
    the async pipeline on (defaults) and off. Identical generations, at
    least one prefetch hit with it on and no async counter with it off,
    and both packages agree on the prefetch and speculation counters."""
    got = {}
    for name, on in (("overlap", True), ("sync", False)):
        gens, reg_j, reg_t, eng = _both(
            tiny, COLD, num_blocks=4, host_pool_blocks=16,
            prefetch_depth=2 if on else 0, spec_append=on, overlap_waves=on)
        _same_counters(reg_t, reg_j, ASYNC_COUNTERS + TIER_COUNTERS)
        for hist in ("engine/decode_stall_s", "engine/overlap_saved_s"):
            assert reg_t.histogram(hist).count == \
                reg_j.histogram(hist).count, hist
        got[name] = (gens, reg_t)
        if on:
            eng._prefetch.check_invariants()
            assert not eng._spec_pending
    assert got["overlap"][0] == got["sync"][0]
    on, off = got["overlap"][1], got["sync"][1]
    assert on.counter("kvcache/prefetch_hits").value >= 1
    assert on.counter("kvcache/prefetch_hits").value <= \
        on.counter("kvcache/swap_in_hits").value
    assert on.histogram("engine/overlap_saved_s").count >= 1
    assert off.counter("kvcache/prefetch_issued").value == 0
    assert off.histogram("engine/overlap_saved_s").count == 0


def test_prefetch_stale_discard_matches_reference(tiny):
    """``test_async_serving.py``'s churn stream: a one-block host tier and
    a reversed second pass evict entries between issue and admission, so
    transfers go stale and are discarded (counted wasted). Generations
    equal the synchronous engine's and the JAX engine's; the prefetch
    accounting is conserved and equal in both packages."""
    prompts = [[30 + i] * 8 for i in range(4)]
    kw = dict(reverse_odd=True, num_blocks=4, host_pool_blocks=1)
    gens, reg_j, reg_t, eng = _both(tiny, prompts, **kw)
    _same_counters(reg_t, reg_j, ASYNC_COUNTERS + TIER_COUNTERS)
    _, tcfg, _, pt = tiny
    sync, _, _ = _passes(te, tobs, tcfg, pt, prompts, prefetch_depth=0,
                         spec_append=False, overlap_waves=False,
                         cache_dtype=torch.float32, **kw)
    assert gens == sync
    pf = eng._prefetch
    pf.check_invariants()
    assert pf.resolved + pf.discarded + pf.in_flight == pf.issued
    assert reg_t.counter("kvcache/prefetch_hits").value + \
        reg_t.counter("kvcache/prefetch_wasted").value + pf.in_flight == \
        reg_t.counter("kvcache/prefetch_issued").value


def test_slotted_rejects_host_pool_blocks(tiny):
    _, tcfg, _, pt = tiny
    with pytest.raises(ValueError, match="host_pool_blocks requires"):
        te.ServingEngine(tcfg, pt, te.EngineConfig(host_pool_blocks=4))


class _Built(Exception):
    """Raised by a stand-in engine: carries the launcher's EngineConfig."""


class _Capture:
    def __init__(self, cfg, params, ecfg):
        raise _Built(ecfg)


@pytest.mark.parametrize("argv", [
    ["--kv-layout", "paged", "--host-pool-blocks", "auto"],
    ["--kv-layout", "paged", "--num-blocks", "9", "--host-pool-blocks",
     "auto", "--requests", "20", "--prompt-len", "40"],
    ["--kv-layout", "paged", "--num-blocks", "400", "--host-pool-blocks",
     "auto"],
    ["--kv-layout", "paged", "--host-pool-blocks", "7", "--prefetch-depth",
     "0", "--no-spec-append", "--no-overlap"],
])
def test_launchers_resolve_host_flags_alike(monkeypatch, argv):
    """Both launchers turn the host-tier flags into the same EngineConfig
    fields (``auto`` through ``size_host_pool_blocks``); the engine is a
    stand-in, so nothing is served."""
    got = {}
    for name, mod in (("jax", jserve), ("torch", tserve)):
        monkeypatch.setattr(mod, "ServingEngine", _Capture)
        extra = ["--device", "cpu"] if name == "torch" else []
        with pytest.raises(_Built) as built:
            mod.main(argv + extra)
        ecfg = built.value.args[0]
        got[name] = tuple(getattr(ecfg, f) for f in (
            "host_pool_blocks", "prefetch_depth", "spec_append",
            "overlap_waves", "num_blocks"))
    assert got["torch"] == got["jax"]
    with pytest.raises(SystemExit):
        tserve.main(["--device", "cpu", "--host-pool-blocks", "auto"])


# ---------------------------------------------------------------------------
# the sliding window in the decode step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("with_store", [False, True])
def test_windowed_decode_step_matches_reference(tiny, with_store):
    """Reduced tinyllama with ``attn_window`` 6: one decode step over the
    same random cache (lengths below, at and past the window) in both
    packages, slotted and with the cache in scrambled pages, within 2e-5;
    the port's paged logits equal its slotted ones, and the window changes
    the logits."""
    jcfg, tcfg, pj, pt = tiny
    jw, tw = (dataclasses.replace(c, attn_window=6) for c in (jcfg, tcfg))
    B, S, bs = 3, 16, 4
    M = S // bs
    Lc, KHc, Dc = tcfg.num_layers, tcfg.num_kv_heads, tcfg.head_dim
    lens = np.array([3, 6, 13], np.int32)          # the step appends one
    start = 0
    sj = st = None
    if with_store:
        n, C = 2 * tcfg.moska.chunk_size, tcfg.moska.chunk_size
        sk, sv = randn(7, (Lc, n, KHc, Dc)), randn(8, (Lc, n, KHc, Dc))
        sj = jbuild(jnp.asarray(sk), jnp.asarray(sv), C)
        st = tbuild(torch.from_numpy(sk), torch.from_numpy(sv), C)
        start = n
    k, v = randn(5, (Lc, B, S, KHc, Dc)), randn(6, (Lc, B, S, KHc, Dc))
    offs = np.full((B,), start, np.int32)
    cj = jcache.KVCache(*(jnp.asarray(a) for a in (k, v, lens, offs)))

    def ct():
        return tcache.KVCache(*(torch.from_numpy(a.copy())
                                for a in (k, v, lens, offs)))

    tok = np.array([5, 17, 2], np.int32)
    tt = torch.from_numpy(tok).long()
    table = (np.random.default_rng(3).permutation(B * M) + 1).reshape(B, M)
    pool = np.zeros((2, Lc, 1 + B * M, bs, KHc, Dc), np.float32)
    for b in range(B):
        for m in range(M):
            pool[0, :, table[b, m]] = k[:, b, m * bs:(m + 1) * bs]
            pool[1, :, table[b, m]] = v[:, b, m * bs:(m + 1) * bs]
    pj_ = jpg.PagedKVCache(jnp.asarray(pool[0]), jnp.asarray(pool[1]))
    pt_ = tpg.PagedKVCache(*(torch.from_numpy(pool[i].copy())
                             for i in range(2)))
    paged = [torch.from_numpy(a) for a in (table.astype(np.int32), lens,
                                           offs)]

    lj, _ = jd.decode_step(jw, pj, jnp.asarray(tok), cj, store=sj)
    ljp, _ = jd.decode_step_paged(jw, pj, jnp.asarray(tok), pj_,
                                  *(jnp.asarray(a.numpy()) for a in paged),
                                  store=sj)
    lt, _ = td.decode_step(tw, pt, tt, ct(), store=st)
    lp, _ = td.decode_step_paged(tw, pt, tt, pt_, *paged, store=st)
    unwindowed, _ = td.decode_step(tcfg, pt, tt, ct(), store=st)
    assert_close(lt, lj, tol=2e-5)
    assert_close(lp, ljp, tol=2e-5)
    assert torch.equal(lp, lt)
    assert not torch.allclose(unwindowed, lt, atol=1e-3)
