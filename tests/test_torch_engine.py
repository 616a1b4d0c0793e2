"""The port's slotted serving engine against the reference's on the CPU:
on tinyllama-1.1b ``.reduced()`` in fp32, with the reference's weights
converted, both engines must generate the same greedy tokens on the same
request stream (one corpus, and corpora A and B interleaved), through the
same scheduler decisions. Also the launcher on the CPU."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import obs as jobs
from repro.configs import get_config as jget
from repro.models.model import build_model as jbuild_model
from repro.serving import engine as je
from repro_torch import obs as tobs
from repro_torch.configs import get_config as tget
from repro_torch.convert import from_reference_params
from repro_torch.data.pipeline import CorpusSpec, synthesize_corpus
from repro_torch.kernels import ops
from repro_torch.launch import serve
from repro_torch.serving import engine as te

KEY = jax.random.PRNGKey(0)


@pytest.fixture(scope="module")
def tiny():
    jcfg, tcfg = (dataclasses.replace(get("tinyllama-1.1b").reduced(),
                                      dtype="float32") for get in (jget, tget))
    pj = jbuild_model(jcfg).init(KEY)
    pt = from_reference_params(tcfg, jax.tree.map(np.asarray, pj))
    return jcfg, tcfg, pj, pt


def _run_jax(cfg, params, requests, corpora, **ecfg):
    reg = jobs.MetricsRegistry()
    prev = jobs.set_registry(reg)
    try:
        eng = je.ServingEngine(cfg, params, je.EngineConfig(
            cache_dtype=jnp.float32, **ecfg))
        for cid, toks in corpora:
            eng.register_corpus(cid, toks)
        for prompt, new, cid in requests:
            eng.submit(prompt, max_new_tokens=new, corpus_id=cid)
        return eng.run(), reg
    finally:
        jobs.set_registry(prev)


def _run_torch(cfg, params, requests, corpora, **ecfg):
    reg = tobs.MetricsRegistry()
    prev = tobs.set_registry(reg)
    try:
        eng = te.ServingEngine(cfg, params, te.EngineConfig(
            cache_dtype=torch.float32, **ecfg))
        for cid, toks in corpora:
            eng.register_corpus(cid, toks)
        for prompt, new, cid in requests:
            eng.submit(prompt, max_new_tokens=new, corpus_id=cid)
        return eng.run(), reg
    finally:
        tobs.set_registry(prev)


def _gen(done):
    return {r.uid: (r.slot, tuple(r.generated)) for r in done}


def _corpus(name, seed, vocab):
    return synthesize_corpus(CorpusSpec(name, 256, vocab, seed=seed))


STREAMS = {
    "one-corpus": [([3 + i] * (5 + 3 * i), 4, "laws") for i in range(5)],
    "mixed-corpus": [([1] * 6, 4, "A"), ([7, 8, 9, 10], 4, "B"),
                     ([2] * 6, 4, "A"), ([11, 12, 13], 4, "B"),
                     ([3] * 6, 4, "A"), (list(range(20, 40)), 6, "B")],
}


@pytest.mark.parametrize("stream", sorted(STREAMS))
@pytest.mark.parametrize("buckets", ["auto", None])
def test_greedy_tokens_equal_reference_engine(tiny, stream, buckets):
    jcfg, tcfg, pj, pt = tiny
    requests = STREAMS[stream]
    corpora = [(c, _corpus(c, i + 1, jcfg.vocab_size))
               for i, c in enumerate(sorted({r[2] for r in requests}))]
    ecfg = dict(max_slots=3, max_seq=64, prefill_buckets=buckets)
    done_j, reg_j = _run_jax(jcfg, pj, requests, corpora, **ecfg)
    done_t, reg_t = _run_torch(tcfg, pt, requests, corpora, **ecfg)
    assert len(done_t) == len(requests)
    assert _gen(done_t) == _gen(done_j)
    for name in ("engine/decode_steps", "engine/prefills",
                 "engine/tokens_generated", "engine/prefill_tokens",
                 "scheduler/affinity_hits", "moska/dispatched_queries",
                 "moska/dropped_queries", "moska/decode/calls"):
        assert reg_t.counter(name).value == reg_j.counter(name).value, name
    for name in ("engine/decode_cache_bytes", "engine/hbm_high_water_bytes"):
        assert reg_t.gauge(name).value == reg_j.gauge(name).value, name
    assert reg_t.gauge("engine/decode_cache_bytes_copied").value == 0


def test_bucket_resolution_matches_reference():
    for spec, max_seq in (("auto", 64), ("auto", 512), ("auto", 8),
                          (None, 64), ((), 64), ((64, 16, 16), 64),
                          ((256, 128), 512)):
        assert (te.resolve_prefill_buckets(spec, max_seq)
                == je.resolve_prefill_buckets(spec, max_seq))
    for spec in ("fast", (0,), (300,), (200,)):
        with pytest.raises(ValueError):
            te.resolve_prefill_buckets(spec, 256)
    for n in (1, 16, 17, 200, 600):
        b = te.resolve_prefill_buckets("auto", 512)
        assert te.bucket_for(b, n) == je.bucket_for(b, n)
    assert te.bucket_for(None, 37) == 37


def test_persistent_cache_in_place_and_slot_reuse(tiny):
    """The batch cache is one allocation written in place across run()
    calls, and a reused slot decodes what a fresh engine decodes."""
    _, cfg, _, params = tiny
    corpus = _corpus("laws", 1, cfg.vocab_size)
    eng = te.ServingEngine(cfg, params, te.EngineConfig(
        max_slots=2, max_seq=64, cache_dtype=torch.float32))
    eng.register_corpus("laws", corpus)
    eng.submit([9] * 40, max_new_tokens=4, corpus_id="laws")
    first = eng.run()
    ptr = eng._cache.k.data_ptr()
    eng.submit([4, 5, 6], max_new_tokens=5, corpus_id="laws")
    second = [r for r in eng.run() if r.uid != first[0].uid]
    assert eng._cache.k.data_ptr() == ptr
    fresh, _ = _run_torch(cfg, params, [([4, 5, 6], 5, "laws")],
                          [("laws", corpus)], max_slots=2, max_seq=64)
    assert tuple(second[0].generated) == tuple(fresh[0].generated)


def test_engine_rejects_and_raises(tiny):
    jcfg, cfg, pj, params = tiny
    # the reference's paged-layout validation: block_size must divide
    # max_seq, prefill_chunk must be block- and route-block-aligned
    for bad in (dict(block_size=24), dict(block_size=0),
                dict(prefill_chunk=24), dict(prefill_chunk=192)):
        ecfg = dict(max_slots=2, max_seq=64, kv_layout="paged", **bad)
        with pytest.raises(ValueError) as err_j:
            je.ServingEngine(jcfg, pj, je.EngineConfig(**ecfg))
        with pytest.raises(ValueError) as err_t:
            te.ServingEngine(cfg, params, te.EngineConfig(**ecfg))
        assert str(err_t.value) == str(err_j.value)
    with pytest.raises(ValueError):
        te.ServingEngine(cfg, params, te.EngineConfig(kv_layout="ring"))
    eng = te.ServingEngine(cfg, params, te.EngineConfig(max_slots=1,
                                                        max_seq=32))
    with pytest.raises(ValueError, match="shorter than one chunk"):
        eng.register_corpus("short", np.arange(10))
    with pytest.raises(KeyError):
        eng.submit([1, 2], max_new_tokens=2, corpus_id="nope")
    with pytest.raises(ValueError, match="max_new_tokens"):
        eng.submit([1, 2, 3], max_new_tokens=0)
    starved = te.ServingEngine(cfg, params, te.EngineConfig(
        max_slots=2, max_seq=64, mem_budget_bytes=1.0))
    starved.submit([1, 2, 3], max_new_tokens=2)
    with pytest.raises(RuntimeError, match="livelock.*one slot's cost"):
        starved.run()
    # the paged layout charges blocks and refuses such a request up front
    starved = te.ServingEngine(cfg, params, te.EngineConfig(
        max_slots=2, max_seq=64, mem_budget_bytes=1.0, kv_layout="paged"))
    with pytest.raises(ValueError, match="block budget"):
        starved.submit([1, 2, 3], max_new_tokens=2)


def test_serve_cli_on_cpu(tmp_path):
    out = tmp_path / "metrics.json"
    prev = tobs.set_registry(tobs.MetricsRegistry())
    try:
        summary = serve.main(["--device", "cpu", "--requests", "3",
                              "--new-tokens", "3", "--metrics-out", str(out)])
    finally:
        tobs.set_registry(prev)
    assert summary["finished"] == 3 and summary["tokens"] == 9
    assert summary["device"] == "cpu"
    assert summary["decode_cache_bytes_copied"] == 0
    assert summary["kernel_launches"] == {k: 0 for k in ops.launch_counts()}
    dumped = tobs.load(str(out))
    assert dumped.counter("engine/decode_steps").value == \
        summary["decode_steps"]


def test_serve_cli_paged_on_cpu():
    """The launcher's paged layout generates what its slotted layout
    generates (same seed, same requests) and reports the paged counters."""
    out = {}
    for layout in ("slotted", "paged"):
        prev = tobs.set_registry(tobs.MetricsRegistry())
        try:
            out[layout] = serve.main(["--device", "cpu", "--requests", "3",
                                      "--new-tokens", "3", "--kv-layout",
                                      layout, "--block-size", "8"])
        finally:
            tobs.set_registry(prev)
    paged, slotted = out["paged"], out["slotted"]
    assert paged["kv_layout"] == "paged"
    assert paged["tokens"] == slotted["tokens"] == 9
    assert paged["wave"] == slotted["wave"]
    assert paged["hbm_high_water_bytes"] < slotted["hbm_high_water_bytes"]
    for key in ("prefix_hits", "cow_copies", "blocks_appended",
                "pool_growths", "chunked_prefills", "block_capacity"):
        assert isinstance(paged[key], int), key
    assert paged["kernel_launches"] == {k: 0 for k in ops.launch_counts()}


def test_serve_cli_rejects_missing_card_and_short_corpus():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(SystemExit):
        serve.main(["--device", "cuda"])
    with pytest.raises(SystemExit):
        serve.main(["--device", "cpu", "--full", "--corpus-tokens", "512"])
