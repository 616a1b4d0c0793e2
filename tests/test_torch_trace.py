"""The port's spans on the CPU: the engine's phase spans of every wave
(always on) and the model step's layer spans (only while a profiler
runs), each span also a profiler range above the operations it ran; the
bounded span store; and a traced tiny benchmark cell in which every
reader of these spans reads a number."""
import collections
import dataclasses
import json
import sys
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import obs
from repro_torch.configs import get_config
from repro_torch.data.pipeline import CorpusSpec, synthesize_corpus
from repro_torch.models.model import build_model
from repro_torch.serving import engine as te

ROOT = Path(__file__).resolve().parent.parent
ENGINE = {"engine.run", "engine.wave", "engine.schedule", "engine.prefill",
          "engine.decode", "engine.readback", "engine.record", "engine.hooks",
          "engine.register_corpus"}
#: the model step's ranges, by model, with a store attached
LAYER = {"tinyllama-1.1b": {"layer", "layer.route", "layer.dispatch",
                            "layer.shared_attention", "layer.merge",
                            "layer.unique_attention", "layer.ffn",
                            "unembed"},
         "granite-moe-1b-a400m": {"layer", "layer.route", "layer.dispatch",
                                  "layer.shared_attention", "layer.merge",
                                  "layer.unique_attention", "moe_ffn",
                                  "unembed"}}
REQUESTS = [([3 + i] * (5 + 3 * i), 4) for i in range(5)]


@pytest.fixture(scope="module", params=sorted(LAYER))
def model(request):
    cfg = dataclasses.replace(get_config(request.param).reduced(),
                              dtype="float32")
    gen = torch.Generator().manual_seed(0)
    return request.param, cfg, build_model(cfg).init(gen, torch.device("cpu"))


def _serve(model, profiled=False, **ecfg):
    """The request stream over one corpus; returns (tokens by uid, the
    registry, the profile or None)."""
    _, cfg, params = model
    reg = obs.MetricsRegistry()
    prev = obs.set_registry(reg)
    try:
        eng = te.ServingEngine(cfg, params, te.EngineConfig(
            max_slots=3, max_seq=64, cache_dtype=torch.float32, **ecfg))
        eng.register_corpus("doc", synthesize_corpus(
            CorpusSpec("doc", 256, cfg.vocab_size, seed=1)))
        for prompt, new in REQUESTS:
            eng.submit(prompt, max_new_tokens=new, corpus_id="doc")
        prof = None
        if profiled:
            with profile(activities=[ProfilerActivity.CPU]) as prof:
                done = eng.run()
        else:
            done = eng.run()
        return {r.uid: tuple(r.generated) for r in done}, reg, prof
    finally:
        obs.set_registry(prev)


def test_no_profiler_no_layer_span(model):
    """Without a profiler a layer-span site returns the one shared null
    context and records nothing: only the engine's spans are kept."""
    assert obs.profiled_span("layer") is obs.profiled_span("layer.route")
    _, reg, _ = _serve(model)
    names = {s.name for s in reg.spans}
    assert names == ENGINE
    assert reg.counter("moska/decode/calls").value > 0


def _ancestors(e):
    p = e.cpu_parent
    while p is not None:
        yield p.name
        p = p.cpu_parent


def _nearest_range(e, ranges):
    return next((n for n in _ancestors(e) if n in ranges), None)


def test_profiled_ranges_nest_in_the_decode_and_hold_their_ops(model):
    name = model[0]
    _, reg, prof = _serve(model, profiled=True)
    events = prof.events()
    ranges = ENGINE | LAYER[name]
    in_decode = {e.name for e in events if e.name in LAYER[name]
                 and "engine.decode" in _ancestors(e)}
    assert in_decode == LAYER[name]
    seen = {e.name for e in events if e.name in ranges}
    assert seen == ranges - {"engine.register_corpus"}
    # each range holds its own code's operations (the MoE FFN runs a
    # one-hot, a cumsum and a sort of its own)
    moe = {"moe_ffn"} & LAYER[name]
    for op, rng in (("aten::one_hot", "layer.dispatch"),
                    ("aten::cumsum", "layer.dispatch"),
                    ("aten::sort", "layer.route")):
        found = {_nearest_range(e, ranges) for e in events if e.name == op
                 and "engine.decode" in _ancestors(e)}
        assert found == {rng} | moe, (op, found)
    # the dispatch's device recordings (a mean of its mask, two sums) are
    # queued outside its range, so its self time is the dispatch alone
    found = {_nearest_range(e, ranges) for e in events
             if e.name == "aten::mean" and "engine.decode" in _ancestors(e)}
    assert found and "layer.dispatch" not in found, found
    # the registry keeps the same nesting
    spans = list(reg.spans)
    assert {s.name for s in spans} == ranges
    for s in spans:
        if s.name == "layer":
            assert s.parent in ("engine.decode", "engine.prefill")
        elif s.name in LAYER[name] and s.name != "unembed":
            assert s.parent == "layer", (s.name, s.parent)


@pytest.mark.parametrize("layout", ["slotted", "paged"])
def test_prefill_spans_carry_the_request_and_its_queue_wait(model, layout):
    kw = dict(kv_layout="paged", block_size=16) if layout == "paged" else {}
    _, reg, _ = _serve(model, **kw)
    pre = [s for s in reg.spans if s.name == "engine.prefill"]
    assert sorted(s.attrs["uid"] for s in pre) == list(range(len(REQUESTS)))
    for s in pre:
        assert s.parent == "engine.wave"
        assert s.attrs["queued_s"] >= 0
        assert s.attrs["tokens"] == len(REQUESTS[s.attrs["uid"]][0])
        assert 0 <= s.attrs["slot"] < 3
    waves = [s for s in reg.spans if s.name == "engine.wave"]
    for phase in ("engine.schedule", "engine.decode", "engine.readback",
                  "engine.record", "engine.hooks"):
        kids = [s for s in reg.spans if s.name == phase]
        assert kids and all(s.parent == "engine.wave" for s in kids)
        assert len(kids) <= len(waves)


def test_requests_keep_their_submit_and_admission_times(model):
    _, cfg, params = model
    eng = te.ServingEngine(cfg, params, te.EngineConfig(
        max_slots=2, max_seq=64, cache_dtype=torch.float32))
    for prompt, new in REQUESTS:
        eng.submit(prompt, max_new_tokens=new)
    done = eng.run()
    assert len(done) == len(REQUESTS)
    for r in done:
        assert 0 < r.submitted_s <= r.admitted_s


def test_greedy_tokens_equal_with_spans_on_and_off(model):
    off, reg_off, _ = _serve(model)
    on, reg, _ = _serve(model, profiled=True)
    assert on == off
    assert any(s.name == "layer" for s in reg.spans)
    # the layer spans record spans only: no metric of their own
    assert reg.names() == reg_off.names()


def test_span_store_drops_its_oldest_at_capacity():
    reg = obs.MetricsRegistry()
    assert reg.spans.maxlen == obs.SPAN_CAPACITY
    reg.spans = collections.deque(maxlen=3)
    for i in range(5):
        with obs.span(f"s{i}", registry=reg, i=i):
            pass
    assert [s.name for s in reg.spans] == ["s2", "s3", "s4"]
    assert reg.histogram("span/s0/duration_s").count == 1
    back = obs.from_dict(obs.to_dict(reg))
    assert [(s.name, s.attrs) for s in back.spans] == \
        [(f"s{i}", {"i": i}) for i in (2, 3, 4)]


def test_a_span_closes_on_an_exception_and_keeps_its_nesting():
    reg = obs.MetricsRegistry()
    with pytest.raises(KeyError):
        with obs.span("outer", registry=reg):
            with obs.span("inner", registry=reg):
                raise KeyError("x")
    inner, outer = reg.spans
    assert (inner.name, inner.parent, inner.depth) == ("inner", "outer", 1)
    assert (outer.name, outer.parent, outer.depth) == ("outer", None, 0)
    assert outer.start_s <= inner.start_s <= inner.end_s <= outer.end_s
    assert obs.current_span() is None


# -- the benchmark's readers of these spans -------------------------------

NEW = ("queue_wait_ms", "decode_enqueue_ms", "wave_host_ms",
       "decode_host_ms.moska", "decode_host_ms.moe")


@pytest.mark.parametrize("cell,metrics", [
    ("coupled-store", ("queue_wait_ms", "decode_enqueue_ms", "wave_host_ms",
                       "decode_host_ms.moska")),
    ("moe-no-store", ("queue_wait_ms", "decode_enqueue_ms", "wave_host_ms",
                      "decode_host_ms.moe")),
])
def test_a_traced_tiny_cell_reads_every_new_metric(tmp_path, cell, metrics):
    if str(ROOT / "bench") not in sys.path:
        sys.path.insert(0, str(ROOT / "bench"))
    import run
    import test_bench_correctness as tb
    c = tb._cell(tmp_path, cell, **tb.CELLS[cell])
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    c.per_layer = [m for m in spec["per_layer"] if m["name"] in NEW]
    assert len(c.per_layer) == len(NEW)
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        res = run.run_cell(c, tb.SEED, 1.0, True, device="cpu")
    finally:
        torch.set_num_threads(threads)
    assert res["correct"] is True
    got = res["metrics"]
    for m in metrics:
        assert m in got and got[m]["value"] >= 0, (m, got)
    assert got["decode_enqueue_ms"]["value"] > 0
