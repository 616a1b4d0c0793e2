"""Parity of the port's MoE FFN (``repro_torch.models.moe``) with the
reference's ``repro.models.moe`` on the CPU: the same seeded numpy input
and weights through both, fp32 within 2e-5 and bf16 within 2e-2, with and
without dropped slots, the Switch aux loss, ties in the router broken
toward the lower expert index as ``lax.top_k`` does, and the capacity
rule. Also the converter on the MoE archs' reduced trees, bit for bit;
whole-model bf16 logits of granite-moe-1b-a400m; and the port's engines
against the reference's on granite, slotted and paged."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import obs as jobs
from repro.configs import get_config as jget
from repro.kvcache import init_kv_cache as jinit
from repro.models import dense as jd
from repro.models import moe as jm
from repro.models.model import build_model as jbuild_model
from repro.serving import engine as je
from repro_torch import obs as tobs
from repro_torch.configs import get_config as tget
from repro_torch.configs.base import MoEConfig
from repro_torch.convert import from_reference_params
from repro_torch.data.pipeline import CorpusSpec, synthesize_corpus
from repro_torch.kvcache import init_kv_cache as tinit
from repro_torch.models import dense as td
from repro_torch.models import moe as tm
from repro_torch.serving import engine as te
from torch_parity import TDT, assert_close, both, randn

CFG = MoEConfig(num_experts=4, top_k=2, capacity_factor=1.25)
KEY = jax.random.PRNGKey(0)


def _weights(d, f, E, dtype, seed=0):
    """The reference's leaves as (JAX dict, torch dict); router fp32."""
    ws = {"router": randn(seed, (d, E), d ** -0.5),
          "e_gate": randn(seed + 1, (E, d, f), d ** -0.5),
          "e_up": randn(seed + 2, (E, d, f), d ** -0.5),
          "e_down": randn(seed + 3, (E, f, d), f ** -0.5)}
    pairs = {k: both(v, "float32" if k == "router" else dtype)
             for k, v in ws.items()}
    return ({k: a for k, (a, _) in pairs.items()},
            {k: b for k, (_, b) in pairs.items()})


def _kept(x, router, capacity):
    """How many of the T*K slots the dispatch keeps."""
    probs = torch.softmax(x.float() @ router, -1)
    ids = tm.top_k(probs, CFG.top_k)[1].reshape(-1)
    onehot = torch.nn.functional.one_hot(ids, CFG.num_experts)
    pos = ((onehot.cumsum(0) - 1) * onehot).sum(1)
    return int((pos < capacity).sum())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("capacity", [None, 8, 48],
                         ids=["default", "drops", "no-drops"])
def test_moe_ffn_matches_reference(dtype, capacity):
    T, d, f = 24, 32, 48
    xj, xt = both(randn(10, (T, d)), dtype)
    pj, pt = _weights(d, f, CFG.num_experts, dtype)
    yj, auxj = jm.moe_ffn(xj, pj, CFG, capacity=capacity)
    yt, auxt = tm.moe_ffn(xt, pt, CFG, capacity=capacity)
    assert yt.dtype == TDT[dtype] and auxt.dtype == torch.float32
    assert_close(yt, yj, dtype)
    assert_close(auxt, auxj, tol=2e-5)
    cap = min(tm.moe_capacity(T, CFG) if capacity is None else capacity,
              T * CFG.top_k)
    kept = _kept(xt, pt["router"], cap)
    if capacity == 8:
        assert kept < T * CFG.top_k           # the case drops slots
    if capacity == 48:
        assert kept == T * CFG.top_k


def test_router_ties_pick_the_lower_expert():
    """Rows of zeros score every expert alike: both packages keep experts
    0 and 1 (``lax.top_k`` takes the lower index first), so the outputs
    agree on those rows too."""
    T, d, f = 8, 16, 24
    x = randn(11, (T, d))
    x[::2] = 0.0
    xj, xt = both(x)
    pj, pt = _weights(d, f, CFG.num_experts, "float32", seed=4)
    probs = torch.softmax(xt @ pt["router"], -1)
    ids = tm.top_k(probs, CFG.top_k)[1]
    np.testing.assert_array_equal(ids[::2].numpy(), [[0, 1]] * (T // 2))
    _, jids = jax.lax.top_k(jax.nn.softmax(xj @ pj["router"], -1), 2)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    yj, _ = jm.moe_ffn(xj, pj, CFG)
    yt, _ = tm.moe_ffn(xt, pt, CFG)
    assert_close(yt, yj)


def test_capacity_rule_matches_reference():
    for cfg in (CFG, dataclasses.replace(CFG, num_experts=32, top_k=8),
                dataclasses.replace(CFG, num_experts=128, top_k=2)):
        for T in (1, 7, 64, 256, 32768):
            assert tm.moe_capacity(T, cfg) == jm.moe_capacity(T, cfg)


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "arctic-480b"])
def test_convert_moe_tree_is_exact(arch):
    """Every leaf of the reduced bf16 tree, MoE leaves included (and
    Arctic's dense residual), arrives bit for bit; the router stays fp32."""
    jcfg, tcfg = (g(arch).reduced() for g in (jget, tget))
    assert jcfg.dtype == "bfloat16" and tcfg.moe.enabled
    pj = jd.init_params(jcfg, jax.random.PRNGKey(1))
    pt = from_reference_params(tcfg, jax.tree.map(np.asarray, pj))
    sd = pt.state_dict()
    groups = pj["layers"]
    assert ("mlp" in groups) == tcfg.moe.dense_residual
    assert len(sd) == len(jax.tree.leaves(pj)) - len(
        jax.tree.leaves(groups)) + tcfg.num_layers * len(
        jax.tree.leaves(groups))
    for i in range(tcfg.num_layers):
        for group, leaves in groups.items():
            for name, leaf in leaves.items():
                got = sd[f"layers.{i}.{group}.{name}"]
                want = np.asarray(leaf)[i]
                assert str(got.dtype)[6:] == str(want.dtype), (group, name)
                np.testing.assert_array_equal(got.float().numpy(),
                                              want.astype(np.float32))
    assert sd["layers.0.moe.router"].dtype == torch.float32
    assert sd["layers.0.moe.e_gate"].dtype == torch.bfloat16


def test_init_params_moe_scales():
    """The port's own init draws the MoE leaves with the reference's
    shapes, dtypes and scales (router fp32, 1/sqrt(fan_in))."""
    cfg = dataclasses.replace(tget("granite-moe-1b-a400m").reduced(),
                              num_layers=1)
    lp = td.init_params(cfg, torch.Generator().manual_seed(0)).layers[0]
    jlp = jax.eval_shape(lambda k: jd.init_params(
        dataclasses.replace(jget("granite-moe-1b-a400m").reduced(),
                            num_layers=1), k), jax.random.PRNGKey(0))
    assert not hasattr(lp, "mlp")
    for name, p in lp.moe.items():
        want = jlp["layers"]["moe"][name]
        assert tuple(p.shape) == tuple(want.shape[1:])
        assert str(p.dtype)[6:] == str(want.dtype)
        fan_in = p.shape[-2]
        assert abs(float(p.float().std()) * fan_in ** 0.5 - 1) < 0.1, name


def _cfgs(arch, dtype="float32"):
    return tuple(dataclasses.replace(get(arch).reduced(), dtype=dtype)
                 for get in (jget, tget))


def _close_logits(lt, lj, tol):
    """Whole-model logits within ``tol`` of the largest, greedy equal."""
    scale = float(np.abs(np.asarray(lj)).max())
    assert_close(lt, lj, tol=tol * max(scale, 1.0))
    np.testing.assert_array_equal(lt.argmax(-1).numpy(),
                                  np.asarray(lj).argmax(-1))


def test_bf16_moe_logits():
    """granite in bf16: both packages pick the same experts on this input,
    and the logits hold to 2e-2 of the largest with equal greedy tokens
    (bf16 rounds at other places in the two frameworks; a routing flip
    would move a row by a whole expert's output)."""
    jcfg, tcfg = _cfgs("granite-moe-1b-a400m", "bfloat16")
    pj = jd.init_params(jcfg, KEY)
    pt = from_reference_params(tcfg, jax.tree.map(np.asarray, pj))
    toks = np.random.default_rng(7).integers(
        0, jcfg.vocab_size, (2, 12)).astype(np.int32)
    cj = jinit(jcfg.num_layers, 2, 16, jcfg.num_kv_heads, jcfg.head_dim)
    ct = tinit(tcfg.num_layers, 2, 16, tcfg.num_kv_heads, tcfg.head_dim)
    lj, cj = jd.prefill(jcfg, pj, jnp.asarray(toks), cj)
    lt, ct = td.prefill(tcfg, pt, torch.from_numpy(toks).long(), ct)
    _close_logits(lt, lj, tol=2e-2)
    lj, _ = jd.decode_step(jcfg, pj, jnp.asarray(toks[:, -1]), cj)
    lt, _ = td.decode_step(tcfg, pt, torch.from_numpy(toks[:, -1]).long(), ct)
    _close_logits(lt, lj, tol=2e-2)


# ---------------------------------------------------------------------------
# engines
# ---------------------------------------------------------------------------

def _run(pkg, cfg, params, layout, requests, corpus, slots):
    obs_, eng_ = (jobs, je) if pkg == "jax" else (tobs, te)
    reg = obs_.MetricsRegistry()
    prev = obs_.set_registry(reg)
    try:
        eng = eng_.ServingEngine(cfg, params, eng_.EngineConfig(
            cache_dtype=jnp.float32 if pkg == "jax" else torch.float32,
            max_slots=slots, max_seq=64, kv_layout=layout, block_size=8))
        eng.register_corpus("c", corpus)
        for prompt, new in requests:
            eng.submit(prompt, max_new_tokens=new, corpus_id="c")
        return {r.uid: tuple(r.generated) for r in eng.run()}, reg
    finally:
        obs_.set_registry(prev)


def test_moe_engines_equal_reference_engines():
    """granite-moe-1b-a400m ``.reduced()`` in fp32 on 24 slots, a stream of
    mixed lengths (free slots decode beside live ones): each port engine
    generates what the reference's engine of its layout generates, with
    the same counters. The two layouts need not agree with each other: a
    free slot's row holds other values in the two layouts, and it takes
    expert capacity ahead of the live rows after it (ROADMAP Queue 3)."""
    jcfg, tcfg = _cfgs("granite-moe-1b-a400m")
    pj = jbuild_model(jcfg).init(KEY)
    pt = from_reference_params(tcfg, jax.tree.map(np.asarray, pj))
    corpus = synthesize_corpus(CorpusSpec("c", 256, jcfg.vocab_size, seed=1))
    rng = np.random.default_rng(0)
    requests = [(rng.integers(0, jcfg.vocab_size,
                              int(rng.integers(3, 30))).tolist(),
                 int(rng.integers(2, 9))) for _ in range(40)]
    gens = {}
    for layout in ("slotted", "paged"):
        gj, rj = _run("jax", jcfg, pj, layout, requests, corpus, 24)
        gt, rt = _run("torch", tcfg, pt, layout, requests, corpus, 24)
        assert len(gt) == len(requests)
        assert gt == gj, layout
        for name in ("engine/decode_steps", "engine/prefills",
                     "engine/tokens_generated", "moska/dropped_queries"):
            assert rt.counter(name).value == rj.counter(name).value, name
        gens[layout] = gj
    same = sum(gens["slotted"][u] == gens["paged"][u] for u in gens["paged"])
    assert same < len(requests)        # the accounted difference shows here
