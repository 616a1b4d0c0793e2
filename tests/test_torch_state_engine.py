"""The port's slotted serving engine on the state families against the
reference's, on the CPU at ``.reduced()`` in fp32 with the reference's
weights converted: mamba2-130m and recurrentgemma-9b serve a stream of
mixed prompt lengths on 3 slots (slots reused) with the same greedy
tokens and counters as the reference engine. The slot write against its
full-copy oracle, and the refusals: the paged layout for every
non-dense family, ``register_corpus`` for the state families, the
engine for whisper-tiny, and the launcher at registration."""
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
from repro_torch.launch import serve
from repro_torch.models.model import build_model as tbuild_model
from repro_torch.serving import engine as te

# prompt lengths and new tokens: slot reuse on 3 slots, a prompt past the
# hybrid's 64-key window; the hybrid also takes prompts of 1 and 2 tokens
# (its conv tail is zero-padded in both packages; the reference's SSM
# leaves a short tail there, ROADMAP Queue 3)
STREAMS = {"mamba2-130m": [(5, 4), (3, 3), (70, 5), (4, 6), (33, 4),
                           (9, 3)],
           "recurrentgemma-9b": [(5, 4), (1, 3), (70, 5), (2, 6), (33, 4),
                                 (9, 3)]}


@pytest.fixture(scope="module", params=sorted(STREAMS))
def served(request):
    arch = request.param
    jcfg, tcfg = (dataclasses.replace(get(arch).reduced(), dtype="float32")
                  for get in (jget, tget))
    pj = jbuild_model(jcfg).init(jax.random.PRNGKey(0))
    pt = from_reference_params(tcfg, jax.tree.map(np.asarray, pj))
    return arch, jcfg, tcfg, pj, pt


def _requests(arch):
    g = np.random.default_rng(0)
    return [(g.integers(0, 512, n).tolist(), new) for n, new in STREAMS[arch]]


def _serve(mod, registry_mod, cfg, params, requests, dtype):
    reg = registry_mod.MetricsRegistry()
    prev = registry_mod.set_registry(reg)
    try:
        eng = mod.ServingEngine(cfg, params, mod.EngineConfig(
            max_slots=3, max_seq=96, cache_dtype=dtype))
        for prompt, new in requests:
            eng.submit(prompt, max_new_tokens=new)
        done = {r.uid: (r.slot, tuple(r.generated)) for r in eng.run()}
        return done, reg, eng
    finally:
        registry_mod.set_registry(prev)


def test_greedy_tokens_equal_reference_engine(served):
    arch, jcfg, tcfg, pj, pt = served
    requests = _requests(arch)
    done_j, reg_j, _ = _serve(je, jobs, jcfg, pj, requests, jnp.float32)
    done_t, reg_t, eng = _serve(te, tobs, tcfg, pt, requests, torch.float32)
    assert len(done_t) == len(requests)
    assert done_t == done_j
    for name in ("engine/decode_steps", "engine/prefills",
                 "engine/tokens_generated", "engine/prefill_tokens",
                 "engine/decoded_tokens"):
        assert reg_t.counter(name).value == reg_j.counter(name).value, name
    for name in ("engine/decode_cache_bytes", "engine/hbm_high_water_bytes"):
        assert reg_t.gauge(name).value == reg_j.gauge(name).value, name
    assert isinstance(eng._cache, dict)
    assert reg_t.gauge("engine/decode_cache_bytes_copied").value == 0


def test_write_slot_state_matches_merge_oracle(served):
    """The in-place slot write equals the full-copy merge: on an (L, B, S,
    ...) state whose source is shorter than the slot, and on the served
    family's own state dict."""
    _, _, tcfg, _, _ = served
    g = np.random.default_rng(0)
    cache = {"state": torch.from_numpy(g.normal(size=(2, 3, 8, 4))).float(),
             "length": torch.zeros(3, dtype=torch.int32)}
    slot = {"state": torch.from_numpy(g.normal(size=(2, 1, 5, 4))).float(),
            "length": torch.tensor([5], dtype=torch.int32)}
    model = tbuild_model(tcfg)
    big = model.init_cache(3, 16, torch.float32)
    one = model.init_cache(1, 16, torch.float32)
    for name, t in one.items():
        t.copy_(torch.from_numpy(g.integers(1, 9, t.shape)).to(t.dtype))
    for dst, src in ((cache, slot), (big, one)):
        want = te._merge_slot_cache(dst, src, 1)
        te.write_slot_state(dst, src, 1)
        for name in dst:
            assert torch.equal(dst[name], want[name]), name


def test_non_dense_families_refused():
    """Paged: every non-dense family (the reference's message); the state
    families' ``register_corpus`` and whisper's engine: a
    ``NotImplementedError`` naming the family, before any work."""
    for arch in ("mamba2-130m", "recurrentgemma-9b"):
        cfg = dataclasses.replace(tget(arch).reduced(), dtype="float32")
        params = tbuild_model(cfg).init(torch.Generator().manual_seed(0))
        with pytest.raises(NotImplementedError, match="slotted"):
            te.ServingEngine(cfg, params, te.EngineConfig(
                max_slots=2, max_seq=64, kv_layout="paged"))
        eng = te.ServingEngine(cfg, params, te.EngineConfig(max_slots=2,
                                                            max_seq=64))
        with pytest.raises(NotImplementedError, match=cfg.family):
            eng.register_corpus("c", np.arange(128))
        assert not eng.stores
    cfg = tget("whisper-tiny").reduced()
    params = tbuild_model(cfg).init(torch.Generator().manual_seed(0))
    for layout in ("slotted", "paged"):
        with pytest.raises(NotImplementedError, match=cfg.family):
            te.ServingEngine(cfg, params, te.EngineConfig(kv_layout=layout))


@pytest.mark.parametrize("arch", ["mamba2-130m", "whisper-tiny"])
def test_serve_cli_stops_at_registration(arch):
    with pytest.raises(NotImplementedError, match="register_corpus|frames"):
        serve.main(["--arch", arch, "--device", "cpu", "--requests", "2"])
