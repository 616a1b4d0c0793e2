"""The port's Griffin hybrid (``repro_torch.models.hybrid``,
recurrentgemma-9b) against the reference on the CPU, at ``.reduced()``
(one cycle of (rglru, rglru, attn), window 64), and at five layers (a
cycle and a tail of two recurrent layers): the config, the converted
superblock and tail weights bit for bit, prefill and decode logits (fp32
within 1e-4 of the largest logit with equal greedy tokens, bf16 within
2e-2) with a prefill longer than the window (the ring wraps), a decode
that crosses the window, prompts of 1 and 2 tokens (the conv tail's
zero pad), the RG-LRU scan at S = 1 and past it, and the port's own
prefill-then-decode consistency."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.models import hybrid as jhy
from repro.models.model import build_model as jbuild_model
from repro_torch.configs import get_config as tget
from repro_torch.convert import from_reference_params
from repro_torch.models import hybrid as thy
from repro_torch.models.model import build_model as tbuild_model
from torch_parity import (assert_close, assert_converted_exactly,
                          close_logits, randn)

ARCH = "recurrentgemma-9b"
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
MODELS = {"reduced": ("float32", {}), "tail": ("float32", {"num_layers": 5}),
          "bf16": ("bfloat16", {})}


def _cfgs(dtype="float32", **kw):
    return tuple(dataclasses.replace(get(ARCH).reduced(), dtype=dtype, **kw)
                 for get in (jget, tget))


@pytest.fixture(scope="module", params=sorted(MODELS))
def model(request):
    dtype, kw = MODELS[request.param]
    jcfg, tcfg = _cfgs(dtype, **kw)
    pj = jbuild_model(jcfg).init(jax.random.PRNGKey(0))
    pt = from_reference_params(tcfg, jax.tree.map(np.asarray, pj))
    return dtype, jcfg, tcfg, pj, pt


@pytest.fixture(scope="module")
def fp32():
    jcfg, tcfg = _cfgs()
    pj = jbuild_model(jcfg).init(jax.random.PRNGKey(2))
    pt = from_reference_params(tcfg, jax.tree.map(np.asarray, pj))
    return "float32", jcfg, tcfg, pj, pt


def _tokens(seed, shape, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


def _run(model, S, steps, B=2):
    """Prefill B prompts of S tokens in both packages, then ``steps``
    greedy decode steps; logits compared at every step, and the caches
    (ring positions exactly) at the end."""
    dtype, jcfg, tcfg, pj, pt = model
    toks = _tokens(S, (B, S))
    cj = jhy.init_cache(jcfg, B, S + steps, JDT[dtype])
    ct = thy.init_cache(tcfg, B, S + steps, TDT[dtype])
    lj, cj = jax.jit(lambda p, t, c: jhy.prefill(jcfg, p, t, c))(
        pj, jnp.asarray(toks), cj)
    lt, ct2 = thy.prefill(tcfg, pt, torch.from_numpy(toks).long(), ct)
    assert ct2 is ct
    close_logits(lt, lj, TOL[dtype])
    jdecode = jax.jit(lambda p, t, c: jhy.decode_step(jcfg, p, t, c))
    for _ in range(steps):
        nt = lt.argmax(-1)
        lj, cj = jdecode(pj, jnp.asarray(nt.numpy()), cj)
        lt, ct = thy.decode_step(tcfg, pt, nt, ct)
        close_logits(lt, lj, TOL[dtype])
    for name in ("ring_pos", "length"):
        np.testing.assert_array_equal(ct[name].numpy(), np.asarray(cj[name]))
    if dtype == "float32":
        for name in ("ring_k", "ring_v", "lru", "conv"):
            assert_close(ct[name], cj[name], tol=1e-4)
    return ct


def test_config_equals_reference():
    for j, t in ((jget(ARCH), tget(ARCH)),
                 (jget(ARCH).reduced(), tget(ARCH).reduced())):
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert tget(ARCH).num_attention_layers == 12
    assert thy._layout(tget(ARCH)) == (12, ("rglru", "rglru"))


def test_convert_is_exact(model):
    _, _, tcfg, pj, pt = model
    assert_converted_exactly(pt, pj)
    assert len(pt["tail"]) == tcfg.num_layers % 3


def test_prefill_past_the_window(model):
    """80 prompt tokens over a 64-key window: the prefill's ring holds the
    last 64 and has wrapped; three decode steps."""
    ct = _run(model, 80, 3)
    assert int(ct["ring_pos"].min()) == 80 + 3 - 64


def test_decode_crosses_the_window(fp32):
    """A 60-token prefill and 8 decode steps: the ring fills, then wraps."""
    _run(fp32, 60, 8)


@pytest.mark.parametrize("S", [1, 2])
def test_short_prompts(fp32, S):
    """A conv tail of 1 or 2 rows, left-padded with zeros to 3."""
    ct = _run(fp32, S, 3)
    assert bool((ct["ring_pos"] < 0).any())


@pytest.mark.parametrize("S", [1, 37])
def test_rglru_full_matches_reference(S):
    """The doubling scan against the reference's associative scan, fp32,
    from a nonzero initial state."""
    lw, B = 16, 2
    lp_np = {"lru_gate_w": randn(0, (lw, 2 * lw), 0.25),
             "lru_gate_b": randn(1, (2 * lw,), 0.1),
             "lru_a": randn(2, (lw,))}
    x, h0 = randn(3, (B, S, lw)), randn(4, (B, lw))
    yj, hj = jhy._rglru_full(jnp.asarray(x),
                             {k: jnp.asarray(v) for k, v in lp_np.items()},
                             jnp.asarray(h0))
    yt, ht = thy._rglru_full(torch.from_numpy(x),
                             {k: torch.from_numpy(v)
                              for k, v in lp_np.items()},
                             torch.from_numpy(h0))
    assert_close(yt, yj, tol=1e-5)
    assert_close(ht, hj, tol=1e-5)


def test_prefill_decode_consistency():
    """decode(prefill(S - 1), token S - 1) == prefill(S), as
    ``tests/test_arch_smoke.py`` holds the reference."""
    cfg = dataclasses.replace(tget(ARCH).reduced(), dtype="float32")
    model = tbuild_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    S = 12
    toks = torch.from_numpy(_tokens(5, (2, S))).long()
    c1 = model.init_cache(2, S + 4, torch.float32)
    model.prefill(params, toks[:, :S - 1], c1)
    ld, _ = model.decode_step(params, toks[:, S - 1], c1)
    lf, _ = model.prefill(params, toks,
                          model.init_cache(2, S + 4, torch.float32))
    torch.testing.assert_close(ld, lf, rtol=2e-3, atol=2e-3)
