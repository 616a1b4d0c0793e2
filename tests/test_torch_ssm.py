"""The port's Mamba-2 (``repro_torch.models.ssm``, mamba2-130m) against the
reference on the CPU, at ``.reduced()``: the config, the converted weights
bit for bit, prefill and decode logits (fp32 within 1e-4 of the largest
logit with equal greedy tokens, bf16 within 2e-2), the chunked SSD scan at
S below, at and past the chunk (the dt = 0 pad path), the shared-state
warm start tiled to the batch, and the port's own prefill-then-decode
consistency, also for prompts shorter than the conv's 3 taps of state."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.models import ssm as jssm
from repro.models.model import build_model as jbuild_model
from repro_torch.configs import get_config as tget
from repro_torch.convert import from_reference_params
from repro_torch.models import ssm as tssm
from repro_torch.models.model import build_model as tbuild_model
from torch_parity import (assert_close, assert_converted_exactly,
                          close_logits, randn)

ARCH = "mamba2-130m"
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def model(request):
    dtype = request.param
    jcfg, tcfg = (dataclasses.replace(get(ARCH).reduced(), dtype=dtype)
                  for get in (jget, tget))
    pj = jbuild_model(jcfg).init(jax.random.PRNGKey(0))
    pt = from_reference_params(tcfg, jax.tree.map(np.asarray, pj))
    return dtype, jcfg, tcfg, pj, pt


def _tokens(seed, shape, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


def test_config_equals_reference():
    for j, t in ((jget(ARCH), tget(ARCH)),
                 (jget(ARCH).reduced(), tget(ARCH).reduced())):
        assert dataclasses.asdict(t) == dataclasses.asdict(j)


def test_convert_is_exact(model):
    _, _, _, pj, pt = model
    assert_converted_exactly(pt, pj)


def test_prefill_and_decode_logits(model):
    """S = 40: one whole chunk of 32 and one padded; three decode steps;
    the states and conv tails as the reference's."""
    dtype, jcfg, tcfg, pj, pt = model
    B, S = 2, 40
    toks = _tokens(1, (B, S))
    cj = jssm.init_cache(jcfg, B, S + 4, JDT[dtype])
    ct = tssm.init_cache(tcfg, B, S + 4, TDT[dtype])
    lj, cj = jssm.prefill(jcfg, pj, jnp.asarray(toks), cj)
    lt, ct2 = tssm.prefill(tcfg, pt, torch.from_numpy(toks).long(), ct)
    assert ct2 is ct
    close_logits(lt, lj, TOL[dtype])
    for _ in range(3):
        nt = lt.argmax(-1)
        lj, cj = jssm.decode_step(jcfg, pj, jnp.asarray(nt.numpy()), cj)
        lt, ct = tssm.decode_step(tcfg, pt, nt, ct)
        close_logits(lt, lj, TOL[dtype])
    if dtype == "float32":
        for name in ("conv", "state"):
            assert_close(ct[name], cj[name], tol=1e-4)
    np.testing.assert_array_equal(ct["length"].numpy(),
                                  np.asarray(cj["length"]))


@pytest.mark.parametrize("S", [20, 32, 75])
def test_ssd_chunked_matches_reference(S):
    """fp32 scan of 8 heads at chunk 32: S below the chunk, one chunk, and
    two chunks and a padded third; from a nonzero initial state."""
    B, NH, P, N, chunk = 2, 8, 16, 12, 32
    x, Bm, Cm = (randn(s, shape) for s, shape in (
        (0, (B, S, NH, P)), (1, (B, S, N)), (2, (B, S, N))))
    dt = np.log1p(np.exp(randn(3, (B, S, NH)))).astype(np.float32)
    A = -np.linspace(0.5, 4.0, NH).astype(np.float32)
    h0 = randn(4, (B, NH, P, N), 0.5)
    yj, hj = jssm._ssd_chunked(*(jnp.asarray(a) for a in (x, dt, A, Bm, Cm,
                                                            h0)), chunk)
    yt, ht = tssm._ssd_chunked(*(torch.from_numpy(a) for a in (x, dt, A, Bm,
                                                               Cm, h0)),
                               chunk)
    assert tuple(yt.shape) == (B, S, NH, P)
    assert_close(yt, yj, tol=1e-4)
    assert_close(ht, hj, tol=1e-4)


def test_shared_state_warm_start_tiled():
    """The corpus' warm-start state (batch 1) tiled to B = 2 and fed to both
    packages' prefill; the port refuses the untiled state."""
    jcfg, tcfg = (dataclasses.replace(get(ARCH).reduced(), dtype="float32")
                  for get in (jget, tget))
    pj = jbuild_model(jcfg).init(jax.random.PRNGKey(1))
    pt = from_reference_params(tcfg, jax.tree.map(np.asarray, pj))
    corpus = _tokens(2, (1, 50))
    sj = jssm.shared_state(jcfg, pj, jnp.asarray(corpus))
    st = tssm.shared_state(tcfg, pt, torch.from_numpy(corpus).long())
    assert tuple(st["state"].shape[:2]) == (tcfg.num_layers, 1)
    assert_close(st["state"], sj["state"], tol=1e-4)
    B, S = 2, 10
    sj = {"state": jnp.tile(sj["state"], (1, B, 1, 1, 1))}
    st = {"state": st["state"].expand(-1, B, -1, -1, -1).contiguous()}
    toks = _tokens(3, (B, S))
    cj = jssm.init_cache(jcfg, B, S + 4, jnp.float32)
    ct = tssm.init_cache(tcfg, B, S + 4, torch.float32)
    lj, cj = jssm.prefill(jcfg, pj, jnp.asarray(toks), cj, store=sj)
    lt, ct = tssm.prefill(tcfg, pt, torch.from_numpy(toks).long(), ct,
                          store=st)
    close_logits(lt, lj)
    nt = lt.argmax(-1)
    lj, _ = jssm.decode_step(jcfg, pj, jnp.asarray(nt.numpy()), cj)
    lt, _ = tssm.decode_step(tcfg, pt, nt, ct)
    close_logits(lt, lj)
    with pytest.raises(ValueError, match="tile"):
        tssm.prefill(tcfg, pt, torch.from_numpy(toks).long(),
                     tssm.init_cache(tcfg, B, S, torch.float32),
                     store={"state": st["state"][:, :1]})


@pytest.mark.parametrize("S", [12, 3, 2])
def test_prefill_decode_consistency(S):
    """decode(prefill(S - 1), token S - 1) == prefill(S), as
    ``tests/test_arch_smoke.py`` holds the reference; at S = 2 and 3 the
    first prefill is shorter than the conv's 3 taps of state, which the
    port left-pads with zeros."""
    cfg = dataclasses.replace(tget(ARCH).reduced(), dtype="float32")
    model = tbuild_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    toks = torch.from_numpy(_tokens(4, (2, S))).long()
    c1 = model.init_cache(2, S + 4, torch.float32)
    model.prefill(params, toks[:, :S - 1], c1)
    ld, _ = model.decode_step(params, toks[:, S - 1], c1)
    lf, _ = model.prefill(params, toks,
                          model.init_cache(2, S + 4, torch.float32))
    torch.testing.assert_close(ld, lf, rtol=2e-3, atol=2e-3)
