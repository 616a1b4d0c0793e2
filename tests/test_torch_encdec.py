"""The port's encoder-decoder (``repro_torch.models.encdec``, whisper-tiny)
against the reference on the CPU, at ``.reduced()`` (2 + 2 layers, 64 stub
frames): the config, the converted weights bit for bit, prefill and
decode logits (fp32 within 1e-4 of the largest logit with equal greedy
tokens, bf16 within 2e-2) with the cross-attention over each request's
own cross cache, and routed over a ``SharedKVStore`` of one audio's cross
K/V: at the reduced 64 frames (one chunk of 64, top-2 cut to 1) and at
256 frames (4 chunks, top-2 routing); and the port's own
prefill-then-decode consistency."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.core.shared_kv import build_store as jbuild
from repro.models import encdec as jed
from repro.models.model import build_model as jbuild_model
from repro_torch.configs import get_config as tget
from repro_torch.convert import from_reference_params
from repro_torch.core.shared_kv import build_store as tbuild
from repro_torch.kernels import ops
from repro_torch.models import encdec as ted
from repro_torch.models.model import build_model as tbuild_model
from torch_parity import (assert_close, assert_converted_exactly,
                          close_logits, randn)

ARCH = "whisper-tiny"
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# (dtype, audio frames): the reduced 64 frames are one chunk of 64;
# 256 frames are 4 chunks
MODELS = {"fp32": ("float32", 64), "bf16": ("bfloat16", 64),
          "fp32-4chunks": ("float32", 256)}


def _cfgs(dtype, frames):
    return tuple(dataclasses.replace(
        get(ARCH).reduced(), dtype=dtype,
        encoder=dataclasses.replace(get(ARCH).reduced().encoder,
                                    frontend_seq=frames))
        for get in (jget, tget))


@pytest.fixture(scope="module", params=sorted(MODELS))
def model(request):
    dtype, frames = MODELS[request.param]
    jcfg, tcfg = _cfgs(dtype, frames)
    pj = jbuild_model(jcfg).init(jax.random.PRNGKey(0))
    pt = from_reference_params(tcfg, jax.tree.map(np.asarray, pj))
    return dtype, jcfg, tcfg, pj, pt


def _tokens(seed, shape, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


def _prefill(model, B, S):
    """One audio's frames behind B prompts of S tokens, in both packages."""
    dtype, jcfg, tcfg, pj, pt = model
    F = jcfg.encoder.frontend_seq
    frames = np.broadcast_to(randn(7, (1, F, jcfg.d_model)),
                             (B, F, jcfg.d_model)).copy()
    toks = _tokens(8, (B, S))
    cj = jed.init_cache(jcfg, B, S + 8, JDT[dtype])
    ct = ted.init_cache(tcfg, B, S + 8, TDT[dtype])
    lj, cj = jax.jit(lambda p, t, c, f: jed.prefill(
        jcfg, p, t, c, frontend_embeds=f))(
        pj, jnp.asarray(toks), cj, jnp.asarray(frames, JDT[dtype]))
    lt, ct2 = ted.prefill(tcfg, pt, torch.from_numpy(toks).long(), ct,
                          torch.from_numpy(frames).to(TDT[dtype]))
    assert ct2 is ct
    close_logits(lt, lj, TOL[dtype])
    if dtype == "float32":
        for name in ("self_k", "cross_k", "cross_v"):
            assert_close(ct[name], cj[name], tol=1e-4)
    return lt, cj, ct


def _decode(model, lt, cj, ct, steps, stores=(None, None)):
    dtype, jcfg, tcfg, pj, pt = model
    jdecode = jax.jit(lambda p, t, c, s: jed.decode_step(jcfg, p, t, c,
                                                         store=s))
    for _ in range(steps):
        nt = lt.argmax(-1)
        lj, cj = jdecode(pj, jnp.asarray(nt.numpy()), cj, stores[0])
        lt, ct = ted.decode_step(tcfg, pt, nt, ct, store=stores[1])
        close_logits(lt, lj, TOL[dtype])
    np.testing.assert_array_equal(ct["length"].numpy(),
                                  np.asarray(cj["length"]))


def test_config_equals_reference():
    for j, t in ((jget(ARCH), tget(ARCH)),
                 (jget(ARCH).reduced(), tget(ARCH).reduced())):
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
    full = tget(ARCH)
    assert full.encoder.frontend_seq // full.moska.chunk_size == 4
    assert (full.num_heads, full.num_kv_heads, full.head_dim) == (6, 6, 64)


def test_convert_is_exact(model):
    _, _, _, pj, pt = model
    assert_converted_exactly(pt, pj)


def test_decode_without_store(model):
    """Three decode steps, the cross-attention over each request's own
    cross cache through ``decode_attention`` (its plain version here)."""
    lt, cj, ct = _prefill(model, 3, 10)
    _decode(model, lt, cj, ct, 3)


def test_decode_with_store(model):
    """Four requests over one audio: the store chunks its cross K/V
    (``cross_k[:, 0]``), and three decode steps route each request's
    cross-attention query over the chunks (one chunk at 64 frames: the
    top-2 is cut to 1; four chunks at 256 frames, top-2)."""
    _, jcfg, tcfg, _, _ = model
    lt, cj, ct = _prefill(model, 4, 10)
    C = jcfg.moska.chunk_size
    sj = jbuild(cj["cross_k"][:, 0], cj["cross_v"][:, 0], C)
    st = tbuild(ct["cross_k"][:, 0], ct["cross_v"][:, 0], C)
    E = jcfg.encoder.frontend_seq // C
    assert st.num_chunks == E and st.chunk_size == C
    assert all(st.k[i].is_contiguous() and st.v[i].is_contiguous()
               for i in range(tcfg.num_layers))
    before = ops.launch_counts()
    _decode(model, lt, cj, ct, 3, stores=(sj, st))
    assert ops.launch_counts() == before       # the CPU runs plain versions


def test_prefill_decode_consistency():
    """decode(prefill(S - 1), token S - 1) == prefill(S), as
    ``tests/test_arch_smoke.py`` holds the reference."""
    cfg = dataclasses.replace(tget(ARCH).reduced(), dtype="float32")
    model = tbuild_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    B, S, F = 2, 12, cfg.encoder.frontend_seq
    toks = torch.from_numpy(_tokens(5, (B, S))).long()
    frames = torch.from_numpy(randn(6, (B, F, cfg.d_model)))
    c1 = model.init_cache(B, S + 4, torch.float32)
    model.prefill(params, toks[:, :S - 1], c1, frontend_embeds=frames)
    ld, _ = model.decode_step(params, toks[:, S - 1], c1)
    lf, _ = model.prefill(params, toks, model.init_cache(B, S + 4,
                                                          torch.float32),
                          frontend_embeds=frames)
    torch.testing.assert_close(ld, lf, rtol=2e-3, atol=2e-3)
