"""The dense family's other members on the port, against the reference on
the CPU: the configs field for field, and with the reference's weights
converted, prefill / decode / paged decode / chunked prefill logits of
the MoE archs (granite-moe-1b-a400m, arctic-480b with its dense residual)
and the dense ones (qwen1.5-0.5b with nonzero QKV biases,
mistral-large-123b, and mistral's G = 12 grouping at small width), with
and without a shared store, fp32 within 1e-4 of the largest logit; the
VLM's frontend patches (internvl2-76b)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.core.shared_kv import build_store as jbuild
from repro.kvcache import init_kv_cache as jinit
from repro.kvcache import paged as jpg
from repro.models import dense as jd
from repro.models.model import build_model as jbuild_model
from repro_torch.configs import base as tbase
from repro_torch.configs import get_config as tget
from repro_torch.configs import list_archs
from repro_torch.convert import from_reference_params
from repro_torch.core.shared_kv import build_store as tbuild
from repro_torch.kvcache import init_kv_cache as tinit
from repro_torch.kvcache import paged as tpg
from repro_torch.models import dense as td
from repro_torch.models.model import Model
from torch_parity import assert_close

KEY = jax.random.PRNGKey(0)
NEW_ARCHS = ["granite-moe-1b-a400m", "arctic-480b", "internvl2-76b",
             "qwen1.5-0.5b", "mistral-large-123b"]


def _to_port(obj):
    """A reference config rebuilt from the port's copy of its classes."""
    if dataclasses.is_dataclass(obj):
        return getattr(tbase, type(obj).__name__)(**{
            f.name: _to_port(getattr(obj, f.name))
            for f in dataclasses.fields(obj)})
    return obj


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_config_equals_reference(arch):
    assert arch in list_archs()
    for j, t in ((jget(arch), tget(arch)),
                 (jget(arch).reduced(), tget(arch).reduced())):
        assert type(t) is tbase.ModelConfig
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        assert t.head_dim == j.head_dim and t.moe.enabled == j.moe.enabled
    assert Model(tget(arch)).cfg is tget(arch)


@pytest.mark.parametrize("arch", ["mamba2-130m", "recurrentgemma-9b",
                                  "whisper-tiny"])
def test_model_refuses_other_families(arch):
    """The SSM, hybrid and enc-dec families build, and refuse the paged
    layout (dense-family caches only), as the reference's facade does."""
    cfg = _to_port(jget(arch))
    assert type(cfg) is tbase.ModelConfig
    model = Model(cfg)
    assert model.cfg is cfg
    for what in ("init_paged_cache", "decode_step_paged", "prefill_chunk"):
        with pytest.raises(NotImplementedError, match=cfg.family):
            model._require_paged(what)


def test_registry_has_every_reference_arch():
    """All 11 of the reference's archs, ``ASSIGNED_ARCHS`` as the
    reference's, and a ``Model`` for each of the six families."""
    from repro.configs import ASSIGNED_ARCHS as JASSIGNED
    from repro.configs import list_archs as jlist
    from repro_torch.configs import ASSIGNED_ARCHS
    assert list_archs() == jlist() and len(list_archs()) == 11
    assert ASSIGNED_ARCHS == JASSIGNED
    families = set()
    for arch in list_archs():
        assert dataclasses.asdict(tget(arch)) == dataclasses.asdict(
            jget(arch)), arch
        families.add(Model(tget(arch)).cfg.family)
    assert families == set(tbase.FAMILIES)


def _cfgs(arch, dtype="float32", **kw):
    return tuple(dataclasses.replace(get(arch).reduced(), dtype=dtype, **kw)
                 for get in (jget, tget))


def _with_biases(pj, seed=3):
    """QKV biases drawn nonzero (the reference inits them to 0)."""
    g = np.random.default_rng(seed)
    attn = dict(pj["layers"]["attn"])
    for name in ("bq", "bk", "bv"):
        attn[name] = jnp.asarray(
            g.standard_normal(attn[name].shape) * 0.5, attn[name].dtype)
    return {**pj, "layers": {**pj["layers"], "attn": attn}}


MODELS = {
    "granite": ("granite-moe-1b-a400m", {}),           # MoE, G = 1 reduced
    "arctic": ("arctic-480b", {}),                     # MoE + dense residual
    "qwen": ("qwen1.5-0.5b", {}),                      # MHA, QKV bias
    "mistral": ("mistral-large-123b", {}),
    # mistral-large's G = 12 (96 heads over 8 kv heads) at small width
    "mistral-g12": ("mistral-large-123b",
                    {"num_heads": 12, "num_kv_heads": 1, "head_dim": 16}),
}


@pytest.fixture(scope="module", params=sorted(MODELS))
def model(request):
    arch, kw = MODELS[request.param]
    jcfg, tcfg = _cfgs(arch, **kw)
    pj = jd.init_params(jcfg, KEY)
    if jcfg.qkv_bias:
        pj = _with_biases(pj)
    pt = from_reference_params(tcfg, jax.tree.map(np.asarray, pj))
    return jcfg, tcfg, pj, pt


def _tokens(seed, shape, vocab):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


def _caches(jcfg, tcfg, B, S):
    return (jinit(jcfg.num_layers, B, S, jcfg.num_kv_heads, jcfg.head_dim,
                  jnp.float32),
            tinit(tcfg.num_layers, B, S, tcfg.num_kv_heads, tcfg.head_dim,
                  torch.float32))


def _stores(jcfg, tcfg, pj, pt, n, seed=1):
    """Both packages chunk the reference's corpus prefill (one 1-row MoE
    batch of n tokens), after the port's own prefill of it agreed."""
    toks = _tokens(seed, (1, n), jcfg.vocab_size)
    cj, ct = _caches(jcfg, tcfg, 1, n)
    _, cj = jd.prefill(jcfg, pj, jnp.asarray(toks), cj)
    td.prefill(tcfg, pt, torch.from_numpy(toks).long(), ct)
    assert_close(ct.k, cj.k, tol=1e-4)
    C = jcfg.moska.chunk_size
    k, v = (torch.from_numpy(np.array(x[:, 0])) for x in (cj.k, cj.v))
    return jbuild(cj.k[:, 0], cj.v[:, 0], C), tbuild(k, v, C)


def _close_logits(lt, lj, tol=1e-4):
    """Whole-model logits within ``tol`` of the largest, greedy equal."""
    scale = float(np.abs(np.asarray(lj)).max())
    assert_close(lt, lj, tol=tol * max(scale, 1.0))
    np.testing.assert_array_equal(lt.argmax(-1).numpy(),
                                  np.asarray(lj).argmax(-1))


@pytest.mark.parametrize("with_store", [False, True])
def test_prefill_and_decode_logits(model, with_store):
    jcfg, tcfg, pj, pt = model
    B, S = 3, 10
    sj = st = None
    start = 0
    if with_store:
        sj, st = _stores(jcfg, tcfg, pj, pt, 192)
        start = 192
    toks = _tokens(2, (B, S), jcfg.vocab_size)
    cj, ct = _caches(jcfg, tcfg, B, S + 4)
    lj, cj = jd.prefill(jcfg, pj, jnp.asarray(toks), cj, store=sj,
                        start_pos=start)
    lt, ct = td.prefill(tcfg, pt, torch.from_numpy(toks).long(), ct,
                        store=st, start_pos=start)
    _close_logits(lt, lj)
    for _ in range(3):
        nt = lt.argmax(-1)
        lj, cj = jd.decode_step(jcfg, pj, jnp.asarray(nt.numpy()), cj,
                                store=sj)
        lt, ct = td.decode_step(tcfg, pt, nt, ct, store=st)
        _close_logits(lt, lj)
    assert_close(ct.k, cj.k, tol=1e-4)
    np.testing.assert_array_equal(ct.length.numpy(), np.asarray(cj.length))


@pytest.mark.parametrize("with_store", [False, True])
def test_decode_step_paged_matches_reference(model, with_store):
    """Two paged decode steps over scrambled pages against the reference's
    ``decode_step_paged``; the port's paged logits equal its slotted ones
    on the same logical cache bit for bit (every row live, so the MoE
    batches hold the same rows)."""
    jcfg, tcfg, pj, pt = model
    B, S, bs, M = 3, 10, 4, 4
    L_, KH, D = tcfg.num_layers, tcfg.num_kv_heads, tcfg.head_dim
    sj = st = None
    start = 0
    if with_store:
        sj, st = _stores(jcfg, tcfg, pj, pt, 128)
        start = 128
    toks = _tokens(8, (B, S), jcfg.vocab_size)
    ct = tinit(L_, B, M * bs, KH, D, torch.float32)
    lt, ct = td.prefill(tcfg, pt, torch.from_numpy(toks).long(), ct,
                        store=st, start_pos=start)
    g = np.random.default_rng(9)
    n_pages = 1 + B * M + 3
    table = (g.permutation(n_pages - 1)[:B * M] + 1).reshape(B, M)
    pool = g.standard_normal((2, L_, n_pages, bs, KH, D)).astype(np.float32)
    for i, c in enumerate((ct.k.numpy(), ct.v.numpy())):
        for b in range(B):
            for m in range(M):
                live = np.arange(m * bs, (m + 1) * bs) < S
                pool[i, :, table[b, m]][:, live] = \
                    c[:, b, m * bs:(m + 1) * bs][:, live]
    pool_j = jpg.PagedKVCache(jnp.asarray(pool[0]), jnp.asarray(pool[1]))
    pool_t = tpg.PagedKVCache(*(torch.from_numpy(pool[i].copy())
                                for i in range(2)))
    tbl = table.astype(np.int32)
    lens = np.full((B,), S, np.int32)
    offs = np.full((B,), start, np.int32)
    nxt = lt.argmax(-1)
    for _ in range(2):
        lj, pool_j = jd.decode_step_paged(
            jcfg, pj, jnp.asarray(nxt.numpy()), pool_j, jnp.asarray(tbl),
            jnp.asarray(lens), jnp.asarray(offs), store=sj)
        lp, _ = td.decode_step_paged(
            tcfg, pt, nxt, pool_t, torch.from_numpy(tbl),
            torch.from_numpy(lens), torch.from_numpy(offs), store=st)
        _close_logits(lp, lj)
        ls, _ = td.decode_step(tcfg, pt, nxt, ct, store=st)
        assert torch.equal(lp, ls)
        lens = lens + 1
        nxt = lp.argmax(-1)
    assert_close(pool_t.k, pool_j.k, tol=1e-4)


@pytest.mark.parametrize("with_store", [False, True])
def test_prefill_chunk_matches_reference(model, with_store):
    """A 40-token prompt in 16-token chunks (each chunk one MoE batch of
    16 rows, padding included) against the reference's ``prefill_chunk``."""
    jcfg, tcfg, pj, pt = model
    sj = st = None
    start = 0
    if with_store:
        sj, st = _stores(jcfg, tcfg, pj, pt, 128, seed=10)
        start = 128
    n, C = 40, 16
    prompt = _tokens(11, (n,), jcfg.vocab_size)
    cj, ct = _caches(jcfg, tcfg, 1, 48)
    for s0 in range(0, n, C):
        clen = min(C, n - s0)
        chunk = np.zeros((1, C), np.int32)
        chunk[0, :clen] = prompt[s0:s0 + clen]
        lj, cj = jd.prefill_chunk(jcfg, pj, jnp.asarray(chunk), cj,
                                  store=sj, start_pos=start,
                                  chunk_len=jnp.int32(clen))
        lt, ct = td.prefill_chunk(tcfg, pt, torch.from_numpy(chunk).long(),
                                  ct, store=st, start_pos=start,
                                  chunk_len=clen)
        _close_logits(lt, lj)
    assert_close(ct.v, cj.v, tol=1e-4)
    np.testing.assert_array_equal(ct.length.numpy(), np.asarray(cj.length))


@pytest.fixture(scope="module")
def vlm():
    jcfg, tcfg = _cfgs("internvl2-76b")
    assert tcfg.family == tbase.VLM and tcfg.encoder.frontend_seq == 64
    pj = jd.init_params(jcfg, KEY)
    pt = from_reference_params(tcfg, jax.tree.map(np.asarray, pj))
    return jcfg, tcfg, pj, pt


@pytest.mark.parametrize("with_store", [False, True])
def test_vlm_prefill_with_frontend_patches(vlm, with_store):
    """64 stub patch embeddings in front of 64 tokens (one 128-query
    routing block): logits and the (P + S)-long cache equal the
    reference's, through ``Model.prefill``; then two decode steps."""
    jcfg, tcfg, pj, pt = vlm
    B, P, S = 2, tcfg.encoder.frontend_seq, 64
    sj = st = None
    start = 0
    if with_store:
        sj, st = _stores(jcfg, tcfg, pj, pt, 128, seed=12)
        start = 128
    toks = _tokens(13, (B, S), jcfg.vocab_size)
    patches = np.random.default_rng(14).standard_normal(
        (B, P, tcfg.d_model)).astype(np.float32) * 0.5
    cj, ct = _caches(jcfg, tcfg, B, P + S + 4)
    lj, cj = jbuild_model(jcfg).prefill(pj, jnp.asarray(toks), cj, store=sj,
                                        frontend_embeds=jnp.asarray(patches),
                                        start_pos=start)
    lt, ct = Model(tcfg).prefill(pt, torch.from_numpy(toks).long(), ct,
                                 store=st,
                                 frontend_embeds=torch.from_numpy(patches),
                                 start_pos=start)
    _close_logits(lt, lj)
    assert ct.length.tolist() == [P + S] * B == np.asarray(cj.length).tolist()
    assert ct.offset.tolist() == [start] * B
    assert_close(ct.k, cj.k, tol=1e-4)
    for _ in range(2):
        nt = lt.argmax(-1)
        lj, cj = jd.decode_step(jcfg, pj, jnp.asarray(nt.numpy()), cj,
                                store=sj)
        lt, ct = td.decode_step(tcfg, pt, nt, ct, store=st)
        _close_logits(lt, lj)


def test_vlm_prefill_refuses_true_len(vlm):
    jcfg, tcfg, pj, pt = vlm
    toks = torch.zeros((1, 16), dtype=torch.long)
    patches = torch.zeros((1, 4, tcfg.d_model))
    ct = tinit(tcfg.num_layers, 1, 20, tcfg.num_kv_heads, tcfg.head_dim,
               torch.float32)
    with pytest.raises(ValueError, match="true_len"):
        td.prefill(tcfg, pt, toks, ct, frontend_embeds=patches, true_len=8)
    cj = jinit(jcfg.num_layers, 1, 20, jcfg.num_kv_heads, jcfg.head_dim,
               jnp.float32)
    with pytest.raises(ValueError, match="true_len"):
        jd.prefill(jcfg, pj, jnp.zeros((1, 16), jnp.int32), cj,
                   frontend_embeds=jnp.zeros((1, 4, jcfg.d_model)),
                   true_len=8)
