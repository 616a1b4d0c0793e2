"""Parity of the port's dense decoder with the reference's on the CPU, with
the reference's weights converted by ``repro_torch.convert``: prefill and
decode logits within 1e-4 in fp32 (2e-2 in bf16), with and without a
shared store, bucket-padded prefill, the int8 store, and the quickstart's
exactness check (full routing equals the monolithic context, 1e-3); the
paged decode step and the chunked prefill within 1e-4."""
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
from repro_torch.configs import get_config as tget
from repro_torch.convert import from_reference_params
from repro_torch.core.shared_kv import build_store as tbuild
from repro_torch.kvcache import init_kv_cache as tinit
from repro_torch.kvcache import paged as tpg
from repro_torch.models import dense as td
from torch_parity import assert_close, to_np

KEY = jax.random.PRNGKey(0)


def _cfgs(arch, dtype, **kw):
    return tuple(dataclasses.replace(get(arch).reduced(), dtype=dtype, **kw)
                 for get in (jget, tget))


@pytest.fixture(scope="module", params=[
    ("tinyllama-1.1b", {}),                        # G = 1
    ("llama3-8b", {"num_kv_heads": 2}),            # G = 2
], ids=["tinyllama", "llama3-gqa"])
def model(request):
    arch, kw = request.param
    jcfg, tcfg = _cfgs(arch, "float32", **kw)
    pj = jd.init_params(jcfg, KEY)
    pt = from_reference_params(tcfg, jax.tree.map(np.asarray, pj))
    return jcfg, tcfg, pj, pt


def _tokens(seed, shape, vocab):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


def _stores(jcfg, tcfg, pj, pt, n, seed=1, quantize=False):
    toks = _tokens(seed, (1, n), jcfg.vocab_size)
    cj = jinit(jcfg.num_layers, 1, n, jcfg.num_kv_heads, jcfg.head_dim,
               jnp.float32)
    _, cj = jd.prefill(jcfg, pj, jnp.asarray(toks), cj)
    ct = tinit(tcfg.num_layers, 1, n, tcfg.num_kv_heads, tcfg.head_dim,
               torch.float32)
    td.prefill(tcfg, pt, torch.from_numpy(toks).long(), ct)
    assert_close(ct.k, cj.k, tol=1e-4)         # a whole-model output
    assert_close(ct.v, cj.v, tol=1e-4)
    # both stores chunk the same values: int8 rounding would turn the
    # corpus prefill's 1e-5 differences into whole quantization steps
    C = jcfg.moska.chunk_size
    k, v = (torch.from_numpy(np.array(x[:, 0])) for x in (cj.k, cj.v))
    return (jbuild(cj.k[:, 0], cj.v[:, 0], C, quantize=quantize),
            tbuild(k, v, C, quantize=quantize))


def test_convert_is_exact(model):
    jcfg, _, pj, pt = model
    n_layer = len(jax.tree.leaves(pj["layers"]))
    n_other = len(jax.tree.leaves(pj)) - n_layer
    sd = pt.state_dict()
    assert len(sd) == n_layer * jcfg.num_layers + n_other
    np.testing.assert_array_equal(sd["embed.embed"].numpy(),
                                  np.asarray(pj["embed"]["embed"]))
    for i in range(jcfg.num_layers):
        for group in ("ln1", "ln2", "attn", "mlp"):
            for name, leaf in pj["layers"][group].items():
                np.testing.assert_array_equal(
                    sd[f"layers.{i}.{group}.{name}"].numpy(),
                    np.asarray(leaf)[i])


@pytest.mark.parametrize("with_store", [False, True])
def test_prefill_and_decode_logits(model, with_store):
    jcfg, tcfg, pj, pt = model
    B, S, n_corpus = 3, 10, 192
    sj = st = None
    start = 0
    if with_store:
        sj, st = _stores(jcfg, tcfg, pj, pt, n_corpus)
        start = n_corpus
    toks = _tokens(2, (B, S), jcfg.vocab_size)
    cj = jinit(jcfg.num_layers, B, S + 4, jcfg.num_kv_heads, jcfg.head_dim,
               jnp.float32)
    ct = tinit(tcfg.num_layers, B, S + 4, tcfg.num_kv_heads, tcfg.head_dim,
               torch.float32)
    lj, cj = jd.prefill(jcfg, pj, jnp.asarray(toks), cj, store=sj,
                        start_pos=start)
    lt, ct = td.prefill(tcfg, pt, torch.from_numpy(toks).long(), ct,
                        store=st, start_pos=start)
    assert_close(lt, lj, tol=1e-4)
    for _ in range(3):
        nj = jnp.argmax(lj, -1).astype(jnp.int32)
        nt = lt.argmax(-1)
        np.testing.assert_array_equal(nt.numpy(), np.asarray(nj))
        lj, cj = jd.decode_step(jcfg, pj, nj, cj, store=sj)
        lt, ct = td.decode_step(tcfg, pt, nt, ct, store=st)
        assert_close(lt, lj, tol=1e-4)
    assert_close(ct.k, cj.k, tol=1e-4)
    np.testing.assert_array_equal(ct.length.numpy(), np.asarray(cj.length))


def test_bucketed_prefill_pads_out_of_routing(model):
    """A prompt right-padded to a bucket with ``true_len`` gives the logits
    and cache the reference gives, and the exact-length prefill's logits."""
    jcfg, tcfg, pj, pt = model
    sj, st = _stores(jcfg, tcfg, pj, pt, 128, seed=3)
    true_len, pad = 11, 16
    toks = np.zeros((1, pad), np.int32)
    toks[0, :true_len] = _tokens(4, (true_len,), jcfg.vocab_size)
    cj = jinit(jcfg.num_layers, 1, pad, jcfg.num_kv_heads, jcfg.head_dim,
               jnp.float32)
    ct = tinit(tcfg.num_layers, 1, pad, tcfg.num_kv_heads, tcfg.head_dim,
               torch.float32)
    lj, cj = jd.prefill(jcfg, pj, jnp.asarray(toks), cj, store=sj,
                        start_pos=128, true_len=jnp.int32(true_len))
    lt, ct = td.prefill(tcfg, pt, torch.from_numpy(toks).long(), ct,
                        store=st, start_pos=128, true_len=true_len)
    assert_close(lt, lj, tol=1e-4)
    assert int(ct.length[0]) == true_len and int(ct.offset[0]) == 128
    ce = tinit(tcfg.num_layers, 1, true_len, tcfg.num_kv_heads,
               tcfg.head_dim, torch.float32)
    le, _ = td.prefill(tcfg, pt, torch.from_numpy(toks[:, :true_len]).long(),
                       ce, store=st, start_pos=128)
    assert_close(lt, le, tol=1e-4)


def test_int8_store_decode(model):
    jcfg, tcfg, pj, pt = model
    sj, st = _stores(jcfg, tcfg, pj, pt, 128, seed=5, quantize=True)
    assert st.quantized and st.k.dtype == torch.int8
    B, S = 2, 8
    toks = _tokens(6, (B, S), jcfg.vocab_size)
    cj = jinit(jcfg.num_layers, B, 12, jcfg.num_kv_heads, jcfg.head_dim,
               jnp.float32)
    ct = tinit(tcfg.num_layers, B, 12, tcfg.num_kv_heads, tcfg.head_dim,
               torch.float32)
    _, cj = jd.prefill(jcfg, pj, jnp.asarray(toks), cj, store=sj,
                       start_pos=128)
    td.prefill(tcfg, pt, torch.from_numpy(toks).long(), ct, store=st,
               start_pos=128)
    lj, _ = jd.decode_step(jcfg, pj, jnp.asarray(toks[:, -1]), cj, store=sj)
    lt, _ = td.decode_step(tcfg, pt, torch.from_numpy(toks[:, -1]).long(),
                           ct, store=st)
    assert_close(lt, lj, tol=1e-4)


@pytest.mark.parametrize("with_store", [False, True])
def test_decode_step_paged_matches_reference(model, with_store):
    """Three paged decode steps over pages in scrambled order (garbage in
    every page past each length): logits and pools within 1e-4 of the
    reference's ``decode_step_paged``; the port's paged logits equal its
    slotted logits on the same logical cache, bit for bit."""
    jcfg, tcfg, pj, pt = model
    B, S, bs, M = 3, 10, 4, 4
    L_, KH, D = tcfg.num_layers, tcfg.num_kv_heads, tcfg.head_dim
    sj = st = None
    start = 0
    if with_store:
        sj, st = _stores(jcfg, tcfg, pj, pt, 192)
        start = 192
    toks = _tokens(8, (B, S), jcfg.vocab_size)
    ct = tinit(L_, B, M * bs, KH, D, torch.float32)
    lt, ct = td.prefill(tcfg, pt, torch.from_numpy(toks).long(), ct,
                        store=st, start_pos=start)
    g = np.random.default_rng(9)
    n_pages = 1 + B * M + 3
    table = (g.permutation(n_pages - 1)[:B * M] + 1).reshape(B, M)
    pool = g.standard_normal((2, L_, n_pages, bs, KH, D)).astype(np.float32)
    k_np, v_np = ct.k.numpy(), ct.v.numpy()
    for b in range(B):
        for m in range(M):
            pos = slice(m * bs, (m + 1) * bs)
            live = np.arange(m * bs, (m + 1) * bs) < S
            pool[0, :, table[b, m]][:, live] = k_np[:, b, pos][:, live]
            pool[1, :, table[b, m]][:, live] = v_np[:, b, pos][:, live]
    pool_j = jpg.PagedKVCache(jnp.asarray(pool[0]), jnp.asarray(pool[1]))
    pool_t = tpg.PagedKVCache(*(torch.from_numpy(pool[i].copy())
                                for i in range(2)))
    tbl = table.astype(np.int32)
    lens = np.full((B,), S, np.int32)
    offs = np.full((B,), start, np.int32)
    nxt = lt.argmax(-1)
    for _ in range(3):
        lj, pool_j = jd.decode_step_paged(
            jcfg, pj, jnp.asarray(nxt.numpy()), pool_j, jnp.asarray(tbl),
            jnp.asarray(lens), jnp.asarray(offs), store=sj)
        lp, _ = td.decode_step_paged(
            tcfg, pt, nxt, pool_t, torch.from_numpy(tbl),
            torch.from_numpy(lens), torch.from_numpy(offs), store=st)
        assert_close(lp, lj, tol=1e-4)
        ls, _ = td.decode_step(tcfg, pt, nxt, ct, store=st)
        assert torch.equal(lp, ls)
        lens = lens + 1
        nxt = lp.argmax(-1)
    assert_close(pool_t.k, pool_j.k, tol=1e-4)
    assert_close(pool_t.v, pool_j.v, tol=1e-4)


@pytest.mark.parametrize("with_store", [False, True])
def test_prefill_chunk_matches_reference(model, with_store):
    """A 40-token prompt in 16-token chunks against a 48-token scratch
    context: each chunk's logits and the context within 1e-4 of the
    reference's ``prefill_chunk``."""
    jcfg, tcfg, pj, pt = model
    sj = st = None
    start = 0
    if with_store:
        sj, st = _stores(jcfg, tcfg, pj, pt, 128, seed=10)
        start = 128
    n, C = 40, 16
    prompt = _tokens(11, (n,), jcfg.vocab_size)
    cj = jinit(jcfg.num_layers, 1, 48, jcfg.num_kv_heads, jcfg.head_dim,
               jnp.float32)
    ct = tinit(tcfg.num_layers, 1, 48, tcfg.num_kv_heads, tcfg.head_dim,
               torch.float32)
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
        assert_close(lt, lj, tol=1e-4)
    assert_close(ct.k, cj.k, tol=1e-4)
    assert_close(ct.v, cj.v, tol=1e-4)
    np.testing.assert_array_equal(ct.length.numpy(), np.asarray(cj.length))
    np.testing.assert_array_equal(ct.offset.numpy(), np.asarray(cj.offset))


def _close_bf16_logits(lt, lj):
    """bf16 rounds at other places in the two frameworks, and the
    differences compound over the layers: whole-model bf16 logits are held
    to 2e-2 of the largest logit, and to the same greedy tokens."""
    scale = float(np.abs(np.asarray(lj)).max())
    assert_close(lt, lj, tol=2e-2 * scale)
    np.testing.assert_array_equal(lt.argmax(-1).numpy(),
                                  np.asarray(lj).argmax(-1))


def test_bf16_logits():
    jcfg, tcfg = _cfgs("tinyllama-1.1b", "bfloat16")
    pj = jd.init_params(jcfg, KEY)
    pt = from_reference_params(tcfg, jax.tree.map(np.asarray, pj))
    assert pt.embed["embed"].dtype == torch.bfloat16
    toks = _tokens(7, (2, 12), jcfg.vocab_size)
    cj = jinit(jcfg.num_layers, 2, 16, jcfg.num_kv_heads, jcfg.head_dim)
    ct = tinit(tcfg.num_layers, 2, 16, tcfg.num_kv_heads, tcfg.head_dim)
    lj, cj = jd.prefill(jcfg, pj, jnp.asarray(toks), cj)
    lt, ct = td.prefill(tcfg, pt, torch.from_numpy(toks).long(), ct)
    assert lt.dtype == torch.float32
    _close_bf16_logits(lt, lj)
    lj, _ = jd.decode_step(jcfg, pj, jnp.asarray(toks[:, -1]), cj)
    lt, _ = td.decode_step(tcfg, pt, torch.from_numpy(toks[:, -1]).long(), ct)
    _close_bf16_logits(lt, lj)


def test_quickstart_full_routing_equals_monolithic_context():
    """``examples/quickstart.py`` on the port: with every chunk routed,
    decode against the store equals decode over the concatenated context
    (within 1e-3)."""
    _, cfg = _cfgs("tinyllama-1.1b", "float32")
    params = td.init_params(cfg, torch.Generator().manual_seed(0))
    corpus_len, B, S = 256, 4, 12
    g = np.random.default_rng(1)
    corpus = torch.from_numpy(g.integers(0, cfg.vocab_size, (1, corpus_len)))
    prompts = torch.from_numpy(g.integers(0, cfg.vocab_size, (B, S)))

    def cache(b, n):
        return tinit(cfg.num_layers, b, n, cfg.num_kv_heads, cfg.head_dim,
                     torch.float32)

    cc = cache(1, corpus_len)
    td.prefill(cfg, params, corpus, cc)
    store = tbuild(cc.k[:, 0], cc.v[:, 0], cfg.moska.chunk_size)
    full = dataclasses.replace(cfg, moska=dataclasses.replace(
        cfg.moska, top_k_chunks=store.num_chunks))
    c2 = cache(B, S + 8)
    lg, _ = td.prefill(full, params, prompts, c2, store=store,
                       start_pos=corpus_len)
    nxt = lg.argmax(-1)
    lg, _ = td.decode_step(full, params, nxt, c2, store=store)
    mono = torch.cat([corpus.repeat(B, 1), prompts, nxt[:, None]], dim=1)
    lm, _ = td.prefill(cfg, params, mono, cache(B, mono.shape[1] + 4))
    assert float((lg - lm).abs().max()) < 1e-3


def test_init_params_from_generator():
    _, cfg = _cfgs("tinyllama-1.1b", "bfloat16")
    a = td.init_params(cfg, torch.Generator().manual_seed(3))
    b = td.init_params(cfg, torch.Generator().manual_seed(3))
    for (na, ta), (nb, tb) in zip(a.state_dict().items(),
                                  b.state_dict().items()):
        assert na == nb and torch.equal(ta, tb)
    emb = a.embed["embed"].float()
    assert abs(float(emb.std()) * cfg.d_model ** 0.5 - 1) < 0.05
    assert not a.layers[0].ln1["scale"].any()
    assert a.layers[1].mlp["w_down"].shape == (cfg.d_ff, cfg.d_model)
    assert all(not p.requires_grad for p in a.parameters())
    assert to_np(a.unembed_matrix()).shape == (cfg.vocab_size, cfg.d_model)
