"""The port's afmoe model (Trinity) on the CPU: corpus registration, an
admission prefill over the store and decode steps through the cache,
against the plain full forward of ``tests/afmoe_reference.py`` over
document + prompt + fed tokens; the per-layer store; the configurations
the new defaults must leave bit for bit as they were; and the mutations
the comparison must catch.

The tiny configuration: one dense leading layer, then one whole
sliding-sliding-sliding-full period of MoE layers, 16 experts top-8 with a
shared expert, a sigmoid router whose seeded bias moves the top-8, every
norm scale drawn non-zero. Its MoE capacity factor is 2.0, where
capacity = tokens: the reference has no capacity, so the program must
drop nothing."""
import dataclasses
import hashlib
import math

import pytest
import torch

from afmoe_reference import AfmoeReference
from repro_torch import obs
from repro_torch.configs import (AfmoeConfig, AfmoeMoEConfig, ModelConfig,
                                 MoSKAConfig, get_config)
from repro_torch.core import moska_attention as MA
from repro_torch.core import router as router_lib
from repro_torch.core.shared_kv import LayeredStore, build_store
from repro_torch.models import moe as moe_lib
from repro_torch.models.model import build_model
from repro_torch.serving.engine import EngineConfig, ServingEngine

CHUNK, WINDOW, DOC, PROMPT, FED = 16, 24, 64, 12, 16
#: the logits' largest gap the comparison allows: both sides compute in
#: float32 from the same weights, the program in other contraction orders
#: (blocked attention, an LSE merge of the unique, tail and chunk
#: partials, the MoE's scatter and bmm); measured gaps stay under 2e-5
#: (test_program_matches_the_reference), so 1e-3 leaves room for another
#: machine's order and sits far under every mutation's gap (0.05 and up)
TOL = 1e-3
#: the expert bias's standard deviation: large enough that the biased
#: top-8 of 16 differs from the unbiased one on most rows
BIAS_STD = 0.5


def tiny_cfg(top_k_chunks: int = DOC // CHUNK, **kw) -> ModelConfig:
    base = dict(
        name="afmoe-tiny", family="moe", num_layers=5, d_model=64,
        num_heads=4, num_kv_heads=2, head_dim=16, d_ff=32, vocab_size=97,
        rope_theta=10000.0, rms_eps=1e-5, dtype="float32",
        layer_windows=(WINDOW,) * 4 + (0,), nope_full_layers=True,
        qk_norm=True, attn_gate=True, sandwich_norm=True,
        num_dense_layers=1, dense_d_ff=48, embed_scale=math.sqrt(64),
        moe=AfmoeMoEConfig(num_experts=16, top_k=8, capacity_factor=2.0,
                      score_func="sigmoid", route_norm=True,
                      route_scale=2.826, shared_expert_width=24),
        moska=MoSKAConfig(chunk_size=CHUNK, top_k_chunks=top_k_chunks))
    base.update(kw)
    return AfmoeConfig(**base)


def make_params(cfg: ModelConfig, seed: int = 3):
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(seed), "cpu")
    g = torch.Generator().manual_seed(seed + 100)
    with torch.no_grad():
        for name, p in params.named_parameters():
            if "ln" in name or "norm" in name:
                p.copy_(0.2 * torch.randn(p.shape, generator=g))
            elif name.endswith("expert_bias"):
                p.copy_(BIAS_STD * torch.randn(p.shape, generator=g))
    return model, params


def reference_weights(cfg: ModelConfig, params) -> dict:
    """The program's leaves under the reference's names; a norm's weight
    is the program's 1 + scale."""
    w = {"embed": params.embed["embed"],
         "unembed": params.unembed["unembed"],
         "final_norm": 1 + params.final_norm["scale"]}
    for i, lp in enumerate(params.layers):
        p = f"layers.{i}."
        w.update({p + "input_norm": 1 + lp.ln1["scale"],
                  p + "pre_mlp_norm": 1 + lp.ln2["scale"],
                  p + "post_attn_norm": 1 + lp.post_norm["attn"],
                  p + "post_mlp_norm": 1 + lp.post_norm["mlp"],
                  p + "q_norm": 1 + lp.qk_norm["q"],
                  p + "k_norm": 1 + lp.qk_norm["k"],
                  p + "q_proj": lp.attn["wq"], p + "k_proj": lp.attn["wk"],
                  p + "v_proj": lp.attn["wv"], p + "o_proj": lp.attn["wo"],
                  p + "gate_proj": lp.attn["wg"]})
        if hasattr(lp, "moe"):
            m = lp.moe
            w.update({p + "router": m["router"],
                      p + "expert_bias": m["expert_bias"],
                      p + "experts.gate": m["e_gate"],
                      p + "experts.up": m["e_up"],
                      p + "experts.down": m["e_down"],
                      p + "shared.gate": m["sh_gate"],
                      p + "shared.up": m["sh_up"],
                      p + "shared.down": m["sh_down"]})
        else:
            w.update({p + "mlp.gate": lp.mlp["w_gate"],
                      p + "mlp.up": lp.mlp["w_up"],
                      p + "mlp.down": lp.mlp["w_down"]})
    return {k: t.detach().float() for k, t in w.items()}


def reference_spec(cfg: ModelConfig) -> dict:
    return dict(num_layers=cfg.num_layers, d_model=cfg.d_model,
                num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads,
                head_dim=cfg.head_dim, vocab_size=cfg.vocab_size,
                rope_theta=cfg.rope_theta, rms_eps=cfg.rms_eps,
                layer_types=["sliding" if w else "full"
                             for w in cfg.layer_windows],
                sliding_window=max(cfg.layer_windows),
                num_dense_layers=cfg.num_dense_layers,
                num_experts=cfg.moe.num_experts, top_k=cfg.moe.top_k,
                route_norm=cfg.moe.route_norm,
                route_scale=cfg.moe.route_scale, mup_enabled=True)


def _tokens(seed: int):
    g = torch.Generator().manual_seed(seed)
    doc = torch.randint(0, 97, (DOC,), generator=g)
    prompts = torch.randint(0, 97, (2, PROMPT), generator=g)
    fed = torch.randint(0, 97, (2, FED), generator=g)
    return doc, prompts, fed


def serve(cfg: ModelConfig, params, doc, prompts, fed, store_fn=None):
    """Register the document through the engine, prefill both prompts over
    its store, then feed ``fed`` one decode step at a time. Returns the
    logits (2, 1 + FED, V) (the prompt's last position, then each step's)
    and the store."""
    model = build_model(cfg)
    eng = ServingEngine(cfg, params, EngineConfig(
        max_slots=2, max_seq=64, cache_dtype=torch.float32))
    eng.register_corpus("doc", doc.numpy())
    store = eng.stores["doc"]
    if store_fn is not None:
        store = store_fn(store)
    cache = model.init_cache(2, PROMPT + FED + 1, torch.float32, "cpu")
    out = []
    logits, cache = model.prefill(params, prompts, cache, store=store,
                                  start_pos=DOC)
    out.append(logits)
    for j in range(FED):
        logits, cache = model.decode_step(params, fed[:, j], cache,
                                          store=store)
        out.append(logits)
    return torch.stack(out, dim=1), store


def reference_logits(cfg, params, doc, prompts, fed, visible=None):
    ref = AfmoeReference(reference_spec(cfg), reference_weights(cfg, params))
    rows = []
    for b in range(2):
        seq = doc.tolist() + prompts[b].tolist() + fed[b].tolist()
        lg = ref.forward(seq, None if visible is None else visible[b])
        rows.append(lg[DOC + PROMPT - 1:DOC + PROMPT + FED])
    return torch.stack(rows)


def gap(cfg, params, seed=5, **kw) -> float:
    doc, prompts, fed = _tokens(seed)
    got, _ = serve(cfg, params, doc, prompts, fed, **kw)
    want = reference_logits(cfg, params, doc, prompts, fed)
    return float((got - want).abs().max())


@pytest.fixture(scope="module")
def tiny():
    cfg = tiny_cfg()
    return cfg, make_params(cfg)[1]


def test_program_matches_the_reference(tiny):
    """Every chunk chosen (top-k = all 4): MoSKA is exact, so the port's
    prefill and decode logits equal the full forward's, in float32, over
    decode steps whose unique offset passes the tail (t >= 23: the tail
    shows nothing more)."""
    cfg, params = tiny
    assert gap(cfg, params) < 2e-5


def test_routed_program_matches_the_reference_following_its_choices():
    """Top-2 of 4 chunks: the reference follows the program's choices
    (each full layer's routed chunks per prompt block and decode step)
    and matches."""
    cfg = tiny_cfg(top_k_chunks=2)
    _, params = make_params(cfg)
    doc, prompts, fed = _tokens(7)
    calls = []
    orig = router_lib.route

    def keep(*a, **k):
        out = orig(*a, **k)
        calls.append(out.chunk_ids.clone())
        return out
    router_lib.route = keep
    try:
        got, _ = serve(cfg, params, doc, prompts, fed)
    finally:
        router_lib.route = orig
    # one route call a full layer a model call: the prefill's, then FED
    assert len(calls) == 1 + FED
    S = DOC + PROMPT + FED
    visible = []
    for b in range(2):
        vis = torch.ones(S, S, dtype=torch.bool)
        chunk_of = torch.arange(S) // CHUNK
        for row in range(DOC, S):
            step = 0 if row < DOC + PROMPT else row - DOC - PROMPT + 1
            ids = calls[step][b]
            doc_ok = torch.isin(chunk_of, ids) | (torch.arange(S) >= DOC)
            vis[row] = doc_ok
        visible.append({cfg.num_layers - 1: vis})
        assert len(set(calls[0][b].tolist())) == 2
    want = reference_logits(cfg, params, doc, prompts, fed, visible)
    assert float((got - want).abs().max()) < TOL
    # and routing mattered: the reference with every chunk differs
    full = reference_logits(cfg, params, doc, prompts, fed)
    assert float((got - full).abs().max()) > 10 * TOL


def test_the_bias_moves_the_top_eight(tiny):
    """The seeded expert bias picks other experts than the unbiased top-8
    on most rows of the router's input (RMS-normed hidden states)."""
    cfg, params = tiny
    g = torch.Generator().manual_seed(1)
    x = torch.randn(512, cfg.d_model, generator=g)
    shares = []
    for lp in params.layers[cfg.num_dense_layers:]:
        s = torch.sigmoid(x @ lp.moe["router"])
        biased = torch.topk(s + lp.moe["expert_bias"], 8).indices.sort().values
        plain = torch.topk(s, 8).indices.sort().values
        shares.append(float((biased != plain).any(dim=1).float().mean()))
    assert min(shares) > 0.5, shares


def test_layered_store_shapes_and_judge_indexing(tiny):
    """Registration keeps, per layer, a full layer's 4 chunks of 16 keys
    and a sliding layer's one tail of window - 1 = 23 keys (the document's
    last), each with its mean key, indexed k[i], v[i], emb[i] as the
    stacked store is; they equal the registration prefill's keys."""
    cfg, params = tiny
    doc, prompts, fed = _tokens(5)
    eng = ServingEngine(cfg, params, EngineConfig(
        max_slots=2, max_seq=64, cache_dtype=torch.float32))
    assert eng.register_corpus("doc", doc.numpy()) == DOC // CHUNK
    st = eng.stores["doc"]
    assert isinstance(st, LayeredStore)
    assert st.num_layers == 5 and st.total_tokens == DOC
    assert st.num_chunks == DOC // CHUNK
    model = build_model(cfg)
    cache = model.init_cache(1, DOC, torch.float32, "cpu")
    model.prefill(params, doc[None], cache)
    for i in range(5):
        tail = cfg.window(i) > 0
        shape = (1, WINDOW - 1, 2, 16) if tail else (4, CHUNK, 2, 16)
        assert st.k[i].shape == shape and st.v[i].shape == shape
        assert st.emb[i].shape == (shape[0], 2, 16)
        want_k = cache.k[i, 0, DOC - (WINDOW - 1):] if tail else cache.k[i, 0]
        assert torch.equal(st.k[i].reshape(-1, 2, 16), want_k)
        assert torch.allclose(st.emb[i], st.k[i].mean(dim=1))
    assert st.nbytes == sum(t.numel() * 4 for t in (*st.k, *st.v, *st.emb))


def _no_gate(cfg, params):
    return dataclasses.replace(cfg, attn_gate=False), params, {}


def _rope_on_full(cfg, params):
    return dataclasses.replace(cfg, nope_full_layers=False), params, {}


def _swap_post_norms(cfg, params):
    import copy
    p = copy.deepcopy(params)
    with torch.no_grad():
        for lp in p.layers:
            a = lp.post_norm["attn"].clone()
            lp.post_norm["attn"].copy_(lp.post_norm["mlp"])
            lp.post_norm["mlp"].copy_(a)
    return cfg, p, {}


def _no_shared_expert(cfg, params):
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, shared_expert_width=0)), params, {}


def _biased_weights(cfg, params):
    def route(x, p, mcfg):
        s = torch.sigmoid(x.float() @ p["router"]) + p["expert_bias"]
        _, ids = moe_lib.top_k(s, mcfg.top_k)
        g = s.gather(-1, ids)
        return s, g / (g.sum(-1, keepdim=True) + 1e-20) * mcfg.route_scale, ids
    return cfg, params, {(moe_lib, "_sigmoid_route"): route}


def _sliding_routes_all_chunks(cfg, params):
    """Sliding layers handed every chunk of the document, as a windowed
    layer over a stacked store would route them."""
    def store_fn(st):
        k = torch.stack([t.reshape(DOC, 2, 16) for t in
                         _full_kv(cfg, params, "k")])
        v = torch.stack([t.reshape(DOC, 2, 16) for t in
                         _full_kv(cfg, params, "v")])
        return build_store(k, v, CHUNK)
    return cfg, params, {"store_fn": store_fn}


def _full_kv(cfg, params, which):
    doc, _, _ = _tokens(5)
    model = build_model(cfg)
    cache = model.init_cache(1, DOC, torch.float32, "cpu")
    model.prefill(params, doc[None], cache)
    return [getattr(cache, which)[i, 0] for i in range(cfg.num_layers)]


def _skip_tail(cfg, params):
    return cfg, params, {(MA, "shared_tail_merge"):
                         lambda q, o_u, *a, **k: o_u}


MUTATIONS = {"drops the gate": _no_gate,
             "applies RoPE on full layers": _rope_on_full,
             "swaps the post-attention and post-MLP norms": _swap_post_norms,
             "drops the shared expert": _no_shared_expert,
             "weights experts by the biased score": _biased_weights,
             "routes a sliding layer over all chunks":
                 _sliding_routes_all_chunks,
             "skips the tail": _skip_tail}


@pytest.mark.parametrize("name", list(MUTATIONS))
def test_each_mutation_fails_the_comparison(tiny, monkeypatch, name):
    cfg, params = tiny
    mcfg, mparams, patch = MUTATIONS[name](cfg, params)
    kw = {}
    for key, fn in patch.items():
        if key == "store_fn":
            kw["store_fn"] = fn
        else:
            monkeypatch.setattr(*key, fn)
    doc, prompts, fed = _tokens(5)
    got, _ = serve(mcfg, mparams, doc, prompts, fed, **kw)
    want = reference_logits(cfg, params, doc, prompts, fed)
    assert float((got - want).abs().max()) > 50 * TOL, name


def test_paged_engine_serves_what_the_slotted_one_serves(tiny):
    """The paged decode takes the tail and the routed chunks as the
    slotted path does: the same generations over the document."""
    cfg, params = tiny
    doc, _, _ = _tokens(9)
    g = torch.Generator().manual_seed(4)
    prompts = [torch.randint(0, 97, (n,), generator=g).tolist()
               for n in (5, 20)]
    outs = []
    for layout in ("slotted", "paged"):
        eng = ServingEngine(cfg, params, EngineConfig(
            max_slots=2, max_seq=32, cache_dtype=torch.float32,
            kv_layout=layout, block_size=8, prefill_chunk=16,
            share_prefix_blocks=False))
        eng.register_corpus("doc", doc.numpy())
        for p in prompts:
            eng.submit(p, 12, "doc")
        outs.append([r.generated for r in sorted(eng.run(),
                                                  key=lambda r: r.uid)])
    assert outs[0] == outs[1]


class _NamedRecorder(obs.DeviceRecorder):
    """A recorder that keeps the name of every record queued on it."""

    def __init__(self):
        super().__init__()
        self.names = []

    def inc(self, name, value):
        self.names.append(name)
        super().inc(name, value)


@pytest.mark.parametrize("call", ["prefill", "decode", "prefill chunk"])
def test_tail_counters_are_queued_once_a_model_call(tiny, call):
    """A model call queues each tail counter once, not once a sliding
    layer, and its totals are those of the tiny config's four sliding
    layers' calls over their 23-key tail, with the rows and first keys the
    layers hand the kernel."""
    cfg, params = tiny
    doc, prompts, fed = _tokens(5)
    eng = ServingEngine(cfg, params, EngineConfig(
        max_slots=2, max_seq=64, cache_dtype=torch.float32))
    eng.register_corpus("doc", doc.numpy())
    store = eng.stores["doc"]
    model = build_model(cfg)
    cache = model.init_cache(2, 40, torch.float32, "cpu")
    rec = _NamedRecorder()
    if call == "prefill":
        model.prefill(params, prompts, cache, store=store, start_pos=DOC,
                      rec=rec)
        first = torch.arange(PROMPT).repeat(2)
    else:
        model.prefill(params, prompts, cache, store=store, start_pos=DOC)
        if call == "decode":
            model.decode_step(params, fed[:, 0], cache, store=store, rec=rec)
            first = torch.full((2,), PROMPT)
        else:
            model.prefill_chunk(params, fed[:, :8], cache, store=store,
                                start_pos=DOC, chunk_len=8, rec=rec)
            first = (PROMPT + torch.arange(8)).repeat(2)
    tails = [n for n in rec.names if n.startswith("moska/tail_")]
    assert sorted(tails) == sorted(
        f"moska/tail_{k}" for k in ("rows", "keys", "calls", "query_rows",
                                    "kv_rows"))
    totals = rec.flush(obs.MetricsRegistry())
    seen = (WINDOW - 1 - first).clamp(0, WINDOW - 1)
    assert totals["moska/tail_calls"] == 4
    assert totals["moska/tail_query_rows"] == 4 * first.numel()
    assert totals["moska/tail_kv_rows"] == 4 * (WINDOW - 1)
    assert totals["moska/tail_rows"] == 4 * int((seen > 0).sum())
    assert totals["moska/tail_keys"] == 4 * int(seen.sum())


def test_training_refuses_the_afmoe_layers(tiny):
    cfg, params = tiny
    model = build_model(cfg)
    batch = {"tokens": torch.zeros(1, 8, dtype=torch.long),
             "targets": torch.zeros(1, 8, dtype=torch.long),
             "mask": torch.ones(1, 8)}
    with pytest.raises(NotImplementedError, match="layer_windows"):
        model.train_loss(params, batch)


def test_trinity_mini_config_is_the_published_one():
    cfg = get_config("trinity-mini")
    assert (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
            cfg.head_dim, cfg.vocab_size) == (32, 2048, 32, 4, 128, 200192)
    assert [i for i in range(32) if cfg.window(i) == 0] == list(range(3, 32,
                                                                      4))
    assert {cfg.window(i) for i in range(32)} == {0, 2048}
    assert cfg.num_dense_layers == 2 and cfg.dense_d_ff == 6144
    m = cfg.moe
    assert (m.num_experts, m.top_k, cfg.d_ff, m.shared_expert_width) == \
        (128, 8, 1024, 1024)
    assert m.score_func == "sigmoid" and m.route_scale == 2.826
    assert cfg.embed_scale == math.sqrt(2048)
    assert round(cfg.param_count() / 1e9, 2) == 26.12
    from repro_torch.configs import list_archs
    assert "trinity-mini" not in list_archs()


# --- the present configurations, bit for bit as before -------------------

#: sha256 of the float32 logits (prefill's last position, then three greedy
#: decode steps, both rows) of each configuration's ``.reduced()`` at the
#: parent commit of the afmoe change, weights seed 7, tokens seed 11, one
#: thread; "store": a 256-token corpus registered and attended
FROZEN = {
    ("granite-moe-1b-a400m", "float32", False):
        "9bd32e8f5abc856e43c51f3cb23ea30371607b8aba8517501865e1527568604f",
    ("granite-moe-1b-a400m", "bfloat16", False):
        "81f972f5f387c16cf348f582f3641a91314318fb96569f2dca3f9f75fd6a75a3",
    ("tinyllama-1.1b", "float32", False):
        "6ca377826863fb95435e45c4e44169c3f56211022b01fe96ec1121e227ad1ec1",
    ("tinyllama-1.1b", "bfloat16", False):
        "78fa0541e8abce2bc12439211884827e565b8175db6177dcd5738066ae449281",
    ("granite-moe-1b-a400m", "float32", True):
        "04cece79992990b5abfe6bb0411dc0901333ce296d3d47002bce657becdd3d14",
    ("granite-moe-1b-a400m", "bfloat16", True):
        "f0e5bd8aba84119374e17105f34656774518afff9dc055aeb8ee1877c04a4652",
    ("tinyllama-1.1b", "float32", True):
        "e48d1360c18db104af2d6cdff1c87f309f28e4a2efbbf22bd3e061fb3f6800df",
    ("tinyllama-1.1b", "bfloat16", True):
        "8cf2c880c96689e1af44602471d8a84825079ee597dc6c982c60ea5c4bfc27f3",
}


@pytest.mark.parametrize("arch,dtype,with_store", list(FROZEN))
def test_present_configs_keep_their_logits_bit_for_bit(arch, dtype,
                                                       with_store):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        cfg = dataclasses.replace(get_config(arch).reduced(), dtype=dtype)
        dt = torch.float32 if dtype == "float32" else torch.bfloat16
        model = build_model(cfg)
        p = model.init(torch.Generator().manual_seed(7), "cpu")
        g = torch.Generator().manual_seed(11)
        store, start = None, 0
        if with_store:
            corpus = torch.randint(0, cfg.vocab_size, (1, 256), generator=g)
            cc = model.init_cache(1, 256, dt, "cpu")
            model.prefill(p, corpus, cc)
            store = build_store(cc.k[:, 0], cc.v[:, 0], cfg.moska.chunk_size)
            start = 256
        tok = torch.randint(0, cfg.vocab_size, (2, 12), generator=g)
        cache = model.init_cache(2, 32, dt, "cpu")
        outs = []
        lg, cache = model.prefill(p, tok, cache, store=store,
                                  start_pos=start)
        outs.append(lg)
        for _ in range(3):
            lg, cache = model.decode_step(p, lg.argmax(-1), cache,
                                          store=store)
            outs.append(lg)
    finally:
        torch.set_num_threads(threads)
    t = torch.cat([o.float().reshape(-1) for o in outs])
    assert hashlib.sha256(t.numpy().tobytes()).hexdigest() == \
        FROZEN[(arch, dtype, with_store)]
