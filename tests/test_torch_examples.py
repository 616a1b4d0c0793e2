"""The port's examples (``repro_torch.examples``) run on the CPU at their
reduced configs, through the same ``main`` that ``python -m`` runs: the
quickstart's exactness check (full routing equals the monolithic context
within 1e-3) holds, the serving example finishes every request over two
corpora, and the long-context decode's greedy tokens equal the reference
model's (``repro.models.dense``, the steps of the reference's
``examples/long_context_decode.py``) on the same weights and inputs."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.core.shared_kv import build_store as jbuild
from repro.kvcache import init_kv_cache as jinit
from repro.models import dense as jd
from repro_torch.convert import from_reference_params
from repro_torch.examples import long_context_decode, quickstart
from repro_torch.examples import serve_shared_corpus


def test_quickstart_exactness_check_passes():
    err = quickstart.main(["--device", "cpu"])
    assert 0.0 <= err < quickstart.E2E_TOL


def test_serve_shared_corpus_finishes_every_request():
    done = serve_shared_corpus.main(["--device", "cpu"])
    assert len(done) == 10
    assert all(len(r.generated) == 8 for r in done)
    assert {r.corpus_id for r in done} == {"laws", "medical"}


def _reference_tree(model):
    """The reference's parameter tree holding a port model's weights (the
    inverse of ``from_reference_params``: layers stacked on axis 0)."""
    def leaf(t):
        return jnp.asarray(t.detach().numpy())

    tree = {"embed": {"embed": leaf(model.embed["embed"])},
            "final_norm": {"scale": leaf(model.final_norm["scale"])},
            "layers": {group: {name: jnp.stack([
                leaf(getattr(lp, group)[name]) for lp in model.layers])
                for name in pd}
                for group, pd in model.layers[0].named_children()}}
    if model.unembed is not None:
        tree["unembed"] = {"unembed": leaf(model.unembed["unembed"])}
    return tree


def test_long_context_decode_runs():
    """The example's 8 greedy tokens of each request equal those of the
    reference model run through the reference script's steps, on the
    example's weights and inputs."""
    toks, err = long_context_decode.main(["--device", "cpu"])
    assert toks.shape == (8, long_context_decode.B)
    assert err < long_context_decode.KERNEL_TOL
    cfg, params, ctx, prompt = long_context_decode.setup(torch.device("cpu"))
    jcfg = dataclasses.replace(jget("llama3-8b").reduced(), dtype="float32")
    tree = _reference_tree(params)
    back = from_reference_params(cfg, tree).state_dict()
    assert all(torch.equal(back[k], v)
               for k, v in params.state_dict().items())

    L, KH, D = jcfg.num_layers, jcfg.num_kv_heads, jcfg.head_dim
    ctx_j = jnp.asarray(ctx.numpy())
    cc = jinit(L, 1, ctx_j.shape[1], KH, D, jnp.float32)
    _, cc = jd.prefill(jcfg, tree, ctx_j, cc)
    store = jbuild(cc.k[:, 0], cc.v[:, 0], jcfg.moska.chunk_size)
    cache = jinit(L, prompt.shape[0], 64, KH, D, jnp.float32)
    logits, cache = jd.prefill(jcfg, tree, jnp.asarray(prompt.numpy()), cache,
                               store=store, start_pos=ctx_j.shape[1])
    tok = jnp.argmax(logits, -1).astype(jnp.int32)
    want = []
    for _ in range(8):
        logits, cache = jd.decode_step(jcfg, tree, tok, cache, store=store)
        tok = jnp.argmax(logits, -1).astype(jnp.int32)
        want.append(np.asarray(tok))
    np.testing.assert_array_equal(toks.numpy(), np.stack(want))


@pytest.mark.parametrize("mod", [quickstart, serve_shared_corpus,
                                 long_context_decode])
def test_examples_default_to_the_card(mod, monkeypatch):
    """Without a card, the default ``--device cuda`` refuses to run
    instead of falling back to the CPU."""
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        mod.main([])
