"""Parity of the port's training path (``repro_torch.data.pipeline``'s
batches, ``training.optimizer``, every family's ``train_loss`` and its
gradients, ``training.train_loop``, ``launch.train``) with the
reference's, on the CPU: the same seeded numpy input through both.

Tolerances: the batch stream is bit-equal; the schedule within 1e-7;
AdamW on identical parameters, gradients and state within 2e-6 in fp32
and within one bf16 ulp for bf16 parameters (the update is computed in
fp32 and rounded once, so an fp32 difference of an ulp can move the
rounding by one bf16 step); losses within 2e-5; each gradient leaf within
1e-4 of that leaf's largest magnitude; a short training run's loss
history within 1e-4 relative."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.data import pipeline as jpipe
from repro.models import moe as jmoe
from repro.models.model import build_model as jbuild
from repro.training import optimizer as jopt
from repro.training import train_loop as jloop
from repro_torch.configs import get_config as tget
from repro_torch.convert import from_reference_params, to_reference_params
from repro_torch.data import pipeline as tpipe
from repro_torch.launch import train as tlaunch
from repro_torch.models.model import build_model as tbuild
from repro_torch.training import optimizer as topt
from repro_torch.training import train_loop as tloop
from torch_parity import flat_tree, randn

KEY = jax.random.PRNGKey(0)
LOSS_TOL = 2e-5
GRAD_TOL = 1e-4
ADAM_TOL = 2e-6
#: a gate's top-k is decided with margin when the k-th probability leads
#: the next by this much: far above fp32 rounding (~1e-7 of the values)
TOPK_MARGIN = 1e-5


@pytest.fixture(autouse=True)
def one_thread():
    """torch ops of one thread: these tests run many small ops, which
    intra-op threads only slow down when the test workers share the
    cores. Every comparison here holds on any thread count."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _cfgs(arch, dtype="float32", **kw):
    return tuple(dataclasses.replace(get(arch).reduced(), dtype=dtype, **kw)
                 for get in (jget, tget))


def _pair(arch, dtype="float32", seed=0, **kw):
    """Both packages' configs and the same weights: the reference's init,
    converted."""
    jcfg, tcfg = _cfgs(arch, dtype, **kw)
    pj = jbuild(jcfg).init(jax.random.PRNGKey(seed))
    return jcfg, tcfg, pj, from_reference_params(
        tcfg, jax.tree.map(np.asarray, pj))


def _jbatch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _tbatch(b):
    return tloop.to_device(b, torch.device("cpu"))


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "internvl2-76b",
                                  "whisper-tiny"],
                         ids=["dense", "vlm", "audio"])
def test_make_train_batches_bit_equal(arch):
    jcfg, tcfg = _cfgs(arch)
    want = list(jpipe.make_train_batches(jcfg, 3, 48, num_batches=3,
                                         seed=5))
    got = list(tpipe.make_train_batches(tcfg, 3, 48, num_batches=3, seed=5))
    assert len(got) == len(want) == 3
    keys = {"tokens", "targets", "mask"} | (
        {"frontend_embeds"} if arch != "tinyllama-1.1b" else set())
    for g, w in zip(got, want):
        assert set(g) == set(w) == keys
        for k in keys:
            assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape
            np.testing.assert_array_equal(g[k], w[k])


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("base_lr,warmup,total", [
    (3e-4, 10, 20), (1e-3, 1, 100), (3e-4, 20, 200), (2e-3, 0, 7)])
def test_cosine_schedule_matches_reference(base_lr, warmup, total):
    jlr = jopt.cosine_schedule(base_lr, warmup, total)
    tlr = topt.cosine_schedule(base_lr, warmup, total)
    for step in range(total + 3):
        assert abs(tlr(step) - float(jlr(step))) <= 1e-7, step


def _grads(tcfg, like_j, seed, scale):
    """The same random gradients as a reference tree and a port name
    dict."""
    leaves, treedef = jax.tree.flatten(like_j)
    gj = jax.tree.unflatten(treedef, [
        jnp.asarray(randn(seed + i, a.shape, scale), a.dtype)
        for i, a in enumerate(leaves)])
    gt = from_reference_params(tcfg, jax.tree.map(np.asarray, gj))
    return gj, dict(gt.named_parameters())


def _assert_params(pt, pj, dtype, before=None):
    """fp32: within 2e-6. bf16: within one bf16 ulp of the larger of the
    parameter's magnitudes before and after the update (``before``: the
    reference's tree before it). The update is computed in fp32 and
    rounded once: its fp32 value can differ by fp32 ulps of its operands
    (the clip scale's global norm sums in another order), which is far
    below a bf16 ulp of them, but where the update cancels the parameter
    the small result keeps that absolute difference."""
    want = flat_tree(jax.tree.map(np.asarray, pj))
    got = flat_tree(to_reference_params(pt))
    prev = flat_tree(jax.tree.map(np.asarray, before)) if before else {}
    for k, w in want.items():
        g = got[k].astype(np.float32)
        w = w.astype(np.float32)
        if dtype == "float32":
            np.testing.assert_allclose(g, w, rtol=ADAM_TOL, atol=ADAM_TOL,
                                       err_msg=k)
            continue
        mag = np.maximum(np.abs(g), np.abs(w))
        if k in prev:
            mag = np.maximum(mag, np.abs(prev[k].astype(np.float32)))
        ulp = np.exp2(np.floor(np.log2(np.maximum(mag, 1e-30))) - 7)
        assert np.all(np.abs(g - w) <= ulp), k


def _port_state(tcfg, sj):
    """The reference's AdamW state as the port's (fp32 moments)."""
    f32 = dataclasses.replace(tcfg, dtype="float32")

    def moments(tree):
        return dict(from_reference_params(
            f32, jax.tree.map(np.asarray, tree)).named_parameters())
    return topt.AdamWState(int(sj.step), moments(sj.mu), moments(sj.nu))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("scale", [1e-4, 10.0], ids=["unclipped", "clipped"])
def test_adamw_update_matches_reference(dtype, scale):
    """3 updates, the same gradients fed to both packages each time (a
    gradient difference would be amplified where the second moment is
    tiny). fp32: the packages run on independently, and agree within
    2e-6 after 1 and after 3 updates. bf16: the parameters agree within
    one bf16 ulp (``_assert_params``), not exactly: where the fp32 value
    lies within an fp32 ulp of a bf16 rounding midpoint, the two round
    apart. Such a step would feed the next update parameters one ulp
    apart, so in bf16 every update starts from the reference's parameters
    and state."""
    jcfg, tcfg, pj, pt = _pair("tinyllama-1.1b", dtype)
    sj, st = jopt.adamw_init(pj), topt.adamw_init(pt)
    assert all(m.dtype == torch.float32 for m in st.mu.values())
    jlr, tlr = (o.cosine_schedule(1e-2, 2, 10) for o in (jopt, topt))
    jupdate = jax.jit(lambda g, s, p: jopt.adamw_update(g, s, p, lr=jlr))
    gnorms = []
    for step in range(3):
        if dtype == "bfloat16":
            pt = from_reference_params(tcfg, jax.tree.map(np.asarray, pj))
            st = _port_state(tcfg, sj)
        gj, gt = _grads(tcfg, pj, 100 * step, scale)
        gnorms.append(float(topt.global_norm(gt)))
        before = pj
        pj, sj = jupdate(gj, sj, pj)
        pt, st = topt.adamw_update(gt, st, pt, lr=tlr)
        assert st.step == int(sj.step) == step + 1
        if step in (0, 2) or dtype == "bfloat16":
            _assert_params(pt, pj, dtype, before)
            for field in ("mu", "nu"):
                want = flat_tree(jax.tree.map(np.asarray,
                                              getattr(sj, field)))
                got = flat_tree(to_reference_params(pt, getattr(st, field)))
                for k, w in want.items():
                    np.testing.assert_allclose(got[k], w, rtol=ADAM_TOL,
                                               atol=ADAM_TOL, err_msg=k)
    assert (min(gnorms) > 1.0) == (scale == 10.0)


# ---------------------------------------------------------------------------
# train_loss and its gradients
# ---------------------------------------------------------------------------

FAMILIES = ["tinyllama-1.1b", "granite-moe-1b-a400m", "internvl2-76b",
            "mamba2-130m", "recurrentgemma-9b", "whisper-tiny"]


def _gate_margins(monkeypatch):
    """Record every reference MoE call's smallest gap between the k-th
    and the (k+1)-th gate probability of a row."""
    gaps = []
    orig = jmoe.moe_ffn

    def wrapped(x, p, cfg, capacity=None):
        probs = jax.nn.softmax(jnp.einsum(
            "td,de->te", x.astype(jnp.float32), p["router"]), -1)
        top = jax.lax.top_k(probs, cfg.top_k + 1)[0]
        jax.debug.callback(lambda g: gaps.append(float(g)),
                           jnp.min(top[:, -2] - top[:, -1]))
        return orig(x, p, cfg, capacity)

    monkeypatch.setattr(jmoe, "moe_ffn", wrapped)
    return gaps


def _port_grads(tcfg, pt, batch, **kw):
    with tloop.trainable(pt):
        loss, metrics = tbuild(tcfg).train_loss(pt, batch, **kw)
        loss.backward()
        grads = {n: p.grad.clone() for n, p in pt.named_parameters()}
    return loss, metrics, grads


#: leaves whose exact gradient is 0: a key bias adds q.bk to every score
#: of a query's row, and softmax is invariant to that shift. Both packages
#: leave rounding noise there, which is held to the tree's scale instead.
ZERO_GRAD = ("attn.bk", "xattn.bk")


@pytest.mark.parametrize("arch", FAMILIES)
def test_train_loss_and_grads_match_reference(arch, monkeypatch):
    """fp32 ``.reduced()``: the loss, ``moe_aux`` and every gradient leaf
    of ``jax.value_and_grad(train_loss)`` on the same weights and batch;
    the port's gradients are bit-equal with remat on and off. internvl2
    runs with its frontend patches (positions without loss)."""
    jcfg, tcfg, pj, pt = _pair(arch)
    gaps = _gate_margins(monkeypatch) if jcfg.moe.enabled else None
    batch = next(jpipe.make_train_batches(jcfg, 2, 48, seed=1))
    if arch == "internvl2-76b":
        assert batch["frontend_embeds"].shape[1] == 24
    jm = jbuild(jcfg)
    (lj, mj), gj = jax.jit(jax.value_and_grad(
        lambda p, b: jm.train_loss(p, b), has_aux=True))(pj, _jbatch(batch))
    jax.effects_barrier()
    lt, mt, gt = _port_grads(tcfg, pt, _tbatch(batch))
    assert abs(lt.item() - float(lj)) <= LOSS_TOL
    assert abs(mt["ce_loss"].item() - float(mj["ce_loss"])) <= LOSS_TOL
    assert abs(mt["moe_aux"].item() - float(mj["moe_aux"])) <= LOSS_TOL
    if gaps is not None:
        assert float(mj["moe_aux"]) > 0
        assert len(gaps) >= jcfg.num_layers and min(gaps) > TOPK_MARGIN
    want = flat_tree(jax.tree.map(np.asarray, gj))
    got = flat_tree(to_reference_params(pt, gt))
    assert sorted(got) == sorted(want)
    top = max(float(np.abs(w).max()) for w in want.values())
    for k, w in want.items():
        if k.endswith(ZERO_GRAD):
            assert max(np.abs(w).max(), np.abs(got[k]).max()) <= 1e-6 * top
            continue
        tol = GRAD_TOL * float(np.abs(w).max())
        np.testing.assert_allclose(got[k], w, rtol=0, atol=tol, err_msg=k)
    _, _, g_off = _port_grads(tcfg, pt, _tbatch(batch), remat=False)
    for n, g in gt.items():
        assert torch.equal(g, g_off[n]), n


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "granite-moe-1b-a400m"])
def test_remat_policies_give_equal_grads(arch):
    """``cfg.remat_policy`` "nothing", "dots" and "none", and remat off:
    bit-equal gradients within the port on the CPU."""
    batch = _tbatch(next(tpipe.make_train_batches(_cfgs(arch)[1], 2, 40)))
    grads = []
    for policy, remat in (("nothing", True), ("dots", True),
                          ("none", True), ("nothing", False)):
        _, tcfg, _, pt = _pair(arch, remat_policy=policy)
        grads.append(_port_grads(tcfg, pt, batch, remat=remat)[2])
    for g in grads[1:]:
        for n, t in g.items():
            assert torch.equal(t, grads[0][n]), n


def test_lm_loss_chunks_equal_one_chunk():
    """More than one sequence chunk (recomputed in the backward pass) and
    a remainder: the loss and gradients equal the single chunk's within
    fp32 rounding."""
    from repro_torch.models import dense as tdense
    _, tcfg, _, pt = _pair("tinyllama-1.1b")
    b = _tbatch(next(tpipe.make_train_batches(tcfg, 2, 40)))
    out = []
    for chunk in (512, 16):
        with tloop.trainable(pt):
            x = tdense.embed_inputs(tcfg, pt, b["tokens"])
            h, _ = tdense.forward_hidden(tcfg, pt, x, torch.arange(40))
            loss = tdense.lm_loss(tcfg, pt, h, b["targets"], b["mask"],
                                  seq_chunk=chunk)
            loss.backward()
            out.append((loss.detach(), [p.grad.clone()
                                        for p in pt.parameters()]))
    torch.testing.assert_close(out[1][0], out[0][0], rtol=1e-6, atol=1e-6)
    for a, b_ in zip(out[1][1], out[0][1]):
        torch.testing.assert_close(a, b_, rtol=1e-5, atol=1e-7)


# ---------------------------------------------------------------------------
# the train loop and the launcher
# ---------------------------------------------------------------------------

def test_train_history_matches_reference():
    """Five steps of each package's ``train`` on tinyllama ``.reduced()``
    in fp32, from the same weights and batches: the loss history agrees
    within 1e-4 relative, with the reference's history keys."""
    jcfg, tcfg, pj, pt = _pair("tinyllama-1.1b")
    loop = dict(num_steps=5, batch_size=2, seq_len=32, lr=1e-3, warmup=2,
                log_every=1)
    bj = jpipe.make_train_batches(jcfg, 2, 32, seed=3)
    bt = tpipe.make_train_batches(tcfg, 2, 32, seed=3)
    hj = jloop.train(jcfg, jloop.TrainLoopConfig(**loop), bj, pj)["history"]
    out = tloop.train(tcfg, tloop.TrainLoopConfig(**loop), bt, pt,
                      device="cpu")
    ht = out["history"]
    assert [h["step"] for h in ht] == [h["step"] for h in hj] == list(
        range(5))
    assert set(ht[0]) == set(hj[0]) == {"loss", "ce_loss", "moe_aux",
                                        "step", "elapsed_s"}
    for a, b in zip(ht, hj):
        assert abs(a["loss"] - b["loss"]) <= 1e-4 * abs(b["loss"])
    assert ht[-1]["loss"] < ht[0]["loss"]
    assert out["opt_state"].step == 5
    assert not any(p.requires_grad for p in out["params"].parameters())


def test_train_refuses_a_missing_card(monkeypatch):
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    _, tcfg = _cfgs("tinyllama-1.1b")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tloop.train(tcfg, tloop.TrainLoopConfig(num_steps=1))


def test_launch_train_runs_on_the_cpu():
    final = tlaunch.main(["--arch", "tinyllama-1.1b", "--reduced",
                          "--steps", "2", "--batch", "2", "--seq", "32",
                          "--device", "cpu"])
    assert final["step"] == 1 and np.isfinite(final["loss"])


def test_launch_train_refuses_without_card_or_mesh(monkeypatch, capsys):
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        tlaunch.main(["--arch", "tinyllama-1.1b", "--reduced"])
    with pytest.raises(SystemExit, match="no CUDA device"):
        tlaunch.main(["--arch", "tinyllama-1.1b", "--reduced",
                      "--host-mesh"])
    with pytest.raises(SystemExit):
        tlaunch.main(["--arch", "tinyllama-1.1b", "--reduced", "--device",
                      "cpu", "--multi-pod"])
    assert "a world of 512 ranks, not 1" in capsys.readouterr().err
