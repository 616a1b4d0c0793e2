"""The port's checkpoints (``repro_torch.training.checkpoint``) and its
converter's inverse (``convert.to_reference_params``), on the CPU.

A round trip within the port is bit-exact; a run resumed from a
checkpoint equals the uninterrupted run bit for bit; checkpoints pass
between the packages in both directions with identical npz keys, shapes
and values; and ``to_reference_params`` inverts ``from_reference_params``
exactly for every family."""
import dataclasses
import os
import shutil

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.models.model import build_model as jbuild
from repro.training import checkpoint as jckpt
from repro.training import optimizer as jopt
from repro_torch.configs import get_config as tget
from repro_torch.convert import from_reference_params, to_reference_params
from repro_torch.data.pipeline import make_train_batches
from repro_torch.models.model import build_model as tbuild
from repro_torch.training import checkpoint as tckpt
from repro_torch.training import optimizer as topt
from repro_torch.training import train_loop as tloop
from torch_parity import flat_tree, randn


@pytest.fixture(autouse=True)
def one_thread():
    """torch ops of one thread: these tests run many small ops, which
    intra-op threads only slow down when the test workers share the
    cores. Every comparison here holds on any thread count."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _cfgs(arch, **kw):
    return tuple(dataclasses.replace(get(arch).reduced(), **kw)
                 for get in (jget, tget))


def _leaves_equal(a, b, what=""):
    """Two reference trees (numpy or jax leaves): the same paths, dtypes,
    shapes and bits."""
    fa = flat_tree(jax.tree.map(np.asarray, a))
    fb = flat_tree(jax.tree.map(np.asarray, b))
    assert sorted(fa) == sorted(fb), what
    for k in fa:
        assert fa[k].dtype == fb[k].dtype, (what, k)
        assert fa[k].shape == fb[k].shape, (what, k)
        np.testing.assert_array_equal(fa[k].view(np.uint8),
                                      fb[k].view(np.uint8), err_msg=k)


ARCHS = [("tinyllama-1.1b", {}), ("qwen1.5-0.5b", {}),
         ("granite-moe-1b-a400m", {}), ("arctic-480b", {}),
         ("internvl2-76b", {}), ("mamba2-130m", {}),
         ("recurrentgemma-9b", {}), ("recurrentgemma-9b", {"num_layers": 5}),
         ("whisper-tiny", {})]
ARCH_IDS = [a + ("-tail" if kw else "") for a, kw in ARCHS]


@pytest.mark.parametrize("arch,kw", ARCHS, ids=ARCH_IDS)
def test_to_reference_params_inverts_the_converter(arch, kw):
    """Every family's bf16 tree (the hybrid also with a tail of layers
    past its last whole cycle, a list): ``to_reference_params`` of the
    converted module gives back the reference's tree, bit for bit, with
    its dtypes; and converting that again gives the module's values."""
    jcfg, tcfg = _cfgs(arch, **kw)
    pj = jax.tree.map(np.asarray, jbuild(jcfg).init(jax.random.PRNGKey(1)))
    pt = from_reference_params(tcfg, pj)
    back = to_reference_params(pt)
    assert jax.tree.structure(back) == jax.tree.structure(pj)
    _leaves_equal(back, pj, arch)
    again = from_reference_params(tcfg, back).state_dict()
    for name, t in pt.state_dict().items():
        assert torch.equal(again[name], t), name


def _trained_state(tcfg, pt, seed=0):
    """A state after one update with random gradients: nonzero moments."""
    st = topt.adamw_init(pt)
    grads = {n: torch.from_numpy(randn(seed + i, tuple(p.shape))).to(p.dtype)
             for i, (n, p) in enumerate(pt.named_parameters())}
    return topt.adamw_update(grads, st, pt, lr=1e-3)


def test_round_trip_within_the_port_is_exact(tmp_path):
    """bf16 parameters and fp32 moments saved and restored into fresh
    templates: equal bit for bit, with the step and the LATEST pointer."""
    _, tcfg = _cfgs("granite-moe-1b-a400m")
    model = tbuild(tcfg)
    pt, st = _trained_state(tcfg, model.init(torch.Generator().manual_seed(0)))
    path = tckpt.save_checkpoint(str(tmp_path), 7, pt, st, extra={"a": 1})
    assert tckpt.latest_checkpoint(str(tmp_path)) == path
    assert os.path.basename(path) == "step_00000007"
    tmpl = model.init(torch.Generator().manual_seed(1))
    step, p2, s2 = tckpt.restore_checkpoint(path, tmpl,
                                            topt.adamw_init(tmpl))
    assert step == 7 and s2.step == 1
    for (n, a), (_, b) in zip(pt.state_dict().items(),
                              p2.state_dict().items()):
        assert a.dtype == b.dtype and torch.equal(a, b), n
    for field in ("mu", "nu"):
        for n, t in getattr(st, field).items():
            assert torch.equal(getattr(s2, field)[n], t), (field, n)
    with pytest.raises(FileExistsError):
        tckpt.save_checkpoint(str(tmp_path), 7, pt, st)


def test_resume_equals_the_uninterrupted_run(tmp_path):
    """bf16 tinyllama ``.reduced()``: 4 steps in one run, against 2 steps,
    a checkpoint, and a fresh ``train`` that resumes from it for steps 2
    and 3 on the same batches: the same losses, parameters and moments,
    bit for bit on the CPU."""
    _, tcfg = _cfgs("tinyllama-1.1b")
    batches = list(make_train_batches(tcfg, 2, 32, num_batches=4, seed=2))
    full, part = tmp_path / "full", tmp_path / "part"

    def run(ckpt_dir, feed):
        loop = tloop.TrainLoopConfig(num_steps=4, batch_size=2, seq_len=32,
                                     lr=1e-3, warmup=1, log_every=1,
                                     ckpt_dir=str(ckpt_dir), ckpt_every=2)
        return tloop.train(tcfg, loop, iter(feed), device="cpu")

    a = run(full, batches)
    part.mkdir()
    shutil.copytree(full / "step_00000002", part / "step_00000002")
    (part / "LATEST").write_text("step_00000002")
    b = run(part, batches[2:])
    assert [h["step"] for h in b["history"]] == [2, 3]
    for ha, hb in zip(a["history"][2:], b["history"]):
        assert ha["loss"] == hb["loss"], (ha, hb)
    for (n, x), (_, y) in zip(a["params"].state_dict().items(),
                              b["params"].state_dict().items()):
        assert torch.equal(x, y), n
    assert a["opt_state"].step == b["opt_state"].step == 4
    for n, t in a["opt_state"].nu.items():
        assert torch.equal(b["opt_state"].nu[n], t), n


@pytest.mark.parametrize("arch,kw", [("tinyllama-1.1b", {}),
                                     ("recurrentgemma-9b", {"num_layers": 5}),
                                     ("whisper-tiny", {})],
                         ids=["dense", "hybrid-tail", "encdec"])
def test_checkpoints_pass_between_the_packages(arch, kw, tmp_path):
    """A reference checkpoint (bf16 parameters, an AdamW state of step 1
    with fp32 moments) restores into the port, and the port's checkpoint of the same state
    restores in ``repro.training.checkpoint``: the same npz keys and
    shapes in both files, and equal values."""
    _, tcfg = _cfgs(arch, **kw)
    # the reference's tree of this arch (its layout is held to the
    # reference's init by the test above), with the port's seeded weights
    pj = to_reference_params(
        tbuild(tcfg).init(torch.Generator().manual_seed(2)))
    leaves, treedef = jax.tree.flatten(pj)

    def moments(seed):
        return jax.tree.unflatten(treedef, [
            randn(seed + i, a.shape) ** 2 for i, a in enumerate(leaves)])
    sj = jopt.AdamWState(np.asarray(1, np.int32), moments(0), moments(1000))
    jpath = jckpt.save_checkpoint(str(tmp_path / "jax"), 3, pj, sj)

    # reference -> port
    tmpl = tbuild(tcfg).init(torch.Generator().manual_seed(0))
    step, pt, st = tckpt.restore_checkpoint(jpath, tmpl,
                                            topt.adamw_init(tmpl))
    assert step == 3 and st.step == 1
    _leaves_equal(to_reference_params(pt), pj)
    for field in ("mu", "nu"):
        _leaves_equal(to_reference_params(pt, getattr(st, field)),
                      getattr(sj, field), field)

    # port -> reference
    tpath = tckpt.save_checkpoint(str(tmp_path / "torch"), 3, pt, st)
    for name in ("params.npz", "opt.npz"):
        with np.load(os.path.join(jpath, name)) as a, \
                np.load(os.path.join(tpath, name)) as b:
            assert sorted(a.files) == sorted(b.files), name
            for k in a.files:
                assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    zeros = jax.tree.map(np.zeros_like, pj)
    step, p2, s2 = jckpt.restore_checkpoint(tpath, zeros,
                                            jopt.adamw_init(zeros))
    assert step == 3 and int(s2.step) == 1
    _leaves_equal(p2, pj)
    _leaves_equal(s2.mu, sj.mu)
    _leaves_equal(s2.nu, sj.nu)
