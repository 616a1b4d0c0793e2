"""Expert parallelism of the port's MoE members, on the CPU.

Gloo worlds of 2 ((1, 2) mesh: ``data`` 1, ``model`` 2) and of 4 ((2, 2)),
spawned once per mesh for the whole file, each rank on one thread. Each
rank trains the reduced granite-moe-1b-a400m and arctic-480b (with its
dense residual) in fp32 for 5 steps under the training rules, then
prefills and decodes one routed step over a store split by chunk and by
chunk position under the serving rules; on (2, 2) it also decodes under
``--variant expert_resident`` (experts over ``data``, their d dim over
``model``) and runs the meshed ``moe_ffn`` alone on a global batch. The
capacity factor is lowered to 0.25 so that the rows of both data ranks
drop slots (asserted on the unmeshed runs): a slot placed without the
earlier ranks' counts would keep what the global batch drops.

The test process runs the same unmeshed, on one thread: losses and the
aux loss within 1e-5 relative, the first update's gradients within 1e-5
of each leaf's largest and its global norm within 1e-5 relative, the
final parameters within 2e-4 of each leaf's scale (the bounds of
``tests/test_torch_tp.py``, which says why), the decode logits within
2e-5 with the same greedy tokens. The meshed layer alone is held to the
reference's ``repro.models.moe.moe_ffn`` on the global batch (jax on the
CPU at ``highest`` precision) within 2e-5.
"""
from __future__ import annotations

import contextlib
import dataclasses
import datetime
import time

import numpy as np
import pytest
import torch

from test_torch_tp import (B, BATCH, GRAD_REL, LOGIT_TOL, MAX_SEQ,
                           PARAM_REL, REL, SEQ, _decode_inputs, _first_update,
                           _loop, _loss_after, _lr_sum)

ARCHS = ("granite-moe-1b-a400m", "arctic-480b")
CAPACITY_FACTOR = 0.25
RESIDENT = "expert_resident"
# the layer alone: global rows
LAYER_T = 32


def _cfg(arch):
    from repro_torch.configs import get_config
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=CAPACITY_FACTOR))


def _layer_inputs(cfg):
    """x (LAYER_T, d) and the layer's weights, numpy from a seed."""
    g = np.random.default_rng(11)
    d, f, E = cfg.d_model, cfg.d_ff, cfg.moe.num_experts
    x = g.standard_normal((LAYER_T, d))
    p = {"router": g.standard_normal((d, E)) / np.sqrt(d),
         "e_gate": g.standard_normal((E, d, f)) / np.sqrt(d),
         "e_up": g.standard_normal((E, d, f)) / np.sqrt(d),
         "e_down": g.standard_normal((E, f, d)) / np.sqrt(f)}
    return x.astype(np.float32), {k: v.astype(np.float32)
                                  for k, v in p.items()}


def _kept(x, router, cfg):
    """(T, K) bool: the slots that the one-process layer keeps."""
    from repro_torch.core.router import top_k
    from repro_torch.models.moe import moe_capacity
    T, K, E = x.shape[0], cfg.top_k, cfg.num_experts
    cap = min(moe_capacity(T, cfg), T * K)
    _, ids = top_k(torch.softmax(x.float() @ router, dim=-1), K)
    onehot = torch.nn.functional.one_hot(ids.reshape(-1), E)
    pos = (onehot.cumsum(dim=0) - 1).mul_(onehot).sum(dim=1)
    return (pos < cap).view(T, K)


@contextlib.contextmanager
def _drops():
    """Records, for each unmeshed MoE call, whether the first and the
    second half of its rows (the two data ranks' on (2, 2)) drop slots."""
    from repro_torch.models import moe
    real, seen = moe.moe_ffn, []

    def wrapped(x, p, cfg, *args, **kw):
        with torch.no_grad():
            dropped = ~_kept(x, p["router"], cfg).all(dim=1)
        seen.append(tuple(bool(h.any()) for h in dropped.chunk(2)))
        return real(x, p, cfg, *args, **kw)

    moe.moe_ffn = wrapped
    try:
        yield seen
    finally:
        moe.moe_ffn = real


def _decode(cfg, mesh=None, variant=None):
    """Prefill (no store) and one routed decode step; with ``mesh`` on
    ``DTensor`` inputs placed by the serving rules (and ``variant``).
    Returns (prefill logits, decode logits) whole."""
    from repro_torch.launch.input_specs import _CACHE_AXES, _STORE_AXES
    from repro_torch.sharding import SERVE_RULES, apply_variant, use_rules
    from repro_torch.sharding.tensor_parallel import (full_tensor, place,
                                                      place_fields)
    from repro_torch.training.train_loop import tensor_parallel
    model, params, store, tokens, nxt, _ = _decode_inputs(cfg)
    cache = model.init_cache(B, MAX_SEQ, dtype=torch.float32)
    if mesh is None:
        lp, cache = model.prefill(params, tokens, cache)
        ld, _ = model.decode_step(params, nxt, cache, store=store)
        return lp, ld
    rules = apply_variant(SERVE_RULES, variant)
    with use_rules(rules):
        tensor_parallel(model, params, mesh)
        cache = place_fields(cache, _CACHE_AXES, rules, mesh)
        store = place_fields(store, _STORE_AXES, rules, mesh)
        tokens, nxt = (place(t, ("batch",), rules, mesh)
                       for t in (tokens, nxt))
        lp, cache = model.prefill(params, tokens, cache)
        ld, _ = model.decode_step(params, nxt, cache, store=store)
    return full_tensor(lp), full_tensor(ld)


def _layer(cfg, mesh):
    """The meshed ``moe_ffn`` on the global batch of ``_layer_inputs``:
    x split by rows, the weights at the training rules' placements.
    Returns (y, aux) whole."""
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.models.moe import moe_ffn
    from repro_torch.sharding import TRAIN_RULES, lsc, use_rules
    from repro_torch.sharding import specs as sp
    from repro_torch.sharding.tensor_parallel import full_tensor, place
    x, p = _layer_inputs(cfg)
    with use_rules(TRAIN_RULES), torch.no_grad():
        pm = {k: distribute_tensor(torch.from_numpy(v), mesh, sp.placements(
            sp.param_spec(k, v.shape, TRAIN_RULES, mesh), mesh))
            for k, v in p.items()}
        y, aux = moe_ffn(place(torch.from_numpy(x), ("batch", None),
                               TRAIN_RULES, mesh), pm, cfg.moe)
        y = lsc(y, "batch", None)
    return full_tensor(y), full_tensor(aux)


def _rank(rank, world, shape, out_dir):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.data.pipeline import make_train_batches
    from repro_torch.sharding import TRAIN_RULES, use_rules
    from repro_torch.sharding.tensor_parallel import full_tensor
    from repro_torch.training.train_loop import train
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{out_dir}/rdzv",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=120))
    try:
        mesh = init_device_mesh("cpu", shape,
                                mesh_dim_names=("data", "model"))
        res = {}
        for arch in ARCHS:
            cfg = _cfg(arch)
            with use_rules(TRAIN_RULES), _first_update() as first:
                out = train(cfg, _loop(), make_train_batches(cfg, BATCH, SEQ),
                            device="cpu", mesh=mesh)
            for key in ("loss", "moe_aux"):
                res[f"{arch}/{key}"] = np.array([h[key]
                                                 for h in out["history"]])
            res[f"{arch}/gnorm"] = np.array(first["gnorm"])
            for n, g in first["grads"].items():
                res[f"{arch}/g/{n}"] = g
            for n, p in out["params"].named_parameters():
                res[f"{arch}/p/{n}"] = full_tensor(p).numpy()
            res[f"{arch}/prefill"], res[f"{arch}/decode"] = (
                t.numpy() for t in _decode(cfg, mesh))
            if shape == (2, 2):
                res[f"{arch}/{RESIDENT}"] = _decode(cfg, mesh, RESIDENT)[1] \
                    .numpy()
                res[f"{arch}/layer/y"], res[f"{arch}/layer/aux"] = (
                    t.numpy() for t in _layer(cfg, mesh))
        if rank == 0:
            np.savez(f"{out_dir}/ep.npz", **res)
    finally:
        dist.destroy_process_group()


def _spawn(world, shape, out_dir, timeout=300):
    ctx = torch.multiprocessing.start_processes(
        _rank, args=(world, shape, str(out_dir)), nprocs=world, join=False,
        start_method="spawn")
    deadline = time.monotonic() + timeout
    while not ctx.join(timeout=1):
        if time.monotonic() > deadline:
            for proc in ctx.processes:
                proc.kill()
            raise TimeoutError(f"{world} ranks outlasted {timeout} s")
    with np.load(out_dir / "ep.npz") as f:
        return dict(f)


_WORLDS = {}


def _world(shape, tmp_path_factory):
    """The ranks' results on the mesh ``shape``, one spawned world per
    mesh for the whole file."""
    if shape not in _WORLDS:
        _WORLDS[shape] = _spawn(
            shape[0] * shape[1], shape,
            tmp_path_factory.mktemp(f"ep{shape[0]}x{shape[1]}"))
    return _WORLDS[shape]


@pytest.fixture(scope="module", params=[(1, 2), (2, 2)],
                ids=["mesh1x2", "mesh2x2"])
def meshed(request, tmp_path_factory):
    return _world(request.param, tmp_path_factory)


@pytest.fixture(scope="module")
def mesh2x2(tmp_path_factory):
    return _world((2, 2), tmp_path_factory)


@pytest.fixture(scope="module")
def plain():
    """The unmeshed runs on one thread, and whether each of their MoE
    calls dropped slots in both halves of its rows."""
    from repro_torch.data.pipeline import make_train_batches
    from repro_torch.training.train_loop import train
    out = {}
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        for arch in ARCHS:
            cfg = _cfg(arch)
            with _first_update() as first, _drops() as train_drops:
                run = train(cfg, _loop(), make_train_batches(cfg, BATCH, SEQ),
                            device="cpu")
            with _drops() as decode_drops:
                logits = _decode(cfg)
            out[arch] = (run, *logits, first, train_drops, decode_drops)
    finally:
        torch.set_num_threads(threads)
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_expert_parallel_trains_as_one_process(meshed, plain, arch):
    """5 steps: the losses and the aux loss, the final parameters and
    their loss on the next batch, against one process; the rows of both
    data ranks drop slots in every step's layers."""
    got = meshed
    run, _, _, _, drops, _ = plain[arch]
    assert drops and all(a and b for a, b in drops), drops
    for key in ("loss", "moe_aux"):
        want = np.array([h[key] for h in run["history"]])
        assert got[f"{arch}/{key}"].shape == want.shape
        np.testing.assert_allclose(got[f"{arch}/{key}"], want, rtol=REL)
    moved = _lr_sum()
    gaps = {}
    for n, p in run["params"].named_parameters():
        scale = max(float(p.abs().max()), moved)
        gaps[n] = np.abs(got[f"{arch}/p/{n}"] - p.numpy()).max() / scale
    worst = max(gaps, key=gaps.get)
    print(f"{arch}: largest parameter gap {gaps[worst]:.3e} of its scale "
          f"({worst})")
    assert gaps[worst] <= PARAM_REL, (worst, gaps[worst])
    after = [_loss_after(_cfg(arch), values) for values in (
        {n: got[f"{arch}/p/{n}"] for n, _ in run["params"].named_parameters()},
        {n: p.detach().numpy() for n, p in run["params"].named_parameters()})]
    assert abs(after[0] - after[1]) <= REL * abs(after[1])


@pytest.mark.parametrize("arch", ARCHS)
def test_expert_parallel_first_gradients_equal_one_process(meshed, plain,
                                                           arch):
    """The first AdamW update's gradients (every leaf within GRAD_REL of
    its largest unmeshed gradient: the experts', the router's, the dense
    residual's) and their global norm."""
    got = meshed
    first = plain[arch][3]
    gaps = {}
    for n, want in first["grads"].items():
        g = got[f"{arch}/g/{n}"]
        assert g.shape == want.shape, n
        gaps[n] = np.abs(g - want).max() / np.abs(want).max()
    worst = max(gaps, key=gaps.get)
    gn = float(got[f"{arch}/gnorm"])
    print(f"{arch}: largest gradient gap {gaps[worst]:.3e} of its leaf's "
          f"largest ({worst}); global norm {gn:.8e} vs "
          f"{first['gnorm']:.8e}")
    assert gaps[worst] <= GRAD_REL, (worst, gaps[worst])
    assert abs(gn - first["gnorm"]) <= GRAD_REL * first["gnorm"]


@pytest.mark.parametrize("arch", ARCHS)
def test_expert_parallel_decode_over_a_chunk_sharded_store(meshed, plain,
                                                           arch):
    """The prefill (whose rows drop slots in both halves) and one routed
    decode step: logits within LOGIT_TOL, the same greedy tokens."""
    got = meshed
    _, lp, ld, _, _, drops = plain[arch]
    assert any(a and b for a, b in drops), drops
    print(f"{arch}: logits max_abs_err prefill "
          f"{np.abs(got[f'{arch}/prefill'] - lp.numpy()).max():.3e}, "
          f"decode {np.abs(got[f'{arch}/decode'] - ld.numpy()).max():.3e}")
    for key, want in (("prefill", lp), ("decode", ld)):
        np.testing.assert_allclose(got[f"{arch}/{key}"], want.numpy(),
                                   rtol=LOGIT_TOL, atol=LOGIT_TOL)
    np.testing.assert_array_equal(got[f"{arch}/decode"].argmax(-1),
                                  ld.numpy().argmax(-1))


@pytest.mark.parametrize("arch", ARCHS)
def test_expert_resident_decode_equals_one_process(mesh2x2, plain, arch):
    """The decode step under ``expert_resident`` on (2, 2): the experts
    split over ``data``, their d dim over ``model``."""
    ld = plain[arch][2].numpy()
    got = mesh2x2[f"{arch}/{RESIDENT}"]
    print(f"{arch} {RESIDENT}: decode logits max_abs_err "
          f"{np.abs(got - ld).max():.3e}")
    np.testing.assert_allclose(got, ld, rtol=LOGIT_TOL, atol=LOGIT_TOL)
    np.testing.assert_array_equal(got.argmax(-1), ld.argmax(-1))


@pytest.mark.parametrize("arch", ARCHS)
def test_meshed_layer_equals_the_reference(mesh2x2, arch):
    """The meshed ``moe_ffn`` on (2, 2) against the reference's on the
    global batch, with slots dropped in both data ranks' rows."""
    got = mesh2x2
    import jax.numpy as jnp
    from repro.configs.base import MoEConfig
    from repro.models import moe as jmoe
    cfg = _cfg(arch)
    x, p = _layer_inputs(cfg)
    kept = _kept(torch.from_numpy(x), torch.from_numpy(p["router"]),
                 cfg.moe)
    halves = [bool((~h).any()) for h in kept.chunk(2)]
    assert halves == [True, True], halves
    jcfg = MoEConfig(**dataclasses.asdict(cfg.moe))
    y, aux = jmoe.moe_ffn(jnp.asarray(x), {k: jnp.asarray(v)
                                           for k, v in p.items()}, jcfg)
    err = np.abs(got[f"{arch}/layer/y"] - np.asarray(y)).max()
    print(f"{arch}: meshed layer vs reference max_abs_err {err:.3e}, "
          f"{int((~kept).sum())} of {kept.numel()} slots dropped")
    np.testing.assert_allclose(got[f"{arch}/layer/y"], np.asarray(y),
                               rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got[f"{arch}/layer/aux"], float(aux),
                               rtol=2e-5, atol=2e-5)
