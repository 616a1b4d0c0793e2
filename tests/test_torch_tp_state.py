"""Tensor parallelism of the port's SSM, hybrid and enc-dec families, on
the CPU.

Gloo worlds of 2 ((1, 2) mesh: ``data`` 1, ``model`` 2) and of 4 ((2, 2)),
spawned once per mesh for the whole file, each rank on one thread. Each
rank trains the reduced mamba2-130m, recurrentgemma-9b and whisper-tiny
in fp32 for 5 steps under the training rules, then prefills 80-token
prompts (past the hybrid's reduced window of 64: its ring wraps and both
ranks' slots fill) and decodes one step under the serving rules;
whisper-tiny decodes a second step, its cross-attention routed over a
store of the shared audio (4 chunks of 64 frames: split by chunk over
``data`` and by chunk position over ``model`` on (2, 2), which the test
asserts) instead of its cross cache. Its self cache of 83 positions does
not split over ``model``, so the rules split it by kv head: both of the
meshed decode's splits run.

The test process runs the same unmeshed, on one thread: losses within
1e-5 relative, the first update's gradients within 1e-5 of each leaf's
largest and their global norm within 1e-5 relative (the bounds of
``tests/test_torch_tp.py``), prefill and decode logits within 2e-5 with
the same greedy tokens. whisper's key biases have a gradient of 0 in
exact arithmetic (softmax does not see a bias added to every key): both
runs' are rounding, at most 1e-7 of the global norm, and are held to
that instead of a gap relative to their largest. whisper's meshed
decode steps are also held to the reference's own
``encdec.decode_step`` (jax on the CPU at ``highest`` precision) from
the same weights, within 2e-5.

On (1, 2) the ranks also run two variants whose dims the rules leave
whole over a ``model`` of 2 where they leave the full-size members' whole
over the production mesh's 16 (``WHOLE``; the test asserts that every
leaf splits over ``model`` alike): mamba2 with 15 heads and a vocab of 511
(``in_proj``, the head vectors and the embedding whole, the conv's
channels and ``out_proj``'s rows split), whisper with 3 heads and a vocab
of 511 (the projections' columns split, the heads and the embedding
whole). They are held to one process as the reduced archs are, but for
the mamba2 variant's head vectors (``a_log``, ``dt_bias``): with the
heads whole each rank's gradient of them is a partial sum over its share
of ``out_proj``'s rows, the two partials cancel, and the meshed gradient
came 1.6e-05 of the leaf's largest from one process's. They are held
at ``NOISY_GRAD``, and the same first update in float64 (every fp32
tensor made float64, in the ranks' processes only) is held within
``FP64_GRAD`` of each leaf's largest: the meshed arithmetic is one
process's, the fp32 gap rounding.

The mutation check: on (1, 2) the ranks run mamba2 and the hybrid once
more with ``tensor_parallel.concat_whole`` replaced by a rank that takes
its local columns of a concatenated projection (mamba2's z | x | B | C |
dt, the RG-LRU's xa | xb and r | i) as if they were its slice of each
part; its first loss and prefill logits must then be off.
"""
from __future__ import annotations

import contextlib
import dataclasses
import datetime
import time

import numpy as np
import pytest
import torch

from test_torch_tp import (BATCH, GRAD_REL, LOGIT_TOL, REL, SEQ, STEPS,
                           _first_update)

ARCHS = ("mamba2-130m", "recurrentgemma-9b", "whisper-tiny")
MUTATED = ARCHS[:2]
# a gradient that is 0 in exact arithmetic (whisper's key biases), at most
# this share of the global norm
ZERO_GRAD = 1e-7
# the serving steps: requests, prompt, cache positions (odd), audio frames
B, PROMPT, MAX_SEQ, FRAMES = 4, 80, 83, 256
# variants of the reduced archs whose dims divide 2 where the full-size
# members' divide 16 (run on (1, 2) only)
WHOLE = {"mamba2-130m/whole": dict(d_model=240, vocab_size=511),
         "whisper-tiny/whole": dict(d_model=192, num_heads=3, num_kv_heads=3,
                                    vocab_size=511)}
# the mamba2 variant's head vectors' first gradients, of their largest;
# the float64 run's gradients, of each leaf's largest
NOISY_GRAD = {"mamba2-130m/whole": {"layers.a_log": 1e-4,
                                    "layers.dt_bias": 1e-4}}
FP64_GRAD = 1e-11


def _loop(steps=STEPS):
    from repro_torch.training.train_loop import TrainLoopConfig
    return TrainLoopConfig(num_steps=steps, batch_size=BATCH, seq_len=SEQ,
                           log_every=1)


def _cfg(arch):
    from repro_torch.configs import get_config
    cfg = dataclasses.replace(get_config(arch.split("/")[0]).reduced(),
                              dtype="float32", **WHOLE.get(arch, {}))
    if cfg.encoder.enabled:
        cfg = dataclasses.replace(cfg, encoder=dataclasses.replace(
            cfg.encoder, frontend_seq=FRAMES, frontend_dim=cfg.d_model))
    return cfg


def _inputs(cfg):
    """Weights, B prompts, two next tokens and (whisper) one audio's frames
    behind every prompt, all from seeds (the same on every rank)."""
    from repro_torch.models.model import build_model
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(1))
    g = np.random.default_rng(5)
    tokens = torch.from_numpy(g.integers(0, cfg.vocab_size, (B, PROMPT)))
    nxt = torch.from_numpy(g.integers(0, cfg.vocab_size, (2, B)))
    frames = None
    if cfg.encoder.enabled:
        frames = torch.from_numpy(np.broadcast_to(g.standard_normal(
            (1, FRAMES, cfg.d_model)), (B, FRAMES, cfg.d_model))
            .astype(np.float32).copy())
    return model, params, tokens, nxt, frames


def _serve(cfg, mesh=None):
    """Prefill, one decode step, and for whisper a second step routed over
    a store of the audio's cross K/V (built from the run's own cross
    cache); with ``mesh`` each on ``DTensor`` inputs placed by the serving
    rules. Returns {name: logits whole} and the store's split axes."""
    from repro_torch.core.shared_kv import build_store
    from repro_torch.launch.input_specs import _CACHE_AXES, _STORE_AXES
    from repro_torch.sharding import SERVE_RULES, use_rules
    from repro_torch.sharding.tensor_parallel import (full_tensor, place,
                                                      place_fields,
                                                      split_axes)
    from repro_torch.training.train_loop import tensor_parallel
    model, params, tokens, nxt, frames = _inputs(cfg)
    cache = model.init_cache(B, MAX_SEQ, dtype=torch.float32)
    out, axes = {}, {}
    with use_rules(SERVE_RULES if mesh is not None else None):
        if mesh is not None:
            tensor_parallel(model, params, mesh)
            cache = place_fields(cache, _CACHE_AXES, SERVE_RULES, mesh)
            tokens, frames = (None if t is None else
                              place(t, ("batch",), SERVE_RULES, mesh)
                              for t in (tokens, frames))
            nxt = [place(t, ("batch",), SERVE_RULES, mesh) for t in nxt]
        whole = full_tensor if mesh is not None else (lambda t: t)
        out["prefill"], cache = model.prefill(params, tokens, cache,
                                              frontend_embeds=frames)
        out["decode"], cache = model.decode_step(params, nxt[0], cache)
        if cfg.encoder.enabled:
            C = cfg.moska.chunk_size
            store = build_store(whole(cache["cross_k"])[:, 0],
                                whole(cache["cross_v"])[:, 0], C)
            if mesh is not None:
                store = place_fields(store, _STORE_AXES, SERVE_RULES, mesh)
                axes = {"chunks": split_axes(store.k, 1),
                        "positions": split_axes(store.k, 2),
                        "self heads": split_axes(cache["self_k"], 3),
                        "cross positions": split_axes(cache["cross_k"], 2)}
            out["routed"], _ = model.decode_step(params, nxt[1], cache,
                                                 store=store)
        out = {k: whole(v).detach().numpy() for k, v in out.items()}
    return out, axes


def _naive_concat_whole(t, span, parts, mesh):
    """The first trap: this rank's columns of a concatenated product taken
    as its slice of each part (the parts' slices gathered whole)."""
    from repro_torch.sharding import tensor_parallel as tp
    n = mesh["model"].size()
    pieces = t.split([p // n for p in parts], dim=-1)
    return torch.cat([tp.Gather.apply(x, t.ndim - 1, mesh, "model", p, True)
                      for x, p in zip(pieces, parts)], dim=-1)


@contextlib.contextmanager
def _float64():
    """Every fp32 tensor made float64 (``torch.float32``, ``.float()``,
    the default dtype and the model's initial weights): for a process of
    its own."""
    from repro_torch.models.model import Model
    saved = (torch.float32, torch.Tensor.float, Model.init,
             torch.get_default_dtype())
    init = Model.init
    torch.float32 = torch.float64
    torch.Tensor.float = torch.Tensor.double
    Model.init = lambda self, *a, **k: init(self, *a, **k).double()
    torch.set_default_dtype(torch.float64)
    try:
        yield
    finally:
        torch.float32, torch.Tensor.float, Model.init, dtype = saved
        torch.set_default_dtype(dtype)


def _first_grads(cfg, mesh=None):
    """The first update's gradients of one training step, whole."""
    from repro_torch.data.pipeline import make_train_batches
    from repro_torch.sharding import TRAIN_RULES, use_rules
    from repro_torch.training.train_loop import train
    with use_rules(TRAIN_RULES if mesh is not None else None), \
            _first_update() as first:
        train(cfg, _loop(1), make_train_batches(cfg, BATCH, SEQ),
              device="cpu", mesh=mesh)
    return first["grads"]


def _rank(rank, world, shape, out_dir):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.data.pipeline import make_train_batches
    from repro_torch.sharding import TRAIN_RULES, use_rules
    from repro_torch.sharding import tensor_parallel as tp
    from repro_torch.training.train_loop import train
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{out_dir}/rdzv",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=120))
    try:
        mesh = init_device_mesh("cpu", shape,
                                mesh_dim_names=("data", "model"))
        res = {}
        for arch in ARCHS + (tuple(WHOLE) if shape == (1, 2) else ()):
            cfg = _cfg(arch)
            with use_rules(TRAIN_RULES), _first_update() as first:
                out = train(cfg, _loop(), make_train_batches(cfg, BATCH, SEQ),
                            device="cpu", mesh=mesh)
            res[f"{arch}/loss"] = np.array([h["loss"]
                                            for h in out["history"]])
            res[f"{arch}/gnorm"] = np.array(first["gnorm"])
            for n, g in first["grads"].items():
                res[f"{arch}/g/{n}"] = g
            logits, axes = _serve(cfg, mesh)
            for k, v in logits.items():
                res[f"{arch}/{k}"] = v
            for k, v in axes.items():
                res[f"{arch}/axes/{k}"] = np.array(v, dtype=str)
        if shape == (1, 2):
            real, tp.concat_whole = tp.concat_whole, _naive_concat_whole
            try:
                for arch in MUTATED:
                    cfg = _cfg(arch)
                    with use_rules(TRAIN_RULES):
                        out = train(cfg, _loop(1),
                                    make_train_batches(cfg, BATCH, SEQ),
                                    device="cpu", mesh=mesh)
                    res[f"naive/{arch}/loss"] = np.array(
                        out["history"][0]["loss"])
                    res[f"naive/{arch}/prefill"] = _serve(cfg, mesh)[0][
                        "prefill"]
            finally:
                tp.concat_whole = real
            with _float64():
                for arch in NOISY_GRAD:
                    cfg = _cfg(arch)
                    for n, g in _first_grads(cfg, mesh).items():
                        res[f"fp64/{arch}/g/{n}"] = g
                    if rank == 0:
                        for n, g in _first_grads(cfg).items():
                            res[f"fp64/{arch}/plain/{n}"] = g
        if rank == 0:
            np.savez(f"{out_dir}/tp.npz", **res)
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
    with np.load(out_dir / "tp.npz") as f:
        return dict(f)


_RUNS = {}


def _run(shape, tmp_path_factory):
    """The ranks' results on a mesh of ``shape``, spawned once."""
    if shape not in _RUNS:
        _RUNS[shape] = _spawn(shape[0] * shape[1], shape,
                              tmp_path_factory.mktemp(
                                  f"tps{shape[0]}x{shape[1]}"))
    return _RUNS[shape]


@pytest.fixture(scope="module", params=[(1, 2), (2, 2)],
                ids=["mesh1x2", "mesh2x2"])
def meshed(request, tmp_path_factory):
    return _run(request.param, tmp_path_factory)


@pytest.fixture(scope="module")
def mesh1x2(tmp_path_factory):
    """The (1, 2) ranks' runs: the ``WHOLE`` variants' and those with the
    naive split besides the reduced archs'."""
    return _run((1, 2), tmp_path_factory)


@pytest.fixture(scope="module")
def plain():
    """The unmeshed runs, on one thread as each rank runs."""
    from repro_torch.data.pipeline import make_train_batches
    from repro_torch.training.train_loop import train
    out = {}
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        for arch in ARCHS + tuple(WHOLE):
            cfg = _cfg(arch)
            with _first_update() as first:
                run = train(cfg, _loop(), make_train_batches(cfg, BATCH, SEQ),
                            device="cpu")
            out[arch] = (run, _serve(cfg)[0], first)
    finally:
        torch.set_num_threads(threads)
    return out


def _trained_alike(meshed, plain, arch):
    """Losses every step, and the first update's gradients leaf by leaf
    (``NOISY_GRAD``'s leaves at their own bound) and their global
    norm."""
    run, _, first = plain[arch]
    want = np.array([h["loss"] for h in run["history"]])
    got = meshed[f"{arch}/loss"]
    print(f"{arch}: losses {got} vs {want}")
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=REL)
    gaps = {}
    for n, w in first["grads"].items():
        g = meshed[f"{arch}/g/{n}"]
        assert g.shape == w.shape, n
        if n.endswith(".bk"):
            # softmax does not see a bias added to every key: the key
            # bias's gradient is 0, both runs' are rounding
            assert max(np.abs(g).max(), np.abs(w).max()) <= \
                ZERO_GRAD * first["gnorm"], n
            continue
        gaps[n] = np.abs(g - w).max() / np.abs(w).max()
    noisy = NOISY_GRAD.get(arch, {})
    for n in noisy:
        print(f"{arch}: {n} gradient gap {gaps[n]:.3e} of its largest")
        assert gaps.pop(n) <= noisy[n], n
    worst = max(gaps, key=gaps.get)
    gn = float(meshed[f"{arch}/gnorm"])
    print(f"{arch}: largest gradient gap {gaps[worst]:.3e} of its leaf's "
          f"largest ({worst}); global norm {gn:.8e} vs {first['gnorm']:.8e}")
    assert gaps[worst] <= GRAD_REL, (worst, gaps[worst])
    assert abs(gn - first["gnorm"]) <= GRAD_REL * first["gnorm"]


def _served_alike(meshed, plain, arch):
    """Prefill and decode logits (whisper's routed step too) within 2e-5,
    the same greedy tokens."""
    want = plain[arch][1]
    for key, w in want.items():
        got = meshed[f"{arch}/{key}"]
        print(f"{arch} {key}: max_abs_err {np.abs(got - w).max():.3e}")
        np.testing.assert_allclose(got, w, rtol=LOGIT_TOL, atol=LOGIT_TOL)
        np.testing.assert_array_equal(got.argmax(-1), w.argmax(-1))


@pytest.mark.parametrize("arch", ARCHS)
def test_state_families_train_as_one_process(meshed, plain, arch):
    """Losses every step, and the first update's gradients leaf by leaf
    and their global norm."""
    _trained_alike(meshed, plain, arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_state_families_serve_as_one_process(meshed, plain, arch):
    """Prefill and decode logits (whisper's routed step too) within 2e-5,
    the same greedy tokens."""
    _served_alike(meshed, plain, arch)


@pytest.mark.parametrize("arch", tuple(WHOLE))
def test_whole_dims_split_as_the_full_size_members(arch):
    """Every leaf of a ``WHOLE`` variant splits over a ``model`` of 2, dim
    by dim, where the full-size member's splits over the production
    mesh's 16, under the training and the serving rules; so do the
    heads."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import empty_params
    from repro_torch.sharding import SERVE_RULES, TRAIN_RULES
    from repro_torch.sharding.specs import param_spec
    small, full = _cfg(arch), get_config(arch.split("/")[0])

    def over_model(cfg, mesh, rules):
        return {n: tuple("model" in ((a,) if isinstance(a, str) else a or ())
                         for a in param_spec(n, t.shape, rules, mesh))
                for n, t in empty_params(cfg, "meta").named_parameters()}
    for rules in (TRAIN_RULES, SERVE_RULES):
        got = over_model(small, {"data": 1, "model": 2}, rules)
        want = over_model(full, {"data": 16, "model": 16}, rules)
        assert got == want

    def heads(cfg):          # the SSM's: its head vectors' length
        return (cfg.d_model * cfg.ssm.expand // cfg.ssm.head_dim
                if cfg.family == "ssm" else cfg.num_heads)
    assert heads(small) % 2 and heads(full) % 16


@pytest.mark.parametrize("arch", tuple(WHOLE))
def test_whole_dims_train_and_serve_as_one_process(mesh1x2, plain, arch):
    """The ``WHOLE`` variants on (1, 2), held as the reduced archs are."""
    _trained_alike(mesh1x2, plain, arch)
    _served_alike(mesh1x2, plain, arch)


def test_whisper_store_and_caches_split_as_the_rules_say(meshed):
    """The routed step's store is split by chunk over ``data`` (on (2, 2))
    and by chunk position over ``model``; the self cache (83 positions)
    by kv head, the cross cache by position."""
    axes = {k.split("/")[-1]: tuple(v) for k, v in meshed.items()
            if k.startswith("whisper-tiny/axes/")}
    assert axes["chunks"] == ("data",), axes
    assert axes["positions"] == ("model",), axes
    assert axes["self heads"] == ("model",), axes
    assert axes["cross positions"] == ("model",), axes


def test_whisper_decode_equals_the_reference(meshed, plain):
    """whisper-tiny's meshed decode steps (cross cache, then routed over
    the store) against the reference's ``encdec.decode_step`` on the same
    weights, prompts and frames (its store built from its own cross
    cache)."""
    import jax
    import jax.numpy as jnp
    from repro.core.shared_kv import build_store
    from repro.models import encdec as jed
    from repro_torch.convert import to_reference_params
    cfg = _cfg("whisper-tiny")
    from repro.configs import get_config as jget
    jcfg = dataclasses.replace(jget("whisper-tiny").reduced(),
                               dtype="float32")
    jcfg = dataclasses.replace(jcfg, encoder=dataclasses.replace(
        jcfg.encoder, frontend_seq=FRAMES))
    _, params, tokens, nxt, frames = _inputs(cfg)
    pj = jax.tree.map(jnp.asarray, to_reference_params(params))
    cache = jed.init_cache(jcfg, B, MAX_SEQ, jnp.float32)
    _, cache = jax.jit(lambda p, t, c, f: jed.prefill(
        jcfg, p, t, c, frontend_embeds=f))(
        pj, jnp.asarray(tokens.numpy(), jnp.int32), cache,
        jnp.asarray(frames.numpy()))
    step = jax.jit(lambda p, t, c, s: jed.decode_step(jcfg, p, t, c,
                                                      store=s))
    ld, cache = step(pj, jnp.asarray(nxt[0].numpy(), jnp.int32), cache,
                     None)
    store = build_store(cache["cross_k"][:, 0], cache["cross_v"][:, 0],
                        jcfg.moska.chunk_size)
    lr, _ = step(pj, jnp.asarray(nxt[1].numpy(), jnp.int32), cache, store)
    for key, w in (("decode", np.asarray(ld)), ("routed", np.asarray(lr))):
        got = meshed[f"whisper-tiny/{key}"]
        print(f"whisper {key} vs the reference: max_abs_err "
              f"{np.abs(got - w).max():.3e}")
        np.testing.assert_allclose(got, w, rtol=LOGIT_TOL, atol=LOGIT_TOL)
        np.testing.assert_array_equal(got.argmax(-1), w.argmax(-1))


@pytest.mark.parametrize("arch", tuple(NOISY_GRAD))
def test_whole_dims_gradients_in_float64_equal_one_process(mesh1x2, arch):
    """The first update of the ``NOISY_GRAD`` variant in float64 on (1, 2)
    against one process in float64: every leaf within ``FP64_GRAD`` of its
    largest, so the fp32 gaps of its head vectors are rounding."""
    plain = {k.rsplit("/", 1)[1]: v for k, v in mesh1x2.items()
             if k.startswith(f"fp64/{arch}/plain/")}
    assert plain and all(v.dtype == np.float64 for v in plain.values())
    gaps = {n: np.abs(mesh1x2[f"fp64/{arch}/g/{n}"] - w).max()
            / np.abs(w).max() for n, w in plain.items()}
    worst = max(gaps, key=gaps.get)
    print(f"{arch} in float64: largest gradient gap {gaps[worst]:.3e} of "
          f"its leaf's largest ({worst})")
    assert gaps[worst] <= FP64_GRAD, (worst, gaps[worst])


@pytest.mark.parametrize("arch", MUTATED)
def test_naive_split_of_a_concatenated_projection_fails(mesh1x2, plain,
                                                        arch):
    """On (1, 2), a rank that takes its local columns of in_proj / lru_in
    / the gate product as its slice of each part computes another model:
    its first loss and its prefill logits are far outside the bounds
    above."""
    run, serve, _ = plain[arch]
    loss = float(mesh1x2[f"naive/{arch}/loss"])
    want = run["history"][0]["loss"]
    err = np.abs(mesh1x2[f"naive/{arch}/prefill"] - serve["prefill"]).max()
    print(f"{arch} naive split: first loss {loss:.6f} vs {want:.6f}, "
          f"prefill max_abs_err {err:.3e}")
    assert abs(loss - want) > 100 * REL * abs(want)
    assert err > 100 * LOGIT_TOL
