"""Training under a mesh (``train(..., mesh=)``, ``--host-mesh``): FSDP
over the ``data`` axis must train as the unmeshed loop does, and as the
reference trains under its host mesh, on the CPU.

A gloo world of 2 (``torch.multiprocessing``, a file rendezvous, a 60 s
collective timeout) trains reduced tinyllama, granite-moe (its capacity
factor cut to 0.5 so that experts drop slots: the global capacity and
slot positions then decide which) and mamba2 for 5 steps in fp32, on the
same seeded global batches as a single-process ``train``, each rank on
its rows. Every step's loss (and ``moe_aux``) must be within 1e-5
relative: the ranks add the same terms as the single process, only in
another order. The final parameters must agree leaf by leaf within 1e-5
of the leaf's scale: the larger of its largest element and the sum of
the steps' learning rates, how far AdamW can move an element (the scale
of the norm scales, which start at 0). The reordering moved them by at
most 2e-6 of it. A forward of the final parameters on the batch after
the last must give the same loss within 1e-5 relative: that holds the
last update too, which no logged loss sees. The reference's ``train``
runs the same 5 steps from the same weights under its host mesh (a
subprocess on 2 forced CPU devices with ``Auto`` axes, its
``TRAIN_RULES`` installed): the meshed run's losses, and its loss after
them, must be within 1e-5 relative of the reference's (they were within
2e-7). A world of one must equal the unmeshed run bit for bit.
"""
import dataclasses
import datetime
import json
import os
import shutil
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

REL = 1e-5              # losses; parameters: of each leaf's scale
ROOT = Path(__file__).resolve().parents[1]
STEPS, BATCH, SEQ = 5, 4, 32
ARCHS = ("tinyllama-1.1b", "granite-moe-1b-a400m", "mamba2-130m")


def _cfg(arch):
    from repro_torch.configs import get_config
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
    if cfg.moe is not None:
        cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=0.5))
    return cfg


def _bf16_cfg():
    from repro_torch.configs import get_config
    return get_config("granite-moe-1b-a400m").reduced()


def _loop(**kw):
    from repro_torch.training.train_loop import TrainLoopConfig
    kw = dict(dict(num_steps=STEPS, batch_size=BATCH, seq_len=SEQ,
                   log_every=1), **kw)
    return TrainLoopConfig(**kw)


def _batches(cfg):
    from repro_torch.data.pipeline import make_train_batches
    return make_train_batches(cfg, BATCH, SEQ)


def _mesh(device="cpu"):
    from repro_torch.launch.mesh import make_host_mesh
    return make_host_mesh(device=device)


def _full(params):
    return {n: (p.full_tensor() if hasattr(p, "full_tensor") else p)
            .detach().clone() for n, p in params.named_parameters()}


def _moe_inputs(cfg, T=64):
    g = np.random.default_rng(7)
    x = torch.from_numpy(g.standard_normal((T, cfg.d_model))
                         .astype(np.float32))
    from repro_torch.models.model import build_model
    params = build_model(cfg).init(torch.Generator().manual_seed(3))
    return x, params.layers[0].moe


def _init(cfg):
    """The weights that ``train`` draws on the CPU from seed 0."""
    from repro_torch.models.model import build_model
    return build_model(cfg).init(torch.Generator("cpu").manual_seed(0),
                                 torch.device("cpu"))


def _loss_after(cfg, values):
    """The loss of the parameters ``values`` ({name: numpy array}) on the
    batch after the run's last: the 6th of the stream."""
    from repro_torch.models.model import build_model
    from repro_torch.training.train_loop import to_device
    params = _init(cfg)
    with torch.no_grad():
        for n, p in params.named_parameters():
            p.copy_(torch.as_tensor(values[n]))
        batches = _batches(cfg)
        for _ in range(STEPS):
            next(batches)
        loss, _ = build_model(cfg).train_loss(
            params, to_device(next(batches), torch.device("cpu")),
            remat=False)
    return float(loss)


def _backward_on_a_side_thread(loss):
    """``loss.backward()`` on a thread of its own, as autograd runs the
    backward of card tensors on its device thread."""
    errs = []

    def run():
        try:
            loss.backward()
        except BaseException as e:        # handed to the caller's thread
            errs.append(e)
    th = threading.Thread(target=run)
    th.start()
    th.join()
    if errs:
        raise errs[0]


def _moe_side_thread_loss(x, p, cfg, world):
    """One remat'd MoE layer's loss on ``x``: its outputs' squares and
    1/``world`` of its aux (each rank's share of the global loss)."""
    from torch.utils.checkpoint import checkpoint
    from repro_torch.models import moe
    y, aux = checkpoint(lambda t: moe.moe_ffn(t, p, cfg.moe), x,
                        use_reentrant=False)
    return y.square().sum() + aux / world


def _spawn(fn, args, nprocs, timeout=180):
    """Run ``fn(rank, *args)`` in ``nprocs`` spawned processes; raise if
    one fails or they outlast ``timeout`` seconds (then kill them)."""
    ctx = torch.multiprocessing.start_processes(
        fn, args=args, nprocs=nprocs, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    while not ctx.join(timeout=1):
        if time.monotonic() > deadline:
            for proc in ctx.processes:
                proc.kill()
            raise TimeoutError(f"{nprocs} ranks outlasted {timeout} s")


def _rank(rank, world, out_dir):
    """One rank of the gloo world: the three archs' meshed runs (tinyllama
    saving at step 3), a meshed run resumed from that save, and one MoE
    layer on this rank's rows; rank 0 writes the results."""
    import torch.distributed as dist
    from repro_torch.models import moe
    from repro_torch.sharding import TRAIN_RULES, use_rules
    from repro_torch.sharding.data_parallel import data_parallel
    from repro_torch.training.train_loop import train
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{out_dir}/rdzv",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=60))
    res = {}
    try:
        mesh = _mesh()
        with use_rules(TRAIN_RULES):
            for arch in ARCHS:
                cfg = _cfg(arch)
                kw = ({"ckpt_dir": f"{out_dir}/full", "ckpt_every": 3}
                      if arch == ARCHS[0] else {})
                out = train(cfg, _loop(**kw), _batches(cfg), device="cpu",
                            mesh=mesh)
                res[f"{arch}/loss"] = [h["loss"] for h in out["history"]]
                res[f"{arch}/moe_aux"] = [h["moe_aux"]
                                          for h in out["history"]]
                for n, t in _full(out["params"]).items():
                    res[f"{arch}/p/{n}"] = t.numpy()
            if rank == 0:
                name = "step_00000003"
                shutil.copytree(f"{out_dir}/full/{name}",
                                f"{out_dir}/part/{name}")
                with open(f"{out_dir}/part/LATEST", "w") as f:
                    f.write(name)
            dist.barrier()
            cfg = _cfg(ARCHS[0])
            batches = _batches(cfg)     # read from their start: skip 3
            for _ in range(3):
                next(batches)
            out = train(cfg, _loop(ckpt_dir=f"{out_dir}/part"), batches,
                        device="cpu", mesh=mesh)
            res["resumed/loss"] = [h["loss"] for h in out["history"]]
            res["resumed/step"] = [h["step"] for h in out["history"]]
            for n, t in _full(out["params"]).items():
                res[f"resumed/p/{n}"] = t.numpy()
            # bf16 weights beside fp32 routers: the routers stay whole
            cfg = _bf16_cfg()
            out = train(cfg, _loop(num_steps=2), _batches(cfg),
                        device="cpu", mesh=mesh)
            res["bf16/loss"] = [h["loss"] for h in out["history"]]
            for n, t in out["params"].named_parameters():
                if t.dtype == torch.float32:
                    assert not hasattr(t, "full_tensor"), n
                    ts = [torch.empty_like(t) for _ in range(world)]
                    dist.all_gather(ts, t.detach())
                    res[f"bf16/whole/{n}"] = torch.stack(ts).numpy()
                else:
                    assert hasattr(t, "full_tensor"), n
        cfg = _cfg("granite-moe-1b-a400m")
        x, p = _moe_inputs(cfg)
        rows = x.shape[0] // world
        with data_parallel(mesh.get_group("data")):
            y, aux = moe.moe_ffn(x[rank * rows:(rank + 1) * rows], p,
                                 cfg.moe)
        ys = [torch.empty_like(y) for _ in range(world)]
        dist.all_gather(ys, y)
        res["moe/y"], res["moe/aux"] = torch.cat(ys).numpy(), aux.numpy()
        # the remat'd layer's recompute on another thread than the forward
        xr = x[rank * rows:(rank + 1) * rows].clone().requires_grad_()
        with data_parallel(mesh.get_group("data")):
            _backward_on_a_side_thread(
                _moe_side_thread_loss(xr, p, cfg, world))
        dxs = [torch.empty_like(xr) for _ in range(world)]
        dist.all_gather(dxs, xr.grad)
        res["moe/dx"] = torch.cat(dxs).numpy()
        if rank == 0:
            np.savez(f"{out_dir}/mesh.npz", **res)
    finally:
        dist.destroy_process_group()


_REFERENCE = r"""
import dataclasses, json, sys
import numpy as np
import jax
from repro.configs import get_config
from repro.data.pipeline import make_train_batches
from repro.models.model import build_model
from repro.sharding import TRAIN_RULES, set_rules
from repro.training import train_loop as jloop
archs, (steps, batch, seq), data = (json.loads(sys.argv[1]),
                                    map(int, sys.argv[2:5]), sys.argv[5])
mesh = jax.make_mesh((2, 1), ("data", "model"),
                     axis_types=(jax.sharding.AxisType.Auto,) * 2)
out = {}
for arch in archs:
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
    if cfg.moe.enabled:
        cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=0.5))
    model = build_model(cfg)
    leaves, treedef = jax.tree_util.tree_flatten_with_path(
        jax.eval_shape(model.init, jax.random.PRNGKey(0)))
    with np.load(f"{data}/{arch}.npz") as f:
        params = jax.tree.unflatten(treedef, [jax.numpy.asarray(f[".".join(
            str(getattr(k, "key", getattr(k, "idx", None))) for k in path)])
            for path, _ in leaves])
    batches = make_train_batches(cfg, batch, seq)
    loop = jloop.TrainLoopConfig(num_steps=steps, batch_size=batch,
                                 seq_len=seq, log_every=1)
    with mesh:
        set_rules(TRAIN_RULES)
        try:
            res = jloop.train(cfg, loop, batches, params)
            after = {k: jax.numpy.asarray(v) for k, v in next(batches).items()}
            after = jax.jit(model.train_loss)(res["params"], after)[0]
        finally:
            set_rules(None)
    out[f"{arch}/loss"] = [h["loss"] for h in res["history"]]
    out[f"{arch}/after"] = float(after)
with open(f"{data}/reference.json", "w") as f:
    json.dump(out, f)
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's ``train`` of ARCHS under its host mesh (2 forced
    CPU devices, ``Auto`` axes), from the port's initial weights."""
    from repro_torch.convert import to_reference_params
    from torch_parity import flat_tree
    data = tmp_path_factory.mktemp("train_mesh_reference")
    for arch in ARCHS:
        np.savez(data / f"{arch}.npz",
                 **flat_tree(to_reference_params(_init(_cfg(arch)))))
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=2",
               PYTHONPATH=str(ROOT / "src"))
    subprocess.run([sys.executable, "-c", _REFERENCE, json.dumps(ARCHS),
                    str(STEPS), str(BATCH), str(SEQ), str(data)], env=env,
                   check=True, timeout=300, stdout=subprocess.DEVNULL)
    with open(data / "reference.json") as f:
        return json.load(f)


@pytest.fixture(scope="module")
def meshed(tmp_path_factory):
    out_dir = tmp_path_factory.mktemp("train_mesh")
    _spawn(_rank, (2, str(out_dir)), 2)
    with np.load(out_dir / "mesh.npz") as f:
        return out_dir, dict(f)


def _plain(arch):
    from repro_torch.training.train_loop import train
    cfg = _cfg(arch)
    return train(cfg, _loop(), _batches(cfg), device="cpu")


def _lr_sum():
    from repro_torch.training.optimizer import cosine_schedule
    loop = _loop()
    lr = cosine_schedule(loop.lr, loop.warmup, loop.num_steps)
    return sum(lr(s) for s in range(1, STEPS + 1))


def _params(res, arch):
    return {k[len(f"{arch}/p/"):]: v for k, v in res.items()
            if k.startswith(f"{arch}/p/")}


@pytest.mark.parametrize("arch", ARCHS)
def test_world_of_two_trains_as_one_process(meshed, arch):
    _, res = meshed
    out = _plain(arch)
    want = [h["loss"] for h in out["history"]]
    np.testing.assert_allclose(res[f"{arch}/loss"], want, rtol=REL)
    np.testing.assert_allclose(res[f"{arch}/moe_aux"],
                               [h["moe_aux"] for h in out["history"]],
                               rtol=REL)
    got = _params(res, arch)
    plain = {n: p.numpy() for n, p in out["params"].named_parameters()}
    assert sorted(got) == sorted(plain)
    for n, p in plain.items():
        assert got[n].shape == p.shape, n
        scale = max(np.abs(p).max(), _lr_sum())
        assert np.abs(got[n] - p).max() <= REL * scale, n
    cfg = _cfg(arch)
    np.testing.assert_allclose(_loss_after(cfg, got),
                               _loss_after(cfg, plain), rtol=REL)


@pytest.mark.parametrize("arch", ARCHS)
def test_world_of_two_trains_as_the_reference_under_its_mesh(
        meshed, reference, arch):
    """Every step's loss, and the loss of the final parameters on the
    next batch, within 1e-5 relative of the reference's ``train`` under its
    host mesh from the same weights and batches."""
    _, res = meshed
    np.testing.assert_allclose(res[f"{arch}/loss"],
                               reference[f"{arch}/loss"], rtol=REL)
    np.testing.assert_allclose(_loss_after(_cfg(arch), _params(res, arch)),
                               reference[f"{arch}/after"], rtol=REL)


def test_moe_layer_takes_the_global_capacity(meshed):
    """One MoE layer, each rank on its 32 of 64 rows, equals the layer on
    all 64 (fp32 within 1e-6): the capacity of 64 tokens, each slot's
    place after the slots of rank 0, the aux means over both ranks. Slots
    are dropped, and rank 1's rows alone would keep more of them."""
    from repro_torch.models import moe
    from repro_torch.models.moe import moe_capacity
    _, res = meshed
    cfg = _cfg("granite-moe-1b-a400m")
    x, p = _moe_inputs(cfg)
    with torch.no_grad():
        y, aux = moe.moe_ffn(x, p, cfg.moe)
        y1, _ = moe.moe_ffn(x[32:], p, cfg.moe)
    np.testing.assert_allclose(res["moe/y"], y.numpy(), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(res["moe/aux"], aux.numpy(), rtol=1e-6)
    T, K, E = x.shape[0], cfg.moe.top_k, cfg.moe.num_experts
    counts = torch.bincount(
        moe.top_k(torch.softmax(x @ p["router"], -1), K)[1].reshape(-1),
        minlength=E)
    assert int(counts.clamp(max=moe_capacity(T, cfg.moe)).sum()) < T * K
    assert not np.allclose(res["moe/y"][32:], y1.numpy(), atol=1e-6)


def test_moe_recompute_on_the_backward_thread_takes_the_group(meshed):
    """The remat'd layer's backward run on another thread than its forward
    (as on the card, where autograd's device thread recomputes it): each
    rank's input gradient equals that of the layer on all 64 rows (fp32
    within 1e-5 of the largest), so the recompute took the global
    capacity, positions and aux means."""
    _, res = meshed
    cfg = _cfg("granite-moe-1b-a400m")
    x, p = _moe_inputs(cfg)
    x.requires_grad_()
    _moe_side_thread_loss(x, p, cfg, 1).backward()
    want = x.grad.numpy()
    np.testing.assert_allclose(res["moe/dx"], want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


def test_bf16_weights_shard_and_fp32_routers_stay_whole(meshed):
    """granite at its bf16 dtype: FSDP takes one dtype, so the fp32
    routers stay whole on both ranks, their gradients summed: after 2
    steps both ranks hold the same routers, equal to the unmeshed run's
    within bf16's tolerance (2e-2), as are the losses."""
    from repro_torch.training.train_loop import train
    _, res = meshed
    cfg = _bf16_cfg()
    out = train(cfg, _loop(num_steps=2), _batches(cfg), device="cpu")
    np.testing.assert_allclose(res["bf16/loss"],
                               [h["loss"] for h in out["history"]],
                               rtol=2e-2)
    whole = {k[len("bf16/whole/"):]: v for k, v in res.items()
             if k.startswith("bf16/whole/")}
    assert sorted(whole) == sorted(
        n for n, p in out["params"].named_parameters()
        if p.dtype == torch.float32) and whole
    params = dict(out["params"].named_parameters())
    for n, ranks in whole.items():
        np.testing.assert_array_equal(ranks[0], ranks[1])
        np.testing.assert_allclose(ranks[0], params[n].numpy(), rtol=2e-2,
                                   atol=2e-2)


def test_checkpoint_under_mesh_has_the_reference_layout(meshed):
    """The save at step 3 holds whole tensors under the reference's npz
    keys and shapes (the reference's own tree, parameters and AdamW
    moments)."""
    import jax
    from repro.configs import get_config
    from repro.models.model import build_model
    out_dir, _ = meshed
    cfg = get_config(ARCHS[0]).reduced()
    tree = jax.eval_shape(build_model(cfg).init, jax.random.PRNGKey(0))
    want = {"/".join(str(k.key) for k in path): leaf.shape for path, leaf
            in jax.tree_util.tree_flatten_with_path(tree)[0]}
    ck = out_dir / "full" / "step_00000003"
    with np.load(ck / "params.npz") as f:
        assert {k: f[k].shape for k in f.files} == want
    with np.load(ck / "opt.npz") as f:
        assert int(f[".step"]) == 3
        for field in ("mu", "nu"):
            assert {k[len(field) + 2:]: f[k].shape for k in f.files
                    if k.startswith(f".{field}/")} == want


def test_resumed_mesh_run_equals_the_uninterrupted_one(meshed):
    """Restored into the shards, the moments and the step: steps 3 and 4
    and the final parameters equal the uninterrupted run bit for bit."""
    _, res = meshed
    arch = ARCHS[0]
    assert list(res["resumed/step"]) == [3, 4]
    assert list(res["resumed/loss"]) == list(res[f"{arch}/loss"][3:])
    for k in res:
        if k.startswith("resumed/p/"):
            np.testing.assert_array_equal(
                res[k], res[f"{arch}/p/" + k[len("resumed/p/"):]])


@pytest.fixture
def world_of_one(tmp_path):
    import torch.distributed as dist
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rdzv",
                            rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=60))
    try:
        yield _mesh()
    finally:
        dist.destroy_process_group()


@pytest.fixture
def deterministic():
    """The CPU's scatter-add (the embedding's backward) sums duplicate
    rows in thread order, so two unmeshed runs differ in the last bit of
    the embedding unless deterministic algorithms are on."""
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)


@pytest.mark.parametrize("arch", ARCHS[:2])
def test_world_of_one_equals_unmeshed_bit_for_bit(world_of_one,
                                                  deterministic, arch):
    from repro_torch.sharding import TRAIN_RULES, use_rules
    from repro_torch.training.train_loop import train
    cfg = _cfg(arch)
    with use_rules(TRAIN_RULES):
        got = train(cfg, _loop(), _batches(cfg), device="cpu",
                    mesh=world_of_one)
    want = _plain(arch)
    assert got["history"] and [
        {k: v for k, v in h.items() if k != "elapsed_s"}
        for h in got["history"]] == [
        {k: v for k, v in h.items() if k != "elapsed_s"}
        for h in want["history"]]
    full = _full(got["params"])
    for n, p in want["params"].named_parameters():
        assert torch.equal(full[n], p), n
    assert not any(p.requires_grad for p in got["params"].parameters())


def test_launcher_host_mesh_runs_and_multi_pod_is_refused(capsys):
    import torch.distributed as dist
    from repro_torch.launch import train as launch
    final = launch.main(["--arch", "tinyllama-1.1b", "--reduced", "--steps",
                         "2", "--batch", "2", "--seq", "16", "--device",
                         "cpu", "--host-mesh"])
    assert final["step"] == 1 and np.isfinite(final["loss"])
    assert not dist.is_initialized()
    with pytest.raises(SystemExit):
        launch.main(["--arch", "tinyllama-1.1b", "--reduced", "--device",
                     "cpu", "--multi-pod"])
    assert "a world of 512 ranks" in capsys.readouterr().err
