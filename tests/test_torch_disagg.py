"""The port's disaggregated shared-KV pool (``repro_torch.core.disagg``)
against the reference's ``disaggregated_shared_attention``, on the CPU.

The reference runs on a 4-device CPU mesh in a subprocess of its own
(``--xla_force_host_platform_device_count=4``, ``Auto`` axes), once per
module, and hands numpy arrays back. The port runs one process per rank
over gloo (``torch.multiprocessing``, a file rendezvous, a 60 s collective
timeout). Both take the same numpy inputs, made from seeds. fp32
throughout: outputs and LSEs within 3e-5 (the reference test's bound).
A world of one must equal the port's and the reference's
``shared_attention_batched`` (global routing).
"""
import datetime
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

TOL = 3e-5
NEG_INF = -1e30
ROOT = Path(__file__).resolve().parents[1]

# name: (mesh shape, mesh axes, batch axis, B, E, top_k, capacity factor)
CASES = {
    "w2": ((2,), ("data",), None, 3, 8, 2, 2.0),
    "w4": ((4,), ("data",), None, 3, 8, 2, 2.0),
    "2x2": ((2, 2), ("data", "model"), "model", 4, 8, 2, 2.0),
    # 16 queries, capacity 8 a chunk: every query prefers owner 1's first
    # two chunks, so owner 1 drops all routes of 8 of them
    "drop": ((2,), ("data",), None, 16, 8, 2, 0.25),
}
C, KH, D, H = 8, 2, 16, 4


def _inputs(name):
    _, _, _, B, E, _, _ = CASES[name]
    g = np.random.default_rng(sum(map(ord, name)))
    q = g.standard_normal((B, H, D)).astype(np.float32)
    k = g.standard_normal((E, C, KH, D)).astype(np.float32)
    v = g.standard_normal((E, C, KH, D)).astype(np.float32)
    if name == "drop":
        q = np.abs(q)
        k[E // 2:E // 2 + 2] += 3.0          # owner 1's chunks 0 and 1
    return {"q": q, "k": k, "v": v, "emb": k.mean(axis=1)}


_REFERENCE = r"""
import json, sys
import numpy as np
import jax
from repro.configs.base import MoSKAConfig
from repro.core.disagg import disaggregated_shared_attention
cases = json.loads(sys.argv[1])
out = {}
for name, (shape, axes, batch_axis, B, E, top_k, cf) in cases.items():
    d = np.load(f"{sys.argv[2]}/{name}.npz")
    n = int(np.prod(shape))
    mesh = jax.make_mesh(tuple(shape), tuple(axes), devices=jax.devices()[:n],
                         axis_types=(jax.sharding.AxisType.Auto,) * len(axes))
    cfg = MoSKAConfig(top_k_chunks=top_k, query_capacity_factor=cf)
    fn = jax.jit(lambda q, k, v, e: disaggregated_shared_attention(
        q, k, v, e, cfg, mesh, chunk_axis="data", batch_axis=batch_axis))
    o, l = fn(d["q"], d["k"], d["v"], d["emb"])
    out[f"{name}/out"], out[f"{name}/lse"] = np.asarray(o), np.asarray(l)
np.savez(f"{sys.argv[2]}/reference.npz", **out)
"""


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    path = tmp_path_factory.mktemp("disagg")
    for name in CASES:
        np.savez(path / f"{name}.npz", **_inputs(name))
    return path


@pytest.fixture(scope="module")
def reference(data_dir):
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=str(ROOT / "src"))
    subprocess.run([sys.executable, "-c", _REFERENCE, json.dumps(CASES),
                    str(data_dir)], env=env, check=True, timeout=300)
    with np.load(data_dir / "reference.npz") as f:
        return dict(f)


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


def _rank(rank, world, data_dir, cases):
    """One rank of a gloo world: every case of ``cases`` over this world's
    mesh; writes this rank's outputs (and its local partial's LSE)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.configs.base import MoSKAConfig
    from repro_torch.core import disagg, router, shared_attention as sa
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{data_dir}/rdzv"
                            f"{world}", rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=60))
    try:
        for name in cases:
            shape, axes, batch_axis, _, _, top_k, cf = CASES[name]
            mesh = init_device_mesh("cpu", shape, mesh_dim_names=axes)
            d = {k: torch.from_numpy(a) for k, a in
                 np.load(f"{data_dir}/{name}.npz").items()}
            k, v, emb = disagg.local_chunks(d["k"], d["v"], d["emb"], mesh)
            q = disagg.local_shard(d["q"], mesh, batch_axis)
            cfg = MoSKAConfig(top_k_chunks=top_k, query_capacity_factor=cf)
            out, lse = disagg.disaggregated_shared_attention(
                q, k, v, emb, cfg, mesh, batch_axis=batch_axis)
            local = sa.shared_attention_batched(
                q[:, None], k, v, router.route(q, emb, top_k),
                capacity_factor=cf)
            np.savez(f"{data_dir}/{name}_r{rank}.npz", out=out.numpy(),
                     lse=lse.numpy(), local_lse=local.lse[:, 0].numpy())
    finally:
        dist.destroy_process_group()


def _run_world(world, data_dir, cases):
    _spawn(_rank, (world, str(data_dir), cases), world)
    return {name: [dict(np.load(data_dir / f"{name}_r{r}.npz"))
                   for r in range(world)] for name in cases}


@pytest.fixture(scope="module")
def port(data_dir):
    out = _run_world(2, data_dir, ["w2", "drop"])
    out.update(_run_world(4, data_dir, ["w4", "2x2"]))
    return out


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("name", ["w2", "w4", "drop"])
def test_owners_match_reference(port, reference, name):
    """Every owner holds the merged result of all queries."""
    for r, got in enumerate(port[name]):
        _close(got["out"], reference[f"{name}/out"])
        _close(got["lse"], reference[f"{name}/lse"])


def test_batch_axis_mesh_matches_reference(port, reference):
    """2 x 2 (data, model) mesh, queries split over model, chunks over
    data: rank (d, m) holds rows m of the merged result."""
    B = CASES["2x2"][3]
    for r, got in enumerate(port["2x2"]):
        rows = slice((r % 2) * B // 2, (r % 2 + 1) * B // 2)
        _close(got["out"], reference["2x2/out"][rows])
        _close(got["lse"], reference["2x2/lse"][rows])


def test_dropped_owner_weighs_nothing(port, reference):
    """Owner 1 dropped every route of some queries: its partial for them
    is empty (-1e30) and must weigh 0. Where owner 0 kept one, the merged
    result is owner 0's alone; where neither did, the LSE is -1e30 and the
    output 0."""
    r0, r1 = port["drop"]
    empty0, empty1 = ((r["local_lse"] <= NEG_INF / 2).all(axis=-1)
                      for r in (r0, r1))
    alone = empty1 & ~empty0
    assert alone.any() and not empty1.all()
    _close(r1["lse"][alone], r0["local_lse"][alone])
    assert (r1["lse"][empty0 & empty1] == NEG_INF).all()
    assert (r1["out"][empty0 & empty1] == 0).all()
    _close(r1["out"], reference["drop/out"])


@pytest.fixture
def world_of_one(tmp_path):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rdzv",
                            rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=60))
    try:
        yield init_device_mesh("cpu", (1,), mesh_dim_names=("data",))
    finally:
        dist.destroy_process_group()


def test_world_of_one_matches_batched(world_of_one):
    """One owner of every chunk: the combine is the identity on the
    batched attention with global routing, the port's and the
    reference's."""
    from repro.core import router as jrouter
    from repro.core import shared_attention as jsa
    from repro_torch.configs.base import MoSKAConfig
    from repro_torch.core import disagg, router, shared_attention as sa
    d = _inputs("w2")
    t = {k: torch.from_numpy(a) for k, a in d.items()}
    cfg = MoSKAConfig(top_k_chunks=2)
    out, lse = disagg.disaggregated_shared_attention(
        t["q"], t["k"], t["v"], t["emb"], cfg, world_of_one)
    part = sa.shared_attention_batched(
        t["q"][:, None], t["k"], t["v"], router.route(t["q"], t["emb"], 2),
        capacity_factor=cfg.query_capacity_factor)
    _close(out.numpy(), part.out[:, 0].numpy())
    _close(lse.numpy(), part.lse[:, 0].numpy())
    ref = jsa.shared_attention_batched(
        d["q"][:, None], d["k"], d["v"], jrouter.route(d["q"], d["emb"], 2),
        capacity_factor=cfg.query_capacity_factor)
    _close(out.numpy(), np.asarray(ref.out[:, 0]))
    _close(lse.numpy(), np.asarray(ref.lse[:, 0]))


def test_batch_axis_may_not_be_a_chunk_axis(world_of_one):
    from repro_torch.configs.base import MoSKAConfig
    from repro_torch.core import disagg
    t = {k: torch.from_numpy(a) for k, a in _inputs("w2").items()}
    with pytest.raises(ValueError, match="chunk axis"):
        disagg.disaggregated_shared_attention(
            t["q"], t["k"], t["v"], t["emb"], MoSKAConfig(), world_of_one,
            batch_axis="data")
