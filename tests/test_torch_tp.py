"""Tensor parallelism of the port's dense and VLM members, on the CPU.

Gloo worlds of 2 ((1, 2) mesh: ``data`` 1, ``model`` 2) and of 4 ((2, 2)),
spawned with ``torch.multiprocessing``. Each rank trains the reduced
tinyllama-1.1b and internvl2-76b (and tinyllama with one kv head, whose
kv projection does not split over ``model``) for 5 steps under the
training rules, then prefills and decodes one step over a shared store
split by chunk and by chunk position under the serving rules. The test
process runs the same unmeshed: losses within 1e-5 relative, and the
trained parameters' loss on the next batch within 1e-5 relative; the
final parameters within 2e-4 of each leaf's scale (the larger of its
largest element and the steps' summed learning rate). The tensor-parallel
sums (a row-parallel product's partial sums, a replicated activation's
gradient summed over ``model``) round in another order than one
process's, and AdamW normalizes an element whose gradient lies at that
rounding noise to a full step: the largest gap, 9.869e-05 of its scale
on the (1, 2) mesh, is one embedding element of internvl2 whose second
gradient is about 4e-7 of the leaf's largest. The unmeshed runs take one
thread, as the ranks do, so the gaps do not move with the thread count.
Since AdamW's step does not change when a leaf's gradient is scaled, the
gradients and their global norm that the first update reads are held
too, leaf by leaf, within 1e-5 of each leaf's largest gradient: a
gradient reduced twice over ``model`` or a norm that counts a replicated
shard more than once fails there. The decode step's fp32 logits are
within 2e-5 and give the same greedy tokens. The tinyllama run saves at
step 3 and a run resumed from that save equals the uninterrupted one bit
for bit; every trained leaf and some unevenly split tensors cut out of
their whole value by ``local_part`` equal DTensor's own shards. Without
a mesh the rules change nothing: the unmeshed step is bit for bit the
same with the rules installed.
"""
from __future__ import annotations

import contextlib
import dataclasses
import datetime
import shutil
import time

import numpy as np
import pytest
import torch

STEPS, BATCH, SEQ = 5, 4, 32
REL = 1e-5
PARAM_REL = 2e-4
GRAD_REL = 1e-5
LOGIT_TOL = 2e-5
CKPT_AT = 3
ARCHS = ("tinyllama-1.1b", "internvl2-76b", "tinyllama-mqa")
# the decode step: requests, prompt, cache length, store chunks
B, PROMPT, MAX_SEQ, CHUNKS = 4, 12, 32, 8


def _cfg(arch):
    from repro_torch.configs import get_config
    name = "tinyllama-1.1b" if arch == "tinyllama-mqa" else arch
    cfg = dataclasses.replace(get_config(name).reduced(), dtype="float32")
    if arch == "tinyllama-mqa":
        cfg = dataclasses.replace(cfg, num_kv_heads=1)
    return cfg


def _loop(**kw):
    from repro_torch.training.train_loop import TrainLoopConfig
    return TrainLoopConfig(num_steps=STEPS, batch_size=BATCH, seq_len=SEQ,
                           log_every=1, **kw)


@contextlib.contextmanager
def _first_update():
    """Records what the run's first AdamW update reads: every gradient,
    whole (gathered from its shards), and their ``global_norm``."""
    from repro_torch.sharding.tensor_parallel import full_tensor, is_meshed
    from repro_torch.training import train_loop
    from repro_torch.training.optimizer import global_norm
    real, seen = train_loop.adamw_update, {}

    def update(grads, state, params, **kw):
        if not seen:
            seen["gnorm"] = float(global_norm(grads))
            seen["grads"] = {n: (full_tensor(g) if is_meshed(g) else g)
                             .detach().clone().numpy()
                             for n, g in grads.items()}
        return real(grads, state, params, **kw)

    train_loop.adamw_update = update
    try:
        yield seen
    finally:
        train_loop.adamw_update = real


def _uneven_shards_mismatch(mesh):
    """The placements of a few tensors that do not split evenly over
    ``mesh`` (nested splits of one dim among them) where ``local_part``
    or ``local_range`` disagrees with DTensor's own shards."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from repro_torch.sharding.tensor_parallel import local_part, local_range
    i, j, k = torch.meshgrid(torch.arange(5), torch.arange(7),
                             torch.arange(3), indexing="ij")
    full = (i * 10000 + j * 100 + k).float()
    bad = []
    for pl in ([Shard(0), Shard(0)], [Shard(1), Shard(1)],
               [Shard(0), Shard(1)], [Replicate(), Shard(2)],
               [Shard(2), Shard(0)]):
        t = distribute_tensor(full, mesh, pl)
        if not torch.equal(local_part(full, mesh, pl), t.to_local()):
            bad.append(f"local_part {pl}")
        for d, unit in enumerate((10000, 100, 1)):
            first, n = local_range(t, d)
            idx = torch.unique((t.to_local() // unit) % 100)
            if not torch.equal(idx, torch.arange(first, first + n).float()):
                bad.append(f"local_range {pl} dim {d}")
    return bad


def _decode_inputs(cfg):
    """Weights, a store of CHUNKS chunks, B prompts and the unmeshed
    prefilled cache, all from seeds (the same on every rank)."""
    from repro_torch.core.shared_kv import build_store
    from repro_torch.models.model import build_model
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(1))
    g = np.random.default_rng(5)
    L, KH, D = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim
    S = CHUNKS * cfg.moska.chunk_size
    kv = [torch.from_numpy(g.standard_normal((L, S, KH, D))
                           .astype(np.float32)) for _ in range(2)]
    store = build_store(*kv, cfg.moska.chunk_size)
    tokens = torch.from_numpy(g.integers(0, cfg.vocab_size, (B, PROMPT)))
    nxt = torch.from_numpy(g.integers(0, cfg.vocab_size, (B,)))
    frontend = None
    if cfg.encoder.frontend_seq:
        frontend = torch.from_numpy(g.standard_normal(
            (B, 4, cfg.d_model)).astype(np.float32))
    return model, params, store, tokens, nxt, frontend


def _decode(cfg, mesh=None):
    """Prefill (no store) and one routed decode step; with ``mesh`` both
    run tensor parallel on ``DTensor`` inputs placed by the serving
    rules. Returns (prefill logits, decode logits) whole."""
    from repro_torch.launch.input_specs import _CACHE_AXES, _STORE_AXES
    from repro_torch.sharding import SERVE_RULES, use_rules
    from repro_torch.sharding.tensor_parallel import (full_tensor, place,
                                                      place_fields)
    from repro_torch.training.train_loop import tensor_parallel
    model, params, store, tokens, nxt, frontend = _decode_inputs(cfg)
    P = 0 if frontend is None else frontend.shape[1]
    cache = model.init_cache(B, MAX_SEQ, dtype=torch.float32)
    if mesh is None:
        lp, cache = model.prefill(params, tokens, cache,
                                  frontend_embeds=frontend)
        ld, _ = model.decode_step(params, nxt, cache, store=store)
        return lp, ld
    with use_rules(SERVE_RULES):
        tensor_parallel(model, params, mesh)
        cache = place_fields(cache, _CACHE_AXES, SERVE_RULES, mesh)
        store = place_fields(store, _STORE_AXES, SERVE_RULES, mesh)
        rows = ("batch",)
        tokens, nxt = (place(t, rows, SERVE_RULES, mesh)
                       for t in (tokens, nxt))
        if frontend is not None:
            frontend = place(frontend, rows, SERVE_RULES, mesh)
        lp, cache = model.prefill(params, tokens, cache,
                                  frontend_embeds=frontend)
        assert int(cache.length.to_local()[0]) == PROMPT + P
        ld, _ = model.decode_step(params, nxt, cache, store=store)
    return full_tensor(lp), full_tensor(ld)


def _rank(rank, world, shape, out_dir):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.data.pipeline import make_train_batches
    from repro_torch.sharding import TRAIN_RULES, use_rules
    from repro_torch.sharding.tensor_parallel import full_tensor, local_part
    from repro_torch.training.train_loop import train
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{out_dir}/rdzv",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=120))
    try:
        mesh = init_device_mesh("cpu", shape,
                                mesh_dim_names=("data", "model"))
        res, bad = {}, _uneven_shards_mismatch(mesh)
        for arch in ARCHS:
            cfg = _cfg(arch)
            kw = {"ckpt_dir": f"{out_dir}/full", "ckpt_every": CKPT_AT} \
                if arch == ARCHS[0] else {}
            with use_rules(TRAIN_RULES), _first_update() as first:
                out = train(cfg, _loop(**kw),
                            make_train_batches(cfg, BATCH, SEQ),
                            device="cpu", mesh=mesh)
            res[f"{arch}/loss"] = np.array([h["loss"]
                                            for h in out["history"]])
            res[f"{arch}/gnorm"] = np.array(first["gnorm"])
            for n, g in first["grads"].items():
                res[f"{arch}/g/{n}"] = g
            for n, p in out["params"].named_parameters():
                whole = full_tensor(p)
                res[f"{arch}/p/{n}"] = whole.numpy()
                if not torch.equal(local_part(whole, mesh, p.placements),
                                   p.to_local()):
                    bad.append(f"local_part {arch} {n}")
            lp, ld = _decode(cfg, mesh)
            res[f"{arch}/prefill"], res[f"{arch}/decode"] = \
                lp.numpy(), ld.numpy()
        # the tinyllama run resumed from its save at step CKPT_AT
        if rank == 0:
            name = f"step_{CKPT_AT:08d}"
            shutil.copytree(f"{out_dir}/full/{name}",
                            f"{out_dir}/part/{name}")
            with open(f"{out_dir}/part/LATEST", "w") as f:
                f.write(name)
        dist.barrier()
        cfg = _cfg(ARCHS[0])
        batches = make_train_batches(cfg, BATCH, SEQ)   # read from the start
        for _ in range(CKPT_AT):
            next(batches)
        with use_rules(TRAIN_RULES):
            out = train(cfg, _loop(ckpt_dir=f"{out_dir}/part"), batches,
                        device="cpu", mesh=mesh)
        res["resumed/loss"] = np.array([h["loss"] for h in out["history"]])
        res["resumed/step"] = np.array([h["step"] for h in out["history"]])
        for n, p in out["params"].named_parameters():
            res[f"resumed/p/{n}"] = full_tensor(p).numpy()
        every = [None] * world
        dist.all_gather_object(every, bad)
        res["mismatched shards"] = np.array(
            [f"rank {r}: {b}" for r, bs in enumerate(every) for b in bs],
            dtype=str)
        if rank == 0:
            np.savez(f"{out_dir}/tp.npz", **res)
    finally:
        dist.destroy_process_group()


def _spawn(world, shape, out_dir, timeout=240):
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


@pytest.fixture(scope="module", params=[(1, 2), (2, 2)],
                ids=["mesh1x2", "mesh2x2"])
def meshed(request, tmp_path_factory):
    shape = request.param
    return _spawn(shape[0] * shape[1], shape,
                  tmp_path_factory.mktemp(f"tp{shape[0]}x{shape[1]}"))


@pytest.fixture(scope="module")
def plain():
    """The unmeshed runs, on one thread as each rank runs (the CPU's
    matmuls block, and so round, by their thread count)."""
    from repro_torch.data.pipeline import make_train_batches
    from repro_torch.training.train_loop import train
    out = {}
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        for arch in ARCHS:
            cfg = _cfg(arch)
            with _first_update() as first:
                run = train(cfg, _loop(), make_train_batches(cfg, BATCH, SEQ),
                            device="cpu")
            out[arch] = (run, *_decode(cfg), first)
    finally:
        torch.set_num_threads(threads)
    return out


def _loss_after(cfg, values):
    """The loss of the parameters ``values`` ({name: array}) on the batch
    after the run's last."""
    from repro_torch.data.pipeline import make_train_batches
    from repro_torch.models.model import build_model
    from repro_torch.training.train_loop import to_device
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    batches = make_train_batches(cfg, BATCH, SEQ)
    for _ in range(STEPS):
        next(batches)
    with torch.no_grad():
        for n, p in params.named_parameters():
            p.copy_(torch.as_tensor(values[n]))
        loss, _ = model.train_loss(params, to_device(next(batches),
                                                     torch.device("cpu")),
                                   remat=False)
    return float(loss)


def _lr_sum():
    from repro_torch.training.optimizer import cosine_schedule
    loop = _loop()
    lr = cosine_schedule(loop.lr, loop.warmup, loop.num_steps)
    return sum(lr(s) for s in range(1, STEPS + 1))


@pytest.mark.parametrize("arch", ARCHS)
def test_tensor_parallel_trains_as_one_process(meshed, plain, arch):
    run = plain[arch][0]
    want = np.array([h["loss"] for h in run["history"]])
    got = meshed[f"{arch}/loss"]
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=REL)
    moved = _lr_sum()
    gaps = {}
    for n, p in run["params"].named_parameters():
        scale = max(float(p.abs().max()), moved)
        gaps[n] = np.abs(meshed[f"{arch}/p/{n}"] - p.numpy()).max() / scale
    worst = max(gaps, key=gaps.get)
    print(f"{arch}: largest parameter gap {gaps[worst]:.3e} of its scale "
          f"({worst})")
    assert gaps[worst] <= PARAM_REL, (worst, gaps[worst])
    after = [_loss_after(_cfg(arch), values) for values in (
        {n: meshed[f"{arch}/p/{n}"] for n, _ in
         run["params"].named_parameters()},
        {n: p.detach().numpy() for n, p in run["params"].named_parameters()})]
    assert abs(after[0] - after[1]) <= REL * abs(after[1])


@pytest.mark.parametrize("arch", ARCHS)
def test_tensor_parallel_first_gradients_equal_one_process(meshed, plain,
                                                           arch):
    """The gradients and the global norm that the first AdamW update
    reads: every leaf within GRAD_REL of its largest unmeshed gradient,
    the norm within GRAD_REL relative."""
    first = plain[arch][3]
    gaps = {}
    for n, want in first["grads"].items():
        got = meshed[f"{arch}/g/{n}"]
        assert got.shape == want.shape, n
        gaps[n] = np.abs(got - want).max() / np.abs(want).max()
    worst = max(gaps, key=gaps.get)
    gn = float(meshed[f"{arch}/gnorm"])
    print(f"{arch}: largest gradient gap {gaps[worst]:.3e} of its leaf's "
          f"largest ({worst}); global norm {gn:.8e} vs "
          f"{first['gnorm']:.8e}")
    assert gaps[worst] <= GRAD_REL, (worst, gaps[worst])
    assert abs(gn - first["gnorm"]) <= GRAD_REL * first["gnorm"]


def test_tensor_parallel_checkpoint_resumes_bit_for_bit(meshed):
    """Saved at step CKPT_AT under the (data, model) mesh and restored
    into the shards, the moments and the step: the remaining steps and
    the final parameters equal the uninterrupted run bit for bit."""
    arch = ARCHS[0]
    assert list(meshed["resumed/step"]) == list(range(CKPT_AT, STEPS))
    assert list(meshed["resumed/loss"]) == \
        list(meshed[f"{arch}/loss"][CKPT_AT:])
    names = [k[len("resumed/p/"):] for k in meshed
             if k.startswith("resumed/p/")]
    assert names
    for n in names:
        np.testing.assert_array_equal(meshed[f"resumed/p/{n}"],
                                      meshed[f"{arch}/p/{n}"])


def test_local_part_and_range_equal_dtensor_shards(meshed):
    """Every trained leaf, and tensors of 5 x 7 x 3 split unevenly (one
    dim over both mesh dims among them): ``local_part`` of the whole
    value is the rank's ``to_local()``, and ``local_range`` names the
    global indices it holds."""
    assert list(meshed["mismatched shards"]) == []


@pytest.mark.parametrize("arch", ARCHS)
def test_tensor_parallel_decode_over_a_chunk_sharded_store(meshed, plain,
                                                           arch):
    _, lp, ld, _ = plain[arch]
    print(f"{arch}: logits max_abs_err prefill "
          f"{np.abs(meshed[f'{arch}/prefill'] - lp.numpy()).max():.3e}, "
          f"decode {np.abs(meshed[f'{arch}/decode'] - ld.numpy()).max():.3e}")
    np.testing.assert_allclose(meshed[f"{arch}/prefill"], lp.numpy(),
                               rtol=LOGIT_TOL, atol=LOGIT_TOL)
    np.testing.assert_allclose(meshed[f"{arch}/decode"], ld.numpy(),
                               rtol=LOGIT_TOL, atol=LOGIT_TOL)
    np.testing.assert_array_equal(meshed[f"{arch}/decode"].argmax(-1),
                                  ld.numpy().argmax(-1))


def test_rules_leave_the_unmeshed_step_as_it_was():
    from repro_torch.sharding import SERVE_RULES, TRAIN_RULES, use_rules
    cfg = _cfg("tinyllama-1.1b")
    want = _decode(cfg)
    with use_rules(SERVE_RULES):
        got = _decode(cfg)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    from repro_torch.models.model import build_model
    from repro_torch.data.pipeline import make_train_batches
    from repro_torch.training.train_loop import to_device
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    batch = to_device(next(make_train_batches(cfg, BATCH, SEQ)),
                      torch.device("cpu"))
    losses = []
    for rules in (None, TRAIN_RULES):
        with use_rules(rules):
            losses.append(model.train_loss(params, batch, remat=False)[0])
    assert torch.equal(*losses)
