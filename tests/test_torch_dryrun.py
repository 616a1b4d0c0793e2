"""The port's dry run (``repro_torch.launch.dryrun``): one full-size record
from the command line in a subprocess, the depth extrapolation against a
trace of every layer (the hybrid's cycle-wise one too), the per-rank
counts of the 16x16 mesh summed over its 256 ranks against the same step
at a world of one, and the records of skipped and failing
combinations."""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch.distributed as dist

ROOT = Path(__file__).resolve().parents[1]
KEYS = ("arch", "shape", "mesh", "variant", "status", "roofline",
        "trace_s", "wall_s")
TERMS = ("arch", "shape", "mesh", "chips", "flops_per_chip",
         "bytes_per_chip", "collective_bytes_per_chip", "peak_mem_per_chip",
         "collectives", "model_flops", "note", "compute_s", "memory_s",
         "collective_s", "dominant", "useful_flops_ratio")


@pytest.fixture
def no_world():
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


def test_one_full_size_record_from_the_command_line(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "tinyllama-1.1b", "--shape", "decode_32k", "--device", "cpu",
         "--out", str(tmp_path)], env=env, timeout=300,
        capture_output=True, text=True)
    assert res.returncode == 0, res.stderr[-2000:]
    assert "0 failures" in res.stdout
    with open(tmp_path / "tinyllama-1.1b__decode_32k__16x16.json") as f:
        rec = json.load(f)
    assert set(KEYS) <= set(rec) and rec["status"] == "ok"
    r = rec["roofline"]
    assert set(TERMS) <= set(r)
    assert r["chips"] == 256 and r["flops_per_chip"] > 0
    assert r["peak_mem_per_chip"] < 80e9
    assert set(r["collectives"]) <= {"all-gather", "all-reduce",
                                     "reduce-scatter", "all-to-all",
                                     "collective-permute"}


@pytest.mark.parametrize("arch,shape", [("tinyllama-1.1b", "decode_32k"),
                                        ("tinyllama-1.1b", "long_500k"),
                                        ("recurrentgemma-9b", "decode_32k")])
def test_depth_extrapolation_equals_every_layer_traced(no_world, arch,
                                                       shape):
    from repro_torch.launch.dryrun import trace, trace_at_depth
    a = trace_at_depth(arch, shape, False, device="cpu")
    b = trace(arch, shape, False, device="cpu")
    assert a[0] == b[0] and a[1] == b[1]


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k"])
def test_depth_extrapolation_equals_a_cut_depth_traced(no_world, shape):
    """Training (remat's saved inputs, the chunked loss, the optimizer's
    moments) and the prefill: the 1- and 2-layer traces extrapolated to 3
    layers equal a trace of 3 layers, every count and the peak."""
    from repro_torch.launch.dryrun import extrapolate_cycles, trace
    one, two, three = (trace("tinyllama-1.1b", shape, False, device="cpu",
                             layers=n)[:2] for n in (1, 2, 3))
    cost, peak = extrapolate_cycles(one, two, None, 3)
    assert cost == three[0] and peak == three[1]


def _world_of_one(arch, shape):
    """The step's flops traced at a world of one: a (1, 1) mesh, at the
    depths the dry run traces (``trace_at_depth``), extrapolated alike."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.configs import get_config
    from repro_torch.launch import input_specs as ispecs
    from repro_torch.launch.dryrun import extrapolate_cycles
    from repro_torch.launch.mesh import init_fake_world
    from repro_torch.launch.op_cost import analyze_ops
    from repro_torch.sharding import use_rules
    cfg = get_config(arch)
    p = len(cfg.hybrid.pattern) if cfg.hybrid.enabled else 1
    cycles, tail = divmod(cfg.num_layers, p)
    init_fake_world(1)
    try:
        mesh = init_device_mesh("cpu", (1, 1),
                                mesh_dim_names=("data", "model"))
        traced = {}
        for layers in (p, 2 * p) + ((p + tail,) if tail else ()):
            with FakeTensorMode(allow_non_fake_inputs=True):
                spec = ispecs.build(arch, shape, mesh, layers=layers)
                with use_rules(spec.rules):
                    traced[layers] = analyze_ops(spec.fn, *spec.args)
    finally:
        dist.destroy_process_group()
    return extrapolate_cycles(traced[p], traced[2 * p],
                              traced.get(p + tail), cycles)[0].flops


@pytest.mark.parametrize("shape", ["train_4k", "decode_32k"])
def test_ranks_sum_to_the_world_of_one(no_world, shape):
    """tinyllama-1.1b: the matmul and kernel FLOPs of one rank of the 16x16
    mesh, times 256, within 5 % of the same step at a world of one (every
    product split by rows over data and by heads, FFN or vocab columns
    over model; the kernels by rows, positions and chunks); training does
    no more than its model FLOPs' worth of products and their
    recompute."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import INPUT_SHAPES
    from repro_torch.launch import roofline as rl
    from repro_torch.launch.dryrun import trace_at_depth
    cost, peak, _ = trace_at_depth("tinyllama-1.1b", shape, False,
                                   device="cpu")
    dist.destroy_process_group()
    one = _world_of_one("tinyllama-1.1b", shape)
    print(f"{shape}: 256 ranks x {cost.flops:.6e} = {256 * cost.flops:.6e}"
          f" FLOPs, a world of one {one:.6e}")
    assert abs(256 * cost.flops - one) <= 0.05 * one, (cost.flops, one)
    r = rl.analyze(cost, peak, arch="tinyllama-1.1b", shape=shape,
                   mesh_name="16x16", chips=256,
                   cfg=get_config("tinyllama-1.1b"),
                   ishape=INPUT_SHAPES[shape])
    if shape == "train_4k":
        assert 0.5 < r.useful_flops_ratio <= 1.0


_RANK_FLOPS = r"""
import sys
from repro_torch.launch.dryrun import trace_at_depth
from repro_torch.launch.mesh import init_fake_world
init_fake_world(256, rank=int(sys.argv[3]))
print(repr(trace_at_depth(sys.argv[1], sys.argv[2], False,
                          device="cpu")[0].flops))
"""


def test_expert_parallel_ranks_sum_to_the_world_of_one(no_world):
    """granite-moe-1b-a400m at decode_32k: the FLOPs of every rank of the
    16x16 mesh summed equal the same step at a world of one plus the work
    that every rank of ``model`` repeats, exactly: the router's product
    (``models/moe.py``) and the unembedding, whose vocab of 49155 does
    not split over 16 (the rules' guard replicates it). The ranks differ
    only in their data coordinate's piece of the expert capacity (C = 40
    over 16 data ranks: 13 pieces of 3, one of 1, two empty), so one rank
    of each piece size is traced, each in a process of its own (a fake
    world of another rank in the same process reads the first world's
    groups through DTensor's caches)."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import INPUT_SHAPES
    from repro_torch.models.moe import moe_capacity
    from repro_torch.sharding.tensor_parallel import _chunks
    arch, shape, D, M = "granite-moe-1b-a400m", "decode_32k", 16, 16
    cfg = get_config(arch)
    B = INPUT_SHAPES[shape].global_batch
    d, E, K, V = (cfg.d_model, cfg.moe.num_experts, cfg.moe.top_k,
                  cfg.vocab_size)
    pieces = _chunks(min(moe_capacity(B, cfg.moe), B * K), D)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    total = 0.0
    for size in sorted(set(pieces)):
        rank = pieces.index(size) * M          # data coordinate, model 0
        res = subprocess.run([sys.executable, "-c", _RANK_FLOPS, arch, shape,
                              str(rank)], env=env, timeout=300,
                             capture_output=True, text=True)
        assert res.returncode == 0, res.stderr[-2000:]
        flops = float(res.stdout.strip().splitlines()[-1])
        print(f"capacity piece {size} (x{pieces.count(size)} data ranks): "
              f"{flops:.6e} FLOPs a rank")
        total += pieces.count(size) * M * flops
    one = _world_of_one(arch, shape)
    router = (M - 1) * cfg.num_layers * 2 * B * d * E
    unembed = (M - 1) * 2 * B * d * V
    assert V % M
    print(f"{shape}: 256 ranks {total:.6e} FLOPs = a world of one "
          f"{one:.6e} + router {router:.6e} + unembedding {unembed:.6e} "
          f"repeated over model")
    assert total == one + router + unembed


def test_hybrid_ranks_sum_to_the_world_of_one(no_world):
    """recurrentgemma-9b at decode_32k: the FLOPs of the 256 ranks of the
    16x16 mesh sum to the same step at a world of one plus the work that
    the rules leave replicated over ``model``, exactly, and that work is
    none: every product's split dim divides 16 (16 query heads, the LRU
    width of 4,096 in ``lru_in``, the gates and ``lru_out``, d_ff 12,288,
    the vocab of 256,000, the ring's 2,048 slots, and the one kv head's
    head_dim of 256 in ``wk`` and ``wv``), and the decode batch of 128
    splits over 16 data ranks, so every rank does the same work: one rank
    is traced, in a subprocess of its own, at the cycle-wise depths of
    ``trace_at_depth``."""
    arch, shape = "recurrentgemma-9b", "decode_32k"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", _RANK_FLOPS, arch, shape,
                          "0"], env=env, timeout=300, capture_output=True,
                         text=True)
    assert res.returncode == 0, res.stderr[-2000:]
    rank = float(res.stdout.strip().splitlines()[-1])
    one = _world_of_one(arch, shape)
    replicated = 0.0
    print(f"{shape}: 256 ranks x {rank:.6e} = {256 * rank:.6e} FLOPs, a "
          f"world of one {one:.6e} + replicated over model {replicated}")
    assert 256 * rank == one + replicated


def test_skipped_and_failing_records(no_world, tmp_path):
    from repro_torch.launch import dryrun
    rec = dryrun.run_one("whisper-tiny", "long_500k", True, str(tmp_path),
                         verbose=False, device="cpu")
    assert rec["status"] == "skipped" and "500K" in rec["reason"]
    assert (tmp_path / "whisper-tiny__long_500k__2x16x16.json").exists()
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", "no-such-arch", "--shape", "decode_32k",
                     "--device", "cpu", "--out", str(tmp_path)])
    assert e.value.code == 1
    with open(tmp_path / "no-such-arch__decode_32k__16x16.json") as f:
        bad = json.load(f)
    assert bad["status"] == "error" and "KeyError" in bad["error"]
    assert "traceback" in bad
