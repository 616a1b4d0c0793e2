"""Multi-pod dry run: trace one rank's step of every (architecture x input
shape) on the production meshes, without the cards.

Port of the reference ``launch/dryrun.py``. For the 16x16 mesh and the
2x16x16 one, in one process over torch's ``"fake"`` process group of 256
or 512 ranks (``launch/mesh.init_fake_world``):

    with FakeTensorMode():
        spec = input_specs.build(arch, shape, mesh)   # fake DTensor args
        cost, peak = op_cost.analyze_ops(spec.fn, *spec.args)

The step runs eagerly on fake tensors: no memory, no kernel, no message;
the counter reads one rank's flops, traffic, collectives and peak live
bytes (``launch/op_cost.py``) and ``launch/roofline.py`` turns them into
terms of the card. An eager trace pays for every op of every layer (a
32K-token prefill runs some 57,000 ops a layer, about 7 s on a CPU),
so the step is traced at a depth of 1 and of 2 layers and each count is
extrapolated to the config's depth (the hybrid's at one and two pattern
cycles and one cycle with its tail): the dense stack is identical layers,
so every count, the peak included (a layer's weights, cache, store and
saved activations), grows by the same amount per layer, as the reference
multiplies a scan body's cost by its trip count
(``tests/test_torch_dryrun.py`` holds the extrapolation equal to a trace
of every layer for decode_32k and long_500k, and of 3 layers for
train_4k and prefill_32k). Records are written to
results/dryrun_torch/<arch>__<shape>__<mesh>.json with the reference's
keys, ``trace_s`` (the trace's seconds) in place of its ``lower_s`` and
``compile_s``: nothing is lowered or compiled.

Usage:
    python -m repro_torch.launch.dryrun --arch llama3-8b --shape decode_32k
    python -m repro_torch.launch.dryrun --all --both-meshes --device cpu

The card is the default device: fake CUDA tensors there, fake CPU tensors
with ``--device cpu``. The counts are the same on either.
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.configs import ASSIGNED_ARCHS, get_config
from repro_torch.configs.base import INPUT_SHAPES
from repro_torch.launch import input_specs as ispecs
from repro_torch.launch import roofline as rl
from repro_torch.launch.mesh import init_fake_world, make_production_mesh
from repro_torch.launch.op_cost import Cost, analyze_ops
from repro_torch.sharding import use_rules

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "results", "dryrun_torch")


def _world(chips: int) -> None:
    """The fake process group of ``chips`` ranks, made once per size."""
    if dist.is_initialized():
        if dist.get_world_size() == chips:
            return
        dist.destroy_process_group()
    init_fake_world(chips)


def trace(arch: str, shape: str, multi_pod: bool, variant=None,
          device: str = "cuda", layers: Optional[int] = None):
    """(cost, peak, spec) of one rank's step, traced on fake tensors;
    ``layers``: at that depth."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    _world(512 if multi_pod else 256)
    mesh = make_production_mesh(multi_pod=multi_pod, device=device)
    with FakeTensorMode(allow_non_fake_inputs=True):
        spec = ispecs.build(arch, shape, mesh, variant=variant,
                            device=device, layers=layers)
        with use_rules(spec.rules):
            cost, peak = analyze_ops(spec.fn, *spec.args)
    return cost, peak, spec


def _plus(a, b, n: float = 1.0):
    """(cost, peak) a + n * b, b a difference of two traces."""
    (ca, pa), (cb, pb) = a, b
    kinds = set(ca.per_collective) | set(cb.per_collective)
    per = {k: ca.per_collective.get(k, 0.0) + n * cb.per_collective.get(
        k, 0.0) for k in kinds}
    return Cost(ca.flops + n * cb.flops, ca.traffic + n * cb.traffic,
                ca.collective + n * cb.collective, per), pa + n * pb


def _minus(a, b):
    """(cost, peak) a - b."""
    return _plus(a, b, -1.0)


def extrapolate_cycles(one, two, tail, cycles: int):
    """(cost, peak) of ``cycles`` whole pattern cycles and a tail from
    traces of one cycle, two cycles, and one cycle with the tail (``tail``
    None: no tail): each cycle adds the second cycle's share, the tail its
    own. A stack of one kind of layer is a pattern of one layer."""
    out = _plus(one, _minus(two, one), cycles - 1)
    return out if tail is None else _plus(out, _minus(tail, one))


def trace_at_depth(arch: str, shape: str, multi_pod: bool, variant=None,
                   device: str = "cuda"):
    """(cost, peak, spec) of the step at the config's depth, traced at one
    and two pattern cycles (a hybrid stack's layers are of two kinds in a
    repeating pattern; any other stack's pattern is one layer) and one
    cycle with the tail, and extrapolated (``extrapolate_cycles``)."""
    cfg = get_config(arch)
    p = len(cfg.hybrid.pattern) if cfg.hybrid.enabled else 1
    cycles, t = divmod(cfg.num_layers, p)
    if cycles <= 2:
        return trace(arch, shape, multi_pod, variant, device)

    def at(n):
        return trace(arch, shape, multi_pod, variant, device, layers=n)[:2]
    spec = trace(arch, shape, multi_pod, variant, device, layers=p)
    tail = at(p + t) if t else None
    return (*extrapolate_cycles(spec[:2], at(2 * p), tail, cycles), spec[2])


def run_one(arch: str, shape: str, multi_pod: bool,
            out_dir: str = RESULTS_DIR, verbose: bool = True,
            variant: str | None = None, device: str = "cuda") -> dict:
    mesh_name = "2x16x16" if multi_pod else "16x16"
    chips = 512 if multi_pod else 256
    t0 = time.perf_counter()
    record = {"arch": arch, "shape": shape, "mesh": mesh_name,
              "variant": variant, "status": "ok"}
    try:
        cost, peak, spec = trace_at_depth(arch, shape, multi_pod, variant,
                                          device)
        t_trace = time.perf_counter() - t0
        roof = rl.analyze(cost, peak, arch=arch, shape=shape,
                          mesh_name=mesh_name, chips=chips,
                          cfg=get_config(arch), ishape=INPUT_SHAPES[shape],
                          note=spec.note)
        record.update(roofline=roof.to_dict(), trace_s=t_trace)
        if verbose:
            print(f"[{arch} x {shape} x {mesh_name}] trace {t_trace:.1f}s "
                  f"flops={cost.flops:.3e} bytes={cost.traffic:.3e} "
                  f"peak={peak / 2**30:.2f} GiB")
            print(f"  roofline: compute {roof.compute_s:.3e}s "
                  f"memory {roof.memory_s:.3e}s "
                  f"collective {roof.collective_s:.3e}s "
                  f"-> {roof.dominant}-bound; useful flops "
                  f"{100*roof.useful_flops_ratio:.1f}%")
    except ispecs.Skip as e:
        record.update(status="skipped", reason=str(e))
        if verbose:
            print(f"[{arch} x {shape} x {mesh_name}] SKIPPED: {e}")
    except Exception as e:  # a failure here is a bug in the system
        record.update(status="error", error=f"{type(e).__name__}: {e}",
                      traceback=traceback.format_exc())
        if verbose:
            print(f"[{arch} x {shape} x {mesh_name}] ERROR: {e}")
    record["wall_s"] = time.perf_counter() - t0
    os.makedirs(out_dir, exist_ok=True)
    vtag = f"__{variant}" if variant else ""
    fname = f"{arch}__{shape}__{mesh_name}{vtag}.json".replace("/", "_")
    with open(os.path.join(out_dir, fname), "w") as f:
        json.dump(record, f, indent=1, default=str)
    return record


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--variant", default=None,
                    help="comma-joined rule and config variants "
                         "(sharding.specs.VARIANTS, "
                         "input_specs.CFG_VARIANTS, int8store, zero1)")
    ap.add_argument("--out", default=RESULTS_DIR)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="the fake tensors' device (the card by default)")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is present "
                         "(trace on the CPU with --device cpu)")

    archs = ASSIGNED_ARCHS if (args.all or not args.arch) else [args.arch]
    shapes = list(INPUT_SHAPES) if (args.all or not args.shape) \
        else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    failures = 0
    try:
        for mp in meshes:
            for arch in archs:
                for shape in shapes:
                    mesh_name = "2x16x16" if mp else "16x16"
                    fname = os.path.join(
                        args.out, f"{arch}__{shape}__{mesh_name}.json")
                    if args.skip_existing and os.path.exists(fname):
                        with open(fname) as f:
                            if json.load(f).get("status") in ("ok",
                                                              "skipped"):
                                continue
                    rec = run_one(arch, shape, mp, args.out,
                                  variant=args.variant, device=args.device)
                    failures += rec["status"] == "error"
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    print(f"\ndry-run complete; {failures} failures")
    raise SystemExit(1 if failures else 0)


if __name__ == "__main__":
    main()
