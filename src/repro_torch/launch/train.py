"""Training launcher.

    PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b \
        --steps 200 --batch 8 --seq 256 [--reduced] [--device cpu] \
        [--ckpt-dir DIR --ckpt-every N]
    PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.train \
        --arch tinyllama-1.1b --reduced --host-mesh --device cpu

Port of the reference ``launch/train.py``: the card by default, or the CPU
with ``--device cpu``. ``--host-mesh`` trains under the training rules
over a ("data", "model") mesh of every rank of the process group (nccl on
the card, gloo on the CPU; a world of one without ``torchrun``): FSDP over
``data``. ``--multi-pod`` trains on the reference's production mesh,
``(2, 16, 16)`` over ("pod", "data", "model"): FSDP over the pods and
``data``, tensor parallelism over ``model`` (the dense and VLM members);
it needs a world of 512 ranks (64 nodes of 8 cards under ``torchrun``)
and refuses any other. ``main`` returns the last logged record; ``run``
returns every one.
"""
from __future__ import annotations

import argparse
import os
from typing import Dict, List

import torch
import torch.distributed as dist

from repro_torch.configs import get_config
from repro_torch.data.pipeline import make_train_batches
from repro_torch.launch.mesh import (init_distributed, make_host_mesh,
                                     make_production_mesh)
from repro_torch.sharding import TRAIN_RULES, use_rules
from repro_torch.training.train_loop import TrainLoopConfig, train


def run(argv=None, log_every: int = 10) -> List[Dict[str, float]]:
    """Train as the command line ``argv`` asks; the history of records
    logged every ``log_every`` steps and at the last (every rank logs the
    same)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--reduced", action="store_true",
                    help="use the CPU-smoke reduced config")
    ap.add_argument("--host-mesh", action="store_true",
                    help="FSDP over a mesh of every rank (torchrun)")
    ap.add_argument("--multi-pod", action="store_true",
                    help="the 2x16x16 production mesh (512 ranks)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if args.multi_pod and world != 512:
        ap.error(f"--multi-pod: the 2x16x16 production mesh needs a world "
                 f"of 512 ranks, not {world}")
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is present")

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()

    loop_cfg = TrainLoopConfig(
        num_steps=args.steps, batch_size=args.batch, seq_len=args.seq,
        lr=args.lr, ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
        log_every=log_every)
    batches = make_train_batches(cfg, args.batch, args.seq)
    rank = 0
    if not (args.host_mesh or args.multi_pod):
        out = train(cfg, loop_cfg, batches, device=args.device)
    else:
        created = init_distributed(args.device)
        try:
            rank = dist.get_rank()
            mesh = (make_production_mesh(multi_pod=True, device=args.device)
                    if args.multi_pod else make_host_mesh(device=args.device))
            with use_rules(TRAIN_RULES):
                out = train(cfg, loop_cfg, batches, device=args.device,
                            mesh=mesh)
        finally:
            if created:
                dist.destroy_process_group()
    if rank == 0:
        print("final:", out["history"][-1] if out["history"] else {})
    return out["history"]


def main(argv=None) -> Dict[str, float]:
    hist = run(argv)
    return hist[-1] if hist else {}


if __name__ == "__main__":
    main()
