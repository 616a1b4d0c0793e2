"""Training launcher.

    PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b \
        --steps 200 --batch 8 --seq 256 [--reduced] [--device cpu] \
        [--ckpt-dir DIR --ckpt-every N]

Port of the reference ``launch/train.py`` on one device: the card by
default, or the CPU with ``--device cpu``. The reference's ``--host-mesh``
and ``--multi-pod`` run its FSDP + TP sharding rules over a device mesh;
the port has no sharding yet, so it refuses them rather than train on one
device under a flag that promises a mesh.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.configs import get_config
from repro_torch.data.pipeline import make_train_batches
from repro_torch.training.train_loop import TrainLoopConfig, train


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--reduced", action="store_true",
                    help="use the CPU-smoke reduced config")
    ap.add_argument("--host-mesh", action="store_true",
                    help="refused: needs the sharding port")
    ap.add_argument("--multi-pod", action="store_true",
                    help="refused: needs the sharding port")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    for flag in ("host_mesh", "multi_pod"):
        if getattr(args, flag):
            ap.error(f"--{flag.replace('_', '-')}: the port trains on one "
                     "device; meshes need the sharding port (ROADMAP "
                     "Queue 1)")
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is present")

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()

    loop_cfg = TrainLoopConfig(
        num_steps=args.steps, batch_size=args.batch, seq_len=args.seq,
        lr=args.lr, ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every)
    batches = make_train_batches(cfg, args.batch, args.seq)
    out = train(cfg, loop_cfg, batches, device=args.device)
    final = out["history"][-1] if out["history"] else {}
    print("final:", final)
    return final


if __name__ == "__main__":
    main()
