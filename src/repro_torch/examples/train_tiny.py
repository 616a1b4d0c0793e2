"""Train a ~100M-param model for a few hundred steps, on the port.

Uses the full (non-reduced) mamba2-130m config by default, or any --arch
at --reduced scale. Shows the loss descending on the synthetic
copy-structured LM task and writes checkpoints into a temporary
directory. Runs on the card; ``--device cpu`` trains on the CPU.

    PYTHONPATH=src python -m repro_torch.examples.train_tiny [--steps 200]
"""
from __future__ import annotations

import argparse
import tempfile

import torch

from repro_torch.configs import get_config
from repro_torch.training.train_loop import TrainLoopConfig, train


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="mamba2-130m")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is present")

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    print(f"training {cfg.name}: {cfg.param_count()/1e6:.0f}M params, "
          f"{args.steps} steps @ batch {args.batch} x seq {args.seq}")

    with tempfile.TemporaryDirectory() as ckpt_dir:
        out = train(cfg, TrainLoopConfig(
            num_steps=args.steps, batch_size=args.batch, seq_len=args.seq,
            lr=3e-4, warmup=20, log_every=20,
            ckpt_dir=ckpt_dir, ckpt_every=max(args.steps // 2, 1)),
            device=args.device)
    hist = out["history"]
    print(f"loss: {hist[0]['loss']:.3f} -> {hist[-1]['loss']:.3f}")
    assert hist[-1]["loss"] < hist[0]["loss"], "training failed to descend"
    print("OK")
    return hist


if __name__ == "__main__":
    main()
