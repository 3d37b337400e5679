"""End-to-end LM training driver example on the PyTorch port (~100M-param
class, scaled down).

Counterpart of ``examples/train_lm.py`` through ``repro_torch`` alone:
exercises the production loop of ``repro_torch.launch.train`` (params
placed by their shardings, grad-accumulation train step, prefetching
loader, checkpoint/restart, preemption hook) on a reduced OLMoE-style MoE
(the paper's quantisation/pruning targets generalised to an assigned
arch), on the GPU (``--device cpu`` for the plain path).  Checkpoints go
under ``build/``; a directory that already holds one resumes from it.  The
loss must fall; the script asserts it.

    PYTHONPATH=src python examples/torch_train_lm.py --steps 60 [--device cpu]
    # full driver (any assigned arch):
    PYTHONPATH=src python -m repro_torch.launch.train --arch olmoe-1b-7b --smoke --steps 200
"""
from __future__ import annotations

import argparse
import sys

import numpy as np

from repro_torch.launch.train import main as train_main


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--arch", default="olmoe-1b-7b")
    ap.add_argument("--scale", type=float, default=2.0, help="width multiplier (2.0 ~ 5M params; raise toward 100M on a GPU)")
    ap.add_argument("--ckpt-dir", default="build/ckpt_example")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    losses = train_main(
        [
            "--arch", args.arch,
            "--smoke",
            "--scale", str(args.scale),
            "--steps", str(args.steps),
            "--batch", "8",
            "--seq", "128",
            "--lr", "2e-3",
            "--warmup", "5",
            "--ckpt-every", "25",
            "--ckpt-dir", args.ckpt_dir,
            "--device", args.device,
        ]
    )
    first, last = losses[0], float(np.mean(losses[-10:]))
    assert last < first * 0.8, f"loss did not fall: {first:.3f} -> {last:.3f}"
    print(f"OK: loss fell {first:.3f} -> {last:.3f}")


if __name__ == "__main__":
    sys.exit(main())
