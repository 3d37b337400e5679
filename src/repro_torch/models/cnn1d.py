"""The 1D-F-CNN detector (SHIELD8-UAV §III-A): configuration and parameters.

Counterpart of the configuration half of ``repro/models/cnn1d.py``.  Three
blocks of conv (K = 3, 'same') -> ReLU -> max-pool 2, a flatten in
``(frames, channels)`` row-major order, then two dense layers.  The
canonical MFCC-20 configuration reproduces the paper's flatten size:

    M=1096 --pool/2--> 548 --pool/2--> 274 --pool/2--> 137 frames x 256 ch
    flatten = 137 * 256 = 35,072          (Table I, before pruning)
    pruned  = 136 * 64  =  8,704          (Table I, after pruning)

Parameters are a plain dict of tensors with the reference's layout: conv
weights ``(K, Cin, Cout)``, dense weights ``(in, out)``.  The float
emulation forward and training belong to a later slice (ROADMAP M9).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Mapping

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class CNNConfig:
    input_len: int = 1096
    channels: tuple[int, ...] = (64, 128, 256)
    kernel: int = 3
    hidden: int = 64
    n_classes: int = 2
    dropout: float = 0.2

    @property
    def n_frames(self) -> int:
        n = self.input_len
        for _ in self.channels:
            n //= 2
        return n

    @property
    def flatten_size(self) -> int:
        return self.n_frames * self.channels[-1]


CANONICAL = CNNConfig()  # flatten 35,072
if CANONICAL.flatten_size != 35_072:
    raise AssertionError(CANONICAL.flatten_size)


def init_params(
    cfg: CNNConfig = CANONICAL, generator: torch.Generator | None = None
) -> dict:
    """He-init conv + dense weights (float32, on the CPU); biases zero, the
    per-layer PACT alpha 6.  Same shapes as the reference's ``init_params``;
    the values come from ``generator`` and differ from ``jax.random``'s."""

    def normal(shape, fan_in):
        w = torch.randn(shape, generator=generator, dtype=torch.float32)
        return w * math.sqrt(2.0 / fan_in)

    params: dict = {}
    c_in = 1
    for i, c_out in enumerate(cfg.channels):
        params[f"conv{i}"] = {
            "w": normal((cfg.kernel, c_in, c_out), cfg.kernel * c_in),
            "b": torch.zeros(c_out),
            "alpha": torch.tensor(6.0),
        }
        c_in = c_out
    params["dense0"] = {
        "w": normal((cfg.flatten_size, cfg.hidden), cfg.flatten_size),
        "b": torch.zeros(cfg.hidden),
        "alpha": torch.tensor(6.0),
    }
    params["dense1"] = {
        "w": normal((cfg.hidden, cfg.n_classes), cfg.hidden),
        "b": torch.zeros(cfg.n_classes),
    }
    return params


def params_from_numpy(tree: Mapping) -> dict:
    """The port's params from the reference's fp32 params as a numpy tree
    (``jax.tree.map(np.asarray, params)``): same keys, same layouts."""
    return {
        layer: {k: torch.from_numpy(np.array(v, np.float32)) for k, v in leaves.items()}
        for layer, leaves in tree.items()
    }


def maxpool2(x: torch.Tensor) -> torch.Tensor:
    """M_1x2: max-pool width 2, stride 2 over the length axis of (B, L, C);
    an odd last row is dropped ('VALID')."""
    b, l, c = x.shape
    return x[:, : 2 * (l // 2), :].reshape(b, l // 2, 2, c).amax(dim=2)
