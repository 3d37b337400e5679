"""The float32 checkpoint both sides start from, made from the seed.

One ``torch.randn`` call on a generator on the run's device draws every
weight and bias at once; the weights take He scaling (``sqrt(2 / fan_in)``,
as the program's ``cnn1d.init_params``), and the biases a small spread, as
a trained detector's have (the program's epilogues add them).  The last
conv's output channels are then scaled to distinct L1 norms, a seeded
permutation of an even spread over 0.5-1.5 times their mean, as a trained
layer's channels differ in importance: the structured prune keeps the
channels of largest L1 norm, and He-normal channels' norms lie so close
together that float32 and float64 sums could rank two of them apart.  The
layout is the program's params dict: conv weights ``(K, Cin, Cout)``,
dense weights ``(in, out)``.
"""
from __future__ import annotations

import math

import torch

#: standard deviation of the seeded biases
BIAS_STD = 0.1


def shapes(cnn: dict) -> dict[str, tuple[tuple[int, ...], tuple[int, ...], int]]:
    """layer -> (weight shape, bias shape, fan-in) of the unpruned model."""
    out, cin, l = {}, 1, cnn["input_len"]
    for i, cout in enumerate(cnn["channels"]):
        out[f"conv{i}"] = ((cnn["kernel"], cin, cout), (cout,), cnn["kernel"] * cin)
        cin, l = cout, l // 2
    flatten = l * cin
    out["dense0"] = ((flatten, cnn["hidden"]), (cnn["hidden"],), flatten)
    out["dense1"] = ((cnn["hidden"], cnn["n_classes"]), (cnn["n_classes"],), cnn["hidden"])
    return out


def float_params(cnn: dict, seed: int, device) -> dict:
    """The seeded fp32 params dict on ``device``."""
    dev = torch.device(device)
    table = shapes(cnn)
    sizes = [math.prod(s) for w, b, _ in table.values() for s in (w, b)]
    gen = torch.Generator(device=dev).manual_seed(seed)
    flat = torch.randn(sum(sizes), generator=gen, device=dev, dtype=torch.float32)
    parts = iter(torch.split(flat, sizes))
    params = {}
    for name, (w_shape, b_shape, fan_in) in table.items():
        w, b = next(parts), next(parts)
        params[name] = {
            "w": (w * math.sqrt(2.0 / fan_in)).reshape(w_shape),
            "b": (b * BIAS_STD).reshape(b_shape),
        }
    last = params[f"conv{len(cnn['channels']) - 1}"]
    l1 = last["w"].abs().sum(dim=(0, 1))
    cout = l1.numel()
    rank = torch.randperm(cout, generator=gen, device=dev).to(torch.float32)
    last["w"] = last["w"] * (l1.mean() * (0.5 + rank / (cout - 1)) / l1)
    return params
