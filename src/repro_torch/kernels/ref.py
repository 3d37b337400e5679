"""Plain PyTorch oracles for the kernels (the correctness contract).

Counterpart of ``repro/kernels/ref.py``: float references that the kernel
tests hold the quantised paths against within a tolerance.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def quant_matmul_ref(x_q, w_q, x_scale, w_scale) -> torch.Tensor:
    """int8 x int8 -> exact integer accumulate -> fp32 dequant."""
    acc = torch.matmul(x_q.to(torch.float64), w_q.to(torch.float64))
    return acc.to(torch.float32) * x_scale.to(torch.float32) * w_scale.to(torch.float32)


def tanh_ref(x):
    return torch.tanh(x)


def sigmoid_ref(x):
    return torch.sigmoid(x)


def exp_ref(x):
    return torch.exp(torch.clamp(x, -30.0, 30.0))


def swish_ref(x):
    return x * torch.sigmoid(x)


def gelu_ref(x):
    # tanh-approximation GELU (the form the CORDIC unit implements)
    return 0.5 * x * (1.0 + torch.tanh(0.7978845608028654 * (x + 0.044715 * x**3)))


def selu_ref(x):
    return F.selu(x)


def relu_ref(x):
    return F.relu(x)


def softmax_ref(x, axis=-1):
    return torch.softmax(x, dim=axis)


ACT_REFS = {
    "tanh": tanh_ref,
    "sigmoid": sigmoid_ref,
    "exp": exp_ref,
    "swish": swish_ref,
    "gelu": gelu_ref,
    "selu": selu_ref,
    "relu": relu_ref,
}


def conv1d_q_ref(x, w, b=None):
    """fp32 'same'-padded 1-D conv oracle in NWC: (B, L, Cin) x (K, Cin, Cout)."""
    k = w.shape[0]
    pad_l = (k - 1) // 2
    xc = F.pad(x.transpose(1, 2), (pad_l, k - 1 - pad_l))
    out = F.conv1d(xc, w.permute(2, 1, 0)).transpose(1, 2)
    return out if b is None else out + b
