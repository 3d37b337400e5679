"""Public kernel entry points plus the im2col sign-off path.

Counterpart of ``repro/kernels/ops.py``.  ``conv1d_q`` lowers the 1-D
convolution onto the W8A8 matmul through a materialised im2col patch
tensor, so convolution and dense layers share one MAC datapath (the
paper's central idea).  The fused conv (kernel K2) is its deployed
successor; ``conv1d_q`` stays as the oracle the fused path is signed off
against (same quantisers, same int8 payloads, same accumulators).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.quantization import QTensor, fxp8_quantize, int8_symmetric
from repro_torch.kernels.conv1d_fused import conv1d_fused, conv1d_fused_q  # noqa: F401
from repro_torch.kernels.cordic_act import cordic_activation, cordic_softmax  # noqa: F401
from repro_torch.kernels.quant_matmul import quant_matmul


def quant_matmul_f32(
    x: torch.Tensor,
    w: torch.Tensor,
    bias: torch.Tensor | None = None,
    *,
    fxp: bool = False,
    act: str | None = None,
    clip=None,
) -> torch.Tensor:
    """Quantise fp32 operands (per-tensor act, per-column weight) and multiply
    on the W8A8 matmul, with the optional fused bias/ReLU/clip epilogue."""
    quant = fxp8_quantize if fxp else int8_symmetric
    xq: QTensor = quant(x, axis=None)
    wq: QTensor = quant(w, axis=1)
    return quant_matmul(
        xq.q, wq.q, xq.scale.reshape(1, 1), wq.scale.reshape(1, -1), bias,
        act=act, clip=clip,
    )


def _im2col(x: torch.Tensor, k: int) -> torch.Tensor:
    """(B, L, C) -> (B*L, k*C) patches under 'same' zero padding."""
    b, l, c = x.shape
    pad = (k - 1) // 2
    xp = F.pad(x, (0, 0, pad, k - 1 - pad))
    cols = torch.stack([xp[:, i : i + l, :] for i in range(k)], dim=2)  # (B, L, k, C)
    return cols.reshape(b * l, k * c)


def conv1d_q(
    x: torch.Tensor,  # (B, L, Cin) fp32
    w: torch.Tensor,  # (K, Cin, Cout) fp32
    b: torch.Tensor | None = None,
    *,
    fxp: bool = False,
) -> torch.Tensor:
    """Quantised 'same' 1-D convolution on the shared matmul datapath
    (materialised-im2col reference path)."""
    bsz, l, cin = x.shape
    k, cin2, cout = w.shape
    if cin != cin2:
        raise ValueError(f"Cin mismatch: {tuple(x.shape)} x {tuple(w.shape)}")
    patches = _im2col(x, k)  # (B*L, K*Cin)
    wmat = w.reshape(k * cin, cout)
    out = quant_matmul_f32(patches, wmat, fxp=fxp).reshape(bsz, l, cout)
    return out if b is None else out + b
