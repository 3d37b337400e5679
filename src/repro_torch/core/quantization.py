"""Deployment quantisers of the W8A8 datapath (SHIELD8-UAV §III-B).

Counterpart of ``repro/core/quantization.py``: the numeric modes
(``Precision``) and the two deployment quantisers that produce real int8
payloads plus scales (``int8_symmetric``, ``fxp8_quantize``).  The
emulation quantisers (PwQ, PACT) belong to the training slice and are not
ported yet.

Bitwise parity with the reference rests on three details:

* every division is by a tensor on the operand's device: PyTorch's CUDA
  division by a host scalar multiplies by its reciprocal instead;
* ``torch.round`` rounds half to even, as ``jnp.round`` does;
* the FXP8 exponent and scale use the reference's own ``log2``/``exp2``
  bits (:mod:`repro_torch.core.f32_math`), which are not exact at powers
  of two;
* ``amax / 127`` is a division where the reference runs the quantiser
  eagerly (the weight bake), but inside its jitted forward (the
  activations) XLA evaluates it as ``amax * float32(1/127)``, which is one
  ulp off in about one scale of twenty: ``jitted=True`` gives those bits.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Optional

import numpy as np
import torch

from repro_torch.core.f32_math import exp2_f32, log2_f32


class Precision(str, enum.Enum):
    """Numeric modes supported by the shared multi-precision datapath."""

    FP32 = "fp32"
    BF16 = "bf16"
    INT8 = "int8"
    FXP8 = "fxp8"

    @property
    def bits(self) -> int:
        return {"fp32": 32, "bf16": 16, "int8": 8, "fxp8": 8}[self.value]

    @property
    def is_integer(self) -> bool:
        return self in (Precision.INT8, Precision.FXP8)


@dataclasses.dataclass
class QTensor:
    """An int8 tensor + dequantisation scale (per-channel on ``axis``)."""

    q: torch.Tensor  # int8 payload
    scale: torch.Tensor  # fp32, broadcastable against q
    axis: Optional[int] = None  # channel axis the scale follows (None = per-tensor)

    @property
    def shape(self):
        return self.q.shape

    def dequantize(self) -> torch.Tensor:
        return self.q.to(torch.float32) * self.scale

    def to(self, device) -> "QTensor":
        return QTensor(self.q.to(device), self.scale.to(device), self.axis)


def _const(v: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32, device=like.device)


def _amax(w: torch.Tensor, axis: Optional[int]) -> torch.Tensor:
    if axis is None:
        return w.abs().amax()
    red = tuple(i for i in range(w.ndim) if i != axis % w.ndim)
    return w.abs().amax(dim=red, keepdim=True)


#: float32(1 / 127): XLA's factor for a division by the constant 127
INV_127_F32 = float(np.float32(1.0) / np.float32(127.0))


def _over_127(amax: torch.Tensor, jitted: bool) -> torch.Tensor:
    if jitted:
        return amax * _const(INV_127_F32, amax)
    return torch.div(amax, _const(127.0, amax))


def _to_int8(w: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(torch.div(w, scale)), -128, 127).to(torch.int8)


def int8_symmetric(w: torch.Tensor, axis: Optional[int] = None, *,
                   jitted: bool = False) -> QTensor:
    """Symmetric int8 quantisation with fp32 per-channel scale (INT8 mode);
    ``jitted`` gives the bits of the reference's jitted forward."""
    w = w.to(torch.float32)
    amax = torch.clamp_min(_amax(w, axis), 1e-12)
    scale = _over_127(amax, jitted)
    return QTensor(q=_to_int8(w, scale), scale=scale, axis=axis)


def fxp8_quantize(w: torch.Tensor, axis: Optional[int] = None, *,
                  jitted: bool = False) -> QTensor:
    """FXP8: the scale is the smallest ``2^e`` with ``127 * 2^e >= amax``, as
    the reference computes it (``ceil(log2(amax / 127))``, then ``exp2``);
    ``jitted`` gives the bits of the reference's jitted forward."""
    w = w.to(torch.float32)
    amax = torch.clamp_min(_amax(w, axis), 1e-12)
    e = torch.ceil(log2_f32(_over_127(amax, jitted)))
    scale = exp2_f32(e)
    return QTensor(q=_to_int8(w, scale), scale=scale, axis=axis)


def bf16_round(x: torch.Tensor) -> torch.Tensor:
    """BF16 mode: true round-trip through bfloat16, back in float32."""
    return x.to(torch.bfloat16).to(torch.float32)
