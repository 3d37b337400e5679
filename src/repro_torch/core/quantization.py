"""Precision-aware quantisation (SHIELD8-UAV §III-B).

Counterpart of ``repro/core/quantization.py``: the numeric modes
(``Precision``), the deployment quantisers that produce real int8
payloads plus scales (``int8_symmetric``, its layer-stacked form
``int8_symmetric_keep``, ``fxp8_quantize``), and the
emulation quantisers that return fake-quantised fp32 tensors and drive the
accuracy tables: PwQ for weights (paper eqs. 4-6), PACT for activations
(eqs. 7-8) with its straight-through gradient (``pact_ste``), and
``quantize_tensor``/``activation_quantize`` over the four modes.

Bitwise parity with the reference rests on these details:

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
    """An int8 tensor + dequantisation scale (per-channel on ``axis``).

    A weight placed on a mesh (``distributed/sharding.shard``) holds this
    rank's part of the payload and the whole scale, as the reference's
    specs place them; ``start`` is then where the part begins in the whole
    payload, one entry a dimension (``None``: the payload is whole), and
    :meth:`local_scale` takes the part's channels."""

    q: torch.Tensor  # int8 payload
    scale: torch.Tensor  # fp32, broadcastable against the whole payload
    axis: Optional[int] = None  # channel axis the scale follows (None = per-tensor)
    start: Optional[tuple[int, ...]] = None

    @property
    def shape(self):
        return self.q.shape

    def local_scale(self) -> torch.Tensor:
        """The scale's channels of this payload: a dimension on which the
        scale has more channels than the part has is narrowed to the part's.
        A part that has lost its ``start`` raises (broadcasting the whole
        scale over a part of one channel would dequantise it wrongly)."""
        s = self.scale
        if s.ndim != self.q.ndim:  # a per-tensor scale
            return s
        for dim, n in enumerate(self.q.shape):
            if s.shape[dim] not in (1, n):
                if self.start is None:
                    raise ValueError(f"a QTensor part of shape {tuple(self.q.shape)} with a "
                                     f"scale of {tuple(s.shape)} does not say where it starts")
                s = s.narrow(dim, self.start[dim], n)
        return s

    def dequantize(self) -> torch.Tensor:
        return self.q.to(torch.float32) * self.local_scale()

    def to(self, device) -> "QTensor":
        return QTensor(self.q.to(device), self.scale.to(device), self.axis, self.start)


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


def int8_symmetric_keep(w: torch.Tensor, keep_axes: tuple[int, ...]) -> QTensor:
    """Symmetric int8 with scales kept along ``keep_axes`` (e.g. the stacked
    layer axis 0 *and* the output-channel axis -1 for layer-stacked
    weights); ``axis`` is the largest kept axis, as in the reference."""
    w = w.to(torch.float32)
    keep = {a % w.ndim for a in keep_axes}
    red = tuple(i for i in range(w.ndim) if i not in keep)
    amax = w.abs().amax(dim=red, keepdim=True) if red else w.abs()
    scale = _over_127(torch.clamp_min(amax, 1e-12), False)
    return QTensor(q=_to_int8(w, scale), scale=scale, axis=max(keep))


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
    """BF16 mode: true round-trip through bfloat16, back in float32.  Its
    gradient is rounded through bfloat16 too, as ``jax.grad``'s is."""
    return x.to(torch.bfloat16).to(torch.float32)


# ---------------------------------------------------------------------------
# PwQ weight quantisation (paper eqs. 4-6)
# ---------------------------------------------------------------------------


def _abs(w: torch.Tensor) -> torch.Tensor:
    """``|w|`` with ``jnp.abs``'s gradient, ``+1`` at 0."""
    return torch.where(w >= 0, w, -w)


def _clip(x: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """``jnp.clip``: ties split the gradient between value and bound."""
    return torch.minimum(torch.maximum(x, lo), hi)


def _mean(x: torch.Tensor) -> torch.Tensor:
    """``jnp.mean`` of all of ``x`` (float32 out): the sum rounded once to
    float32, times the float32 reciprocal of the count."""
    total = x.sum(dtype=torch.float64).to(torch.float32)
    return total * _const(float(np.float32(1.0) / np.float32(x.numel())), x)


def pwq_scale(w: torch.Tensor, n_bits: int) -> torch.Tensor:
    """Paper eq. (4):  scale(k) = mean(|W|) * (2^n - 1) / 2^(n-1)."""
    n = n_bits
    return _mean(_abs(w)) * _const(2.0**n - 1.0, w) / _const(2.0 ** (n - 1), w)


def _nonzero_scale(w: torch.Tensor, n_bits: int) -> torch.Tensor:
    k = pwq_scale(w, n_bits)
    return torch.where(k == 0, torch.ones_like(k), k)


def default_clip_bounds(w: torch.Tensor, n_bits: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Initial (W_l, W_h) clipping bounds for PwQ: the range of the weights
    normalised by eq. (4)'s scale (the domain of eq. 5).  The paper learns
    the bounds; these are what they start from."""
    wn = torch.div(w, _nonzero_scale(w, n_bits))
    return wn.amin(), wn.amax()


def pwq_quantize(
    w: torch.Tensor,
    n_bits: int,
    w_l: Optional[torch.Tensor] = None,
    w_h: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """PwQ fake-quantise ``w`` to ``n_bits`` (paper eqs. 4-6), fp32 out.

    eq. (5):  Ŵ = round((clip(W/k, W_l, W_h) - W_l) * (2^n-1)/(W_h-W_l))
    eq. (6):  Q(W) = Ŵ * (W_h-W_l)/(2^n-1) + W_l        (then re-scaled by k)
    """
    w = w.to(torch.float32)
    k = _nonzero_scale(w, n_bits)
    if w_l is None or w_h is None:
        d_l, d_h = default_clip_bounds(w, n_bits)
        w_l = d_l if w_l is None else w_l
        w_h = d_h if w_h is None else w_h
    span = torch.clamp_min(w_h - w_l, 1e-12)
    levels = _const(2.0**n_bits - 1.0, w)
    w_hat = torch.round(torch.div((_clip(torch.div(w, k), w_l, w_h) - w_l) * levels, span))
    q = torch.div(w_hat * span, levels) + w_l
    return q * k


def pwq_error(w: torch.Tensor, n_bits: int) -> torch.Tensor:
    """||Q^PwQ(w) - w||_2, the building block of the sensitivity score."""
    return torch.linalg.vector_norm(pwq_quantize(w, n_bits) - w)


# ---------------------------------------------------------------------------
# PACT activation quantisation (paper eqs. 7-8)
# ---------------------------------------------------------------------------


def pact(x: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """Paper eq. (7):  y = 0.5 (|x| - |x - α| + α)  ==  clip(x, 0, α)."""
    return 0.5 * (torch.abs(x) - torch.abs(x - alpha) + alpha)


def pact_quantize(x: torch.Tensor, alpha: torch.Tensor, n_bits: int) -> torch.Tensor:
    """Paper eq. (8): quantise the PACT-clipped activation to n_bits (fp32 out)."""
    y = pact(x, alpha)
    levels = _const(2.0**n_bits - 1.0, x)
    a = torch.clamp_min(alpha, 1e-12)
    return torch.div(torch.round(torch.div(y * levels, a)) * a, levels)


class PactSTE(torch.autograd.Function):
    """``pact_quantize`` with the reference's custom gradient: straight
    through for x in [0, α]; PACT's dα = sum(g where x >= α)."""

    @staticmethod
    def forward(ctx, x, alpha, n_bits):
        ctx.save_for_backward(x, alpha)
        return pact_quantize(x, alpha, n_bits)

    @staticmethod
    def backward(ctx, g):
        x, alpha = ctx.saved_tensors
        zero = torch.zeros_like(g)
        dx = torch.where((x >= 0) & (x <= alpha), g, zero)
        dalpha = torch.where(x >= alpha, g, zero).sum().reshape(alpha.shape)
        return dx, dalpha, None


def pact_ste(x: torch.Tensor, alpha: torch.Tensor, n_bits: int) -> torch.Tensor:
    return PactSTE.apply(x, alpha, n_bits)


# ---------------------------------------------------------------------------
# The four modes (emulation path)
# ---------------------------------------------------------------------------


def quantize_tensor(w: torch.Tensor, precision: Precision, axis: Optional[int] = None) -> torch.Tensor:
    """Fake-quantise ``w`` under ``precision`` (fp32 in, fp32 out): the
    emulation path that scores accuracy (Table II).  INT8 uses PwQ (the
    paper's weight quantiser), FXP8 the power-of-two-scale variant, whose
    output carries no gradient (its payload is an integer and its scale a
    ``ceil``), as in the reference."""
    if precision == Precision.FP32:
        return w.to(torch.float32)
    if precision == Precision.BF16:
        return bf16_round(w)
    if precision == Precision.INT8:
        return pwq_quantize(w, 8)
    if precision == Precision.FXP8:
        return fxp8_quantize(w.detach(), axis=axis).dequantize()
    raise ValueError(f"unknown precision {precision}")


def activation_quantize(x: torch.Tensor, precision: Precision,
                        alpha: torch.Tensor | float = 6.0) -> torch.Tensor:
    """Quantise activations under ``precision`` (PACT for the 8-bit modes)."""
    if precision == Precision.FP32:
        return x
    if precision == Precision.BF16:
        return bf16_round(x)
    alpha = torch.as_tensor(alpha, dtype=torch.float32, device=x.device)
    return pact_ste(x, alpha, 8)


def quantization_mse(w: torch.Tensor, precision: Precision) -> float:
    """Mean-squared emulation error of a tensor under a precision mode."""
    return float(torch.mean((quantize_tensor(w, precision) - w) ** 2))
