"""CORDIC activation unit (POLARON's AF stage): kernels K3 and K3b and their
plain twins.

Counterpart of ``repro/kernels/cordic_act.py``.  The hyperbolic CORDIC runs
bit-faithfully in Q15.16 shift-add (20 stages, iterations 4 and 13
repeated, arithmetic right shifts), so the port reproduces the RTL unit's
numbers, not merely the maths.

* :func:`cordic_softmax` is the classifier head of the serving path.  On a
  CUDA tensor it launches kernel K3 (``csrc/cordic_softmax.cu``: one warp
  per row held in registers for rows of up to 32 values, one block per
  wider row, up to :data:`K3_MAX_COLS`); on a CPU tensor it runs
  :func:`cordic_softmax_plain`.
* :func:`cordic_activation` is the elementwise unit for all seven modes.
  On a CUDA tensor it launches kernel K3b (``csrc/cordic_act.cu``, four
  values a thread through 16-byte loads); on a CPU tensor it runs
  :func:`apply_mode`.  Both kernels take the CORDIC, the exp and the modes
  from ``csrc/cordic.cuh``, which carries the stages on the FP32 pipe as
  exact integer-valued floats: every angle the unit can see
  (:func:`angle_grid`) keeps every intermediate below 2^17.

Three details carry the reference's bits (its CPU numerics, which the
golden artifacts pin): ``jnp.exp2(k)`` is ``exp(ln2 * k)`` with XLA's
``exp``, not an exact power of two
(:func:`repro_torch.core.f32_math.exp2_f32`); ``v / ln2`` by the constant
is evaluated as ``v * float32(1 / ln2)``; and XLA's fused loops contract
``1 + t*t`` (tanh doubling) and ``v + 0.044715 v^3`` (gelu) into FMAs.
Row sums run left to right up to 32 values, and in XLA's windows of 32
beyond (``kernels/xla_sum.py``).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.f32_math import INV_LN2_F32, LN2_F32, exp2_f32, fma_f32, relu
from repro_torch.kernels import backend
from repro_torch.kernels.xla_sum import MAX_ROW, xla_row_sum

F = 16  # fraction bits (Q15.16)
ONE = 1 << F

# hyperbolic iteration schedule: 1..18 with 4 and 13 repeated
ITERS = (1, 2, 3, 4, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 13, 14, 15, 16, 17, 18)
ATANH_TABLE = tuple(round(float(np.arctanh(2.0**-i)) * ONE) for i in ITERS)
_GAIN = float(np.prod([np.sqrt(1.0 - 2.0 ** (-2 * i)) for i in ITERS]))
X0 = round(ONE / _GAIN)  # pre-scaled so x converges to cosh, y to sinh

MODES = ("tanh", "sigmoid", "exp", "swish", "gelu", "selu", "relu")

#: the largest |z| the unit feeds the CORDIC: tanh's clamp at 4.4, over 4,
#: in Q15.16 (round(1.1 * 2^16)); and the exp's, round(ln2 / 2 * 2^16)
Z_MAX = 72090
Z_MAX_EXP = 22713

_SELU_ALPHA = 1.6732632423543772
_SELU_SCALE = 1.0507009873554805


def _c(v: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32, device=like.device)


def cordic_sinh_cosh(z_fx: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Rotation-mode hyperbolic CORDIC on Q15.16 int32; returns (cosh, sinh)
    in Q15.16.  Valid for |z| <= ~1.118."""
    x = torch.full_like(z_fx, X0)
    y = torch.zeros_like(z_fx)
    z = z_fx
    for shift, e in zip(ITERS, ATANH_TABLE):
        d_pos = z >= 0
        xs = x >> shift
        ys = y >> shift
        x, y, z = (
            torch.where(d_pos, x + ys, x - ys),
            torch.where(d_pos, y + xs, y - xs),
            torch.where(d_pos, z - e, z + e),
        )
    return x, y


def _fx(v: torch.Tensor) -> torch.Tensor:
    """fp32 -> Q15.16 (round half to even)."""
    return torch.round(v * float(ONE)).to(torch.int32)


def _fl(v: torch.Tensor) -> torch.Tensor:
    """Q15.16 -> fp32 (the scale is a power of two: exact)."""
    return v.to(torch.float32) * (1.0 / ONE)


def angle_grid(mode: str) -> torch.Tensor:
    """fp32 inputs of ``mode`` whose CORDIC angles cover every Q15.16 angle
    the mode can feed the unit: ``v = 4z / 2^16`` for tanh and gelu (tanh's
    angle is ``v / 4``), twice that for sigmoid and swish (which take
    ``tanh(v / 2)``), and ``v = z / 2^16`` with ``|z| <= Z_MAX_EXP`` for exp
    and selu (there ``k = 0`` and the angle is ``v``); relu takes the tanh
    grid.  Each value is exact in fp32."""
    if mode not in MODES:
        raise ValueError(f"unknown CORDIC mode {mode!r}")
    if mode in ("exp", "selu"):
        z = torch.arange(-Z_MAX_EXP, Z_MAX_EXP + 1, dtype=torch.float64)
        return (z / ONE).to(torch.float32)
    z = torch.arange(-Z_MAX, Z_MAX + 1, dtype=torch.float64)
    scale = 8 if mode in ("sigmoid", "swish") else 4
    return (scale * z / ONE).to(torch.float32)


def exp_core(v: torch.Tensor) -> torch.Tensor:
    """exp(v) via base-2 range reduction + CORDIC exp(r) = cosh r + sinh r."""
    v = torch.clamp(v, -30.0, 30.0)
    k = torch.round(v * _c(INV_LN2_F32, v))
    r = v - k * _c(LN2_F32, v)  # |r| <= ln2/2, inside the convergence domain
    c, s = cordic_sinh_cosh(_fx(r))
    return _fl(c + s) * exp2_f32(k)


def tanh_core(v: torch.Tensor) -> torch.Tensor:
    """tanh via two doublings, tanh(2a) = 2t / (1 + t^2) with a = v/4;
    saturates to sign(v) for |v| >= 4.4."""
    a = torch.clamp(v, -4.4, 4.4) * 0.25
    c, s = cordic_sinh_cosh(_fx(a))
    t = torch.div(s.to(torch.float32), torch.clamp_min(c.to(torch.float32), 1.0))
    one = torch.ones_like(t)
    # the reference's fused loop contracts 1 + t*t into one FMA
    t = torch.div(2.0 * t, fma_f32(t, t, one))
    t = torch.div(2.0 * t, fma_f32(t, t, one))
    return torch.where(v.abs() >= _c(4.4, v), torch.sign(v), t)


def apply_mode(v: torch.Tensor, mode: str) -> torch.Tensor:
    if mode == "tanh":
        return tanh_core(v)
    if mode == "sigmoid":
        return 0.5 * (1.0 + tanh_core(0.5 * v))
    if mode == "exp":
        return exp_core(v)
    if mode == "swish":
        return v * (0.5 * (1.0 + tanh_core(0.5 * v)))
    if mode == "gelu":
        # v + 0.044715 v^3 is one FMA in the reference's fused loop
        cubic = fma_f32(_c(0.044715, v).expand_as(v), v * (v * v), v)
        inner = 0.7978845608028654 * cubic
        return 0.5 * v * (1.0 + tanh_core(inner))
    if mode == "selu":
        neg = _SELU_ALPHA * (exp_core(torch.clamp_max(v, 0.0)) - 1.0)
        return _SELU_SCALE * torch.where(v > 0, v, neg)
    if mode == "relu":
        return relu(v)
    raise ValueError(f"unknown CORDIC mode {mode!r}")


def cordic_activation(x: torch.Tensor, mode: str = "tanh") -> torch.Tensor:
    """Elementwise CORDIC activation of a tensor of any shape, cast to fp32.

    A CUDA tensor goes through kernel K3b, a CPU tensor through the plain
    :func:`apply_mode`; both give the reference's bits (NaN inputs are
    defined only for ``relu``, which passes them through)."""
    if mode not in MODES:
        raise ValueError(f"unknown CORDIC mode {mode!r}")
    x = x.to(torch.float32)
    if not backend.on_card(x):
        return apply_mode(x, mode)
    flat = x.contiguous().reshape(-1)
    n = flat.numel()
    if n >= 2**31:
        raise ValueError(f"{n} values exceed one launch")
    # the output starts at the input's offset within 16 bytes, so that the
    # kernel's vector loads and stores line up for a view at any offset
    shift = flat.data_ptr() % 16 // 4
    out = torch.empty(n + shift, dtype=torch.float32, device=flat.device)[shift:]
    if n:
        lib = backend.library()
        with torch.cuda.device(x.device):
            err = lib.cordic_activation_f32(
                flat.data_ptr(), out.data_ptr(), n, MODES.index(mode),
                backend.stream_ptr(x),
            )
        backend.check(err, "cordic_activation_f32")
        backend.count_launch(cordic_activation)
    return out.reshape(x.shape)


#: kernel K3b launches since the counter was last set to 0
cordic_activation.launches = 0


#: the widest row kernel K3 takes: its first-level window sums fit one
#: block's shared memory
K3_MAX_COLS = MAX_ROW


def cordic_softmax_plain(x: torch.Tensor) -> torch.Tensor:
    """Row softmax over the last axis with CORDIC exponentials: the plain
    PyTorch twin of kernel K3, step for step (row max, ``exp_core`` of
    ``x - max``, the row sum in the reference's order, IEEE division)."""
    x = x.to(torch.float32)
    e = exp_core(x - x.amax(dim=-1, keepdim=True))
    return torch.div(e, xla_row_sum(e))


def cordic_softmax(x: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Softmax with CORDIC exponentials (max-subtracted) along ``axis``."""
    x = x.to(torch.float32)
    moved = axis not in (-1, x.ndim - 1)
    if moved:
        x = x.movedim(axis, -1)
    if backend.on_card(x):
        out = _cordic_softmax_cuda(x)
    else:
        out = cordic_softmax_plain(x)
    return out.movedim(-1, axis) if moved else out


def _cordic_softmax_cuda(x: torch.Tensor) -> torch.Tensor:
    if x.ndim == 0 or x.shape[-1] == 0:
        raise ValueError(f"cordic_softmax needs rows of at least one value, got {tuple(x.shape)}")
    x = x.contiguous()
    cols = x.shape[-1]
    if cols > K3_MAX_COLS:
        raise ValueError(f"kernel K3 takes rows of up to {K3_MAX_COLS} values, got {cols}")
    rows = x.numel() // cols
    if rows >= 2**31 // 32:
        raise ValueError(f"{rows} rows exceed one launch")
    out = torch.empty_like(x)
    if rows:
        lib = backend.library()
        with torch.cuda.device(x.device):
            err = lib.cordic_softmax_f32(
                x.data_ptr(), out.data_ptr(), rows, cols, backend.stream_ptr(x)
            )
        backend.check(err, "cordic_softmax_f32")
        backend.count_launch(cordic_softmax)
    return out


#: kernel K3 launches since the counter was last set to 0
cordic_softmax.launches = 0
