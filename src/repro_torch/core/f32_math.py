"""float32 ``exp`` and ``log`` exactly as the reference datapath evaluates them.

The reference deployment numerics (and the committed golden artifacts) are
those of the JAX package on the CPU, where XLA lowers ``exp`` and ``log``
to Cephes-style polynomials evaluated with fused multiply-adds.  Two
places of the serving path depend on those bits:

* ``fxp8_quantize`` takes ``ceil(log2(amax / 127))``, and ``jnp.log2`` is
  ``log(x) / log(2)``; its scale is ``jnp.exp2(e)`` = ``exp(ln2 * e)``, which
  is *not* an exact power of two for most ``e``.
* the CORDIC ``exp`` mode multiplies by ``jnp.exp2(k)``, the same
  ``exp(ln2 * k)``.

``torch.exp``/``torch.log`` round differently, so the port evaluates the
same polynomials here, with a correctly rounded float32 FMA emulated in
float64 (round-to-odd, then one rounding to float32).  Every step is an
IEEE operation, so the result is the same on any device.  The CUDA CORDIC
kernel (``csrc/cordic_softmax.cu``) carries the same ``exp`` with
``__fmaf_rn``.
"""
from __future__ import annotations

import math
import threading

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.utils._python_dispatch import _disable_current_modes

#: float32(ln 2), the constant ``jnp.exp2`` multiplies by and ``jnp.log2``
#: divides by (0x3F317218)
LN2_F32 = 0.6931471824645996
#: float32(1 / float32(ln 2)) (0x3FB8AA3B)
INV_LN2_F32 = 1.4426950216293335

#: the smallest normal float32; ``exp`` flushes results below it to zero
FLT_MIN = 1.1754943508222875e-38

_EXP_LO, _EXP_HI = -87.8, 88.8
_LOG2E = 1.4426950408889634
_C1, _C2 = 0.693359375, -2.12194440e-4
_EXP_P = (
    1.9875691500e-4, 1.3981999507e-3, 8.3334519073e-3,
    4.1665795894e-2, 1.6666665459e-1, 5.0000001201e-1,
)
_LOG_P = (
    7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1,
    -1.2420140846e-1, 1.4249322787e-1, -1.6668057665e-1,
    2.0000714765e-1, -2.4999993993e-1, 3.3333331174e-1,
)
_SQRTHF = 0.707106781186547524


_consts: dict[tuple, torch.Tensor] = {}
_consts_lock = threading.Lock()


def kept(key: tuple, like: torch.Tensor, make) -> torch.Tensor:
    """``make(device)``, a tensor on ``like``'s device, made once a ``key``
    and device and kept.  Made once, so a forward that uses it copies
    nothing from the host and never waits on the card after its first call
    (and can be captured into a CUDA graph).  It is made outside inference
    mode and without grad, so a training path may save it for backward,
    and it is never written to.  It is made outside every dispatch mode (the
    dry run's meters count a step, and a server makes it before its steps).
    A fake ``like`` (the dry run's ``FakeTensorMode``) gets a tensor of its
    own mode, not kept."""
    if isinstance(like, FakeTensor):
        with _disable_current_modes(), like.fake_mode:
            return make(like.device)
    key = (*key, like.device)
    t = _consts.get(key)
    if t is None:
        with _consts_lock:
            t = _consts.get(key)
            if t is None:
                with (_disable_current_modes(), torch.inference_mode(False),
                      torch.no_grad()):
                    t = make(like.device)
                _consts[key] = t
    return t


def const_f32(v: float, like: torch.Tensor) -> torch.Tensor:
    """The float32 0-d tensor ``v`` on ``like``'s device, made once a value
    and device and kept (:func:`kept`).  A tensor operand, so no kernel
    ever folds it into a reciprocal or a wider type."""
    return kept((v, math.copysign(1.0, v)), like,
                lambda dev: torch.tensor(v, dtype=torch.float32, device=dev))


def _f(v: float, like: torch.Tensor) -> torch.Tensor:
    """The float32 constant ``v`` on ``like``'s device (:func:`const_f32`)."""
    return const_f32(v, like)


def fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 ``a * b + c`` of float32 tensors.

    The float64 product of two float32 values is exact; the float64 sum is
    made round-to-odd with an exact TwoSum error term, and round-to-odd at
    53 bits followed by one round-to-nearest to 24 bits is the correctly
    rounded result.
    """
    p = a.double() * b.double()
    cd = c.double()
    s = p + cd
    bv = s - p
    av = s - bv
    err = (p - av) + (cd - bv)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, torch.inf, -torch.inf).to(torch.float64)
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
    return s.float()


def relu(x: torch.Tensor) -> torch.Tensor:
    """``jnp.maximum(x, 0.0)``: NaN propagates and ``-0.0`` becomes ``+0.0``
    (``torch.clamp_min`` keeps ``-0.0``)."""
    return torch.where((x > 0) | torch.isnan(x), x, torch.zeros_like(x))


def minimum(x: torch.Tensor, c) -> torch.Tensor:
    """``jnp.minimum(x, c)`` for a scalar ``c``: NaN propagates, ties take
    ``c``."""
    c = torch.as_tensor(c, dtype=torch.float32, device=x.device)
    return torch.where((x < c) | torch.isnan(x), x, c)


def exp_f32(x: torch.Tensor) -> torch.Tensor:
    """float32 ``exp`` with the reference's bits (range-reduced Cephes
    polynomial, FMA-contracted).  A result below ``FLT_MIN`` is flushed to
    zero: XLA's CPU code runs with subnormals flushed, so ``jnp.exp`` never
    returns one (``jnp.exp(-87.7)`` is 0.0)."""
    x = x.to(torch.float32)
    x = torch.clamp(x, _EXP_LO, _EXP_HI)
    n = torch.floor(fma_f32(x, _f(_LOG2E, x), _f(0.5, x)))
    n = torch.clamp(n, -127.0, 127.0)
    r = fma_f32(_f(-_C1, x), n, x)
    r = fma_f32(_f(-_C2, x), n, r)
    z = fma_f32(r, _f(_EXP_P[0], x), _f(_EXP_P[1], x))
    for p in _EXP_P[2:]:
        z = fma_f32(z, r, _f(p, x))
    z = fma_f32(z, r * r, r)
    z = z + 1.0
    pow2 = ((n.to(torch.int32) + 127) << 23).view(torch.float32)
    out = z * pow2
    return torch.where(out < FLT_MIN, torch.zeros_like(out), out)


def log_f32(x: torch.Tensor) -> torch.Tensor:
    """float32 natural ``log`` with the reference's bits, for positive
    finite ``x`` (the only inputs the quantisers give it)."""
    x = x.to(torch.float32)
    x = torch.maximum(x, torch.full_like(x, FLT_MIN))
    bits = x.view(torch.int32)
    e = ((bits >> 23) - 127).to(torch.float32) + 1.0
    m = ((bits & 0x007FFFFF) | 0x3F000000).view(torch.float32)
    small = m < _SQRTHF
    e = e - small.to(torch.float32)
    m = (m - 1.0) + torch.where(small, m, torch.zeros_like(m))
    x2 = m * m
    x3 = x2 * m
    p = [_f(v, m) for v in _LOG_P]
    y = fma_f32(m, p[0], p[1])
    y1 = fma_f32(m, p[3], p[4])
    y2 = fma_f32(m, p[6], p[7])
    y = fma_f32(y, m, p[2])
    y1 = fma_f32(y1, m, p[5])
    y2 = fma_f32(y2, m, p[8])
    y = fma_f32(y, x3, y1)
    y = fma_f32(y, x3, y2)
    y = fma_f32(y, x3, _f(_C2, m) * e)
    m = m - 0.5 * x2
    m = m + y
    return m + _f(_C1, m) * e


def exp2_f32(k: torch.Tensor) -> torch.Tensor:
    """``jnp.exp2`` of float32 ``k``: ``exp(float32(ln 2) * k)``, so below
    ``2**-126`` it flushes to zero like :func:`exp_f32`."""
    return exp_f32(_f(LN2_F32, k) * k.to(torch.float32))


def log2_f32(x: torch.Tensor) -> torch.Tensor:
    """``jnp.log2`` of float32 ``x``.  The reference divides ``log(x)`` by
    the constant ``log(2)``, which XLA evaluates as a multiply by the
    float32 reciprocal."""
    return log_f32(x) * _f(INV_LN2_F32, x)
