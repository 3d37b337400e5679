"""Gradient compression for the cross-pod (DCN) axis.

Counterpart of ``repro/training/compression.py``:

* ``int8_compress / int8_decompress`` — per-tensor symmetric int8 with an
  fp32 scale and **error feedback** (``compress_with_feedback`` carries the
  quantisation residual into the next step);
* ``fake_compress_grads`` — every gradient of at least one dimension and
  1,024 values round-tripped through int8 (the emulation inside the train
  step, so the all-reduce payload is int8-representable);
* ``topk_compress`` — magnitude top-k sparsification.

``jitted=True`` gives the bits of the reference inside ``jax.jit``, where
XLA turns ``amax / 127.0`` into ``amax * float32(1/127)``; the eager
reference divides; jitted, it also contracts the feedback's ``corrected -
q * scale`` into an FMA.  The train step is jitted in the reference, so
its compression is the jitted one.  The top-k takes ties in ascending index
order, as ``lax.top_k`` does (``models.moe.top_k``).
"""
from __future__ import annotations

import math
from typing import Any

import torch

from repro_torch.core.f32_math import fma_f32
from repro_torch.core.quantization import INV_127_F32
from repro_torch.models.layers import tree_map
from repro_torch.models.moe import top_k


def int8_compress(g: torch.Tensor, *, jitted: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    amax = torch.clamp_min(torch.amax(torch.abs(g)), 1e-12)
    if jitted:
        scale = amax * torch.tensor(INV_127_F32, dtype=torch.float32,
                                    device=amax.device).to(amax.dtype)
    else:
        scale = amax / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def int8_decompress(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def compress_with_feedback(g: torch.Tensor, error: torch.Tensor, *, jitted: bool = False):
    """Error-feedback int8: returns (q, scale, new_error).  Jitted, XLA
    contracts ``corrected - q * scale`` into one fused multiply-add."""
    corrected = g + error
    q, scale = int8_compress(corrected, jitted=jitted)
    if jitted:
        new_error = fma_f32(-q.to(torch.float32), scale.expand_as(corrected), corrected)
    else:
        new_error = corrected - int8_decompress(q, scale)
    return q, scale, new_error


def _round_trip(g: torch.Tensor, jitted: bool) -> torch.Tensor:
    if g.ndim < 1 or g.numel() < 1024:
        return g
    q, s = int8_compress(g, jitted=jitted)
    return int8_decompress(q, s).to(g.dtype)


def fake_compress_grads(grads: Any, *, jitted: bool = False) -> Any:
    """Round-trip every gradient tensor through int8."""
    return tree_map(lambda g: _round_trip(g, jitted), grads)


def topk_compress(g: torch.Tensor, k_frac: float = 0.01):
    """Magnitude top-k sparsification: returns (values, indices, shape)."""
    flat = g.reshape(-1)
    k = max(1, int(flat.numel() * k_frac))
    _, idx = top_k(torch.abs(flat), k)
    return flat[idx], idx, tuple(g.shape)


def topk_decompress(vals: torch.Tensor, idx: torch.Tensor, shape) -> torch.Tensor:
    out = torch.zeros(math.prod(shape), dtype=vals.dtype, device=vals.device)
    out[idx] = vals
    return out.reshape(shape)
