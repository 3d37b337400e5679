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
order, as ``lax.top_k`` does (``models.moe.top_k``).  Under tensor
parallelism a gradient is this rank's part of a cut leaf: its scale is the
whole leaf's (a max all-reduce over the cut's group), and the size test
reads the whole leaf's count.
"""
from __future__ import annotations

import math
from typing import Any

import torch
import torch.distributed as dist

from repro_torch.core.f32_math import fma_f32
from repro_torch.core.quantization import INV_127_F32
from repro_torch.distributed.sharding import group_of
from repro_torch.models.moe import top_k


def int8_compress(g: torch.Tensor, *, jitted: bool = False,
                  group=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-tensor symmetric int8; ``g`` is one rank's part of a tensor cut
    over ``group`` where given (the scale is then the whole tensor's)."""
    amax = torch.amax(torch.abs(g))
    if group is not None:
        dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=group)
    amax = torch.clamp_min(amax, 1e-12)
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


def _round_trip(g: torch.Tensor, jitted: bool, cut=None) -> torch.Tensor:
    if g.ndim < 1 or g.numel() * (cut.size if cut else 1) < 1024:
        return g
    q, s = int8_compress(g, jitted=jitted, group=group_of(cut))
    return int8_decompress(q, s).to(g.dtype)


def fake_compress_grads(grads: Any, *, jitted: bool = False, cuts: Any = None) -> Any:
    """Round-trip every gradient tensor through int8.  ``cuts`` mirrors
    ``grads`` with each leaf's ``sharding.Cut`` (``None``: every leaf whole)."""
    if isinstance(grads, dict):
        return {k: fake_compress_grads(v, jitted=jitted, cuts=None if cuts is None else cuts[k])
                for k, v in grads.items()}
    return _round_trip(grads, jitted, cuts)


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
