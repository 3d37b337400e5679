"""Per-row primitives with batch-independent bits: the DSP front-end's
projections and row sums, and the float layers' sums.

No TPU kernel stands behind this module: the reference computes its
front-end (``repro/data/features_jax.py``) with XLA's own ops and runs the
two projections under ``jax.lax.map`` so that their bits cannot depend on
the batch.  On the card three library paths would break that contract:
cuBLAS picks its kernel by shape, PyTorch's reductions split a row's sum
according to the whole tensor's shape, and cuFFT plans depend on the batch
count.  PyTorch's CPU matmul, too, picks its blocking by batch size.  The
port therefore fixes the order of every sum itself:

* :func:`project_rows` (``(R, K) @ (K, N)``) sums over ``k`` in ascending
  order, each product and each sum rounded on its own.  It computes the
  mel and DCT-II projections of the front-end, and every bf16/fp32 dense
  and conv layer of the datapath (``serving/accelerator.py``: a conv as the
  product of its im2col rows), so a float layer's row has the same bits at
  any batch size and on either device;
* :func:`row_sum` sums each row in the order of the reference's CPU
  compiler (``jnp.sum``): left to right up to 32 values, and beyond in
  XLA's windows of exactly 32, level after level (``kernels/xla_sum.py``,
  the rule the softmax's plain twin shares), which gives the reference's
  bits at every row length up to :data:`MAX_ROW`.

On a CUDA tensor each launches its kernel (``csrc/frontend_rows.cu``); on a
CPU tensor it runs its plain version, which is elementwise PyTorch in the
same order and therefore the same bits on either device.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import backend
from repro_torch.kernels.xla_sum import MAX_ROW, xla_row_sum


def _check_2d(x: torch.Tensor, name: str) -> None:
    if x.dtype != torch.float32 or x.ndim != 2:
        raise ValueError(f"{name}: 2-D float32 expected, got {x.dtype} {tuple(x.shape)}")


# ---------------------------------------------------------------------------
# projection
# ---------------------------------------------------------------------------


#: products the plain twin forms at once (a chunk of k), at most
_PLAIN_CHUNK_VALUES = 1 << 22


def project_rows_plain(x: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """Plain twin of :func:`project_rows`: ``acc += x[:, k] * m[k]`` for
    ascending ``k``, starting from 0.  The products of a chunk of ``k`` are
    formed in one operation (each rounded on its own, as in the loop), then
    added in order."""
    _check_2d(x, "x")
    _check_2d(m, "m")
    r, k = x.shape
    n = m.shape[1]
    acc = torch.zeros((r, n), dtype=torch.float32, device=x.device)
    step = max(1, _PLAIN_CHUNK_VALUES // max(1, r * n))
    for k0 in range(0, k, step):
        prods = x[:, k0 : k0 + step, None] * m[None, k0 : k0 + step, :]
        for j in range(prods.shape[1]):
            acc = acc + prods[:, j]
    return acc


def project_rows(x: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """``(R, K) @ (K, N)`` fp32 with a fixed summation order per output."""
    _check_2d(x, "x")
    _check_2d(m, "m")
    if x.shape[1] != m.shape[0]:
        raise ValueError(f"(R, K) x (K, N) expected, got {tuple(x.shape)} x {tuple(m.shape)}")
    if not backend.on_card(x, m):
        return project_rows_plain(x, m)
    x, m = x.contiguous(), m.contiguous()
    r, k = x.shape
    n = m.shape[1]
    out = torch.empty((r, n), dtype=torch.float32, device=x.device)
    if r and n:
        lib = backend.library()
        with torch.cuda.device(x.device):
            err = lib.project_rows_f32(
                x.data_ptr(), m.data_ptr(), out.data_ptr(), r, k, n, backend.stream_ptr(x)
            )
        backend.check(err, "project_rows_f32")
        backend.count_launch(project_rows)
    return out


#: project_rows kernel launches since the counter was last set to 0
project_rows.launches = 0


# ---------------------------------------------------------------------------
# row sums
# ---------------------------------------------------------------------------


def row_sum_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain twin of :func:`row_sum`: :func:`xla_row_sum` over each row."""
    _check_2d(x, "x")
    if x.shape[1] == 0:
        raise ValueError("row_sum needs rows of at least one value")
    return xla_row_sum(x)[:, 0]


def row_sum(x: torch.Tensor) -> torch.Tensor:
    """``(R, n)`` fp32 -> ``(R,)`` row sums in the reference's window order."""
    _check_2d(x, "x")
    if not backend.on_card(x):
        return row_sum_plain(x)
    r, n = x.shape
    if not 0 < n <= MAX_ROW:
        raise ValueError(f"row_sum takes rows of 1..{MAX_ROW} values, got {n}")
    x = x.contiguous()
    out = torch.empty((r,), dtype=torch.float32, device=x.device)
    if r:
        lib = backend.library()
        with torch.cuda.device(x.device):
            err = lib.row_sum_f32(x.data_ptr(), out.data_ptr(), r, n, backend.stream_ptr(x))
        backend.check(err, "row_sum_f32")
        backend.count_launch(row_sum)
    return out


#: row_sum kernel launches since the counter was last set to 0
row_sum.launches = 0


def row_mean(x: torch.Tensor) -> torch.Tensor:
    """Mean over the last axis of ``(..., n)``: the row sum times
    ``float32(1 / n)``, which is how the reference's compiler evaluates a
    division by the constant ``n``."""
    lead, n = x.shape[:-1], x.shape[-1]
    return (row_sum(x.reshape(-1, n)) * inv_f32(n)).reshape(lead)


def inv_f32(n: int) -> float:
    """``float32(1) / float32(n)``, correctly rounded in float32."""
    return float(np.float32(1.0) / np.float32(n))
