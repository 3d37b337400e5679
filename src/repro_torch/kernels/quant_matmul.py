"""W8A8 matmul with an int32 accumulator and a fused epilogue: kernel K1.

Counterpart of ``repro/kernels/quant_matmul.py::quant_matmul`` (the Pallas
MAC-bank kernel).  int8 (M, K) x int8 (K, N) accumulates exactly in int32;
the epilogue then runs in the reference's fp32 order,
``(acc * x_scale[m]) * w_scale[n]``, ``+ bias[n]``, ReLU, ``min(., clip)``,
where the reference's CPU numerics fuse the scale-by-``w_scale`` and the
bias add into one FMA (:func:`epilogue`).
``return_acc=True`` returns the raw int32 accumulators.

On a CUDA tensor :func:`quant_matmul` launches ``csrc/quant_matmul.cu``
once (int8 tensor cores; K split as :func:`qmm_tiling` says, the partial
tiles added into a self-cleaning workspace whose last block runs the
epilogue); on a CPU tensor it runs :func:`quant_matmul_plain`.  Integer
addition is exact and associative, so the kernel's accumulators equal the
plain version's bit for bit whatever order the blocks finish in.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.f32_math import fma_f32, minimum, relu
from repro_torch.kernels import backend


def int_matmul(x_q: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """Exact int8 (M, K) x int8 (K, N) -> int32 (M, N).

    The integers are widened to float64: every product (|p| <= 2^14) and
    every partial sum (|s| <= 2^14 K < 2^53) is an exactly representable
    integer, so the float64 product is the exact integer product in any
    summation order, on any device (CUDA has no int32 matmul)."""
    return torch.matmul(x_q.to(torch.float64), w_q.to(torch.float64)).to(torch.int32)


def epilogue(
    acc: torch.Tensor,
    x_scale: torch.Tensor,
    w_scale: torch.Tensor,
    bias: torch.Tensor | None,
    act: str | None,
    clip,
) -> torch.Tensor:
    """The dequant epilogue on int32 accumulators in the reference's order
    (scales broadcast against ``acc``).  The reference's fused loop
    contracts the bias add into one FMA, ``fma(acc * xs, ws, bias)``; without
    a bias it is ``(acc * xs) * ws``."""
    y = acc.to(torch.float32) * x_scale
    if bias is None:
        y = y * w_scale
    else:
        y = fma_f32(y, w_scale, bias)
    if act == "relu":
        y = relu(y)
    if clip is not None:
        y = minimum(y, clip)
    return y


#: streaming multiprocessors of the H100 the splits are sized for
SMS = 132
#: depth of one chunk of K, and output columns a block takes
CHUNK_K, BLOCK_N = 256, 64


@dataclasses.dataclass(frozen=True)
class QmmTiling:
    """Launch configuration of kernel K1: ``bm`` rows of x a block takes
    (8 or 64), the grid ``(m_tiles, n_tiles, splits)`` and the chunks of K
    each split covers.  ``splits > 1`` needs a zeroed workspace of
    ``M * N`` int32 and ``m_tiles * n_tiles`` counters."""

    bm: int
    m_tiles: int
    n_tiles: int
    splits: int
    chunks_per_block: int

    @property
    def blocks(self) -> int:
        return self.m_tiles * self.n_tiles * self.splits


def qmm_tiling(m: int, k: int, n: int) -> QmmTiling:
    """Split K only as far as it takes to put about one block on each SM:
    at least :data:`SMS` blocks where K has that many chunks (dense0: 137
    splits of one chunk), none where the output tiles already fill the
    card (the im2col sign-off shapes)."""
    bm = 8 if m <= 8 else 64
    m_tiles, n_tiles = -(-m // bm), -(-n // BLOCK_N)
    chunks = max(1, -(-k // CHUNK_K))
    want = -(-SMS // (m_tiles * n_tiles))
    per_block = max(1, chunks // want)
    return QmmTiling(bm, m_tiles, n_tiles, -(-chunks // per_block), per_block)


#: K1's int32 workspace and tile counters per device and stream, both zero
#: between calls: each split call leaves them as it found them
_scratch = backend.SplitScratch(torch.int32)


def _check_args(x_q, w_q, x_scale, w_scale, bias, act):
    if act not in (None, "relu"):
        raise ValueError(f"act must be None or 'relu', got {act!r}")
    if x_q.dtype != torch.int8 or w_q.dtype != torch.int8:
        raise TypeError(f"int8 operands expected, got {x_q.dtype} x {w_q.dtype}")
    if x_q.ndim != 2 or w_q.ndim != 2 or x_q.shape[1] != w_q.shape[0]:
        raise ValueError(f"(M, K) x (K, N) expected, got {tuple(x_q.shape)} x {tuple(w_q.shape)}")
    m, n = x_q.shape[0], w_q.shape[1]
    if x_scale.numel() not in (1, m):
        raise ValueError(f"x_scale has {x_scale.numel()} values for M={m}")
    if w_scale.numel() not in (1, n):
        raise ValueError(f"w_scale has {w_scale.numel()} values for N={n}")
    if bias is not None and bias.numel() != n:
        raise ValueError(f"bias has {bias.numel()} values for N={n}")


def quant_matmul_plain(
    x_q: torch.Tensor,
    w_q: torch.Tensor,
    x_scale: torch.Tensor,
    w_scale: torch.Tensor,
    bias: torch.Tensor | None = None,
    *,
    act: str | None = None,
    clip=None,
    return_acc: bool = False,
) -> torch.Tensor:
    """Plain PyTorch twin of kernel K1 (same arguments as :func:`quant_matmul`)."""
    _check_args(x_q, w_q, x_scale, w_scale, bias, act)
    acc = int_matmul(x_q, w_q)
    if return_acc:
        return acc
    m, n = acc.shape
    xs = x_scale.to(torch.float32).reshape(-1, 1)
    ws = w_scale.to(torch.float32).reshape(1, -1)
    b = None if bias is None else bias.to(torch.float32).reshape(1, n)
    return epilogue(acc, xs, ws, b, act, clip)


def quant_matmul(
    x_q: torch.Tensor,  # (M, K) int8
    w_q: torch.Tensor,  # (K, N) int8
    x_scale: torch.Tensor,  # (M, 1) or (1, 1) fp32
    w_scale: torch.Tensor,  # (1, N) or (1, 1) fp32
    bias: torch.Tensor | None = None,  # (N,) or (1, N) fp32
    *,
    act: str | None = None,  # None or "relu"
    clip=None,  # scalar fp32 upper clip (PACT alpha)
    return_acc: bool = False,  # skip the epilogue, return int32 accumulators
) -> torch.Tensor:
    """Dequantised fp32 product of int8 operands (int32 with ``return_acc``)."""
    if not backend.on_card(*(t for t in (x_q, w_q, x_scale, w_scale, bias) if t is not None)):
        return quant_matmul_plain(
            x_q, w_q, x_scale, w_scale, bias, act=act, clip=clip, return_acc=return_acc
        )
    _check_args(x_q, w_q, x_scale, w_scale, bias, act)
    x_q, w_q = x_q.contiguous(), w_q.contiguous()
    m, k = x_q.shape
    n = w_q.shape[1]
    acc = out = xs = ws = b = None
    if return_acc:
        acc = torch.empty((m, n), dtype=torch.int32, device=x_q.device)
    else:
        out = torch.empty((m, n), dtype=torch.float32, device=x_q.device)
        xs = x_scale.to(torch.float32).reshape(-1).contiguous()
        ws = w_scale.to(torch.float32).reshape(-1).contiguous()
        if bias is not None:
            b = bias.to(torch.float32).reshape(-1).contiguous()
    if m and n:
        tile = qmm_tiling(m, k, n)
        stream = backend.stream_ptr(x_q)
        work = counters = None
        if tile.splits > 1:
            work, counters = _scratch.get(x_q.device, stream, m * n, tile.m_tiles * tile.n_tiles)
        lib = backend.library()
        with torch.cuda.device(x_q.device):
            err = lib.quant_matmul_i8(
                x_q.data_ptr(), w_q.data_ptr(), backend.ptr(acc), backend.ptr(out),
                backend.ptr(xs), backend.ptr(ws), backend.ptr(b),
                0.0 if clip is None else float(clip),
                int(clip is not None and not return_acc),
                int(act == "relu" and not return_acc),
                int(xs is not None and xs.numel() == m and m > 1),
                int(ws is not None and ws.numel() == n and n > 1),
                m, k, n, backend.ptr(work), backend.ptr(counters),
                tile.bm, tile.chunks_per_block, tile.splits, stream,
            )
        if err != 0:
            _scratch.drop(x_q.device, stream)
        backend.check(err, "quant_matmul_i8")
        backend.count_launch(quant_matmul)
    return acc if return_acc else out


#: kernel K1 launches since the counter was last set to 0
quant_matmul.launches = 0
