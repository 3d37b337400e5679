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

* :func:`project_rows` (``(R, K) @ (K, N)``) sums in an order that depends
  on ``K`` alone: ``k`` is cut into consecutive chunks of
  :data:`PROJECT_CHUNK` (the last may be short), each chunk is summed from
  0 in ascending ``k``, and the chunk partials are added left to right
  from the first; each product and each sum is rounded on its own.  For
  ``K <= PROJECT_CHUNK`` that is one ascending chain, so the front-end's
  projections (``K`` = 513 and 64) and every float conv and the canonical
  dense1 keep the bits of a single chain; only a float dense0 (``K`` =
  8,704 or 35,072) sums in chunks.  It computes the mel and DCT-II
  projections of the front-end, and every bf16/fp32 dense and conv layer
  of the datapath (``serving/accelerator.py``: a conv as the product of its
  im2col rows), so a float layer's row has the same bits at any batch size
  and on either device;
* :func:`row_sum` sums each row in the order of the reference's CPU
  compiler (``jnp.sum``): left to right up to 32 values, and beyond in
  XLA's windows of exactly 32, level after level (``kernels/xla_sum.py``,
  the rule the softmax's plain twin shares), which gives the reference's
  bits at every row length up to :data:`MAX_ROW`.

On a CUDA tensor each launches its kernel (``csrc/frontend_rows.cu``: a
tiled product whose grid splits ``k`` over the chunks, and row sums staged
through shared memory); on a CPU tensor it runs its plain version, which
is elementwise PyTorch in the same order and therefore the same bits on
either device.
"""
from __future__ import annotations

import dataclasses

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


#: ``k`` is summed in ascending order inside consecutive chunks of this
#: many values, and the chunk partials are added left to right
#: (``kProjectChunk`` in ``csrc/frontend_rows.cu``)
PROJECT_CHUNK = 1024
#: products the plain twin forms at once, at most
_PLAIN_CHUNK_VALUES = 1 << 22


def project_chunks(k: int) -> int:
    """Chunks of ``k`` that :func:`project_rows` sums on their own (one
    when ``k`` is 0)."""
    return max(1, -(-k // PROJECT_CHUNK))


def project_rows_plain(x: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """Plain twin of :func:`project_rows`: each chunk's ``acc += x[:, k] *
    m[k]`` for ascending ``k`` from 0, all chunks at once as one ``(R,
    chunks, N)`` accumulation, then the chunk partials added left to right.
    The last chunk is padded with zero products, which leave a sum from +0
    unchanged; a chunk's products are formed a slice of ``k`` at a time
    (each rounded on its own, as in the loop), then added in order."""
    _check_2d(x, "x")
    _check_2d(m, "m")
    r, k = x.shape
    n = m.shape[1]
    chunks, width = project_chunks(k), min(k, PROJECT_CHUNK)
    pad = chunks * width - k
    if pad:
        x = torch.nn.functional.pad(x, (0, pad))
        m = torch.nn.functional.pad(m, (0, 0, 0, pad))
    xc, mc = x.reshape(r, chunks, width), m.reshape(chunks, width, n)
    acc = torch.zeros((r, chunks, n), dtype=torch.float32, device=x.device)
    step = max(1, _PLAIN_CHUNK_VALUES // max(1, r * chunks * n))
    for j0 in range(0, width, step):
        prods = xc[:, :, j0 : j0 + step, None] * mc[None, :, j0 : j0 + step, :]
        for j in range(prods.shape[2]):
            acc = acc + prods[:, :, j]
    out = acc[:, 0]
    for c in range(1, chunks):
        out = out + acc[:, c]
    return out


#: streaming multiprocessors of the H100 the tiles are sized for
SMS = 132
#: ``(BR, BC, TM, TN)`` of each output tile the kernel takes, by index (the
#: switch in ``project_rows_f32``, which also fixes the ``k`` a stage
#: holds): a block owns ``BR x BC`` outputs and one chunk of ``k``, a
#: thread a ``TM x TN`` micro-tile
PROJECT_TILES = ((8, 8, 1, 1), (8, 16, 1, 1), (16, 32, 2, 2), (32, 64, 4, 4))


@dataclasses.dataclass(frozen=True)
class ProjectTiling:
    """Launch configuration of ``project_rows``: the tile's index into
    :data:`PROJECT_TILES` and the grid ``(col_tiles, row_tiles, chunks)``.
    ``chunks > 1`` needs a workspace of ``chunks * R * N`` floats and
    ``row_tiles * col_tiles`` zeroed counters."""

    tile: int
    row_tiles: int
    col_tiles: int
    chunks: int

    @property
    def blocks(self) -> int:
        return self.row_tiles * self.col_tiles * self.chunks


def tiling_with(tile: int, r: int, k: int, n: int) -> ProjectTiling:
    """The grid of tile ``tile`` over an ``(r, k) @ (k, n)`` product."""
    br, bc = PROJECT_TILES[tile][:2]
    return ProjectTiling(tile, -(-r // br), -(-n // bc), project_chunks(k))


def project_tiling(r: int, k: int, n: int) -> ProjectTiling:
    """A ``k`` split over chunks takes the 8 x 8 tile: each output's
    chunk is a chain of 1,024 dependent adds, so the time is one chain's,
    and the most warps carry the chains (a float dense0, 8 x 35,072 x 64:
    280 blocks of 8 x 8).  Otherwise the largest tile that still gives the
    card enough blocks: half the SMs for chains of more than 128 adds (the
    mel projection, 408 x 513 x 64: 8 x 16, 204 blocks), 16 blocks for
    shorter ones, which the launch and the bytes bound (conv0's im2col
    rows, 8,768 x 3 x 64: 32 x 64, 274 blocks; the DCT, 408 x 64 x 20:
    16 x 32, 26 blocks); else 8 x 16 (dense1, 8 x 64 x 2: one block).
    The 8 x 8 tile stages 256 values of k at a time, for the long chains
    it is kept for; at short ``k`` its size costs more than it saves."""
    if project_chunks(k) > 1:
        return tiling_with(0, r, k, n)
    want = SMS // 2 if k > 128 else 16
    for tile in reversed(range(1, len(PROJECT_TILES))):
        t = tiling_with(tile, r, k, n)
        if t.blocks >= want:
            return t
    return tiling_with(1, r, k, n)


#: the fp32 chunk partials and tile counters per device and stream; the
#: last block of each tile resets its counter
_scratch = backend.SplitScratch(torch.float32)


#: the kernel library whose chunk was last found equal to PROJECT_CHUNK
_chunk_checked = None


def _check_chunk(lib) -> None:
    global _chunk_checked
    if _chunk_checked is not lib:
        chunk = lib.project_rows_chunk()
        if chunk != PROJECT_CHUNK:
            raise RuntimeError(
                f"project_rows: the kernel library sums chunks of {chunk} values of k, "
                f"this module chunks of {PROJECT_CHUNK}; rebuild the library"
            )
        _chunk_checked = lib


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
        _check_chunk(lib)
        tile = project_tiling(r, k, n)
        stream = backend.stream_ptr(x)
        work = counters = None
        if tile.chunks > 1:
            work, counters = _scratch.get(x.device, stream, tile.chunks * r * n,
                                          tile.row_tiles * tile.col_tiles)
        with torch.cuda.device(x.device):
            err = lib.project_rows_f32(
                x.data_ptr(), m.data_ptr(), out.data_ptr(), r, k, n, tile.tile,
                backend.ptr(work), backend.ptr(counters), stream,
            )
        if err != 0:
            _scratch.drop(x.device, stream)
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
