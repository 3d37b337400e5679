"""Fused W8A8 'same' 1-D convolution with in-kernel taps: kernel K2.

Counterpart of ``repro/kernels/conv1d_fused.py`` (``conv1d_fused_q`` and
``conv1d_fused``).  Activations are int8 ``(B, L, Cin)`` (NWC) with a
per-tensor or per-sample scale, weights int8 ``(K, Cin, Cout)`` with
per-output-channel scales, 'same' zero padding (``(K-1)//2`` rows on the
left).  Each of the K taps is a shifted read of one activation slab; the K
tap products accumulate exactly in int32, then the K1 epilogue runs:
``(acc * x_scale[b]) * w_scale[co]``, ``+ bias[co]``, ReLU, ``min(., clip)``.
No im2col tensor exists.  ``return_acc=True`` returns the int32
accumulators.

On a CUDA tensor :func:`conv1d_fused_q` launches ``csrc/conv1d_fused.cu``
(int8 tensor cores for Cin >= 4, with the tile :func:`conv_tiling` picks
and the weight packed K-major once per weight tensor by
:func:`packed_weight`); on a CPU tensor it runs
:func:`conv1d_fused_q_plain`.
"""
from __future__ import annotations

import dataclasses
import threading
import weakref

import torch
import torch.nn.functional as F

from repro_torch.core.quantization import QTensor, fxp8_quantize, int8_symmetric
from repro_torch.kernels import backend
from repro_torch.kernels.quant_matmul import epilogue

#: largest kernel width the CUDA kernel stages in shared memory
MAX_TAPS = 31
#: streaming multiprocessors of the H100 the tiles are sized for
SMS = 132
#: shared memory one block may use on the H100 (bytes)
SMEM_LIMIT = 232_448
#: K2's block tiles (output rows, output channels) in order of preference:
#: 64-row tiles re-read the weight slice from L2 half as often as 32-row
#: ones, and 32-channel tiles keep more blocks in flight
#: (the ``tile_sweep`` lines of ``chip_smoke.py``)
TILES = ((64, 64), (64, 32), (32, 64), (32, 32))
#: input channels a pipeline stage holds, and the bytes a staged row takes
STAGE_CHANNELS, STAGE_ROW_BYTES = 32, 48


@dataclasses.dataclass(frozen=True)
class ConvTiling:
    """Launch configuration of kernel K2 for one shape.  ``bm`` x ``bn`` is
    a block's tile of output rows x output channels and ``stages`` its ring
    of staged 32-channel chunks (tensor-core path, Cin >= 4); the
    Cin < 4 path takes neither (``bm = bn = stages = 0``)."""

    bm: int
    bn: int
    stages: int
    blocks: int
    smem_bytes: int


def conv_tiling(b: int, l: int, cin: int, cout: int, k: int) -> ConvTiling:
    """The first tile of :data:`TILES` that puts about two blocks on every SM
    (else the one with the most blocks); a stage for every 32-channel chunk
    of Cin (two to four, so that a layer's loads are all in flight at once)
    where the blocks fit in one wave of about two a SM, else two stages (a
    larger ring then only costs resident blocks); within shared memory."""
    if cin < 4:
        return ConvTiling(0, 0, 0, -(-b * l * -(-cout // 4) // 256), 0)
    options = [(bm, bn, b * -(-l // bm) * -(-cout // bn)) for bm, bn in TILES]
    bm, bn, blocks = next((o for o in options if o[2] >= 2 * SMS),
                          max(options, key=lambda o: o[2]))
    per_stage = (bm + k - 1 + k * bn) * STAGE_ROW_BYTES
    stages = 2 if blocks > 2 * SMS else max(2, min(4, -(-cin // STAGE_CHANNELS)))
    while stages > 2 and stages * per_stage > SMEM_LIMIT:
        stages -= 1
    return ConvTiling(bm, bn, stages, blocks, stages * per_stage)


_packed: dict[int, tuple] = {}
_packed_lock = threading.Lock()


def packed_weight(w_q: torch.Tensor) -> torch.Tensor:
    """``w_q`` (K, Cin, Cout) as (K, Cout, Cin), Cin contiguous: the layout
    the tensor cores take.  Packed once per weight tensor and kept while the
    tensor lives and is not written to (its version counter), so serving
    calls reuse it and launch nothing extra; every worker of a fleet serves
    one artifact, so a rebuilt worker finds its weights packed.  An
    inference tensor has no version counter and is packed anew on every
    call.  ``packed_weight.packs`` counts the packs made (the misses); the
    cache is locked, as fleet lanes call it from several threads."""
    if w_q.is_inference():
        with _packed_lock:
            packed_weight.packs += 1
        return w_q.permute(0, 2, 1).contiguous()
    key = id(w_q)
    with _packed_lock:
        hit = _packed.get(key)
        if hit is not None and hit[0]() is w_q and hit[1] == w_q._version:
            return hit[2]
        wp = w_q.permute(0, 2, 1).contiguous()
        _packed[key] = (weakref.ref(w_q, lambda _, k=key: _packed.pop(k, None)), w_q._version,
                        wp)
        packed_weight.packs += 1
    return wp


#: weight packs made since the counter was last set to 0
packed_weight.packs = 0


def conv_acc(x_q: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """Exact int32 'same' conv accumulators, one shifted slice per tap.

    Widened to float64, each tap's product and the sum over taps are exact
    integers (|acc| <= 2^14 K Cin < 2^53), so this is the int32 result."""
    b, l, cin = x_q.shape
    k = w_q.shape[0]
    pad_l = (k - 1) // 2
    xp = F.pad(x_q.to(torch.float64), (0, 0, pad_l, k - 1 - pad_l))
    wf = w_q.to(torch.float64)
    acc = torch.matmul(xp[:, 0:l, :], wf[0])
    for t in range(1, k):
        acc = acc + torch.matmul(xp[:, t : t + l, :], wf[t])
    return acc.to(torch.int32)


def _check_args(x_q, w_q, x_scale, w_scale, bias, act):
    if act not in (None, "relu"):
        raise ValueError(f"act must be None or 'relu', got {act!r}")
    if x_q.dtype != torch.int8 or w_q.dtype != torch.int8:
        raise TypeError(f"int8 operands expected, got {x_q.dtype} x {w_q.dtype}")
    if x_q.ndim != 3 or w_q.ndim != 3 or x_q.shape[2] != w_q.shape[1]:
        raise ValueError(
            f"(B, L, Cin) x (K, Cin, Cout) expected, got "
            f"{tuple(x_q.shape)} x {tuple(w_q.shape)}"
        )
    if w_q.shape[0] < 1 or w_q.shape[1] < 1:
        raise ValueError("the conv needs at least one tap and one input channel")
    if x_scale.numel() not in (1, x_q.shape[0]):
        raise ValueError(f"x_scale has {x_scale.numel()} values for B={x_q.shape[0]}")
    if w_scale.numel() not in (1, w_q.shape[2]):
        raise ValueError(f"w_scale has {w_scale.numel()} values for Cout={w_q.shape[2]}")
    if bias is not None and bias.numel() != w_q.shape[2]:
        raise ValueError(f"bias has {bias.numel()} values for Cout={w_q.shape[2]}")


def conv1d_fused_q_plain(
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
    """Plain PyTorch twin of kernel K2 (same arguments as :func:`conv1d_fused_q`)."""
    _check_args(x_q, w_q, x_scale, w_scale, bias, act)
    acc = conv_acc(x_q, w_q)
    if return_acc:
        return acc
    xs = x_scale.to(torch.float32).reshape(-1, 1, 1)
    ws = w_scale.to(torch.float32).reshape(1, 1, -1)
    b = None if bias is None else bias.to(torch.float32).reshape(1, 1, -1)
    return epilogue(acc, xs, ws, b, act, clip)


def conv1d_fused_q(
    x_q: torch.Tensor,  # (B, L, Cin) int8
    w_q: torch.Tensor,  # (K, Cin, Cout) int8
    x_scale: torch.Tensor,  # scalar or (B,)-broadcastable fp32
    w_scale: torch.Tensor,  # (Cout,)-broadcastable fp32
    bias: torch.Tensor | None = None,  # (Cout,) fp32
    *,
    act: str | None = None,  # None or "relu"
    clip=None,  # scalar fp32 upper clip (PACT alpha)
    return_acc: bool = False,
) -> torch.Tensor:
    """Fused W8A8 'same' 1-D convolution; fp32 out (int32 with ``return_acc``)."""
    if not backend.on_card(*(t for t in (x_q, w_q, x_scale, w_scale, bias) if t is not None)):
        return conv1d_fused_q_plain(
            x_q, w_q, x_scale, w_scale, bias, act=act, clip=clip, return_acc=return_acc
        )
    _check_args(x_q, w_q, x_scale, w_scale, bias, act)
    b, l, cin = x_q.shape
    k, _, cout = w_q.shape
    if k > MAX_TAPS:
        raise ValueError(f"kernel width {k} exceeds the CUDA kernel's {MAX_TAPS}")
    wp = packed_weight(w_q) if cin >= 4 else None
    x_q, w_q = x_q.contiguous(), w_q.contiguous()
    acc = out = xs = ws = bv = None
    if return_acc:
        acc = torch.empty((b, l, cout), dtype=torch.int32, device=x_q.device)
    else:
        out = torch.empty((b, l, cout), dtype=torch.float32, device=x_q.device)
        xs = x_scale.to(torch.float32).reshape(-1).contiguous()
        ws = w_scale.to(torch.float32).reshape(-1).contiguous()
        if bias is not None:
            bv = bias.to(torch.float32).reshape(-1).contiguous()
    if b and l and cout:
        tile = conv_tiling(b, l, cin, cout, k)
        lib = backend.library()
        with torch.cuda.device(x_q.device):
            err = lib.conv1d_fused_i8(
                x_q.data_ptr(), w_q.data_ptr(), backend.ptr(wp), backend.ptr(acc),
                backend.ptr(out), backend.ptr(xs), backend.ptr(ws), backend.ptr(bv),
                0.0 if clip is None else float(clip),
                int(clip is not None and not return_acc),
                int(act == "relu" and not return_acc),
                int(xs is not None and xs.numel() == b and b > 1),
                int(ws is not None and ws.numel() == cout and cout > 1),
                b, l, cin, cout, k, tile.bm, tile.bn, tile.stages, backend.stream_ptr(x_q),
            )
        backend.check(err, "conv1d_fused_i8")
        backend.count_launch(conv1d_fused_q)
    return acc if return_acc else out


#: kernel K2 launches since the counter was last set to 0
conv1d_fused_q.launches = 0


def conv1d_fused(
    x: torch.Tensor,  # (B, L, Cin) fp32
    w: torch.Tensor,  # (K, Cin, Cout) fp32
    bias: torch.Tensor | None = None,
    *,
    fxp: bool = False,
    act: str | None = None,
    clip=None,
) -> torch.Tensor:
    """Quantise fp32 operands (per-tensor activations, per-output-channel
    weights) and run the fused conv."""
    quant = fxp8_quantize if fxp else int8_symmetric
    xq: QTensor = quant(x, axis=None)
    wq: QTensor = quant(w, axis=2)
    return conv1d_fused_q(xq.q, wq.q, xq.scale, wq.scale, bias, act=act, clip=clip)
