"""Deployed-datapath inference: the whole 1D-F-CNN through the W8A8 kernels.

Counterpart of ``repro/serving/accelerator.py``.  Every int8/fxp8 conv runs
on the fused conv (kernel K2) and every int8/fxp8 dense layer on the W8A8
matmul (kernel K1), with bias + ReLU fused into each epilogue; the
classifier head finishes with the CORDIC softmax (kernel K3).  Activations
are quantised per request, per sample by default, so each row's result is
independent of its co-batch (streaming == batched, bitwise).

The artifact's per-layer tags drive dispatch: int8/fxp8 layers take the
kernels; bf16 and fp32 layers sum through the fixed-order row product
:func:`~repro_torch.kernels.frontend.project_rows` (a dense layer is
``project_rows(h, w) + b``, a conv ``project_rows`` of its im2col rows),
bf16 layers on bf16-rounded operands widened to fp32, so that the products
are exact and only the order of the sums matters.  That order depends on
``K`` alone (ascending ``k`` within chunks of
:data:`~repro_torch.kernels.frontend.PROJECT_CHUNK`, the chunk partials
left to right) and is the same on both devices and at every batch size:
no cuBLAS, cuDNN or CPU BLAS call, each of which picks its blocking by
shape, is left on the float path, so a float layer's row is bitwise
independent of its co-batch and the card gives the CPU's bits.  It is not the reference's order (XLA's
``einsum`` and conv), so float layers agree with the reference within a
tolerance (``tests/test_torch_forward.py``).  A pruned artifact's
``keep_frames`` trims frames between the last pool and the flatten, which
keeps the reference's ``(frames, channels)`` row-major order.

With ``raw_windows=True`` the forward starts at raw ``(B, 12800)`` audio
windows: the artifact's baked front-end
(:func:`repro_torch.data.features_torch.feature_rows`) runs on the device
ahead of the first layer.  Its bits are per row, so streaming == batched
still holds; against host-extracted features it agrees within the
front-end's ``PARITY_ATOL``, not bitwise.

:func:`accelerator_forward_sharded` splits the rows over the entries of a
:class:`~repro_torch.distributed.sharding.StreamMesh`, one artifact
replica an entry, and gives the unsharded forward's bits.

:func:`deviation_report` holds the datapath against the fp32 emulation
forward of the same checkpoint (``repro_torch.models.cnn1d.forward``).

On the card, :func:`accelerator_forward` replays a baked artifact's
feature-row forward as one CUDA graph per input shape, dtype, activation
scaling and calling stream (:mod:`repro_torch.kernels.graphs`): three host
operations a block in place of ~50, with the eager forward's bits.  An fp32
checkpoint, the CPU, raw windows (the front-end's syncs) and a forward
under the program's spans stay eager.

On ``device="cuda"`` (the default) every kernel runs on the card; on
``device="cpu"`` the kernels' plain PyTorch versions run.  Without a GPU a
CUDA request raises.
"""
from __future__ import annotations

import functools
import threading
import weakref

import torch

from repro_torch.core.f32_math import relu
from repro_torch.core.quantization import QTensor, bf16_round, fxp8_quantize, int8_symmetric
from repro_torch.data.features import N_SAMPLES
from repro_torch.data.features_torch import feature_rows
from repro_torch.distributed.sharding import STREAM_AXIS
from repro_torch.kernels import backend
from repro_torch.kernels.backend import resolve_device, span
from repro_torch.kernels.conv1d_fused import conv1d_fused_q
from repro_torch.kernels.cordic_act import cordic_softmax
from repro_torch.kernels.frontend import project_rows
from repro_torch.kernels.graphs import GraphCache
from repro_torch.kernels.ops import _im2col
from repro_torch.kernels.quant_matmul import quant_matmul
from repro_torch.models.cnn1d import CNNConfig, maxpool2
from repro_torch.serving.quantized_params import (
    QuantizedParams,
    quantize_params,
    replicate_params,
)


def _quantizer(layer_mode: str):
    """The activation quantiser of a layer, with the bits it has in the
    reference's jitted forward (``amax * float32(1/127)``)."""
    quant = fxp8_quantize if layer_mode == "fxp8" else int8_symmetric
    return functools.partial(quant, jitted=True)


def _float_operands(h: torch.Tensor, w: torch.Tensor, lmode: str):
    """bf16 layers: bf16-rounded operands, widened (exactly) to fp32, so the
    products are exact and the sums fp32, like the reference's bf16-in /
    fp32-accumulate op."""
    if lmode == "bf16":
        return bf16_round(h), w.to(torch.float32)
    return h, w.to(torch.float32)


def _conv1d_float(h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """'same' 1-D conv in NWC: (B, L, Cin) x (K, Cin, Cout) -> (B, L, Cout),
    as the fixed-order product of the im2col rows (B*L, K*Cin) with the
    weight (K*Cin, Cout)."""
    bsz, l, _ = h.shape
    k, cin, cout = w.shape
    return project_rows(_im2col(h, k), w.reshape(k * cin, cout)).reshape(bsz, l, cout)


def forward_quantized(
    qp: QuantizedParams,
    x: torch.Tensor,
    per_sample_acts: bool = True,
    raw_windows: bool = False,
) -> torch.Tensor:
    """(B, M) features (or, with ``raw_windows``, (B, 12800) raw windows) on
    the artifact's device -> (B, n_classes) probabilities.

    Under a profiler (inside :func:`~repro_torch.kernels.backend.program_spans`)
    the work is marked with spans: ``repro_torch.forward`` around the call;
    ``input``, one span a layer (``conv{i}``, ``dense{i}``) with the children
    its mode has (``.quantize``, the activation quantiser; ``.kernel``, K2,
    K1 or the float path; ``.pool``), ``flatten`` (the keep-frames trim and
    the reshape) and ``softmax`` (K3) under it.  The raw front-end has none."""
    with span("forward"):
        if raw_windows:
            x = feature_rows(x, qp.feature_kind)
        act_axis = 0 if per_sample_acts else None
        bsz = x.shape[0]
        conv_modes, dense_modes = qp.layer_modes
        with span("input"):
            h = x[:, :, None].to(torch.float32)
        for i, (layer, lmode) in enumerate(zip(qp.convs, conv_modes)):
            name = f"conv{i}"
            with span(name):
                if lmode in ("int8", "fxp8"):
                    with span(name + ".quantize"):
                        hq = _quantizer(lmode)(h, axis=act_axis)  # per-request act quant
                    with span(name + ".kernel"):
                        h = conv1d_fused_q(
                            hq.q,
                            layer["w"].q,
                            hq.scale.reshape(-1, 1) if per_sample_acts else hq.scale,
                            layer["w"].scale,
                            layer["b"],
                            act="relu",  # CORDIC ReLU == max(v, 0): fused into the epilogue
                        )
                else:
                    with span(name + ".kernel"):
                        hin, w = _float_operands(h, layer["w"], lmode)
                        h = relu(_conv1d_float(hin, w) + layer["b"])
                with span(name + ".pool"):
                    h = maxpool2(h)
        with span("flatten"):
            if qp.keep_frames is not None:
                h = h[:, : qp.keep_frames, :]  # pruned artifact: boundary-frame trim
            h = h.reshape(bsz, -1)  # (frames, channels) row-major
        for i, (layer, lmode) in enumerate(zip(qp.denses, dense_modes)):
            name = f"dense{i}"
            act = "relu" if i < len(qp.denses) - 1 else None
            with span(name):
                if lmode in ("int8", "fxp8"):
                    with span(name + ".quantize"):
                        hq = _quantizer(lmode)(h, axis=act_axis)
                    with span(name + ".kernel"):
                        h = quant_matmul(
                            hq.q,
                            layer["w"].q,
                            hq.scale.reshape(bsz if per_sample_acts else 1, 1),
                            layer["w"].scale.reshape(1, -1),
                            layer["b"],
                            act=act,
                        )
                else:
                    with span(name + ".kernel"):
                        hin, w = _float_operands(h, layer["w"], lmode)
                        h = project_rows(hin, w) + layer["b"]
                        if act == "relu":
                            h = relu(h)
        with span("softmax"):
            return cordic_softmax(h)


def _check_raw_windows(qp: QuantizedParams, x: torch.Tensor, feature_kind: str | None):
    """The raw-window contract, checked before any work is queued."""
    if qp.feature_kind is None:
        raise ValueError(
            "raw_windows=True needs an artifact with a baked feature kind; "
            "re-bake with quantize_params(..., feature_kind=...) or pass "
            "feature_kind= alongside the fp32 checkpoint"
        )
    if feature_kind is not None and feature_kind != qp.feature_kind:
        raise ValueError(
            f"artifact was baked for feature kind {qp.feature_kind!r}, "
            f"got feature_kind={feature_kind!r}"
        )
    if x.ndim != 2 or x.shape[1] != N_SAMPLES:
        raise ValueError(
            f"raw_windows=True expects (B, {N_SAMPLES}) raw "
            f"0.8 s windows, got {tuple(x.shape)}"
        )


def _leaves(qp: QuantizedParams) -> list[torch.Tensor]:
    """Every tensor of the artifact's layers: what its graphs read."""
    out = []
    for layer in qp.convs + qp.denses:
        for v in layer.values():
            out.extend((v.q, v.scale) if isinstance(v, QTensor) else (v,))
    return out


_graphs: dict[int, tuple] = {}
_graphs_lock = threading.Lock()


def _graphs_of(qp: QuantizedParams) -> GraphCache:
    """The artifact's graphs, dropped with the artifact (held by a weak
    reference)."""
    key = id(qp)
    with _graphs_lock:
        hit = _graphs.get(key)
        if hit is None or hit[0]() is not qp:
            hit = _graphs[key] = (weakref.ref(qp, lambda _, k=key: _graphs.pop(k, None)),
                                  GraphCache(accelerator_forward))
        return hit[1]


def _forward_graphed(qp: QuantizedParams, x: torch.Tensor, per_sample_acts: bool):
    """The forward through the artifact's graphs: a replay copies the rows
    into the graph's input buffer and clones its output."""

    def build():
        static_x = x.to(qp.device, memory_format=torch.contiguous_format, copy=True)
        return static_x, [lambda: forward_quantized(qp, static_x, per_sample_acts)]

    def replay(static_x, graphs):
        static_x.copy_(x)
        graphs[0].replay()
        return graphs[0].out.clone()

    return _graphs_of(qp)(
        (tuple(x.shape), x.dtype, per_sample_acts), _leaves(qp),
        lambda: forward_quantized(qp, x.to(qp.device), per_sample_acts), build, replay)


def _graphed(params, qp: QuantizedParams, x: torch.Tensor, raw_windows: bool) -> bool:
    """Whether a call replays a graph: a baked artifact on the card, feature
    rows, at least one row, and no program spans being recorded."""
    return (params is qp and qp.device.type == "cuda" and not raw_windows
            and x.shape[0] > 0 and not backend.spans_recording())


def accelerator_forward(
    params: dict | QuantizedParams,
    x,
    cfg: CNNConfig,
    *,
    device="cuda",
    fxp: bool = False,
    per_sample_acts: bool = True,
    raw_windows: bool = False,
    feature_kind: str | None = None,
) -> torch.Tensor:
    """x: (B, M) features -> (B, n_classes) class probabilities on
    ``device``, computed on the kernel datapath.

    Pass a :class:`QuantizedParams` artifact on ``device`` to serve from the
    weight cache (no weight quantisation per call); a raw fp32 ``params``
    dict is baked on the fly (``fxp`` picks the mode, ``feature_kind`` the
    front-end) for one-off sign-offs.  ``per_sample_acts=False`` quantises
    activations with one per-tensor scale (the legacy A/B surface of the
    reference).  ``raw_windows=True`` takes raw (B, 12800) 0.8 s windows and
    runs the artifact's baked front-end first.

    A baked artifact's feature-row forward on the card replays a CUDA
    graph (see the module docstring), counted by
    ``accelerator_forward.graph_captures`` and ``.graph_replays``.
    """
    dev = resolve_device(device)
    if isinstance(params, QuantizedParams):
        qp = params
        if qp.device.type != dev.type:
            raise ValueError(
                f"the artifact lives on {qp.device}, the forward was asked "
                f"for {dev}; load or bake it with device={dev.type!r}"
            )
    else:
        qp = quantize_params(
            params, cfg, mode="fxp8" if fxp else "int8", feature_kind=feature_kind,
            device=dev,
        )
    x = torch.as_tensor(x)
    if raw_windows:
        _check_raw_windows(qp, x, feature_kind)
    elif x.ndim != 2:
        raise ValueError(f"(B, M) feature rows expected, got {tuple(x.shape)}")
    if _graphed(params, qp, x, raw_windows):
        return _forward_graphed(qp, x, per_sample_acts)
    return forward_quantized(qp, x.to(qp.device), per_sample_acts, raw_windows)


#: CUDA graphs captured, and calls served from a replay, since last set to 0
accelerator_forward.graph_captures = 0
accelerator_forward.graph_replays = 0


def accelerator_forward_sharded(
    params: dict | QuantizedParams | tuple[QuantizedParams, ...],
    x,
    cfg: CNNConfig,
    *,
    mesh,
    axis_name: str = STREAM_AXIS,
    fxp: bool = False,
    raw_windows: bool = False,
    feature_kind: str | None = None,
) -> torch.Tensor:
    """Sharded-batch twin of :func:`accelerator_forward`: the rows are split
    into ``k`` contiguous chunks along ``mesh``'s ``axis_name`` axis, each
    entry of the mesh runs the whole datapath on its chunk with its own
    replica of the artifact, and the results are gathered, in order, onto
    the first entry's device.

    Activations are quantised with per-sample scales and every float layer
    sums each row in one fixed order, so a row's result depends on nothing
    outside the row: the output is bitwise the unsharded forward's, for
    every artifact cell.  Per-tensor activation scales are not offered here:
    a shard-local amax would differ from the global one.  With
    ``raw_windows`` each shard runs the baked front-end on its own rows.

    ``params`` is a baked artifact (replicated here), the replicas
    :func:`~repro_torch.serving.quantized_params.replicate_params` gave for
    this mesh (what the engine passes, so that no call copies weights), or
    an fp32 checkpoint baked on the fly on the first entry's device.  On one
    card the shards run one after another on the current stream.
    ``x.shape[0]`` must divide evenly by the shard count.
    """
    n_shards = mesh.shape[axis_name]
    x = torch.as_tensor(x)
    if x.shape[0] % n_shards != 0:
        raise ValueError(
            f"batch {x.shape[0]} not divisible by {n_shards} shards on "
            f"mesh axis {axis_name!r}"
        )
    if isinstance(params, tuple):
        replicas = params
        if len(replicas) != n_shards:
            raise ValueError(f"{len(replicas)} replicas for a mesh of {n_shards} entries")
    else:
        qp = params
        if not isinstance(qp, QuantizedParams):
            qp = quantize_params(
                params, cfg, mode="fxp8" if fxp else "int8", feature_kind=feature_kind,
                device=mesh.devices[0],
            )
        replicas = replicate_params(qp, mesh)
    if raw_windows:
        _check_raw_windows(replicas[0], x, feature_kind)
    elif x.ndim != 2:
        raise ValueError(f"(B, M) feature rows expected, got {tuple(x.shape)}")
    rows = x.shape[0] // n_shards
    out = [
        forward_quantized(qp, x[i * rows : (i + 1) * rows].to(qp.device), True, raw_windows)
        for i, qp in enumerate(replicas)
    ]
    home = mesh.devices[0]
    return torch.cat([o.to(home) for o in out])


def precompile_slot_shapes(
    qp: QuantizedParams,
    cfg: CNNConfig,
    slot_counts,
    *,
    row_width: int | None = None,
    mesh=None,
    axis_name: str | None = None,
    raw_windows: bool = False,
) -> None:
    """Warm the datapath once per batch (slot) shape of the ladder: the
    first call builds and loads the kernel library, and each shape's first
    call pays its allocator and launch set-up outside a serving round.
    Zeros are the engine's silence padding, so there is no NaN hazard.
    Rows are ``N_SAMPLES`` raw samples wide with ``raw_windows``, else
    ``cfg.input_len`` features.  With a ``mesh`` every shape goes through
    the sharded forward (``qp`` may then be the mesh's replicas)."""
    baked = qp if isinstance(qp, tuple) and mesh is not None else (qp,)
    if not all(isinstance(q, QuantizedParams) for q in baked):
        raise TypeError(
            f"precompile_slot_shapes needs a baked QuantizedParams artifact, "
            f"got {type(qp).__name__}"
        )
    if row_width is None:
        row_width = N_SAMPLES if raw_windows else cfg.input_len
    for slots in sorted(set(int(s) for s in slot_counts)):
        x = torch.zeros((slots, row_width), dtype=torch.float32, device=baked[0].device)
        if mesh is not None:
            out = accelerator_forward_sharded(
                qp, x, cfg, mesh=mesh, axis_name=STREAM_AXIS if axis_name is None else axis_name,
                raw_windows=raw_windows,
            )
        else:
            out = accelerator_forward(qp, x, cfg, device=qp.device, raw_windows=raw_windows)
        out.cpu()


def deviation_report(
    params: dict, x, cfg: CNNConfig, *, per_sample_acts: bool = True, device="cuda"
) -> dict:
    """Max probability deviation and decision agreement of the kernel
    datapath (an int8 artifact baked from ``params`` on ``device``) against
    the fp32 emulation forward's softmax."""
    from repro_torch.models import cnn1d

    dev = resolve_device(device)
    x = torch.as_tensor(x).to(dev)
    with cnn1d.fp32_numerics(), torch.no_grad():
        ref = torch.softmax(cnn1d.forward(cnn1d.params_to(params, dev), x, cfg), dim=-1)
    acc = accelerator_forward(params, x, cfg, device=dev, per_sample_acts=per_sample_acts)
    return {
        "max_prob_dev": float(torch.max(torch.abs(ref - acc))),
        "decision_agreement": float(
            torch.mean((ref.argmax(-1) == acc.argmax(-1)).to(torch.float32))),
    }


__all__ = [
    "accelerator_forward",
    "accelerator_forward_sharded",
    "deviation_report",
    "forward_quantized",
    "precompile_slot_shapes",
]
