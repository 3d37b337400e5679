"""The plain reference of the deployed detector datapath.

Plain PyTorch, written from the datapath's stated semantics and nothing of
the program's: it bakes its own artifact from the float32 checkpoint
(structured prune of the last conv by its channels' L1 norms with the
boundary-frame trim, then each layer's weights in the precision the
configuration states) and scores rows through it:

* an 8-bit layer: weights quantised once, symmetric, one scale per output
  channel (``amax / 127``); activations quantised per sample, one scale a
  row (``amax * float32(1 / 127)``); the integer products summed exactly
  (in float64, where every partial sum of int8 products is an integer
  below 2**53); the epilogue ``(acc * x_scale) * w_scale + bias`` with one
  rounding for the last multiply-add, then ReLU;
* a bf16 layer: operands rounded to bfloat16, products and sums wider; an
  fp32 layer: fp32 operands; both summed in float64 and rounded once to
  float32, a conv as the product of its 'same'-padded im2col rows;
* max-pool of width 2 between convs, the flatten in ``(frames, channels)``
  order, a softmax in float64.

:func:`bake` with ``modes=control_modes(...)`` gives the control: every
layer one precision below what the configuration states (int8 -> int4,
bf16 -> int8, fp32 -> bf16), put in the program's place.  No TF32 is
involved: every product here is float64.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from perfbench import spec

#: the largest magnitude of each integer precision
QMAX = {"int8": 127, "int4": 7}
#: the precision one step below each stated one (the control)
BELOW = {"fp32": "bf16", "bf16": "int8", "int8": "int4"}
#: rows scored in one pass (bounds the float64 im2col tensors)
ROWS_PER_PASS = 256


def _c(v: float, like: torch.Tensor) -> torch.Tensor:
    """A float32 constant as a tensor on ``like``'s device (so no kernel
    turns a division by it into a multiplication by its reciprocal)."""
    return torch.tensor(v, dtype=torch.float32, device=like.device)


def control_modes(conf: dict) -> dict[str, str]:
    return {name: BELOW[mode] for name, mode in spec.layer_modes(conf).items()}


def _quantize(x: torch.Tensor, keep: tuple[int, ...], qmax: int, *, act: bool):
    """Symmetric integer quantisation with one scale along the ``keep`` axes;
    returns (integers as float64, float32 scale)."""
    red = tuple(d for d in range(x.ndim) if d not in keep)
    amax = torch.clamp_min(x.abs().amax(dim=red, keepdim=True), 1e-12)
    if act:
        scale = amax * _c(float(np.float32(1.0) / np.float32(qmax)), x)
    else:
        scale = torch.div(amax, _c(float(qmax), x))
    q = torch.clamp(torch.round(torch.div(x, scale)), -qmax - 1, qmax)
    return q.to(torch.float64), scale


def _im2col(h: torch.Tensor, k: int) -> torch.Tensor:
    """(N, L, C) -> (N*L, k*C) 'same'-padded patches, (k-1)//2 rows on the left."""
    n, l, c = h.shape
    pad = (k - 1) // 2
    hp = torch.nn.functional.pad(h, (0, 0, pad, k - 1 - pad))
    return torch.stack([hp[:, t : t + l, :] for t in range(k)], dim=2).reshape(n * l, k * c)


@dataclasses.dataclass
class RefLayer:
    mode: str
    w: torch.Tensor  # float64: integers for int8/int4, the rounded values otherwise
    scale: torch.Tensor | None  # float32 per output channel (integer modes)
    b: torch.Tensor  # float32


@dataclasses.dataclass
class RefArtifact:
    kernel: int
    convs: list[RefLayer]
    denses: list[RefLayer]
    keep_frames: int | None


def _prep(w: torch.Tensor, b: torch.Tensor, mode: str, out_axis: int) -> RefLayer:
    w = w.to(torch.float32)
    if mode in QMAX:
        q, scale = _quantize(w, (out_axis,), QMAX[mode], act=False)
        return RefLayer(mode, q, scale.reshape(-1), b.to(torch.float32))
    if mode == "bf16":
        return RefLayer(mode, w.to(torch.bfloat16).to(torch.float64), None, b.to(torch.float32))
    if mode == "fp32":
        return RefLayer(mode, w.to(torch.float64), None, b.to(torch.float32))
    raise ValueError(f"the reference has no {mode!r} layers")


def bake(params: dict, conf: dict, modes: dict[str, str] | None = None) -> RefArtifact:
    """The reference's artifact of ``params`` (the float32 checkpoint) under
    ``conf``'s prune and precisions (``modes`` overrides the precisions)."""
    modes = spec.layer_modes(conf) if modes is None else modes
    cnn = conf["cnn"]
    n_convs = len(cnn["channels"])
    w = {name: params[name]["w"].to(torch.float32) for name in spec.layer_names(conf)}
    b = {name: params[name]["b"].to(torch.float32) for name in spec.layer_names(conf)}
    keep_frames = None
    prune = conf.get("prune")
    if prune:
        last = f"conv{n_convs - 1}"
        n_frames = cnn["input_len"] >> n_convs
        n_ch = cnn["channels"][-1]
        importance = w[last].to(torch.float64).abs().sum(dim=(0, 1))
        keep = torch.sort(torch.argsort(importance, descending=True)[: prune["keep"]]).values
        w[last], b[last] = w[last][:, :, keep], b[last][keep]
        keep_frames = n_frames - prune["trim_frames"]
        d0 = w["dense0"].reshape(n_frames, n_ch, -1)[:keep_frames][:, keep]
        w["dense0"] = d0.reshape(keep_frames * prune["keep"], -1)
    return RefArtifact(
        kernel=cnn["kernel"],
        convs=[_prep(w[f"conv{i}"], b[f"conv{i}"], modes[f"conv{i}"], 2) for i in range(n_convs)],
        denses=[_prep(w[n], b[n], modes[n], 1) for n in ("dense0", "dense1")],
        keep_frames=keep_frames,
    )


def _epilogue(acc: torch.Tensor, xs: torch.Tensor, ws: torch.Tensor, b: torch.Tensor):
    """``(acc * xs) * ws + b``: the first product in float32, the
    multiply-add rounded once."""
    y = acc.to(torch.float32) * xs
    return (y.to(torch.float64) * ws.to(torch.float64) + b.to(torch.float64)).to(torch.float32)


def _float_operand(h: torch.Tensor, mode: str) -> torch.Tensor:
    return (h.to(torch.bfloat16) if mode == "bf16" else h).to(torch.float64)


def _conv(layer: RefLayer, h: torch.Tensor, k: int) -> torch.Tensor:
    n, l, _ = h.shape
    wmat = layer.w.reshape(-1, layer.w.shape[2])
    if layer.mode in QMAX:
        hq, xs = _quantize(h, (0,), QMAX[layer.mode], act=True)
        acc = (_im2col(hq, k) @ wmat).reshape(n, l, -1)
        y = _epilogue(acc, xs.reshape(n, 1, 1), layer.scale, layer.b)
    else:
        y = (_im2col(_float_operand(h, layer.mode), k) @ wmat).to(torch.float32)
        y = y.reshape(n, l, -1) + layer.b
    return torch.clamp_min(y, 0.0)


def _dense(layer: RefLayer, h: torch.Tensor, relu: bool) -> torch.Tensor:
    if layer.mode in QMAX:
        hq, xs = _quantize(h, (0,), QMAX[layer.mode], act=True)
        y = _epilogue(hq @ layer.w, xs, layer.scale, layer.b)
    else:
        y = (_float_operand(h, layer.mode) @ layer.w).to(torch.float32) + layer.b
    return torch.clamp_min(y, 0.0) if relu else y


def _pool(h: torch.Tensor) -> torch.Tensor:
    n, l, c = h.shape
    return h[:, : 2 * (l // 2)].reshape(n, l // 2, 2, c).amax(dim=2)


def _forward_pass(art: RefArtifact, x: torch.Tensor) -> torch.Tensor:
    h = x.to(torch.float32)[:, :, None]
    for layer in art.convs:
        h = _pool(_conv(layer, h, art.kernel))
    if art.keep_frames is not None:
        h = h[:, : art.keep_frames]
    h = h.reshape(h.shape[0], -1)
    for i, layer in enumerate(art.denses):
        h = _dense(layer, h, relu=i < len(art.denses) - 1)
    return torch.softmax(h.to(torch.float64), dim=-1)


def forward(art: RefArtifact, rows: torch.Tensor) -> torch.Tensor:
    """(N, input_len) float32 feature rows on the artifact's device ->
    (N, n_classes) float64 probabilities, :data:`ROWS_PER_PASS` rows at a time."""
    with torch.no_grad():
        return torch.cat([_forward_pass(art, rows[i : i + ROWS_PER_PASS])
                          for i in range(0, rows.shape[0], ROWS_PER_PASS)])
