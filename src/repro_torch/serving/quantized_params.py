"""Pre-quantised parameter artifact for the deployed datapath.

Counterpart of ``repro/serving/quantized_params.py``.  The serving
lifecycle is: train in fp32 -> bake the deployment decisions **once** ->
serve every request against the frozen artifact.  Baked decisions:

* **precision**: each layer's weight in its serving form, an int8/fxp8
  payload + scale (``QTensor``), a bf16 tensor, or fp32, resolved per layer
  by an optional ``PrecisionPolicy`` (default: the artifact's ``mode``);
* **pruning**: a ``PruneSpec`` removes the pruned conv-out channels and
  dense rows *before* quantisation, and the boundary-frame trim survives as
  ``keep_frames``;
* **layout**: conv weights per output channel on axis 2, dense on axis 1,
  biases fp32 for the epilogue.

``save_artifact``/``load_artifact`` round-trip an artifact through the same
``.npz`` the reference writes, byte for byte, so the two packages exchange
models.  ``quantize_calls`` counts weight tensors quantised here: serving
must leave it flat.

An artifact lives on one device (``device=``, CUDA by default).  Baking is
device-independent: every quantiser step is an IEEE operation, so the
payloads and scales are the same bits wherever they are computed.
"""
from __future__ import annotations

import dataclasses
import json

import numpy as np
import torch

from repro_torch.core.precision_policy import PrecisionPolicy
from repro_torch.core.pruning import PruneSpec, apply_prune_conv, apply_prune_dense
from repro_torch.core.quantization import QTensor, fxp8_quantize, int8_symmetric
from repro_torch.data.features import FEATURE_DIMS
from repro_torch.kernels.backend import resolve_device
from repro_torch.models.cnn1d import CNNConfig

MODES = ("int8", "fxp8")
#: every numeric form a single layer may be stored in
LAYER_MODES = ("fp32", "bf16", "int8", "fxp8")

# Incremented once per weight tensor quantised; tests assert this stays flat
# across serving calls.
quantize_calls: int = 0


@dataclasses.dataclass(frozen=True)
class QuantizedParams:
    """The frozen serving artifact for ``accelerator_forward``.

    ``mode`` is the default precision; ``conv_modes``/``dense_modes`` carry
    the per-layer tags the accelerator dispatches on (``None`` = uniform
    ``mode``).  ``keep_frames`` is the pruned artifact's frame count before
    the flatten (``None`` = unpruned).
    """

    mode: str  # default mode: "int8" | "fxp8"
    convs: tuple[dict, ...]  # each {"w": QTensor | Tensor, "b": fp32 Tensor}
    denses: tuple[dict, ...]
    conv_modes: tuple[str, ...] | None = None
    dense_modes: tuple[str, ...] | None = None
    keep_frames: int | None = None
    #: the DSP front-end baked in for raw-window serving (``None``: the
    #: artifact takes feature rows only)
    feature_kind: str | None = None

    @property
    def fxp(self) -> bool:
        return self.mode == "fxp8"

    @property
    def layer_modes(self) -> tuple[tuple[str, ...], tuple[str, ...]]:
        """Resolved (conv_modes, dense_modes) with the uniform default applied."""
        return (
            self.conv_modes or (self.mode,) * len(self.convs),
            self.dense_modes or (self.mode,) * len(self.denses),
        )

    @property
    def mixed(self) -> bool:
        conv_m, dense_m = self.layer_modes
        return any(m != self.mode for m in conv_m + dense_m)

    @property
    def pruned(self) -> bool:
        return self.keep_frames is not None

    @property
    def device(self) -> torch.device:
        return self.convs[0]["b"].device

    def to(self, device) -> "QuantizedParams":
        """The same artifact with every tensor on ``device``."""
        dev = resolve_device(device)

        def move(layer):
            w = layer["w"]
            return {"w": w.to(dev), "b": layer["b"].to(dev)}

        return dataclasses.replace(
            self,
            convs=tuple(move(l) for l in self.convs),
            denses=tuple(move(l) for l in self.denses),
        )


def _quantize_weight(w: torch.Tensor, mode: str, axis: int) -> QTensor:
    global quantize_calls
    quantize_calls += 1
    quant = fxp8_quantize if mode == "fxp8" else int8_symmetric
    return quant(w.to(torch.float32), axis=axis)


def _prep_weight(w: torch.Tensor, layer_mode: str, axis: int):
    """One layer's weight in its serving numeric form."""
    if layer_mode in ("int8", "fxp8"):
        return _quantize_weight(w, layer_mode, axis)
    if layer_mode == "bf16":
        return w.to(torch.bfloat16)
    return w.to(torch.float32)


def quantize_params(
    params: dict,
    cfg: CNNConfig,
    *,
    mode: str = "int8",
    prune: PruneSpec | None = None,
    policy: PrecisionPolicy | None = None,
    feature_kind: str | None = None,
    device="cuda",
) -> QuantizedParams:
    """Bake an fp32 checkpoint (a dict of tensors) into one serving
    artifact on ``device``.

    ``mode`` is the default precision of every layer; ``policy`` overrides
    it per layer (resolved against ``conv{i}/w`` / ``dense{i}/w``).
    ``prune`` physically removes the planned conv-out channels and dense
    rows *before* quantisation, and the artifact remembers the frame trim in
    ``keep_frames``.
    """
    dev = resolve_device(device)
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    if feature_kind is not None:
        if feature_kind not in FEATURE_DIMS:
            raise ValueError(f"unknown feature kind {feature_kind!r}")
        if FEATURE_DIMS[feature_kind] != cfg.input_len:
            raise ValueError(
                f"feature kind {feature_kind!r} yields "
                f"{FEATURE_DIMS[feature_kind]}-dim vectors but the model "
                f"takes input_len {cfg.input_len}"
            )
    n_convs = len(cfg.channels)
    names = [f"conv{i}" for i in range(n_convs)] + ["dense0", "dense1"]
    if policy is None:
        modes = {name: mode for name in names}
    else:
        modes = {name: policy.precision_for(f"{name}/w").value for name in names}
    bad = {n: m for n, m in modes.items() if m not in LAYER_MODES}
    if bad:
        raise ValueError(f"unsupported layer modes {bad}")

    weights = {name: params[name]["w"] for name in names}
    biases = {name: params[name]["b"] for name in names}
    keep_frames = None
    if prune is not None:
        if prune.flatten_before != cfg.flatten_size:
            raise ValueError(
                f"PruneSpec planned for flatten {prune.flatten_before}, "
                f"model flattens {cfg.flatten_size}"
            )
        # The trim is served as a prefix slice, so only boundary trims (a
        # contiguous prefix of frames, what plan_prune produces) are legal.
        if not np.array_equal(
            np.asarray(prune.keep_frames), np.arange(len(prune.keep_frames))
        ):
            raise ValueError(
                "PruneSpec.keep_frames must be a contiguous prefix "
                "(boundary-frame trim); arbitrary frame subsets are not "
                "servable"
            )
        last = f"conv{n_convs - 1}"
        weights[last], biases[last] = apply_prune_conv(weights[last], biases[last], prune)
        weights["dense0"] = apply_prune_dense(
            weights["dense0"], prune, cfg.n_frames, cfg.channels[-1]
        )
        keep_frames = len(prune.keep_frames)

    def layer(name, axis):
        w = _prep_weight(weights[name], modes[name], axis)
        return {"w": w.to(dev), "b": biases[name].to(torch.float32).to(dev)}

    return QuantizedParams(
        mode=mode,
        convs=tuple(layer(f"conv{i}", 2) for i in range(n_convs)),
        denses=tuple(layer(name, 1) for name in ("dense0", "dense1")),
        conv_modes=tuple(modes[f"conv{i}"] for i in range(n_convs)),
        dense_modes=(modes["dense0"], modes["dense1"]),
        keep_frames=keep_frames,
        feature_kind=feature_kind,
    )


def replicate_params(qp: QuantizedParams, mesh) -> tuple[QuantizedParams, ...]:
    """One artifact per entry of ``mesh`` (a
    :class:`~repro_torch.distributed.sharding.StreamMesh`), in mesh order.

    Sharded-batch dispatch keeps the weights on every device and splits
    only the activation rows.  An entry on the artifact's own device gets
    the artifact itself, so nothing is copied and K2's packed weights
    (cached by tensor identity) are shared; an entry on another device gets
    one ``.to(device)`` copy, shared by every entry on that device.
    Placing the artifact once, at engine construction, keeps weight copies
    out of every call."""
    copies = {qp.device: qp}
    for dev in mesh.devices:
        if dev not in copies:
            copies[dev] = qp.to(dev)
    return tuple(copies[dev] for dev in mesh.devices)


# ---------------------------------------------------------------------------
# Artifact (de)serialisation: the reference's .npz format
# ---------------------------------------------------------------------------

_ARTIFACT_VERSION = 1


def save_artifact(path, qp: QuantizedParams) -> None:
    """Write one artifact to ``path`` as an ``.npz`` (arrays + JSON meta),
    in the reference's array order and meta encoding.  bf16 weights are
    stored widened to fp32 (lossless) and re-narrowed on load."""
    conv_modes, dense_modes = qp.layer_modes
    arrays: dict[str, np.ndarray] = {}
    meta: dict = {
        "version": _ARTIFACT_VERSION,
        "mode": qp.mode,
        "conv_modes": list(conv_modes),
        "dense_modes": list(dense_modes),
        "keep_frames": qp.keep_frames,
        "feature_kind": qp.feature_kind,
        "scale_axes": {},
    }
    for kind, layers, modes in (
        ("conv", qp.convs, conv_modes),
        ("dense", qp.denses, dense_modes),
    ):
        for i, (layer, lmode) in enumerate(zip(layers, modes)):
            pre = f"{kind}{i}"
            w = layer["w"]
            if lmode in ("int8", "fxp8"):
                if not isinstance(w, QTensor):
                    raise TypeError(f"{pre}: {lmode} layer holds {type(w).__name__}")
                arrays[f"{pre}.w_q"] = w.q.cpu().numpy()
                arrays[f"{pre}.w_scale"] = w.scale.to(torch.float32).cpu().numpy()
                meta["scale_axes"][pre] = w.axis
            else:
                arrays[f"{pre}.w"] = w.to(torch.float32).cpu().numpy()
            arrays[f"{pre}.b"] = layer["b"].to(torch.float32).cpu().numpy()
    arrays["meta"] = np.frombuffer(json.dumps(meta, sort_keys=True).encode(), np.uint8)
    with open(path, "wb") as f:
        np.savez(f, **arrays)


def load_artifact(path, *, device="cuda") -> QuantizedParams:
    """Load a :func:`save_artifact` file (from either package) onto ``device``."""
    dev = resolve_device(device)
    with np.load(path) as z:
        meta = json.loads(bytes(z["meta"]).decode())
        if meta["version"] != _ARTIFACT_VERSION:
            raise ValueError(f"artifact version {meta['version']} != {_ARTIFACT_VERSION}")

        def t(key):
            return torch.from_numpy(np.array(z[key])).to(dev)

        def layer(pre: str, lmode: str) -> dict:
            if lmode in ("int8", "fxp8"):
                w = QTensor(q=t(f"{pre}.w_q"), scale=t(f"{pre}.w_scale"),
                            axis=meta["scale_axes"][pre])
            elif lmode == "bf16":
                w = t(f"{pre}.w").to(torch.bfloat16)
            else:
                w = t(f"{pre}.w")
            return {"w": w, "b": t(f"{pre}.b")}

        return QuantizedParams(
            mode=meta["mode"],
            convs=tuple(layer(f"conv{i}", m) for i, m in enumerate(meta["conv_modes"])),
            denses=tuple(layer(f"dense{i}", m) for i, m in enumerate(meta["dense_modes"])),
            conv_modes=tuple(meta["conv_modes"]),
            dense_modes=tuple(meta["dense_modes"]),
            keep_frames=meta["keep_frames"],
            feature_kind=meta.get("feature_kind"),
        )


class QuantizedParamsCache:
    """Per-deployment-cell memo over one fp32 checkpoint: ``get`` bakes a
    cell (mode, prune, policy, feature kind) on first use and returns the
    same artifact forever after."""

    def __init__(self, params: dict, cfg: CNNConfig, *, device="cuda"):
        self._params = params
        self._cfg = cfg
        self._device = resolve_device(device)
        self._by_cell: dict[tuple, QuantizedParams] = {}

    def get(
        self,
        mode: str = "int8",
        *,
        prune: PruneSpec | None = None,
        policy: PrecisionPolicy | None = None,
        feature_kind: str | None = None,
    ) -> QuantizedParams:
        cell = (
            mode,
            prune.cache_key if prune is not None else None,
            policy.to_json() if policy is not None else None,
            feature_kind,
        )
        if cell not in self._by_cell:
            self._by_cell[cell] = quantize_params(
                self._params, self._cfg, mode=mode, prune=prune,
                policy=policy, feature_kind=feature_kind, device=self._device,
            )
        return self._by_cell[cell]
