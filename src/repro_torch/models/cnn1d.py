"""The 1D-F-CNN detector (SHIELD8-UAV §III-A, eq. 1) as functions on a params dict.

Counterpart of ``repro/models/cnn1d.py``.  Three blocks of
o = D_0.2( M_1x2( ReLU( C_1x3(x) ) ) ), a flatten in ``(frames, channels)``
row-major order, then two dense layers.  The canonical MFCC-20
configuration reproduces the paper's flatten size:

    M=1096 --pool/2--> 548 --pool/2--> 274 --pool/2--> 137 frames x 256 ch
    flatten = 137 * 256 = 35,072          (Table I, before pruning)
    pruned  = 136 * 64  =  8,704          (Table I, after pruning)

Parameters are a plain dict of tensors with the reference's layout: conv
weights ``(K, Cin, Cout)``, dense weights ``(in, out)``, one PACT clip α a
hidden layer; ``params_from_numpy``/``params_to_numpy`` carry them across
packages.  :func:`forward` is the emulation forward that trains the model
and scores its accuracy: every layer's weights and activations are
fake-quantised under a :class:`PrecisionPolicy`, on autograd's own
``F.conv1d`` and matmul.  It runs in the reference's fp32: callers that
run it on the card wrap it in :func:`fp32_numerics` (cuDNN's convolutions
default to TF32 on Hopper).  The deployed int8 datapath is
``repro_torch.serving.accelerator``.

Two details give the reference's gradients: max-pool sends a tie's
gradient to the first of the two values (XLA's select-and-scatter; a
``torch.amax`` would split it), and the quantisers' clips split theirs
(:mod:`repro_torch.core.quantization`).  Dropout draws from a
``torch.Generator``, so its masks are not ``jax.random``'s.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.f32_math import fma_f32
from repro_torch.core.precision_policy import Precision, PrecisionPolicy
from repro_torch.core.pruning import PruneSpec, apply_prune_conv, apply_prune_dense, plan_prune
from repro_torch.core.quantization import activation_quantize, quantize_tensor


@dataclasses.dataclass(frozen=True)
class CNNConfig:
    input_len: int = 1096
    channels: tuple[int, ...] = (64, 128, 256)
    kernel: int = 3
    hidden: int = 64
    n_classes: int = 2
    dropout: float = 0.2

    @property
    def n_frames(self) -> int:
        n = self.input_len
        for _ in self.channels:
            n //= 2
        return n

    @property
    def flatten_size(self) -> int:
        return self.n_frames * self.channels[-1]


CANONICAL = CNNConfig()  # flatten 35,072
if CANONICAL.flatten_size != 35_072:
    raise AssertionError(CANONICAL.flatten_size)


def init_params(
    cfg: CNNConfig = CANONICAL, generator: torch.Generator | None = None
) -> dict:
    """He-init conv + dense weights (float32, on ``generator``'s device, the
    CPU without one); biases zero, the per-layer PACT alpha 6.  Same shapes
    as the reference's ``init_params``; the values come from ``generator``
    and differ from ``jax.random``'s."""
    dev = generator.device if generator is not None else torch.device("cpu")

    def normal(shape, fan_in):
        w = torch.randn(shape, generator=generator, dtype=torch.float32, device=dev)
        return w * math.sqrt(2.0 / fan_in)

    def zeros(n):
        return torch.zeros(n, device=dev)

    def alpha():
        return torch.tensor(6.0, device=dev)

    params: dict = {}
    c_in = 1
    for i, c_out in enumerate(cfg.channels):
        params[f"conv{i}"] = {
            "w": normal((cfg.kernel, c_in, c_out), cfg.kernel * c_in),
            "b": zeros(c_out),
            "alpha": alpha(),
        }
        c_in = c_out
    params["dense0"] = {
        "w": normal((cfg.flatten_size, cfg.hidden), cfg.flatten_size),
        "b": zeros(cfg.hidden),
        "alpha": alpha(),
    }
    params["dense1"] = {
        "w": normal((cfg.hidden, cfg.n_classes), cfg.hidden),
        "b": zeros(cfg.n_classes),
    }
    return params


def params_from_numpy(tree: Mapping) -> dict:
    """The port's params from the reference's fp32 params as a numpy tree
    (``jax.tree.map(np.asarray, params)``): same keys, same layouts."""
    return {
        layer: {k: torch.from_numpy(np.array(v, np.float32)) for k, v in leaves.items()}
        for layer, leaves in tree.items()
    }


def params_to_numpy(params: Mapping) -> dict:
    """The reverse of :func:`params_from_numpy`: numpy arrays on the host."""
    return {
        layer: {k: v.detach().cpu().numpy() for k, v in leaves.items()}
        for layer, leaves in params.items()
    }


def params_to(params: Mapping, device) -> dict:
    """The params dict with every tensor on ``device``."""
    return {layer: {k: v.to(device) for k, v in leaves.items()}
            for layer, leaves in params.items()}


def maxpool2(x: torch.Tensor) -> torch.Tensor:
    """M_1x2: max-pool width 2, stride 2 over the length axis of (B, L, C);
    an odd last row is dropped ('VALID')."""
    b, l, c = x.shape
    return x[:, : 2 * (l // 2), :].reshape(b, l // 2, 2, c).amax(dim=2)


# ---------------------------------------------------------------------------
# The emulation forward (training and accuracy scoring)
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def fp32_numerics():
    """IEEE fp32 convolutions and matmuls on the card, with deterministic
    cuDNN algorithms (so two seeded runs give the same bits), for the
    duration of the block; the process's settings come back after it."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                        deterministic=True, allow_tf32=False):
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _conv1d(h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """h: (B, C_in, L), w: (K, C_in, C_out) -> (B, C_out, L), 'same'
    padding (the smaller half on the left, as XLA's)."""
    k = w.shape[0]
    lo = (k - 1) // 2
    return F.conv1d(F.pad(h, (lo, k - 1 - lo)), w.permute(2, 1, 0))


def _maxpool2(h: torch.Tensor) -> torch.Tensor:
    """M_1x2 over the length axis of (B, C, L), an odd last value dropped;
    a tie's gradient goes to the first value, as XLA's."""
    n = h.shape[-1] // 2 * 2
    a, b = h[..., 0:n:2], h[..., 1:n:2]
    return torch.where(a >= b, a, b)


def _dropout(h: torch.Tensor, rate: float, generator: torch.Generator) -> torch.Tensor:
    """Inverted dropout; the jitted reference scales by the float32
    reciprocal of the keep probability."""
    keep = torch.rand(h.shape, generator=generator, device=h.device) < 1.0 - rate
    scale = float(np.float32(1.0) / np.float32(1.0 - rate))
    return torch.where(keep, h * scale, torch.zeros_like(h))


def _flatten(h: torch.Tensor) -> torch.Tensor:
    """(B, C, frames) -> (B, frames * C), the reference's row-major
    ``(frames, channels)`` flatten."""
    return h.transpose(1, 2).reshape(h.shape[0], -1)


def _forward(params, x, cfg, policy, train, generator, *, keep_frames=None,
             bf16_acts=True):
    policy = policy or PrecisionPolicy()
    if train and cfg.dropout > 0 and generator is None:
        raise ValueError("dropout needs a generator")

    def act(h, prec, alpha):
        if prec.is_integer:
            return activation_quantize(h, prec, alpha)
        if bf16_acts and prec == Precision.BF16:
            return activation_quantize(h, prec)
        return h

    h = x.to(torch.float32)[:, None, :]
    for i in range(len(cfg.channels)):
        name = f"conv{i}"
        p = params[name]
        prec = policy.precision_for(f"{name}/w")
        w = quantize_tensor(p["w"], prec, axis=2)
        h = torch.relu(_conv1d(h, w) + p["b"][:, None])
        h = _maxpool2(act(h, prec, p["alpha"]))
        if train and cfg.dropout > 0:
            h = _dropout(h, cfg.dropout, generator)
    if keep_frames is not None:
        h = h[:, :, :keep_frames]  # boundary-frame trim
    h = _flatten(h)
    p = params["dense0"]
    prec = policy.precision_for("dense0/w")
    h = torch.relu(h @ quantize_tensor(p["w"], prec, axis=1) + p["b"])
    h = act(h, prec, p["alpha"])
    p = params["dense1"]
    return h @ quantize_tensor(p["w"], policy.precision_for("dense1/w"), axis=1) + p["b"]


def forward(
    params: dict,
    x: torch.Tensor,
    cfg: CNNConfig = CANONICAL,
    *,
    policy: Optional[PrecisionPolicy] = None,
    train: bool = False,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """x: (B, M) feature vectors -> (B, n_classes) logits.

    ``policy`` selects the per-layer numeric mode (fake-quant emulation of
    the shared datapath); ``train`` enables dropout (eq. 1's D_0.2), drawn
    from ``generator``."""
    return _forward(params, x, cfg, policy, train, generator)


# ---------------------------------------------------------------------------
# Structured pruning of the trained model (§III-C)
# ---------------------------------------------------------------------------


def prune_model(params: dict, cfg: CNNConfig = CANONICAL, *, keep: int = 64,
                trim_frames: int = 1):
    """Prune the final conv block's channels and boundary frame; returns
    (pruned_params, pruned_cfg, PruneSpec).  Canonical config: 35,072 -> 8,704."""
    last = len(cfg.channels) - 1
    spec = plan_prune(params[f"conv{last}"]["w"], cfg.n_frames, keep=keep,
                      trim_frames=trim_frames)
    new = {k: dict(v) for k, v in params.items()}
    w, b = apply_prune_conv(params[f"conv{last}"]["w"], params[f"conv{last}"]["b"], spec)
    new[f"conv{last}"]["w"], new[f"conv{last}"]["b"] = w, b
    new["dense0"]["w"] = apply_prune_dense(
        params["dense0"]["w"], spec, cfg.n_frames, cfg.channels[-1]
    )
    pruned_cfg = dataclasses.replace(cfg, channels=cfg.channels[:-1] + (keep,))
    return new, pruned_cfg, spec


def forward_pruned(
    params: dict,
    x: torch.Tensor,
    cfg: CNNConfig,
    spec: PruneSpec,
    *,
    policy: Optional[PrecisionPolicy] = None,
    train: bool = False,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Forward pass of a pruned model: the same graph plus the frame trim
    between the last pool and the flatten.  As in the reference, a BF16
    layer's activations are not rounded to bf16 here (:func:`forward`
    rounds them)."""
    return _forward(params, x, cfg, policy, train, generator,
                    keep_frames=len(spec.keep_frames), bf16_acts=False)


def percentile(a: torch.Tensor, pct: float) -> torch.Tensor:
    """``jnp.percentile(a, pct)`` (linear method) of all of ``a``, with its
    float32 bits.  XLA folds the position into ``pct * c`` with the
    constant ``c = float32(float32(n) - 1) * float32(1/100)``, clamps the
    neighbours' indices to the array, and contracts the lerp into
    ``fma(high, w_high, low * w_low)``.  ``torch.quantile`` refuses more
    than 2**24 values (the canonical conv0 activations on 256 calibration
    rows hold 17,956,864), so the two sorted neighbours are read by hand."""
    flat = torch.sort(a.reshape(-1).to(torch.float32)).values
    n = flat.numel()
    f32 = np.float32
    last = f32(n) - f32(1.0)
    pos = f32(pct) * f32(last * (f32(1.0) / f32(100.0)))
    low, high = np.floor(pos), np.ceil(pos)
    w_high = f32(pos - low)
    w_low = f32(1.0) - w_high

    def index(v):  # float clamp, then the gather's clamp into the array
        return min(int(min(max(v, f32(0.0)), last)), n - 1)

    return fma_f32(flat[index(high)], _scalar(w_high, flat),
                   flat[index(low)] * _scalar(w_low, flat))


def _scalar(v, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(float(v), dtype=torch.float32, device=like.device)


@torch.no_grad()
def calibrate_alphas(params: dict, x: torch.Tensor, cfg: CNNConfig = CANONICAL,
                     pct: float = 99.9) -> dict:
    """Set each layer's PACT clip α to the ``pct`` percentile of its fp32
    activations on a calibration batch: the deployment analogue of the
    paper's learned clipping parameter (eq. 7), which keeps the 8-bit modes
    within the paper's < 2.5 % accuracy budget.  ``x`` lives on the
    params' device."""
    new = {k: dict(v) for k, v in params.items()}
    with fp32_numerics():
        h = x.to(torch.float32)[:, None, :]
        for i in range(len(cfg.channels)):
            p = params[f"conv{i}"]
            h = torch.relu(_conv1d(h, p["w"].to(torch.float32)) + p["b"][:, None])
            new[f"conv{i}"]["alpha"] = percentile(h, pct)
            h = _maxpool2(h)
        p = params["dense0"]
        h = torch.relu(_flatten(h) @ p["w"].to(torch.float32) + p["b"])
        new["dense0"]["alpha"] = percentile(h, pct)
    return new


def export_quantized(params: dict, cfg: CNNConfig = CANONICAL, *, mode: str = "int8",
                     device="cuda"):
    """Export a trained checkpoint as the deployment artifact: weights
    quantised once for ``mode`` ("int8" | "fxp8") on ``device``, ready for
    ``repro_torch.serving.accelerator.accelerator_forward``: the
    train -> quantise once -> serve handoff."""
    from repro_torch.serving.quantized_params import quantize_params

    return quantize_params(params, cfg, mode=mode, device=device)


def count_params(params: Mapping) -> int:
    return sum(int(t.numel()) for leaves in params.values() for t in leaves.values())


def layer_macs(cfg: CNNConfig = CANONICAL, pruned_flatten: Optional[int] = None) -> dict[str, int]:
    """Per-layer MAC counts, which feed the cycle-accurate timing model
    (eqs. 9-10)."""
    macs = {}
    length = cfg.input_len
    c_in = 1
    for i, c_out in enumerate(cfg.channels):
        macs[f"conv{i}"] = length * cfg.kernel * c_in * c_out
        length //= 2
        c_in = c_out
    flat = pruned_flatten if pruned_flatten is not None else length * c_in
    macs["dense0"] = flat * cfg.hidden
    macs["dense1"] = cfg.hidden * cfg.n_classes
    return macs
