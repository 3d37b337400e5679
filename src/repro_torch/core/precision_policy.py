"""Per-layer precision policy: the software face of the multi-precision datapath.

Counterpart of ``PrecisionPolicy`` in ``repro/core/precision_policy.py``: a
mapping from parameter paths (glob patterns) to ``Precision`` modes with a
default, serialisable to JSON so it rides along in configs and artifacts;
``from_sensitivity`` builds one from layer-sensitivity scores, and
``fake_quant_params`` applies one to a params tree on the emulation path.
``policy_einsum`` is the precision-dispatched einsum of the LM scale: with
``use_kernel=True`` its 8-bit modes run the W8A8 matmul, kernel K1 on a
CUDA tensor.
"""
from __future__ import annotations

import dataclasses
import fnmatch
import json
import os
from typing import Mapping

import torch

from repro_torch.core.quantization import (
    Precision,
    QTensor,
    activation_quantize,
    bf16_round,
    fxp8_quantize,
    int8_symmetric,
    quantize_tensor,
)


@dataclasses.dataclass
class PrecisionPolicy:
    """Glob-pattern -> Precision mapping with a default mode."""

    rules: dict[str, Precision] = dataclasses.field(default_factory=dict)
    default: Precision = Precision.FP32

    def precision_for(self, path: str) -> Precision:
        # Most-specific matching pattern wins: longest first, then fewest
        # wildcards (an exact path beats an equal-length glob), then the
        # lexicographically smallest pattern.  Resolution is a function of
        # the rule set, never of dict insertion order.
        best = None
        best_key: tuple | None = None
        for pat in sorted(self.rules):
            if fnmatch.fnmatch(path, pat):
                key = (len(pat), -sum(pat.count(c) for c in "*?["))
                if best_key is None or key > best_key:
                    best, best_key = self.rules[pat], key
        return best if best is not None else self.default

    @staticmethod
    def uniform(precision: Precision) -> "PrecisionPolicy":
        return PrecisionPolicy(rules={}, default=precision)

    def to_dict(self) -> dict:
        return {
            "default": self.default.value,
            "rules": {k: v.value for k, v in self.rules.items()},
        }

    @staticmethod
    def from_dict(d: Mapping) -> "PrecisionPolicy":
        return PrecisionPolicy(
            rules={k: Precision(v) for k, v in d["rules"].items()},
            default=Precision(d["default"]),
        )

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), sort_keys=True)

    @staticmethod
    def from_json(s: str) -> "PrecisionPolicy":
        return PrecisionPolicy.from_dict(json.loads(s))

    @staticmethod
    def parse(spec: str, *, default: "Precision | str | None" = None) -> "PrecisionPolicy":
        """Build a policy from a CLI-ish spec: a path to a ``to_json`` file,
        an inline JSON string, or comma-separated ``pattern=mode`` rules
        (``"conv0/w=bf16,dense1/w=fp32"``).  ``default`` sets the default
        mode of the rule-list form (the JSON forms carry their own)."""
        default = Precision(default) if default is not None else Precision.FP32
        spec = spec.strip()
        if os.path.exists(spec):
            with open(spec) as f:
                return PrecisionPolicy.from_json(f.read())
        if spec.startswith("{"):
            return PrecisionPolicy.from_json(spec)
        rules = {}
        for item in spec.split(","):
            if not item.strip():
                continue
            pat, sep, mode = item.partition("=")
            if not sep:
                raise ValueError(f"policy rule {item!r} is not 'pattern=mode'")
            rules[pat.strip()] = Precision(mode.strip())
        return PrecisionPolicy(rules=rules, default=default)

    @staticmethod
    def from_sensitivity(scores: Mapping[str, float], **kw) -> "PrecisionPolicy":
        from repro_torch.core.sensitivity import assign_precisions

        return PrecisionPolicy(rules=dict(assign_precisions(scores, **kw)))


def fake_quant_params(params, policy: PrecisionPolicy, prefix: str = ""):
    """Emulation path: fake-quantise every weight tensor per the policy.

    Biases and other tensors of fewer than two dimensions ride at fp32
    (they live in the extended-precision accumulator in hardware).
    """

    def walk(tree, path):
        if isinstance(tree, Mapping):
            return type(tree)({k: walk(v, f"{path}/{k}" if path else k) for k, v in tree.items()})
        if torch.as_tensor(tree).ndim < 2:
            return tree
        return quantize_tensor(tree, policy.precision_for(path))

    return walk(params, prefix)


def policy_einsum(
    spec: str,
    x: torch.Tensor,
    w: torch.Tensor,
    precision: Precision,
    *,
    use_kernel: bool = False,
    act_alpha: float = 6.0,
) -> torch.Tensor:
    """A precision-dispatched einsum: the shared datapath's MAC bank.

    FP32 is a plain fp32 einsum (no TF32 on the card while
    ``torch.backends.cuda.matmul.allow_tf32`` stays off), BF16 a bf16
    einsum of bf16-rounded operands, widened back.  The 8-bit modes quantise
    the weight per output channel; with ``use_kernel=True`` and a 2-D spec
    they also quantise x per tensor and run the W8A8 matmul
    (:func:`repro_torch.kernels.quant_matmul.quant_matmul`: kernel K1 on a
    CUDA tensor, its plain twin on a CPU tensor), otherwise the fake-quant
    emulation (PACT activations times the dequantised weight).  The
    quantisers run eagerly, as the reference calls them: scales divide by
    127.
    """
    if precision == Precision.FP32:
        return torch.einsum(spec, x, w)
    if precision == Precision.BF16:
        return torch.einsum(
            spec, bf16_round(x).to(torch.bfloat16), w.to(torch.bfloat16)
        ).to(torch.float32)
    quant = int8_symmetric if precision == Precision.INT8 else fxp8_quantize
    wq: QTensor = quant(w, axis=w.ndim - 1)
    if use_kernel and spec in ("mk,kn->mn", "bk,kn->bn"):
        from repro_torch.kernels.quant_matmul import quant_matmul

        xq = quant(x, axis=None)
        return quant_matmul(xq.q, wq.q, xq.scale, wq.scale.reshape(1, -1))
    xf = activation_quantize(x, precision, act_alpha)
    return torch.einsum(spec, xf, wq.dequantize())


__all__ = ["Precision", "PrecisionPolicy", "fake_quant_params", "policy_einsum"]
