"""Layer-sensitivity-driven precision assignment (SHIELD8-UAV §III-B, eqs. 2-3).

Counterpart of ``repro/core/sensitivity.py``.  For each layer ``l`` the
paper scores quantisation sensitivity as

    s_{l,sc,k} = ( ||Q(w_l) - w_l|| - ||Q_{sc,k}(w_l) - w_l|| ) * ||∇L_{w_l}|| / n_l
    s_l        = max(s_{l,sc,16}, s_{l,sc,8})                                  (3)

where ``Q`` is the default (8-bit) PwQ quantiser and ``Q_{sc,k}`` the
scale-corrected k-bit variant: layers where extra precision removes much
gradient-weighted error are sensitive and stay FP32/BF16; the rest run
INT8/FXP8.  Gradients come from ``torch.autograd.grad``.
"""
from __future__ import annotations

from typing import Callable, Mapping

import torch

from repro_torch.core.quantization import Precision, pwq_error


def layer_sensitivity(w: torch.Tensor, grad: torch.Tensor) -> torch.Tensor:
    """Paper eqs. (2)-(3) for one layer's weight tensor and loss gradient.

    Eq. (3)'s ``s_{l,sc,8}`` term compares the default 8-bit quantiser with
    itself, so it is zero by construction; the max against it survives as
    a clamp at 0."""
    w = w.to(torch.float32)
    gnorm = torch.linalg.vector_norm(grad.to(torch.float32))
    s_16 = (pwq_error(w, 8) - pwq_error(w, 16)) * gnorm / w.numel()
    return torch.clamp_min(s_16, 0.0)


def sensitivity_scores(
    params: Mapping[str, torch.Tensor], grads: Mapping[str, torch.Tensor]
) -> dict[str, float]:
    """Score every weight tensor in a flat {name: tensor} mapping (tensors
    of fewer than two dimensions stay high precision and are not scored)."""
    return {
        name: float(layer_sensitivity(w, grads[name]))
        for name, w in params.items()
        if w.ndim >= 2
    }


def assign_precisions(
    scores: Mapping[str, float],
    *,
    high_fraction: float = 0.25,
    low_precision: Precision = Precision.INT8,
    high_precision: Precision = Precision.BF16,
    pinned: Mapping[str, Precision] | None = None,
) -> dict[str, Precision]:
    """Rank layers by sensitivity; the top ``high_fraction`` stay high
    precision.  ``pinned`` overrides (e.g. the classifier head at FP32) are
    applied after ranking."""
    if not scores:
        return dict(pinned or {})
    names = sorted(scores, key=lambda n: scores[n], reverse=True)
    n_high = max(1, int(round(high_fraction * len(names)))) if high_fraction > 0 else 0
    policy = {name: high_precision if i < n_high else low_precision
              for i, name in enumerate(names)}
    if pinned:
        policy.update(pinned)
    return policy


def value_and_grad(loss_fn: Callable[[Mapping], torch.Tensor], params: Mapping):
    """``jax.value_and_grad(loss_fn)(params)`` for a nested dict of tensors:
    the loss and the gradient of every leaf, zeros where the loss does not
    reach it."""
    flat = dict(_flatten(params))
    leaves = {name: t.detach().requires_grad_(True) for name, t in flat.items()}
    loss = loss_fn(_unflatten(leaves))
    got = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
    return loss.detach(), _unflatten({
        name: torch.zeros_like(t) if g is None else g
        for (name, t), g in zip(leaves.items(), got)
    })


def score_with_loss(
    loss_fn: Callable[[Mapping[str, torch.Tensor]], torch.Tensor],
    params: Mapping[str, torch.Tensor],
) -> dict[str, float]:
    """Compute the gradients of ``loss_fn`` and score in one shot."""
    _, grads = value_and_grad(loss_fn, params)
    return sensitivity_scores(dict(_flatten(params)), dict(_flatten(grads)))


def _flatten(tree, prefix=""):
    """(``a/b/c`` name, leaf) pairs of a nested mapping, the reference's
    names."""
    if isinstance(tree, Mapping):
        for k, v in tree.items():
            yield from _flatten(v, f"{prefix}{k}/")
    else:
        yield prefix.rstrip("/"), tree


def _unflatten(flat: Mapping[str, torch.Tensor]) -> dict:
    out: dict = {}
    for name, leaf in flat.items():
        *path, last = name.split("/")
        node = out
        for key in path:
            node = node.setdefault(key, {})
        node[last] = leaf
    return out
