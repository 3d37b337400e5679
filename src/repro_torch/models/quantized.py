"""LM-scale precision-aware quantisation.

Counterpart of ``repro/models/quantized.py``.  ``quantize_lm_params`` walks
a transformer parameter tree and converts selected weight matrices to
``QTensor`` (int8 payload + per-channel scale) per a ``PrecisionPolicy``;
``qeinsum`` (``models/layers.py``) dispatches on the leaf type, so the same
model code runs full-precision or weight-only int8.

Policy defaults follow the sensitivity framework's structural priors:
embeddings / unembedding, norms, routers, SSM decay + dt params and the
RWKV decay LoRA stay high precision; attention projections and FFN/expert
matrices go to int8.

The scales are the reference's bits: amax, a division by 127 (the bake runs
eagerly, so no reciprocal) and a round half to even are exact on both
devices, so a quantisation on the card equals one on the CPU bitwise.
"""
from __future__ import annotations

from typing import Mapping

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.precision_policy import Precision, PrecisionPolicy
from repro_torch.core.quantization import QTensor, int8_symmetric, int8_symmetric_keep
from repro_torch.models.layers import tree_leaves

#: parameter-name glob patterns that must stay high-precision (structural pins)
SENSITIVE_PATTERNS = (
    "*embed*", "*lm_head*", "*norm*", "*scale*", "*router*",
    "*a_log*", "*dt_bias*", "*d_skip*", "*mamba/w_in*",  # mamba2 decay/dt/dynamics

    "*w0*", "*w_lora*", "*mu_*", "*/u",  # rwkv6 decay/mix
    "*conv_w*", "*conv_b*", "*alpha*", "*frontend*",
)


def default_lm_policy(cfg: ArchConfig, low: Precision = Precision.INT8) -> PrecisionPolicy:
    rules = {pat: Precision.BF16 for pat in SENSITIVE_PATTERNS}
    return PrecisionPolicy(rules=rules, default=low)


def quantize_leaf(path: str, w: torch.Tensor, policy: PrecisionPolicy):
    """One leaf of :func:`quantize_lm_params`: ``w`` itself, or its
    ``QTensor`` where ``policy`` puts ``path`` at an 8-bit mode."""
    if isinstance(w, QTensor) or w.ndim < 2:
        return w
    if policy.precision_for(path) not in (Precision.INT8, Precision.FXP8):
        return w
    if w.ndim >= 3:
        if w.ndim == 4 and path.rsplit("/", 1)[-1] in ("wq", "wk", "wv"):
            # stacked multi-head projections (layer, embed, heads, head_dim):
            # an output channel is a (head, head_dim) pair, so only the
            # embed contraction axis is reduced: one scale per layer per
            # head per lane.  The 4-D guard keeps rwkv6's headless
            # (layer, d, d) wk/wv on the generic stacked rule.
            return int8_symmetric_keep(w, keep_axes=(0, 2, 3))
        # stacked weights: keep the layer axis AND the output-channel axis
        # so a group's slice carries its own scales
        return int8_symmetric_keep(w, keep_axes=(0, w.ndim - 1))
    return int8_symmetric(w, axis=w.ndim - 1)


def quantize_lm_params(params, policy: PrecisionPolicy | None = None, cfg: ArchConfig | None = None):
    """Returns a parameter tree where int8-eligible weights are QTensor."""
    if policy is None:
        policy = default_lm_policy(cfg) if cfg is not None else PrecisionPolicy()

    def walk(tree, path):
        if isinstance(tree, Mapping):
            return {k: walk(v, f"{path}/{k}" if path else k) for k, v in tree.items()}
        return quantize_leaf(path, tree, policy)

    return walk(params, "")


def quantized_fraction(qparams) -> float:
    """Fraction of parameter *bytes* now stored as int8."""
    total = 0
    q = 0
    for leaf in tree_leaves(qparams):
        if isinstance(leaf, QTensor):
            n = leaf.q.numel()
            q += n
            total += n
        else:
            total += leaf.numel() * leaf.element_size()
    return q / max(total, 1)


def abstract_quantized(aparams, logical, policy: PrecisionPolicy):
    """The quantised model's abstract and logical trees, the reference's:
    every matrix that ``policy`` puts at an 8-bit mode becomes a
    ``QTensor`` of an int8 ``meta`` payload and an fp32 ``meta`` scale over
    the last axis, whose logical axes are all ``None``; other leaves pass
    through.  ``aparams`` is a tree of ``meta`` tensors
    (``transformer.abstract_params``), ``logical`` its axis names.  These
    scales are not :func:`quantize_lm_params`'s, which keep the stacked
    layer axis (and the heads of ``wq``/``wk``/``wv``): a step over stacked
    groups rejects them, in the reference's scan too, so the port's dry
    run quantises its fake params with :func:`quantize_lm_params`."""
    def walk(tree, ltree, path):
        if isinstance(tree, Mapping):
            out_a, out_l = {}, {}
            for k in tree:
                out_a[k], out_l[k] = walk(tree[k], ltree[k], f"{path}/{k}")
            return out_a, out_l
        nd = len(tree.shape)
        if nd >= 2 and policy.precision_for(path) in (Precision.INT8, Precision.FXP8):
            scale_shape = tuple(tree.shape[-1] if i == nd - 1 else 1 for i in range(nd))
            qt = QTensor(q=torch.empty(tree.shape, dtype=torch.int8, device="meta"),
                         scale=torch.empty(scale_shape, dtype=torch.float32, device="meta"),
                         axis=nd - 1)
            return qt, QTensor(q=ltree, scale=(None,) * nd, axis=nd - 1)
        return tree, ltree

    return walk(aparams, logical, "")
