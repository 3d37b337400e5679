"""Serialisation-aware structured channel pruning (SHIELD8-UAV §III-C).

Counterpart of ``repro/core/pruning.py`` (``PruneSpec``,
``channel_importance``, ``plan_prune``, ``apply_prune_conv``,
``apply_prune_dense``, and the LM generalisation ``prune_ffn``).  Channel importance is the L1 norm of each output
channel of the last conv; the top ``keep`` channels survive, the prune is
propagated into the consumer dense layer's rows (flatten order is
``(frames, channels)`` row-major), and ``trim_frames`` boundary frames are
cut.  ``keep=64, trim_frames=1`` on the canonical detector gives the paper's
35,072 -> 8,704.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch

from repro_torch.kernels.xla_sum import xla_row_sum


@dataclasses.dataclass(frozen=True)
class PruneSpec:
    """Result of planning a structured channel prune."""

    keep_channels: np.ndarray  # sorted indices of surviving channels
    keep_frames: np.ndarray  # surviving spatial frames (boundary trim)
    flatten_before: int
    flatten_after: int

    @property
    def reduction(self) -> float:
        return 1.0 - self.flatten_after / self.flatten_before

    def to_dict(self) -> dict:
        """Plain-JSON form so a spec can ride along in configs/artifacts."""
        return {
            "keep_channels": [int(c) for c in self.keep_channels],
            "keep_frames": [int(f) for f in self.keep_frames],
            "flatten_before": int(self.flatten_before),
            "flatten_after": int(self.flatten_after),
        }

    @staticmethod
    def from_dict(d: Mapping) -> "PruneSpec":
        return PruneSpec(
            keep_channels=np.asarray(d["keep_channels"], np.int64),
            keep_frames=np.asarray(d["keep_frames"], np.int64),
            flatten_before=int(d["flatten_before"]),
            flatten_after=int(d["flatten_after"]),
        )

    @property
    def cache_key(self) -> tuple:
        """Hashable identity (numpy members make the dataclass unhashable)."""
        return (
            tuple(int(c) for c in self.keep_channels),
            tuple(int(f) for f in self.keep_frames),
            self.flatten_before,
            self.flatten_after,
        )


def channel_importance(w_conv: torch.Tensor) -> torch.Tensor:
    """L1-norm importance (float32) of each output channel of a conv kernel
    laid out (kernel, in_ch, out_ch)."""
    return w_conv.to(torch.float32).abs().sum(dim=(0, 1))


def plan_prune(
    w_conv: torch.Tensor, n_frames: int, *, keep: int, trim_frames: int = 0
) -> PruneSpec:
    """Plan a structured prune of the final conv block feeding the flatten.

    The ranking uses the same ``np.argsort`` as the reference, so equal
    importance vectors give equal specs; near-tied channels can still swap
    where the float32 sums round differently."""
    imp = channel_importance(torch.as_tensor(w_conv)).cpu().numpy()
    order = np.argsort(imp)[::-1]
    keep_ch = np.sort(order[:keep])
    keep_fr = np.arange(n_frames - trim_frames)
    n_ch = w_conv.shape[-1]
    return PruneSpec(
        keep_channels=keep_ch,
        keep_frames=keep_fr,
        flatten_before=n_frames * n_ch,
        flatten_after=len(keep_fr) * keep,
    )


def apply_prune_conv(w_conv: torch.Tensor, b_conv: torch.Tensor, spec: PruneSpec):
    """Slice the producing conv's output channels."""
    idx = torch.as_tensor(spec.keep_channels, dtype=torch.long, device=w_conv.device)
    return w_conv[:, :, idx], b_conv[idx]


def apply_prune_dense(
    w_dense: torch.Tensor, spec: PruneSpec, n_frames: int, n_ch: int
) -> torch.Tensor:
    """Drop the consumer dense layer's rows of pruned channels and frames
    (rows follow the ``(frames, channels)`` row-major flatten)."""
    w = w_dense.reshape(n_frames, n_ch, -1)
    fr = torch.as_tensor(spec.keep_frames, dtype=torch.long, device=w.device)
    ch = torch.as_tensor(spec.keep_channels, dtype=torch.long, device=w.device)
    return w[fr][:, ch].reshape(spec.flatten_after, -1)


def prune_ffn(
    w_in: torch.Tensor, w_out: torch.Tensor, *, keep: int
) -> tuple[torch.Tensor, torch.Tensor, np.ndarray]:
    """Structured hidden-channel prune of a dense FFN (LM generalisation).

    ``w_in``: (d_model, d_ff), ``w_out``: (d_ff, d_model).  Importance of a
    hidden channel is ||w_in[:, c]||_1 * ||w_out[c, :]||_1 (flow through the
    channel), each norm summed in the reference's order of additions
    (:func:`~repro_torch.kernels.xla_sum.xla_row_sum`; bitwise for float32
    weights), so the same channels survive.  Returns sliced weights + kept
    indices."""
    l1_in = xla_row_sum(w_in.to(torch.float32).abs().T)[..., 0]
    l1_out = xla_row_sum(w_out.to(torch.float32).abs())[..., 0]
    imp = (l1_in * l1_out).cpu().numpy()
    keep_idx = np.sort(np.argsort(imp)[::-1][:keep])
    idx = torch.as_tensor(keep_idx, dtype=torch.long, device=w_in.device)
    return w_in[:, idx], w_out[idx, :], keep_idx
