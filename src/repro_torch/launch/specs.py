"""Input stand-ins per (architecture x input shape) cell.

Counterpart of ``repro/launch/specs.py``: tensors on the ``meta`` device
(shapes and dtypes, nothing allocated) take the place of the reference's
``ShapeDtypeStruct``, each tree beside its tree of logical axes.

Shapes:
    train_4k      seq_len=4,096   global_batch=256   (train_step)
    prefill_32k   seq_len=32,768  global_batch=32    (prefill serve step)
    decode_32k    seq_len=32,768  global_batch=128   (decode serve step)
    long_500k     seq_len=524,288 global_batch=1     (long-context decode)

Skips, as the reference's:
    * encoder-only archs (hubert) have no decode step -> decode_32k and
      long_500k skipped;
    * pure full-attention archs skip long_500k (it needs sub-quadratic
      attention); SSM, hybrid and sliding-window archs run it.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import transformer as T
from repro_torch.models.layers import tree_map


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


def skip_reason(cfg: ArchConfig, shape: ShapeSpec) -> Optional[str]:
    if cfg.is_encoder and shape.kind == "decode":
        return "encoder-only: no decode step"
    if shape.name == "long_500k" and not cfg.subquadratic:
        return "pure full-attention arch: long_500k needs sub-quadratic attention"
    return None


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def batch_specs(cfg: ArchConfig, shape: ShapeSpec) -> tuple[dict, dict]:
    """(tree of ``meta`` tensors, tree of logical axis tuples) for the
    *data* inputs of the step (params and caches are built elsewhere)."""
    b, s = shape.global_batch, shape.seq_len
    i32 = torch.int32
    if shape.kind in ("train", "prefill"):
        if cfg.frontend == "audio_frames":
            specs = {"frames": _meta((b, s, cfg.frontend_dim), torch.float32)}
            logical = {"frames": ("batch", "seq", "frontend")}
        elif cfg.frontend == "vision_patches":
            specs = {
                "tokens": _meta((b, s - cfg.n_patches), i32),
                "patches": _meta((b, cfg.n_patches, cfg.frontend_dim), torch.float32),
            }
            logical = {"tokens": ("batch", "seq"), "patches": ("batch", "seq", "frontend")}
        else:
            specs = {"tokens": _meta((b, s), i32)}
            logical = {"tokens": ("batch", "seq")}
        if shape.kind == "train":
            lt = specs.get("tokens")
            specs["labels"] = _meta((b, lt.shape[1] if lt is not None else s), i32)
            logical["labels"] = ("batch", "seq")
        return specs, logical
    # decode
    specs = {"token": _meta((b, 1), i32), "pos": _meta((), i32)}
    logical = {"token": ("decode_batch", None), "pos": ()}
    return specs, logical


def cache_specs(cfg: ArchConfig, shape: ShapeSpec, model_axis_size: int = 16):
    """(tree of ``meta`` cache tensors, tree of logical axes) of a decode
    cell; the sequence axis is ``"kv_seq_model"`` when the kv heads do not
    divide over ``model_axis_size``."""
    caches = tree_map(lambda sd: _meta(*sd),
                      T.cache_shapes(cfg, shape.global_batch, shape.seq_len))
    seq_axis = "kv_seq" if cfg.n_kv_heads % model_axis_size == 0 else "kv_seq_model"
    return caches, T.cache_logical_axes(cfg, seq_axis=seq_axis)
