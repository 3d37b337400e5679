"""Atomic, retained checkpoints of a params tree, in the reference's layout.

Counterpart of ``repro/training/checkpoint.py``.  A checkpoint is a
directory ``step_%010d/`` holding one ``leaf_%05d.npy`` a leaf and a
``MANIFEST.json`` (step, time, extra, and each leaf's ``/``-joined key,
file, shape and dtype).  Leaves are numbered in ``jax.tree_util``'s order:
dict keys sorted, sequences by index, named tuples by field, so a
checkpoint written by either package restores in the other.

* **Atomic saves**: the leaves are written into a temp directory that is
  renamed into place when complete, so a preempted save never corrupts the
  previous checkpoint.
* **Restore onto a device**: leaves are read as whole arrays and placed on
  ``device`` (``"cuda"`` by default; without a GPU that raises unless
  ``device="cpu"``).  The reference's ``shardings=`` (placement onto a
  mesh) has no counterpart on one card; ``device=`` takes its place.
* **bf16 leaves**: numpy has no bfloat16, so a bf16 leaf is written as its
  raw bits, a 2-byte void array (the bytes JAX writes for one), with the
  manifest dtype ``"bfloat16"``; a leaf whose manifest says ``"bfloat16"``
  is read back by those bits.  (The reference writes such leaves but
  cannot read them back itself: ``jnp.asarray`` refuses the void array.)
* **Retention and preemption**: ``CheckpointManager`` keeps the last
  ``keep`` checkpoints, resumes from the newest (``maybe_restore``), and
  can save on SIGTERM.
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
import signal
import tempfile
import time
from pathlib import Path
from typing import Any, Callable, Mapping, Optional

import numpy as np
import torch

from repro_torch.kernels.backend import resolve_device


def _flatten_with_paths(tree, prefix: tuple = ()) -> list[tuple[str, Any]]:
    """(key, leaf) pairs in ``jax.tree_util``'s order; ``None`` is an empty
    subtree, as there."""
    if tree is None:
        return []
    if isinstance(tree, Mapping):
        items = [(str(k), tree[k]) for k in sorted(tree)]
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        items = [(name, getattr(tree, name)) for name in tree._fields]
    elif isinstance(tree, (list, tuple)):
        items = [(str(i), v) for i, v in enumerate(tree)]
    else:
        return [("/".join(prefix), tree)]
    out = []
    for key, sub in items:
        out.extend(_flatten_with_paths(sub, prefix + (key,)))
    return out


def _unflatten_like(tree, leaves):
    """``tree``'s structure with its leaves taken in order from ``leaves``
    (an iterator)."""
    if tree is None:
        return None
    if isinstance(tree, Mapping):
        new = {k: _unflatten_like(tree[k], leaves) for k in sorted(tree)}
        return type(tree)({k: new[k] for k in tree})
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_unflatten_like(getattr(tree, f), leaves) for f in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_unflatten_like(v, leaves) for v in tree)
    return next(leaves)


#: numpy's view of a bf16 leaf: its raw 2-byte words
BF16_VOID = np.dtype("V2")


def _to_numpy(leaf) -> tuple[np.ndarray, str]:
    """The array to write and the manifest's dtype name."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(BF16_VOID), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _from_numpy(arr: np.ndarray, dtype: str) -> torch.Tensor:
    # ``ascontiguousarray`` makes a 0-d array 1-d: reshape it back (an
    # optimizer's step counter is a scalar)
    arr = np.ascontiguousarray(arr).reshape(arr.shape)
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def save_checkpoint(directory: str | Path, step: int, tree: Any, *,
                    extra: Optional[dict] = None) -> Path:
    """Atomic save of a tree of tensors (or arrays); returns the final
    checkpoint path."""
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    final = directory / f"step_{step:010d}"
    tmp = Path(tempfile.mkdtemp(prefix=".tmp_ckpt_", dir=directory))
    manifest = {"step": step, "time": time.time(), "extra": extra or {}, "leaves": []}
    try:
        for i, (key, leaf) in enumerate(_flatten_with_paths(tree)):
            arr, dtype = _to_numpy(leaf)
            fname = f"leaf_{i:05d}.npy"
            np.save(tmp / fname, arr)
            manifest["leaves"].append(
                {"key": key, "file": fname, "shape": list(arr.shape), "dtype": dtype}
            )
        (tmp / "MANIFEST.json").write_text(json.dumps(manifest, indent=1))
        if final.exists():
            shutil.rmtree(final)
        os.replace(tmp, final)  # atomic publish
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    return final


def latest_checkpoint(directory: str | Path) -> Optional[Path]:
    directory = Path(directory)
    if not directory.exists():
        return None
    steps = sorted(p for p in directory.iterdir() if p.name.startswith("step_"))
    return steps[-1] if steps else None


def restore_checkpoint(path: str | Path, tree_like: Any, *, device="cuda") -> tuple[int, Any]:
    """Restore into the structure of ``tree_like`` (leaves matched by key,
    shapes checked), every leaf a tensor on ``device``; returns
    (step, tree)."""
    dev = resolve_device(device)
    path = Path(path)
    manifest = json.loads((path / "MANIFEST.json").read_text())
    by_key = {e["key"]: e for e in manifest["leaves"]}
    leaves = []
    for key, leaf in _flatten_with_paths(tree_like):
        entry = by_key.get(key)
        if entry is None:
            raise KeyError(f"checkpoint {path} missing leaf {key!r}")
        arr = np.load(path / entry["file"])
        expected = tuple(getattr(leaf, "shape", arr.shape))
        if tuple(arr.shape) != expected:
            raise ValueError(f"leaf {key}: ckpt shape {arr.shape} != expected {expected}")
        leaves.append(_from_numpy(arr, entry["dtype"]).to(dev))
    return manifest["step"], _unflatten_like(tree_like, iter(leaves))


@dataclasses.dataclass
class CheckpointManager:
    directory: str | Path
    keep: int = 3
    save_every: int = 100

    def should_save(self, step: int) -> bool:
        return step > 0 and step % self.save_every == 0

    def save(self, step: int, tree: Any, extra: Optional[dict] = None) -> Path:
        path = save_checkpoint(self.directory, step, tree, extra=extra)
        self._gc()
        return path

    def maybe_restore(self, tree_like: Any, device="cuda") -> tuple[int, Any]:
        """Resume from the latest checkpoint if present, else (0, tree_like)."""
        latest = latest_checkpoint(self.directory)
        if latest is None:
            return 0, tree_like
        return restore_checkpoint(latest, tree_like, device=device)

    def install_preemption_hook(self, get_state: Callable[[], tuple[int, Any]]):
        """SIGTERM -> emergency checkpoint (preemption-safe training)."""

        def handler(signum, frame):
            step, tree = get_state()
            save_checkpoint(self.directory, step, tree, extra={"emergency": True})
            raise SystemExit(143)

        signal.signal(signal.SIGTERM, handler)

    def _gc(self):
        directory = Path(self.directory)
        steps = sorted(p for p in directory.iterdir() if p.name.startswith("step_"))
        for old in steps[: -self.keep]:
            shutil.rmtree(old, ignore_errors=True)
