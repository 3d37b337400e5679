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
* **Sharded trees** (``shardings=``, a tree of specs mirroring the tree:
  ``distributed/sharding.tree_shardings``' for params; ``None`` for a
  whole subtree, as an optimizer's step counter): a save gathers each cut
  leaf whole, collectively on every rank, and global rank 0 writes, so a
  checkpoint always holds whole leaves in the reference's layout; a restore
  checks each leaf against its *global* shape and places this rank's part
  of it under the active rules.  So a checkpoint saved on one mesh restores
  onto any other (the reference's elastic ``restore_checkpoint(shardings=)``).
* **Restore onto a device**: leaves are placed on ``device`` (``"cuda"`` by
  default; without a GPU that raises unless ``device="cpu"``).
* **bf16 leaves**: numpy has no bfloat16, so a bf16 leaf is written as its
  raw bits, a 2-byte void array (the bytes JAX writes for one), with the
  manifest dtype ``"bfloat16"``; a leaf whose manifest says ``"bfloat16"``
  is read back by those bits.  (The reference writes such leaves but
  cannot read them back itself: ``jnp.asarray`` refuses the void array.)
* **Retention and preemption**: ``CheckpointManager`` keeps the last
  ``keep`` checkpoints and resumes from the newest (``maybe_restore``).
  Its SIGTERM hook only sets a flag; the training loop reads it between
  steps (``preempt_requested``, agreed over the world by ``any_rank``) and
  every rank then takes part in the emergency save at the same step
  boundary, as a gathering save needs.
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
import torch.distributed as dist

from repro_torch.distributed import sharding as SH
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


class _Spec:
    """A spec carried as one leaf through ``_flatten_with_paths`` (a spec is
    itself a tuple)."""

    def __init__(self, spec):
        self.spec = spec


def _specs_like(tree, shardings) -> list:
    """``shardings``' spec for each leaf of ``tree``, in leaf order."""
    return [s.spec for _, s in _flatten_with_paths(
        SH.map_specs(lambda _, spec: _Spec(spec), tree, shardings))]


def _writer() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0


def save_checkpoint(directory: str | Path, step: int, tree: Any, *,
                    extra: Optional[dict] = None, shardings: Any = None) -> Optional[Path]:
    """Atomic save of a tree of tensors (or arrays); returns the final
    checkpoint path.  With ``shardings`` every rank calls it: each cut leaf
    is gathered whole under the active rules, global rank 0 writes, and all
    ranks leave together (the others get ``None``)."""
    if shardings is not None:
        rules = SH.active_rules()
        specs = _specs_like(tree, shardings)
        # one leaf gathered at a time (a generator), written by rank 0 only
        leaves = ((key, SH.unshard(leaf, spec, rules) if rules is not None else leaf)
                  for (key, leaf), spec in zip(_flatten_with_paths(tree), specs))
        path = None
        if _writer():
            path = _write(directory, step, leaves, extra)
        else:
            for _ in leaves:
                pass
        if dist.is_initialized():
            dist.barrier()
        return path
    return _write(directory, step, _flatten_with_paths(tree), extra)


def _write(directory, step: int, leaves, extra: Optional[dict]) -> Path:
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    final = directory / f"step_{step:010d}"
    tmp = Path(tempfile.mkdtemp(prefix=".tmp_ckpt_", dir=directory))
    manifest = {"step": step, "time": time.time(), "extra": extra or {}, "leaves": []}
    try:
        for i, (key, leaf) in enumerate(leaves):
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


def restore_checkpoint(path: str | Path, tree_like: Any, *, shardings: Any = None,
                       device="cuda") -> tuple[int, Any]:
    """Restore into the structure of ``tree_like`` (leaves matched by key,
    shapes checked), every leaf a tensor on ``device``; returns
    (step, tree).  With ``shardings`` (specs mirroring ``tree_like``, whose
    leaves are this rank's parts) each leaf is checked against its global
    shape and this rank's part of it is placed, under the active rules: the
    elastic path onto a new mesh."""
    dev = resolve_device(device)
    path = Path(path)
    manifest = json.loads((path / "MANIFEST.json").read_text())
    by_key = {e["key"]: e for e in manifest["leaves"]}
    rules = SH.active_rules()
    specs = (_specs_like(tree_like, shardings) if shardings is not None and rules is not None
             else [None] * len(_flatten_with_paths(tree_like)))
    leaves = []
    for (key, leaf), spec in zip(_flatten_with_paths(tree_like), specs):
        entry = by_key.get(key)
        if entry is None:
            raise KeyError(f"checkpoint {path} missing leaf {key!r}")
        arr = np.load(path / entry["file"])
        expected = tuple(getattr(leaf, "shape", arr.shape))
        if spec is not None:
            expected = SH.global_shape(expected, spec, rules)
        if tuple(arr.shape) != expected:
            raise ValueError(f"leaf {key}: ckpt shape {arr.shape} != expected {expected}")
        t = _from_numpy(arr, entry["dtype"])
        leaves.append(SH.shard(t, spec, rules, device=dev) if spec is not None else t.to(dev))
    return manifest["step"], _unflatten_like(tree_like, iter(leaves))


def any_rank(flags, device) -> list[bool]:
    """Each flag true on any rank of the world (one max all-reduce of a
    ``device`` tensor, the device of the world's backend; the flags as they
    are without a process group), so
    the ranks of a training loop stop at the same step boundary."""
    if not dist.is_initialized():
        return [bool(f) for f in flags]
    t = torch.tensor([int(bool(f)) for f in flags], dtype=torch.int32, device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return [bool(v) for v in t.tolist()]


@dataclasses.dataclass
class CheckpointManager:
    """Retained checkpoints of one run.  ``shardings`` (specs mirroring the
    saved tree, or ``None`` for whole leaves) makes every save and restore
    the sharded one: then every rank calls ``save``."""

    directory: str | Path
    keep: int = 3
    save_every: int = 100
    shardings: Any = None
    _preempted: bool = dataclasses.field(default=False, init=False, repr=False)

    def should_save(self, step: int) -> bool:
        return step > 0 and step % self.save_every == 0

    def save(self, step: int, tree: Any, extra: Optional[dict] = None) -> Optional[Path]:
        path = save_checkpoint(self.directory, step, tree, extra=extra, shardings=self.shardings)
        if path is not None:
            self._gc()
        return path

    def maybe_restore(self, tree_like: Any, device="cuda") -> tuple[int, Any]:
        """Resume from the latest checkpoint if present, else (0, tree_like)."""
        latest = latest_checkpoint(self.directory)
        if latest is None:
            return 0, tree_like
        return restore_checkpoint(latest, tree_like, shardings=self.shardings, device=device)

    def install_preemption_hook(self) -> Callable:
        """SIGTERM sets the flag :attr:`preempt_requested` reads; returns the
        handler it replaced."""

        def handler(signum, frame):
            self._preempted = True

        return signal.signal(signal.SIGTERM, handler)

    @property
    def preempt_requested(self) -> bool:
        """Whether SIGTERM reached this process since the hook was
        installed (:func:`any_rank` makes the ranks agree on it)."""
        return self._preempted

    def save_emergency(self, step: int, tree: Any) -> Optional[Path]:
        """The preemption save (every rank calls it with ``shardings``)."""
        return save_checkpoint(self.directory, step, tree, extra={"emergency": True},
                               shardings=self.shardings)

    def _gc(self):
        directory = Path(self.directory)
        steps = sorted(p for p in directory.iterdir() if p.name.startswith("step_"))
        for old in steps[: -self.keep]:
            shutil.rmtree(old, ignore_errors=True)
