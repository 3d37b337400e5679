"""Meshes, logical-axis sharding rules and the collectives that replace
``shard_map``.

Counterpart of ``repro/distributed/sharding.py``, in two halves.

**The serving mesh.**  There a mesh is a ``jax.sharding.Mesh`` of the
local devices; here it is a :class:`StreamMesh`, an ordered list of
``torch.device`` entries on one named axis, which is all the serving layer
reads of it (``shape[axis]`` and ``axis_names``).

An entry is a place a shard runs, not necessarily a device of its own: a
mesh built by hand may repeat a device, so one card runs ``k`` shards one
after another (``StreamMesh(("cuda:0",) * k)``), and
``stream_mesh(k, device="cpu")`` gives ``k`` CPU entries, the counterpart
of the reference's forced host devices.

**The LM rules** (MaxText-style).  Model code names tensor dimensions with
*logical* axes ("batch", "heads", "mlp", ...); a :class:`ShardingRules`
table maps them onto mesh axes and ``spec`` resolves a logical shape to a
tuple of mesh axes per dimension (the reference's ``PartitionSpec``),
dropping any mesh axis that does not divide the dimension and logging the
fallback, exactly as the reference does.  An LM mesh is a
``torch.distributed.device_mesh.DeviceMesh`` with named dims (one rank a
device, ``torch.distributed`` initialised by the launcher), or, when no
process group is initialised, a one-process :class:`HostMesh` with the same
``axis_names`` and ``shape`` and every axis of size 1.

The port places tensors by process group, not by annotation: every rank
holds whole parameters and its own rows of the batch, and the few places
where the reference's ``shard_map`` moves data (the vocab-parallel gather,
the expert-parallel MoE, the data-parallel gradient sum) call the autograd
collectives at the end of this module over :meth:`ShardingRules.group`.
``constrain`` is therefore an identity.  On a :class:`HostMesh` the groups
are ``None`` and every collective is an identity.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
from typing import Any, Optional, Sequence

import torch
import torch.distributed as dist

from repro_torch.kernels.backend import resolve_device

try:
    from torch.distributed.device_mesh import DeviceMesh
except ImportError:  # a build without torch.distributed: only HostMesh exists
    DeviceMesh = ()

#: mesh axis name used by the serving layer's sharded-batch dispatch
STREAM_AXIS = "streams"


@dataclasses.dataclass(frozen=True)
class StreamMesh:
    """A 1-D mesh: ``devices`` in shard order on the axis ``axis``."""

    devices: tuple[torch.device, ...]
    axis: str = STREAM_AXIS

    def __post_init__(self):
        devs = tuple(resolve_device(d) for d in self.devices)
        if not devs:
            raise ValueError("a mesh needs at least one device")
        devs = tuple(
            torch.device("cuda", torch.cuda.current_device()) if d.type == "cuda" and d.index is None
            else d
            for d in devs
        )
        object.__setattr__(self, "devices", devs)

    @property
    def axis_names(self) -> tuple[str, ...]:
        return (self.axis,)

    @property
    def shape(self) -> dict[str, int]:
        return {self.axis: len(self.devices)}

    @property
    def size(self) -> int:
        return len(self.devices)


def stream_mesh(shards: int, *, axis: str = STREAM_AXIS, device="cuda") -> StreamMesh:
    """1-D serving mesh: the first ``shards`` CUDA devices on one axis, or,
    with ``device="cpu"``, ``shards`` CPU entries.

    The monitor engine splits its fixed ``batch_slots`` along this axis
    (weights replicated, activation rows sharded).  To run several shards
    on one card, build the mesh by hand with that card repeated."""
    dev = resolve_device(device)
    count = torch.cuda.device_count() if dev.type == "cuda" else None
    if shards < 1 or (count is not None and shards > count):
        most = "" if count is None else f" <= {count}"
        raise ValueError(
            f"stream_mesh: need 1 <= shards{most} local devices, got {shards} "
            f"(to run several shards on one card, build StreamMesh((device,) * "
            f"shards) with the card repeated)"
        )
    if dev.type == "cpu":
        return StreamMesh((dev,) * shards, axis)
    return StreamMesh(tuple(torch.device("cuda", i) for i in range(shards)), axis)


# ---------------------------------------------------------------------------
# LM meshes and logical-axis rules
# ---------------------------------------------------------------------------

# logical axis -> mesh axis (or tuple of mesh axes)
DEFAULT_RULES: dict[str, tuple[str, ...]] = {
    "batch": ("pod", "data"),
    "decode_batch": ("pod", "data"),
    "seq": (),  # replicated by default; long-context rules shard it
    "kv_seq": (),
    # decode KV caches when kv_heads cannot use the model axis (MQA/GQA with
    # few kv heads): shard the *sequence* dim over model instead
    "kv_seq_model": ("model",),
    "embed": (),
    "vocab": ("model",),
    "heads": ("model",),
    "kv_heads": ("model",),
    "head_dim": (),
    "mlp": ("model",),
    "experts": ("model",),
    "expert_capacity": (),
    "ssm_heads": ("model",),
    "ssm_state": (),
    "conv_kernel": (),
    "layers": (),
    "frontend": (),
    "classes": ("model",),
}

#: long-context serving rules: shard the KV/sequence axis over "data"
#: (ring-attention style cache partitioning) since decode batch is tiny.
LONG_CONTEXT_OVERRIDES = {
    "kv_seq": ("data",),
    "kv_seq_model": ("data", "model"),
    "decode_batch": ("pod",),
}


@dataclasses.dataclass(frozen=True)
class HostMesh:
    """The one-process stand-in for a ``DeviceMesh``: named axes, every one
    of size 1.  It has no process groups."""

    axis_names: tuple[str, ...]

    @property
    def shape(self) -> dict[str, int]:
        return {a: 1 for a in self.axis_names}


def mesh_shape(mesh) -> dict[str, int]:
    """``{axis: size}`` of a ``DeviceMesh``, a :class:`HostMesh` or any
    object with ``axis_names`` and a ``shape`` mapping."""
    if getattr(mesh, "mesh_dim_names", None) is not None:
        return dict(zip(mesh.mesh_dim_names, mesh.shape))
    return dict(mesh.shape)


class ShardingRules:
    def __init__(self, mesh, rules: Optional[dict] = None):
        self.mesh = mesh
        self.rules = dict(DEFAULT_RULES)
        if rules:
            self.rules.update(rules)
        self.fallbacks: list[tuple[str, int, str]] = []  # (logical, size, reason)
        self._groups: dict[tuple[str, ...], Any] = {}

    @property
    def axis_names(self) -> tuple[str, ...]:
        return tuple(mesh_shape(self.mesh))

    @property
    def shape(self) -> dict[str, int]:
        return mesh_shape(self.mesh)

    def mesh_axes_for(self, logical: Optional[str]) -> tuple[str, ...]:
        if logical is None:
            return ()
        axes = self.rules.get(logical, ())
        return tuple(a for a in axes if a in self.axis_names)

    def spec(self, logical_shape: Sequence[Optional[str]],
             dims: Optional[Sequence[int]] = None) -> tuple:
        """Resolve logical axis names (+ optional dim sizes for divisibility)
        to one entry a dimension: ``None``, a mesh axis, or a tuple of them.

        A mesh axis may shard at most one dimension of a tensor: earlier
        dimensions win (e.g. MoE expert weights ("experts","embed","mlp")
        give the model axis to "experts"; "mlp" falls back to replicated).
        Non-divisible mappings also fall back; both are logged.
        """
        parts = []
        used: set[str] = set()
        shape = self.shape
        for i, name in enumerate(logical_shape):
            axes = self.mesh_axes_for(name)
            kept = []
            total = 1
            for a in axes:
                if a in used:
                    self.fallbacks.append((name or "?", -1, f"{a} already used in tensor"))
                    continue
                n = shape[a]
                if dims is not None:
                    size = dims[i]
                    if size % (total * n) != 0:
                        self.fallbacks.append((name or "?", size, f"{a}={n} !| {size}"))
                        continue
                kept.append(a)
                total *= n
            used.update(kept)
            if not kept:
                parts.append(None)
            elif len(kept) == 1:
                parts.append(kept[0])
            else:
                parts.append(tuple(kept))
        return tuple(parts)

    def size(self, axes: Sequence[str]) -> int:
        shape = self.shape
        return math.prod(shape[a] for a in axes)

    def axis_index(self, axes: Sequence[str]) -> int:
        """This rank's index along ``axes`` combined row-major (the
        reference's ``axis_index`` products); 0 on a :class:`HostMesh`."""
        if not isinstance(self.mesh, DeviceMesh):
            return 0
        idx = 0
        for a in axes:
            idx = idx * self.shape[a] + self.mesh.get_local_rank(a)
        return idx

    def group(self, axes: Sequence[str]):
        """The process group of the ranks that differ only along ``axes``
        (``None`` on a :class:`HostMesh`, or for no axes).  A single axis is
        the mesh's own group; several axes get a group built once per rules
        object, collectively on every rank."""
        axes = tuple(axes)
        if not axes or not isinstance(self.mesh, DeviceMesh):
            return None
        if len(axes) == 1:
            return self.mesh.get_group(axes[0])
        if axes not in self._groups:
            names = self.axis_names
            ranks = self.mesh.mesh
            order = [names.index(a) for a in names if a not in axes] + [names.index(a)
                                                                       for a in axes]
            rows = ranks.permute(order).reshape(-1, self.size(axes))
            me = dist.get_rank()
            for row in rows.tolist():
                g = dist.new_group(row)
                if me in row:
                    self._groups[axes] = g
        return self._groups[axes]


_ACTIVE = threading.local()


def active_rules() -> Optional[ShardingRules]:
    return getattr(_ACTIVE, "rules", None)


@contextlib.contextmanager
def use_rules(rules: Optional[ShardingRules]):
    prev = getattr(_ACTIVE, "rules", None)
    _ACTIVE.rules = rules
    try:
        yield rules
    finally:
        _ACTIVE.rules = prev


def kv_seq_axis(n_kv_heads: int) -> str:
    """Logical axis for KV-cache sequence dims: "kv_seq_model" when the kv
    heads cannot occupy the model axis."""
    rules = active_rules()
    if rules is None:
        return "kv_seq"
    msize = rules.shape.get("model", 1)
    return "kv_seq" if n_kv_heads % msize == 0 else "kv_seq_model"


def constrain(x: torch.Tensor, logical_shape: Sequence[Optional[str]]) -> torch.Tensor:
    """The reference's activation annotation: an identity here.  The port
    places tensors by process group (each rank holds its rows), so there
    is nothing to annotate; the call stays where the reference has it."""
    return x


def is_logical_leaf(t) -> bool:
    return isinstance(t, tuple) and all(isinstance(i, (str, type(None))) for i in t)


def tree_shardings(rules: ShardingRules, abstract_tree, logical_tree):
    """The tree of specs for params: ``logical_tree`` mirrors the abstract
    param tree (tensors on the ``meta`` device, or anything with a
    ``shape``), with tuples of logical axis names at the leaves."""
    if is_logical_leaf(logical_tree):
        return rules.spec(logical_tree, dims=tuple(abstract_tree.shape))
    return {k: tree_shardings(rules, abstract_tree[k], logical_tree[k])
            for k in sorted(logical_tree)}  # the reference's leaf order (fallbacks log)


# ---------------------------------------------------------------------------
# autograd collectives (what ``shard_map`` does in the reference)
# ---------------------------------------------------------------------------


class _CopyTo(torch.autograd.Function):
    """Forward identity, backward all-reduce: a tensor every rank of
    ``group`` holds whole, entering a computation each rank does on its own
    share (the transpose of a replicated ``shard_map`` input)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)  # never reduce autograd's own buffer
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFrom(torch.autograd.Function):
    """Forward all-reduce (sum), backward identity: partial results summed
    into a value every rank then uses whole (``psum`` inside a
    ``shard_map`` whose output is replicated)."""

    @staticmethod
    def forward(ctx, x, group):
        x = x.contiguous().clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFrom(torch.autograd.Function):
    """Forward all-gather along dim 0, backward this rank's slice: each
    rank's rows assembled into the whole on every rank."""

    @staticmethod
    def forward(ctx, x, group):
        n = dist.get_world_size(group)
        ctx.rank, ctx.rows = dist.get_rank(group), x.shape[0]
        parts = [torch.empty_like(x, memory_format=torch.contiguous_format) for _ in range(n)]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, g):
        return g[ctx.rank * ctx.rows:(ctx.rank + 1) * ctx.rows], None


class _AllToAll(torch.autograd.Function):
    """``all_to_all`` of equal chunks of dim 0 (``lax.all_to_all(...,
    split_axis=0, concat_axis=0)``); its transpose is itself."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_to_all(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, ctx.group), None


def _all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    # the collective writes raw rows: both buffers must be row-major
    # (``empty_like`` of a permuted gradient would keep its strides)
    x = x.contiguous()
    out = torch.empty_like(x, memory_format=torch.contiguous_format)
    dist.all_to_all_single(out, x, group=group)
    return out


def copy_to(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _CopyTo.apply(x, group)


def reduce_from(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _ReduceFrom.apply(x, group)


def gather_from(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _GatherFrom.apply(x, group)


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _AllToAll.apply(x, group)


__all__ = [
    "STREAM_AXIS", "StreamMesh", "stream_mesh", "DEFAULT_RULES", "LONG_CONTEXT_OVERRIDES",
    "HostMesh", "ShardingRules", "active_rules", "use_rules", "kv_seq_axis", "constrain",
    "is_logical_leaf", "tree_shardings", "mesh_shape", "copy_to",
    "reduce_from", "gather_from", "all_to_all",
]
