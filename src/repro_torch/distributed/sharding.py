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

The port places tensors by process group, not by annotation.  Every LM
parameter, and its Adam moments, is held as this rank's part of the spec
``tree_shardings`` gives it (:func:`shard_tree`; a dimension whose spec
names mesh axes of more than one rank is cut into equal contiguous parts,
the rank's part picked by ``ShardingRules.axis_index``), every rank holds
its own rows of the batch, and the blocks compute on those parts with the
Megatron-style autograd collectives at the end of this module over
:meth:`ShardingRules.group`: ``copy_to`` where a whole activation enters
work split over a group, ``reduce_from`` where partial results leave it,
``gather_dim`` where a block needs a cut leaf (or activation) whole for
work every rank does alike, ``gather_partials`` and ``sum_partials`` where
a gathered tensor or a summed value is then used by each rank on its own
share (their backwards sum the ranks' partial gradients).  A
block asks :func:`dim_cut` whether a dimension of one of its leaves is cut,
from the leaf's logical axes, its global shape and the active rules, and
never guesses from the shapes it is handed.  A mesh axis of size 1 cuts
nothing, so a ``"model"`` axis of 1 (or a :class:`HostMesh`) runs the
program of whole parameters.  ``constrain`` is an identity.  On a
:class:`HostMesh` the groups are ``None`` and every collective is an
identity.

A decode cache's sequence is cut as its logical axes say
(``models/layers.cache_seq_cut``), and its rows are the
``"decode_batch"`` axes' (:func:`to_cache_rows`).  An int8 ``QTensor``
leaf is placed as the reference places it (``tree_shardings`` over
``models/quantized.abstract_quantized``'s trees gives its payload the
weight's spec and its scale an all-``None`` one): the payload cut, the
scale whole, and the part's ``start`` recorded so that a block
dequantises with the part's channels (``QTensor.local_scale``).
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
from typing import Any, Mapping, Optional, Sequence

import torch
import torch.distributed as dist

from repro_torch.core.quantization import QTensor
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
             dims: Optional[Sequence[int]] = None, *, record: bool = True) -> tuple:
        """Resolve logical axis names (+ optional dim sizes for divisibility)
        to one entry a dimension: ``None``, a mesh axis, or a tuple of them.

        A mesh axis may shard at most one dimension of a tensor: earlier
        dimensions win (e.g. MoE expert weights ("experts","embed","mlp")
        give the model axis to "experts"; "mlp" falls back to replicated).
        Non-divisible mappings also fall back; both are logged unless
        ``record`` is false (a block asking again during a step).
        """
        log = self.fallbacks if record else []
        parts = []
        used: set[str] = set()
        shape = self.shape
        for i, name in enumerate(logical_shape):
            axes = self.mesh_axes_for(name)
            kept = []
            total = 1
            for a in axes:
                if a in used:
                    log.append((name or "?", -1, f"{a} already used in tensor"))
                    continue
                n = shape[a]
                if dims is not None:
                    size = dims[i]
                    if size % (total * n) != 0:
                        log.append((name or "?", size, f"{a}={n} !| {size}"))
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
    places parameters by :func:`shard_tree` and each block moves its
    activations with explicit collectives, so there is nothing to
    annotate; the call stays where the reference has it."""
    return x


def is_logical_leaf(t) -> bool:
    return isinstance(t, tuple) and all(isinstance(i, (str, type(None))) for i in t)


def tree_shardings(rules: ShardingRules, abstract_tree, logical_tree, *, record: bool = True):
    """The tree of specs for params: ``logical_tree`` mirrors the abstract
    param tree (tensors on the ``meta`` device, or anything with a
    ``shape``), with tuples of logical axis names at the leaves.  A
    ``QTensor`` leaf (``models/quantized.abstract_quantized``'s trees) gets a
    ``QTensor`` of specs: its payload's and its scale's."""
    if is_logical_leaf(logical_tree):
        return rules.spec(logical_tree, dims=tuple(abstract_tree.shape), record=record)
    if isinstance(logical_tree, QTensor):
        return QTensor(
            rules.spec(logical_tree.q, dims=tuple(abstract_tree.q.shape), record=record),
            rules.spec(logical_tree.scale, dims=tuple(abstract_tree.scale.shape), record=record),
            logical_tree.axis)
    return {k: tree_shardings(rules, abstract_tree[k], logical_tree[k], record=record)
            for k in sorted(logical_tree)}  # the reference's leaf order (fallbacks log)


# ---------------------------------------------------------------------------
# placement: this rank's parts of the leaves
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Cut:
    """How a leaf is cut: into ``size`` equal contiguous parts over the mesh
    axes ``axes``; this rank holds part ``index``, and ``group`` is the
    process group of the ranks holding the parts (in part order)."""

    axes: tuple[str, ...]
    size: int
    index: int
    group: Any

    def part(self, n: int) -> slice:
        """This rank's part of a dimension of global length ``n``."""
        k = n // self.size
        return slice(self.index * k, (self.index + 1) * k)


def _entry_axes(entry) -> tuple[str, ...]:
    return () if entry is None else (entry,) if isinstance(entry, str) else tuple(entry)


def _cut(axes: tuple[str, ...], rules: ShardingRules) -> Optional[Cut]:
    n = rules.size(axes) if axes else 1
    if n == 1:
        return None
    return Cut(axes, n, rules.axis_index(axes), rules.group(axes))


def spec_cuts(spec, rules: ShardingRules) -> dict[int, Cut]:
    """``{dim: Cut}`` of the dimensions a spec cuts (mesh axes of more than
    one rank); a whole leaf gives ``{}``."""
    cuts = {}
    for i, entry in enumerate(spec or ()):
        c = _cut(_entry_axes(entry), rules)
        if c is not None:
            cuts[i] = c
    return cuts


def spec_cut(spec, rules: ShardingRules) -> Optional[Cut]:
    """The whole leaf's cut: the mesh axes of all its cut dimensions
    together (what a sum or a max over the leaf reduces over), or ``None``
    for a whole leaf."""
    axes = tuple(a for entry in (spec or ()) for a in _entry_axes(entry))
    return _cut(axes, rules)


def dim_cut(logical: Sequence[Optional[str]], dims: Sequence[int], dim: int) -> Optional[Cut]:
    """How dimension ``dim`` of a leaf with logical axes ``logical`` and
    global shape ``dims`` is held under the active rules: its :class:`Cut`,
    or ``None`` where every rank holds it whole.  The leaf's spec is ``rules.spec(logical, dims)``, divisibility
    fallback included (not logged again), so a block reads the cut from its
    config and never from the shapes it is handed."""
    rules = active_rules()
    if rules is None:
        return None
    return spec_cuts(rules.spec(logical, dims, record=False), rules).get(dim)


def batch_cut(logical: str = "batch") -> Optional[Cut]:
    """How the batch's rows are split over the ranks under the active
    rules: over the mesh axes of ``logical`` (``"batch"``, or a decode
    cache's ``"decode_batch"``), or ``None`` where one rank holds them
    all."""
    rules = active_rules()
    return None if rules is None else _cut(rules.mesh_axes_for(logical), rules)


def to_cache_rows(t: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """``t``'s rows (dimension ``dim``) as a decode cache holds them: a
    prefill's activations hold the rows of ``"batch"``, a cache those of
    ``"decode_batch"``; where the two cuts differ (the long-context rules
    keep a decode's rows whole over ``"data"``), the rows are gathered over
    the one and this rank's part of the other is kept."""
    src, dst = batch_cut(), batch_cut("decode_batch")
    if (src and src.axes) == (dst and dst.axes):
        return t
    if src is not None:
        t = _all_gather_dim(t, group_of(src), dim)
    if dst is not None:
        t = t.narrow(dim, dst.index * (t.shape[dim] // dst.size), t.shape[dim] // dst.size)
    return t


def map_specs(fn, tree, specs):
    """``fn(leaf, spec)`` over the leaves of ``tree`` (nested dicts, named
    tuples, tuples and lists) and the matching entries of ``specs``, a tree
    of the same structure with a spec at each leaf; ``None`` in ``specs``
    stands for a whole subtree."""
    if isinstance(tree, Mapping):
        return {k: map_specs(fn, v, None if specs is None else specs[k]) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(map_specs(fn, getattr(tree, f),
                                      None if specs is None else getattr(specs, f))
                            for f in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_specs(fn, v, None if specs is None else specs[i])
                          for i, v in enumerate(tree))
    return fn(tree, specs)


def _q_specs(spec) -> tuple:
    """A ``QTensor`` leaf's (payload, scale) specs: a ``QTensor`` of specs
    (:func:`tree_shardings` over ``abstract_quantized``'s trees) as it is;
    a plain spec is the payload's, the scale then whole."""
    return (spec.q, spec.scale) if isinstance(spec, QTensor) else (spec, None)


def shard(t: torch.Tensor, spec, rules: ShardingRules, *, device="cuda") -> torch.Tensor:
    """This rank's part of the whole tensor ``t`` under ``spec``, on
    ``device`` (``"cuda"`` by default; without a GPU that raises unless
    ``device="cpu"``).  A ``QTensor``: its payload's part and its scale by
    the scale's own spec (whole, as the reference places it), with the
    part's ``start`` in the whole payload."""
    if isinstance(t, QTensor):
        qspec, sspec = _q_specs(spec)
        q = shard(t.q, qspec, rules, device=device)
        cuts = spec_cuts(qspec, rules)
        start = tuple(cuts[d].index * n if d in cuts else 0
                      for d, n in enumerate(q.shape)) if cuts else None
        return QTensor(q, shard(t.scale, sspec, rules, device=device), t.axis, start)
    dev = resolve_device(device)
    cuts = spec_cuts(spec, rules)
    if not cuts:
        return t.to(dev)
    for dim, c in cuts.items():
        n = t.shape[dim]
        if n % c.size:
            raise ValueError(f"dimension {dim} of {tuple(t.shape)} does not divide over "
                             f"{c.axes} ({c.size} ranks)")
        t = t.narrow(dim, c.index * (n // c.size), n // c.size)
    return t.to(dev).clone(memory_format=torch.contiguous_format)


def shard_tree(tree, specs, rules: ShardingRules, *, device="cuda"):
    """This rank's parts of a tree of whole leaves (:func:`shard` on each,
    ``specs`` as :func:`map_specs` reads it)."""
    return map_specs(lambda t, spec: shard(t, spec, rules, device=device), tree, specs)


def unshard(t: torch.Tensor, spec, rules: ShardingRules) -> torch.Tensor:
    """The whole leaf of which ``t`` is this rank's part, gathered over the
    groups of its cut dimensions (a collective: every rank of those groups
    calls it).  A ``QTensor``: its payload and scale made whole."""
    if isinstance(t, QTensor):
        qspec, sspec = _q_specs(spec)
        return QTensor(unshard(t.q, qspec, rules), unshard(t.scale, sspec, rules), t.axis)
    for dim, c in spec_cuts(spec, rules).items():
        t = _all_gather_dim(t, group_of(c), dim)
    return t


def unshard_tree(tree, specs, rules: ShardingRules):
    """The whole leaves of a tree of parts, on every rank (a checkpoint's
    save gathers leaf by leaf with :func:`unshard` and writes on rank 0)."""
    return map_specs(lambda t, spec: unshard(t, spec, rules), tree, specs)


def global_shape(shape: Sequence[int], spec, rules: ShardingRules) -> tuple[int, ...]:
    """The whole leaf's shape from the shape of one rank's part (a
    ``QTensor``'s: its payload's)."""
    out = list(shape)
    for dim, c in spec_cuts(_q_specs(spec)[0], rules).items():
        out[dim] *= c.size
    return tuple(out)


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
        ctx.rank, ctx.rows = dist.get_rank(group), x.shape[0]
        return _all_gather_dim(x, group, 0)

    @staticmethod
    def backward(ctx, g):
        return g[ctx.rank * ctx.rows:(ctx.rank + 1) * ctx.rows], None


def _all_gather_dim(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The parts of ``group``'s ranks, in rank order, joined along ``dim``."""
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=dim)


class _GatherDim(torch.autograd.Function):
    """Forward all-gather along ``dim`` over a cut's group, backward this
    rank's part of the gradient: a cut leaf (or activation) made whole for
    work every rank of the group then does alike (the gradient each rank
    computes is already the whole one)."""

    @staticmethod
    def forward(ctx, x, cut, dim):
        ctx.index, ctx.n, ctx.dim = cut.index, x.shape[dim], dim
        return _all_gather_dim(x, group_of(cut), dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.index * ctx.n, ctx.n), None, None


class _GatherPartials(torch.autograd.Function):
    """Forward all-gather along ``dim`` over a cut's group, backward
    reduce-scatter: a cut tensor made whole for work each rank of the group
    does only in part (its own heads' columns, and a share of the columns
    every rank reads), so the gradient of the whole that each rank computes
    is a partial sum, and a part's gradient is the sum over the ranks of
    their gradients of that part.  (``_GatherDim``'s backward keeps this
    rank's slice of its own gradient, which is right only where every rank
    computes the whole gradient alike.)"""

    @staticmethod
    def forward(ctx, x, cut, dim):
        ctx.group, ctx.dim = group_of(cut), dim
        return _all_gather_dim(x, ctx.group, dim)

    @staticmethod
    def backward(ctx, g):
        parts = [p.contiguous() for p in g.chunk(dist.get_world_size(ctx.group), dim=ctx.dim)]
        out = torch.empty_like(parts[0])
        dist.reduce_scatter(out, parts, group=ctx.group)
        return out, None, None


class _SumPartials(torch.autograd.Function):
    """Forward all-reduce (sum), backward all-reduce: partial sums (a norm's
    sum of squares over this rank's channels) combined into a value that
    each rank then uses on its own share (its channels), so the gradient
    each rank computes for the sum is partial as well.  (``_ReduceFrom``'s
    identity backward is right only where every rank uses the sum alike.)"""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        x = x.contiguous().clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)  # never reduce autograd's own buffer
        dist.all_reduce(g, group=ctx.group)
        return g, None


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
    """A whole ``QTensor`` takes no gradient, so it enters as it is."""
    return x if group is None or isinstance(x, QTensor) else _CopyTo.apply(x, group)


def reduce_from(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _ReduceFrom.apply(x, group)


def gather_from(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _GatherFrom.apply(x, group)


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _AllToAll.apply(x, group)


def gather_dim(x, cut: Optional[Cut], dim: int):
    """``x`` joined with the other parts of ``cut`` along ``dim`` (an
    identity for ``cut`` ``None``); the backward keeps this rank's part.
    A ``QTensor``: its payload joined (the scale is whole already)."""
    if cut is None:
        return x
    if isinstance(x, QTensor):
        dim %= x.q.ndim
        start = None if x.start is None else tuple(0 if i == dim else s
                                                   for i, s in enumerate(x.start))
        return QTensor(_all_gather_dim(x.q, group_of(cut), dim), x.scale, x.axis, start)
    return _GatherDim.apply(x, cut, dim % x.ndim)


def gather_partials(x, cut: Optional[Cut], dim: int):
    """``x`` joined with the other parts of ``cut`` along ``dim`` (an
    identity for ``cut`` ``None``) for work each rank does in part: the
    backward sums the ranks' gradients and keeps this rank's part (a
    reduce-scatter).  A ``QTensor`` (which takes no gradient): its payload
    joined, as :func:`gather_dim` joins it."""
    if cut is None:
        return x
    if isinstance(x, QTensor):
        return gather_dim(x, cut, dim)
    return _GatherPartials.apply(x, cut, dim % x.ndim)


def sum_partials(x: torch.Tensor, cut: Optional[Cut]) -> torch.Tensor:
    """The sum over ``cut``'s group of each rank's partial ``x`` (an
    identity for ``cut`` ``None``), for a value each rank uses on its own
    share: the backward sums the ranks' gradients too."""
    return x if cut is None else _SumPartials.apply(x, group_of(cut))


def group_of(cut: Optional[Cut]):
    """A cut's process group, ``None`` for a whole leaf (where every
    collective is an identity).  A cut over ranks that have no process
    group (a mesh that is not a ``DeviceMesh``) raises: its parts cannot be
    combined, and the program of whole parameters is not a fallback."""
    if cut is None:
        return None
    if cut.group is None:
        raise RuntimeError(f"a cut over {cut.axes} ({cut.size} ranks) has no process group: "
                           "build the mesh over an initialised torch.distributed world")
    return cut.group


__all__ = [
    "STREAM_AXIS", "StreamMesh", "stream_mesh", "DEFAULT_RULES", "LONG_CONTEXT_OVERRIDES",
    "HostMesh", "ShardingRules", "active_rules", "use_rules", "kv_seq_axis", "constrain",
    "is_logical_leaf", "tree_shardings", "mesh_shape", "copy_to",
    "reduce_from", "gather_from", "all_to_all", "Cut", "spec_cuts", "spec_cut", "dim_cut", "batch_cut",
    "to_cache_rows", "map_specs", "shard", "shard_tree", "unshard", "unshard_tree",
    "global_shape", "gather_dim", "gather_partials", "sum_partials", "group_of",
]
