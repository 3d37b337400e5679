"""Multi-pod dry run: every (architecture x input shape x mesh) cell traced
on fake tensors, with its FLOPs, bytes, memory and collectives.

Counterpart of ``repro/launch/dryrun.py``.  The reference lowers and
compiles each cell with XLA on 512 forced host devices and reads
``memory_analysis``, ``cost_analysis`` and the collectives of the
partitioned HLO.  The port has no compiler between it and the card: its
step is the eager program itself.  So a cell runs the port's real
``make_train_step``, ``make_prefill_step``, ``make_decode_step`` or
``make_encoder_step`` once, on ``FakeTensorMode`` tensors (shapes, dtypes
and devices, no data, no card memory), as rank 0 of the production mesh of
256 or 512 ranks on the ``fake`` process-group backend, in this process.
Every rank holds what the port's program gives it (``launch/train.py``):
its part of every parameter and Adam moment that ``tree_shardings`` cuts
(the ``"model"`` axis), its data-parallel share of the batch (rows over
the mesh axes of ``"batch"``/``"decode_batch"``), and decode caches cut
where the blocks cut them: the kv heads (and the RWKV and mamba2 states'
heads, ``"heads"`` and ``"ssm_heads"``), and the sequence
(``"kv_seq_model"`` over ``"model"`` where the kv heads do not divide the
model axis; the long-context rules' ``"kv_seq"`` over ``"data"`` and
``"kv_seq_model"`` over both), which the decode's ring-decode attention
combines.  A record's ``"uncut_cache_axes"`` names any cache axis the
reference's rules cut and the port holds whole (none since the mamba2
state is cut).  Int8 ``QTensor`` weights
(``quantize``) are baked whole and placed as the port places them: the
payload cut by the weight's spec, the scale whole.

A cell records:

* ``flops_per_device``: ``torch.utils.flop_counter.FlopCounterMode`` over
  the step (matmuls, convolutions and attention kernels; elementwise work
  is not counted, where XLA's ``cost_analysis`` counts it);
* ``bytes_per_device``: the operand plus result bytes of every op the step
  dispatches, views and allocations without writes left out: the eager
  program's upper bound on its HBM traffic (each op reads its inputs and
  writes its outputs; nothing is fused);
* ``collectives``: every ``c10d`` op the step issues
  (``launch/comm_analysis.py``);
* ``memory``: ``argument_bytes`` (params, optimizer state, batch or
  caches), ``peak_bytes`` (the most bytes of live storage at any point of
  the step, arguments included, each storage rounded up to the CUDA
  caching allocator's 512-byte block: what ``torch.cuda.max_memory_allocated``
  reads over a real step, ``chip_smoke.py`` phase 11) and ``fits_80gb``;
* ``trace_s``.

The reference's two lowering variants, ``fit`` (scanned, for memory) and
``cost`` (unrolled, for FLOPs), exist to get round XLA:CPU; one eager trace
serves both, so ``--variants`` is accepted and recorded, nothing more.

**Extrapolated cells.**  Tracing costs host time per dispatched op.  Two
kinds of cell are traced at reduced sizes and their numbers extrapolated
(the reference's ``_extrapolated_cost``, generalised): a stack deeper than
60 layers (zamba2's 81 blocks) is traced at one and two pattern groups; a
train or prefill cell of an architecture with a time scan (``mamba2``,
``rwkv6``: the port's scans are Python loops of a few dozen ops a time
step, ~10^6 ops a layer at 32,768 positions) is traced at one and two
groups, one and two microbatches (train) and three sequence lengths (two
for a prefill that does not attend: attention is quadratic in the length,
and so is a train step's backward of the scans' per-step slices).  rwkv6's
scan is that loop; mamba2's multi-token scan is chunked
(``mamba2._ssd_chunked``), and a cell longer than one of its chunks is
sampled at whole chunks (one, two and three: :func:`_scan_seq`), where
its FLOPs are a polynomial of degree 2 in the length as its attention's
are.
Each number is the tensor-product Lagrange extrapolation of the sampled
ones to the cell's depth, microbatch count and length, which is exact for
whatever is linear in depth and microbatches and polynomial in the length
to that degree (FLOPs and collectives are; bytes nearly).  The samples
run the cell's program: a mamba2 block takes the route of the cell's own
tokens a rank (``mamba2.route_tokens``), which a shorter sample's would
not (zamba2's train_4k: 8,192 tokens a microbatch a rank take the weight
route, the samples' 128-384 the activation route).  The sampled
lengths run the dense attention path, the full ones the KV-chunked path:
the FLOPs of the two agree at multiples of the chunk.  The peak is an
estimate (``memory["peak_is"]``): it is the largest of the step's phases
(the optimizer's at short lengths, the activations' at long ones), which
no polynomial follows.  So the step's own bytes (peak less arguments),
at the sample with the most microbatches (the step holds one
microbatch's work at a time), are the largest of: the extrapolation
linear in depth and in length through the two longest samples (the
activations' phase), the extrapolation linear in depth alone at each
sampled length (the optimizer's phase, which the length does not change,
shows at the shortest), and every sample's own.  Where the
pattern attends (zamba2), the samples' dense scores do not extrapolate to
the full length's chunked ones (a chunk's scores, rows x heads x length x
1,024 in fp32, are gigabytes at 32,768 positions), so ``fits_80gb`` is
``None`` (undecided) unless the arguments alone exceed 80 GB.

Nothing runs at import: no process group is started and no environment
variable is set.  ``run_cell`` starts (or resizes) a ``fake`` world and
refuses to touch a real one.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma-2b --shape decode_32k \\
        --mesh single --device cpu
    python -m repro_torch.launch.dryrun --arch all --shape all --mesh both   # on the card

Each cell writes ``artifacts/dryrun_torch/<arch>__<shape>__<mesh>.json``.
"""
from __future__ import annotations

import argparse
import dataclasses
import itertools
import json
import math
import time
import traceback
import weakref
from pathlib import Path
from typing import Any, Callable, Optional

import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import get_config, lm_arch_names
from repro_torch.configs.base import ArchConfig
from repro_torch.core.quantization import QTensor
from repro_torch.distributed.sharding import (
    LONG_CONTEXT_OVERRIDES,
    ShardingRules,
    shard_tree,
    tree_shardings,
    use_rules,
)
from repro_torch.kernels.backend import resolve_device
from repro_torch.launch import comm_analysis
from repro_torch.launch.hw import HBM_BYTES
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.specs import SHAPES, ShapeSpec, batch_specs, cache_specs, skip_reason
from repro_torch.models import mamba2 as M2
from repro_torch.models import transformer as T
from repro_torch.training.lm import (
    TrainSettings,
    make_decode_step,
    make_encoder_step,
    make_prefill_step,
    make_train_step,
)
from repro_torch.training.optimizer import Adam

ARTIFACTS = Path(__file__).resolve().parents[3] / "artifacts" / "dryrun_torch"

#: the CUDA caching allocator rounds every block up to a multiple of this
ALLOC_BLOCK = 512
#: deeper stacks are traced at one and two groups (the reference's rule)
DEEP_LAYERS = 60
#: the time-scan blocks, and the sequence lengths a cell holding them is
#: traced at (a multiple of the first, up to its degree + 1)
SCAN_KINDS = ("mamba2", "mamba2_shared", "rwkv6")
SCAN_SEQ = 64
#: logical axes over which a rank holds a share of the data
_DATA_AXES = ("batch", "decode_batch")
#: a decode cache's logical axes the blocks cut (with the data's)
_CACHE_AXES = _DATA_AXES + ("kv_heads", "heads", "ssm_heads", "kv_seq", "kv_seq_model")
#: ops that alias their input or allocate without writing: no bytes moved
_NO_BYTES = ("_unsafe_view", "_reshape_alias", "empty", "empty_like", "empty_strided",
             "new_empty", "new_empty_strided")


# ---------------------------------------------------------------------------
# the step meter: bytes moved and live storage
# ---------------------------------------------------------------------------


def _tensors(value) -> list[torch.Tensor]:
    if isinstance(value, torch.Tensor):
        return [value]
    if isinstance(value, QTensor):
        return [value.q, value.scale]
    if isinstance(value, dict):
        return [t for v in value.values() for t in _tensors(v)]
    if isinstance(value, (list, tuple)):
        return [t for v in value for t in _tensors(v)]
    return []


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class StepMeter(TorchDispatchMode):
    """Bytes moved and live bytes over a step, op by op.

    ``bytes`` sums the operand and result bytes of every ``aten`` op that
    returns a tensor (views and allocations without a write are left out;
    ``c10d`` collectives are counted apart).  ``live`` follows every storage an op creates, rounded up to
    :data:`ALLOC_BLOCK`, until it is freed (a finalizer on the storage
    object, which PyTorch keeps one-to-one with the storage); ``peak`` is
    the most ``live`` has held.  :meth:`track` enters storages made before
    the step (its arguments)."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.live = 0
        self.peak = 0
        self._sizes: dict[int, int] = {}

    def _free(self, key: int) -> None:
        self.live -= self._sizes.pop(key, 0)

    def _hold(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = id(st)
        if key in self._sizes:
            return
        size = -(-st.nbytes() // ALLOC_BLOCK) * ALLOC_BLOCK
        self._sizes[key] = size
        weakref.finalize(st, self._free, key)
        self.live += size
        self.peak = max(self.peak, self.live)

    def track(self, tree) -> int:
        """Hold the storages of ``tree``'s tensors; returns the live bytes."""
        for t in _tensors(tree):
            self._hold(t)
        return self.live

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        results = _tensors(out)
        name = func._schema.name.split("::")[-1]
        if results and func.namespace == "aten" and not (func.is_view or name in _NO_BYTES):
            self.bytes += sum(_nbytes(t) for t in _tensors(args) + _tensors(kwargs) + results)
        for t in results:
            self._hold(t)
        return out


# ---------------------------------------------------------------------------
# cells
# ---------------------------------------------------------------------------


def _local(rules: ShardingRules, logical, meta: torch.Tensor,
           names: Optional[tuple[str, ...]] = None) -> tuple[int, ...]:
    """``meta``'s shape on one rank: each dimension whose logical axis is in
    ``names`` (every cut dimension when ``None``) divided over the mesh
    axes its spec gives it (the divisibility fallback keeps it whole)."""
    spec = rules.spec(logical, dims=tuple(meta.shape))
    shape = []
    for dim, name, axes in zip(meta.shape, logical, spec):
        if axes is not None and (names is None or name in names):
            dim //= rules.size((axes,) if isinstance(axes, str) else axes)
        shape.append(dim)
    return tuple(shape)


def _empty(shape, dtype, dev) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=dev)


def _materialise(tree, logical, rules: ShardingRules, dev, names=None):
    """Empty tensors like ``tree``'s, each this rank's part of its spec
    (:func:`_local`; ``names=()``: whole), keys in sorted order as
    ``init_from_specs`` builds real params (the functional Adam's leaf
    order, and so the step's peak, follows it)."""
    if isinstance(tree, dict):
        return {k: _materialise(tree[k], logical[k], rules, dev, names) for k in sorted(tree)}
    return _empty(_local(rules, logical, tree, names), tree.dtype, dev)


def build_cell(cfg: ArchConfig, shape: ShapeSpec, rules: ShardingRules, n_micro: int, *,
               quantize: bool = False, device="cuda") -> tuple[Callable, tuple]:
    """``(fn, args)``: the cell's step function and rank 0's inputs, made
    with ``torch.empty`` on ``device`` (the dry run calls this inside a
    ``FakeTensorMode``, so nothing is allocated).  A decode cell's ``pos``
    is the Python int ``seq_len - 1`` (the step reads it with ``int``)."""
    dev = torch.device(device)
    aparams, logical = T.abstract_params(cfg), T.logical_axes(cfg)
    if quantize:
        # the served int8 weights, baked from the whole (fake) params and
        # placed as ``sharding.shard`` places them: the payload cut by the
        # weight's spec, the scale by its own (whole), the specs
        # ``tree_shardings`` gives over the reference's ``abstract_quantized``
        # trees (whose one scale per channel of the last axis its own scan
        # over stacked groups rejects, so the scales are the bake's)
        if shape.kind == "train":
            raise ValueError("quantize: int8 weights take no gradient step")
        from repro_torch.models.quantized import (
            abstract_quantized,
            default_lm_policy,
            quantize_lm_params,
        )

        policy = default_lm_policy(cfg)
        whole = quantize_lm_params(_materialise(aparams, logical, rules, dev, names=()), policy)
        specs = tree_shardings(rules, *abstract_quantized(aparams, logical, policy),
                               record=False)
        params = shard_tree(whole, specs, rules, device=dev)
        del whole
    else:
        params = _materialise(aparams, logical, rules, dev)
    bspecs, blogical = batch_specs(cfg, shape)
    batch = {k: _empty(_local(rules, blogical[k], v), v.dtype, dev)
             for k, v in bspecs.items() if k != "pos"}
    if shape.kind == "train":
        opt = Adam(lr=1e-4)
        step = make_train_step(cfg, opt, TrainSettings(n_micro=n_micro))
        return step, (params, opt.init(params), batch)
    if shape.kind == "prefill":
        if cfg.is_encoder:
            return make_encoder_step(cfg), (params, batch)
        return make_prefill_step(cfg, max_seq=shape.seq_len), (params, batch)
    acache, clogical = cache_specs(cfg, shape, model_axis_size=rules.shape.get("model", 1))
    caches = _map_logical(lambda a, lg: _empty(_local(rules, lg, a, _CACHE_AXES), a.dtype, dev),
                          acache, clogical)
    return make_decode_step(cfg, max_seq=shape.seq_len), (params, batch["token"], caches,
                                                          shape.seq_len - 1)


def _map_logical(fn, tree, logical):
    """``fn(leaf, its logical axes)`` over a tree and its logical tree."""
    if isinstance(tree, dict):
        return {k: _map_logical(fn, tree[k], logical[k]) for k in tree}
    return fn(tree, logical)


def prepare_groups(rules: ShardingRules) -> None:
    """Build the groups of the data and parameter axes outside any
    ``FakeTensorMode``: a group over several mesh axes is made on first use
    from the mesh's rank tensor, which a fake mode would not take (a
    one-axis group is the mesh's own)."""
    for name in rules.rules:
        axes = rules.mesh_axes_for(name)
        if axes and rules.size(axes) > 1:
            rules.group(axes)


def uncut_cache_axes(cfg: ArchConfig, shape: ShapeSpec, rules: ShardingRules) -> list[str]:
    """The logical axes of a decode cell's caches that the reference's rules
    cut and the port holds whole: those of the caches' axes that
    ``_CACHE_AXES`` leaves out and the rules map to more than one rank
    (none: every cut the reference makes, the port makes)."""
    if shape.kind != "decode":
        return []
    _, clogical = cache_specs(cfg, shape, model_axis_size=rules.shape.get("model", 1))
    axes = {a for lg in _leaves_logical(clogical) for a in lg if a is not None}
    return sorted(a for a in axes - set(_CACHE_AXES)
                  if rules.size(rules.mesh_axes_for(a)) > 1)


def _leaves_logical(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves_logical(v)]
    return [tree]


def trace_cell(cfg: ArchConfig, shape: ShapeSpec, rules: ShardingRules, n_micro: int, *,
               quantize: bool = False, device="cuda") -> dict:
    """Run one cell's step once on fake tensors under ``rules`` and return
    its numbers (the module docstring's keys, unextrapolated)."""
    prepare_groups(rules)
    fake = FakeTensorMode()
    with fake:
        fn, args = build_cell(cfg, shape, rules, n_micro, quantize=quantize, device=device)
    meter, comm = StepMeter(), comm_analysis.CollectiveMode()
    flops = FlopCounterMode(display=False)
    argument = meter.track(args)
    t0 = time.perf_counter()
    with fake, use_rules(rules), flops, comm, meter:
        out = fn(*args)
    trace_s = time.perf_counter() - t0
    del out
    return {
        "n_micro": n_micro if shape.kind == "train" else None,
        "rows_per_device": _rows(shape, args),
        "flops_per_device": float(flops.get_total_flops()),
        "bytes_per_device": float(meter.bytes),
        "collectives": comm.result(),
        "memory": {"argument_bytes": argument, "peak_bytes": meter.peak},
        "trace_s": trace_s,
    }


def _rows(shape: ShapeSpec, args) -> int:
    """The batch rows a rank holds (the data argument's leading dim)."""
    data = args[2] if shape.kind == "train" else args[1]
    return int(_tensors(data)[0].shape[0])


# ---------------------------------------------------------------------------
# extrapolation (deep stacks, time scans)
# ---------------------------------------------------------------------------


def _attends(cfg: ArchConfig) -> bool:
    """Whether a full-sequence step runs attention (zamba2's shared block
    rides in its ``mamba2_shared`` slot)."""
    return cfg.attends or "mamba2_shared" in cfg.pattern


def extrapolation_axes(cfg: ArchConfig, shape: ShapeSpec, n_micro: int) -> list[tuple]:
    """``[(axis, samples, target), ...]`` a cell is extrapolated over, or
    ``[]`` for a full trace (see the module docstring)."""
    scan = shape.kind != "decode" and any(k in SCAN_KINDS for k in cfg.pattern)
    axes = []
    if scan or cfg.n_layers > DEEP_LAYERS:
        axes.append(("groups", (1, 2), cfg.n_groups))
    if scan and shape.kind == "train" and n_micro > 1:
        axes.append(("n_micro", (1, 2), n_micro))
    if scan:
        # quadratic in the length: attention, and a train step's backward of
        # the scans' per-step slices (each writes a zero-filled copy of the
        # whole sequence's tensor)
        degree = 2 if _attends(cfg) or shape.kind == "train" else 1
        axes.append(("seq_len", tuple(_scan_seq(cfg, shape) * (i + 1) for i in range(degree + 1)),
                     shape.seq_len))
    return axes


def _scan_seq(cfg: ArchConfig, shape: ShapeSpec) -> int:
    """The step of the sampled lengths: :data:`SCAN_SEQ`, or mamba2's chunk
    (``mamba2.SSD_CHUNK``) where the cell is longer than one, so that every
    sample runs the chunked scan in whole chunks as the cell does (its
    products with the masked decay grow with the square of a chunk's
    length and with the number of chunks, the recurrence over the chunks
    with that number squared: in whole chunks, a polynomial of degree 2 in
    the length)."""
    mamba = any(k in ("mamba2", "mamba2_shared") for k in cfg.pattern)
    return M2.SSD_CHUNK if mamba and shape.seq_len > M2.SSD_CHUNK else SCAN_SEQ


def _weights(axes, grid) -> list[float]:
    """Tensor-product Lagrange weights of the points of ``grid`` for the
    targets of ``axes`` (``(axis, samples, target)``); a point off the
    samples given for an axis weighs 0."""
    def lagrange(xs, x):
        return {xi: math.prod((x - xj) / (xi - xj) for xj in xs if xj != xi) for xi in xs}

    per_axis = [lagrange(xs, x) for _, xs, x in axes]
    return [math.prod(w.get(v, 0.0) for w, v in zip(per_axis, point)) for point in grid]


def _combine(values: list, weights: list[float]):
    """The weighted sum of same-structure numeric trees."""
    first = values[0]
    if isinstance(first, dict):
        keys = set().union(*values)
        return {k: _combine([v.get(k, 0) for v in values], weights) for k in keys}
    if isinstance(first, (int, float)) and not isinstance(first, bool):
        return float(sum(w * v for w, v in zip(weights, values)))
    return first


def _extrapolated(cfg, shape, rules, n_micro, axes, *, quantize, device) -> dict:
    period = len(cfg.pattern)
    grid = list(itertools.product(*(samples for _, samples, _ in axes)))
    prepare_groups(rules)
    with FakeTensorMode():  # the full-size arguments, built, not run
        _, args = build_cell(cfg, shape, rules, n_micro, quantize=quantize, device=device)
        argument = StepMeter().track(args)
        rows = _rows(shape, args)
    # a rank's tokens a block call at the cell's own size: the samples take
    # the mamba2 route of the cell they stand for, not their own
    tokens = rows * (1 if shape.kind == "decode" else shape.seq_len) // (
        n_micro if shape.kind == "train" else 1)
    samples = []
    with M2.route_tokens(tokens):
        for point in grid:
            knobs = dict(zip((a for a, _, _ in axes), point))
            c = cfg.replace(n_layers=knobs.get("groups", cfg.n_groups) * period)
            m = int(knobs.get("n_micro", n_micro))
            s = dataclasses.replace(shape, seq_len=int(knobs.get("seq_len", shape.seq_len)),
                                    global_batch=shape.global_batch * m // n_micro)
            samples.append(trace_cell(c, s, rules, m, quantize=quantize, device=device))
    weights = _weights(axes, grid)
    # memory, the step's own bytes at the most microbatches: the largest of
    # the peak extrapolated linearly in depth and length (through the two
    # longest samples; the activations' phase), in depth alone at each
    # sampled length (the optimizer's phase, which the length does not
    # change, shows at the shortest), and any sample's
    temps = [v["memory"]["peak_bytes"] - v["memory"]["argument_bytes"] for v in samples]

    def extrapolated(lengths):
        """``temps`` linear in depth, at the most microbatches, and in
        length through ``lengths`` (two samples) or at it (one)."""
        sel = [(a, (max(xs),), max(xs)) if a == "n_micro" else
               (a, lengths, x if len(lengths) > 1 else lengths[0]) if a == "seq_len" else
               (a, xs, x) for a, xs, x in axes]
        return _combine(temps, _weights(sel, grid))

    lengths = next((xs for a, xs, _ in axes if a == "seq_len"), None)
    candidates = ([extrapolated(lengths[-2:])] + [extrapolated((n,)) for n in lengths]
                  if lengths else [extrapolated(None)])
    temp = max(candidates + temps)
    out = {
        "n_micro": n_micro if shape.kind == "train" else None,
        "rows_per_device": rows,
        "flops_per_device": _combine([v["flops_per_device"] for v in samples], weights),
        "bytes_per_device": _combine([v["bytes_per_device"] for v in samples], weights),
        "collectives": _combine([v["collectives"] for v in samples], weights),
        "memory": {"argument_bytes": argument,
                   "peak_bytes": argument + temp},
        "trace_s": sum(v["trace_s"] for v in samples),
        "extrapolated": {a: {"samples": list(xs), "target": x} for a, xs, x in axes},
    }
    out["memory"]["peak_is"] = "estimate"
    if any(a == "seq_len" for a, _, _ in axes) and _attends(cfg):
        out["memory"]["peak_is"] = ("estimate without attention's scores: the sampled lengths "
                                    "run dense attention, the full length the KV-chunked path")
    return out


# ---------------------------------------------------------------------------
# the fake world and one cell
# ---------------------------------------------------------------------------


def fits(memory: dict) -> Optional[bool]:
    """Whether a cell's peak fits one card's 80 GB; ``None`` (undecided)
    where the estimate leaves attention's scores out and the arguments
    alone fit."""
    if "attention" in memory.get("peak_is", ""):
        return None if memory["argument_bytes"] <= HBM_BYTES else False
    return memory["peak_bytes"] <= HBM_BYTES


def fake_world(n_ranks: int) -> None:
    """Make this process rank 0 of an ``n_ranks`` world on the ``fake``
    backend (starting it, or resizing one the dry run started).  A real
    process group is never touched: that raises."""
    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError("the dry run needs a process of its own: a "
                               f"{dist.get_backend()!r} process group is initialised")
        if dist.get_world_size() == n_ranks:
            return
        dist.destroy_process_group()
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n_ranks)


def run_cell(
    arch: str,
    shape_name: str,
    multi_pod: bool,
    *,
    n_micro: int = 8,
    variants: tuple[str, ...] = ("fit", "cost"),
    rules_overrides: Optional[dict] = None,
    cfg_overrides: Optional[dict] = None,
    quantize: bool = False,
    tag: str = "",
    out_dir: Path = ARTIFACTS,
    verbose: bool = True,
    device="cuda",
) -> dict:
    """One (arch x shape x mesh) cell on the production mesh (256 ranks,
    or 512 with ``multi_pod``), traced as rank 0; writes and returns its
    record.  A cell that fails is recorded with ``status="error"``."""
    shape = SHAPES[shape_name]
    cfg = get_config(arch)
    if cfg_overrides:
        cfg = cfg.replace(**cfg_overrides)
    mesh_name = "multipod_2x16x16" if multi_pod else "pod_16x16"
    rec: dict[str, Any] = {"arch": arch, "shape": shape_name, "mesh": mesh_name, "tag": tag,
                           "variants": list(variants)}
    reason = skip_reason(cfg, shape)
    if reason:
        rec.update(status="skip", reason=reason)
        _write(rec, out_dir)
        if verbose:
            print(f"[skip] {arch} x {shape_name} x {mesh_name}: {reason}")
        return rec
    dev = resolve_device(device)
    rec.update(device=str(dev), n_params=T.param_count(cfg),
               n_params_active=T.active_param_count(cfg))
    try:
        fake_world(512 if multi_pod else 256)
        mesh = make_production_mesh(multi_pod=multi_pod, device=dev)
        overrides = dict(rules_overrides or {})
        if shape.name == "long_500k":
            overrides = {**LONG_CONTEXT_OVERRIDES, **overrides}
        rules = ShardingRules(mesh, overrides)
        axes = extrapolation_axes(cfg, shape, n_micro)
        if axes:
            v = _extrapolated(cfg, shape, rules, n_micro, axes, quantize=quantize, device=dev)
        else:
            v = trace_cell(cfg, shape, rules, n_micro, quantize=quantize, device=dev)
        v["memory"]["fits_80gb"] = fits(v["memory"])
        v["uncut_cache_axes"] = uncut_cache_axes(cfg, shape, rules)
        v["fallbacks"] = sorted(set(map(tuple, rules.fallbacks)))
        rec.update(v, status="ok")
        if verbose:
            print(f"[ok] {arch} x {shape_name} x {mesh_name} trace={v['trace_s']:.1f}s "
                  f"flops/dev={v['flops_per_device']:.3e} bytes/dev={v['bytes_per_device']:.3e} "
                  f"coll={v['collectives']['total_bytes']:.3e}B "
                  f"peak={v['memory']['peak_bytes'] / 2**30:.2f}GiB"
                  f"{' (extrapolated)' if 'extrapolated' in v else ''}")
    except Exception as e:  # noqa: BLE001 -- a failing cell is a fault we record
        rec.update(status="error", error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-4000:])
        if verbose:
            print(f"[ERR] {arch} x {shape_name} x {mesh_name}: {e}")
    _write(rec, out_dir)
    return rec


def _write(rec: dict, out_dir: Path) -> None:
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    tag = f"__{rec['tag']}" if rec.get("tag") else ""
    path = out_dir / f"{rec['arch']}__{rec['shape']}__{rec['mesh']}{tag}.json"
    path.write_text(json.dumps(rec, indent=1, default=str))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--variants", default="fit,cost",
                    help="recorded only: one eager trace serves the reference's fit and cost")
    ap.add_argument("--n-micro", type=int, default=8)
    ap.add_argument("--tag", default="")
    ap.add_argument("--out", default=str(ARTIFACTS))
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    archs = lm_arch_names() if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]
    results = []
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                results.append(run_cell(arch, shape, mp, n_micro=args.n_micro,
                                        variants=tuple(args.variants.split(",")), tag=args.tag,
                                        out_dir=Path(args.out), device=args.device))
    n = {s: sum(r["status"] == s for r in results) for s in ("ok", "skip", "error")}
    print(f"\n=== dry-run summary: {n['ok']} ok, {n['skip']} skip, {n['error']} error ===")
    if n["error"]:
        for r in results:
            if r["status"] == "error":
                print(f"  FAILED {r['arch']} x {r['shape']} x {r['mesh']}: {r['error']}")
        raise SystemExit(1)


if __name__ == "__main__":
    main()
