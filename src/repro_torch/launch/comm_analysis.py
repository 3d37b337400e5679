"""Collective-traffic accounting of an eager step, for the roofline.

Counterpart of ``repro/launch/hlo_analysis.py``.  The reference parses the
collectives out of XLA's partitioned HLO text; the port has no HLO: its
step issues each collective from Python through ``torch.distributed``,
which reaches the dispatcher as a ``c10d`` op.  :class:`CollectiveMode`, a
``TorchDispatchMode``, records every such op the step issues (on real or
fake tensors, on any backend): the op, the size of its process group, its
operand and result bytes by dtype.

Conventions, as the reference's:

* the bytes are this rank's (the tensors a rank passes are its own), so
  the sum is per-device traffic;
* an op counts ``max(operand bytes, result bytes)``, which covers
  all-gather (result larger) and reduce-scatter (operand larger) alike,
  times ``_WIRE_FACTOR``: 2 for all-reduce (a ring's reduce-scatter plus
  all-gather), 1 for the rest.

Left out: the reference's loop factors (a collective inside a while body
appears once in HLO text and is scaled by trip counts) are not needed,
because the port's loops run in Python and every issue is recorded; wire
factors of particular algorithms beyond the ring convention (trees,
NVLink SHARP, hierarchical all-reduce) are not modelled.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Any

import torch
from torch.utils._python_dispatch import TorchDispatchMode

#: dtype names of the reference's HLO text (its ``by_dtype`` keys)
_DTYPE_NAMES = {
    torch.bool: "pred", torch.int8: "s8", torch.uint8: "u8", torch.int16: "s16",
    torch.int32: "s32", torch.int64: "s64", torch.bfloat16: "bf16", torch.float16: "f16",
    torch.float32: "f32", torch.float64: "f64", torch.complex64: "c64",
    torch.complex128: "c128",
}

#: ``c10d`` op -> the reference's collective name
_OPS = {
    "allreduce_": "all-reduce",
    "allgather_": "all-gather",
    "_allgather_base_": "all-gather",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "alltoall_": "all-to-all",
    "alltoall_base_": "all-to-all",
    "send": "collective-permute",
    "recv_": "collective-permute",
}

# wire-traffic multiplier per op (ring algorithms)
_WIRE_FACTOR = {
    "all-reduce": 2.0,  # reduce-scatter + all-gather
    "all-gather": 1.0,
    "reduce-scatter": 1.0,
    "all-to-all": 1.0,
    "collective-permute": 1.0,
}

#: schema arguments that carry an op's operand and its result; an
#: in-place op's ``tensors`` are both
_OPERANDS = ("input", "input_tensor", "input_tensors", "tensors")
_RESULTS = ("output", "output_tensor", "output_tensors", "tensors")


def _tensors(value) -> list[torch.Tensor]:
    if isinstance(value, torch.Tensor):
        return [value]
    if isinstance(value, (list, tuple)):
        return [t for v in value for t in _tensors(v)]
    return []


def tensor_bytes_by_dtype(tensors) -> dict[str, int]:
    out: dict[str, int] = defaultdict(int)
    for t in _tensors(tensors):
        out[_DTYPE_NAMES.get(t.dtype, str(t.dtype))] += t.numel() * t.element_size()
    return dict(out)


def _group_size(args) -> int | None:
    from torch._C._distributed_c10d import ProcessGroup

    for a in args:
        if isinstance(a, torch.ScriptObject):
            try:
                return ProcessGroup.unbox(a).size()
            except (RuntimeError, TypeError):
                continue
    return None


def record(func, args, kwargs) -> dict[str, Any] | None:
    """One ``c10d`` collective's record, or ``None`` for any other op (and
    for ``c10d`` ops outside :data:`_OPS`, such as ``barrier``)."""
    if func.namespace != "c10d":
        return None
    op = _OPS.get(func._schema.name.split("::")[-1])
    if op is None:
        return None
    named = dict(zip((a.name for a in func._schema.arguments), args))
    named.update(kwargs or {})
    operand = {k: v for n in _OPERANDS if n in named
               for k, v in tensor_bytes_by_dtype(named[n]).items()}
    result = {k: v for n in _RESULTS if n in named
              for k, v in tensor_bytes_by_dtype(named[n]).items()}
    return {"op": op, "group_size": _group_size(args), "operand_bytes": operand,
            "result_bytes": result}


def collective_bytes(records: list[dict]) -> dict:
    """Per-device collective traffic by op (bytes) and op counts, from
    :func:`record`'s records: the reference's ``collective_bytes`` keys
    (``per_op_bytes``, ``counts``, ``by_dtype``, ``total_bytes``) and the
    count of each op by group size (``group_sizes``)."""
    per_op: dict[str, float] = defaultdict(float)
    counts: dict[str, int] = defaultdict(int)
    by_dtype: dict[str, float] = defaultdict(float)
    sizes: dict[str, dict[str, int]] = defaultdict(lambda: defaultdict(int))
    for r in records:
        op, f = r["op"], _WIRE_FACTOR[r["op"]]
        in_b, out_b = sum(r["operand_bytes"].values()), sum(r["result_bytes"].values())
        per_op[op] += max(in_b, out_b) * f
        counts[op] += 1
        sizes[op][str(r["group_size"])] += 1
        for dt, b in (r["result_bytes"] if out_b >= in_b else r["operand_bytes"]).items():
            by_dtype[dt] += b * f
    return {
        "per_op_bytes": dict(per_op),
        "counts": dict(counts),
        "by_dtype": dict(by_dtype),
        "group_sizes": {op: dict(v) for op, v in sizes.items()},
        "total_bytes": float(sum(per_op.values())),
    }


class CollectiveMode(TorchDispatchMode):
    """Records every collective dispatched inside it; :meth:`result` sums
    them as :func:`collective_bytes` does."""

    def __init__(self):
        super().__init__()
        self.records: list[dict] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        rec = record(func, args, kwargs)
        if rec is not None:
            self.records.append(rec)
        return func(*args, **(kwargs or {}))

    def result(self) -> dict:
        return collective_bytes(self.records)
