"""The serving mesh: the devices a sharded forward splits its rows over.

Counterpart of ``STREAM_AXIS`` and ``stream_mesh`` in
``repro/distributed/sharding.py``.  There a mesh is a ``jax.sharding.Mesh``
of the local devices; here it is a :class:`StreamMesh`, an ordered list of
``torch.device`` entries on one named axis, which is all the serving layer
reads of it (``shape[axis]`` and ``axis_names``).  The reference's
logical-axis rules for the LM stack are not ported with it.

An entry is a place a shard runs, not necessarily a device of its own: a
mesh built by hand may repeat a device, so one card runs ``k`` shards one
after another (``StreamMesh(("cuda:0",) * k)``), and
``stream_mesh(k, device="cpu")`` gives ``k`` CPU entries, the counterpart
of the reference's forced host devices.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels.backend import resolve_device

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


__all__ = ["STREAM_AXIS", "StreamMesh", "stream_mesh"]
