"""Reduction of a profiler trace to what the metric readers read.

A ``--trace 1`` run profiles a segment of blocks with
``torch.profiler`` (CPU and CUDA activities: CUPTI on the card).  The
harness marks its own host phases with ``record_function`` spans named
``perfbench.<phase>`` and the whole segment with ``perfbench.traced``.  This
module keeps, from the raw events:

* every device activity (kernels, copies, memsets) with its name, start
  and duration;
* the union of the device's busy intervals, and the idle gaps between them
  inside the traced segment, each labelled with what the host was doing
  half way through it: the innermost harness phase and the outermost
  operator under it;
* the program's own spans (``record_function`` spans named
  ``repro_torch.<name>``, :data:`PROGRAM_PREFIX`) by name: their count, the
  host time they span, and the time their shadows span on the device
  timeline (each from its first device op's start to its last op's end).
  They are neither device work nor operators: no busy interval, idle gap
  label or device op reads them, so a trace with them reads as without.
"""
from __future__ import annotations

import dataclasses

import numpy as np

#: prefix of the harness's own spans
SPAN_PREFIX = "perfbench."
#: prefix of the program's spans (``repro_torch.kernels.backend.SPAN_PREFIX``,
#: written out here because the harness does not import the port)
PROGRAM_PREFIX = "repro_torch."
#: the span around the whole traced segment
TRACED = SPAN_PREFIX + "traced"
#: the harness's own copies (block staging, probabilities home): not the datapath's
HARNESS_COPIES = ("Memcpy HtoD (Pinned", "Memcpy DtoH (Device -> Pinned")
#: longest kernel name kept in a breakdown
NAME_CHARS = 96


@dataclasses.dataclass(frozen=True)
class DeviceOp:
    name: str
    start_ns: int
    dur_ns: int


@dataclasses.dataclass
class SpanTime:
    """One program span's name over a traced segment: how often it opened,
    the host seconds it spanned, and the seconds its shadows spanned on the
    device timeline (0 where it launched nothing)."""

    calls: int = 0
    host_s: float = 0.0
    device_s: float = 0.0


@dataclasses.dataclass
class Trace:
    """One traced segment of ``blocks`` forwards (or decode steps)."""

    blocks: int
    window_s: float
    device_ops: list[DeviceOp]
    busy_s: float
    #: idle gaps: (seconds, host label)
    gaps: list[tuple[float, str]]
    #: the program's spans by name (:data:`PROGRAM_PREFIX` included)
    spans: dict[str, SpanTime] = dataclasses.field(default_factory=dict)

    def kernel_seconds(self, *names: str) -> tuple[float, int]:
        """Summed seconds and launch count of the device ops whose name holds
        any of ``names``."""
        hits = [op.dur_ns for op in self.device_ops if any(n in op.name for n in names)]
        return sum(hits) / 1e9, len(hits)

    def datapath_seconds(self) -> float:
        """Device seconds of everything but the harness's own copies."""
        return sum(op.dur_ns for op in self.device_ops
                   if not op.name.startswith(HARNESS_COPIES)) / 1e9

    def breakdown(self, top: int = 10) -> dict:
        """The device ops that took most time, by name, and the idle time by
        what the host was doing."""
        by_op: dict[str, float] = {}
        for op in self.device_ops:
            key = op.name[:NAME_CHARS]
            by_op[key] = by_op.get(key, 0.0) + op.dur_ns / 1e9
        by_gap: dict[str, float] = {}
        for secs, label in self.gaps:
            by_gap[label] = by_gap.get(label, 0.0) + secs
        ordered = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]
        return {"device_ops": ordered(by_op), "idle_gaps": ordered(by_gap)}


def _union(intervals: list[tuple[int, int]]) -> list[tuple[int, int]]:
    merged: list[list[int]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def _label(t: int, cpu: list[tuple[int, int, str]], starts: np.ndarray, ends: np.ndarray) -> str:
    live = np.nonzero((starts <= t) & (ends > t))[0]
    spans = [cpu[i] for i in live if cpu[i][2].startswith(SPAN_PREFIX) and cpu[i][2] != TRACED]
    ops = [cpu[i] for i in live if not cpu[i][2].startswith(SPAN_PREFIX)]
    phase = max(spans)[2][len(SPAN_PREFIX):] if spans else "between phases"
    if spans:  # operators inside the innermost phase
        ops = [o for o in ops if o[0] >= max(spans)[0]]
    return f"{phase} > {min(ops)[2]}" if ops else phase


def _annotation(e) -> bool:
    """A host span's shadow on the device timeline, which is no device work
    (older profilers do not flag it: the harness's and the program's spans
    are known by name)."""
    flag = getattr(e, "is_user_annotation", None)
    return bool(flag and flag()) or e.name().startswith((SPAN_PREFIX, PROGRAM_PREFIX))


def reduce(events, blocks: int) -> Trace:
    """A :class:`Trace` of the raw profiler events (``_KinetoEvent``s) of a
    segment of ``blocks`` forwards wrapped in a :data:`TRACED` span."""
    from torch.autograd import DeviceType

    device, cpu, window = [], [], None
    host_spans, device_spans = [], []
    for e in events:
        start, dur = int(e.start_ns()), int(e.duration_ns())
        program = e.name().startswith(PROGRAM_PREFIX)
        if e.device_type() == DeviceType.CUDA:
            if program:
                device_spans.append((start, dur, e.name()))
            elif not _annotation(e):
                device.append(DeviceOp(e.name(), start, dur))
        elif e.name() == TRACED:
            window = (start, start + dur)
        elif program:  # kept apart: the idle gaps' labels read no program span
            host_spans.append((start, dur, e.name()))
        else:
            cpu.append((start, start + dur, e.name()))
    if window is None:
        raise RuntimeError(f"the trace holds no {TRACED!r} span")
    spans: dict[str, SpanTime] = {}
    for start, dur, name in host_spans:
        if window[0] <= start < window[1]:
            t = spans.setdefault(name, SpanTime())
            t.calls += 1
            t.host_s += dur / 1e9
    for start, dur, name in device_spans:
        if window[0] <= start < window[1]:
            spans.setdefault(name, SpanTime()).device_s += dur / 1e9
    device = [op for op in device if window[0] <= op.start_ns < window[1]]
    device.sort(key=lambda op: op.start_ns)
    busy = _union([(op.start_ns, op.start_ns + op.dur_ns) for op in device])
    starts = np.array([c[0] for c in cpu], np.int64)
    ends = np.array([c[1] for c in cpu], np.int64)
    gaps, prev = [], window[0]
    for s, e in busy + [(window[1], window[1])]:
        if s > prev:
            gaps.append(((s - prev) / 1e9, _label((prev + s) // 2, cpu, starts, ends)))
        prev = max(prev, e)
    return Trace(
        blocks=blocks,
        window_s=(window[1] - window[0]) / 1e9,
        device_ops=device,
        busy_s=sum(e - s for s, e in busy) / 1e9,
        gaps=gaps,
        spans=spans,
    )
