"""The program's own spans in a profiler trace: device time by layer, and the
host's waits on the card split from its issue time.

    python3 perfbench/program_spans.py --workload <cell> --seed <n> [--seconds 2] [--spans 1]

runs a cell as a ``--trace 1`` run does (``harness.run_cell``) with the
program's spans recorded in its traced segment, and prints the run's
result line with a ``program`` object beside the harness's metrics, and
the tables below on standard error.  ``--spans 0`` runs the same without
them, so that the two give the spans' cost under the profiler.

The port marks ``serving/accelerator.forward_quantized`` with spans named
:data:`PROGRAM_PREFIX` ``+ name`` (``repro_torch.kernels.backend.span``:
``forward``; ``conv{i}`` and ``dense{i}`` with their ``.quantize``,
``.kernel`` and ``.pool``; ``input``, ``flatten``, ``softmax``), recorded
inside ``backend.program_spans()`` while a profiler runs.  :func:`reduce`
keeps, from the raw events of a traced segment:

* the harness's :class:`tracing.Trace` of the same events without the
  program's spans (host spans and their shadows on the device), so every
  metric of the benchmark reads as it does without them;
* each device op with the innermost program span open when its launch
  started on the host: the runtime call with the op's ``correlation_id``
  (CUPTI's, shared by a launch and its kernel), else the operator whose
  ``correlation_id`` is the op's ``linked_correlation_id``; ops under no
  program span are unattributed (the harness's staging and result copies);
* the blocking runtime calls (:data:`BLOCKING`) inside a
  ``repro_torch.forward`` span, each with its host duration and its
  innermost span;
* the idle gaps of the card labelled by the innermost program span half
  way through each, with the outermost operator or runtime call under it.

The benchmark's harness does not read these yet (``PERF.md``, open
questions: which of its files take which edit).
"""
from __future__ import annotations

import sys
from pathlib import Path

if __name__ == "__main__":
    sys.path[0:1] = [str(Path(__file__).resolve().parents[1]),
                     str(Path(__file__).resolve().parents[1] / "src")]

import argparse  # noqa: E402
import bisect  # noqa: E402
import dataclasses  # noqa: E402
import json  # noqa: E402
import re  # noqa: E402

import numpy as np  # noqa: E402

from perfbench import spec, tracing  # noqa: E402

#: prefix of the program's spans: ``repro_torch.kernels.backend.SPAN_PREFIX``,
#: written out here because the harness does not import the port
PROGRAM_PREFIX = "repro_torch."
FORWARD = PROGRAM_PREFIX + "forward"
#: runtime calls that return only when the card has caught up (or, for
#: ``cudaMemcpy``, when the copy is done)
BLOCKING = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
            "cudaMemcpy")
#: CUDA runtime and driver API calls
_RUNTIME = re.compile(r"cu(da)?[A-Z]")
#: the five per-layer metrics the program's spans give, by name
METRICS = ("quantize_device_ms_per_block", "pool_device_ms_per_block",
           "float_layers_device_ms_per_block", "host_sync_wait_ms_per_block",
           "host_issue_ms_per_block")


@dataclasses.dataclass(frozen=True)
class Span:
    name: str
    start_ns: int
    end_ns: int


@dataclasses.dataclass(frozen=True)
class Sync:
    """A blocking runtime call inside a forward: its innermost span and the
    index of its ``repro_torch.forward`` span."""

    name: str
    dur_ns: int
    span: str
    forward: int


@dataclasses.dataclass
class ProgramTrace:
    """The program's spans of one traced segment of ``blocks`` forwards."""

    blocks: int
    #: every ``repro_torch.forward`` span, in order
    forwards: list[Span]
    #: each device op of the segment and its innermost program span (None:
    #: launched under none)
    device_ops: list[tuple[tracing.DeviceOp, str | None]]
    syncs: list[Sync]
    #: idle gaps: (seconds, innermost program span > outermost host call)
    gaps: list[tuple[float, str]]

    def device_ms_per_block(self, keep) -> float:
        """Device ms a block of the ops whose span name satisfies ``keep``."""
        ns = sum(op.dur_ns for op, name in self.device_ops if name is not None and keep(name))
        return ns / self.blocks / 1e6

    def by_span(self) -> dict[str, float]:
        """Device ms a block by innermost program span; the ops under none
        by whether they are the harness's copies."""
        out: dict[str, float] = {}
        for op, name in self.device_ops:
            if name is None:
                name = ("(the harness's copies)" if op.name.startswith(tracing.HARNESS_COPIES)
                        else "(no program span)")
            else:
                name = name[len(PROGRAM_PREFIX):]
            out[name] = out.get(name, 0.0) + op.dur_ns / self.blocks / 1e6
        return out

    def unattributed(self) -> list[str]:
        """Names of the datapath's device ops launched under no program span."""
        return sorted({op.name for op, name in self.device_ops
                       if name is None and not op.name.startswith(tracing.HARNESS_COPIES)})

    def per_forward(self) -> tuple[np.ndarray, np.ndarray]:
        """Each forward's host issue time and its blocking calls' wait, ms."""
        wait = np.zeros(len(self.forwards))
        for s in self.syncs:
            wait[s.forward] += s.dur_ns / 1e6
        span = np.array([(f.end_ns - f.start_ns) / 1e6 for f in self.forwards])
        return span - wait, wait

    def metrics(self, float_layers) -> dict[str, float | None]:
        """The five metrics (:data:`METRICS`); None where the trace holds no
        program span, and the float layers' where ``float_layers`` (layer
        names) is empty."""
        if not self.forwards:
            return dict.fromkeys(METRICS)
        kernels = {f"{PROGRAM_PREFIX}{n}.kernel" for n in float_layers}
        issue, wait = self.per_forward()
        return {
            "quantize_device_ms_per_block": self.device_ms_per_block(
                lambda n: n.endswith(".quantize")),
            "pool_device_ms_per_block": self.device_ms_per_block(lambda n: n.endswith(".pool")),
            "float_layers_device_ms_per_block": (
                self.device_ms_per_block(kernels.__contains__) if kernels else None),
            "host_sync_wait_ms_per_block": float(wait.sum()) / self.blocks,
            "host_issue_ms_per_block": float(issue.sum()) / self.blocks,
        }

    def tables(self) -> str:
        """The stderr report: device and idle ms a block by span, the
        blocking calls a block, and any datapath op under no span."""
        lines = ["program spans: device ms a block by innermost span"]
        lines += [f"  {name:<28} {ms:.4f}" for name, ms in
                  sorted(self.by_span().items(), key=lambda kv: -kv[1])]
        lines.append("program spans: idle ms a block by innermost span > outermost host call")
        idle: dict[str, float] = {}
        for secs, label in self.gaps:
            idle[label] = idle.get(label, 0.0) + secs * 1e3 / self.blocks
        lines += [f"  {label:<60} {ms:.4f}" for label, ms in
                  sorted(idle.items(), key=lambda kv: -kv[1])[:15]]
        calls: dict[str, int] = {}
        for s in self.syncs:
            key = f"{s.name} under {s.span[len(PROGRAM_PREFIX):]}"
            calls[key] = calls.get(key, 0) + 1
        lines.append(f"program spans: {len(self.syncs) / self.blocks:.2f} blocking calls a block"
                     + "".join(f"; {k} {n / self.blocks:.2f}" for k, n in sorted(calls.items())))
        missing = self.unattributed()
        if missing:
            lines.append("program spans: datapath ops under no span: " + ", ".join(missing))
        return "\n".join(lines)


class _Innermost:
    """The innermost of properly nested spans open at a time: a sweep over
    their starts and ends gives, from each boundary on, the span that is
    innermost until the next one."""

    def __init__(self, spans: list[Span]):
        order = sorted(range(len(spans)), key=lambda i: (spans[i].start_ns, -spans[i].end_ns))
        self.spans, self.times, self.owners = spans, [], []
        stack: list[int] = []

        def close_until(t):
            while stack and spans[stack[-1]].end_ns <= t:
                self.times.append(spans[stack.pop()].end_ns)
                self.owners.append(stack[-1] if stack else -1)

        for i in order:
            close_until(spans[i].start_ns)
            stack.append(i)
            self.times.append(spans[i].start_ns)
            self.owners.append(i)
        close_until(float("inf"))

    def at(self, t: int) -> Span | None:
        k = bisect.bisect_right(self.times, t) - 1
        return None if k < 0 or self.owners[k] < 0 else self.spans[self.owners[k]]


def _id(e, attr: str) -> int:
    """A correlation id of a raw event; 0 where the event has none."""
    get = getattr(e, attr, None)
    return int(get()) if get is not None else 0


def _is_program(e) -> bool:
    return e.name().startswith(PROGRAM_PREFIX)


def reduce(events, blocks: int) -> tuple[tracing.Trace, ProgramTrace]:
    """The harness's :class:`tracing.Trace` of the raw events without the
    program's spans, and the :class:`ProgramTrace` of those spans."""
    from torch.autograd import DeviceType

    events = list(events)
    trace = tracing.reduce([e for e in events if not _is_program(e)], blocks)
    window, device, spans, host = None, [], [], []
    runtime: dict[int, int] = {}  # CUPTI correlation id -> the call's host start
    ops: dict[int, int] = {}  # the profiler's operator id -> its host start
    for e in events:
        name, start, dur = e.name(), int(e.start_ns()), int(e.duration_ns())
        if e.device_type() == DeviceType.CUDA:
            if not (tracing._annotation(e) or _is_program(e)):
                device.append((tracing.DeviceOp(name, start, dur), _id(e, "correlation_id"),
                               _id(e, "linked_correlation_id")))
        elif name == tracing.TRACED:
            window = (start, start + dur)
        elif _is_program(e):
            spans.append(Span(name, start, start + dur))
        else:
            host.append((start, start + dur, name))
            if _RUNTIME.match(name):
                runtime[_id(e, "correlation_id")] = start
            elif _id(e, "correlation_id"):
                ops[_id(e, "correlation_id")] = start
    device = sorted((d for d in device if window[0] <= d[0].start_ns < window[1]),
                    key=lambda d: d[0].start_ns)
    inner = _Innermost(spans)
    attributed = []
    for op, corr, linked in device:
        t = runtime.get(corr) if corr else None
        if t is None and linked:
            t = ops.get(linked)
        span = inner.at(t) if t is not None else None
        attributed.append((op, span.name if span else None))
    forwards = sorted((s for s in spans if s.name == FORWARD), key=lambda s: s.start_ns)
    starts = [f.start_ns for f in forwards]
    syncs = []
    for start, end, name in host:
        span = inner.at(start) if name in BLOCKING else None
        if span is not None:
            k = bisect.bisect_right(starts, start) - 1
            if k >= 0 and start < forwards[k].end_ns:
                syncs.append(Sync(name, end - start, span.name, k))
    gaps = _gaps([op for op, _, _ in device], window, inner, host)
    return trace, ProgramTrace(blocks, forwards, attributed, syncs, gaps)


def _gaps(device, window, inner: _Innermost, host) -> list[tuple[float, str]]:
    """The card's idle gaps inside the window, each labelled by the
    innermost program span half way through it and the outermost operator
    or runtime call under that span then."""
    busy = tracing._union([(op.start_ns, op.start_ns + op.dur_ns) for op in device])
    calls = [h for h in host if not h[2].startswith(tracing.SPAN_PREFIX)]
    starts = np.array([c[0] for c in calls], np.int64)
    ends = np.array([c[1] for c in calls], np.int64)
    gaps, prev = [], window[0]
    for s, e in busy + [(window[1], window[1])]:
        if s > prev:
            t = (prev + s) // 2
            span = inner.at(t)
            if span is None:
                label = "outside the program"
            else:
                live = [calls[i] for i in np.nonzero((starts <= t) & (ends > t))[0]
                        if calls[i][0] >= span.start_ns]
                label = span.name[len(PROGRAM_PREFIX):]
                label += f" > {min(live)[2]}" if live else ""
            gaps.append(((s - prev) / 1e9, label))
        prev = max(prev, e)
    return gaps


def _forward_with_spans(conf, params, device, raw):
    """The program's forward, its spans recorded while a profiler runs."""
    from perfbench.program import Program

    program = Program(conf, params, device, raw=raw)
    backend = sys.modules["repro_torch.kernels.backend"]

    def forward(rows):
        with backend.program_spans():
            return program(rows)

    return forward


def main(argv) -> int:
    from perfbench import harness

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True, help="cell name, <config>.<traffic>")
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=2.0, help="length of the measured window")
    ap.add_argument("--spans", type=int, choices=(0, 1), default=1,
                    help="record the program's spans in the traced segment")
    args = ap.parse_args(argv)
    cell = spec.cell(args.workload)
    programs = []
    plain = tracing.reduce

    def reduce_both(events, blocks):
        tracing.reduce = plain  # reduce() calls the harness's own
        trace, program = reduce(events, blocks)
        programs.append(program)
        return trace

    tracing.reduce = reduce_both
    result = harness.run_cell(cell, args.seed, args.seconds, True,
                              forward_factory=_forward_with_spans if args.spans else None)
    program = programs[0]
    floats = [n for n, m in spec.layer_modes(cell.config).items() if m not in spec.EIGHT_BIT]
    issue, wait = program.per_forward()
    attributed = sum(ms for name, ms in program.by_span().items() if not name.startswith("("))
    datapath = result["metrics"].get("datapath_device_ms_per_block", {}).get("value")
    result["program"] = {
        "spans": bool(args.spans),
        "metrics": program.metrics(floats),
        "attributed_device_ms_per_block": attributed,
        "datapath_device_ms_per_block": datapath,
        "blocking_calls_per_block": len(program.syncs) / program.blocks,
        "forward_ms_per_block": float((issue + wait).sum()) / program.blocks,
        "issue_ms_p50_p95": [float(np.percentile(issue, q)) for q in (50, 95)] if len(issue)
        else None,
        "wait_ms_p50_p95": [float(np.percentile(wait, q)) for q in (50, 95)] if len(wait)
        else None,
        "window_ms_per_block": result["device"].get("window_s", 0.0) * 1e3 / program.blocks,
    }
    print(program.tables(), file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
