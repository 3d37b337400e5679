"""One run of one cell: set-up, the measured window, the traced segment,
the comparison with the reference, and the result line.

:func:`main` finds the cell's program by name (``perfbench/programs/
<program>.py``, :func:`load_program`) and calls its ``run_cell``; the look
for a card, the check for JAX in the process and the printed checks are
shared by every program.  This module holds the detector's program
(``programs/detector.py`` calls :func:`run_cell`):

The window is a closed loop over blocks of ``block`` rows with
``inflight`` blocks queued on the card: stage block ``i`` from pinned host
memory into its device buffer (a non-blocking copy), enqueue its forward,
enqueue the copy of its probabilities into a pinned host buffer and record
an event; then wait for the event of block ``i - inflight + 1`` and take its
probabilities.  A block's latency runs from its staging to its
probabilities on the host; the host never waits on a block younger than
the one it harvests, so the card always has the next forward queued.

Everything a run reports is read by the metric readers in
``perfbench/metrics/`` from the :class:`Run` record.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import importlib.util
import json
import subprocess
import sys
import time

import numpy as np
import torch

from perfbench import reference, spec, tracing, traffic, weights, yardstick

#: top-level modules that no process of the benchmark may hold: JAX and the
#: JAX package the port was made from
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "repro")
#: the detector's two input kinds: stored mfcc20 rows, or raw 0.8 s windows
INPUT_KINDS = ("feat", "raw")


@dataclasses.dataclass
class Window:
    """What a closed-loop run of blocks recorded on the host clock."""

    blocks: int
    rows: int
    seconds: float
    latencies_s: list[float]
    enqueue_s: list[float]
    results: list[np.ndarray]  # block j's (rows, n_classes) probabilities


@dataclasses.dataclass
class Run:
    """What the metric readers read."""

    cell: spec.Cell
    setup_s: float
    window: Window
    layers: list[yardstick.Layer]
    trace: tracing.Trace | None


class _HostDone:
    """The CPU stand-in of a CUDA event: a CPU copy has finished when it returns."""

    def record(self):
        pass

    def synchronize(self):
        pass


class Loop:
    """The closed loop of the window (see the module docstring)."""

    def __init__(self, forward, ring: torch.Tensor, device: torch.device, *,
                 inflight: int, n_classes: int):
        cuda = device.type == "cuda"
        self.forward = forward
        self.ring = ring.pin_memory() if cuda else ring
        self.inflight = inflight
        _, rows, width = ring.shape
        self.dev_in = [torch.empty((rows, width), dtype=torch.float32, device=device)
                       for _ in range(inflight)]
        self.host_out = [torch.empty((rows, n_classes), dtype=torch.float32, pin_memory=cuda)
                         for _ in range(inflight)]
        self.events = [torch.cuda.Event() if cuda else _HostDone() for _ in range(inflight)]

    def run(self, *, seconds: float | None = None, blocks: int | None = None,
            traced: bool = False) -> Window:
        span = torch.profiler.record_function if traced else (lambda _: contextlib.nullcontext())
        k, n_ring = self.inflight, self.ring.shape[0]
        staged, done, enqueue, results = [], [], [], []

        def harvest(j: int) -> None:
            s = j % k
            with span("perfbench.wait"):
                self.events[s].synchronize()
            with span("perfbench.harvest"):
                results.append(self.host_out[s].numpy().copy())
            done.append(time.perf_counter())

        t0 = time.perf_counter()
        i = 0
        while True:
            now = time.perf_counter()
            if seconds is not None and now - t0 >= seconds or blocks is not None and i >= blocks:
                break
            s = i % k
            staged.append(now)
            with span("perfbench.stage"):
                self.dev_in[s].copy_(self.ring[i % n_ring], non_blocking=True)
            a = time.perf_counter()
            with span("perfbench.forward"):
                out = self.forward(self.dev_in[s])
            enqueue.append(time.perf_counter() - a)
            with span("perfbench.send_home"):
                self.host_out[s].copy_(out, non_blocking=True)
                self.events[s].record()
            del out
            if i >= k - 1:
                harvest(i - k + 1)
            i += 1
        for j in range(max(0, i - k + 1), i):
            harvest(j)
        end = done[-1] if done else time.perf_counter()
        rows = self.ring.shape[1]
        return Window(i, i * rows, end - t0, [d - s for s, d in zip(staged, done)], enqueue,
                      results)


def forbidden_modules() -> list[str]:
    """Top-level names in ``sys.modules`` that the benchmark must not load."""
    return sorted({m.partition(".")[0] for m in sys.modules} & set(FORBIDDEN_MODULES))


def card_line() -> str:
    """``nvidia-smi``'s name and power limit of the card the run uses, and
    its SM clock, power draw and temperature as the window closes."""
    try:
        proc = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,power.draw,temperature.gpu",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as exc:
        return f"nvidia-smi unavailable: {exc}"
    return proc.stdout.strip().splitlines()[0] if proc.returncode == 0 else proc.stderr.strip()


def load_reader(name: str):
    """The ``read(run)`` function of ``perfbench/metrics/<name>.py``."""
    path = spec.METRICS / f"{name}.py"
    mod_spec = importlib.util.spec_from_file_location("perfbench_metric_" + name.replace(".", "_"),
                                                      path)
    module = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(module)
    return module.read


def load_program(conf: dict):
    """The module ``perfbench/programs/<program>.py`` of configuration
    ``conf``; raises, naming the path, where there is no such file."""
    path = spec.program_path(conf)
    if not path.is_file():
        raise FileNotFoundError(f"configuration {conf.get('name')!r} names program "
                                f"{spec.program_name(conf)!r}, and there is no file {path}")
    mod_spec = importlib.util.spec_from_file_location(
        "perfbench_program_" + spec.program_name(conf), path)
    module = importlib.util.module_from_spec(mod_spec)
    sys.modules[mod_spec.name] = module  # its dataclasses look their module up by name
    mod_spec.loader.exec_module(module)
    return module


def read_metrics(run, metrics) -> dict:
    """Each metric whose reader finds something to read, by name."""
    out = {}
    for m in metrics:
        value = load_reader(m["name"])(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def _ring_rows(bank: traffic.Bank, ring_idx: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(bank.rows[ring_idx]))


def reference_ring(cell: spec.Cell, seed: int, bank: traffic.Bank, ring_idx: np.ndarray,
                   device: torch.device) -> np.ndarray:
    """The reference's (ring, block, n_classes) probabilities of the ring's
    rows, from a checkpoint drawn again from the seed; each distinct bank
    row is scored once.  Raw windows take the frozen numpy front-end."""
    from perfbench.frozen import features

    used, inverse = np.unique(ring_idx, return_inverse=True)
    rows = bank.rows[used] if bank.input == "feat" else features.batch_features(bank.rows[used])
    params = weights.float_params(cell.config["cnn"], traffic.seeds(seed).weights, device)
    art = reference.bake(params, cell.config)
    probs = reference.forward(art, torch.from_numpy(np.asarray(rows, np.float32)).to(device))
    return probs.cpu().numpy()[inverse.reshape(-1)].reshape(*ring_idx.shape, -1)


#: the gap a row reads when an answer is not finite: more than two
#: probabilities can differ
NOT_FINITE_GAP = 2.0


def row_gaps(windows: list[Window], ref_ring: np.ndarray) -> tuple[np.ndarray, int]:
    """Each answered row's widest probability gap to the reference
    (:data:`NOT_FINITE_GAP` where the answer is not finite), over every block
    of ``windows`` (block ``j`` of a window holds ring slot ``j % ring``),
    and the rows whose answer never came."""
    n_ring, block = ref_ring.shape[:2]
    gaps, missing = [], 0
    for w in windows:
        missing += (w.blocks - len(w.results)) * block
        for j, got in enumerate(w.results):
            diff = np.abs(got.astype(np.float64) - ref_ring[j % n_ring]).max(axis=1)
            gaps.append(np.where(np.isfinite(got).all(axis=1), diff, NOT_FINITE_GAP))
    return (np.concatenate(gaps) if gaps else np.zeros(0)), missing


def run_cell(cell: spec.Cell, seed: int, seconds: float, trace: bool, *, device="cuda",
             t_start: float | None = None, forward_factory=None) -> dict:
    """One run: the result line's object.  ``forward_factory(conf, params,
    device, raw)`` puts another forward in the program's place (the control,
    a planted fault); by default it is the program."""
    t_start = time.perf_counter() if t_start is None else t_start
    conf, mix = cell.config, cell.traffic
    if mix["input"] not in INPUT_KINDS:
        raise ValueError(f"cell {cell.name!r}: the detector's input must be one of "
                         f"{INPUT_KINDS}")
    marks = [("imports", time.perf_counter())]
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.init()
        torch.cuda.reset_peak_memory_stats(dev)
    marks.append(("card", time.perf_counter()))
    raw = mix["input"] == "raw"
    seeds = traffic.seeds(seed)
    bank = traffic.make_bank(mix, seeds.bank)
    ring_idx = traffic.draw_ring(mix, len(bank.labels), seeds.blocks)
    marks.append(("bank", time.perf_counter()))
    params = weights.float_params(conf["cnn"], seeds.weights, dev)
    if forward_factory is None:
        from perfbench.program import Program

        forward = Program(conf, params, dev, raw=raw)
    else:
        forward = forward_factory(conf, params, dev, raw)
    del params
    loop = Loop(forward, _ring_rows(bank, ring_idx), dev, inflight=int(mix["inflight"]),
                n_classes=conf["cnn"]["n_classes"])
    marks.append(("weights and bake", time.perf_counter()))
    with torch.no_grad():
        warm = loop.run(blocks=int(mix["warmup_blocks"]))
        if cuda:
            torch.cuda.synchronize(dev)
        marks.append(("warm-up", time.perf_counter()))
        setup_s = time.perf_counter() - t_start
        window = loop.run(seconds=seconds)
        traced, trace_rec = None, None
        if trace:
            traced, trace_rec = _traced_segment(loop, int(mix["trace_blocks"]), cuda)
    backend = sys.modules.get("repro_torch.kernels.backend")
    steps = [(name, t - (marks[i - 1][1] if i else t_start)) for i, (name, t) in enumerate(marks)]
    steps.append(("the kernels' build (in the warm-up)", getattr(backend, "build_seconds", 0.0)))
    print("setup: " + ", ".join(f"{name} {secs:.3f} s" for name, secs in steps), file=sys.stderr)
    card = card_line() if cuda else "cpu"
    memory_peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    del loop, forward
    if cuda:
        torch.cuda.empty_cache()

    ref_ring = reference_ring(cell, seed, bank, ring_idx, dev)
    gaps, missing = row_gaps([warm, window] + ([traced] if traced else []), ref_ring)
    gap = float(gaps.max()) if gaps.size else NOT_FINITE_GAP
    limit = (conf.get("limits") or {}).get(mix["input"], {}).get("max_prob_gap")
    failed = missing + (int((gaps > limit).sum()) if limit is not None else gaps.size)
    correct = limit is not None and failed == 0 and gaps.size > 0

    run = Run(cell, setup_s, window, yardstick.layers(conf, int(mix["block"])), trace_rec)
    metrics = read_metrics(run, cell.per_layer if trace else cell.end_to_end)
    result = {
        "correct": bool(correct),
        "attempted": int(gaps.size) + missing,
        "failed": failed,
        "metrics": metrics,
        "device": {
            "platform": "gpu" if cuda else "cpu",
            "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
            "count": 1,
            "memory_peak_bytes": int(memory_peak),
        },
    }
    if trace_rec is not None:
        result["device"]["busy_s"] = trace_rec.busy_s
        result["device"]["window_s"] = trace_rec.window_s
        result["breakdown"] = trace_rec.breakdown()
    result["card"] = card
    result["checks"] = {
        "max_prob_gap": {"value": gap, "limit": limit},
        "rows_missing": {"value": missing, "limit": 0},
    }
    return result


def _traced_segment(loop: Loop, blocks: int, cuda: bool):
    from torch.profiler import ProfilerActivity, profile, record_function

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    if cuda:
        torch.cuda.synchronize()
    with profile(activities=activities) as prof:
        with record_function(tracing.TRACED):
            window = loop.run(blocks=blocks, traced=True)
            if cuda:
                torch.cuda.synchronize()
    return window, tracing.reduce(prof.profiler.kineto_results.events(), blocks)


def parse_args(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True, help="cell name, <config>.<traffic>")
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True, help="length of the measured window")
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv, *, t_start: float) -> int:
    args = parse_args(argv)
    cell = spec.cell(args.workload)
    program = load_program(cell.config)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"perfbench: {cell.name} needs {cell.chips} CUDA device(s); the benchmark "
              f"runs only on the card", file=sys.stderr)
        return 2
    result = program.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                              t_start=t_start)
    found = forbidden_modules()
    if found:
        print(f"perfbench: the run loaded {', '.join(found)}; the benchmark must load neither "
              f"JAX nor the JAX package", file=sys.stderr)
        return 3
    for name, check in result["checks"].items():
        print(f"check {name}: {check['value']!r} (limit {check['limit']!r})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0
