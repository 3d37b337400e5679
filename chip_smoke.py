#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py            # from the root of a checkout

Needs one CUDA device and ``nvcc``; it never imports JAX or the ``repro``
package.  Phases, each of which ends the run with a non-zero exit on
failure:

1. print the card's name and power limit (``nvidia-smi``), build the kernel
   library from ``src/repro_torch/csrc`` and print the build seconds;
2. hold each kernel against its plain PyTorch version on the card,
   bitwise (int32 accumulators and fp32 outputs), at the serving path's
   shapes and at ragged ones, and time kernel, plain version and (where
   one exists) a single PyTorch library call at the serving shapes;
3. serve the canonical detector (mfcc20, flatten 35,072) from a seeded
   random checkpoint through ``MonitorEngine`` in two cells, int8 and the
   paper's deployed cell (pruned to 8,704, ``conv0/w=bf16,dense1/w=fp32``):
   8 streams x 4.0 s of seeded audio in uneven chunks, 8 slots.  Launch
   counters must show that every block went through K1, K2 and K3 for
   each int8 layer; the scores must equal a ``device="cpu"`` run of the
   same engine (bitwise for int8, within 1e-5 for the mixed cell, whose
   fp32/bf16 layers sum in another order on the card).

Output: per-phase lines, one JSON line with every kernel's numbers, the
``nvidia-smi`` line, and as the last line the contract
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
INT8_OPS_PER_S = 1.979e15  # H100 SXM dense int8 tensor-core peak
FP32_OPS_PER_S = 67e12  # H100 SXM fp32 outside the tensor cores
SEED = 20261016
N_STREAMS, SECONDS, SLOTS = 8, 4.0, 8
MIXED_POLICY = "conv0/w=bf16,dense1/w=fp32"
MIXED_ATOL = 1e-5


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def nvidia_smi() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(proc.returncode == 0, f"nvidia-smi failed: {proc.stderr.strip()}")
    return proc.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------


def call_ms(torch, fn, *, warmup: int = 10, iters: int = 60) -> float:
    """Median wall time of one call as the stream sees it: CUDA events
    around each call, so host launch overhead counts when the card waits."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        pairs.append((a, b))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in pairs)


def device_ops(torch, fn, *, iters: int) -> list:
    """The GPU activities (kernels, memsets, copies) of ``iters`` calls,
    from a CUPTI trace, in start order."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    ops = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    return sorted(ops, key=lambda e: e.time_range.start)


def device_time(torch, fn, *, warmup: int = 10, iters: int = 60) -> tuple[float, list]:
    """Device time (ms) of one call: the summed durations of the GPU work
    each call enqueues, from a CUPTI trace, so host overhead does not count.
    The median over calls when the trace splits into equal per-call groups,
    else the mean (total / calls).  Also returns one call's op names."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    ops = device_ops(torch, fn, iters=iters)
    check(bool(ops), "the CUPTI trace holds no device activity")
    per = len(ops) // iters
    if per * iters != len(ops):
        print(f"timing: trace held {len(ops)} device ops for {iters} calls; using the mean")
        return sum(e.time_range.elapsed_us() for e in ops) / iters / 1e3, []
    sums = [sum(e.time_range.elapsed_us() for e in ops[i * per:(i + 1) * per])
            for i in range(iters)]
    return statistics.median(sums) / 1e3, [e.name[:60] for e in ops[:per]]


def time_ms(torch, fn, **kw) -> float:
    return device_time(torch, fn, **kw)[0]


def bound_ms(bytes_moved: float, ops: float, peak_ops: float) -> tuple[float, str]:
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / peak_ops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def bitwise(torch, a, b) -> bool:
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype == torch.float32:
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    return torch.equal(a, b)


def max_abs(torch, a, b) -> float:
    return float((a.double() - b.double()).abs().max()) if a.numel() else 0.0


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def _qmm_case(torch, gen, dev, m, k, n, *, act, clip=None, bias=True):
    def ri(shape):
        return torch.randint(-128, 128, shape, generator=gen, dtype=torch.int8).to(dev)

    x, w = ri((m, k)), ri((k, n))
    xs = (torch.rand((m, 1), generator=gen) * 0.05 + 1e-3).to(dev)
    ws = (torch.rand((1, n), generator=gen) * 1e-3 + 1e-5).to(dev)
    b = (torch.randn(n, generator=gen) * 0.1).to(dev) if bias else None
    return (x, w, xs, ws, b), dict(act=act, clip=clip)


def _conv_case(torch, gen, dev, bsz, l, cin, cout, k, *, per_sample=True):
    def ri(shape):
        return torch.randint(-128, 128, shape, generator=gen, dtype=torch.int8).to(dev)

    x, w = ri((bsz, l, cin)), ri((k, cin, cout))
    xs = (torch.rand((bsz, 1) if per_sample else (), generator=gen) * 0.05 + 1e-3).to(dev)
    ws = (torch.rand((cout,), generator=gen) * 1e-2 + 1e-4).to(dev)
    b = (torch.randn(cout, generator=gen) * 0.1).to(dev)
    return (x, w, xs, ws, b), dict(act="relu")


def kernel_phase(torch, dev, gpu_line):
    from repro_torch.kernels.conv1d_fused import conv1d_fused_q, conv1d_fused_q_plain
    from repro_torch.kernels.cordic_act import cordic_softmax, cordic_softmax_plain
    from repro_torch.kernels.quant_matmul import quant_matmul, quant_matmul_plain

    gen = torch.Generator().manual_seed(SEED)
    results = {}

    def compare(name, kernel, plain, args, kw, with_acc=True):
        got = kernel(*args, **kw)
        torch.cuda.synchronize()
        want = plain(*args, **kw)
        ok = bitwise(torch, got, want)
        err = max_abs(torch, got, want)
        if with_acc:
            acc_k = kernel(*args[:4], return_acc=True)
            torch.cuda.synchronize()
            acc_p = plain(*args[:4], return_acc=True)
            ok = ok and bitwise(torch, acc_k, acc_p)
            err = max(err, max_abs(torch, acc_k, acc_p))
        shapes = [tuple(a.shape) for a in args if a is not None]
        print(f"kernel_check {name} shapes={shapes} kw={kw} bitwise={ok} max_abs_err={err}")
        check(ok, f"{name} disagrees with its plain version at {shapes}")
        return err

    # K1: the serving path's dense layers plus ragged shapes
    k1_main = {
        "dense0": _qmm_case(torch, gen, dev, 8, 35072, 64, act="relu"),
        "dense1": _qmm_case(torch, gen, dev, 8, 64, 2, act=None),
    }
    k1_err = 0.0
    for name, (args, kw) in k1_main.items():
        k1_err = max(k1_err, compare(f"quant_matmul[{name}]", quant_matmul, quant_matmul_plain, args, kw))
    for m, k, n, kw in ((8, 8704, 64, dict(act="relu")), (3, 37, 5, dict(act="relu", clip=0.05)),
                        (1, 1, 1, dict(act=None)), (64, 8704, 64, dict(act="relu"))):
        args, kw2 = _qmm_case(torch, gen, dev, m, k, n, **kw)
        k1_err = max(k1_err, compare("quant_matmul", quant_matmul, quant_matmul_plain, args, kw2))

    # K2: the three conv blocks (and the pruned conv2) plus edge cases
    k2_main = {
        "conv0": _conv_case(torch, gen, dev, 8, 1096, 1, 64, 3),
        "conv1": _conv_case(torch, gen, dev, 8, 548, 64, 128, 3),
        "conv2": _conv_case(torch, gen, dev, 8, 274, 128, 256, 3),
    }
    k2_err = 0.0
    for name, (args, kw) in k2_main.items():
        k2_err = max(k2_err, compare(f"conv1d_fused_q[{name}]", conv1d_fused_q, conv1d_fused_q_plain, args, kw))
    for shape, per_sample in (((8, 274, 128, 64, 3), True), ((8, 548, 64, 128, 3), False),
                              ((3, 77, 12, 20, 1), True), ((2, 63, 5, 70, 5), False),
                              ((1, 1, 1, 1, 3), True), ((2, 100, 200, 33, 3), True)):
        args, kw = _conv_case(torch, gen, dev, *shape, per_sample=per_sample)
        k2_err = max(k2_err, compare("conv1d_fused_q", conv1d_fused_q, conv1d_fused_q_plain, args, kw))

    # K3: softmax heads, with rows that hit the +-30 clip of the exp argument
    k3_err = 0.0
    k3_main = None
    for cols in (2, 5):
        x = (torch.randn((8, cols), generator=gen) * 4).to(dev)
        x[0, 0] = 80.0
        x[1, -1] = -75.0
        if cols == 2:
            k3_main = x
        got = cordic_softmax(x)
        torch.cuda.synchronize()
        want = cordic_softmax_plain(x)
        ok = bitwise(torch, got, want)
        k3_err = max(k3_err, max_abs(torch, got, want))
        print(f"kernel_check cordic_softmax shape={tuple(x.shape)} bitwise={ok} max_abs_err={k3_err}")
        check(ok, f"cordic_softmax disagrees with its plain version at {tuple(x.shape)}")

    # timing at the serving shapes (one forward's launches of each kernel)
    def per_forward(cases, kernel, plain, library=None):
        ms = plain_ms = 0.0
        lib_ms = 0.0 if library is not None else None
        for name, (args, kw) in cases.items():
            t_k, k_ops = device_time(torch, lambda: kernel(*args, **kw))
            t_p, p_ops = device_time(torch, lambda: plain(*args, **kw), iters=50)
            ms, plain_ms = ms + t_k, plain_ms + t_p
            line = {"kernel": kernel.__name__, "layer": name, "ms": t_k, "plain_ms": t_p,
                    "call_ms": call_ms(torch, lambda: kernel(*args, **kw)),
                    "kernel_ops": k_ops, "plain_ops": len(p_ops)}
            if library is not None:
                t_l = library(args, kw)
                lib_ms = None if (t_l is None or lib_ms is None) else lib_ms + t_l
                line["library_ms"] = t_l
            print("kernel_time " + json.dumps({**line, "gpu": gpu_line}))
        return ms, plain_ms, lib_ms

    def int_mm_library(args, kw):
        x, w, xs, ws, b = args

        def call():
            y = torch._int_mm(x, w).float() * xs * ws + b
            return torch.relu(y) if kw["act"] == "relu" else y

        try:
            call()
        except RuntimeError as exc:  # shape constraints of _int_mm (M > 16, ...)
            print(f"library torch._int_mm not applicable at {tuple(x.shape)}x{tuple(w.shape)}: "
                  f"{str(exc).splitlines()[0]}")
            return None
        return time_ms(torch, call)

    k1_ms, k1_plain, k1_lib = per_forward(k1_main, quant_matmul, quant_matmul_plain, int_mm_library)
    k2_ms, k2_plain, _ = per_forward(k2_main, conv1d_fused_q, conv1d_fused_q_plain)
    k3_ms, k3_ops = device_time(torch, lambda: cordic_softmax(k3_main))
    k3_plain, k3_plain_ops = device_time(torch, lambda: cordic_softmax_plain(k3_main), iters=50)
    k3_lib = time_ms(torch, lambda: torch.softmax(k3_main, dim=-1))
    print("kernel_time " + json.dumps({
        "kernel": "cordic_softmax", "layer": "head", "ms": k3_ms, "plain_ms": k3_plain,
        "library_ms": k3_lib, "call_ms": call_ms(torch, lambda: cordic_softmax(k3_main)),
        "kernel_ops": k3_ops, "plain_ops": len(k3_plain_ops),
        "gpu": gpu_line,
    }))

    def qmm_cost(args):
        x, w = args[0], args[1]
        m, k = x.shape
        n = w.shape[1]
        return m * k + k * n + 4 * (m + 2 * n) + 4 * m * n, 2 * m * k * n

    def conv_cost(args):
        x, w = args[0], args[1]
        b, l, cin = x.shape
        k, _, cout = w.shape
        return b * l * cin + k * cin * cout + 4 * (b + 2 * cout) + 4 * b * l * cout, 2 * b * l * k * cin * cout

    def total_bound(cases, cost):
        bytes_moved = sum(cost(args)[0] for args, _ in cases.values())
        ops = sum(cost(args)[1] for args, _ in cases.values())
        return bound_ms(bytes_moved, ops, INT8_OPS_PER_S)

    k1_bound, k1_by = total_bound(k1_main, qmm_cost)
    k2_bound, k2_by = total_bound(k2_main, conv_cost)
    # K3: 8 B per value in and out; ~150 scalar integer/fp32 ops per value
    k3_bound, k3_by = bound_ms(8 * k3_main.numel(), 150 * k3_main.numel(), FP32_OPS_PER_S)

    results["quant_matmul"] = dict(
        name="quant_matmul", route="cuda", source="src/repro_torch/csrc/quant_matmul.cu",
        replaces="src/repro/kernels/quant_matmul.py:78", max_abs_err=k1_err,
        ms=k1_ms, plain_ms=k1_plain, bound_ms=k1_bound, bound_by=k1_by, library_ms=k1_lib,
    )
    results["conv1d_fused_q"] = dict(
        name="conv1d_fused_q", route="cuda", source="src/repro_torch/csrc/conv1d_fused.cu",
        replaces="src/repro/kernels/conv1d_fused.py:98", max_abs_err=k2_err,
        ms=k2_ms, plain_ms=k2_plain, bound_ms=k2_bound, bound_by=k2_by, library_ms=None,
    )
    results["cordic_softmax"] = dict(
        name="cordic_softmax", route="cuda", source="src/repro_torch/csrc/cordic_softmax.cu",
        replaces="src/repro/kernels/cordic_act.py:132", max_abs_err=k3_err,
        ms=k3_ms, plain_ms=k3_plain, bound_ms=k3_bound, bound_by=k3_by, library_ms=k3_lib,
    )
    return results


# ---------------------------------------------------------------------------
# phase 3: MonitorEngine in the two canonical cells
# ---------------------------------------------------------------------------


def make_audio(np, features):
    """Seeded 0.8 s-windowed scenes: broadband noise everywhere, and in a
    random stretch of each stream a rotor-like harmonic stack."""
    rng = np.random.default_rng(SEED)
    n = int(SECONDS * features.SR)
    t = np.arange(n) / features.SR
    audio = rng.standard_normal((N_STREAMS, n)) * 0.3
    for s in range(N_STREAMS):
        f0 = rng.uniform(80, 240)
        on = rng.uniform(0, SECONDS / 2)
        gate = (t >= on) & (t < on + rng.uniform(1.0, SECONDS / 2))
        tone = sum(np.sin(2 * np.pi * f0 * h * t + rng.uniform(0, 6.28)) / h for h in range(1, 6))
        audio[s] += gate * tone * rng.uniform(0.2, 2.0)
    audio = audio.astype(np.float32)
    chunks, cursors = [], [0] * N_STREAMS
    while any(c < n for c in cursors):
        rnd = []
        for s in range(N_STREAMS):
            size = int(rng.uniform(0.3, 1.7) * features.N_SAMPLES)
            if cursors[s] < n:
                rnd.append((s, cursors[s], min(n, cursors[s] + size)))
            cursors[s] += size
        chunks.append(rnd)
    return audio, chunks


def serve(engine, audio, chunks):
    scores, round_s = [], []
    t0 = time.perf_counter()
    for rnd in chunks:
        for s, lo, hi in rnd:
            engine.push(s, audio[s, lo:hi])
        ts = time.perf_counter()
        got = engine.step()
        if got:
            round_s.append(time.perf_counter() - ts)
        scores.extend(got)
    while True:
        ts = time.perf_counter()
        got = engine.step()
        if not got:
            break
        round_s.append(time.perf_counter() - ts)
        scores.extend(got)
    wall = time.perf_counter() - t0
    return scores, engine.finalize(), wall, round_s


def engine_phase(torch, np, dev, gpu_line):
    from repro_torch.core.precision_policy import PrecisionPolicy
    from repro_torch.core.pruning import plan_prune
    from repro_torch.data import features
    from repro_torch.kernels.conv1d_fused import conv1d_fused_q
    from repro_torch.kernels.cordic_act import cordic_softmax
    from repro_torch.kernels.quant_matmul import quant_matmul
    from repro_torch.models import cnn1d
    from repro_torch.serving.accelerator import accelerator_forward
    from repro_torch.serving.engine import MonitorEngine

    cfg = cnn1d.CANONICAL
    params = cnn1d.init_params(cfg, torch.Generator().manual_seed(SEED))
    spec = plan_prune(params["conv2"]["w"], cfg.n_frames, keep=64, trim_frames=1)
    check(spec.flatten_after == 8704, f"pruned flatten {spec.flatten_after} != 8704")
    cells = {
        "int8": dict(precision="int8"),
        "pruned_mixed": dict(precision="int8", prune=spec,
                             policy=PrecisionPolicy.parse(MIXED_POLICY, default="int8")),
    }
    audio, chunks = make_audio(np, features)
    n_windows = N_STREAMS * int(SECONDS / features.WINDOW_S)
    kernels = (quant_matmul, conv1d_fused_q, cordic_softmax)
    launches = {k.__name__: 0 for k in kernels}
    for cell, kw in cells.items():
        engines = {
            d: MonitorEngine(params, cfg, n_streams=N_STREAMS, feature_kind="mfcc20",
                             batch_slots=SLOTS, device=d, **kw)
            for d in ("cuda", "cpu")
        }
        gpu = engines["cuda"]
        gpu.precompile()  # warm-up: builds/loads the library, first-touch allocations
        torch.cuda.synchronize()
        for k in kernels:
            k.launches = 0
        scores, events, wall, rounds = serve(gpu, audio, chunks)
        torch.cuda.synchronize()
        counts = {k.__name__: k.launches for k in kernels}
        for name, c in counts.items():
            launches[name] += c
        conv_modes, dense_modes = gpu.artifact.layer_modes
        blocks = gpu.forward_calls
        want = {
            "conv1d_fused_q": blocks * sum(m == "int8" for m in conv_modes),
            "quant_matmul": blocks * sum(m == "int8" for m in dense_modes),
            "cordic_softmax": blocks,
        }
        print(f"engine_launches cell={cell} blocks={blocks} counts={counts} expected={want}")
        check(counts == want, f"{cell}: kernel launches {counts} != {want}")
        check(len(scores) == n_windows, f"{cell}: {len(scores)} windows scored, want {n_windows}")

        # the same windows batched straight through the forward: finite rows
        # summing to 1, and equal to the streamed scores (co-batch independence)
        order = sorted(scores, key=lambda w: (w.stream, w.window_idx))
        wins = audio.reshape(N_STREAMS, -1, features.N_SAMPLES).reshape(-1, features.N_SAMPLES)
        feats = features.batch_features(wins, "mfcc20")
        probs = np.concatenate([
            accelerator_forward(gpu.artifact, feats[i : i + SLOTS], cfg, device=dev).cpu().numpy()
            for i in range(0, len(feats), SLOTS)
        ])
        check(np.isfinite(probs).all(), f"{cell}: non-finite probabilities")
        row_err = float(np.abs(probs.sum(axis=1) - 1.0).max())
        check(row_err <= 1e-6, f"{cell}: probability rows sum to 1 only within {row_err}")
        check(np.array_equal(probs[:, 1].astype(np.float64), [w.p_uav for w in order]),
              f"{cell}: batched forward differs from the streamed scores")

        # where a round's time goes: host features, the forward of one block,
        # and the card's busy share over a whole serving run (CUPTI trace)
        t0 = time.perf_counter()
        features.batch_features(wins[:SLOTS], "mfcc20")
        feat_ms = (time.perf_counter() - t0) * 1e3 / SLOTS
        block = torch.from_numpy(feats[:SLOTS]).to(dev)
        fwd_call = call_ms(torch, lambda: accelerator_forward(gpu.artifact, block, cfg, device=dev))
        fwd_dev = time_ms(torch, lambda: accelerator_forward(gpu.artifact, block, cfg, device=dev))
        traced = MonitorEngine(gpu.artifact, cfg, n_streams=N_STREAMS, feature_kind="mfcc20",
                               batch_slots=SLOTS, device="cuda")
        t0 = time.perf_counter()
        ops = device_ops(torch, lambda: serve(traced, audio, chunks), iters=1)
        traced_wall = time.perf_counter() - t0
        busy = sum(e.time_range.elapsed_us() for e in ops) / 1e6 / traced_wall

        cpu_scores, cpu_events, _, _ = serve(engines["cpu"], audio, chunks)
        got = [dataclasses.astuple(w) for w in scores]
        ref = [dataclasses.astuple(w) for w in cpu_scores]
        dp = max(abs(a[2] - b[2]) for a, b in zip(got, ref))
        if cell == "int8":
            check(got == ref, f"{cell}: card scores differ from the CPU run (max |dp| {dp})")
            check(events == cpu_events, f"{cell}: card events differ from the CPU run")
        else:
            check([a[:2] for a in got] == [b[:2] for b in ref], f"{cell}: window order differs")
            check(dp <= MIXED_ATOL, f"{cell}: card vs CPU max |dp| {dp} > {MIXED_ATOL}")
            key = [[(e.onset_idx, e.offset_idx) for e in evs] for evs in events]
            check(key == [[(e.onset_idx, e.offset_idx) for e in evs] for evs in cpu_events],
                  f"{cell}: card events differ from the CPU run")
        n_events = sum(len(e) for e in events)
        print("engine " + json.dumps({
            "cell": cell, "flatten": (spec.flatten_after if "prune" in kw else cfg.flatten_size),
            "layer_modes": [list(conv_modes), list(dense_modes)], "windows": len(scores),
            "blocks": blocks, "windows_per_s": len(scores) / wall,
            "round_p50_ms": statistics.median(rounds) * 1e3, "rounds": len(rounds),
            "events": n_events, "max_abs_dp_vs_cpu": dp, "row_sum_err": row_err,
            "feature_ms_per_window": feat_ms, "forward_call_ms_per_block": fwd_call,
            "forward_device_ms_per_block": fwd_dev, "device_busy_share": busy,
            "device_ops_per_run": len(ops),
            "gpu": gpu_line,
        }))
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: FAIL: no CUDA device is available", file=sys.stderr)
        return 1
    if not (SRC / "repro_torch" / "csrc").is_dir():
        print(f"chip_smoke: FAIL: {SRC / 'repro_torch'} not found beside chip_smoke.py",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))
    import numpy as np

    from repro_torch.kernels import backend

    try:
        gpu_line = nvidia_smi()
        print(f"gpu {gpu_line}")
        t0 = time.perf_counter()
        backend.library()
        print(f"build_seconds {time.perf_counter() - t0:.1f} (nvcc {backend.build_seconds:.1f})")
        dev = torch.device("cuda")
        kernels = kernel_phase(torch, dev, gpu_line)
        launches = engine_phase(torch, np, dev, gpu_line)
        for name, count in launches.items():
            check(count > 0, f"kernel {name} was never launched on the main path")
            kernels[name]["launches"] = count
        keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
                "plain_ms", "bound_ms", "bound_by", "library_ms")
        print(json.dumps({"kernels": [{k: v[k] for k in keys} for v in kernels.values()]}))
        print(nvidia_smi())
    except SmokeFailure as exc:
        print(f"chip_smoke: FAIL: {exc}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
