#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py            # from the root of a checkout
    python3 chip_smoke.py --parent DIR   # also time K1, K2, project_rows
                                         # and row_sum against a checkout
                                         # of the parent commit

Needs one CUDA device and ``nvcc``; it never imports JAX or the ``repro``
package.  Phases, each of which ends the run with a non-zero exit on
failure (no phase catches its own failure and carries on):

1. print the card's name and power limit (``nvidia-smi``), build the kernel
   library from ``src/repro_torch/csrc`` (one ``nvcc`` per source, all at
   once) and print the build seconds; disassemble it (``cuobjdump -sass``)
   and count the instructions one value costs in each K3b mode and in K3,
   by pipe (the ``sass_mix`` line), read the SM count and clock, and time
   an empty kernel (the launch floor).  K3's and K3b's bounds are the
   largest of bytes at 3.35 TB/s, INT32 instructions at 64 per SM and
   cycle, and all instructions at 128 per SM and cycle.  A second
   ``sass_mix`` line counts ``IMMA``, ``LDGSTS``, ``LDG.E.128``, ``ATOMG``
   and ``RED`` in each K1 and K2 kernel; a tensor-core kernel without
   ``IMMA`` fails the run;
2. hold each kernel against its plain PyTorch version on the card,
   bitwise, at the serving path's shapes and at ragged ones, and time
   kernel, plain version and (where one exists) a single PyTorch library
   call: K1 (M in 1, 8, 9, 64, 8,768; split and unsplit K; ragged K and N)
   and K2 (Cin 1-200 around the MMA depth, L 1-1,096, K 1/3/5), on
   outputs and accumulators, each serving layer one device operation and
   timed beside its bound; K3 at 1-100 columns (both sides of its register
   path) and on wide rows (1,025, 2,048, 4,096 and the widest it takes,
   32,768 columns, a block a row);
   K3b in all seven modes at the reference sweep's 4096 x 128, on every
   Q15.16 angle the mode can feed the CORDIC, at ragged sizes, on views
   at 1- and 3-float offsets and at the unit's edge values; the
   front-end's fixed-order projection (at the mfcc20 block's shapes and at
   ragged ones, K 1-2,047 on both sides of a chunk, N 1-33, R 1 and 7, each
   with the chosen tile and every other) and row sum (at the block's
   shapes and at each of its three kernels' edges, up to 32,768 values),
   each shape one device op, timed beside its bound and ``torch.matmul`` /
   ``torch.sum``; the projection at the float layers' shapes (8 x 35,072 x
   64, 8 x 8,704 x 64, 8 x 64 x 2 and conv0's im2col rows 8,768 x 3 x 64),
   twice the same bits, one device op, timed beside its bound, and every
   tile at those shapes and the block's (the ``project_tile_sweep`` lines);
   then the float layers at full width (policies ``dense0/w=fp32`` and
   ``dense0/w=bf16``): a row's logits and probabilities bitwise the same
   at batch sizes 1, 3 and 8, under a permutation and beside silence
   padding, and the card's bitwise the CPU's;
3. the im2col sign-off layer ``cordic_activation(conv1d_q(x, w, b),
   "relu")`` at each canonical conv (B = 8), K1 at M = B*L then K3b:
   bitwise against the same expression on the CPU, and against the fused
   conv (int32 accumulators bitwise, outputs within 1e-5);
4. the on-device front-end for all four kinds on seeded scenes: within
   ``PARITY_ATOL`` of the numpy oracle and bitwise row-independent across
   batch sizes 1, 3 and 8, a permutation and silence padding; and which of
   the three library hazards (cuBLAS by shape, reductions by shape, cuFFT
   plans by batch count) the card shows;
5. serve the canonical detector (mfcc20, flatten 35,072) from a seeded
   random checkpoint in three cells, 8 streams x 4.0 s of seeded audio in
   uneven chunks, 8 slots: int8 and the paper's deployed cell (pruned to
   8,704, ``conv0/w=bf16,dense1/w=fp32``) through ``MonitorEngine`` with
   host features, and ``int8_ondevice`` through the driver
   (``repro_torch.launch.monitor.main`` with ``--artifact`` and
   ``--device-features``).  Launch counters must show every block going
   through its kernels (the mixed cell's float layers through
   ``project_rows``); scores and events must equal a ``device="cpu"`` run
   bitwise (the mixed cell too: its float layers sum in one fixed order on
   both devices) or, for the on-device cell, a batched raw-window forward
   on the card (bitwise), with the card's features within ``PARITY_ATOL``
   of the CPU's.

6. the fleet (``FleetSupervisor``, two workers) over the int8 cell's
   artifact and scene: the sequential and the lane fleet equal phase 5's
   monolithic card run bitwise, scores and events, with every block of
   every worker through K2 x3, K1 x2 and K3; a seeded fault plan (crash,
   stall, kill; drop, corrupt, jitter) never escapes ``step`` and leaves
   the streams it does not damage equal (a lossless plan: all of them); a
   worker past ``max_rebuilds`` is reassigned losslessly and no revived
   worker packs K2's weights again; a fleet abandoned mid-scene restores
   from its state dir to the uninterrupted run; spawn and retire are
   lossless; and the driver with ``--workers 2 --lanes threads --state-dir``
   gives a plain run's events, and again when rerun on the same dir.  The
   ``fleet`` line: windows/s and round p50 of monolith, sequential and lane
   fleet, revive and ``restore_from_dir`` time (CUDA events), checkpoint
   and WAL bytes a round, and the phase's seconds.

7. sharded dispatch (``sharded_phase``): the int8, pruned_mixed and
   on-device int8 cells of phase 5 served by ``MonitorEngine`` over meshes
   of 2 and 4 entries of one card (and over every card when there are
   several): scores and events bitwise the unsharded engine's, and every
   block exactly k x one forward's kernel launches; the driver's
   ``--shards 1`` run equals its plain run.  One ``sharded`` line a case,
   with windows/s and round p50.

Then K2 is timed at every tile and stage count it takes and K1 at other
splits of K, each held to the chosen tiling's int32 accumulators and
outputs (no tiling may change them), and every serving call of both again
with the card held busy before each call (the ``tile_sweep`` lines).

8. detector training and analysis (``training_phase``): the reference's
   corpus (2,400 windows, host numpy) and mfcc20 features; the canonical
   detector trained on the card with ``train_detector`` (14 epochs, batch
   64, patience 5; ms a step and s an epoch from CUDA events, one step's
   device time from CUPTI, loss per epoch) and cached where
   ``get_detector`` finds it; params and optimizer state on the card,
   finite loss, and two seeded 20-step runs bitwise equal;
   ``calibrate_alphas`` on 256 rows; test accuracy under FP32, BF16, INT8,
   FXP8, the sensitivity policy and ``prune_model(keep=64)``, the FP32
   accuracy inside the JAX reference's band (``REFERENCE_CORRECT``) and
   the 8-bit drops beside the reference's; the card's FP32 emulation
   logits within ``EMULATION_RTOL`` of the CPU's (the TF32 guard); the
   int8, fxp8 and pruned + sensitivity-policy artifacts serving the 300
   test windows through K1-K3 (launches counted) with ``deviation_report``,
   the int8 artifact's card probabilities bitwise the CPU's; and the
   driver's quick-train default path and ``--trained`` (2 streams x 4 s).
   The ``training`` line holds the numbers.

9. the LM serving stack (``lm_phase``): gemma-2b at its published
   configuration (2,506,172,416 params, bf16, ``init_params`` seed 0 on
   the card) serves the JAX serve driver's traffic (6 requests of 4-24
   tokens, 12 new tokens each, 4 slots, 256 positions) through
   ``BatchedServer``, fixed and adaptive slots, each twice with the same
   tokens; tokens/s, prefill and decode ms a step (CUDA events), one
   decode step's device time and ops (CUPTI), peak memory, beside the
   decode step's bytes bound (``lm_serve``); the same traffic on
   ``quantize_lm_params`` weights, quantised on the card and bitwise a CPU
   quantisation of the same weights (``lm_serve_int8``); for all ten
   architectures at their published widths, one pattern group deep, fp32,
   prefill and two decode steps against the full forward
   (``LM_CONSISTENCY_TOL``, ``lm_consistency``); every smoke config and
   gemma-2b at one layer on the card against the CPU (``LM_CARD_CPU_TOL``,
   ``lm_card_vs_cpu``); and ``policy_einsum(use_kernel=True)`` in int8 and
   fxp8 at gemma-2b's ``wi_gate`` shape (4 x 2,048 x 16,384) on K1, bitwise
   its plain twin, timed beside its bound and a bf16 ``torch.matmul``
   (``lm_policy_einsum``; these two calls are K1's LM launches).

10. the LM training stack (``lm_train_phase``), after phase 9's params are
   freed: gemma-2b at its published configuration (2,506,172,416 params,
   bf16, remat) trained through the driver ``repro_torch.launch.train.main``
   (``--batch 8 --seq 128 --n-micro 2``, ``synthetic_lm_batches``,
   checkpoints under ``build/lm_train``): (a) 8 steps, ms a step from CUDA
   events and the host clock, tokens/s, one step's device work (CUPTI) and
   busy share, peak memory, the step's bound (operations at the bf16 peak
   against bytes), losses (``lm_train``), as the driver runs (no
   deterministic algorithms); (b) under
   ``torch.use_deterministic_algorithms(True)``, with
   ``CUBLAS_WORKSPACE_CONFIG`` set by this script: 8 uninterrupted steps,
   timed beside (a), then a SIGTERM as the 6th step begins (the driver's
   hook sets its flag, the loop finishes step 6, saves it, 25.06 GB, and
   exits 143), then a rerun that
   restores it and resumes to step 8: steps 7-8's losses and the final
   params and moments bitwise the uninterrupted run's, checkpoint bytes,
   save and restore seconds (``lm_train_resume``; the driver's other
   saves are held in host memory, so a run writes 25 GB in all, within
   hosts that cap a run's disk writes at 45 GiB); (c) a step with ``--compress-pod-grads``, the card's int8 round trip
   of ``groups/pos0/attn/wq``'s gradient bitwise the CPU's
   (``lm_train_compress``); (d) every smoke config's train step (fp32,
   ``n_micro`` 2) against the CPU, the loss and each leaf's first moment
   within ``LM_CARD_CPU_TOL`` / ``LM_CARD_CPU_ULPS`` (``lm_train_card_vs_cpu``),
   and gemma-2b at one layer in bf16, ``loss_fn``'s gradients each within
   ``LM_BF16_GRAD_NOISE`` of the CPU's own distance from an fp32
   computation (``lm_train_card_vs_cpu_bf16``);
   (e) ``moe_fwd_a2a`` against ``moe_fwd`` (olmoe's published width, one
   layer) and ``embedding_gather`` against the plain gather, through NCCL
   at world size 1 (``lm_train_collectives``).

11. the dry run (``dryrun_phase``), after phase 10: ``repro_torch.launch.dryrun``
   traces gemma-2b's train step as phase 10 runs it (8 x 128 tokens, two
   microbatches, remat) and its decode step as phase 9 serves it (4 slots,
   256 positions) on fake tensors on the card's device, and each step then
   runs once for real (``dryrun_card_checks``, in a child process with a
   fresh CUDA context): the FLOPs ``FlopCounterMode`` counts on the card
   must equal the fake trace's, and the predicted peak must lie within
   ``DRYRUN_PEAK_TOL`` of ``torch.cuda.max_memory_allocated`` over the step;
   the roofline bound is printed beside phase 10's step time
   (``dryrun_train``, ``dryrun_decode``); then gemma-2b and zamba2-7b x
   decode_32k on the 256-rank production mesh run in a child process (the
   ``dryrun_mesh`` lines): gemma-2b's one kv head puts its caches' sequence
   on "model", zamba2's mamba2 states are cut over "ssm_heads", a rank's
   argument bytes must equal those reckoned from the specs, no cache axis
   may be left uncut, and zamba2's collectives must stay under
   ``DRYRUN_ZAMBA_COLLECTIVE_BYTES``.

12. tensor parallelism over ``"model"`` (``tp_phase``, run first, before
   this process makes a CUDA context: its ranks share the card): gemma-2b at its
   published width, one train step as ``launch.train`` takes it (8 x 128
   tokens, two microbatches), by 2 and then 4 ranks sharing the card on
   gloo, ("data", "model") = (1, 2) and (1, 4), each rank holding its part
   of every leaf ``tree_shardings`` cuts: in fp32 at ``TP_FP32_LAYERS``
   layers and in bf16 at full depth, loss, params and moments held leaf by
   leaf against the 1-rank step within ``TP_ULPS`` times a one-ulp weight
   nudge's change, every whole leaf the same bits on every rank (the fp32
   run holds the backward: in bf16 a first step at ``launch.train``'s
   warmup rate moves few weights, and one ulp of bf16 weight noise moves
   the moments by about their own scale, so there only the loss binds); each
   rank's parameter and Adam bytes and FLOPs equal to the dry run's and its
   peak within ``DRYRUN_PEAK_TOL``; the fp32 state saved at (1, 2) and
   restored bitwise at (1, 4) and on one rank (the ``tp*`` lines; each
   rank's ms a step and the collectives' share printed, not claimed:
   ranks sharing a card time no collective).  Then each world serves it
   (``tp_serve_leg``, the ``tp_serve`` lines): 4 rows x 4,096 tokens
   prefilled into caches of 32,768 positions whose sequence is cut over
   "model", 16 greedy decode steps, against rank 0's 1-rank run: fp32 at
   ``TP_FP32_LAYERS`` within ``TP_ULPS`` times a one-ulp nudge's change,
   greedy and ``BatchedServer`` tokens equal; the int8 bake's parts
   bitwise the whole's and its logits within its own nudge's limit; bf16
   at full depth, each rank's cache bytes the whole's over the world
   exactly and the first decode step's arguments and peak against the
   dry run's.  Then zamba2-7b at its published width, one pattern period
   deep, its mamba2 blocks head-parallel over "ssm_heads" (``tp_zamba_leg``,
   the ``tp_zamba`` lines): one fp32 train step held as gemma-2b's is, and
   a prefill of 4 x 1,024 tokens and 16 greedy decode steps in fp32 and
   int8, each rank's mamba2 state the whole's bytes over the world
   exactly, logits within ``TP_ULPS`` times the nudge's change, tokens
   equal, int8 parts bitwise.

13. the examples on the port (``examples_phase``, the ``examples`` line):
   ``examples/torch_*.py`` on the card at the CPU test's arguments, each in
   a child process; any exit but 0 fails.

With ``--parent DIR``, K1's
and K2's device time at every serving layer, and ``project_rows``'s and
``row_sum``'s at the mfcc20 block's and the float layers' shapes, is
then taken for DIR's kernels and this tree's in fresh processes, in the
order parent, change, change, parent (the ``kernel_compare`` line).

Output: per-phase lines, one JSON line with every kernel's numbers, the
``nvidia-smi`` line, and as the last line the contract
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import collections
import dataclasses
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

if str(SRC) not in sys.path:
    sys.path.insert(0, str(SRC))
try:
    # the H100 SXM5 80 GB's peaks, in one place (fp32: the front-end's bound)
    from repro_torch.launch.hw import BF16_FLOPS_PER_S as BF16_OPS_PER_S
    from repro_torch.launch.hw import FP32_FLOPS_PER_S as FP32_OPS_PER_S
    from repro_torch.launch.hw import HBM_BYTES_PER_S, INT8_OPS_PER_S
except ImportError:
    sys.exit(f"chip_smoke: FAIL: {SRC / 'repro_torch'} not found beside chip_smoke.py")
#: Hopper SM, per cycle: INT32 results (16 lanes in each of 4 sub-partitions)
#: and issued thread-instructions (one warp instruction per sub-partition)
INT32_LANES_PER_SM = 64
ISSUE_LANES_PER_SM = 128
SEED = 20261016
#: numbers a later phase reads (phase 11 prints phase 10's step time)
PHASE_RESULTS: dict = {}
N_STREAMS, SECONDS, SLOTS = 8, 4.0, 8
MIXED_POLICY = "conv0/w=bf16,dense1/w=fp32"


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


def device_ops(torch, fn, *, iters: int, attempts: int = 4) -> list:
    """The GPU activities (kernels, memsets, copies) of ``iters`` calls,
    from a CUPTI trace, in start order.  A trace that comes back empty is
    taken again, up to ``attempts`` times in all (the profiler now and then
    returns no device events for a short trace); an empty result is
    returned only if every attempt was empty."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for attempt in range(1, attempts + 1):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        ops = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        if ops:
            return sorted(ops, key=lambda e: e.time_range.start)
        print(f"timing: trace {attempt} of {attempts} held no device activity")
        time.sleep(0.5)
    return []


def events_ms(torch, fn, *, iters: int) -> float:
    """Time of one call from CUDA events around ``iters`` calls in a row:
    the stream's time, host gaps between launches included."""
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def device_time(torch, fn, *, warmup: int = 10, iters: int = 60) -> tuple[float, list]:
    """Device time (ms) of one call: the summed durations of the GPU work
    each call enqueues, from a CUPTI trace, so host overhead does not count.
    The median over calls when the trace splits into equal per-call groups,
    else the mean over the calls the trace holds (a trace may drop the first
    op).  Also returns one call's op names.  When every trace comes back
    empty, the time is taken with CUDA events instead (``events_ms``) and
    says so: an upper bound, since host gaps count."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    ops = device_ops(torch, fn, iters=iters)
    if not ops:
        ms = events_ms(torch, fn, iters=iters)
        print(f"timing: no CUPTI device activity; CUDA events over {iters} calls: {ms} ms")
        return ms, ["(CUDA events)"]
    per = len(ops) // iters
    if per * iters != len(ops):
        # the trace lost (or split) an op: average over the calls it holds
        calls = len(ops) / max(1, round(len(ops) / iters))
        print(f"timing: trace held {len(ops)} device ops for {iters} calls; "
              f"using the mean over {calls:g} calls")
        return sum(e.time_range.elapsed_us() for e in ops) / calls / 1e3, []
    sums = [sum(e.time_range.elapsed_us() for e in ops[i * per:(i + 1) * per])
            for i in range(iters)]
    return statistics.median(sums) / 1e3, [e.name[:60] for e in ops[:per]]


def time_ms(torch, fn, **kw) -> float:
    return device_time(torch, fn, **kw)[0]


def bound_ms(bytes_moved: float, ops: float, peak_ops: float) -> tuple[float, str]:
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / peak_ops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# instruction counts from the built library's SASS (kernels K3 and K3b)
# ---------------------------------------------------------------------------

#: SASS opcodes executed on the INT32 pipe, and on the FP32 pipe; the rest
#: (moves, memory, control, MUFU, conversions) count toward the issue rate only
SASS_INT32 = frozenset({"IADD3", "IADD", "IADD32I", "IMAD", "IMUL", "ISETP", "ISCADD", "SHF",
                        "SHL", "SHR", "LOP3", "LOP", "LOP32I", "SEL", "IMNMX", "IABS", "LEA",
                        "PRMT", "BMSK", "BREV", "VIMNMX"})
SASS_FP32 = frozenset({"FFMA", "FFMA32I", "FADD", "FADD32I", "FMUL", "FMUL32I", "FSEL", "FSETP",
                       "FSET", "FMNMX", "FCHK", "FSWZADD"})
_SASS_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.+?)\s*;")
_SASS_LABEL = re.compile(r"^\s*(\.L_x_\d+):")
#: a predicated branch, to a label or to an address
_SASS_BRA = re.compile(r"^@!?U?P\w+\s+BRA(?:\.\w+)*\s+(?:`\((\.L_x_\d+)\)|(0x[0-9a-f]+))")


def sass_opcode(insn: str) -> str:
    """``@!P0 FFMA.RM R1, ...`` -> ``FFMA``."""
    words = insn.split()
    if words[0].startswith("@"):
        words = words[1:]
    return words[0].split(".")[0]


def sass_functions(text: str) -> dict[str, list[tuple[str, str]]]:
    """``cuobjdump -sass`` output -> {function: [(kind, text)]}: ("I", insn)
    for an instruction, and ("L", label) for a label or, before each
    instruction, for its address (``0x...``)."""
    funcs: dict[str, list[tuple[str, str]]] = {}
    body = None
    for line in text.splitlines():
        head = re.match(r"\s*Function : (\S+)", line)
        if head:
            body = funcs.setdefault(head.group(1), [])
            continue
        if body is None:
            continue
        label = _SASS_LABEL.match(line)
        if label:
            body.append(("L", label.group(1)))
            continue
        insn = _SASS_INSN.search(line)
        if insn:
            body.append(("L", hex(int(insn.group(1), 16))))
            body.append(("I", insn.group(2)))
    return funcs


def sass_common_path(body: list[tuple[str, str]]) -> list[str]:
    """The instructions a thread runs from the entry to the first
    unpredicated EXIT, in a function without loops, skipping each block that
    a predicated forward branch jumps over to call a subroutine (the slow
    path of an IEEE division, for divisors and quotients near the ends of
    the range); NOPs are padding and not counted."""
    labels = {v: i for i, (k, v) in enumerate(body) if k == "L"}
    path, i = [], 0
    while i < len(body):
        kind, insn = body[i]
        i += 1
        if kind == "L" or sass_opcode(insn) == "NOP":
            continue
        path.append(insn)
        if sass_opcode(insn) == "EXIT" and not insn.startswith("@"):
            break
        bra = _SASS_BRA.match(insn)
        target = -1
        if bra:
            dest = bra.group(1) or hex(int(bra.group(2), 16))
            target = labels.get(dest, -1)
        if target >= i:
            ops = [sass_opcode(v) for k, v in body[i:target] if k == "I"]
            if "CALL" in ops and "EXIT" not in ops:
                i = target
    return path


def sass_mix_of(path: list[str]) -> dict:
    ops = [sass_opcode(v) for v in path]
    n_int = sum(op in SASS_INT32 for op in ops)
    n_fp = sum(op in SASS_FP32 for op in ops)
    return {"int32": n_int, "fp32": n_fp, "other": len(ops) - n_int - n_fp, "total": len(ops)}


def sass_per_value(text: str, probes: dict[str, tuple[str, int, str]]) -> dict[str, dict]:
    """Instructions per value, by pipe, of each probe ``(function, values
    it computes, baseline function)``: the probe's count less its
    baseline's (the same load, store and indexing without the work), over
    the values."""
    funcs = sass_functions(text)
    out = {}
    for key, (name, values, baseline) in probes.items():
        for fn in (name, baseline):
            check(fn in funcs, f"SASS of {fn} not found in the library's disassembly")
        mix = sass_mix_of(sass_common_path(funcs[name]))
        base = sass_mix_of(sass_common_path(funcs[baseline]))
        out[key] = {k: max(0, mix[k] - base[k]) / values for k in mix}
    return out


def sass_bound_ms(n_values: int, bytes_moved: float, per_value: dict, sms: int,
                  clock_hz: float) -> tuple[float, str, dict]:
    """The least time for ``n_values`` values: the largest of the bytes at
    the HBM rate, the INT32 instructions at 64 lanes per SM and cycle, and
    all instructions at one warp instruction per sub-partition and cycle.
    Returns (ms, winning term, every term)."""
    terms = {
        "bytes": bytes_moved / HBM_BYTES_PER_S * 1e3,
        "int32": n_values * per_value["int32"] / (INT32_LANES_PER_SM * sms * clock_hz) * 1e3,
        "issue": n_values * per_value["total"] / (ISSUE_LANES_PER_SM * sms * clock_hz) * 1e3,
    }
    term = max(terms, key=terms.get)
    return terms[term], term, terms


def contract_bound_by(term: str) -> str:
    return "bytes" if term == "bytes" else "operations"


def card_rates(torch) -> dict:
    """The SM count and the SM clock the rates are taken at
    (``nvidia-smi --query-gpu=clocks.max.sm``)."""
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60,
    )
    check(proc.returncode == 0, f"nvidia-smi clocks failed: {proc.stderr.strip()}")
    mhz = float(proc.stdout.strip().splitlines()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return {"sms": sms, "clock_hz": mhz * 1e6}


def library_sass(backend) -> str:
    """``cuobjdump -sass`` of the built kernel library, kept beside it."""
    lib = backend.build()
    tool = Path(backend._nvcc()).with_name("cuobjdump")
    proc = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True, text=True,
                          timeout=300)
    check(proc.returncode == 0, f"cuobjdump failed: {proc.stderr.strip()[:500]}")
    lib.with_suffix(".sass").write_text(proc.stdout)
    return proc.stdout


#: K3b's modes (a thread's four values, as the kernel takes them) and K3's
#: row (one lane's value), each as (probe function, values, baseline)
SASS_PROBES = {
    **{mode: (f"sass_probe_{mode}", 4, "sass_probe_copy4")
       for mode in ("tanh", "sigmoid", "exp", "swish", "gelu", "selu", "relu")},
    "softmax_row": ("sass_probe_softmax_row", 1, "sass_probe_copy"),
}


#: K1's and K2's kernels in the library's SASS, and the instructions that
#: show their design: int8 tensor-core products, asynchronous and 16-byte
#: global loads, and the split-K atomics
SASS_W8A8_KERNELS = ("conv1d_mma_kernel", "conv1d_small_cin_kernel", "qmm_kernel")
_SASS_TEMPLATE = re.compile(r"(" + "|".join(SASS_W8A8_KERNELS) + r")I(.*?)EEv")


def sass_mnemonic(insn: str) -> str:
    """``@!P0 LDG.E.128 R4, ...`` -> ``LDG.E.128``."""
    words = insn.split()
    return words[1] if words[0].startswith("@") else words[0]


def sass_w8a8_mix(text: str) -> dict[str, dict[str, int]]:
    """For each instance of K1's and K2's kernel templates (``name<args>``),
    the static count of ``IMMA``, ``LDGSTS`` (cp.async), ``LDG.E.128``,
    ``ATOMG`` and ``RED`` (``RED`` or ``REDG``) instructions in its SASS."""
    out = {}
    for fname, body in sass_functions(text).items():
        m = _SASS_TEMPLATE.search(fname)
        if not m:
            continue
        args = re.findall(r"L[ib](\d+)E", m.group(2) + "E")
        counts = dict.fromkeys(("IMMA", "LDGSTS", "LDG.E.128", "ATOMG", "RED"), 0)
        for kind, insn in body:
            if kind != "I":
                continue
            op, mnem = sass_opcode(insn), sass_mnemonic(insn)
            if op in ("IMMA", "LDGSTS", "ATOMG"):
                counts[op] += 1
            elif op in ("RED", "REDG"):  # a global reduction, no value returned
                counts["RED"] += 1
            elif op == "LDG" and ".128" in mnem:
                counts["LDG.E.128"] += 1
        out[f"{m.group(1)}<{','.join(args)}>"] = counts
    return out


def sass_phase(torch, backend, gpu_line) -> dict:
    """Instructions per value of every K3b mode and of K3, by pipe, from the
    library's SASS; the card's rates; and the launch floor (CUPTI time of an
    empty kernel)."""
    text = library_sass(backend)
    per_value = sass_per_value(text, SASS_PROBES)
    rates = card_rates(torch)
    lib = backend.library()
    stream = torch.cuda.current_stream().cuda_stream

    def empty():
        backend.check(lib.empty_launch(stream), "empty_launch")

    floor_ms = time_ms(torch, empty)
    print("sass_mix " + json.dumps({"per_value": per_value, **rates,
                                    "launch_floor_ms": floor_ms, "gpu": gpu_line}))
    mix = sass_w8a8_mix(text)
    print("sass_mix " + json.dumps({"w8a8_kernels": mix, "gpu": gpu_line}))
    for name, counts in mix.items():
        if name.startswith(("conv1d_mma_kernel", "qmm_kernel")):
            check(counts["IMMA"] > 0, f"{name}: no IMMA (int8 tensor-core) instruction in its SASS")
    check(any(k.startswith("conv1d_mma_kernel") for k in mix)
          and any(k.startswith("qmm_kernel") for k in mix),
          "K1's or K2's tensor-core kernel is missing from the library's SASS")
    return {"per_value": per_value, "floor_ms": floor_ms, **rates}


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


def _qmm_case(torch, gen, dev, m, k, n, *, act, clip=None, bias=True, per_row=True):
    def ri(shape):
        return torch.randint(-128, 128, shape, generator=gen, dtype=torch.int8).to(dev)

    x, w = ri((m, k)), ri((k, n))
    xs = (torch.rand((m, 1) if per_row else (1, 1), generator=gen) * 0.05 + 1e-3).to(dev)
    ws = (torch.rand((1, n), generator=gen) * 1e-3 + 1e-5).to(dev)
    b = (torch.randn(n, generator=gen) * 0.1).to(dev) if bias else None
    return (x, w, xs, ws, b), dict(act=act, clip=clip)


def _conv_case(torch, gen, dev, bsz, l, cin, cout, k, *, per_sample=True, clip=None):
    def ri(shape):
        return torch.randint(-128, 128, shape, generator=gen, dtype=torch.int8).to(dev)

    x, w = ri((bsz, l, cin)), ri((k, cin, cout))
    xs = (torch.rand((bsz, 1) if per_sample else (), generator=gen) * 0.05 + 1e-3).to(dev)
    ws = (torch.rand((cout,), generator=gen) * 1e-2 + 1e-4).to(dev)
    b = (torch.randn(cout, generator=gen) * 0.1).to(dev)
    return (x, w, xs, ws, b), dict(act="relu", clip=clip)


#: K1's edge shapes: rows on both sides of its 8- and 64-row tiles, with
#: split K, ragged K and N, and the im2col sign-off depths at M = B*L
K1_EDGE_M = (1, 8, 9, 64, 8768)
K1_EDGE_KN = ((8704, 64), (37, 5), (64, 2), (384, 256))
#: K2's edge shapes: ragged Cin around the MMA depth of 32, L around the row
#: tiles, K in {1, 3, 5} in turn
K2_EDGE_CIN = (1, 4, 5, 31, 32, 33, 200)
K2_EDGE_L = (1, 63, 274, 1096)


def qmm_cost(args):
    """(bytes, int8 operations) of one K1 call: each input once, the output once."""
    x, w = args[0], args[1]
    m, k = x.shape
    n = w.shape[1]
    return m * k + k * n + 4 * (m + 2 * n) + 4 * m * n, 2 * m * k * n


def conv_cost(args):
    """(bytes, int8 operations) of one K2 call."""
    x, w = args[0], args[1]
    b, l, cin = x.shape
    k, _, cout = w.shape
    return b * l * cin + k * cin * cout + 4 * (b + 2 * cout) + 4 * b * l * cout, 2 * b * l * k * cin * cout


#: K3's row widths: the serving path's 2, both sides of the register path's
#: 32, and rows summed in windows of 32
K3_COLS = (1, 2, 5, 31, 32, 33, 100)
#: K3's wide rows, a block a row: one level of windows and more, up to the
#: widest it takes (``cordic_act.K3_MAX_COLS``, appended in ``kernel_phase``)
K3_WIDE_COLS = (1025, 2048, 4096)


def kernel_phase(torch, dev, gpu_line, sass):
    from repro_torch.kernels.conv1d_fused import conv1d_fused_q, conv1d_fused_q_plain
    from repro_torch.kernels.cordic_act import K3_MAX_COLS, cordic_softmax, cordic_softmax_plain
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
    for i, (m, (k, n)) in enumerate((m, kn) for m in K1_EDGE_M for kn in K1_EDGE_KN):
        kw = dict(act="relu", clip=0.05) if i % 2 else dict(act=None)
        args, kw2 = _qmm_case(torch, gen, dev, m, k, n, per_row=i % 3 != 0, **kw)
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
    for i, (cin, l) in enumerate((c, ln) for c in K2_EDGE_CIN for ln in K2_EDGE_L):
        k, cout = (1, 3, 5)[i % 3], (8, 70, 64, 33)[i % 4]
        args, kw = _conv_case(torch, gen, dev, 2, l, cin, cout, k, per_sample=i % 2 == 0,
                              clip=0.05 if i % 3 == 1 else None)
        k2_err = max(k2_err, compare("conv1d_fused_q", conv1d_fused_q, conv1d_fused_q_plain, args, kw))

    # K3: softmax heads, with rows that hit the +-30 clip of the exp argument
    k3_err = 0.0
    k3_main = None
    for cols in K3_COLS:
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
    k3_wide = None
    for cols in (*K3_WIDE_COLS, K3_MAX_COLS):
        x = (torch.randn((4, cols), generator=gen) * 4).to(dev)
        x[0, 7] = 80.0
        if cols == 4096:
            k3_wide = x
        got = cordic_softmax(x)
        torch.cuda.synchronize()
        want = cordic_softmax_plain(x)
        ok = bitwise(torch, got, want)
        k3_err = max(k3_err, max_abs(torch, got, want))
        print(f"kernel_check cordic_softmax wide shape={tuple(x.shape)} bitwise={ok} "
              f"max_abs_err={k3_err}")
        check(ok, f"cordic_softmax disagrees with its plain version at {tuple(x.shape)}")
    check(k3_wide is not None, "no 4,096-column K3 case")

    # timing at the serving shapes (one forward's launches of each kernel),
    # each layer beside its bound; a serving call is one device operation
    def per_forward(cases, kernel, plain, cost, library=None):
        ms = plain_ms = 0.0
        lib_ms = 0.0 if library is not None else None
        for name, (args, kw) in cases.items():
            t_k, k_ops = device_time(torch, lambda: kernel(*args, **kw))
            t_p, p_ops = device_time(torch, lambda: plain(*args, **kw), iters=50)
            ms, plain_ms = ms + t_k, plain_ms + t_p
            b_ms, b_by = bound_ms(*cost(args), INT8_OPS_PER_S)
            traced = bool(k_ops) and k_ops != ["(CUDA events)"]
            if traced:
                check(len(k_ops) == 1, f"{kernel.__name__}[{name}] is {len(k_ops)} device "
                                       f"operations a call: {k_ops}")
            line = {"kernel": kernel.__name__, "layer": name, "ms": t_k, "plain_ms": t_p,
                    "bound_ms": b_ms, "bound_by": b_by, "bound_share": b_ms / t_k,
                    "call_ms": call_ms(torch, lambda: kernel(*args, **kw)),
                    "kernel_ops": len(k_ops) if traced else None, "kernel_op_names": k_ops,
                    "plain_ops": len(p_ops)}
            if library is not None:
                t_l = library(args, kw)
                lib_ms = None if (t_l is None or lib_ms is None) else lib_ms + t_l
                line["library_ms"] = t_l
            print("kernel_time " + json.dumps({**line, "gpu": gpu_line}))
        return ms, plain_ms, lib_ms

    def int_mm_library(args, kw):
        """``torch._int_mm`` takes M > 16 and K, N multiples of 8: x is
        zero-padded to 32 rows (and K, N to multiples of 8), which leaves
        the product's first M x N values exact; then the same epilogue."""
        x, w, xs, ws, b = args
        m, k = x.shape
        n = w.shape[1]
        mp, kp, np_ = max(32, -(-m // 8) * 8), -(-k // 8) * 8, -(-n // 8) * 8
        xp = torch.zeros((mp, kp), dtype=torch.int8, device=x.device)
        wp = torch.zeros((kp, np_), dtype=torch.int8, device=w.device)
        xp[:m, :k], wp[:k, :n] = x, w

        def call():
            y = torch._int_mm(xp, wp)[:m, :n].float() * xs * ws + b
            return torch.relu(y) if kw["act"] == "relu" else y

        print(f"library torch._int_mm at {tuple(x.shape)}x{tuple(w.shape)} padded to "
              f"({mp}, {kp})x({kp}, {np_})")
        return time_ms(torch, call)

    k1_ms, k1_plain, k1_lib = per_forward(k1_main, quant_matmul, quant_matmul_plain, qmm_cost,
                                          int_mm_library)
    k2_ms, k2_plain, _ = per_forward(k2_main, conv1d_fused_q, conv1d_fused_q_plain, conv_cost)
    # the pruned_mixed cell's layers, timed alone (not part of the forward sums above)
    per_forward({"dense0_pruned": _qmm_case(torch, gen, dev, 8, 8704, 64, act="relu")},
                quant_matmul, quant_matmul_plain, qmm_cost)
    per_forward({"conv2_pruned": _conv_case(torch, gen, dev, 8, 274, 128, 64, 3)},
                conv1d_fused_q, conv1d_fused_q_plain, conv_cost)
    k3_ms, k3_ops = device_time(torch, lambda: cordic_softmax(k3_main))
    k3_plain, k3_plain_ops = device_time(torch, lambda: cordic_softmax_plain(k3_main), iters=10)
    k3_lib = time_ms(torch, lambda: torch.softmax(k3_main, dim=-1))
    # K3: 8 B per value in and out; its instructions per value from the SASS
    k3_bound, k3_term, k3_terms = sass_bound_ms(
        k3_main.numel(), 8 * k3_main.numel(), sass["per_value"]["softmax_row"],
        sass["sms"], sass["clock_hz"])
    floor = sass["floor_ms"]
    print("kernel_time " + json.dumps({
        "kernel": "cordic_softmax", "layer": "head", "shape": list(k3_main.shape), "ms": k3_ms,
        "plain_ms": k3_plain, "library_ms": k3_lib,
        "call_ms": call_ms(torch, lambda: cordic_softmax(k3_main)),
        "bound_ms": k3_bound, "bound_by": k3_term, "bound_terms": k3_terms,
        "launch_floor_ms": floor, "bound_with_floor_ms": max(k3_bound, floor),
        "bound_share": max(k3_bound, floor) / k3_ms,
        "sass_per_value": sass["per_value"]["softmax_row"],
        "kernel_ops": k3_ops, "plain_ops": len(k3_plain_ops), "gpu": gpu_line,
    }))

    # K3 on wide rows (no serving caller): a block a row, timed beside its
    # bytes bound (the SASS count above is the register path's)
    wide_ms, wide_ops = device_time(torch, lambda: cordic_softmax(k3_wide))
    wide_b, wide_by = bound_ms(8 * k3_wide.numel(), 0, INT8_OPS_PER_S)
    print("kernel_time " + json.dumps({
        "kernel": "cordic_softmax", "layer": "wide rows", "shape": list(k3_wide.shape),
        "ms": wide_ms, "kernel_ops": wide_ops,
        "plain_ms": time_ms(torch, lambda: cordic_softmax_plain(k3_wide), iters=10),
        "library_ms": time_ms(torch, lambda: torch.softmax(k3_wide, dim=-1)),
        "bound_ms": wide_b, "bound_by": wide_by, "launch_floor_ms": floor, "gpu": gpu_line,
    }))

    def total_bound(cases, cost):
        bytes_moved = sum(cost(args)[0] for args, _ in cases.values())
        ops = sum(cost(args)[1] for args, _ in cases.values())
        return bound_ms(bytes_moved, ops, INT8_OPS_PER_S)

    k1_bound, k1_by = total_bound(k1_main, qmm_cost)
    k2_bound, k2_by = total_bound(k2_main, conv_cost)
    for name, t, bound, by in (("quant_matmul", k1_ms, k1_bound, k1_by),
                               ("conv1d_fused_q", k2_ms, k2_bound, k2_by)):
        print("kernel_time " + json.dumps({"kernel": name, "per": "forward", "ms": t,
                                           "bound_ms": bound, "bound_by": by,
                                           "bound_share": bound / t, "gpu": gpu_line}))

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
        ms=k3_ms, plain_ms=k3_plain, bound_ms=k3_bound, bound_by=contract_bound_by(k3_term),
        library_ms=k3_lib,
    )
    return results


# ---------------------------------------------------------------------------
# phase 2b: kernel K3b (all seven CORDIC modes) and the front-end primitives
# ---------------------------------------------------------------------------

#: the edges of the CORDIC unit: tanh's +-4.4 saturation and the value just
#: inside it, beyond the +-30 exp clip, signed zeros, tiny and huge values
K3B_EDGES = [4.4, -4.4, 4.3999996, -4.3999996, 30.5, -30.5, 80.0, -80.0,
             -0.0, 0.0, 1e-30, -1e-30, 1e4, -1e4]
#: ragged sizes: below, at and past one 16-byte vector, and none a multiple
K3B_RAGGED = ((1,), (3,), (4,), (5,), (33,), (1000,), (3, 5, 7))


def cordic_phase(torch, np, dev, gpu_line, sass):
    """K3b against ``apply_mode`` (bitwise) at the sweep's, the exhaustive
    angle grid's, ragged, offset and edge inputs, and each mode's time
    beside its plain version, the nearest PyTorch call and its bound at
    4096 x 128."""
    import torch.nn.functional as F

    from repro_torch.kernels.cordic_act import MODES, angle_grid, apply_mode, cordic_activation

    rng = np.random.default_rng(SEED)
    sweep = torch.from_numpy(rng.uniform(-4, 4, (4096, 128)).astype(np.float32)).to(dev)
    flat = sweep.reshape(-1)
    # views at 1- and 3-float offsets: a scalar head before the vectors
    inputs = [sweep, flat[1:], flat[3:-2], torch.tensor(K3B_EDGES, dtype=torch.float32, device=dev)]
    inputs += [torch.from_numpy(rng.uniform(-6, 6, shape).astype(np.float32)).to(dev)
               for shape in K3B_RAGGED]
    err = 0.0
    for mode in MODES:
        grid = angle_grid(mode).to(dev)
        for x in [grid, *inputs]:
            got = cordic_activation(x, mode)
            torch.cuda.synchronize()
            want = apply_mode(x, mode)
            ok = bitwise(torch, got, want)
            err = max(err, max_abs(torch, got, want))
            check(ok, f"cordic_activation[{mode}] disagrees with apply_mode at {tuple(x.shape)} "
                      f"(offset {x.storage_offset()})")
        print(f"kernel_check cordic_activation[{mode}] angle grid {tuple(grid.shape)}, "
              f"shapes={[tuple(x.shape) for x in inputs]} bitwise=True")
    library = {"tanh": torch.tanh, "sigmoid": torch.sigmoid, "exp": torch.exp, "swish": F.silu,
               "gelu": lambda v: F.gelu(v, approximate="tanh"), "selu": F.selu, "relu": torch.relu}
    for mode in MODES:
        t_k, k_ops = device_time(torch, lambda: cordic_activation(sweep, mode))
        t_p, p_ops = device_time(torch, lambda: apply_mode(sweep, mode), warmup=2, iters=5)
        t_l = time_ms(torch, lambda: library[mode](sweep))
        per_value = sass["per_value"][mode]
        b_ms, b_term, terms = sass_bound_ms(sweep.numel(), 8 * sweep.numel(), per_value,
                                            sass["sms"], sass["clock_hz"])
        print("kernel_time " + json.dumps({
            "kernel": "cordic_activation", "mode": mode, "shape": list(sweep.shape), "ms": t_k,
            "plain_ms": t_p, "library_ms": t_l, "bound_ms": b_ms, "bound_by": b_term,
            "bound_terms": terms, "bound_share": b_ms / t_k, "launch_floor_ms": sass["floor_ms"],
            "sass_per_value": per_value, "kernel_ops": k_ops, "plain_ops": len(p_ops),
            "gpu": gpu_line,
        }))
    return err


#: one 8-window mfcc20 block: the mel and DCT projections (R, K, N) and
#: every row sum (R, n) of the on-device front-end
MFCC20_PROJECTIONS = ((408, 513, 64), (408, 64, 20))
MFCC20_ROW_SUMS = ((4104, 12), (512, 51), (80, 51), (8, 128), (8, 128), (8, 128), (8, 1096),
                   (8, 1096))
#: project_rows at ragged shapes: K on both sides of a chunk (one and two
#: chunks of the split), N around the 16-byte vectors and the tiles, R of 1
#: and 7 rows
PROJECT_RAGGED = tuple((r, k, n) for r in (1, 7) for k in (1, 13, 1025, 2047)
                       for n in (1, 2, 20, 33)) + ((5, 1, 7), (3, 700, 33))
#: row_sum at ragged shapes: each of the three kernels' edges (32 values a
#: thread, 64 windows a warp, a block a row up to 32,768 values), rows that
#: start off a 16-byte boundary, and blocks of rows that end mid-block
ROW_SUM_RAGGED = ((3, 1), (300, 7), (130, 32), (2, 33), (2, 65), (5, 100), (9, 2048),
                  (3, 2049), (3, 4104), (1, 32 * 1024))


def project_cost(r, k, n):
    """(bytes, fp32 operations) of one ``project_rows`` call."""
    return 4 * (r * k + k * n + r * n), 2 * r * k * n


def frontend_primitive_phase(torch, np, dev, gpu_line):
    """The fixed-order projection and row sum against their plain versions
    (bitwise) at the mfcc20 front-end's shapes for 8 windows and at ragged
    ones (``project_rows`` with every tile, split and unsplit), each shape
    timed beside its bound and ``torch.matmul`` / ``torch.sum``, and the
    block's sums."""
    from repro_torch.kernels import frontend
    from repro_torch.kernels.frontend import project_rows, project_rows_plain, row_sum, row_sum_plain

    rng = np.random.default_rng(SEED + 1)

    def rand(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev)

    proj_cases = [(rand(r, k).abs(), rand(k, n).abs()) if k == 513 else (rand(r, k), rand(k, n))
                  for r, k, n in MFCC20_PROJECTIONS]
    sum_cases = [rand(*s) for s in MFCC20_ROW_SUMS]
    err = 0.0
    chosen = frontend.project_tiling
    try:
        for x, m in proj_cases + [(rand(r, k), rand(k, n)) for r, k, n in PROJECT_RAGGED]:
            want = project_rows_plain(x, m)
            (r, k), n = x.shape, m.shape[1]
            for tile in [None, *range(len(frontend.PROJECT_TILES))]:
                frontend.project_tiling = chosen if tile is None else (
                    lambda *a, t=tile: frontend.tiling_with(t, *a))
                got = project_rows(x, m)
                torch.cuda.synchronize()
                err = max(err, max_abs(torch, got, want))
                check(bitwise(torch, got, want),
                      f"project_rows disagrees at {(r, k, n)} with tile {tile} (None: chosen)")
    finally:
        frontend.project_tiling = chosen
    for x in sum_cases + [rand(*s) for s in ROW_SUM_RAGGED]:
        got = row_sum(x)
        torch.cuda.synchronize()
        want = row_sum_plain(x)
        err = max(err, max_abs(torch, got, want))
        check(bitwise(torch, got, want), f"row_sum disagrees at {tuple(x.shape)}")
    print(f"kernel_check project_rows at the mfcc20 block shapes and {len(PROJECT_RAGGED)} ragged "
          f"ones (K 1-2,047, N 1-33, R 1 and 7), each with the chosen tile and every tile; "
          f"row_sum at the block's shapes and {ROW_SUM_RAGGED}: bitwise=True")

    def timed(cases, kernel, plain, library, cost, per="mfcc20 block of 8"):
        ms = plain_ms = lib_ms = 0.0
        bytes_moved = ops = 0
        for args in cases:
            t_k, k_ops = device_time(torch, lambda: kernel(*args))
            traced = bool(k_ops) and k_ops != ["(CUDA events)"]
            check(not traced or len(k_ops) == 1,
                  f"{kernel.__name__} at {[tuple(a.shape) for a in args]} is {len(k_ops)} "
                  f"device operations a call: {k_ops}")
            t_p = time_ms(torch, lambda: plain(*args), iters=10)
            t_l = time_ms(torch, lambda: library(*args))
            b, o = cost(*args)
            b_ms, b_by = bound_ms(b, o, FP32_OPS_PER_S)
            print("kernel_time " + json.dumps({
                "kernel": kernel.__name__, "shape": [list(a.shape) for a in args], "ms": t_k,
                "plain_ms": t_p, "library_ms": t_l, "bound_ms": b_ms, "bound_by": b_by,
                "bound_share": b_ms / t_k, "kernel_ops": len(k_ops) if traced else None,
                "gpu": gpu_line}))
            ms, plain_ms, lib_ms = ms + t_k, plain_ms + t_p, lib_ms + t_l
            bytes_moved, ops = bytes_moved + b, ops + o
        b_ms, b_by = bound_ms(bytes_moved, ops, FP32_OPS_PER_S)
        line = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by)
        if per is not None:
            print("kernel_time " + json.dumps({"kernel": kernel.__name__, "per": per, **line,
                                               "bound_share": b_ms / ms, "gpu": gpu_line}))
        return line

    p_line = timed(proj_cases, project_rows, project_rows_plain, torch.matmul,
                   lambda x, m: project_cost(*x.shape, m.shape[1]))
    def row_cost(x):
        return 4 * (x.numel() + x.shape[0]), x.numel()

    s_line = timed([(x,) for x in sum_cases], row_sum, row_sum_plain, lambda x: x.sum(dim=1),
                   row_cost)
    # the longest row the kernel takes (not on the main path), on its own line
    timed([(rand(1, 32 * 1024),)], row_sum, row_sum_plain, lambda x: x.sum(dim=1), row_cost,
          per=None)
    common = dict(route="cuda", source="src/repro_torch/csrc/frontend_rows.cu", replaces=None,
                  max_abs_err=err)
    return {
        "project_rows": dict(name="project_rows", **common, **p_line),
        "row_sum": dict(name="row_sum", **common, **s_line),
    }


def project_tile_sweep(torch, rand, gpu_line) -> None:
    """``project_rows`` at the mfcc20 block's projections and the float
    layers' shapes with every tile of ``frontend.PROJECT_TILES``: each held
    bitwise to the chosen tile's output and timed beside it, so that the
    run shows what ``project_tiling`` chose and what it could have chosen.
    One ``project_tile_sweep`` line a shape."""
    from repro_torch.kernels import frontend

    chosen = frontend.project_tiling
    try:
        for r, k, n in (*MFCC20_PROJECTIONS, *FLOAT_LAYER_SHAPES.values()):
            x, m = rand(r, k), rand(k, n)
            base = chosen(r, k, n)
            want = frontend.project_rows(x, m)
            times = {}
            for tile in range(len(frontend.PROJECT_TILES)):
                frontend.project_tiling = lambda *a, t=tile: frontend.tiling_with(t, *a)
                got = frontend.project_rows(x, m)
                torch.cuda.synchronize()
                check(bitwise(torch, got, want), f"project_rows at {(r, k, n)}: tile "
                                                 f"{frontend.PROJECT_TILES[tile]} differs from "
                                                 f"the chosen tile's output")
                times[str(frontend.PROJECT_TILES[tile])] = time_ms(
                    torch, lambda: frontend.project_rows(x, m), iters=30)
            frontend.project_tiling = chosen
            best = min(times, key=times.get)
            print("project_tile_sweep " + json.dumps({
                "shape": [r, k, n], "chosen": str(frontend.PROJECT_TILES[base.tile]),
                "blocks": base.blocks, "ms": times, "fastest": best,
                "chosen_over_fastest": times[str(frontend.PROJECT_TILES[base.tile])] / times[best],
                "outputs_equal_chosen": True, "gpu": gpu_line}))
    finally:
        frontend.project_tiling = chosen


#: the float layers' row products (R, K, N) at 8 slots: dense0 of a float
#: dense0 policy at full and pruned width, pruned_mixed's fp32 dense1, and
#: the im2col rows of its bf16 conv0
FLOAT_LAYER_SHAPES = {"dense0": (8, 35072, 64), "dense0_pruned": (8, 8704, 64),
                      "dense1": (8, 64, 2), "conv0_im2col": (8768, 3, 64)}
#: float dense0 policies whose row independence is checked at full width
FLOAT_POLICIES = ("dense0/w=fp32", "dense0/w=bf16")


def float_layer_phase(torch, np, dev, gpu_line):
    """``project_rows`` at the float layers' shapes (bitwise against its
    plain version, timed beside its bound, ``torch.matmul`` and the plain
    version), then the float layers at full width: with a float dense0
    (K = 35,072) a row's logits and probabilities do not depend on its
    co-batch, and the card gives the CPU's bits.  Returns the shapes'
    numbers."""
    from repro_torch.core.precision_policy import PrecisionPolicy
    from repro_torch.data import features
    from repro_torch.kernels import frontend
    from repro_torch.kernels.frontend import project_rows, project_rows_plain
    from repro_torch.models import cnn1d
    from repro_torch.serving import accelerator as acc
    from repro_torch.serving.quantized_params import quantize_params

    rng = np.random.default_rng(SEED + 6)

    def rand(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev)

    lines = {}
    for name, (r, k, n) in FLOAT_LAYER_SHAPES.items():
        x, m = rand(r, k), rand(k, n)
        got = project_rows(x, m)
        torch.cuda.synchronize()
        want = project_rows_plain(x, m)
        check(bitwise(torch, got, want), f"project_rows disagrees at the float layer {name}")
        again = project_rows(x, m)
        torch.cuda.synchronize()
        check(bitwise(torch, again, got), f"project_rows at the float layer {name} changed its "
                                          f"bits from one call to the next")
        t_k, k_ops = device_time(torch, lambda: project_rows(x, m), iters=20)
        traced = bool(k_ops) and k_ops != ["(CUDA events)"]
        check(not traced or len(k_ops) == 1,
              f"project_rows at the float layer {name} is {len(k_ops)} device ops: {k_ops}")
        if k > 1000:
            # a launch a k of a chunk: too many device ops for a trace, so
            # CUDA events around two calls (host gaps included)
            project_rows_plain(x, m)
            t_p = events_ms(torch, lambda: project_rows_plain(x, m), iters=2)
        else:
            t_p = time_ms(torch, lambda: project_rows_plain(x, m), iters=10)
        b_ms, b_by = bound_ms(*project_cost(r, k, n), FP32_OPS_PER_S)
        lines[name] = dict(layer=name, shape=[r, k, n], ms=t_k, plain_ms=t_p,
                           library_ms=time_ms(torch, lambda: torch.matmul(x, m)),
                           bound_ms=b_ms, bound_by=b_by, bound_share=b_ms / t_k,
                           max_abs_err=max_abs(torch, got, want),
                           tiling=dataclasses.asdict(frontend.project_tiling(r, k, n)),
                           kernel_ops=len(k_ops) if traced else None, same_bits_twice=True)
        print("kernel_time " + json.dumps({"kernel": "project_rows", **lines[name],
                                           "plain_timing": "CUDA events" if k > 1000 else "CUPTI",
                                           "gpu": gpu_line}))
    project_tile_sweep(torch, rand, gpu_line)

    cfg = cnn1d.CANONICAL
    params = cnn1d.init_params(cfg, torch.Generator().manual_seed(SEED))
    feats = features.batch_features(scene_windows(np, 8, SEED + 7), "mfcc20")
    feats *= (10.0 ** rng.uniform(-2, 2, (8, 1))).astype(np.float32)
    x = torch.from_numpy(feats).to(dev)
    perm = torch.from_numpy(rng.permutation(8)).to(dev)
    padded = torch.cat([x[:3], torch.zeros((5, x.shape[1]), device=dev)])
    softmax = acc.cordic_softmax
    for policy in FLOAT_POLICIES:
        for out in ("logits", "probabilities"):
            # an artifact a pass: its CUDA graphs hold the softmax they were captured with
            qp = quantize_params(params, cfg, policy=PrecisionPolicy.parse(policy, default="int8"),
                                 device=dev)
            qp_cpu = qp.to("cpu")
            if out == "logits":  # the softmax's Q15.16 input would hide an ulp
                acc.cordic_softmax = lambda h: h
            try:
                def fwd(rows, art=qp):
                    return acc.accelerator_forward(art, rows, cfg, device=art.device)

                full = fwd(x)
                same = [bitwise(torch, full[perm], fwd(x[perm])),
                        bitwise(torch, full[:3], fwd(padded)[:3])]
                for size in (1, 3):
                    same += [bitwise(torch, full[i:i + size], fwd(x[i:i + size]))
                             for i in range(0, 8 - size + 1, size)]
                check(all(same), f"{policy}: a row's {out} depend on its co-batch on the card")
                cpu = fwd(x.cpu(), qp_cpu)
                check(bitwise(torch, full.cpu(), cpu),
                      f"{policy}: card {out} differ from the CPU's "
                      f"(max |d| {max_abs(torch, full.cpu(), cpu)})")
            finally:
                acc.cordic_softmax = softmax
        print(f"float_layers {policy} (K = {qp.denses[0]['w'].shape[0]}): logits and "
              f"probabilities bitwise independent of batch size 1/3/8, permutation and "
              f"silence padding; card == CPU bitwise")
    return lines


# ---------------------------------------------------------------------------
# phase 3: the im2col sign-off layer (K1 at M = B*L, then K3b)
# ---------------------------------------------------------------------------

SIGNOFF_LAYERS = {"conv0": (1096, 1, 64), "conv1": (548, 64, 128), "conv2": (274, 128, 256)}
SIGNOFF_ATOL = 1e-5


def signoff_phase(torch, np, dev, gpu_line, sass):
    """``cordic_activation(conv1d_q(x, w, b), "relu")`` at each canonical
    conv layer (B = 8) on the card: the main path of K3b, and K1 at
    M = B*L.  Returns the launches of that path and K3b's numbers there."""
    from repro_torch.core.quantization import int8_symmetric
    from repro_torch.kernels.conv1d_fused import conv1d_fused, conv1d_fused_q
    from repro_torch.kernels.cordic_act import apply_mode, cordic_activation
    from repro_torch.kernels.ops import _im2col, conv1d_q
    from repro_torch.kernels.quant_matmul import quant_matmul

    rng = np.random.default_rng(SEED + 2)
    layers = {}
    for name, (l, cin, cout) in SIGNOFF_LAYERS.items():
        x = np.abs(rng.standard_normal((8, l, cin))).astype(np.float32) * 2
        w = (rng.standard_normal((3, cin, cout)) * np.sqrt(2 / (3 * cin))).astype(np.float32)
        b = (rng.standard_normal(cout) * 0.1).astype(np.float32)
        layers[name] = [torch.from_numpy(a) for a in (x, w, b)]

    def layer(x, w, b):
        return cordic_activation(conv1d_q(x, w, b), "relu")

    counters = (quant_matmul, cordic_activation)
    for k in counters:
        k.launches = 0
    outs = {name: layer(*(a.to(dev) for a in args)) for name, args in layers.items()}
    torch.cuda.synchronize()
    launches = {k.__name__: k.launches for k in counters}
    want = {"quant_matmul": len(layers), "cordic_activation": len(layers)}
    check(launches == want, f"sign-off layer launches {launches} != {want}")

    relu_in = {}
    for name, (x, w, b) in layers.items():
        xd, wd, bd = x.to(dev), w.to(dev), b.to(dev)
        cpu = layer(x, w, b)
        check(bitwise(torch, outs[name].cpu(), cpu),
              f"{name}: sign-off layer on the card differs from the CPU")
        # the fused conv: the same int8 payloads give the same int32 accumulators
        k, cin, cout = w.shape
        xq, wq = int8_symmetric(xd, axis=None), int8_symmetric(wd, axis=2)
        acc_f = conv1d_fused_q(xq.q, wq.q, xq.scale, wq.scale, return_acc=True)
        acc_i = quant_matmul(_im2col(xq.q, k), wq.q.reshape(k * cin, cout),
                             xq.scale.reshape(1, 1), wq.scale.reshape(1, -1), return_acc=True)
        check(bitwise(torch, acc_f, acc_i.reshape(acc_f.shape)),
              f"{name}: fused and im2col int32 accumulators differ")
        fused = conv1d_fused(xd, wd, bd, act="relu")
        dev_err = max_abs(torch, fused, outs[name])
        ok = torch.allclose(fused, outs[name], rtol=SIGNOFF_ATOL, atol=SIGNOFF_ATOL)
        check(ok, f"{name}: fused conv vs sign-off layer max |d| {dev_err}")
        relu_in[name] = conv1d_q(xd, wd, bd)
        print(f"signoff {name} B=8 L={x.shape[1]} M={8 * x.shape[1]} K={k * cin} N={cout}: "
              f"card == cpu bitwise, accumulators == fused bitwise, "
              f"|fused - im2col| {dev_err} <= {SIGNOFF_ATOL}")

    # K3b on its main path: relu over the three layers' outputs
    ms = plain_ms = lib_ms = 0.0
    n_values = 0
    err = 0.0
    for v in relu_in.values():
        ms += time_ms(torch, lambda: cordic_activation(v, "relu"))
        plain_ms += time_ms(torch, lambda: apply_mode(v, "relu"))
        lib_ms += time_ms(torch, lambda: torch.relu(v))
        err = max(err, max_abs(torch, cordic_activation(v, "relu"), apply_mode(v, "relu")))
        n_values += v.numel()
    b_ms, b_term, terms = sass_bound_ms(n_values, 8 * n_values, sass["per_value"]["relu"],
                                        sass["sms"], sass["clock_hz"])
    floor = len(relu_in) * sass["floor_ms"]  # one launch a layer
    print("kernel_time " + json.dumps({
        "kernel": "cordic_activation", "mode": "relu", "per": "three sign-off layers",
        "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": b_ms, "bound_by": b_term,
        "bound_terms": terms, "launch_floor_ms": floor, "bound_with_floor_ms": max(b_ms, floor),
        "bound_share": max(b_ms, floor) / ms, "sass_per_value": sass["per_value"]["relu"],
        "gpu": gpu_line,
    }))
    entry = dict(name="cordic_activation", route="cuda", source="src/repro_torch/csrc/cordic_act.cu",
                 replaces="src/repro/kernels/cordic_act.py:132", max_abs_err=err, ms=ms,
                 plain_ms=plain_ms, bound_ms=b_ms, bound_by=contract_bound_by(b_term),
                 library_ms=lib_ms)
    return launches, entry


# ---------------------------------------------------------------------------
# phase 4: the on-device front-end
# ---------------------------------------------------------------------------


def scene_windows(np, n: int, seed: int):
    """``n`` seeded 0.8 s windows from the port's scene synthesisers: UAV
    and background in turn, each at an SNR in [8, 20] dB."""
    from repro_torch.data import acoustic

    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n):
        x = acoustic.synth_uav(rng) if i % 2 == 0 else acoustic.synth_background(rng)
        rows.append(acoustic.add_noise_snr(x, float(rng.uniform(8, 20)), rng))
    return np.stack(rows).astype(np.float32)


def frontend_phase(torch, np, dev, gpu_line):
    """``feature_rows`` on the card for every kind: parity with the numpy
    oracle and bitwise row independence; then which library hazards the
    card shows on the same shapes."""
    from repro_torch.data import features
    from repro_torch.data.features_torch import PARITY_ATOL, feature_rows

    w = scene_windows(np, 8, SEED + 3)
    x = torch.from_numpy(w).to(dev)
    perm = torch.from_numpy(np.random.default_rng(0).permutation(8)).to(dev)
    padded = torch.cat([x[:3], torch.zeros((5, x.shape[1]), device=dev)])
    for kind in sorted(features.FEATURE_DIMS):
        full = feature_rows(x, kind)
        oracle = features.batch_features(w, kind)
        dev_max = float(np.abs(full.cpu().numpy() - oracle).max())
        check(dev_max <= PARITY_ATOL[kind], f"{kind}: card features {dev_max} from numpy")
        same = [bitwise(torch, full[perm], feature_rows(x[perm], kind)),
                bitwise(torch, full[:3], feature_rows(padded, kind)[:3])]
        for size in (1, 3):
            same += [bitwise(torch, full[i:i + size], feature_rows(x[i:i + size], kind))
                     for i in range(0, 8 - size + 1, size)]
        check(all(same), f"{kind}: a row's features depend on its co-batch on the card")
        print(f"frontend {kind}: max |card - numpy| {dev_max} <= {PARITY_ATOL[kind]}; rows "
              f"bitwise independent of batch size 1/3/8, permutation and silence padding")

    # the hazards the fixed-order primitives and per-window FFTs avoid:
    # does a row's result change with its co-batch if the library does it?
    rng = np.random.default_rng(SEED + 4)
    p = torch.from_numpy(np.abs(rng.standard_normal((8, 51, 513))).astype(np.float32)).to(dev)
    mel = torch.from_numpy(np.abs(rng.standard_normal((513, 64))).astype(np.float32)).to(dev)
    v = torch.from_numpy(rng.standard_normal((8, 1096)).astype(np.float32)).to(dev)
    f = torch.from_numpy(rng.standard_normal((8, 51, 1024)).astype(np.float32)).to(dev)
    batched_mm = (p.reshape(-1, 513) @ mel).reshape(8, 51, 64)
    batched_fft = torch.view_as_real(torch.fft.rfft(f, dim=-1))
    hazards = {
        "a_cublas_projection": any(not bitwise(torch, batched_mm[i], p[i] @ mel) for i in range(8)),
        "b_torch_reductions": any(
            not bitwise(torch, red(v)[i:i + 1], red(v[i:i + 1]))
            for red in (lambda t: t.mean(dim=1), lambda t: t.sum(dim=1), lambda t: t.std(dim=1))
            for i in range(8)),
        "c_cufft_batch_count": any(
            not bitwise(torch, batched_fft[i], torch.view_as_real(torch.fft.rfft(f[i], dim=-1)))
            for i in range(8)),
    }
    print("frontend_hazards " + json.dumps({**hazards, "gpu": gpu_line}))
    return hazards


# ---------------------------------------------------------------------------
# phase 5: the serving cells
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


def launches_per_forward(qp, *, raw: bool) -> dict[str, int]:
    """Kernel launches of one forward of the artifact ``qp``: K2 a 8-bit
    conv, K1 a 8-bit dense layer, ``project_rows`` a float layer, K3 once;
    with ``raw`` the mfcc20 front-end's two projections and eight row sums."""
    conv_modes, dense_modes = qp.layer_modes
    eight_bit = ("int8", "fxp8")
    return {
        "conv1d_fused_q": sum(m in eight_bit for m in conv_modes),
        "quant_matmul": sum(m in eight_bit for m in dense_modes),
        "cordic_softmax": 1,
        "project_rows": sum(m not in eight_bit for m in conv_modes + dense_modes)
        + (2 if raw else 0),
        "row_sum": 8 if raw else 0,
    }


def engine_phase(torch, np, dev, gpu_line):
    from repro_torch.core.precision_policy import PrecisionPolicy
    from repro_torch.core.pruning import plan_prune
    from repro_torch.data import features
    from repro_torch.kernels.conv1d_fused import conv1d_fused_q
    from repro_torch.kernels.cordic_act import cordic_softmax
    from repro_torch.kernels.frontend import project_rows
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
    kernels = (quant_matmul, conv1d_fused_q, cordic_softmax, project_rows)
    launches = {k.__name__: 0 for k in kernels}
    runs = {}
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
        want = {name: blocks * n
                for name, n in launches_per_forward(gpu.artifact, raw=False).items()
                if name in counts}
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
        check(bool(ops), f"{cell}: the CUPTI trace of a serving run holds no device activity")
        busy = sum(e.time_range.elapsed_us() for e in ops) / 1e6 / traced_wall

        cpu_scores, cpu_events, _, _ = serve(engines["cpu"], audio, chunks)
        got = [dataclasses.astuple(w) for w in scores]
        ref = [dataclasses.astuple(w) for w in cpu_scores]
        dp = max(abs(a[2] - b[2]) for a, b in zip(got, ref))
        check(got == ref, f"{cell}: card scores differ from the CPU run (max |dp| {dp})")
        check(events == cpu_events, f"{cell}: card events differ from the CPU run")
        runs[cell] = (gpu.artifact, scores, events)
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
    return launches, runs


def ondevice_phase(torch, np, dev, gpu_line):
    """The ``int8_ondevice`` cell through the driver: the canonical mfcc20
    detector baked with its front-end, served from raw windows on the card
    and on the CPU.  Returns the launches of the card's run."""
    import contextlib
    import io
    import tempfile

    from repro_torch.data import features
    from repro_torch.data.features_torch import PARITY_ATOL, feature_rows
    from repro_torch.kernels.conv1d_fused import conv1d_fused_q
    from repro_torch.kernels.cordic_act import cordic_softmax
    from repro_torch.kernels.frontend import project_rows, row_sum
    from repro_torch.kernels.quant_matmul import quant_matmul
    from repro_torch.launch import monitor
    from repro_torch.models import cnn1d
    from repro_torch.serving.accelerator import accelerator_forward
    from repro_torch.serving.quantized_params import load_artifact, quantize_params, save_artifact

    cfg = cnn1d.CANONICAL
    params = cnn1d.init_params(cfg, torch.Generator().manual_seed(SEED))
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "detector_int8_ondevice.npz"
        save_artifact(path, quantize_params(params, cfg, feature_kind="mfcc20", device="cpu"))
        argv = ["--artifact", str(path), "--device-features", "--streams", str(N_STREAMS),
                "--duration", str(SECONDS), "--slots", str(SLOTS), "--seed", str(SEED)]

        def drive(device):
            log = io.StringIO()
            with contextlib.redirect_stdout(log):
                run = monitor.main([*argv, "--device", device])
            summary = [ln for ln in log.getvalue().splitlines() if "windows/s" in ln]
            print(f"driver[{device}] {summary[0].strip() if summary else '(no summary)'}")
            return run

        kernels = (quant_matmul, conv1d_fused_q, cordic_softmax, project_rows, row_sum)
        drive("cuda")  # warm-up: first-touch allocations and FFT plans
        torch.cuda.synchronize()
        for k in kernels:
            k.launches = 0
        run = drive("cuda")
        torch.cuda.synchronize()
        counts = {k.__name__: k.launches for k in kernels}
        qp = run.engine.artifact
        blocks = run.engine.forward_calls
        want = {name: blocks * n for name, n in launches_per_forward(qp, raw=True).items()}
        print(f"engine_launches cell=int8_ondevice blocks={blocks} counts={counts} expected={want}")
        check(counts == want, f"int8_ondevice: kernel launches {counts} != {want}")
        n_windows = N_STREAMS * int(SECONDS / features.WINDOW_S)
        check(len(run.scores) == n_windows,
              f"int8_ondevice: {len(run.scores)} windows scored, want {n_windows}")

        # every window at once through the raw-window forward: the same bits
        wins = np.concatenate([s.reshape(-1, features.N_SAMPLES) for s in run.scenes])
        raw = torch.from_numpy(wins).to(dev)
        probs = accelerator_forward(qp, raw, cfg, device=dev, raw_windows=True).cpu().numpy()
        check(np.isfinite(probs).all(), "int8_ondevice: non-finite probabilities")
        row_err = float(np.abs(probs.sum(axis=1) - 1.0).max())
        check(row_err <= 1e-6, f"int8_ondevice: rows sum to 1 only within {row_err}")
        order = sorted(run.scores, key=lambda w: (w.stream, w.window_idx))
        check(np.array_equal(probs[:, 1].astype(np.float64), [w.p_uav for w in order]),
              "int8_ondevice: batched raw-window forward differs from the streamed scores")

        # the card against the CPU: features within tolerance, scores compared
        feat_card = feature_rows(raw, "mfcc20").cpu().numpy()
        feat_cpu = feature_rows(torch.from_numpy(wins), "mfcc20").numpy()
        feat_dev = float(np.abs(feat_card - feat_cpu).max())
        check(feat_dev <= PARITY_ATOL["mfcc20"],
              f"int8_ondevice: card vs CPU features {feat_dev} > {PARITY_ATOL['mfcc20']}")
        cpu_run = drive("cpu")
        got = sorted(run.scores, key=lambda w: (w.stream, w.window_idx))
        ref = sorted(cpu_run.scores, key=lambda w: (w.stream, w.window_idx))
        check([(a.stream, a.window_idx) for a in got] == [(b.stream, b.window_idx) for b in ref],
              "int8_ondevice: card and CPU scored different windows")
        dp = max(abs(a.p_uav - b.p_uav) for a, b in zip(got, ref))
        agree = float(np.mean([(a.p_uav > 0.5) == (b.p_uav > 0.5) for a, b in zip(got, ref)]))

        # where a round's time goes: the front-end and the whole forward on
        # the device, and the card's busy share over a traced driver run
        block = raw[:SLOTS]
        fe_dev = time_ms(torch, lambda: feature_rows(block, "mfcc20"))
        fwd_dev = time_ms(torch, lambda: accelerator_forward(qp, block, cfg, device=dev,
                                                             raw_windows=True))
        fwd_call = call_ms(torch, lambda: accelerator_forward(qp, block, cfg, device=dev,
                                                              raw_windows=True), iters=20)
        t0 = time.perf_counter()
        ops = device_ops(torch, lambda: drive("cuda"), iters=1)
        traced_wall = time.perf_counter() - t0
        check(bool(ops), "int8_ondevice: the CUPTI trace of a driver run holds no device activity")
        busy = sum(e.time_range.elapsed_us() for e in ops) / 1e6 / traced_wall
    print("engine " + json.dumps({
        "cell": "int8_ondevice", "flatten": cfg.flatten_size, "via": "repro_torch.launch.monitor",
        "windows": len(run.scores), "blocks": blocks,
        "windows_per_s": len(run.scores) / run.seconds,
        "round_p50_ms": statistics.median(run.round_seconds) * 1e3,
        "rounds": len(run.round_seconds), "events": sum(len(e) for e in run.events),
        "max_abs_dp_vs_cpu": dp, "decision_agreement_vs_cpu": agree,
        "max_abs_feature_dev_vs_cpu": feat_dev, "row_sum_err": row_err,
        "frontend_device_ms_per_block": fe_dev, "forward_device_ms_per_block": fwd_dev,
        "forward_call_ms_per_block": fwd_call, "device_busy_share": busy,
        "device_ops_per_run": len(ops), "gpu": gpu_line,
    }))
    return counts


# ---------------------------------------------------------------------------
# phase 6: the fault-tolerant, durable fleet
# ---------------------------------------------------------------------------

FLEET_WORKERS = 2
#: tracker thresholds inside the random detector's score range (0.09-0.35
#: on this scene), so that tracks open and close and events are compared
FLEET_TRACK = dict(ema_alpha=0.7, enter_threshold=0.2, exit_threshold=0.15, min_duration=1)


def score_key(scores) -> list:
    """Window scores as comparable tuples, in (stream, window) order: a
    fleet returns a round's windows worker by worker."""
    return sorted(dataclasses.astuple(w) for w in scores)


def fleet_plan(np, faults_mod, n_rounds: int, *, lossy: bool):
    """A seeded plan with a crash, a stall and a kill on the workers and
    (``lossy``) a dropped and a corrupted chunk, always a jittered one."""
    rng = np.random.default_rng(SEED)
    rounds = sorted(int(r) for r in rng.choice(np.arange(1, n_rounds - 1), 6, replace=False))
    streams = rng.permutation(N_STREAMS)
    Fault = faults_mod.Fault
    faults = [
        Fault("raise_forward", rounds[0], worker=0, magnitude=2),
        Fault("stall_forward", rounds[1], worker=1, magnitude=5.0),
        Fault("kill_worker", rounds[2], worker=0),
        Fault("jitter_chunk", rounds[3], stream=int(streams[0]), magnitude=0.4),
    ]
    if lossy:
        faults += [Fault("drop_chunk", rounds[4], stream=int(streams[1])),
                   Fault("corrupt_chunk", rounds[5], stream=int(streams[2]))]
    return faults_mod.FaultPlan(faults, seed=SEED)


def serve_events_timed(torch, engine, audio, chunks, *, upto=None, start=0, cursor=None):
    """``serve`` with CUDA events around every ``step`` and the whole run;
    ``upto=k`` stops mid-round k (its chunks pushed, no step), ``start`` and
    ``cursor`` skip the rounds and chunks a restored fleet holds.  Returns
    (scores, round ms of the steps that scored, run ms)."""
    scores, rounds_ms, marks = [], [], []
    cursor = [0] * N_STREAMS if cursor is None else [int(c) for c in cursor]
    ordinals = [0] * N_STREAMS
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0.record()

    def step():
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        got = engine.step()
        b.record()
        if got:
            marks.append((a, b))
        scores.extend(got)
        return got

    for r, rnd in enumerate(chunks):
        for s, lo, hi in rnd:
            if ordinals[s] >= cursor[s]:
                engine.push(s, audio[s, lo:hi])
            ordinals[s] += 1
        if r < start:
            continue
        if upto is not None and r >= upto:
            break
        step()
    else:
        while step():
            pass
    t1.record()
    torch.cuda.synchronize()
    rounds_ms = [a.elapsed_time(b) for a, b in marks]
    return scores, rounds_ms, t0.elapsed_time(t1)


def fleet_phase(torch, np, dev, gpu_line, artifact, mono_scores, mono_events):
    """The fleet (``FleetSupervisor``) on the card over the engine phase's
    int8 artifact and scene, with tracker thresholds that open tracks on
    it: sequential and lane fleets equal the monolithic card run bitwise, a seeded fault plan is lossless where the reference
    is, a worker past ``max_rebuilds`` is reassigned losslessly, a cold
    restart from a state dir equals the uninterrupted run, spawn and retire
    are lossless, and the driver's fleet flags serve on the card.  Every
    block of every worker goes through K2 x3, K1 x2 and K3.  Returns the
    launches of the sequential and lane fleets' runs."""
    import contextlib
    import io
    import statistics as st
    import tempfile

    from repro_torch.data import features
    from repro_torch.kernels import conv1d_fused as tconv
    from repro_torch.kernels.conv1d_fused import conv1d_fused_q
    from repro_torch.kernels.cordic_act import cordic_softmax
    from repro_torch.kernels.quant_matmul import quant_matmul
    from repro_torch.launch import monitor
    from repro_torch.models import cnn1d
    from repro_torch.serving import faults as faults_mod
    from repro_torch.serving.durability import LocalFilesystem
    from repro_torch.serving.engine import MonitorEngine, SanitizePolicy
    from repro_torch.serving.quantized_params import save_artifact
    from repro_torch.serving.supervisor import FleetSupervisor

    t_phase = time.perf_counter()
    cfg = cnn1d.CANONICAL
    audio, chunks = make_audio(np, features)
    kw = dict(feature_kind="mfcc20", batch_slots=SLOTS, device=dev, **FLEET_TRACK)
    fleet_kw = dict(kw, sanitize=SanitizePolicy())
    kernels = (quant_matmul, conv1d_fused_q, cordic_softmax)

    def fleet(**extra):
        return FleetSupervisor(artifact, cfg, n_streams=N_STREAMS, n_workers=FLEET_WORKERS,
                               **fleet_kw, **extra)

    def same(name, scores, events, streams=range(N_STREAMS)):
        got = [t for t in score_key(scores) if t[0] in streams]
        want = [t for t in want_scores if t[0] in streams]
        check(got == want, f"fleet {name}: scores differ from the monolithic card run")
        check([events[s] for s in streams] == [want_events[s] for s in streams],
              f"fleet {name}: events differ from the monolithic card run")

    def counted(name, sup, run):
        for k in kernels:
            k.launches = 0
        out = run()
        torch.cuda.synchronize()
        counts = {k.__name__: k.launches for k in kernels}
        blocks = sup.forward_calls
        per_worker = [w.engine.forward_calls for w in sup.workers if w.alive]
        want = {"quant_matmul": 2 * blocks, "conv1d_fused_q": 3 * blocks,
                "cordic_softmax": blocks}
        print(f"fleet_launches {name} blocks={blocks} per_worker={per_worker} "
              f"counts={counts} expected={want}")
        check(counts == want and blocks == sum(per_worker),
              f"fleet {name}: kernel launches {counts} != {want}")
        return out, counts

    # the monolith once more, with the fleet's tracker: the same windows and
    # probabilities as phase 5's card run
    mono = MonitorEngine(artifact, cfg, n_streams=N_STREAMS, **kw)
    m_scores, _, _ = serve_events_timed(torch, mono, audio, chunks)
    check([t[:3] for t in score_key(m_scores)] == [t[:3] for t in score_key(mono_scores)],
          "fleet: the monolith's probabilities differ from phase 5's card run")
    want_scores, want_events = score_key(m_scores), mono.finalize()
    check(sum(len(e) for e in want_events) > 0, "fleet: the monolith closed no track")
    packs0 = tconv.packed_weight.packs
    launches: dict[str, int] = {}

    # 1. sequential and lane fleets equal the monolith, every block on the kernels
    for name, lanes in (("sequential", None), ("lanes", "threads")):
        sup = fleet(lanes=lanes)
        (scores, _, _), counts = counted(
            name, sup, lambda: serve_events_timed(torch, sup, audio, chunks))
        same(name, scores, sup.finalize())
        check(all(w.engine.artifact is artifact for w in sup.workers),
              f"fleet {name}: a worker serves a copy of the artifact")
        for k, c in counts.items():
            launches[k] = launches.get(k, 0) + c
        sup.close()

    # 2. seeded fault plans, sequential and with lanes: never raise, lossless
    #    where the reference is (the lossless plan: every stream)
    n_rounds = len(chunks)
    rebuilds = 0
    for lossy in (True, False):
        plan = fleet_plan(np, faults_mod, n_rounds, lossy=lossy)
        for lanes in (None, "threads"):
            sup = fleet(lanes=lanes, faults=faults_mod.FaultPlan(list(plan.faults), seed=SEED),
                        clock=faults_mod.FaultClock(), dispatch_deadline_s=1.0)
            (scores, _, _), _ = counted(f"plan lossy={lossy} lanes={lanes}", sup,
                                        lambda: serve_events_timed(torch, sup, audio, chunks))
            kinds = sorted(i["kind"] for i in sup.incidents)
            check(kinds == ["crash", "crash", "kill", "stall"],
                  f"fleet plan: incidents {kinds}")
            clean = set(range(N_STREAMS)) - plan.affected_streams
            same(f"plan lossy={lossy}", scores, sup.finalize(), sorted(clean))
            rebuilds += sum(w.rebuilds for w in sup.workers)
            sup.close()
    # 3. a worker killed past max_rebuilds moves its streams, losslessly
    plan = faults_mod.FaultPlan([faults_mod.Fault("kill_worker", 1, worker=0),
                                 faults_mod.Fault("kill_worker", 2, worker=0)])
    sup = fleet(faults=plan, clock=faults_mod.FaultClock(), max_rebuilds=1)
    (scores, _, _), _ = counted("reassign", sup,
                                lambda: serve_events_timed(torch, sup, audio, chunks))
    check([i["kind"] for i in sup.incidents] == ["kill", "kill", "reassign"]
          and not sup.workers[0].alive, f"fleet reassign: incidents {sup.incidents}")
    same("reassign", scores, sup.finalize())
    repacks = tconv.packed_weight.packs - packs0
    print(f"fleet_recovery rebuilds={rebuilds + 2} K2 weight packs during the fleet runs="
          f"{repacks} (revived workers found their packed weights cached: {repacks == 0})")
    check(repacks == 0, f"fleet: revived workers packed K2's weights {repacks} times")

    # revive time: a worker rebuilt from the artifact and its last good state
    sup = fleet(max_rebuilds=10 ** 6)
    serve_events_timed(torch, sup, audio, chunks[:2], upto=None)
    revive_ms = []
    for _ in range(5):
        for w in sup.workers:
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            sup._revive(w)
            b.record()
            torch.cuda.synchronize()
            revive_ms.append(a.elapsed_time(b))

    # 4. durable state: bytes written a round, and a cold restart mid-scene
    class CountingFS(LocalFilesystem):
        def __init__(self):
            self.bytes = {"checkpoint": 0, "wal": 0}

        def write(self, fh, data):
            kind = "wal" if fh.name.endswith("wal.log") else "checkpoint"
            self.bytes[kind] += len(data)
            return super().write(fh, data)

    with tempfile.TemporaryDirectory() as tmp:
        fs = CountingFS()
        sup = fleet(state_dir=str(Path(tmp) / "full"), fs=fs)
        scores, _, _ = serve_events_timed(torch, sup, audio, chunks)
        same("state_dir", scores, sup.finalize())
        per_round = {k: v / sup.round for k, v in fs.bytes.items()}
        d = str(Path(tmp) / "crash")
        cut = n_rounds // 2
        first = fleet(state_dir=d)
        head, _, _ = serve_events_timed(torch, first, audio, chunks, upto=cut)
        del first  # abandoned mid-round (its chunks delivered, no step): no close()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        restored = FleetSupervisor.restore_from_dir(artifact, cfg, state_dir=d, lanes="threads",
                                                    **fleet_kw)
        b.record()
        torch.cuda.synchronize()
        restore_ms = a.elapsed_time(b)
        check(restored is not None and restored.round == cut and restored.replayed_chunks > 0,
              f"fleet restore: round {None if restored is None else restored.round} != {cut} "
              f"or no chunk replayed from the WAL")
        tail, _, _ = serve_events_timed(torch, restored, audio, chunks, start=restored.round,
                                        cursor=restored.pushed_chunks)
        merged = {(w.stream, w.window_idx): dataclasses.astuple(w) for w in head + tail}
        check(sorted(merged.values()) == want_scores,
              "fleet cold restart: scores differ from the uninterrupted run")
        check(restored.finalize() == want_events, "fleet cold restart: events differ")
        replayed = restored.replayed_chunks
        restored.close()

        # 5. spawn and retire mid-scene
        sup = FleetSupervisor(artifact, cfg, n_streams=N_STREAMS, n_workers=1, **fleet_kw)
        third, scores = n_rounds // 3, []
        for r, rnd in enumerate(chunks):
            if r == third:
                check(sup.spawn_worker() == 1, "fleet: spawn_worker found no donor")
            if r == 2 * third:
                check(sup.retire_worker(1), "fleet: retire_worker refused")
            for s, lo, hi in rnd:
                sup.push(s, audio[s, lo:hi])
            scores += sup.step()
        while got := sup.step():
            scores += got
        same("spawn/retire", scores, sup.finalize())
        check([i["kind"] for i in sup.incidents] == ["spawn", "retire"],
              f"fleet spawn/retire: incidents {sup.incidents}")

        # 6. the driver's fleet flags on the card, run twice on one state dir
        path = Path(tmp) / "detector_int8.npz"
        save_artifact(path, artifact.to("cpu"))
        argv = ["--artifact", str(path), "--feature", "mfcc20", "--streams", str(N_STREAMS),
                "--duration", str(SECONDS), "--slots", str(SLOTS), "--seed", str(SEED),
                "--device", dev.type]
        state = str(Path(tmp) / "driver")

        def drive(extra):
            log = io.StringIO()
            with contextlib.redirect_stdout(log):
                run = monitor.main([*argv, *extra])
            return run, log.getvalue()

        plain, _ = drive([])
        for attempt in ("first", "rerun"):
            run, log = drive(["--workers", "2", "--lanes", "threads", "--state-dir", state])
            check(isinstance(run.engine, FleetSupervisor), "driver: no fleet")
            check(run.events == plain.events, f"driver fleet ({attempt}): events differ")
            check(run.engine.windows_scored == plain.engine.windows_scored,
                  f"driver fleet ({attempt}): windows scored differ")
            if attempt == "first":
                check(score_key(run.scores) == score_key(plain.scores),
                      "driver fleet: scores differ from the plain run")
            else:
                check("resumed from state dir" in log, "driver rerun did not resume")
        n_driver_events = sum(len(e) for e in plain.events)

    # windows/s and round p50: three turns of every way of serving, in
    # alternating order; "lanes_switch_0.5ms" runs the lane fleet with the
    # interpreter's thread switch interval cut from 5 to 0.5 ms (lanes hand
    # the interpreter lock back and forth at every block's harvest)
    def serve_once(name):
        if name == "monolith":
            engine = MonitorEngine(artifact, cfg, n_streams=N_STREAMS, **kw)
        else:
            engine = fleet(lanes=None if name == "sequential" else "threads")
        old = sys.getswitchinterval()
        if name == "lanes_switch_0.5ms":
            sys.setswitchinterval(0.0005)
        try:
            scores, rounds, ms = serve_events_timed(torch, engine, audio, chunks)
        finally:
            sys.setswitchinterval(old)
        check(score_key(scores) == want_scores, f"fleet {name}: timed run's scores differ")
        if name != "monolith":
            engine.close()
        return len(scores) / (ms / 1e3), st.median(rounds)

    kinds = ("monolith", "sequential", "lanes", "lanes_switch_0.5ms")
    turns = {k: [] for k in kinds}
    for turn in range(3):
        for name in (kinds if turn % 2 == 0 else kinds[::-1]):
            turns[name].append(serve_once(name))
    timing = {k: {"windows_per_s": st.median(v[0] for v in runs),
                  "round_p50_ms": st.median(v[1] for v in runs),
                  "windows_per_s_runs": [v[0] for v in runs]}
              for k, runs in turns.items()}

    seconds = time.perf_counter() - t_phase
    print("fleet " + json.dumps({
        "workers": FLEET_WORKERS, "streams": N_STREAMS, "slots": SLOTS, **timing,
        "revive_ms_p50": st.median(revive_ms),
        "revive_ms_max": max(revive_ms), "restore_from_dir_ms": restore_ms,
        "replayed_chunks": replayed, "checkpoint_bytes_per_round": per_round["checkpoint"],
        "wal_bytes_per_round": per_round["wal"], "k2_repacks": repacks,
        "driver_events": n_driver_events, "timing": "CUDA events", "phase_seconds": seconds,
        "gpu": gpu_line,
    }))
    return launches


# ---------------------------------------------------------------------------
# phase 7: sharded dispatch
# ---------------------------------------------------------------------------

#: shard counts run as entries of one card (the ROADMAP M8 gate on one H100)
SHARD_COUNTS = (2, 4)


def sharded_phase(torch, np, dev, gpu_line, runs):
    """Phase 5's int8 and pruned_mixed cells, and the on-device int8 cell,
    served by ``MonitorEngine`` over meshes of 2 and 4 entries of one card
    (and over every card when the host has several): scores and events
    bitwise the unsharded engine's, every block exactly k x one forward's
    launches; then the driver's ``--shards 1`` run against its plain run.
    Returns the sharded runs' launches."""
    import contextlib
    import io
    import tempfile

    from repro_torch.data import features
    from repro_torch.distributed.sharding import StreamMesh, stream_mesh
    from repro_torch.kernels.conv1d_fused import conv1d_fused_q
    from repro_torch.kernels.cordic_act import cordic_softmax
    from repro_torch.kernels.frontend import project_rows, row_sum
    from repro_torch.kernels.quant_matmul import quant_matmul
    from repro_torch.launch import monitor
    from repro_torch.models import cnn1d
    from repro_torch.serving.engine import MonitorEngine
    from repro_torch.serving.quantized_params import quantize_params, save_artifact

    cfg = cnn1d.CANONICAL
    audio, chunks = make_audio(np, features)
    kernels = (quant_matmul, conv1d_fused_q, cordic_softmax, project_rows, row_sum)
    meshes = {}
    for k in SHARD_COUNTS:
        mesh = StreamMesh((dev,) * k)
        meshes[f"{mesh.devices[0]}x{k}"] = mesh
    n_cards = torch.cuda.device_count()
    if n_cards > 1:
        meshes[f"cards{n_cards}"] = stream_mesh(n_cards)
    params = cnn1d.init_params(cfg, torch.Generator().manual_seed(SEED))
    cells = {"int8": (runs["int8"][0], False), "pruned_mixed": (runs["pruned_mixed"][0], False),
             "int8_ondevice": (quantize_params(params, cfg, feature_kind="mfcc20", device=dev),
                               True)}
    launches: dict[str, int] = {}

    def counted(engine):
        engine.precompile()
        torch.cuda.synchronize()
        for k in kernels:
            k.launches = 0
        out = serve(engine, audio, chunks)
        torch.cuda.synchronize()
        return out, {k.__name__: k.launches for k in kernels}

    for cell, (art, raw) in cells.items():
        kw = dict(n_streams=N_STREAMS, feature_kind="mfcc20", on_device_features=raw,
                  batch_slots=SLOTS, device=dev)
        base = MonitorEngine(art, cfg, **kw)
        (b_scores, b_events, b_wall, b_rounds), _ = counted(base)
        b_key = [dataclasses.astuple(w) for w in b_scores]
        if cell in runs:
            check(b_key == [dataclasses.astuple(w) for w in runs[cell][1]]
                  and b_events == runs[cell][2], f"sharded {cell}: the unsharded engine "
                  f"differs from phase 5's card run")
        per_forward = launches_per_forward(art, raw=raw)
        for label, mesh in meshes.items():
            eng = MonitorEngine(art, cfg, mesh=mesh, **kw)
            (scores, events, wall, rounds), counts = counted(eng)
            k, blocks = mesh.size, eng.forward_calls
            want = {name: k * n * blocks for name, n in per_forward.items()}
            print(f"sharded_launches cell={cell} mesh={label} blocks={blocks} counts={counts} "
                  f"expected={want}")
            check(counts == want, f"sharded {cell} over {label}: launches {counts} != {want}")
            check([dataclasses.astuple(w) for w in scores] == b_key,
                  f"sharded {cell} over {label}: scores differ from the unsharded engine")
            check(events == b_events, f"sharded {cell} over {label}: events differ")
            for name, c in counts.items():
                launches[name] = launches.get(name, 0) + c
            print("sharded " + json.dumps({
                "cell": cell, "mesh": label, "shards": k,
                "devices": sorted({str(d) for d in mesh.devices}), "windows": len(scores),
                "blocks": blocks, "windows_per_s": len(scores) / wall,
                "round_p50_ms": statistics.median(rounds) * 1e3,
                "unsharded_windows_per_s": len(b_scores) / b_wall,
                "unsharded_round_p50_ms": statistics.median(b_rounds) * 1e3,
                "scores_events_bitwise": True, "gpu": gpu_line,
            }))

    # the driver: --shards 1 (and --shards <every card>) against its plain run
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "detector_int8_ondevice.npz"
        save_artifact(path, cells["int8_ondevice"][0].to("cpu"))
        argv = ["--artifact", str(path), "--device-features", "--streams", str(N_STREAMS),
                "--duration", str(SECONDS), "--slots", str(SLOTS), "--seed", str(SEED)]

        def drive(extra):
            log = io.StringIO()
            with contextlib.redirect_stdout(log):
                run = monitor.main([*argv, *extra])
            return run, log.getvalue()

        plain, _ = drive([])
        for k in sorted({1, max(1, n_cards)}):
            run, log = drive(["--shards", str(k)])
            check(f"sharded dispatch over {k} device(s)" in log and run.engine.shards == k,
                  f"driver --shards {k}: no sharded dispatch")
            check([dataclasses.astuple(w) for w in run.scores]
                  == [dataclasses.astuple(w) for w in plain.scores]
                  and run.events == plain.events,
                  f"driver --shards {k}: scores or events differ from the plain run")
            print(f"sharded driver --shards {k}: {len(run.scores)} windows, scores and events "
                  f"== the plain driver run")
    return launches


# ---------------------------------------------------------------------------
# phase 8: detector training and analysis
# ---------------------------------------------------------------------------

#: test-split correct decisions (of 300) of the JAX reference's canonical
#: mfcc20 detector, ``train_detector`` seeds 0, 1 and 2 with the cached
#: detector's settings, calibrated as ``get_detector`` does; JAX on the
#: CPU, from ``scripts/jax_reference_band.py``
REFERENCE_CORRECT = {
    "fp32": (281, 277, 284), "bf16": (281, 277, 284), "int8": (285, 276, 286),
    "fxp8": (285, 276, 284), "sensitivity": (285, 278, 285),
    "pruned_fp32": (253, 286, 236), "pruned_int8": (268, 287, 242),
}
N_TEST = 300
#: the port's FP32 test accuracy must lie within 2 points of the
#: reference's seeds
FP32_BAND = (min(REFERENCE_CORRECT["fp32"]) / N_TEST - 0.02,
             max(REFERENCE_CORRECT["fp32"]) / N_TEST + 0.02)
#: card vs CPU emulation logits under FP32, relative to the largest
#: |logit|: float32 sums in another order stay near 1e-6, TF32 products
#: (10-bit mantissas) would land near 1e-3
EMULATION_RTOL = 1e-4
DETERMINISM_STEPS = 20


def training_phase(torch, np, dev, gpu_line) -> dict[str, int]:
    """Train the canonical detector on the card with the reference's corpus
    and settings, check it (device, finite loss, bitwise-deterministic
    seeded steps, card vs CPU emulation, FP32 accuracy in the JAX
    reference's band), score its emulation modes, bake and serve its
    int8, fxp8 and pruned + sensitivity-policy artifacts through K1-K3
    (card == CPU bitwise for int8), and drive the driver's quick-train and
    ``--trained`` paths.  Returns the launches of the serving steps."""
    import contextlib
    import io

    from repro_torch.core.precision_policy import Precision, PrecisionPolicy
    from repro_torch.data import features
    from repro_torch.kernels.conv1d_fused import conv1d_fused_q
    from repro_torch.kernels.cordic_act import cordic_softmax
    from repro_torch.kernels.frontend import project_rows
    from repro_torch.kernels.quant_matmul import quant_matmul
    from repro_torch.launch import monitor
    from repro_torch.models import cnn1d
    from repro_torch.serving.accelerator import accelerator_forward, deviation_report
    from repro_torch.serving.quantized_params import quantize_params
    from repro_torch.training import detector_artifact as tdet
    from repro_torch.training import loop
    from repro_torch.training.checkpoint import save_checkpoint

    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    ds = tdet.dataset_cached()
    feats = tdet.features_cached(ds, "mfcc20")
    corpus_s = time.perf_counter() - t0
    n_tr, n_va = tdet.SPLIT
    labels = ds.labels
    test_x, test_y = feats[n_tr + n_va:], labels[n_tr + n_va:]
    check(len(test_y) == N_TEST, f"test split holds {len(test_y)} windows, want {N_TEST}")
    cfg = cnn1d.CNNConfig(input_len=features.FEATURE_DIMS["mfcc20"])
    check(cfg.flatten_size == 35_072, f"flatten {cfg.flatten_size} != 35072")

    def events():
        a = torch.cuda.Event(enable_timing=True)
        a.record()
        return a

    # 1. train on the card (the reference's settings), timed with CUDA events
    torch.cuda.synchronize()
    start = events()
    res = loop.train_detector(feats[:n_tr], labels[:n_tr], feats[n_tr:n_tr + n_va],
                              labels[n_tr:n_tr + n_va], cfg, epochs=14, batch=64, patience=5,
                              seed=0, device=dev)
    end = events()
    torch.cuda.synchronize()
    train_s = start.elapsed_time(end) / 1e3
    epochs_run = len(res.history)
    steps = epochs_run * (n_tr // 64)
    losses = [h["loss"] for h in res.history]
    check(all(t.device.type == "cuda" for leaves in res.params.values() for t in leaves.values()),
          "trained params are not on the card")
    check(all(np.isfinite(losses)), f"non-finite training loss {losses}")
    save_checkpoint(tdet.model_dir("mfcc20"), 1, res.params)

    # 2. seeded steps twice: the same bits, params and optimizer state
    x_train = torch.as_tensor(feats[:n_tr], device=dev)
    y_train = torch.as_tensor(labels[:n_tr], device=dev)

    def seeded_steps(seed):
        gen = torch.Generator(device=dev).manual_seed(seed)
        params = cnn1d.init_params(cfg, gen)
        state = loop.OPT.init(params)
        order = np.random.default_rng(seed).permutation(n_tr)
        torch.cuda.synchronize()
        a = events()
        for i in range(DETERMINISM_STEPS):
            idx = torch.as_tensor(order[i * 64:(i + 1) * 64], device=dev)
            params, state, _ = loop.train_step(params, state, x_train[idx], y_train[idx], gen, cfg)
        b = events()
        torch.cuda.synchronize()
        return params, state, a.elapsed_time(b) / DETERMINISM_STEPS

    (p1, s1, _), (p2, s2, step_ms) = seeded_steps(3), seeded_steps(3)
    leaves = [(p1[k][n], p2[k][n]) for k in p1 for n in p1[k]]
    leaves += [(t1[k][n], t2[k][n]) for t1, t2 in ((s1.mu, s2.mu), (s1.nu, s2.nu))
               for k in t1 for n in t1[k]]
    check(all(a.device.type == "cuda" for a, _ in leaves) and s1.step.device.type == "cuda",
          "params or optimizer state left the card")
    check(int(s1.step) == DETERMINISM_STEPS == int(s2.step), "optimizer step count")
    check(all(torch.equal(a, b) for a, b in leaves),
          f"two seeded runs of {DETERMINISM_STEPS} steps gave different weights")
    # one step's device work (CUPTI) and device ops beside its stream time
    box = [p2, s2]
    step_gen = torch.Generator(device=dev).manual_seed(5)

    def one_step():
        box[0], box[1], _ = loop.train_step(box[0], box[1], x_train[:64], y_train[:64],
                                            step_gen, cfg)

    for _ in range(3):
        one_step()
    torch.cuda.synchronize()
    ops = device_ops(torch, one_step, iters=10)
    check(bool(ops), "the CUPTI trace of ten training steps holds no device activity")
    step_device_ms = sum(e.time_range.elapsed_us() for e in ops) / 10 / 1e3

    # 3. the cached detector (what --trained serves): restore, calibrate, score
    torch.cuda.synchronize()
    det = tdet.get_detector("mfcc20", device=dev)
    params = det["params"]
    check(all(torch.equal(params[k]["w"], res.params[k]["w"]) for k in params),
          "get_detector did not restore the trained checkpoint")
    calib_x = torch.as_tensor(feats[:256], device=dev)
    a = events()
    cnn1d.calibrate_alphas(res.params, calib_x, cfg)
    b = events()
    torch.cuda.synchronize()
    calibrate_ms = a.elapsed_time(b)
    alphas = {k: float(v["alpha"]) for k, v in params.items() if "alpha" in v}

    acc = {}
    logits_card = {}
    for prec in Precision:
        logits_card[prec.value] = loop.predict(params, test_x, cfg, PrecisionPolicy.uniform(prec))
        acc[prec.value] = loop.evaluate_logits(logits_card[prec.value], test_y).accuracy
    check(acc["fp32"] == det["metrics"].accuracy, "get_detector's metrics differ from predict")
    policy = tdet.sensitivity_policy(det)
    acc["sensitivity"] = loop.evaluate_logits(loop.predict(params, test_x, cfg, policy),
                                              test_y).accuracy
    pruned, pcfg, spec = cnn1d.prune_model(params, cfg, keep=64)
    check(spec.flatten_after == 8704, f"pruned flatten {spec.flatten_after}")
    for prec in (Precision.FP32, Precision.INT8):
        with torch.no_grad(), cnn1d.fp32_numerics():
            lg = cnn1d.forward_pruned(pruned, torch.as_tensor(test_x, device=dev), pcfg, spec,
                                      policy=PrecisionPolicy.uniform(prec)).cpu().numpy()
        acc[f"pruned_{prec.value}"] = loop.evaluate_logits(lg, test_y).accuracy
    lo, hi = FP32_BAND
    print(f"training accuracy fp32={acc['fp32']:.4f} band=[{lo:.4f}, {hi:.4f}] "
          f"(JAX reference seeds 0-2 on the CPU)")
    check(lo <= acc["fp32"] <= hi,
          f"FP32 test accuracy {acc['fp32']:.4f} outside the reference band [{lo:.4f}, {hi:.4f}]")

    # 4. the card's emulation against the CPU's, same params (the TF32 guard)
    cpu_params = cnn1d.params_to(params, "cpu")
    emu = {}
    for mode in ("fp32", "int8"):
        cpu = loop.predict(cpu_params, test_x, cfg, PrecisionPolicy.uniform(Precision(mode)))
        card = logits_card[mode]
        emu[mode] = {"max_abs": float(np.abs(card - cpu).max()),
                     "scale": float(np.abs(cpu).max()),
                     "decision_agreement": float(np.mean(card.argmax(1) == cpu.argmax(1)))}
    rel = emu["fp32"]["max_abs"] / max(emu["fp32"]["scale"], 1.0)
    check(rel <= EMULATION_RTOL,
          f"card vs CPU FP32 emulation logits differ by {rel:.3g} of the largest logit "
          f"(> {EMULATION_RTOL}): TF32?")

    # 5. bake and serve the test split through K1-K3 (counts from here)
    kernels = (quant_matmul, conv1d_fused_q, cordic_softmax, project_rows)
    cells = {
        "int8": lambda d, p: cnn1d.export_quantized(p, cfg, mode="int8", device=d),
        "fxp8": lambda d, p: cnn1d.export_quantized(p, cfg, mode="fxp8", device=d),
        "pruned_sensitivity": lambda d, p: quantize_params(p, cfg, mode="int8", prune=spec,
                                                           policy=policy, device=d),
    }
    artifacts = {name: bake(dev, params) for name, bake in cells.items()}
    test_dev = torch.as_tensor(test_x, device=dev)
    torch.cuda.synchronize()
    for k in kernels:
        k.launches = 0
    probs = {name: accelerator_forward(qp, test_dev, cfg, device=dev).cpu().numpy()
             for name, qp in artifacts.items()}
    dev_report = deviation_report(params, test_dev, cfg, device=dev)
    torch.cuda.synchronize()
    counts = {k.__name__: k.launches for k in kernels}
    want = {k.__name__: 0 for k in kernels}
    for qp in (*artifacts.values(), artifacts["int8"]):  # deviation_report bakes int8 once more
        for name, n in launches_per_forward(qp, raw=False).items():
            if name in want:
                want[name] += n
    print(f"training_launches counts={counts} expected={want}")
    check(counts == want, f"training: kernel launches {counts} != {want}")
    deployed = {}
    for name, p in probs.items():
        check(np.isfinite(p).all() and p.shape == (N_TEST, 2), f"{name}: bad probabilities")
        deployed[name] = loop.evaluate_logits(p, test_y).accuracy
    cpu_int8 = accelerator_forward(cells["int8"]("cpu", cpu_params), test_x, cfg, device="cpu")
    check(np.array_equal(probs["int8"], cpu_int8.numpy()),
          "int8 artifact: card probabilities differ from the CPU run")
    launches = dict(counts)

    # 6. the driver: its quick-train default path and --trained (the cache of step 1)
    def drive(extra):
        for k in kernels:
            k.launches = 0
        log = io.StringIO()
        with contextlib.redirect_stdout(log):
            run = monitor.main([*extra, "--streams", "2", "--seconds", "4"])
        torch.cuda.synchronize()
        for k in kernels:
            launches[k.__name__] += k.launches
        lines = log.getvalue().splitlines()
        scored = [ln for ln in lines if ln.startswith("  stream ")]
        summary = [ln.strip() for ln in lines if "windows/s" in ln or "quick-trained" in ln]
        print(f"driver[{' '.join(extra) or 'default'}] {len(scored)} scored windows; "
              + "; ".join(summary))
        check(len(scored) == len(run.scores) == 2 * 5 and run.engine.windows_scored == 10,
              f"driver {extra}: {len(scored)} scored windows printed, want 10")
        check(all(np.isfinite(w.p_uav) for w in run.scores), f"driver {extra}: non-finite scores")
        return run

    quick = drive([])
    check(quick.engine.artifact.device.type == "cuda", "quick-trained artifact is not on the card")
    trained = drive(["--trained"])
    check(int(trained.engine.artifact.denses[0]["w"].q.shape[0]) == 35_072,
          "--trained did not serve the canonical detector")

    ref = {k: [c / N_TEST for c in v] for k, v in REFERENCE_CORRECT.items()}
    print("training " + json.dumps({
        "config": "CNNConfig() mfcc20, flatten 35072", "dataset": tdet.DATASET,
        "split": list(tdet.SPLIT), "corpus_s": corpus_s, "train_s": train_s,
        "epochs_run": epochs_run, "steps": steps, "s_per_epoch": train_s / epochs_run,
        "ms_per_step": step_ms, "step_device_ms": step_device_ms,
        "step_device_ops": len(ops) / 10, "loss_per_epoch": losses,
        "val_acc_per_epoch": [h["val_acc"] for h in res.history],
        "best_val_acc": res.best_val_acc, "calibrate_ms": calibrate_ms, "alphas": alphas,
        "test_accuracy": acc, "fp32_band": list(FP32_BAND),
        "drop_pp": {m: (acc["fp32"] - acc[m]) * 100 for m in ("bf16", "int8", "fxp8")},
        "reference_accuracy": ref,
        "reference_drop_pp": {m: [(f - q) * 100 for f, q in zip(ref["fp32"], ref[m])]
                              for m in ("bf16", "int8", "fxp8")},
        "sensitivity_rules": policy.to_dict(), "emulation_card_vs_cpu": emu,
        "deployed_accuracy": deployed, "deviation_report": dev_report,
        "determinism_steps": DETERMINISM_STEPS, "phase_s": time.perf_counter() - t_phase,
        "gpu": gpu_line,
    }))
    return launches


# ---------------------------------------------------------------------------
# phase 9: the LM serving stack
# ---------------------------------------------------------------------------

#: the served architecture, its published parameter count, and the JAX
#: serve driver's traffic: 6 requests of 4-24 tokens (numpy seed 0), 12 new
#: tokens each, 4 slots, caches for 256 positions
LM_ARCH = "gemma-2b"
LM_PARAMS = 2_506_172_416
LM_REQUESTS, LM_MAX_NEW, LM_SLOTS, LM_MAX_SEQ = 6, 12, 4, 256
#: prefill and decode against the full forward, fp32 at the published
#: widths, ``assert_allclose(rtol=tol, atol=tol)``: the reference's own
#: bounds (``tests/test_lm_archs.py::test_prefill_decode_matches_forward``).
#: cuBLAS picks another kernel, so another order of the sums, for the 52-row
#: forward, the 48-row prefill and the 2-row decode; fp32 sums of up to
#: 16,384 products stay near 1e-5 relative, TF32 (10-bit mantissas) would not
LM_CONSISTENCY_TOL = {"prefill": 2e-4, "decode": 2e-3}
#: card against the port's CPU run of the same weights, fp32 logits: two
#: BLAS libraries, as the CPU tests hold the port against JAX (2e-4), or,
#: where larger, ``LM_CARD_CPU_ULPS`` times the change that a random
#: one-ulp (a factor 1 +- 2^-23) perturbation of every weight makes to the CPU's
#: logits: a config as ill-conditioned as zamba2's smoke config (six
#: layers, its SSM output renormalised) turns fp32 rounding into 5e-4.  The
#: factor is about three times the largest ratio of error to nudge that the
#: sound port reads on an H100 (phi3.5-moe 1.69, hubert 1.44, zamba2 0.80,
#: the rest 0.23-0.74)
LM_CARD_CPU_TOL, LM_CARD_CPU_ULPS = 2e-4, 5
#: gemma-2b at full width, one layer, in bf16 as served (plain and int8
#: weights), card against CPU: the max and mean of |card - CPU| over the
#: max and mean of |CPU logits|, the bf16 limits of the CPU tests
#: (``tests/test_torch_lm_archs.py``: 0.08 and 0.007 on logits of max 1.99
#: and mean 0.397, set between the sound port and planted misplaced casts)
#: taken relative to the logit scale
LM_BF16_REL = {"max": 0.04, "mean": 0.0175}
LM_CONSISTENCY_B, LM_CONSISTENCY_S, LM_CONSISTENCY_MAX = 2, 24, 40
#: decode steps in the CUPTI trace of the ``lm_serve`` line (a device time
#: a step is the trace's sum over them)
LM_TRACE_STEPS = 3


def lm_requests(np, request_cls, vocab: int) -> list:
    """The JAX serve driver's requests (``repro/launch/serve.py:main``)."""
    rng = np.random.default_rng(0)
    return [request_cls(rid=i, prompt=rng.integers(0, vocab, rng.integers(4, 24)).astype(np.int32),
                        max_new=LM_MAX_NEW) for i in range(LM_REQUESTS)]


def lm_batch(np, torch, cfg, dev, seq: int, seed: int = 2) -> dict:
    """Seeded inputs of ``LM_CONSISTENCY_B`` rows: tokens (or hubert's
    frames) and internvl2's patches."""
    rng = np.random.default_rng(seed)
    b = LM_CONSISTENCY_B
    if cfg.frontend == "audio_frames":
        return {"frames": torch.from_numpy(
            rng.standard_normal((b, seq, cfg.frontend_dim)).astype(np.float32)).to(dev)}
    batch = {"tokens": torch.from_numpy(
        rng.integers(0, cfg.vocab, (b, seq)).astype(np.int32)).to(dev)}
    if cfg.frontend == "vision_patches":
        batch["patches"] = torch.from_numpy(rng.standard_normal(
            (b, cfg.n_patches, cfg.frontend_dim)).astype(np.float32)).to(dev)
    return batch


def lm_serve_run(torch, np, server, request_cls, vocab: int) -> dict:
    """Serve the JAX serve driver's requests once: tokens, tokens/s (host clock
    around a synchronised run), and the prefill and decode calls' stream
    time (CUDA events around each call)."""
    spans = {"prefill": [], "decode": []}

    def timed(fn, into):
        def call(*args):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            out = fn(*args)
            b.record()
            into.append((a, b))
            return out
        return call

    prefill, decode = server._prefill, server._decode
    server._prefill, server._decode = timed(prefill, spans["prefill"]), timed(decode, spans["decode"])
    try:
        reqs = lm_requests(np, request_cls, vocab)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        done = server.serve(reqs)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    finally:
        server._prefill, server._decode = prefill, decode
    check([r.rid for r in done] == list(range(LM_REQUESTS)), "lm: requests out of order")
    for r in done:
        check(r.out is not None and len(r.out) == LM_MAX_NEW,
              f"lm: request {r.rid} returned {None if r.out is None else len(r.out)} tokens")
        check(bool(((r.out >= 0) & (r.out < vocab)).all()), f"lm: request {r.rid} token out of range")
    n_tok = sum(len(r.out) for r in done)
    ms = {k: [a.elapsed_time(b) for a, b in v] for k, v in spans.items()}
    return {"tokens": [r.out.tolist() for r in done], "n_tokens": n_tok, "seconds": seconds,
            "tokens_per_s": n_tok / seconds, "prefill_ms": ms["prefill"],
            "decode_ms_per_step": statistics.median(ms["decode"]),
            "decode_steps": len(ms["decode"])}


def lm_quantized_equals_cpu(torch, params, qparams, policy, quantize_leaf, QTensor) -> int:
    """Every leaf of the card's quantised tree against a CPU quantisation of
    the same weight: ``q``, ``scale`` and ``axis`` bitwise, one leaf at a
    time; returns the number of ``QTensor`` leaves."""
    n_q = 0

    def walk(p, q, path):
        nonlocal n_q
        if isinstance(p, dict):
            for k in p:
                walk(p[k], q[k], f"{path}/{k}" if path else k)
            return
        want = quantize_leaf(path, p.cpu(), policy)
        if isinstance(want, QTensor):
            check(isinstance(q, QTensor) and q.q.device.type == "cuda",
                  f"lm: {path} not quantised on the card")
            check(q.axis == want.axis and torch.equal(q.q.cpu(), want.q)
                  and torch.equal(q.scale.cpu().view(torch.int32), want.scale.view(torch.int32)),
                  f"lm: the card's int8 {path} differs from the CPU's")
            n_q += 1
        else:
            check(q is p, f"lm: {path} should stay unquantised")

    walk(params, qparams, "")
    return n_q


def lm_phase(torch, np, dev, gpu_line) -> dict[str, int]:
    """The port's LM serving stack on the card: gemma-2b at its published
    configuration served through ``BatchedServer`` in bf16 and with int8
    weights; prefill/decode against the forward for all ten architectures
    at their published widths, one pattern group deep; each smoke config
    (and gemma-2b, one layer) on the card against the CPU; and
    ``policy_einsum`` on K1.  Returns K1's launches of the main-path
    ``policy_einsum`` calls."""
    from repro_torch.configs import get_config, lm_arch_names
    from repro_torch.core.precision_policy import Precision, policy_einsum
    from repro_torch.core.quantization import QTensor, fxp8_quantize, int8_symmetric
    from repro_torch.kernels.quant_matmul import quant_matmul, quant_matmul_plain
    from repro_torch.launch.serve import BatchedServer, Request
    from repro_torch.models import transformer as T
    from repro_torch.models.layers import tree_leaves, tree_map
    from repro_torch.models.quantized import (
        default_lm_policy, quantize_leaf, quantize_lm_params, quantized_fraction)

    t_phase = time.perf_counter()
    check(not torch.backends.cuda.matmul.allow_tf32, "lm: TF32 matmuls are on")
    bf16_reduced = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    torch.cuda.empty_cache()
    gb = 1024 ** 3

    # 1. lm_serve: gemma-2b at its published configuration, bf16
    cfg = get_config(LM_ARCH)
    check(T.param_count(cfg) == LM_PARAMS, f"lm: {LM_ARCH} counts {T.param_count(cfg)} params")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = T.init_params(0, cfg, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    leaves = tree_leaves(params)
    n_params = sum(t.numel() for t in leaves)
    weight_bytes = sum(t.numel() * t.element_size() for t in leaves)
    check(n_params == LM_PARAMS and all(t.device.type == "cuda" for t in leaves),
          f"lm: {n_params} params, or not all on the card")
    check(params["groups"]["pos0"]["mlp"]["wi_gate"].dtype == torch.bfloat16, "lm: not bf16")
    bound_step_ms = weight_bytes / HBM_BYTES_PER_S * 1e3

    def serve_twice(p, adaptive=False):
        server = BatchedServer(cfg, p, batch_slots=LM_SLOTS, max_seq=LM_MAX_SEQ,
                               adaptive_slots=adaptive, device=dev)
        first = lm_serve_run(torch, np, server, Request, cfg.vocab)
        second = lm_serve_run(torch, np, server, Request, cfg.vocab)
        check(first["tokens"] == second["tokens"], "lm: two runs gave different tokens")
        return server, second

    with torch.inference_mode():
        server, run = serve_twice(params)
        aserver, run_adaptive = serve_twice(params, adaptive=True)
        # one decode step's device work (CUPTI) on the first block's caches
        reqs = lm_requests(np, Request, cfg.vocab)[:LM_SLOTS]
        s = max(len(r.prompt) for r in reqs)
        toks = np.zeros((LM_SLOTS, s), np.int32)
        for i, r in enumerate(reqs):
            toks[i, s - len(r.prompt):] = r.prompt
        logits, caches = T.forward_with_cache(
            server.params, {"tokens": torch.from_numpy(toks).to(dev)}, cfg, LM_MAX_SEQ)
        cur = torch.argmax(logits, dim=-1).to(torch.int32)
        def step():
            return T.decode_step(server.params, cur, caches, s, cfg, LM_MAX_SEQ)

        for _ in range(2):
            step()
        torch.cuda.synchronize()
        host_ms = []
        for _ in range(3):  # the host's time to issue one step, then drain
            t0 = time.perf_counter()
            step()
            host_ms.append((time.perf_counter() - t0) * 1e3)
            torch.cuda.synchronize()
        ops = device_ops(torch, step, iters=LM_TRACE_STEPS)
        check(bool(ops), "lm: the decode step's trace holds no device activity")
        step_dev_ms = sum(e.time_range.elapsed_us() for e in ops) / LM_TRACE_STEPS / 1e3
        kinds = collections.Counter(
            "memcpy" if "memcpy" in e.name.lower() else "memset" if "memset" in e.name.lower()
            else "kernel" for e in ops)
    peak = torch.cuda.max_memory_allocated() / gb
    line = {
        "arch": LM_ARCH, "params": n_params, "dtype": "bfloat16", "weight_bytes": weight_bytes,
        "requests": LM_REQUESTS, "max_new": LM_MAX_NEW, "slots": LM_SLOTS,
        "max_seq": LM_MAX_SEQ, "init_s": init_s,
        **{k: v for k, v in run.items() if k != "tokens"},
        "slot_histogram": server.slot_histogram,
        "adaptive": {"tokens_per_s": run_adaptive["tokens_per_s"],
                     "decode_ms_per_step": run_adaptive["decode_ms_per_step"],
                     "decode_steps": run_adaptive["decode_steps"],
                     "slot_histogram": aserver.slot_histogram},
        "decode_step_device_ms": step_dev_ms,
        "decode_step_device_ops": len(ops) / LM_TRACE_STEPS,
        "decode_step_ops_by_kind": {k: v / LM_TRACE_STEPS for k, v in kinds.items()},
        "decode_step_host_ms": statistics.median(host_ms),
        "decode_busy_share": step_dev_ms / run["decode_ms_per_step"],
        "decode_bound_ms": bound_step_ms, "decode_bound_by": "bytes",
        "bound_tokens_per_s": LM_SLOTS / (bound_step_ms / 1e3),
        "peak_gb": peak, "allow_bf16_reduced_precision_reduction": bf16_reduced,
        "first_request_tokens": run["tokens"][0], "gpu": gpu_line,
    }
    print("lm_serve " + json.dumps(line))
    del server, aserver, logits, caches

    # 2. lm_serve_int8: the same traffic on weight-only int8
    policy = default_lm_policy(cfg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    qparams = quantize_lm_params(params, policy)
    torch.cuda.synchronize()
    quant_s = time.perf_counter() - t0
    n_q = lm_quantized_equals_cpu(torch, params, qparams, policy, quantize_leaf, QTensor)
    torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode():
        qserver, qrun = serve_twice(qparams)
    qleaves = tree_leaves(qparams)
    q_bytes = sum(t.q.numel() + 4 * t.scale.numel() if isinstance(t, QTensor)
                  else t.numel() * t.element_size() for t in qleaves)
    print("lm_serve_int8 " + json.dumps({
        "arch": LM_ARCH, "qtensor_leaves": n_q, "card_equals_cpu_quantisation": True,
        "quantized_fraction": quantized_fraction(qparams), "quantise_s": quant_s,
        "weight_bytes": q_bytes, **{k: v for k, v in qrun.items() if k != "tokens"},
        "bf16_tokens_per_s": run["tokens_per_s"],
        "over_bf16": qrun["tokens_per_s"] / run["tokens_per_s"],
        "decode_bound_ms": q_bytes / HBM_BYTES_PER_S * 1e3,
        "peak_gb": torch.cuda.max_memory_allocated() / gb,
        "slot_histogram": qserver.slot_histogram, "gpu": gpu_line}))
    wi_gate = params["groups"]["pos0"]["mlp"]["wi_gate"][0].float()
    del qserver, qparams, qleaves, params, leaves
    torch.cuda.empty_cache()

    # 3. lm_consistency: every architecture at its published widths, one
    # pattern group deep, fp32: prefill and two decode steps == forward
    b, s, mx = LM_CONSISTENCY_B, LM_CONSISTENCY_S, LM_CONSISTENCY_MAX
    for arch in lm_arch_names():
        full_cfg = get_config(arch)
        acfg = full_cfg.replace(n_layers=len(full_cfg.pattern), param_dtype="float32",
                                act_dtype="float32",
                                capacity_factor=16.0 if full_cfg.n_experts else
                                full_cfg.capacity_factor)
        torch.cuda.reset_peak_memory_stats()
        with torch.inference_mode():
            p = T.init_params(0, acfg, device=dev)
            batch = lm_batch(np, torch, acfg, dev, s + 2)
            full = T.forward(p, batch, acfg)
            check(bool(torch.isfinite(full).all()), f"lm_consistency: {arch} non-finite logits")
            res = {"arch": arch, "params": T.param_count(acfg), "layers": acfg.n_layers,
                   "logit_scale": float(full.abs().max())}
            if not acfg.is_encoder:
                # internvl2's 256 patches lead the sequence: the caches hold
                # them too (a linear cache clamps writes past its end)
                off = acfg.n_patches if acfg.frontend == "vision_patches" else 0
                pre = {k: (v[:, :s] if k == "tokens" else v) for k, v in batch.items()}
                last, caches = T.forward_with_cache(p, pre, acfg, mx + off)
                errs = {"prefill": max_abs(torch, last[:, 0], full[:, s - 1 + off])}
                check(torch.allclose(last[:, 0], full[:, s - 1 + off],
                                     rtol=LM_CONSISTENCY_TOL["prefill"],
                                     atol=LM_CONSISTENCY_TOL["prefill"]),
                      f"lm_consistency: {arch} prefill differs from forward by {errs['prefill']}")
                errs["decode"] = []
                for i in range(2):
                    lg, caches = T.decode_step(p, batch["tokens"][:, s + i:s + i + 1], caches,
                                               s + i + off, acfg, mx + off)
                    want = full[:, s + i + off]
                    errs["decode"].append(max_abs(torch, lg[:, 0], want))
                    check(torch.allclose(lg[:, 0], want, rtol=LM_CONSISTENCY_TOL["decode"],
                                         atol=LM_CONSISTENCY_TOL["decode"]),
                          f"lm_consistency: {arch} decode step {i} differs from forward by "
                          f"{errs['decode'][-1]}")
                res.update(max_abs=errs, tol=LM_CONSISTENCY_TOL)
                del caches, last, lg
            res["peak_gb"] = torch.cuda.max_memory_allocated() / gb
        print("lm_consistency " + json.dumps({**res, "gpu": gpu_line}))
        del p, batch, full
        torch.cuda.empty_cache()

    # 4. lm_card_vs_cpu: smoke configs (and gemma-2b at full width, one
    # layer, fp32) on the card against the port's CPU run of the same weights
    cases = [(arch, get_config(arch).smoke()) for arch in lm_arch_names()]
    cases.append((f"{LM_ARCH}:1-layer", get_config(LM_ARCH).replace(
        n_layers=1, param_dtype="float32", act_dtype="float32")))
    card_cpu = {}
    with torch.inference_mode():
        for name, ccfg in cases:
            p_cpu = T.init_params(0, ccfg, device="cpu")
            batch = lm_batch(np, torch, ccfg, torch.device("cpu"), LM_CONSISTENCY_S)
            want = T.forward(p_cpu, batch, ccfg)
            gen = torch.Generator().manual_seed(SEED)
            nudged = tree_map(lambda t: t * (1 + 2.0 ** -23 * torch.randn(
                t.shape, generator=gen).sign()), p_cpu)
            ulp = max_abs(torch, T.forward(nudged, batch, ccfg), want)
            tol = max(LM_CARD_CPU_TOL, LM_CARD_CPU_ULPS * ulp)
            got = T.forward(T.params_to(p_cpu, dev), {k: v.to(dev) for k, v in batch.items()},
                            ccfg).cpu()
            err = max_abs(torch, got, want)
            card_cpu[name] = {"max_abs": err, "one_ulp_change": ulp, "tol": tol,
                              "logit_scale": float(want.abs().max())}
            check(err <= tol, f"lm_card_vs_cpu: {name} differs by {err} (tolerance {tol})")
            del p_cpu, nudged
    print("lm_card_vs_cpu " + json.dumps({"archs": card_cpu, "gpu": gpu_line}))

    # 4b. gemma-2b at full width, one layer, bf16 as served, plain and int8
    # weights: the card (its bf16 GEMMs reducing as served, and in fp32)
    # against the CPU
    bcfg = get_config(LM_ARCH).replace(n_layers=1)
    bf16_cases = {}
    with torch.inference_mode():
        p_cpu = T.init_params(0, bcfg, device="cpu")
        check(p_cpu["groups"]["pos0"]["mlp"]["wi_gate"].dtype == torch.bfloat16,
              "lm_card_vs_cpu_bf16: not bf16")
        batch = lm_batch(np, torch, bcfg, torch.device("cpu"), LM_CONSISTENCY_S)
        card_batch = {k: v.to(dev) for k, v in batch.items()}
        for wname, pc in (("bf16", p_cpu),
                          ("int8", quantize_lm_params(p_cpu, default_lm_policy(bcfg)))):
            want = T.forward(pc, batch, bcfg).float()
            tol = {"max": LM_BF16_REL["max"] * float(want.abs().max()),
                   "mean": LM_BF16_REL["mean"] * float(want.abs().mean())}
            p_dev = T.params_to(pc, dev)
            res = {"logit_max": float(want.abs().max()), "logit_mean": float(want.abs().mean()),
                   "tol": tol}
            for reduced in (True, False):
                torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = reduced
                try:
                    got = T.forward(p_dev, card_batch, bcfg).float().cpu()
                finally:
                    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
                        bf16_reduced
                d = (got - want).abs()
                key = "reduced_precision_reduction" if reduced else "fp32_reduction"
                res[key] = {"max_abs": float(d.max()), "mean_abs": float(d.mean())}
                check(res[key]["max_abs"] <= tol["max"] and res[key]["mean_abs"] <= tol["mean"],
                      f"lm_card_vs_cpu_bf16: {wname} ({key}) differs by {res[key]} "
                      f"(tolerance {tol})")
            bf16_cases[wname] = res
            del p_dev, want, got
        del p_cpu
    print("lm_card_vs_cpu_bf16 " + json.dumps({
        "arch": f"{LM_ARCH}:1-layer", "cases": bf16_cases, "rel_tol": LM_BF16_REL,
        "allow_bf16_reduced_precision_reduction": bf16_reduced, "gpu": gpu_line}))

    # 5. policy_einsum on K1 at gemma-2b's wi_gate shape (layer 0's weight)
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (4, cfg.d_model)).astype(np.float32)).to(dev)
    modes = (Precision.INT8, Precision.FXP8)
    quant_matmul.launches = 0
    outs = {m: policy_einsum("mk,kn->mn", x, wi_gate, m, use_kernel=True) for m in modes}
    torch.cuda.synchronize()
    launches = quant_matmul.launches
    check(launches == len(modes), f"lm: policy_einsum launched K1 {launches} times")
    x_cpu, w_cpu = x.cpu(), wi_gate.cpu()
    pe = {}
    for m in modes:
        want = policy_einsum("mk,kn->mn", x_cpu, w_cpu, m, use_kernel=True)
        check(bitwise(torch, outs[m].cpu(), want), f"lm: policy_einsum {m.value} on K1 differs "
                                                   f"from its plain twin")
        quant = int8_symmetric if m == Precision.INT8 else fxp8_quantize
        xq, wq = quant(x, axis=None), quant(wi_gate, axis=1)
        args = (xq.q, wq.q, xq.scale, wq.scale.reshape(1, -1))
        k_ms, k_ops = device_time(torch, lambda: quant_matmul(*args))
        b_ms, b_by = bound_ms(*qmm_cost(args), INT8_OPS_PER_S)
        pe[m.value] = {
            "ms": k_ms, "kernel_ops": len(k_ops),
            "plain_ms": time_ms(torch, lambda: quant_matmul_plain(*args), iters=10),
            "policy_einsum_ms": time_ms(torch, lambda: policy_einsum(
                "mk,kn->mn", x, wi_gate, m, use_kernel=True), iters=10),
            "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": max_abs(torch, outs[m].cpu(), want)}
    xb, wb = x.to(torch.bfloat16), wi_gate.to(torch.bfloat16)
    print("lm_policy_einsum " + json.dumps({
        "shape": [4, cfg.d_model, cfg.d_ff], "launches": launches, "modes": pe,
        "bf16_matmul_ms": time_ms(torch, lambda: torch.matmul(xb, wb)),
        "phase_s": time.perf_counter() - t_phase, "gpu": gpu_line}))
    return {"quant_matmul": launches}


# ---------------------------------------------------------------------------
# phase 10: the LM training stack
# ---------------------------------------------------------------------------

#: gemma-2b's train cell as the driver takes it: 8 x 128 tokens a step in two
#: microbatches, remat on (its published config), 8 steps
LM_TRAIN_ARGS = ["--arch", LM_ARCH, "--batch", "8", "--seq", "128", "--n-micro", "2",
                 "--log-every", "1", "--ckpt-every", "50", "--steps", "8"]
LM_TRAIN_TOKENS, LM_TRAIN_STEPS, LM_RESUME_AT, LM_TRAIN_TRACE_CALL = 8 * 128, 8, 6, 4
#: a run's disk writes may be capped (45 GiB on the H100 hosts this phase
#: was written for), and one gemma-2b checkpoint with its moments is 25.06
#: GB: the phase writes one (leg (b)'s emergency save, which the resume
#: reads back) and holds the driver's other saves in host memory
LM_TRAIN_WRITE_LIMIT = 45 * 1024 ** 3
#: the card-vs-CPU train steps: rows, positions, the Adam of the CPU tests
#: (no clipping, eps 1e-3: ``tests/test_torch_lm_train.py``)
LM_TRAIN_B, LM_TRAIN_S = 4, 24
LM_TRAIN_BACKEND = "nccl"
#: gemma-2b's one-layer bf16 gradients, card against CPU, each leaf's max and
#: mean |card - CPU| over the max and mean of |CPU bf16 - fp32| (the CPU's
#: own rounding error): bf16 rounds at the same points on both devices, so
#: the sound card sits far inside bf16's error (at most 0.0554 of it, max,
#: and 0.0516, mean, on an H100), about a third of these limits; a misplaced
#: cast does not (rmsnorm in bf16, planted on the CPU at a reduced width:
#: 0.80-1.88 of it).  Serving's relative limits (``LM_BF16_REL``) do not
#: hold for gradients: the sound card reads up to 2.05 % of a leaf's mean
#: (attn/wq) against 1.75 %
LM_BF16_GRAD_NOISE = {"max": 0.2, "mean": 0.16}
#: the phase's checkpoints (inside the checkout, gitignored)
LM_TRAIN_DIR = ROOT / "build" / "lm_train"


def _bits(torch, t):
    """``t`` as integers of its width (a bitwise view of any dtype)."""
    if not t.is_floating_point():
        return t
    return t.view({2: torch.int16, 4: torch.int32, 8: torch.int64}[t.element_size()])


def _flat_named(tree, prefix=""):
    """(``a/b`` name, tensor) pairs of a tree: dicts by sorted key, tuples
    in order."""
    if isinstance(tree, dict):
        items = [(k, tree[k]) for k in sorted(tree)]
    elif isinstance(tree, (list, tuple)):
        items = list(enumerate(tree))
    else:
        yield prefix, tree
        return
    for k, v in items:
        yield from _flat_named(v, f"{prefix}/{k}" if prefix else str(k))


def _tensors(tree) -> list:
    return [t for _, t in _flat_named(tree)]


class TrainProbe:
    """Wraps the driver's train step, checkpoint manager and emergency save
    (swapped into ``repro_torch.launch.train`` and
    ``repro_torch.training.checkpoint`` while the probe is entered): each
    step timed with CUDA events and the host clock (the ``trace_call``-th
    traced with CUPTI instead), the manager's saves written only when
    ``write`` (else held in memory: the machine's disk writes are capped),
    the emergency save and the restore timed, the state saved at step
    ``keep`` copied to the host, the state saved at step ``compare`` held
    bitwise against that copy, and SIGTERM sent to this process as the
    step after the ``kill_after``-th is called (the driver's hook sets its
    flag, and the loop saves that step's state when it ends)."""

    def __init__(self, torch, train_mod, ckpt_mod):
        self.torch, self.train, self.ckpt = torch, train_mod, ckpt_mod
        self.make_step, self.manager = train_mod.make_train_step, train_mod.CheckpointManager
        self.save_checkpoint = ckpt_mod.save_checkpoint
        self.kept = None
        self.reset()

    def reset(self, *, trace_call=None, keep=None, compare=None, kill_after=None, write=False):
        self.calls, self.events, self.host_ms, self.saves = 0, [], [], []
        self.trace_call, self.trace = trace_call, None
        self.keep, self.compare, self.kill_after, self.write = keep, compare, kill_after, write
        self.final_equal = self.emergency = self.restore_s = None

    def __enter__(self):
        probe, torch = self, self.torch

        def make_train_step(*a, **k):
            step = probe.make_step(*a, **k)

            def timed(params, opt_state, batch):
                probe.calls += 1
                if probe.kill_after is not None and probe.calls == probe.kill_after + 1:
                    import os
                    import signal

                    os.kill(os.getpid(), signal.SIGTERM)
                torch.cuda.synchronize()
                if probe.calls == probe.trace_call:
                    from torch.autograd import DeviceType
                    from torch.profiler import ProfilerActivity, profile

                    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                        out = step(params, opt_state, batch)
                        torch.cuda.synchronize()
                    ops = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
                    by_name = collections.defaultdict(lambda: [0, 0.0])
                    for e in ops:
                        by_name[e.name[:70]][0] += 1
                        by_name[e.name[:70]][1] += e.time_range.elapsed_us() / 1e3
                    probe.trace = {"ops": len(ops),
                                   "ms": sum(e.time_range.elapsed_us() for e in ops) / 1e3,
                                   "top": sorted(([k, n, ms] for k, (n, ms) in by_name.items()),
                                                 key=lambda r: -r[2])[:12]}
                else:
                    a0 = torch.cuda.Event(enable_timing=True)
                    a1 = torch.cuda.Event(enable_timing=True)
                    t0 = time.perf_counter()
                    a0.record()
                    out = step(params, opt_state, batch)
                    a1.record()
                    torch.cuda.synchronize()
                    probe.host_ms.append((time.perf_counter() - t0) * 1e3)
                    probe.events.append((a0, a1))
                return out

            return timed

        def emergency_save(directory, step, tree, **kw):
            t0 = time.perf_counter()
            path = probe.save_checkpoint(directory, step, tree, **kw)
            probe.emergency = {"step": step, "s": time.perf_counter() - t0, "bytes": sum(
                f.stat().st_size for f in Path(path).iterdir())}
            return path

        class Manager(self.manager):
            def save(inner, step, tree, extra=None):
                path = None
                if probe.write:
                    t0 = time.perf_counter()
                    path = super().save(step, tree, extra)
                    probe.saves.append({"step": step, "s": time.perf_counter() - t0,
                                        "bytes": sum(f.stat().st_size
                                                     for f in Path(path).iterdir())})
                if step == probe.keep:
                    probe.kept = [t.detach().cpu().clone() for t in _tensors(tree)]
                if step == probe.compare:
                    got = _tensors(tree)
                    probe.final_equal = len(got) == len(probe.kept) and all(
                        a.dtype == b.dtype and torch.equal(_bits(torch, a.detach().cpu()),
                                                           _bits(torch, b))
                        for a, b in zip(got, probe.kept))
                return path

            def maybe_restore(inner, tree_like, device="cuda"):
                t0 = time.perf_counter()
                out = super().maybe_restore(tree_like, device=device)
                torch.cuda.synchronize()
                probe.restore_s = time.perf_counter() - t0
                return out

        self.train.make_train_step, self.train.CheckpointManager = make_train_step, Manager
        self.ckpt.save_checkpoint = emergency_save
        return self

    def __exit__(self, *exc):
        self.train.make_train_step, self.train.CheckpointManager = self.make_step, self.manager
        self.ckpt.save_checkpoint = self.save_checkpoint
        return False

    def step_ms(self) -> list[float]:
        return [a.elapsed_time(b) for a, b in self.events]


def lm_train_bound(cfg, tokens: int, n_params: int) -> dict:
    """The least time one step could take on the H100: its operations (8
    FLOP a non-embedding weight and token with remat: the forward, its
    recomputation and a backward of twice its work; 6 for the tied
    unembedding, not recomputed) at the bf16 peak, against its bytes were
    each state read and written once (bf16 params in and out, fp32 moments
    in and out, the fp32 gradient read once) at 3.35 TB/s."""
    embed = cfg.vocab * cfg.d_model
    flop = 8 * (n_params - embed) * tokens + 6 * embed * tokens
    moved = n_params * (2 * 2 + 2 * 2 * 4 + 4)
    t_ops, t_bytes = flop / BF16_OPS_PER_S * 1e3, moved / HBM_BYTES_PER_S * 1e3
    return {"flop": flop, "bytes": moved, "ops_ms": t_ops, "bytes_ms": t_bytes,
            "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def lm_train_batch(np, torch, cfg, dev, b: int, s: int, seed: int = 5) -> dict:
    """Seeded inputs and labels (about a fifth of them -1, masked)."""
    rng = np.random.default_rng(seed)
    batch = {}
    if cfg.frontend == "audio_frames":
        batch["frames"] = rng.standard_normal((b, s, cfg.frontend_dim)).astype(np.float32)
    else:
        batch["tokens"] = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    if cfg.frontend == "vision_patches":
        batch["patches"] = rng.standard_normal((b, cfg.n_patches, cfg.frontend_dim)).astype(
            np.float32)
    labels = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    labels[rng.random((b, s)) < 0.2] = -1
    batch["labels"] = labels
    return {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}


def _rel(torch, got, want) -> float:
    scale = float(want.abs().max())
    return float((got.double() - want.double()).abs().max()) / scale if scale else \
        float(got.abs().max())


def lm_train_phase(torch, np, dev, gpu_line) -> dict[str, int]:
    """The port's LM training stack on the card (the ``lm_train*`` lines):
    gemma-2b at its published configuration trained through the driver,
    ``repro_torch.launch.train.main``: (a) 8 steps, timed; (b) 6 steps, a
    SIGTERM, a rerun that resumes to step 8, bitwise the uninterrupted run;
    (c) a step with ``--compress-pod-grads``, the card's int8 round trip of a
    gradient leaf bitwise the CPU's; (d) every smoke config's train step,
    and gemma-2b at one layer in bf16, card against CPU; (e) ``moe_fwd_a2a``
    and ``embedding_gather`` through NCCL at world size 1 against their
    dense counterparts.  Runs no hand-written kernel."""
    import gc
    import shutil
    import signal

    import torch.distributed as dist

    from repro_torch.configs import get_config, lm_arch_names
    from repro_torch.core.sensitivity import value_and_grad
    from repro_torch.distributed import sharding as SH
    from repro_torch.distributed.embedding import embedding_gather
    from repro_torch.launch import train
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import moe as MOE
    from repro_torch.models import transformer as T
    from repro_torch.models.layers import init_from_specs, tree_leaves, tree_map
    from repro_torch.training import checkpoint as CK
    from repro_torch.training import compression as C
    from repro_torch.training import lm as LM
    from repro_torch.training.optimizer import Adam

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    gb = 1024 ** 3
    check(torch.cuda.memory_allocated() < gb, "lm_train: an earlier phase's tensors remain "
          f"({torch.cuda.memory_allocated()} bytes)")
    cfg = get_config(LM_ARCH)
    n_params = T.param_count(cfg)
    check(n_params == LM_PARAMS and cfg.remat and cfg.param_dtype == "bfloat16",
          f"lm_train: {LM_ARCH} is not its published config")
    shutil.rmtree(LM_TRAIN_DIR, ignore_errors=True)
    LM_TRAIN_DIR.mkdir(parents=True)
    disk = shutil.disk_usage(LM_TRAIN_DIR)
    print(f"lm_train_disk {json.dumps({'total': disk.total, 'used': disk.used, 'free': disk.free})}")
    sigterm = signal.getsignal(signal.SIGTERM)
    probe = TrainProbe(torch, train, CK)
    legs_s = {}

    def run(name, **probe_kw):
        probe.reset(**probe_kw)
        with probe:
            return train.main(LM_TRAIN_ARGS + ["--device", str(dev.type),
                                               "--ckpt-dir", str(LM_TRAIN_DIR / name)])

    ckpt_bytes = n_params * (2 + 4 + 4) + (1 << 20)  # bf16 params, fp32 moments, headers
    check(disk.free > 1.1 * ckpt_bytes and ckpt_bytes < 0.8 * LM_TRAIN_WRITE_LIMIT,
          f"lm_train: a {ckpt_bytes}-byte checkpoint does not fit ({disk.free} bytes free, "
          f"{LM_TRAIN_WRITE_LIMIT} bytes of writes a run)")
    bound = lm_train_bound(cfg, LM_TRAIN_TOKENS, n_params)

    def timing(losses) -> dict:
        ev, host = probe.step_ms()[1:], probe.host_ms[1:]  # step 1 pays the set-up
        ms = statistics.median(ev)
        return {"step_ms_events": ms, "step_ms_events_all": probe.step_ms(),
                "step_ms_host": statistics.median(host),
                "tokens_per_s": LM_TRAIN_TOKENS / (statistics.median(host) / 1e3),
                "loss_first": losses[0], "loss_last": losses[-1], "losses": losses}

    # (a) 8 uninterrupted steps as the driver runs them (nondeterministic
    # algorithms allowed), timed; the driver's final save held in memory
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    losses_a = run("a", trace_call=LM_TRAIN_TRACE_CALL)
    peak = torch.cuda.max_memory_allocated() / gb
    check(len(losses_a) == LM_TRAIN_STEPS and all(np.isfinite(losses_a)),
          f"lm_train: losses {losses_a}")
    check(probe.trace is not None and probe.trace["ops"] > 0,
          "lm_train: the traced step holds no device activity")
    timed_a = timing(losses_a)
    PHASE_RESULTS["lm_train_step_ms"] = timed_a["step_ms_events"]
    legs_s["a"] = time.perf_counter() - t0
    print("lm_train " + json.dumps({
        "arch": LM_ARCH, "params": n_params, "dtype": "bfloat16", "remat": cfg.remat,
        "batch": 8, "seq": 128, "n_micro": 2, "steps": LM_TRAIN_STEPS, "deterministic": False,
        **timed_a, "step_device_ms": probe.trace["ms"], "step_device_ops": probe.trace["ops"],
        "step_device_top": probe.trace["top"],
        "busy_share": probe.trace["ms"] / timed_a["step_ms_events"], "peak_gb": peak, **bound,
        "bound_share": bound["bound_ms"] / timed_a["step_ms_events"],
        "final_save": "held in host memory (leg (b) writes the phase's one checkpoint)",
        "leg_s": legs_s["a"], "gpu": gpu_line}))

    # (b) under deterministic algorithms: 8 uninterrupted steps (timed: what
    # determinism costs the step), then SIGTERM as step 6 begins (the loop
    # finishes it, saves step 6 and exits 143), and a rerun that resumes from that
    # checkpoint to step 8, bitwise the uninterrupted run
    t0 = time.perf_counter()
    torch.use_deterministic_algorithms(True)
    try:
        losses = run("b_ref", keep=LM_TRAIN_STEPS)
        check(len(losses) == LM_TRAIN_STEPS and all(np.isfinite(losses)),
              f"lm_train_resume: deterministic losses {losses}")
        timed_b = timing(losses)
        try:
            try:
                run("b", kill_after=LM_RESUME_AT - 1, write=True)
                check(False, "lm_train_resume: the driver ran on past its SIGTERM")
            except SystemExit as exc:
                check(exc.code == 143, f"lm_train_resume: exit {exc.code}, not 143")
        finally:
            signal.signal(signal.SIGTERM, sigterm)
        saved = probe.emergency
        (emergency,) = (LM_TRAIN_DIR / "b").glob("*/step_*/MANIFEST.json")
        manifest = json.loads(emergency.read_text())
        check(saved is not None and manifest["step"] == LM_RESUME_AT
              and manifest["extra"] == {"emergency": True},
              f"lm_train_resume: emergency checkpoint {manifest['step']} {manifest['extra']}")
        t1 = time.perf_counter()
        rest = run("b", compare=LM_TRAIN_STEPS)
        resume_s, restore_s = time.perf_counter() - t1, probe.restore_s
        signal.signal(signal.SIGTERM, sigterm)
        check(rest == losses[LM_RESUME_AT:], f"lm_train_resume: steps 7-8 lost {rest} against "
                                             f"{losses[LM_RESUME_AT:]}")
        check(probe.final_equal is True, "lm_train_resume: the resumed run's final params and "
                                         "moments differ from the uninterrupted run's")
        legs_s["b"] = time.perf_counter() - t0
        print("lm_train_resume " + json.dumps({
            "deterministic": True, "resume_at": LM_RESUME_AT, "steps": LM_TRAIN_STEPS,
            "cut": None, "uninterrupted": timed_b,
            "step_ms_events_over_a": timed_b["step_ms_events"] / timed_a["step_ms_events"],
            "loss_max_abs_vs_a": max(abs(x - y) for x, y in zip(losses, losses_a)),
            "losses_7_8": rest, "equal_losses": True, "equal_final_state": True,
            "checkpoint_bytes": saved["bytes"], "checkpoint_save_s": saved["s"],
            "checkpoint_save_gb_per_s": saved["bytes"] / saved["s"] / 1e9,
            "restore_s": restore_s, "resumed_run_s": resume_s, "leg_s": legs_s["b"],
            "gpu": gpu_line}))
        shutil.rmtree(LM_TRAIN_DIR / "b")
    finally:
        torch.use_deterministic_algorithms(False)
    probe.kept = None
    gc.collect()

    # (c) one step with --compress-pod-grads: one gradient leaf's int8 round
    # trip on the card, bitwise the CPU's on the same gradient
    t0 = time.perf_counter()
    leaf = {}
    compress_orig = LM.fake_compress_grads

    def recording(grads, **kw):
        g = grads["groups"]["pos0"]["attn"]["wq"]
        leaf["in"] = g.detach().cpu().clone()
        out = compress_orig(grads, **kw)
        leaf["out"] = out["groups"]["pos0"]["attn"]["wq"].detach().cpu().clone()
        leaf["kw"] = kw
        return out

    LM.fake_compress_grads = recording
    try:
        probe.reset()
        with probe:
            closs = train.main(LM_TRAIN_ARGS[:-2] + [
                "--steps", "1", "--compress-pod-grads", "--device", str(dev.type),
                "--ckpt-dir", str(LM_TRAIN_DIR / "c")])
    finally:
        LM.fake_compress_grads = compress_orig
        # the driver's SIGTERM hook holds its last state (params and Adam
        # states, 25 GB) for as long as it stays installed
        signal.signal(signal.SIGTERM, sigterm)
    check(len(closs) == 1 and np.isfinite(closs[0]), f"lm_train_compress: loss {closs}")
    want_leaf = C.fake_compress_grads({"g": leaf["in"].clone()}, jitted=True)["g"]
    check(leaf["kw"].get("jitted") is True and bool(torch.equal(
        _bits(torch, leaf["out"]), _bits(torch, want_leaf))),
        "lm_train_compress: the card's int8 round trip differs from the CPU's")
    legs_s["c"] = time.perf_counter() - t0
    print("lm_train_compress " + json.dumps({
        "leaf": "groups/pos0/attn/wq", "shape": list(leaf["in"].shape), "loss": closs[0],
        "changed_values": int((leaf["out"] != leaf["in"]).sum()),
        "card_equals_cpu": True, "leg_s": legs_s["c"], "gpu": gpu_line}))
    del leaf
    gc.collect()
    torch.cuda.empty_cache()

    # (d) every smoke config's train step (fp32, n_micro 2) on the card
    # against the CPU: the loss and the first moment (0.1 x the accumulated
    # gradient), each leaf as max|card - CPU| over the leaf's max, the
    # largest over the leaves within the larger of LM_CARD_CPU_TOL and
    # LM_CARD_CPU_ULPS times the largest that a one-ulp weight nudge moves a
    # leaf by on the CPU (the CPU tests' measure against JAX)
    t0 = time.perf_counter()
    opt = Adam(lr=1e-3, eps=1e-3, grad_clip_norm=None)

    def one_step(c, params, batch):
        step = LM.make_train_step(c, opt, LM.TrainSettings(n_micro=2))
        _, o, m = step(params, opt.init(params), batch)
        return float(m["loss"]), [(k, t.cpu()) for k, t in _flat_named(o.mu)]

    card_cpu = {}
    for arch in lm_arch_names():
        scfg = get_config(arch).smoke()
        p_cpu = T.init_params(0, scfg, device="cpu")
        batch = lm_train_batch(np, torch, scfg, torch.device("cpu"), LM_TRAIN_B, LM_TRAIN_S)
        gen = torch.Generator().manual_seed(SEED)
        nudged = tree_map(lambda t: t * (1 + 2.0 ** -23 * torch.randn(
            t.shape, generator=gen).sign()), p_cpu)
        want_loss, want_mu = one_step(scfg, p_cpu, batch)
        n_loss, n_mu = one_step(scfg, nudged, batch)
        got_loss, got_mu = one_step(scfg, T.params_to(p_cpu, dev),
                                    {k: v.to(dev) for k, v in batch.items()})
        errs = {k: _rel(torch, g, w) for (k, g), (_, w) in zip(got_mu, want_mu)}
        nudge = max(_rel(torch, n, w) for (_, n), (_, w) in zip(n_mu, want_mu))
        worst = max(errs, key=errs.get)
        res = {"loss_rel": abs(got_loss - want_loss) / abs(want_loss),
               "loss_nudge": abs(n_loss - want_loss) / abs(want_loss),
               "grad_rel": errs[worst], "worst_leaf": worst, "grad_nudge": nudge}
        res["loss_tol"] = max(LM_CARD_CPU_TOL, LM_CARD_CPU_ULPS * res["loss_nudge"])
        res["grad_tol"] = max(LM_CARD_CPU_TOL, LM_CARD_CPU_ULPS * nudge)
        card_cpu[arch] = res
        check(res["loss_rel"] <= res["loss_tol"] and res["grad_rel"] <= res["grad_tol"],
              f"lm_train_card_vs_cpu: {arch} {res}")
    legs_s["d"] = time.perf_counter() - t0
    print("lm_train_card_vs_cpu " + json.dumps({
        "archs": card_cpu, "n_micro": 2, "rows": LM_TRAIN_B, "seq": LM_TRAIN_S,
        "tol": LM_CARD_CPU_TOL, "ulps": LM_CARD_CPU_ULPS, "leg_s": legs_s["d"],
        "gpu": gpu_line}))

    # (d') gemma-2b at full width, one layer, bf16 as trained (remat on):
    # loss_fn's gradients, card against CPU.  bf16 rounding dominates these
    # gradients (the CPU's bf16 gradient of attn/wq is 8e4 times its fp32
    # one's scale away from it), so each leaf's card-CPU distance is held to
    # a fraction of the CPU's own distance from an fp32 computation on the
    # same weights (LM_BF16_GRAD_NOISE); serving's relative limits are printed
    t0 = time.perf_counter()
    bcfg = get_config(LM_ARCH).replace(n_layers=1)
    fcfg = bcfg.replace(param_dtype="float32", act_dtype="float32")
    p_cpu = T.init_params(0, bcfg, device="cpu")
    batch = lm_train_batch(np, torch, bcfg, torch.device("cpu"), 2, LM_TRAIN_S)
    want_loss, want_g = value_and_grad(lambda p: T.loss_fn(p, batch, bcfg), p_cpu)
    _, exact_g = value_and_grad(lambda p: T.loss_fn(p, batch, fcfg),
                                T.params_from_numpy(T.params_to_numpy(p_cpu), fcfg))
    p_dev, b_dev = T.params_to(p_cpu, dev), {k: v.to(dev) for k, v in batch.items()}
    got_loss, got_g = value_and_grad(lambda p: T.loss_fn(p, b_dev, bcfg), p_dev)
    bf16 = {"loss_rel": abs(float(got_loss) - float(want_loss)) / abs(float(want_loss)),
            "leaves": {}}
    for (key, w), (_, g), (_, e) in zip(_flat_named(want_g), _flat_named(got_g),
                                        _flat_named(exact_g)):
        w, g, e = w.float(), g.float().cpu(), e.float()
        d, noise = (g - w).abs(), (w - e).abs()
        res = {"max_abs": float(d.max()), "mean_abs": float(d.mean()),
               "noise_max": float(noise.max()), "noise_mean": float(noise.mean()),
               "rel_max": float(d.max() / w.abs().max()),
               "rel_mean": float(d.mean() / w.abs().mean())}
        res["of_noise"] = [a / n if n else (0.0 if a == 0 else float("inf")) for a, n in (
            (res["max_abs"], res["noise_max"]), (res["mean_abs"], res["noise_mean"]))]
        bf16["leaves"][key] = res
        check(res["of_noise"][0] <= LM_BF16_GRAD_NOISE["max"]
              and res["of_noise"][1] <= LM_BF16_GRAD_NOISE["mean"],
              f"lm_train_card_vs_cpu_bf16: {key} {res}")
    check(bf16["loss_rel"] <= LM_BF16_REL["mean"], f"lm_train_card_vs_cpu_bf16: loss {bf16}")
    del p_cpu, p_dev, want_g, got_g, exact_g
    legs_s["d_bf16"] = time.perf_counter() - t0
    print("lm_train_card_vs_cpu_bf16 " + json.dumps({
        "arch": f"{LM_ARCH}:1-layer", **bf16, "noise_limits": LM_BF16_GRAD_NOISE,
        "serving_rel_limits": LM_BF16_REL, "leg_s": legs_s["d_bf16"], "gpu": gpu_line}))
    gc.collect()
    torch.cuda.empty_cache()

    # (e) the collectives through NCCL at world size 1: moe_fwd_a2a against
    # moe_fwd (olmoe's published width, one layer, capacity factor 8, fp32)
    # and embedding_gather against the plain gather (gemma-2b's table)
    t0 = time.perf_counter()
    dist.init_process_group(LM_TRAIN_BACKEND, init_method=f"file://{LM_TRAIN_DIR / 'pg'}",
                            rank=0, world_size=1)
    try:
        rules = SH.ShardingRules(make_host_mesh(device=dev))
        check(rules.group(("model",)) is not None, "lm_train_collectives: no process group")
        mcfg = get_config("olmoe-1b-7b").replace(n_layers=1, capacity_factor=8.0,
                                                 param_dtype="float32", act_dtype="float32")
        gen = torch.Generator(device=dev).manual_seed(SEED)
        mp = init_from_specs(gen, MOE.moe_specs(mcfg), mcfg)
        x = torch.randn((2, LM_TRAIN_S, mcfg.d_model), generator=gen, device=dev)
        out = {}
        for name, fn, r in (("dense", MOE.moe_fwd, None), ("a2a", MOE.moe_fwd_a2a, rules)):
            with SH.use_rules(r):
                y, g = _value_and_grad_out(torch, lambda p: fn(p, x, mcfg), mp)
            out[name] = (y, g)
        fwd = max_abs(torch, out["a2a"][0], out["dense"][0])
        grad = max(max_abs(torch, a, b) for a, b in zip(_tensors(out["a2a"][1]),
                                                        _tensors(out["dense"][1])))
        check(fwd < 2e-4 and grad < 1e-4, f"lm_train_collectives: a2a differs from dense by "
                                          f"{fwd} (forward), {grad} (gradient)")
        table = torch.randn((cfg.vocab, cfg.d_model), generator=gen, device=dev)
        ids = torch.randint(0, cfg.vocab, (2, LM_TRAIN_S), generator=gen, device=dev)
        with SH.use_rules(rules):  # a cut of one rank: the masked lookup's path
            gathered = embedding_gather(table, ids, SH.Cut(("model",), 1, 0,
                                                           rules.group(("model",))))
        check(bitwise(torch, gathered, table[ids.long()]),
              "lm_train_collectives: embedding_gather differs from the plain gather")
        backend = dist.get_backend()
    finally:
        dist.destroy_process_group()
    legs_s["e"] = time.perf_counter() - t0
    print("lm_train_collectives " + json.dumps({
        "backend": backend, "world_size": 1, "moe_arch": "olmoe-1b-7b:1-layer",
        "moe_fwd_max_abs": fwd, "moe_grad_max_abs": grad, "moe_tol": [2e-4, 1e-4],
        "gather_bitwise": True, "vocab": cfg.vocab, "leg_s": legs_s["e"], "gpu": gpu_line}))
    shutil.rmtree(LM_TRAIN_DIR, ignore_errors=True)
    print("lm_train_phase " + json.dumps({"phase_s": time.perf_counter() - t_phase,
                                          "legs_s": legs_s, "gpu": gpu_line}))
    return {}


# ---------------------------------------------------------------------------
# phase 11: the dry run's predictions against the card
# ---------------------------------------------------------------------------

#: phase 9's serving cell: 4 slots, 256 positions (one decode step)
DRYRUN_DECODE_SLOTS, DRYRUN_DECODE_SEQ = 4, 256
#: the predicted peak against ``torch.cuda.max_memory_allocated`` over a step
DRYRUN_PEAK_TOL = 0.10
#: the production-mesh cells, run in a child process (this one may hold a
#: real process group from phase 10's collectives leg): gemma-2b's caches
#: cut along the sequence, zamba2's mamba2 states cut over "ssm_heads"
DRYRUN_MESH_CELLS = (("gemma-2b", "decode_32k", "single"), ("zamba2-7b", "decode_32k", "single"))
#: a zamba2 decode_32k step's collective bytes a device, at most (its
#: mamba2 blocks gather the projection of a rank's 8 rows, not their weights)
DRYRUN_ZAMBA_COLLECTIVE_BYTES = 1e8
DRYRUN_DIR = ROOT / "build" / "dryrun"


def _dryrun_check(torch, dev, cfg, shape, n_micro, real_args) -> dict:
    """One cell at world size 1: the dry run's trace of its step on fake
    tensors on ``dev`` beside the same step run once on the card on
    ``real_args(fn)`` (real params, a valid batch), under
    ``FlopCounterMode``, its peak read by ``max_memory_allocated`` over the
    step less what was allocated before its arguments were made."""
    import gc

    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.distributed.sharding import HostMesh, ShardingRules, use_rules
    from repro_torch.launch import dryrun as D
    from repro_torch.launch import roofline

    rules = ShardingRules(HostMesh(("data", "model")))
    t0 = time.perf_counter()
    pred = D.trace_cell(cfg, shape, rules, n_micro, device=dev)
    trace_s = time.perf_counter() - t0
    with FakeTensorMode():
        fn, _ = D.build_cell(cfg, shape, rules, n_micro, device=dev)
    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    args = real_args(fn)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    flops = FlopCounterMode(display=False)
    t0 = time.perf_counter()
    with use_rules(rules), flops:
        out = fn(*args)
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - base
    del out, args
    gc.collect()
    torch.cuda.empty_cache()
    got = {"pred_peak_bytes": pred["memory"]["peak_bytes"], "card_peak_bytes": peak,
           "pred_argument_bytes": pred["memory"]["argument_bytes"],
           "peak_rel_err": (pred["memory"]["peak_bytes"] - peak) / peak,
           "pred_flops": pred["flops_per_device"], "card_flops": float(flops.get_total_flops()),
           "pred_bytes": pred["bytes_per_device"], "trace_s": trace_s,
           "card_step_s_with_counter": step_s,
           "roofline": roofline.terms(pred["flops_per_device"], pred["bytes_per_device"],
                                      pred["collectives"]["total_bytes"])}
    check(got["card_flops"] == got["pred_flops"],
          f"dryrun: {shape.name}: the card's FLOPs {got['card_flops']} differ from the fake "
          f"trace's {got['pred_flops']}: the fake path is not the card's")
    check(abs(got["peak_rel_err"]) <= DRYRUN_PEAK_TOL,
          f"dryrun: {shape.name}: predicted peak {got['pred_peak_bytes']} is "
          f"{got['peak_rel_err']:+.3f} of the card's {peak}")
    return got


def dryrun_card_checks(device: str = "cuda") -> None:
    """Phase 11's card checks, run in a process of their own (a fresh CUDA
    context: the earlier phases leave allocations and cached blocks behind):
    gemma-2b's train step as phase 10 runs it (8 x 128 tokens, two
    microbatches, remat) and its decode step as phase 9 serves it (4 slots,
    256 positions), each traced on fake tensors and run once for real,
    FLOPs equal and peaks within ``DRYRUN_PEAK_TOL`` or the process fails;
    prints the ``dryrun_checks`` line."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch.specs import ShapeSpec
    from repro_torch.models import transformer as T
    from repro_torch.training.optimizer import Adam

    dev = torch.device(device)
    cfg = get_config(LM_ARCH)
    check(T.param_count(cfg) == LM_PARAMS and cfg.remat, f"dryrun: {LM_ARCH} is not its "
                                                         "published config")

    def train_args(fn):
        params = T.init_params(0, cfg, device=dev)
        batch = lm_train_batch(np, torch, cfg, dev, 8, 128)
        return params, Adam(lr=1e-4).init(params), batch

    def decode_args(fn):
        params = T.init_params(0, cfg, device=dev)
        caches = _cache_zeros(torch, T, cfg, dev)
        gen = torch.Generator(device=dev).manual_seed(SEED)
        token = torch.randint(0, cfg.vocab, (DRYRUN_DECODE_SLOTS, 1), generator=gen,
                              device=dev, dtype=torch.int32)
        return params, token, caches, DRYRUN_DECODE_SEQ - 1

    train = _dryrun_check(torch, dev, cfg, ShapeSpec("lm_train_gemma2b", 128, 8, "train"), 2,
                          train_args)
    decode = _dryrun_check(torch, dev, cfg, ShapeSpec(
        "lm_gemma2b_decode", DRYRUN_DECODE_SEQ, DRYRUN_DECODE_SLOTS, "decode"), 1, decode_args)
    print("dryrun_checks " + json.dumps({
        "train": train, "decode": decode,
        "card_total_memory": torch.cuda.get_device_properties(dev).total_memory}))


def _child(code: str, what: str, marker: str | None = None):
    """Run ``code`` in a fresh interpreter beside this checkout; a failure
    fails the phase.  Returns the JSON after ``marker`` on its stdout."""
    import os

    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=900, cwd=ROOT, env={**os.environ, "PYTHONPATH": str(SRC)})
    check(proc.returncode == 0, f"dryrun: {what} failed: {proc.stdout[-1500:]} "
                                f"{proc.stderr[-2500:]}")
    if marker is None:
        return None
    (line,) = [ln for ln in proc.stdout.splitlines() if ln.startswith(marker + " ")]
    return json.loads(line[len(marker) + 1:])


def _decode_arguments_from_specs(arch: str, shape_name: str, mesh=None, overrides=None) -> int:
    """One rank's argument bytes of a decode cell on ``mesh`` (``{axis:
    size}``; ``pod_16x16``'s ("data", "model") = (16, 16) by default) under
    the rules with ``overrides``, reckoned from the specs: each param's part
    of its spec, the rank's rows of tokens, and each cache's part of its
    spec (its sequence over "model" where the kv heads do not divide the
    model axis: ``"kv_seq_model"``; a mamba2 state's heads over
    ``"ssm_heads"``), each storage in 512-byte blocks.
    ``tests/test_torch_lm_tp_serve.py`` holds every decode_32k and long_500k
    cell of the dry run's matrix, at both production meshes, to it."""
    import math

    from repro_torch.configs import get_config
    from repro_torch.distributed import sharding as SH
    from repro_torch.launch.specs import SHAPES
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T

    class Mesh:
        shape = dict(mesh or {"data": 16, "model": 16})
        axis_names = tuple(shape)

    cfg, shape = get_config(arch), SHAPES[shape_name]
    rules = SH.ShardingRules(Mesh(), overrides)

    def part(dims, logical, nbytes) -> int:
        spec = rules.spec(logical, dims, record=False)
        n = math.prod(dims) // math.prod(rules.size(SH._entry_axes(e)) for e in spec)
        return -(-n * nbytes // 512) * 512

    total = sum(part(s.shape, s.logical, L.torch_dtype(s.dtype or cfg.param_dtype).itemsize)
                for s in L.tree_leaves(T.build_specs(cfg)))
    total += part((shape.global_batch, 1), ("decode_batch", None), 4)
    with SH.use_rules(rules):
        logical = T.cache_logical_axes(cfg, SH.kv_seq_axis(cfg.n_kv_heads))

    def caches(sd, lg) -> int:  # ``cache_shapes``' (shape, dtype) leaves
        if isinstance(sd, dict):
            return sum(caches(sd[k], lg[k]) for k in sd)
        return part(sd[0], lg, sd[1].itemsize)

    return total + caches(T.cache_shapes(cfg, shape.global_batch, shape.seq_len), logical)


def dryrun_phase(torch, np, dev, gpu_line) -> None:
    """The dry run (``repro_torch.launch.dryrun``) held against the card:
    :func:`dryrun_card_checks` in a child process, its numbers printed
    beside phase 10's step time; then the production-mesh cells
    (``DRYRUN_MESH_CELLS``: gemma-2b and zamba2-7b x decode_32k x pod_16x16
    at 256 fake ranks) in another child (a process has one default process
    group, and phase 10's may be a real one), each one's arguments equal to
    the specs' reckoning and no cache axis left uncut, zamba2's collectives
    under ``DRYRUN_ZAMBA_COLLECTIVE_BYTES`` (the ``dryrun_*`` lines).  Runs
    no hand-written kernel."""
    import gc

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()  # the child needs the card: hand back this process's cache
    left = torch.cuda.memory_allocated()
    got = _child(f"import sys; sys.path[:0] = [{str(ROOT)!r}, {str(SRC)!r}]; "
                        f"import chip_smoke; chip_smoke.dryrun_card_checks({dev.type!r})",
                 "the card checks", "dryrun_checks")
    train, decode = got["train"], got["decode"]
    step_ms = PHASE_RESULTS.get("lm_train_step_ms")
    train["phase10_step_ms"] = step_ms
    train["phase10_bound_share"] = (train["roofline"]["bound_s"] * 1e3 / step_ms
                                    if step_ms else None)
    print("dryrun_train " + json.dumps({
        "arch": LM_ARCH, "batch": 8, "seq": 128, "n_micro": 2, "remat": True, **train,
        "card_total_memory": got["card_total_memory"], "gpu": gpu_line}))
    print("dryrun_decode " + json.dumps({"arch": LM_ARCH, "slots": DRYRUN_DECODE_SLOTS,
                                         "positions": DRYRUN_DECODE_SEQ, **decode,
                                         "gpu": gpu_line}))

    t0 = time.perf_counter()
    _child("from repro_torch.launch import dryrun\n" + "".join(
        f"dryrun.main(['--arch', {a!r}, '--shape', {sh!r}, '--mesh', {m!r}, "
        f"'--device', {dev.type!r}, '--out', {str(DRYRUN_DIR)!r}])\n"
        for a, sh, m in DRYRUN_MESH_CELLS), "the production-mesh cells")
    child_s = time.perf_counter() - t0
    for arch, shape, _ in DRYRUN_MESH_CELLS:
        (path,) = DRYRUN_DIR.glob(f"{arch}__{shape}__pod_16x16.json")
        rec = json.loads(path.read_text())
        check(rec["status"] == "ok" and rec["device"].startswith(dev.type),
              f"dryrun: the {arch} x {shape} cell: {rec.get('status')} {rec.get('error')}")
        rec.pop("fallbacks", None)
        from_specs = _decode_arguments_from_specs(arch, shape)
        print("dryrun_mesh " + json.dumps({**rec, "argument_bytes_from_specs": from_specs,
                                           "child_s": child_s, "gpu": gpu_line}))
        # gemma-2b's one kv head puts the caches' sequence on "model", and
        # zamba2's 112 ssm heads are cut 16 ways: each rank holds a 16th
        check(rec["memory"]["argument_bytes"] == from_specs and not rec["uncut_cache_axes"],
              f"dryrun: the {arch} x {shape} cell's arguments "
              f"{rec['memory']['argument_bytes']} are not the specs' {from_specs} "
              f"(uncut: {rec['uncut_cache_axes']})")
        if arch == "zamba2-7b":
            check(rec["collectives"]["total_bytes"] < DRYRUN_ZAMBA_COLLECTIVE_BYTES,
                  f"dryrun: the {arch} x {shape} cell moves {rec['collectives']['total_bytes']} "
                  f"collective bytes a device (at most {DRYRUN_ZAMBA_COLLECTIVE_BYTES:.0e})")
    print("dryrun_phase " + json.dumps({
        "phase_s": time.perf_counter() - t_phase, "parent_allocated_bytes": left,
        "parent_reserved_bytes": torch.cuda.memory_reserved(), "gpu": gpu_line}))


# ---------------------------------------------------------------------------
# phase 13: the examples on the port
# ---------------------------------------------------------------------------

#: each example on the port and its arguments (``tests/test_torch_examples.py``'s;
#: ``{tmp}`` is ``EXAMPLES_DIR``)
EXAMPLE_ARGS = {
    "torch_quickstart.py": ["--n", "100", "--epochs", "1"],
    "torch_serve_acoustic.py": ["--windows", "200", "--epochs", "1", "--cache", "{tmp}/detector"],
    "torch_train_lm.py": ["--ckpt-dir", "{tmp}/ckpt"],
    "torch_precision_sweep_lm.py": [],
}
EXAMPLES_DIR = ROOT / "build" / "examples"


def examples_phase(gpu_line) -> None:
    """The four examples on the port (``examples/torch_*.py``) on the card,
    at the CPU test's arguments, each in a child process of its own, all at
    once: any exit but 0 fails the phase (the ``examples`` line: each one's
    seconds and last line)."""
    import os
    import shutil

    t_phase = time.perf_counter()
    shutil.rmtree(EXAMPLES_DIR, ignore_errors=True)
    EXAMPLES_DIR.mkdir(parents=True)
    env = {**os.environ, "PYTHONPATH": str(SRC)}
    procs = {name: (time.perf_counter(), subprocess.Popen(
        [sys.executable, str(ROOT / "examples" / name),
         *[a.format(tmp=EXAMPLES_DIR) for a in args]], cwd=ROOT, env=env, text=True,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE)) for name, args in EXAMPLE_ARGS.items()}
    got, failed = {}, []
    try:
        for name, (t0, proc) in procs.items():
            out, err = proc.communicate(timeout=600)
            got[name] = {"exit": proc.returncode, "s": time.perf_counter() - t0,
                         "last": (out.strip().splitlines() or [""])[-1]}
            if proc.returncode:
                failed.append(f"{name} exited {proc.returncode}: {out[-800:]} {err[-1500:]}")
    finally:
        for _, proc in procs.values():
            if proc.poll() is None:
                proc.kill()
    print("examples " + json.dumps({"runs": got, "phase_s": time.perf_counter() - t_phase,
                                    "gpu": gpu_line}))
    check(not failed, "examples: " + "; ".join(failed))
    shutil.rmtree(EXAMPLES_DIR, ignore_errors=True)


# ---------------------------------------------------------------------------
# phase 12: tensor parallelism over "model"
# ---------------------------------------------------------------------------

#: the worlds: ranks sharing one card (processes on gloo, which takes CUDA
#: tensors; NCCL refuses two ranks on one device), ("data", "model") =
#: (1, n)
TP_WORLDS = (2, 4)
#: the fp32 run's depth, the run that holds the backward leaf by leaf:
#: several groups, so remat recomputes across them (a fault of the rules on
#: autograd's thread showed from 2 layers); the time its comparisons and
#: its checkpoint take bounds it (both move the whole state between the
#: ranks, 1.26 GB of fp32 params and moments a layer)
TP_FP32_LAYERS = 4
#: tests/test_torch_lm_train.py's limits, leaf by leaf: ``TP_ULPS`` times
#: what a one-ulp nudge of every weight (one ulp of its own dtype: fp32 or
#: bf16) moves a metric by in the 1-rank step, or the floor
TP_ULPS = 8
TP_FLOOR = {"loss": 1e-6, "params": 1e-6, "mu": 1e-5}
#: what a rank holds on the card besides its tensors (its CUDA context,
#: loaded kernels, the allocator's slack), in fitting the ranks' predicted
#: peaks on the card: ~2.9 GB measured on the H100 (the card's free bytes
#: at world 2's bf16 step, against its two ranks' arguments), rounded up;
#: four ranks at 1 GiB each ran out of memory at full depth
TP_CONTEXT_BYTES = 4 << 30
TP_DIR = ROOT / "build" / "tp"
TP_STEP_ARGS = dict(b=8, s=128, n_micro=2)  # launch.train's traffic (phase 10's)
#: the serving leg: rows x prompt tokens prefilled into caches of
#: ``TP_SERVE_SEQ`` positions, then ``TP_SERVE_STEPS`` greedy decode steps;
#: gemma-2b's one kv head does not divide a model axis of 2 or 4, so its
#: caches' sequence is cut over "model" (``"kv_seq_model"``)
TP_SERVE_ROWS, TP_SERVE_PROMPT, TP_SERVE_SEQ, TP_SERVE_STEPS = 4, 4096, 32_768, 16
#: the zamba2 leg: zamba2-7b at its published width (d_model 3,584, d_in
#: 7,168, 112 ssm heads of state 64), one pattern period deep (mamba2,
#: mamba2, mamba2_shared), fp32; its mamba2 blocks run head-parallel
TP_ZAMBA_LAYERS, TP_ZAMBA_PARAMS = 3, 617_459_696
#: its serving: ``TP_SERVE_ROWS`` x ``TP_ZAMBA_PROMPT`` tokens prefilled (4,096
#: tokens a rank, over d_model's 3,584: mamba2's weight route; the decode's 4
#: tokens and the train step's 512 a microbatch take the activation route),
#: then ``TP_ZAMBA_STEPS`` greedy decode steps
TP_ZAMBA_PROMPT, TP_ZAMBA_STEPS = 1024, 16


def _tp_cfg(layers, dtype: str):
    """gemma-2b's published config at ``layers`` (``None``: its own depth)."""
    from repro_torch.configs import get_config

    cfg = get_config(LM_ARCH)
    cfg = cfg.replace(n_layers=layers or cfg.n_layers)
    if dtype == "float32":
        cfg = cfg.replace(param_dtype="float32", act_dtype="float32")
    return cfg


def _tp_opt(dtype: str):
    """The fp32 run takes the CPU test's Adam (no clip, eps 1e-3), the bf16
    run ``launch.train``'s (its warmup-cosine schedule over phase 10's 8
    steps, the clip at 1.0)."""
    from repro_torch.training.optimizer import Adam, cosine_warmup_schedule

    if dtype == "float32":
        return Adam(lr=1e-3, eps=1e-3, grad_clip_norm=None)
    return Adam(lr=cosine_warmup_schedule(3e-4, warmup=10, total=LM_TRAIN_STEPS))


def _digest(torch, t) -> int:
    """An integer digest of a tensor's bits (its words weighted by position
    and summed with int64 wraparound): equal tensors, equal digests."""
    w = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}[t.element_size()]
    bits = t.contiguous().reshape(-1).view(w).to(torch.int64)
    weight = torch.arange(bits.numel(), device=bits.device, dtype=torch.int64) % 65521 + 1
    return int((bits * weight).sum())


def _nudged(torch, tree, seed: int):
    """Every nonzero weight moved by one ulp of its dtype, up or down at
    random (a zero's bits less one are a NaN's; the card's normals hold a
    few exact zeros); an int8 ``QTensor``'s scale so, its payload kept."""
    from repro_torch.core.quantization import QTensor

    gen = torch.Generator(device=next(iter(_tensors(tree))).device).manual_seed(seed)

    def leaf(t):
        if isinstance(t, QTensor):
            return QTensor(t.q, leaf(t.scale), t.axis, t.start)
        w = {2: torch.int16, 4: torch.int32}[t.element_size()]
        step = torch.randint(0, 2, t.shape, generator=gen, device=t.device, dtype=w) * 2 - 1
        return torch.where(t == 0, t, (t.view(w) + step).view(t.dtype))

    return {k: _nudged_walk(v, leaf) for k, v in tree.items()}


def _nudged_walk(tree, leaf):
    if isinstance(tree, dict):
        return {k: _nudged_walk(tree[k], leaf) for k in sorted(tree)}
    return leaf(tree)


def _tp_leaf_err(torch, kind: str, got, want) -> float:
    """``tests/test_torch_lm_train.py``'s metric of one leaf (``want`` may be
    on the host): a param's largest absolute difference, a moment's
    max|diff| / max|want|; in fp32, one leaf at a time."""
    want = want.to(got.device)
    diff = float((got.float() - want.float()).abs().max())
    if kind == "params":
        return diff
    scale = float(want.float().abs().max())
    return diff / scale if scale else float(got.float().abs().max())


def _tp_errors(torch, loss: float, leaves, want: dict) -> dict:
    """The step metrics of a run against ``want`` (``{"loss", "params",
    "mu"}``, leaf name -> tensor), leaf by leaf: the loss relative, and
    ``_tp_leaf_err`` of each ``("params" | "mu", name, tensor)`` of
    ``leaves`` (an iterable, so one whole leaf is held at a time)."""
    out = {"loss": abs(loss - want["loss"]) / abs(want["loss"]), "params": {}, "mu": {}}
    for kind, name, t in leaves:
        out[kind][name] = _tp_leaf_err(torch, kind, t, want[kind][name])
    return out


def _tp_within(err: dict, nudge: dict) -> dict:
    """Each metric, leaf by leaf, against ``TP_ULPS`` times the nudge's
    change of that leaf or the floor: the worst share of its limit and the
    leaf that has it."""
    out = {"loss": {"err": err["loss"], "nudge": nudge["loss"],
                    "share": err["loss"] / max(TP_FLOOR["loss"], TP_ULPS * nudge["loss"])}}
    for key in ("params", "mu"):
        shares = {k: e / max(TP_FLOOR[key], TP_ULPS * nudge[key][k])
                  for k, e in err[key].items()}
        worst = max(shares, key=shares.get)
        out[key] = {"share": shares[worst], "leaf": worst, "err": err[key][worst],
                    "nudge": nudge[key][worst], "err_max": max(err[key].values()),
                    "nudge_max": max(nudge[key].values()),
                    # the six worst leaves: [share, err, nudge]
                    "worst": {k: [shares[k], err[key][k], nudge[key][k]] for k in sorted(
                        shares, key=shares.get)[-6:]}}
    return out


def _tp_reference(torch, np, cfg, dtype, dev, nudge=None) -> tuple[dict, dict]:
    """The 1-rank step (no rules) on the seeded params and batch: its loss,
    params and first moments on the host, and what one ulp of weight noise
    moves them by (``_tp_errors`` of the nudged run; ``nudge``, when given,
    is an earlier world's, of the same step)."""
    import gc

    from repro_torch.models import transformer as T
    from repro_torch.training import lm as LM

    batch = lm_train_batch(np, torch, cfg, dev, TP_STEP_ARGS["b"], TP_STEP_ARGS["s"])
    opt = _tp_opt(dtype)
    step = LM.make_train_step(cfg, opt, LM.TrainSettings(n_micro=TP_STEP_ARGS["n_micro"]))
    runs = {"nudged": nudge}
    for name in ("base",) if nudge is not None else ("base", "nudged"):
        params = T.init_params(0, cfg, device=dev)
        if name == "nudged":
            params = _nudged(torch, params, SEED)
            nonfinite = sum(int((~torch.isfinite(t)).sum()) for t in _tensors(params))
        p2, o2, m = step(params, opt.init(params), batch)
        del params
        leaves = [("params", n, t) for n, t in _flat_named(p2)] + [
            ("mu", n, t) for n, t in _flat_named(o2.mu)]
        if name == "base":
            runs[name] = {"loss": float(m["loss"]), "params": {}, "mu": {}}
            for kind, n, t in leaves:
                runs[name][kind][n] = t.cpu()
        else:
            runs[name] = _tp_errors(torch, float(m["loss"]), leaves, runs["base"])
            runs[name]["nonfinite_weights"] = nonfinite
        del p2, o2, m, leaves
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return runs["base"], runs["nudged"]


class _CollectiveClock:
    """Host seconds inside the ``torch.distributed`` collectives a step
    issues (the device synchronised before and after each), while
    entered."""

    NAMES = ("all_reduce", "all_gather", "all_to_all_single", "reduce_scatter")

    def __init__(self, torch, dist):
        self.torch, self.dist, self.s, self.n = torch, dist, 0.0, 0
        self.orig = {n: getattr(dist, n) for n in self.NAMES}

    def _sync(self):
        if self.torch.cuda.is_available():
            self.torch.cuda.synchronize()

    def __enter__(self):
        for name, fn in self.orig.items():
            def timed(*a, _fn=fn, **k):
                self._sync()
                t0 = time.perf_counter()
                out = _fn(*a, **k)
                self._sync()
                self.s += time.perf_counter() - t0
                self.n += 1
                return out

            setattr(self.dist, name, timed)
        return self

    def __exit__(self, *exc):
        for name, fn in self.orig.items():
            setattr(self.dist, name, fn)
        return False


def _tp_pairs(tree, specs, prefix: str = "") -> list:
    """``(name, tensor, spec)`` of a dict tree and its specs (``None`` for a
    whole subtree), keys sorted as ``_flat_named`` names them."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in _tp_pairs(tree[k], None if specs is None else specs[k],
                                   f"{prefix}/{k}" if prefix else str(k))]
    return [(prefix, tree, specs)]


def _tp_state(params, opt_state) -> dict:
    """(params, Adam state) as one named tree (an Adam state of ``None``:
    the params' specs for the moments, ``None`` for the step)."""
    if opt_state is None:
        return {"p": params, "o": {"step": None, "mu": params, "nu": params}}
    return {"p": params, "o": {"step": opt_state.step, "mu": opt_state.mu, "nu": opt_state.nu}}


def _tp_whole(torch, SH, rules, mine, others, spec):
    """A leaf made whole on rank 0 from its own part and the other ranks'
    (shared with it through CUDA IPC, no copy over gloo); for a whole leaf,
    whether every rank holds the same bits."""
    cuts = SH.spec_cuts(spec, rules)
    if not cuts:
        return mine, all(torch.equal(_bits(torch, o), _bits(torch, mine)) for o in others)
    (dim, _), = cuts.items()
    return torch.cat([mine, *others], dim=dim), True


def _tp_warm(torch, SH, rules, dev) -> float:
    """Seconds of a first sharded forward and backward of a toy: gloo's
    first CUDA collectives in a process (and on autograd's device thread)
    take seconds that later ones do not."""
    t0 = time.perf_counter()
    group = rules.group(("model",))
    for _ in range(2):
        x = torch.ones(1 << 20, device=dev, requires_grad=True)
        SH.reduce_from(SH.copy_to(x, group) * 2, group).sum().backward()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    return time.perf_counter() - t0


def _tp_kernel_warm(torch, np, dev) -> float:
    """Seconds of one 1-rank step of a one-layer gemma-2b with a 32,000-row
    vocab (a few GB), in fp32 and in bf16: the kernels a step launches load
    on their first use, so a rank that has run no step would make the others
    wait for it inside the first sharded step's collectives.  Rank 0 needs
    none: its 1-rank reference steps come first."""
    import gc

    from repro_torch.models import transformer as T
    from repro_torch.training import lm as LM

    t0 = time.perf_counter()
    for dtype in ("float32", "bfloat16"):
        cfg = _tp_cfg(1, dtype).replace(vocab=32_000)
        params = T.init_params(0, cfg, device=dev)
        batch = lm_train_batch(np, torch, cfg, dev, TP_STEP_ARGS["b"], TP_STEP_ARGS["s"])
        opt = _tp_opt(dtype)
        out = LM.make_train_step(cfg, opt, LM.TrainSettings(n_micro=TP_STEP_ARGS["n_micro"]))(
            params, opt.init(params), batch)
        del params, batch, out
        gc.collect()
    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    return time.perf_counter() - t0


def tp_rank(rank: int, world: int, port: int, tp_dir: str, queue, device_type: str = "cuda",
            go=None):
    """One rank of phase 12 (a process of its own, on gloo): for the fp32 run
    and the bf16 run, rank 0 first takes the 1-rank step (and its one-ulp
    nudge), then every rank places the seeded params as ``tree_shardings``
    cuts them, takes the sharded step, and hands its parts to rank 0
    through CUDA IPC, which holds the whole against the 1-rank step; in the
    bf16 run each rank holds its argument bytes, FLOPs and peak against the
    dry run's prediction; world 2 saves the fp32 state (rank 0 writes), and
    world 4 first restores it onto its mesh and on one rank.  A world
    started early (``go``, an event) joins its process group and waits for
    it before it makes a CUDA context.  Rank 0 writes
    ``rank0_<world>.json``."""
    import gc

    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.distributed import sharding as SH
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import transformer as T
    from repro_torch.training import checkpoint as CK
    from repro_torch.training import lm as LM
    from repro_torch.training.optimizer import AdamState

    tp_dir = Path(tp_dir)
    dev = torch.device(device_type, 0) if device_type == "cuda" else torch.device("cpu")
    cuda = dev.type == "cuda"
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=world)
    if go is not None:  # no CUDA context on the card before the earlier world ends
        check(go.wait(timeout=900), "tp: the earlier world never ended")
    if cuda:
        torch.cuda.set_device(dev)
    rules = SH.ShardingRules(make_host_mesh(model=world, device=dev))
    out = {"world": world, "mesh": SH.mesh_shape(rules.mesh), "runs": {},
           "warm_s": _tp_warm(torch, SH, rules, dev)}
    if cuda:
        torch.cuda.empty_cache()
    if rank:  # beside rank 0's first 1-rank reference (a few GB at a time)
        out["kernel_warm_s"] = _tp_kernel_warm(torch, np, dev)

    def free():
        gc.collect()
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.ipc_collect()  # blocks rank 0 has read through IPC and let go
            torch.cuda.empty_cache()

    def placed(cfg, seed_params=True):
        specs = SH.tree_shardings(rules, T.abstract_params(cfg), T.logical_axes(cfg))
        whole = T.init_params(0, cfg, device=dev)
        params = SH.shard_tree(whole, specs, rules, device=dev)
        del whole
        return specs, params

    def gather_to_0(tag, named: dict):
        """Rank 0: every other rank's ``named`` tensors, shared through CUDA
        IPC (they stay alive on their ranks until the barrier after)."""
        if rank:
            queue.put((tag, rank, named))
            return None
        got = {}
        while len(got) < world - 1:
            t, r, named_r = queue.get(timeout=600)
            check(t == tag, f"tp: rank 0 expected {tag}, got {t}")
            got[r] = named_r
        return [got[r] for r in range(1, world)]

    def digests(state_pairs, others) -> dict:
        return {n: _digest(torch, _tp_whole(torch, SH, rules, t, [o[n] for o in others], s)[0])
                for n, t, s in state_pairs}

    ckpt_specs = None
    if world == TP_WORLDS[-1]:
        # the checkpoint world 2 wrote, restored onto this mesh and on one rank
        cfg = _tp_cfg(TP_FP32_LAYERS, "float32")
        opt = _tp_opt("float32")
        specs, params = placed(cfg)
        state_specs = (specs, AdamState(None, specs, specs))
        t0 = time.perf_counter()
        with SH.use_rules(rules):
            step_no, state = CK.restore_checkpoint(tp_dir / "ckpt" / "step_0000000001",
                                                   (params, opt.init(params)),
                                                   shardings=state_specs, device=dev)
        restore_s = time.perf_counter() - t0
        pairs = _tp_pairs(_tp_state(*state), _tp_state(specs, None))
        others = gather_to_0("restore", {n: t for n, t, _ in pairs})
        if rank == 0:
            want = json.loads((tp_dir / "digests.json").read_text())
            got = digests(pairs, others)
            whole_like = T.init_params(0, cfg, device=dev)
            t0 = time.perf_counter()
            _, one = CK.restore_checkpoint(tp_dir / "ckpt" / "step_0000000001",
                                           (whole_like, opt.init(whole_like)), device=dev)
            one_s = time.perf_counter() - t0
            one_d = {n: _digest(torch, t) for n, t in _flat_named(_tp_state(*one))}
            out["restore"] = {"step": step_no, "leaves": len(want),
                              "mesh_bitwise": got == want, "one_rank_bitwise": one_d == want,
                              "restore_s": restore_s, "one_rank_restore_s": one_s}
            del whole_like, one
            others = None
            gc.collect()
        dist.barrier()
        del state, params, others, pairs  # the restored state, all of it
        free()
        dist.barrier()

    def train_run(name: str, cfg, dtype: str, plan=None) -> dict:
        """One sharded train step of ``cfg`` against rank 0's 1-rank step
        and its one-ulp nudge (the first world's, from its file); with
        ``plan`` (the bf16 run) the bytes, FLOPs and peak against the dry
        run's; world 2's fp32 run saves what world 4 restores."""
        opt = _tp_opt(dtype)
        ref = nudge = None
        t0 = time.perf_counter()
        nudge_file = tp_dir / f"nudge_{name}_{cfg.n_layers}.json"  # the same 1-rank step
        if rank == 0:
            ref, nudge = _tp_reference(torch, np, cfg, dtype, dev, json.loads(
                nudge_file.read_text()) if nudge_file.exists() else None)
            nudge_file.write_text(json.dumps(nudge))
        ref_s = time.perf_counter() - t0
        free()
        dist.barrier()
        base = torch.cuda.memory_allocated() if cuda else 0
        t0 = time.perf_counter()
        specs, params = placed(cfg)
        opt_state = opt.init(params)
        batch = lm_train_batch(np, torch, cfg, dev, TP_STEP_ARGS["b"], TP_STEP_ARGS["s"])
        free()
        place_s = time.perf_counter() - t0
        args_bytes = D.StepMeter().track((params, opt_state, batch))
        batch_bytes = D.StepMeter().track(batch)
        step = LM.make_train_step(cfg, opt, LM.TrainSettings(n_micro=TP_STEP_ARGS["n_micro"]))
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        flops = FlopCounterMode(display=False)
        clock = _CollectiveClock(torch, dist)
        if cuda:
            res_free = torch.cuda.mem_get_info()[0]
        dist.barrier()  # the ranks start the step together: no wait for a late one
        t0 = time.perf_counter()
        with SH.use_rules(rules), flops, clock:
            p2, o2, m = step(params, opt_state, batch)
        if cuda:
            torch.cuda.synchronize()
        step_s = time.perf_counter() - t0
        peak = (torch.cuda.max_memory_allocated() - base) if cuda else None
        res = {"layers": cfg.n_layers, "dtype": dtype, "ref_s": ref_s, "place_s": place_s,
               "step_ms": step_s * 1e3,
               "card_free_bytes_at_step": res_free if cuda else None,
               "collective_s": clock.s, "collectives": clock.n,
               "collective_share": clock.s / step_s, "argument_bytes": args_bytes,
               "param_adam_bytes": args_bytes - batch_bytes,
               "flops": float(flops.get_total_flops()), "peak_bytes": peak}
        if plan is not None:
            res["pred"] = {k: plan[k] for k in ("argument_bytes", "batch_bytes", "peak_bytes",
                                                 "flops")}
            res["argument_equal"] = res["param_adam_bytes"] == (plan["argument_bytes"]
                                                                 - plan["batch_bytes"])
            res["flops_equal"] = res["flops"] == plan["flops"]
            res["peak_rel_err"] = ((plan["peak_bytes"] - peak) / peak) if peak else None
        # every rank's parts to rank 0, which holds the whole against the
        # 1-rank step; a whole leaf must hold the same bits on every rank
        del params, opt_state, batch  # the step's inputs: only its outputs are compared
        free()  # a rank's cached blocks are no other process's to use
        pairs = _tp_pairs(_tp_state(p2, o2), _tp_state(specs, None))
        others = gather_to_0(name, {n: t for n, t, _ in pairs})
        losses = [torch.zeros(1, device=dev) for _ in range(world)]
        dist.all_gather(losses, m["loss"].reshape(1).to(torch.float32).contiguous())
        # one cut leaf through gloo too: the IPC path reads what gloo moves
        n0, t0_, s0 = next((n, t, s) for n, t, s in pairs if SH.spec_cuts(s, rules))
        via_gloo = SH.unshard(t0_, s0, rules)
        if rank == 0:
            t_compare = time.perf_counter()
            same = []

            def wholes():
                for n, t, s in pairs:
                    kind = "params" if n.startswith("p/") else "mu" if n.startswith(
                        "o/mu/") else None
                    whole, equal = _tp_whole(torch, SH, rules, t, [o[n] for o in others], s)
                    same.append(equal)
                    if not equal:
                        unequal.append(n)
                    if kind is not None:
                        yield kind, n.split("/", 2)[-1] if kind == "mu" else n[2:], whole
                    del whole

            unequal = []
            within = _tp_within(_tp_errors(torch, float(m["loss"]), wholes(), ref), nudge)
            via_ipc = _tp_whole(torch, SH, rules, t0_, [o[n0] for o in others], s0)[0]
            res["ipc_equals_gloo"] = bool(torch.equal(_bits(torch, via_ipc),
                                                      _bits(torch, via_gloo)))
            del via_ipc
            res.update(against_one_rank=within, unequal_whole_leaves=unequal[:8],
                       compare_s=time.perf_counter() - t_compare,
                       nudge_nonfinite_weights=nudge.get("nonfinite_weights"),
                       within=all(v["share"] <= 1 for v in within.values()),
                       whole_leaves_equal=all(same),
                       losses_equal=all(float(v) == float(losses[0]) for v in losses))
            if name == "fp32" and world == TP_WORLDS[0]:  # what world 4 restores
                (tp_dir / "digests.json").write_text(json.dumps(digests(pairs, others)))
            others = None  # let the other ranks' parts go before they free them
            gc.collect()
        dist.barrier()  # the parts stay alive until rank 0 has read them
        if name == "fp32" and world == TP_WORLDS[0]:
            t0 = time.perf_counter()
            with SH.use_rules(rules):
                CK.save_checkpoint(tp_dir / "ckpt", 1, (p2, o2),
                                   shardings=(specs, AdamState(None, specs, specs)))
            res["save_s"] = time.perf_counter() - t0
            if rank == 0:
                res["ckpt_bytes"] = sum(f.stat().st_size for f in
                                        (tp_dir / "ckpt" / "step_0000000001").iterdir())
        del p2, o2, m, pairs, ref, via_gloo, others
        free()
        dist.barrier()  # every rank's memory is back before rank 0's next reference
        return res

    runs = [("fp32", TP_FP32_LAYERS, "float32"), ("bf16", None, "bfloat16")]
    for name, layers, dtype in runs:
        plan = None
        if dtype == "bfloat16":
            path = tp_dir / "predict.json"
            t_wait = time.perf_counter()
            while not path.exists():
                check(time.perf_counter() - t_wait < 900, "tp: no dry-run prediction")
                time.sleep(0.5)
            plan = json.loads(path.read_text())
            check("error" not in plan, f"tp: the dry run's prediction failed: {plan.get('error')}")
            plan = plan[str(world)]
            layers = plan["layers"]
            if rank == 0:
                print("tp_predict " + json.dumps({"world": world, **plan}), flush=True)
        out["runs"][name] = train_run(name, _tp_cfg(layers, dtype), dtype, plan)
    out["serve"] = tp_serve_leg(torch, np, rules, rank, world, tp_dir, dev, plan["serve"], free)
    out["zamba"] = tp_zamba_leg(torch, np, rules, rank, world, tp_dir, dev, free, train_run)
    if rank == 0:
        (tp_dir / f"rank0_{world}.json").write_text(json.dumps(out))
    dist.barrier()
    dist.destroy_process_group()


def _serve_greedy(torch, T, params, cfg, prompt, force=None, measure: bool = False, *,
                  seq: int | None = None, steps: int | None = None,
                  count: bool = False) -> dict:
    """Prefill ``prompt`` into caches of ``seq`` positions (default
    ``TP_SERVE_SEQ``), then ``steps`` (``TP_SERVE_STEPS``) greedy decode steps (feeding ``force``'s tokens instead, where given):
    every step's last logits (fp32, on the device), the tokens fed, the
    caches' bytes and the recurrent states' (``conv``/``ssm``/``wkv``
    leaves), and the decode's ms a step (host clock, synchronised).
    ``measure``: also the first decode step's arguments (``StepMeter``) and
    peak (its arguments plus what ``max_memory_allocated`` rose above the
    bytes held before it).  ``count``: the first decode step runs under
    ``CollectiveMode`` (its collectives and their bytes recorded) and the
    ms a step are the other steps'."""
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.comm_analysis import CollectiveMode

    cuda = prompt.device.type == "cuda"
    seq = TP_SERVE_SEQ if seq is None else seq
    steps = TP_SERVE_STEPS if steps is None else steps

    def sync():
        if cuda:
            torch.cuda.synchronize()

    p = prompt.shape[1]
    out = {}
    with torch.inference_mode():
        logits, caches = T.forward_with_cache(params, {"tokens": prompt}, cfg, seq)
        out["cache_bytes"] = sum(t.numel() * t.element_size() for t in _tensors(caches))
        out["state_bytes"] = sum(t.numel() * t.element_size() for n, t in _flat_named(caches)
                                 if n.rsplit("/", 1)[-1] in ("conv", "ssm", "wkv"))
        steps_out, fed = [logits[:, -1].float()], []
        cur = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
        sync()
        t0 = time.perf_counter()
        for i in range(steps):
            if force is not None:
                cur = force[i].to(prompt.device)
            fed.append(cur)
            if measure and i == 0:
                out["argument_bytes"] = D.StepMeter().track((params, cur, caches))
                if cuda:
                    sync()
                    held = torch.cuda.memory_allocated()
                    torch.cuda.reset_peak_memory_stats()
            if count and i == 0:
                with CollectiveMode() as mode:
                    logits, caches = T.decode_step(params, cur, caches, p + i, cfg, seq)
                out["decode_collectives"] = mode.result()
                sync()
                t0 = time.perf_counter()
            else:
                logits, caches = T.decode_step(params, cur, caches, p + i, cfg, seq)
            if measure and i == 0 and cuda:
                sync()
                out["peak_bytes"] = (out["argument_bytes"] + torch.cuda.max_memory_allocated()
                                     - held)
            steps_out.append(logits[:, -1].float())
            cur = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
        sync()
        out["decode_ms"] = (time.perf_counter() - t0) * 1e3 / (steps - 1 if count else steps)
    out["logits"] = torch.stack(steps_out)
    out["tokens"] = torch.stack(fed).cpu()
    return out


def _serve_prompt(torch, np, cfg, dev):
    """The serving leg's seeded prompt: ``TP_SERVE_ROWS`` x
    ``TP_SERVE_PROMPT`` tokens."""
    rng = np.random.default_rng(SEED)
    return torch.from_numpy(rng.integers(0, cfg.vocab, (TP_SERVE_ROWS, TP_SERVE_PROMPT))
                            .astype(np.int32)).to(dev)


def _serve_requests(torch, np, server) -> list:
    """The JAX serve driver's traffic through ``server``: its tokens."""
    from repro_torch.launch.serve import Request

    with torch.inference_mode():
        done = server.serve(lm_requests(np, Request, server.cfg.vocab))
    return [[int(v) for v in r.out] for r in done]


def _serve_refs(torch, np, dev, path: Path) -> None:
    """Rank 0's 1-rank serving runs (no rules), written to ``path`` for
    both worlds: fp32 at ``TP_FP32_LAYERS`` (and its run on one-ulp-nudged
    weights, fed the base run's tokens), ``BatchedServer`` on the JAX serve
    driver's traffic with ``TP_SERVE_SEQ`` positions, the int8
    (``default_lm_policy``) bake of the fp32 weights (and its nudged
    scales and float leaves), and bf16 at full depth."""
    import gc

    from repro_torch.launch.serve import BatchedServer
    from repro_torch.models import transformer as T
    from repro_torch.models.quantized import default_lm_policy, quantize_lm_params

    refs = {}

    def keep(name, run, nudged=None):
        refs[name] = {"logits": run["logits"].cpu(), "tokens": run["tokens"],
                      "cache_bytes": run["cache_bytes"], "decode_ms": run["decode_ms"]}
        if nudged is not None:
            refs[name]["nudge"] = float((nudged["logits"] - run["logits"]).abs().max())

    cfg = _tp_cfg(TP_FP32_LAYERS, "float32")
    prompt = _serve_prompt(torch, np, cfg, dev)
    whole = T.init_params(0, cfg, device=dev)
    for name, params in (("fp32", whole),
                         ("int8", quantize_lm_params(whole, default_lm_policy(cfg)))):
        base = _serve_greedy(torch, T, params, cfg, prompt)
        keep(name, base, _serve_greedy(torch, T, _nudged(torch, params, SEED), cfg, prompt,
                                       force=base["tokens"]))
        del base
    server = BatchedServer(cfg, whole, batch_slots=LM_SLOTS, max_seq=TP_SERVE_SEQ, device=dev)
    refs["server"] = _serve_requests(torch, np, server)
    del whole, params, server
    gc.collect()
    cfg = _tp_cfg(None, "bfloat16")
    keep("bf16", _serve_greedy(torch, T, T.init_params(0, cfg, device=dev), cfg, prompt))
    torch.save(refs, path)


def tp_serve_leg(torch, np, rules, rank: int, world: int, tp_dir: Path, dev, plan, free) -> dict:
    """Phase 12's serving leg in a rank world, after its training runs:
    gemma-2b served with every leaf as ``tree_shardings`` cuts it and its
    decode caches' sequence cut over "model", against rank 0's 1-rank runs
    (:func:`_serve_refs`, made by the first world): (a) fp32 at
    ``TP_FP32_LAYERS``, the logits within ``TP_ULPS`` times the one-ulp
    nudge's change and the greedy tokens equal, and ``BatchedServer`` under
    the rules on the JAX serve driver's traffic, its tokens equal; (b) bf16
    at full depth, each rank's cache bytes the whole's over the world
    exactly and the first decode step's arguments and peak against the dry
    run's (``plan``), the logits' error, greedy agreement and ms a step
    printed; (c) the int8 bake, every rank's dequantised weights bitwise
    the whole's part, the logits within ``TP_ULPS`` times the int8 run's
    own nudge.  Returns each rank's results (on rank 0, all ranks')."""
    import torch.distributed as dist

    from repro_torch.core.quantization import QTensor
    from repro_torch.distributed import sharding as SH
    from repro_torch.launch.serve import BatchedServer
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T
    from repro_torch.models.layers import dequantize_as, tree_leaves
    from repro_torch.models.quantized import (
        abstract_quantized, default_lm_policy, quantize_lm_params)

    t_leg = time.perf_counter()
    path = tp_dir / "serve_ref.pt"
    if rank == 0 and not path.exists():
        t0 = time.perf_counter()
        _serve_refs(torch, np, dev, path)
        ref_s = time.perf_counter() - t0
        free()
    else:
        ref_s = 0.0
    dist.barrier()
    refs = torch.load(path) if rank == 0 else None
    res = {"rank": rank, "ref_s": ref_s}

    def against(name, run):
        """The run's logits against rank 0's reference: the error, the
        nudge's change, the share of the limit, greedy tokens equal, the
        first decode step fed another token than the reference's, and the
        error of the logits made from the same inputs (those before it)."""
        if refs is None:
            return {}
        want = refs[name]
        diff = (run["logits"] - want["logits"].to(run["logits"].device)).abs()
        err = float(diff.max())
        same = (run["tokens"] == want["tokens"]).reshape(TP_SERVE_STEPS, -1).all(dim=1)
        first = None if bool(same.all()) else int((~same).nonzero()[0])
        got = {"err": err, "tokens_equal": first is None, "first_step_differing": first,
               "err_same_inputs": err if first is None else float(diff[:first + 1].max()),
               "ref_cache_bytes": want["cache_bytes"], "ref_decode_ms": want["decode_ms"]}
        if "nudge" in want:
            got.update(nudge=want["nudge"], share=err / (TP_ULPS * want["nudge"]))
        return got

    def whole_cache(cfg) -> int:
        return (cfg.n_layers * 2 * TP_SERVE_ROWS * TP_SERVE_SEQ * cfg.n_kv_heads * cfg.head_dim
                * (2 if cfg.act_dtype == "bfloat16" else 4))

    # (a) fp32 at TP_FP32_LAYERS, and BatchedServer under the rules
    cfg = _tp_cfg(TP_FP32_LAYERS, "float32")
    prompt = _serve_prompt(torch, np, cfg, dev)
    specs = SH.tree_shardings(rules, T.abstract_params(cfg), T.logical_axes(cfg))
    whole = T.init_params(0, cfg, device=dev)
    params = SH.shard_tree(whole, specs, rules, device=dev)
    with SH.use_rules(rules):
        seq_cut = L.cache_seq_cut(cfg, TP_SERVE_SEQ)
        run = _serve_greedy(torch, T, params, cfg, prompt)
        server = BatchedServer(cfg, params, batch_slots=LM_SLOTS, max_seq=TP_SERVE_SEQ,
                               device=dev)
        t0 = time.perf_counter()
        server_tokens = _serve_requests(torch, np, server)
        server_s = time.perf_counter() - t0
    res["fp32"] = {"layers": cfg.n_layers, "seq_cut": None if seq_cut is None else
                   [list(seq_cut.axes), seq_cut.size], "cache_bytes": run["cache_bytes"],
                   "cache_exact": run["cache_bytes"] * world == whole_cache(cfg),
                   "decode_ms": run["decode_ms"], **against("fp32", run),
                   "server_s": server_s}
    if refs is not None:
        res["fp32"]["server_tokens_equal"] = server_tokens == refs["server"]
    del run, params, server

    # (c) the int8 bake: parts bitwise, then served
    qwhole = quantize_lm_params(whole, default_lm_policy(cfg))
    del whole
    qspecs = SH.tree_shardings(rules, *abstract_quantized(
        T.abstract_params(cfg), T.logical_axes(cfg), default_lm_policy(cfg)))
    qparams = SH.shard_tree(qwhole, qspecs, rules, device=dev)
    pairs = []
    SH.map_specs(lambda t, spec: pairs.append((t, spec)), qwhole, qspecs)
    bitwise, n_q, n_cut = True, 0, 0
    for (w, spec), part in zip(pairs, tree_leaves(qparams)):
        if isinstance(w, QTensor):
            n_q += 1
            n_cut += bool(SH.spec_cuts(spec.q, rules))
            want = SH.shard(dequantize_as(w, torch.float32), spec.q, rules, device=dev)
            bitwise &= bool(torch.equal(_bits(torch, dequantize_as(part, torch.float32)),
                                        _bits(torch, want)))
            del want
    del qwhole, pairs
    with SH.use_rules(rules):
        run = _serve_greedy(torch, T, qparams, cfg, prompt)
    res["int8"] = {"quantized_leaves": n_q, "cut_leaves": n_cut, "parts_bitwise": bitwise,
                   "cache_bytes": run["cache_bytes"], "decode_ms": run["decode_ms"],
                   **against("int8", run)}
    del run, qparams
    free()

    # (b) bf16 at full depth: bytes and peak against the dry run
    cfg = _tp_cfg(None, "bfloat16")
    specs = SH.tree_shardings(rules, T.abstract_params(cfg), T.logical_axes(cfg))
    whole = T.init_params(0, cfg, device=dev)
    params = SH.shard_tree(whole, specs, rules, device=dev)
    del whole
    free()
    with SH.use_rules(rules):
        run = _serve_greedy(torch, T, params, cfg, prompt, measure=True)
    res["bf16"] = {"layers": cfg.n_layers, "cache_bytes": run["cache_bytes"],
                   "whole_cache_bytes": whole_cache(cfg),
                   "cache_exact": run["cache_bytes"] * world == whole_cache(cfg),
                   "argument_bytes": run["argument_bytes"], "peak_bytes": run.get("peak_bytes"),
                   "decode_ms": run["decode_ms"], **against("bf16", run)}
    if plan is not None:
        res["bf16"]["pred"] = plan
        res["bf16"]["argument_equal"] = run["argument_bytes"] == plan["argument_bytes"]
        if run.get("peak_bytes"):
            res["bf16"]["peak_rel_err"] = (plan["peak_bytes"] - run["peak_bytes"]) / run[
                "peak_bytes"]
    del run, params
    free()
    res["leg_s"] = time.perf_counter() - t_leg
    every = [None] * world
    dist.all_gather_object(every, res)
    return every


def _zamba_cfg():
    """zamba2-7b's published config at ``TP_ZAMBA_LAYERS``, fp32."""
    from repro_torch.configs import get_config

    return get_config("zamba2-7b").replace(n_layers=TP_ZAMBA_LAYERS, param_dtype="float32",
                                           act_dtype="float32")


def _zamba_refs(torch, np, cfg, dev, path: Path) -> None:
    """Rank 0's 1-rank zamba2 serving runs (no rules), written to ``path``
    for both worlds: fp32 and its int8 bake (``default_lm_policy``), each
    with its run on one-ulp-nudged weights fed the base run's tokens."""
    from repro_torch.models import transformer as T
    from repro_torch.models.quantized import default_lm_policy, quantize_lm_params

    prompt = _serve_prompt(torch, np, cfg, dev)[:, :TP_ZAMBA_PROMPT]
    whole = T.init_params(0, cfg, device=dev)
    kw = dict(seq=TP_ZAMBA_PROMPT + TP_ZAMBA_STEPS, steps=TP_ZAMBA_STEPS)
    refs = {}
    for name, params in (("fp32", whole),
                         ("int8", quantize_lm_params(whole, default_lm_policy(cfg)))):
        base = _serve_greedy(torch, T, params, cfg, prompt, **kw)
        nudged = _serve_greedy(torch, T, _nudged(torch, params, SEED), cfg, prompt,
                               force=base["tokens"], **kw)
        refs[name] = {"logits": base["logits"].cpu(), "tokens": base["tokens"],
                      "state_bytes": base["state_bytes"], "decode_ms": base["decode_ms"],
                      "nudge": float((nudged["logits"] - base["logits"]).abs().max())}
        del base, nudged
    torch.save(refs, path)


def tp_zamba_leg(torch, np, rules, rank: int, world: int, tp_dir: Path, dev, free,
                 train_run) -> dict:
    """Phase 12's zamba2 leg in a rank world, after gemma-2b's legs:
    zamba2-7b at its published width, one pattern period deep, its mamba2
    blocks head-parallel over ``"ssm_heads"``, against rank 0's 1-rank
    runs: (a) one fp32 train step (``train_run``: every leaf and Adam
    moment within ``TP_ULPS`` times the one-ulp nudge's change, the whole
    leaves bitwise equal on every rank); (b) fp32 serving, a prefill of
    ``TP_SERVE_ROWS`` x ``TP_ZAMBA_PROMPT`` tokens and ``TP_ZAMBA_STEPS``
    greedy steps: each rank's mamba2 state the whole's bytes over the world
    exactly, the logits within ``TP_ULPS`` times the nudge's change, the
    tokens equal; (c) the same with the int8 bake: every rank's ``w_out``
    part dequantised bitwise the whole's slice (``w_in`` is a sensitive
    leaf, ``*mamba/w_in*``, kept float: its part is the whole's float
    slice), logits within the int8 run's limit, tokens equal.  Printed:
    decode ms a step, a decode step's collectives and bytes, each route.
    Returns each rank's results (on rank 0, all ranks')."""
    import torch.distributed as dist

    from repro_torch.core.quantization import QTensor
    from repro_torch.distributed import sharding as SH
    from repro_torch.models import mamba2 as M2
    from repro_torch.models import transformer as T
    from repro_torch.models.layers import dequantize_as
    from repro_torch.models.quantized import (
        abstract_quantized, default_lm_policy, quantize_lm_params)

    t_leg = time.perf_counter()
    cfg = _zamba_cfg()
    check(T.param_count(cfg) == TP_ZAMBA_PARAMS, f"tp_zamba: {T.param_count(cfg)} params, "
                                                 f"not zamba2-7b's {TP_ZAMBA_PARAMS} at "
                                                 f"{TP_ZAMBA_LAYERS} blocks")
    res = {"rank": rank, "train": train_run("zamba2_fp32", cfg, "float32")}
    with SH.use_rules(rules):
        heads = M2.head_cut(cfg)
        like = torch.empty(0, dtype=torch.float32)
        micro = TP_STEP_ARGS["b"] // TP_STEP_ARGS["n_micro"] * TP_STEP_ARGS["s"]
        res["routes"] = {"train": M2.in_route(cfg, micro, like),
                         "prefill": M2.in_route(cfg, TP_SERVE_ROWS * TP_ZAMBA_PROMPT, like),
                         "decode": M2.in_route(cfg, TP_SERVE_ROWS, like)}
    res["heads_cut"] = None if heads is None else [list(heads.axes), heads.size]

    path = tp_dir / "zamba_ref.pt"
    if rank == 0 and not path.exists():
        t0 = time.perf_counter()
        _zamba_refs(torch, np, cfg, dev, path)
        res["ref_s"] = time.perf_counter() - t0
        free()
    dist.barrier()
    refs = torch.load(path) if rank == 0 else None
    prompt = _serve_prompt(torch, np, cfg, dev)[:, :TP_ZAMBA_PROMPT]
    kw = dict(seq=TP_ZAMBA_PROMPT + TP_ZAMBA_STEPS, steps=TP_ZAMBA_STEPS, count=True)
    d_in = cfg.ssm_expand * cfg.d_model
    nh = d_in // cfg.ssm_head_dim
    whole_state = (TP_SERVE_ROWS * cfg.n_layers * ((cfg.conv_kernel - 1) * d_in
                                                   + nh * cfg.ssm_state * cfg.ssm_head_dim) * 4)

    def against(name, run) -> dict:
        got = {"state_bytes": run["state_bytes"], "whole_state_bytes": whole_state,
               "state_exact": run["state_bytes"] * world == whole_state,
               "decode_ms": run["decode_ms"],
               "decode_collectives": run["decode_collectives"]["counts"],
               "decode_collective_bytes": run["decode_collectives"]["total_bytes"]}
        if refs is not None:
            want = refs[name]
            err = float((run["logits"] - want["logits"].to(run["logits"].device)).abs().max())
            got.update(err=err, nudge=want["nudge"], share=err / (TP_ULPS * want["nudge"]),
                       tokens_equal=bool(torch.equal(run["tokens"], want["tokens"])),
                       ref_state_bytes=want["state_bytes"], ref_decode_ms=want["decode_ms"])
        return got

    specs = SH.tree_shardings(rules, T.abstract_params(cfg), T.logical_axes(cfg))
    whole = T.init_params(0, cfg, device=dev)
    params = SH.shard_tree(whole, specs, rules, device=dev)
    with SH.use_rules(rules):
        res["fp32"] = against("fp32", _serve_greedy(torch, T, params, cfg, prompt, **kw))
    del params

    policy = default_lm_policy(cfg)
    qwhole = quantize_lm_params(whole, policy)
    del whole
    qspecs = SH.tree_shardings(rules, *abstract_quantized(
        T.abstract_params(cfg), T.logical_axes(cfg), policy))
    qparams = SH.shard_tree(qwhole, qspecs, rules, device=dev)
    parts = {}
    for (n, w, spec), (_, part, _) in zip(_tp_pairs(qwhole, qspecs), _tp_pairs(qparams, qspecs)):
        if n.endswith(("mamba/w_in", "mamba/w_out")):
            pspec = spec.q if isinstance(w, QTensor) else spec
            want = SH.shard(dequantize_as(w, torch.float32), pspec, rules, device=dev)
            parts[n] = {"int8": isinstance(w, QTensor),
                        "cut": bool(SH.spec_cuts(pspec, rules)),
                        "bitwise": bool(torch.equal(
                            _bits(torch, dequantize_as(part, torch.float32)), _bits(torch, want)))}
            del want
    del qwhole
    with SH.use_rules(rules):
        res["int8"] = {"parts": parts, **against(
            "int8", _serve_greedy(torch, T, qparams, cfg, prompt, **kw))}
    del qparams
    free()
    res["leg_s"] = time.perf_counter() - t_leg
    every = [None] * world
    dist.all_gather_object(every, res)
    return every


def tp_predict(path: str, total_memory, device_type: str = "cuda") -> None:
    """The dry run's prediction for phase 12's bf16 runs (a child process:
    a fake world per mesh): each world's depth (the published 18 layers,
    or the most whose predicted peaks, one a rank, fit the card), and at
    it one rank's argument and batch bytes, peak and FLOPs; written to
    ``path`` (``{"error": ...}`` on a failure, so the ranks stop)."""
    import traceback

    out = {}
    try:
        import torch
        from torch._subclasses.fake_tensor import FakeTensorMode
        from torch.distributed.device_mesh import init_device_mesh

        from repro_torch.distributed.sharding import ShardingRules
        from repro_torch.launch import dryrun as D
        from repro_torch.launch.specs import ShapeSpec

        shape = ShapeSpec("tp", TP_STEP_ARGS["s"], TP_STEP_ARGS["b"], "train")
        if total_memory is None:
            total_memory = torch.cuda.get_device_properties(0).total_memory
        full = _tp_cfg(None, "bfloat16").n_layers
        for world in TP_WORLDS:
            t0 = time.perf_counter()
            D.fake_world(world)
            rules = ShardingRules(init_device_mesh(device_type, (1, world),
                                                   mesh_dim_names=("data", "model")))

            def trace(layers):
                return D.trace_cell(_tp_cfg(layers, "bfloat16"), shape, rules,
                                    TP_STEP_ARGS["n_micro"], device=device_type)

            def fits(rec):
                return world * (rec["memory"]["peak_bytes"] + TP_CONTEXT_BYTES) <= total_memory

            layers, rec = full, trace(full)
            if not fits(rec):  # the peak is linear in depth: solve from a second trace
                half = trace(full // 2)
                per = (rec["memory"]["peak_bytes"] - half["memory"]["peak_bytes"]) / (
                    full - full // 2)
                room = total_memory / world - TP_CONTEXT_BYTES - half["memory"]["peak_bytes"]
                layers = max(1, min(full, full // 2 + int(room // per)))
                rec = trace(layers)
            with FakeTensorMode():  # the rank's rows: data = 1
                batch = {k: torch.empty((shape.global_batch, shape.seq_len), dtype=torch.int32,
                                        device=device_type) for k in ("tokens", "labels")}
                batch_bytes = D.StepMeter().track(batch)
            # the serving leg's first bf16 decode step at full depth
            serve = D.trace_cell(_tp_cfg(None, "bfloat16"),
                                 ShapeSpec("tp_serve", TP_SERVE_SEQ, TP_SERVE_ROWS, "decode"),
                                 rules, 1, device=device_type)
            out[str(world)] = {"layers": layers, "cut": layers < full, "fits": fits(rec),
                               "argument_bytes": rec["memory"]["argument_bytes"],
                               "batch_bytes": batch_bytes, "peak_bytes": rec["memory"]["peak_bytes"],
                               "flops": rec["flops_per_device"], "trace_s": rec["trace_s"],
                               "collectives": rec["collectives"]["counts"],
                               "serve": {"argument_bytes": serve["memory"]["argument_bytes"],
                                         "peak_bytes": serve["memory"]["peak_bytes"],
                                         "flops": serve["flops_per_device"],
                                         "collectives": serve["collectives"]["counts"],
                                         "trace_s": serve["trace_s"]},
                               "child_s": time.perf_counter() - t0}
    except Exception as exc:  # noqa: BLE001 -- handed to the ranks, which fail the phase
        out = {"error": f"{type(exc).__name__}: {exc}", "traceback": traceback.format_exc()}
    tmp = Path(path).with_suffix(".tmp")
    tmp.write_text(json.dumps(out))
    tmp.replace(path)
    print("tp_predict_child " + json.dumps(out))


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _tp_report(w: dict, dev, gpu_line: str) -> list[str]:
    """One world's ``tp`` lines; the failures of its checks."""
    world = w["world"]
    failed = []

    def check(cond, msg):
        if not cond:
            failed.append(msg)

    for name, r in w["runs"].items():
        print("tp " + json.dumps({"world": world, "mesh": w["mesh"], "run": name, **r,
                                  "warm_s": w["warm_s"], "world_s": w["world_s"],
                                  "gpu": gpu_line}), flush=True)
        check(r["within"] and r["whole_leaves_equal"] and r["losses_equal"]
              and r["ipc_equals_gloo"],
              f"tp: world {world} {name}: the sharded step is not the 1-rank step's "
              f"({r['against_one_rank']}, whole leaves equal {r['whole_leaves_equal']}, "
              f"losses equal {r['losses_equal']})")
        if "pred" in r:
            check(r["argument_equal"] and r["flops_equal"],
                  f"tp: world {world}: arguments {r['param_adam_bytes']} / FLOPs "
                  f"{r['flops']} against the dry run's {r['pred']}")
            if dev.type == "cuda":
                check(abs(r["peak_rel_err"]) <= DRYRUN_PEAK_TOL,
                      f"tp: world {world}: predicted peak {r['pred']['peak_bytes']} is "
                      f"{r['peak_rel_err']:+.3f} of the card's {r['peak_bytes']}")
    ranks = w["serve"]
    zero = ranks[0]
    print("tp_serve " + json.dumps({
        "world": world, "mesh": w["mesh"], "rows": TP_SERVE_ROWS, "prompt": TP_SERVE_PROMPT,
        "positions": TP_SERVE_SEQ, "steps": TP_SERVE_STEPS, **zero,
        "ranks_cache_bytes": {k: [r[k]["cache_bytes"] for r in ranks]
                              for k in ("fp32", "int8", "bf16")},
        "ranks_parts_bitwise": [r["int8"]["parts_bitwise"] for r in ranks],
        "ranks_peak_bytes": [r["bf16"].get("peak_bytes") for r in ranks], "gpu": gpu_line}),
        flush=True)
    a, q, b = zero["fp32"], zero["int8"], zero["bf16"]
    check(a["seq_cut"] == [["model"], world],
          f"tp_serve: world {world}: the caches' sequence is not cut over model: {a['seq_cut']}")
    check(all(r[k]["cache_exact"] for r in ranks for k in ("fp32", "bf16"))
          and b["ref_cache_bytes"] == b["whole_cache_bytes"],
          f"tp_serve: world {world}: a rank's cache bytes are not the whole's "
          f"{b['whole_cache_bytes']} over {world}")
    check(a["share"] <= 1 and a["tokens_equal"] and a["server_tokens_equal"],
          f"tp_serve: world {world}: fp32 serving is not the 1-rank run's: {a}")
    check(all(r["int8"]["parts_bitwise"] for r in ranks) and q["cut_leaves"] > 0
          and q["share"] <= 1 and q["tokens_equal"],
          f"tp_serve: world {world}: int8 serving: {q}")
    check(all(r["bf16"]["argument_equal"] for r in ranks),
          f"tp_serve: world {world}: bf16 decode arguments {b['argument_bytes']} against the "
          f"dry run's {b['pred']}")
    if dev.type == "cuda":
        for r in ranks:
            err = r["bf16"]["peak_rel_err"]
            check(abs(err) <= DRYRUN_PEAK_TOL,
                  f"tp_serve: world {world} rank {r['rank']}: predicted decode peak "
                  f"{r['bf16']['pred']['peak_bytes']} is {err:+.3f} of the card's "
                  f"{r['bf16']['peak_bytes']}")
    zs = w["zamba"]
    z = zs[0]
    print("tp_zamba " + json.dumps({
        "world": world, "mesh": w["mesh"], "arch": "zamba2-7b", "layers": TP_ZAMBA_LAYERS,
        "params": TP_ZAMBA_PARAMS, "rows": TP_SERVE_ROWS, "prompt": TP_ZAMBA_PROMPT,
        "steps": TP_ZAMBA_STEPS, **z,
        "ranks_state_bytes": {k: [r[k]["state_bytes"] for r in zs] for k in ("fp32", "int8")},
        "ranks_parts_bitwise": [all(v["bitwise"] for v in r["int8"]["parts"].values())
                                for r in zs], "gpu": gpu_line}), flush=True)
    t, a, q = z["train"], z["fp32"], z["int8"]
    check(t["within"] and t["whole_leaves_equal"] and t["losses_equal"] and t["ipc_equals_gloo"],
          f"tp_zamba: world {world}: the sharded step is not the 1-rank step's "
          f"({t['against_one_rank']}, whole leaves equal {t['whole_leaves_equal']}, "
          f"losses equal {t['losses_equal']})")
    check(z["heads_cut"] == [["model"], world] and z["routes"]["prefill"] == "weight"
          and z["routes"]["decode"] == "activation",
          f"tp_zamba: world {world}: heads cut {z['heads_cut']}, routes {z['routes']}")
    check(all(r[k]["state_exact"] for r in zs for k in ("fp32", "int8"))
          and a["ref_state_bytes"] == a["whole_state_bytes"],
          f"tp_zamba: world {world}: a rank's mamba2 state is not the whole's "
          f"{a['whole_state_bytes']} over {world}: {[r['fp32']['state_bytes'] for r in zs]}")
    check(a["share"] <= 1 and a["tokens_equal"],
          f"tp_zamba: world {world}: fp32 serving is not the 1-rank run's: {a}")
    check(all(v["bitwise"] for r in zs for v in r["int8"]["parts"].values())
          and any(v["int8"] and v["cut"] for v in q["parts"].values())
          and q["share"] <= 1 and q["tokens_equal"],
          f"tp_zamba: world {world}: int8 serving: {q}")
    return failed


def tp_phase(torch, np, dev, gpu_line) -> None:
    """Tensor parallelism over ``"model"`` on the card (the ``tp*`` lines):
    gemma-2b at its published width trained one step as ``launch.train``
    takes it (8 x 128 tokens, two microbatches, remat in bf16) by 2 and
    then 4 ranks sharing the card, ("data", "model") = (1, 2) and (1, 4),
    each rank holding its part of every leaf ``tree_shardings`` cuts, held
    against the 1-rank step (:func:`tp_rank`): in fp32 at
    ``TP_FP32_LAYERS`` layers (the run that holds the gradients and
    moments) and in bf16 at full depth (model = 4: the most the four
    ranks' predicted peaks allow), each within ``TP_ULPS``
    times what one ulp of weight noise moves the 1-rank step by; each rank's
    parameter and Adam bytes, FLOPs and peak against the dry run's
    prediction (made by :func:`tp_predict` in a process beside world 2, and
    printed by rank 0 before its step); the fp32 state saved by world 2 and
    restored bitwise by world 4 and on one rank.  Ranks sharing one card
    time no collective (gloo copies through the host): each rank's ms a
    step and the collectives' share are printed, not claimed.  Runs no
    hand-written kernel."""
    import gc
    import shutil

    import torch.multiprocessing as tmp

    t_phase = time.perf_counter()
    gc.collect()
    if torch.cuda.is_initialized():
        torch.cuda.empty_cache()
    shutil.rmtree(TP_DIR, ignore_errors=True)
    TP_DIR.mkdir(parents=True)
    total = None if dev.type == "cuda" else 80 * 10 ** 9  # the child reads the card's
    ctx = tmp.get_context("spawn")  # fresh processes: no CUDA state, no process group
    predict = ctx.Process(target=tp_predict, args=(str(TP_DIR / "predict.json"), total,
                                                   dev.type))
    predict.start()
    ctx = tmp.get_context("spawn")
    worlds, failed = {}, []
    go = ctx.Event()  # the later world starts early and waits for the earlier one
    started, queues = {}, []
    try:
        for i, world in enumerate(TP_WORLDS):
            queue, port = ctx.Queue(), _free_port()  # held in ``queues``: the
            queues.append(queue)  # children rebuild it after start() drops its args
            started[world] = (time.perf_counter(), [ctx.Process(
                target=tp_rank, args=(r, world, port, str(TP_DIR), queue, dev.type,
                                      go if i else None)) for r in range(world)])
            for p in started[world][1]:
                p.start()
        t_go = None
        for world in TP_WORLDS:
            t0, procs = started[world]
            for p in procs:
                p.join(timeout=900)
            codes = [p.exitcode for p in procs]
            check(codes == [0] * world, f"tp: world {world}'s ranks exited {codes}")
            if t_go is not None:
                t0 = t_go  # a later world's time counts from its go
            t_go = time.perf_counter()
            go.set()
            worlds[world] = json.loads((TP_DIR / f"rank0_{world}.json").read_text())
            worlds[world]["world_s"] = time.perf_counter() - t0
            failed += _tp_report(worlds[world], dev, gpu_line)
    finally:
        for _, procs in started.values():  # a failed world stops the ones waiting
            for p in procs:
                if p.is_alive():
                    p.kill()
        predict.join(timeout=60)
        if predict.is_alive():
            predict.kill()
    check(predict.exitcode == 0, f"tp: the prediction child exited {predict.exitcode}")
    restore = worlds[TP_WORLDS[-1]]["restore"]
    print("tp_checkpoint " + json.dumps({
        "saved_by": list(worlds[TP_WORLDS[0]]["mesh"].values()),
        "restored_on": list(worlds[TP_WORLDS[-1]]["mesh"].values()), **restore,
        "save_s": worlds[TP_WORLDS[0]]["runs"]["fp32"]["save_s"],
        "ckpt_bytes": worlds[TP_WORLDS[0]]["runs"]["fp32"]["ckpt_bytes"], "gpu": gpu_line}))
    check(not failed, "; ".join(failed))
    check(restore["mesh_bitwise"] and restore["one_rank_bitwise"] and restore["step"] == 1,
          f"tp: the checkpoint across meshes: {restore}")
    shutil.rmtree(TP_DIR / "ckpt", ignore_errors=True)
    print("tp_phase " + json.dumps({
        "phase_s": time.perf_counter() - t_phase,
        "world_s": {w: v["world_s"] for w, v in worlds.items()}, "gpu": gpu_line}))


def _cache_zeros(torch, T, cfg, dev) -> dict:
    """Zero decode caches for ``DRYRUN_DECODE_SLOTS`` x ``DRYRUN_DECODE_SEQ``."""
    def make(tree):
        if isinstance(tree, dict):
            return {k: make(v) for k, v in tree.items()}
        shape, dtype = tree
        return torch.zeros(shape, dtype=dtype, device=dev)

    return make(T.cache_shapes(cfg, DRYRUN_DECODE_SLOTS, DRYRUN_DECODE_SEQ))


def _value_and_grad_out(torch, fn, params):
    """``fn(params)`` and the gradients of its sum with respect to every
    leaf of ``params``."""
    from repro_torch.core.sensitivity import value_and_grad

    holder = {}

    def loss(p):
        holder["y"] = fn(p)
        return holder["y"].sum()

    _, grads = value_and_grad(loss, params)
    return holder["y"].detach(), grads


#: K1's and K2's layers at 8 slots, (kernel, shape) as _qmm_case / _conv_case
#: take them, and the front-end primitives' shapes
COMPARE_LAYERS = {
    "dense0": ("quant_matmul", (8, 35072, 64)), "dense0_pruned": ("quant_matmul", (8, 8704, 64)),
    "dense1": ("quant_matmul", (8, 64, 2)), "conv0": ("conv1d_fused_q", (8, 1096, 1, 64, 3)),
    "conv1": ("conv1d_fused_q", (8, 548, 64, 128, 3)),
    "conv2": ("conv1d_fused_q", (8, 274, 128, 256, 3)),
    "conv2_pruned": ("conv1d_fused_q", (8, 274, 128, 64, 3)),
    # the front-end's fixed-order primitives: the mfcc20 block's shapes, the
    # float layers' and the longest row
    "project_rows:mel": ("project_rows", MFCC20_PROJECTIONS[0]),
    "project_rows:dct": ("project_rows", MFCC20_PROJECTIONS[1]),
    **{f"project_rows:{name}": ("project_rows", shape)
       for name, shape in FLOAT_LAYER_SHAPES.items()},
    **{f"row_sum:{r}x{n}": ("row_sum", (r, n))
       for r, n in sorted(set(MFCC20_ROW_SUMS)) + [(1, 32 * 1024)]},
}
#: run in a fresh process against one checkout (argv[1]): its own
#: chip_smoke.py's case makers and timer, its own kernels; prints one
#: "TIMES {...}" line of CUPTI ms a call per layer or shape
COMPARE_SNIPPET = r"""
import json, sys
root = sys.argv[1]
sys.path[:0] = [root, root + "/src"]
import torch
import chip_smoke as cs
from repro_torch.kernels.conv1d_fused import conv1d_fused_q
from repro_torch.kernels.quant_matmul import quant_matmul
dev = torch.device("cuda")
gen = torch.Generator().manual_seed(cs.SEED)
times = {}
from repro_torch.kernels.frontend import project_rows, row_sum
for name, (kernel, shape) in json.loads(sys.argv[2]).items():
    if kernel == "quant_matmul":
        fn, (args, kw) = quant_matmul, cs._qmm_case(torch, gen, dev, *shape, act="relu")
    elif kernel == "conv1d_fused_q":
        fn, (args, kw) = conv1d_fused_q, cs._conv_case(torch, gen, dev, *shape)
    elif kernel == "project_rows":
        r, k, n = shape
        fn, args, kw = project_rows, (torch.randn((r, k), generator=gen).to(dev),
                                      torch.randn((k, n), generator=gen).to(dev)), {}
    else:
        fn, args, kw = row_sum, (torch.randn(tuple(shape), generator=gen).to(dev),), {}
    times[name] = cs.device_time(torch, lambda: fn(*args, **kw))[0]
print("TIMES " + json.dumps(times))
"""


def held_clock_ms(torch, fn, *, iters: int = 30, spin_cycles: int = 2_000_000) -> float:
    """Device time (ms) of the kernel ``fn`` launches (one op a call) when a
    spin kernel (``torch.cuda._sleep``, ~1 ms) runs just before each call,
    so that the card does not clock down in the host gaps between calls.
    The spin kernels are left out by their length (over 0.1 ms)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def spun():
        torch.cuda._sleep(spin_cycles)
        fn()

    for _ in range(5):
        spun()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            spun()
        torch.cuda.synchronize()
    ops = [e for e in prof.events() if e.device_type == DeviceType.CUDA
           and e.time_range.elapsed_us() < 100]
    check(bool(ops), "held-clock timing: the trace holds no kernel")
    return statistics.median(e.time_range.elapsed_us() for e in ops) / 1e3


def sweep_phase(torch, dev, gpu_line) -> None:
    """K2's device time for every tile and stage count the kernel takes,
    and K1's for other splits of K, at the serving layers and at other
    batch sizes (B = 1, 32): what the tiling functions choose, beside what
    they could have chosen, each tiling's int32 accumulators and outputs
    held bitwise to the chosen one's (the reference's contract that no
    tiling changes the accumulators, ``tests/test_tiling.py``); and every
    serving call of K1 and K2 timed again with the card held busy before
    each call (``held_clock_ms``).  One ``tile_sweep`` line a case."""
    import dataclasses as dc

    from repro_torch.kernels import conv1d_fused as tconv
    from repro_torch.kernels import quant_matmul as tqmm

    gen = torch.Generator().manual_seed(SEED + 5)
    chosen_conv, chosen_qmm = tconv.conv_tiling, tqmm.qmm_tiling
    try:
        for label, shape in (("conv1", (8, 548, 64, 128, 3)), ("conv2", (8, 274, 128, 256, 3)),
                             ("conv2_b1", (1, 274, 128, 256, 3)),
                             ("conv2_b32", (32, 274, 128, 256, 3))):
            args, kw = _conv_case(torch, gen, dev, *shape)
            base = chosen_conv(*shape)
            want_out = tconv.conv1d_fused_q(*args, **kw)
            want_acc = tconv.conv1d_fused_q(*args[:4], return_acc=True)
            for bm, bn in ((64, 64), (32, 64), (64, 32), (32, 32)):
                for stages in (2, 4):
                    tile = dc.replace(base, bm=bm, bn=bn, stages=stages)
                    tconv.conv_tiling = lambda *a, t=tile: t
                    same = (bitwise(torch, tconv.conv1d_fused_q(*args[:4], return_acc=True),
                                    want_acc)
                            and bitwise(torch, tconv.conv1d_fused_q(*args, **kw), want_out))
                    check(same, f"K2 {label} at tile {bm}x{bn}, {stages} stages: accumulators "
                                f"or outputs differ from the chosen tile's")
                    ms = time_ms(torch, lambda: tconv.conv1d_fused_q(*args, **kw))
                    print("tile_sweep " + json.dumps({
                        "layer": label, "bm": bm, "bn": bn, "stages": stages, "ms": ms,
                        "chosen": (bm, bn, stages) == (base.bm, base.bn, base.stages),
                        "acc_and_out_equal_chosen": same, "gpu": gpu_line}))
            tconv.conv_tiling = chosen_conv
            ms = time_ms(torch, lambda: tconv.conv1d_fused_q(*args[:4], return_acc=True))
            print("tile_sweep " + json.dumps({"layer": label, "return_acc": True, "ms": ms,
                                              "gpu": gpu_line}))
        # the same serving calls with the card held busy before each one
        for label, (kernel, shape) in COMPARE_LAYERS.items():
            if kernel not in ("quant_matmul", "conv1d_fused_q"):
                continue
            if kernel == "quant_matmul":
                fn, (args, kw) = tqmm.quant_matmul, _qmm_case(torch, gen, dev, *shape, act="relu")
            else:
                fn, (args, kw) = tconv.conv1d_fused_q, _conv_case(torch, gen, dev, *shape)
            print("tile_sweep " + json.dumps({
                "layer": label, "ms": time_ms(torch, lambda: fn(*args, **kw)),
                "held_clock_ms": held_clock_ms(torch, lambda: fn(*args, **kw)),
                "gpu": gpu_line}))
        for label, (m, k, n) in (("dense0", (8, 35072, 64)), ("dense0_pruned", (8, 8704, 64))):
            args, kw = _qmm_case(torch, gen, dev, m, k, n, act="relu")
            base = chosen_qmm(m, k, n)
            want_out = tqmm.quant_matmul(*args, **kw)
            want_acc = tqmm.quant_matmul(*args[:4], return_acc=True)
            chunks = -(-k // tqmm.CHUNK_K)
            for per_block in (1, 2, 4, 8):
                tile = dc.replace(base, chunks_per_block=per_block, splits=-(-chunks // per_block))
                tqmm.qmm_tiling = lambda *a, t=tile: t
                same = (bitwise(torch, tqmm.quant_matmul(*args[:4], return_acc=True), want_acc)
                        and bitwise(torch, tqmm.quant_matmul(*args, **kw), want_out))
                check(same, f"K1 {label} at {per_block} chunks a block ({tile.splits} splits): "
                            f"accumulators or outputs differ from the chosen split's")
                ms = time_ms(torch, lambda: tqmm.quant_matmul(*args, **kw))
                print("tile_sweep " + json.dumps({
                    "layer": label, "chunks_per_block": per_block, "splits": tile.splits,
                    "ms": ms, "chosen": tile == base, "acc_and_out_equal_chosen": same,
                    "gpu": gpu_line}))
    finally:
        tconv.conv_tiling, tqmm.qmm_tiling = chosen_conv, chosen_qmm


def compare_phase(parent: Path, gpu_line: str) -> dict:
    """K1's and K2's device time a call at every serving layer, and
    ``project_rows``'s and ``row_sum``'s at the mfcc20 block's and the float
    layers' shapes, for the parent checkout and this one, each in its own
    process, in the order parent, change, change, parent on this card."""
    runs = []
    for root in (parent, ROOT, ROOT, parent):
        proc = subprocess.run([sys.executable, "-c", COMPARE_SNIPPET, str(root),
                               json.dumps(COMPARE_LAYERS)],
                              capture_output=True, text=True, timeout=600)
        lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("TIMES ")]
        check(proc.returncode == 0 and bool(lines),
              f"timing run in {root} failed: {proc.stderr.strip()[-2000:]}")
        runs.append(json.loads(lines[-1][len("TIMES "):]))
    out = {}
    for name, (kernel, _) in COMPARE_LAYERS.items():
        out[name] = {"kernel": kernel, "parent_ms": [runs[0][name], runs[3][name]],
                     "change_ms": [runs[1][name], runs[2][name]]}
    for kernel, layers in (("quant_matmul", ("dense0", "dense1")),
                           ("conv1d_fused_q", ("conv0", "conv1", "conv2"))):
        out[f"{kernel}_per_forward"] = {
            "kernel": kernel, "layers": list(layers),
            "parent_ms": [sum(runs[i][n] for n in layers) for i in (0, 3)],
            "change_ms": [sum(runs[i][n] for n in layers) for i in (1, 2)]}
    # the on-device front-end's block: both projections, every row sum
    for kernel, layers in (("project_rows", ["project_rows:mel", "project_rows:dct"]),
                           ("row_sum", [f"row_sum:{r}x{n}" for r, n in MFCC20_ROW_SUMS])):
        out[f"{kernel}_per_mfcc20_block"] = {
            "kernel": kernel, "layers": layers,
            "parent_ms": [sum(runs[i][n] for n in layers) for i in (0, 3)],
            "change_ms": [sum(runs[i][n] for n in layers) for i in (1, 2)]}
    for entry in out.values():
        entry["change_over_parent"] = sum(entry["change_ms"]) / sum(entry["parent_ms"])
    print("kernel_compare " + json.dumps({"parent": str(parent), "order": "parent, change, "
                                          "change, parent", "layers": out, "gpu": gpu_line}))
    return out


def main(argv: list[str] | None = None) -> int:
    import argparse
    import os

    # cuBLAS reproducible under torch.use_deterministic_algorithms (phase 10);
    # read when cuBLAS starts, so set before any CUDA work
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch

    ap = argparse.ArgumentParser(description="Smoke run of the port on one GPU.")
    ap.add_argument("--parent", type=Path, default=None,
                    help="a checkout of the parent commit: also time its K1, K2, "
                         "project_rows and row_sum at the serving shapes beside this "
                         "tree's, in turns")
    args = ap.parse_args(argv)

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
        # phase 12 first: its ranks share the card, and this process makes
        # no CUDA context before them (a context that has run the other
        # phases holds GBs the ranks' full-depth steps need)
        tp_phase(torch, np, torch.device("cuda"), gpu_line)
        t0 = time.perf_counter()
        backend.library()
        print(f"build_seconds {time.perf_counter() - t0:.1f} (nvcc {backend.build_seconds:.1f})")
        dev = torch.device("cuda")
        sass = sass_phase(torch, backend, gpu_line)
        kernels = kernel_phase(torch, dev, gpu_line, sass)
        k3b_err = cordic_phase(torch, np, dev, gpu_line, sass)
        kernels.update(frontend_primitive_phase(torch, np, dev, gpu_line))
        float_layer_phase(torch, np, dev, gpu_line)
        launches: dict[str, int] = {}

        def add(counts):
            for name, c in counts.items():
                launches[name] = launches.get(name, 0) + c

        signoff_launches, kernels["cordic_activation"] = signoff_phase(torch, np, dev, gpu_line,
                                                                       sass)
        kernels["cordic_activation"]["max_abs_err"] = max(
            k3b_err, kernels["cordic_activation"]["max_abs_err"])
        add(signoff_launches)
        frontend_phase(torch, np, dev, gpu_line)
        engine_launches, runs = engine_phase(torch, np, dev, gpu_line)
        add(engine_launches)
        add(ondevice_phase(torch, np, dev, gpu_line))
        add(fleet_phase(torch, np, dev, gpu_line, *runs["int8"]))
        add(sharded_phase(torch, np, dev, gpu_line, runs))
        sweep_phase(torch, dev, gpu_line)
        add(training_phase(torch, np, dev, gpu_line))
        add(lm_phase(torch, np, dev, gpu_line))
        add(lm_train_phase(torch, np, dev, gpu_line))
        dryrun_phase(torch, np, dev, gpu_line)
        examples_phase(gpu_line)
        if args.parent is not None:
            compare_phase(args.parent.resolve(), gpu_line)
        for name in kernels:
            check(launches.get(name, 0) > 0, f"kernel {name} was never launched on the main path")
            kernels[name]["launches"] = launches[name]
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
