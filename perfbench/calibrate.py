"""Readings that set the limit of the comparison deciding ``correct``.

    python3 perfbench/calibrate.py --workload <cell> --seeds 1,2,3 --seconds 2 \
        --modes program,control,half_batch,altered_answer

For each seed and mode, one run of the cell's closed loop at its own block
size, with the mode's forward in the program's place, compared with the
reference as a benchmark run compares; one JSON line each.  The modes:

* ``program``: the port (its readings are the lower ones);
* ``control``: the reference computed one precision below what the
  configuration states (int8 -> int4, bf16 -> int8, fp32 -> bf16), which
  has to come out not correct (the upper readings);
* ``half_batch``: the program scoring half of each block, the other half
  given the mean of the answers it computed;
* ``altered_answer``: the program with one answer of each block altered
  where it is produced (its two class probabilities swapped).

The benchmark's own runs never run these.  Seeds share one process; each
seed's bank is synthesised once for all its modes.

A program with modes of its own (a module-level ``MODES``, as
``programs/lm_decode.py``'s control and faults) runs them through its
``run_cell(..., mode=...)``, with the configuration's limits taken away so
that every number the program can compare is read.
"""
import sys
from pathlib import Path

if __name__ == "__main__":
    sys.path[0:1] = [str(Path(__file__).resolve().parents[1]),
                     str(Path(__file__).resolve().parents[1] / "src")]

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import json  # noqa: E402

import torch  # noqa: E402

from perfbench import harness, reference, spec, traffic  # noqa: E402


def control(conf, params, device, raw):
    if raw:
        raise ValueError("the control takes feature rows; raw windows need the numpy front-end")
    art = reference.bake(params, conf, reference.control_modes(conf))
    return lambda rows: reference.forward(art, rows).to(torch.float32)


def _program(conf, params, device, raw):
    from perfbench.program import Program

    return Program(conf, params, device, raw=raw)


def half_batch(conf, params, device, raw):
    prog = _program(conf, params, device, raw)

    def forward(rows):
        half = rows.shape[0] // 2
        done = prog(rows[:half])
        return torch.cat([done, done.mean(dim=0, keepdim=True).expand(rows.shape[0] - half, -1)])

    return forward


def altered_answer(conf, params, device, raw):
    prog = _program(conf, params, device, raw)

    def forward(rows):
        out = prog(rows)
        return torch.cat([out[:1].flip(-1), out[1:]])

    return forward


MODES = {"program": None, "control": control, "half_batch": half_batch,
         "altered_answer": altered_answer}


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds")
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--modes", default="program")
    args = ap.parse_args(argv)
    cell = spec.cell(args.workload)
    program = harness.load_program(cell.config)
    if hasattr(program, "MODES"):
        cell = dataclasses.replace(cell, config=dict(cell.config, limits={}))
        for seed in (int(s) for s in args.seeds.split(",")):
            for mode in args.modes.split(","):
                result = program.run_cell(cell, seed, args.seconds, False, mode=mode)
                # what the run left allocated on the card: the next run in
                # this process starts from it
                left = torch.cuda.memory_allocated() if torch.cuda.is_available() else 0
                print(json.dumps({"cell": cell.name, "seed": seed, "mode": mode,
                                  "checks": result["checks"], "metrics": result["metrics"],
                                  "memory_peak_bytes": result["device"]["memory_peak_bytes"],
                                  "memory_left_bytes": left, "card": result["card"]}),
                      flush=True)
        return 0
    # every mode of one seed runs on the same bank: synthesise it once
    banks = {}
    make_bank = traffic.make_bank

    def bank_once(mix, seq):
        key = (seq.entropy, tuple(seq.spawn_key), json.dumps(mix, sort_keys=True))
        if key not in banks:
            banks.clear()
            banks[key] = make_bank(mix, seq)
        return banks[key]

    traffic.make_bank = bank_once
    for seed in (int(s) for s in args.seeds.split(",")):
        for mode in args.modes.split(","):
            result = harness.run_cell(cell, seed, args.seconds, False,
                                      forward_factory=MODES[mode])
            print(json.dumps({"cell": cell.name, "seed": seed, "mode": mode,
                              "correct": result["correct"], "checks": result["checks"],
                              "metrics": result["metrics"], "card": result["card"]}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
