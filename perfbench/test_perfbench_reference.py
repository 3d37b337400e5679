"""The comparison that decides ``correct``: the reference against the port's
CPU path, and a run driven end to end here on the CPU (the harness's look
for a card skipped) with the program, the control, and the faults the
cells can have planted under the timed path."""
import json
import subprocess
import sys

import numpy as np
import pytest
import torch

from perfbench import calibrate, harness, reference, spec, traffic, weights

CONFIGS = ("shield8_int8", "shield8_pruned_mixed")
SEED = 2**32 + 5


def _cell(config, mix="archive_feat", **kw):
    bench = spec.benchmark()
    cell = spec.cell(f"{config}.{mix}", bench)
    small = {**cell.traffic, **dict(bank=12, scene_windows=6, block=6, ring=2, warmup_blocks=1,
                                    trace_blocks=2), **kw}
    return spec.Cell(cell.name, cell.config, small, cell.end_to_end, cell.per_layer)


@pytest.mark.parametrize("config", CONFIGS)
def test_reference_agrees_with_the_ports_cpu_path(config):
    from perfbench.program import Program

    conf = spec.config(config)
    s = traffic.seeds(SEED)
    mix = _cell(config).traffic
    rows = torch.from_numpy(traffic.make_bank(mix, s.bank).rows)
    params = weights.float_params(conf["cnn"], s.weights, "cpu")
    got = Program(conf, params, "cpu", raw=False)(rows).numpy()
    want = reference.forward(reference.bake(params, conf), rows).numpy()
    assert np.abs(got - want).max() <= conf["limits"]["feat"]["max_prob_gap"]
    control = reference.forward(
        reference.bake(params, conf, reference.control_modes(conf)), rows).numpy()
    assert np.abs(control - want).max() > 3 * conf["limits"]["feat"]["max_prob_gap"]


def test_control_precisions_are_one_step_down():
    assert reference.control_modes(spec.config("shield8_int8")) == {
        f"conv{i}": "int4" for i in range(3)} | {"dense0": "int4", "dense1": "int4"}
    assert reference.control_modes(spec.config("shield8_pruned_mixed")) == {
        "conv0": "int8", "conv1": "int4", "conv2": "int4", "dense0": "int4", "dense1": "bf16"}


@pytest.mark.parametrize("config", CONFIGS)
@pytest.mark.parametrize("mode,correct", [("program", True), ("control", False),
                                          ("half_batch", False), ("altered_answer", False)])
def test_a_run_is_correct_only_with_the_program(config, mode, correct):
    result = harness.run_cell(_cell(config), SEED, 0.2, False, device="cpu",
                              forward_factory=calibrate.MODES[mode])
    assert result["correct"] is correct, result["checks"]
    assert list(result)[-1] == "checks"
    assert result["attempted"] > 0 and (result["failed"] == 0) is correct
    assert set(result["metrics"]) == {"windows_per_s", "block_latency_p95_ms", "setup_s"}


def test_traced_run_reports_per_layer_metrics_it_can_read():
    result = harness.run_cell(_cell("shield8_pruned_mixed"), SEED, 0.2, True, device="cpu")
    assert result["correct"]
    # no device here: only the host's readings
    assert set(result["metrics"]) == {"enqueue_ms_per_block", "mfu"}
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    assert {"busy_s", "window_s"} <= set(result["device"])


def test_raw_windows_are_staged_and_judged():
    cell = _cell("shield8_int8", mix="archive_raw", bank=4, block=3)
    s = traffic.seeds(SEED)
    bank = traffic.make_bank(cell.traffic, s.bank)
    ring = traffic.draw_ring(cell.traffic, 4, s.blocks)
    ref = harness.reference_ring(cell, SEED, bank, ring, torch.device("cpu"))
    assert ref.shape == (2, 3, 2) and np.allclose(ref.sum(axis=-1), 1.0)
    result = harness.run_cell(cell, SEED, 0.2, False, device="cpu")
    assert result["checks"]["rows_missing"]["value"] == 0
    assert result["checks"]["max_prob_gap"]["value"] < 1e-2  # host and card front-ends agree


def test_the_command_refuses_without_a_card(tmp_path):
    proc = subprocess.run(
        [sys.executable, str(spec.HERE / "run.py"), "--workload", "shield8_int8.archive_feat",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=tmp_path, timeout=120)
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert proc.returncode != 0 and proc.stdout == ""
    assert "CUDA" in proc.stderr


def test_a_checkout_without_the_program_refuses(tmp_path):
    import shutil

    shutil.copy(spec.BENCHMARK, tmp_path / "BENCHMARK.json")
    shutil.copytree(spec.HERE, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", "shield8_int8.archive_feat",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=tmp_path, timeout=120)
    assert proc.returncode != 0 and proc.stdout == ""


def test_the_run_loads_neither_jax_nor_the_jax_package():
    code = (
        "import sys, json; sys.path[0:0] = ['.', 'src']\n"
        "from perfbench import harness, spec\n"
        "cell = spec.cell('shield8_pruned_mixed.archive_feat')\n"
        "mix = dict(cell.traffic, bank=4, scene_windows=4, block=2, ring=2, warmup_blocks=1)\n"
        "cell = spec.Cell(cell.name, cell.config, mix, cell.end_to_end, cell.per_layer)\n"
        "harness.run_cell(cell, 3, 0.1, False, device='cpu')\n"
        "print(json.dumps(sorted({m.partition('.')[0] for m in sys.modules})))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          cwd=spec.ROOT, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    loaded = set(json.loads(proc.stdout.strip().splitlines()[-1]))
    assert "repro_torch" in loaded and "perfbench" in loaded
    assert not loaded & set(harness.FORBIDDEN_MODULES)


def test_the_yardstick_imports_nothing_of_the_program_or_of_jax():
    import ast

    judged = ("reference", "yardstick", "traffic", "weights", "tracing", "spec", "harness")
    files = [spec.HERE / f"{m}.py" for m in judged] + sorted(spec.HERE.glob("frozen/*.py"))
    files += sorted(spec.METRICS.glob("*.py"))
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for name in names:
                top = name.partition(".")[0]
                assert top not in harness.FORBIDDEN_MODULES + ("repro_torch", "benchmarks"), (
                    path.name, name)


def test_an_answer_that_is_not_finite_fails_the_run():
    def nan_rows(conf, params, device, raw):
        prog = calibrate._program(conf, params, device, raw)
        first = torch.tensor([[float("nan")]] + [[1.0]] * (_cell("shield8_int8").traffic["block"] - 1))
        return lambda rows: prog(rows) * first

    result = harness.run_cell(_cell("shield8_int8"), SEED, 0.2, False, device="cpu",
                              forward_factory=nan_rows)
    assert not result["correct"]
    assert result["checks"]["max_prob_gap"]["value"] == harness.NOT_FINITE_GAP


def test_the_command_prints_no_result_once_jax_is_loaded(monkeypatch, capsys):
    import types

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(harness, "run_cell", lambda *a, **k: {"checks": {}})
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    code = harness.main(["--workload", "shield8_int8.archive_feat", "--seed", "1",
                         "--seconds", "1"], t_start=0.0)
    out = capsys.readouterr()
    assert code != 0 and out.out == "" and "jax" in out.err
