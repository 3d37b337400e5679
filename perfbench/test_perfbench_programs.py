"""The harness's discovery of a cell's program by name: the detector where a
configuration names none, the LM decode program, and a program with no
file, which fails before any set-up."""
import json
import shutil

import pytest

from perfbench import harness, lm_traffic, spec


def _files(tmp_path, monkeypatch):
    """Copies of the configuration and traffic folders the test may add to."""
    for sub in ("configs", "traffic"):
        shutil.copytree(spec.HERE / sub, tmp_path / sub)
    monkeypatch.setattr(spec, "CONFIGS", tmp_path / "configs")
    monkeypatch.setattr(spec, "TRAFFIC", tmp_path / "traffic")
    return tmp_path


@pytest.mark.parametrize("config,program", [("shield8_int8", "detector"),
                                            ("shield8_pruned_mixed", "detector"),
                                            ("phi4_mini_bf16", "lm_decode")])
def test_each_configuration_finds_its_program(config, program):
    conf = spec.config(config)
    assert ("program" in conf) == (program != "detector")
    assert spec.program_name(conf) == program
    assert spec.program_path(conf) == spec.PROGRAMS / f"{program}.py"
    module = harness.load_program(conf)
    assert callable(module.run_cell)


def test_a_program_with_no_file_fails_before_any_set_up(tmp_path, monkeypatch, capsys):
    _files(tmp_path, monkeypatch)
    conf = dict(spec.config("shield8_int8"), name="ghost", program="no_such_program")
    (tmp_path / "configs" / "ghost.json").write_text(json.dumps(conf))
    monkeypatch.setattr(harness, "run_cell", lambda *a, **k: pytest.fail("set-up ran"))
    with pytest.raises(FileNotFoundError, match=r"programs/no_such_program\.py"):
        harness.main(["--workload", "ghost.archive_feat", "--seed", "1", "--seconds", "1"],
                     t_start=0.0)
    assert capsys.readouterr().out == ""


def test_the_detector_program_is_the_harness_loop(monkeypatch):
    calls = []
    monkeypatch.setattr(harness, "run_cell", lambda *a, **k: calls.append((a, k)) or {})
    module = harness.load_program(spec.config("shield8_int8"))
    cell = spec.cell("shield8_int8.archive_feat")
    assert module.run_cell(cell, 7, 1.0, False, t_start=3.0) == {}
    assert calls == [((cell, 7, 1.0, False), {"t_start": 3.0})]


def test_each_program_validates_its_own_traffic():
    lm_mix, det_mix = spec.traffic("decode_ctx3k"), spec.traffic("archive_feat")
    assert lm_traffic.validate(lm_mix) is lm_mix
    with pytest.raises(ValueError, match="kind"):
        lm_traffic.validate(det_mix)
    with pytest.raises(ValueError, match="inflight"):
        lm_traffic.validate(dict(lm_mix, inflight=2))
    with pytest.raises(ValueError, match="prompt_len"):
        lm_traffic.validate(dict(lm_mix, prompt_len=0))
    cell = spec.cell("shield8_int8.archive_feat")
    odd = spec.Cell(cell.name, cell.config, dict(cell.traffic, input="midi"), (), ())
    with pytest.raises(ValueError, match="input"):
        harness.run_cell(odd, 1, 0.1, False, device="cpu")


def test_a_trial_cell_reports_the_metrics_of_its_programs_cells(tmp_path, monkeypatch):
    _files(tmp_path, monkeypatch)
    mix = dict(spec.traffic("decode_ctx3k"), slots=4, why="a new mix")
    (tmp_path / "traffic" / "decode_ctx3k_s4.json").write_text(json.dumps(mix))
    lm = spec.cell("phi4_mini_bf16.decode_ctx3k_s4")
    assert {m["name"] for m in lm.end_to_end} == {"tokens_per_s", "decode_step_p95_ms", "setup_s"}
    assert "decode_hbm_roofline" in {m["name"] for m in lm.per_layer}
    assert not {"k2_roofline", "windows_per_s"} & {m["name"] for m in lm.per_layer + lm.end_to_end}
    det = spec.cell("shield8_pruned_mixed.archive_raw")
    assert {m["name"] for m in det.end_to_end} == {"windows_per_s", "block_latency_p95_ms",
                                                   "setup_s"}
    assert "decode_mfu" not in {m["name"] for m in det.per_layer}


def test_the_benchmark_has_one_lm_cell_beside_the_detectors():
    bench = spec.benchmark()
    cells = {w["name"]: w for w in bench["workloads"]}
    assert cells["phi4_mini_bf16.decode_ctx3k"]["chips"] == 1
    lm = spec.cell("phi4_mini_bf16.decode_ctx3k", bench)
    assert {m["name"] for m in lm.end_to_end} == {"tokens_per_s", "decode_step_p95_ms", "setup_s"}
    assert {m["name"] for m in lm.per_layer} == {
        "decode_issue_ms_per_step", "decode_device_ms_per_step", "decode_idle_share",
        "decode_hbm_roofline", "decode_mfu"}
    for name in ("shield8_int8.archive_feat", "shield8_pruned_mixed.archive_feat"):
        det = spec.cell(name, bench)
        assert not {m["name"] for m in det.per_layer} & {m["name"] for m in lm.per_layer}
