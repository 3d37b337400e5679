"""``BENCHMARK.json`` against the benchmark's contract, and the harness's
discovery of configurations, traffic mixes and metric readers by name."""
import json
import re
import shutil

import pytest

from perfbench import harness, spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}


@pytest.fixture(scope="module")
def bench():
    return spec.benchmark()


def _text_ok(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_shape(bench):
    assert set(bench) == TOP_KEYS
    assert 1 <= len(bench["paths"]) <= 16 and all(PATH.match(p) for p in bench["paths"])
    assert all(".." not in p.split("/") and not p.startswith("/") for p in bench["paths"])
    assert 1 <= len(bench["command"]) <= 32 and all(_text_ok(w) for w in bench["command"])
    assert 1 <= bench["run_seconds"] <= 51 and isinstance(bench["run_seconds"], int)
    assert len(json.dumps(bench)) <= 64 * 1024


def test_run_seconds_fits_a_full_check_of_24_cells(bench):
    cells = 24
    runs = 2 + 14 * cells
    assert runs * (bench["run_seconds"] + 60) + cells * 2 * 90 + 1200 <= 43200


def test_names_units_and_lines(bench):
    names = [c["name"] for c in bench["configs"]]
    names += [w["name"] for w in bench["workloads"]]
    names += [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    names += [w["config"] for w in bench["workloads"]] + [w["traffic"] for w in bench["workloads"]]
    names += [k for c in bench["configs"] for k in c["reduced"]]
    assert all(NAME.match(n) for n in names), [n for n in names if not NAME.match(n)]
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for entry in bench["configs"] + bench["workloads"]:
        assert _text_ok(entry["why"])
    for m in bench["per_layer"]:
        assert _text_ok(m["layer"])
    for c in bench["configs"]:
        assert _text_ok(c["source"]) and len(c["reduced"]) <= 16


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end", "per_layer"])
def test_entries_have_just_their_keys(bench, section):
    keys = {
        "configs": {"name", "source", "file", "reduced", "why"},
        "workloads": {"name", "config", "traffic", "chips", "why"},
        "end_to_end": {"name", "unit", "better", "bound", "source"},
        "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
    }[section]
    for entry in bench[section]:
        assert set(entry) - {"workloads"} == keys, entry["name"]
    assert len({e["name"] for e in bench[section]}) == len(bench[section])


def test_cells_configs_and_files(bench):
    assert 1 <= len(bench["workloads"]) <= 24 and 1 <= len(bench["configs"]) <= 24
    used = {w["config"] for w in bench["workloads"]}
    assert used == {c["name"] for c in bench["configs"]}
    assert len({(w["config"], w["traffic"]) for w in bench["workloads"]}) == len(bench["workloads"])
    for c in bench["configs"]:
        assert c["file"].startswith(tuple(p + "/" for p in bench["paths"]))
        assert (spec.ROOT / c["file"]).is_file()
        assert c["file"] == f"perfbench/configs/{c['name']}.json"
    for w in bench["workloads"]:
        assert w["chips"] in (1, 4) and w["name"] == f"{w['config']}.{w['traffic']}"
        assert w["traffic"] in spec.traffic_names()
    assert sum(w["chips"] == 4 for w in bench["workloads"]) <= max(1, len(bench["workloads"]) // 4)


def test_metrics_sources_and_bounds(bench):
    e2e = bench["end_to_end"]
    assert 1 <= len(e2e) <= 16 and 1 <= len(bench["per_layer"]) <= 128
    assert "setup_s" in {m["name"] for m in e2e}
    for m in e2e:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert "bound" not in m
    for m in e2e + bench["per_layer"]:
        assert m["name"] in spec.metric_names(), f"no reader for {m['name']}"


def test_each_per_layer_metric_moves_what_its_cells_report(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    cells = [w["name"] for w in bench["workloads"]]

    def reports(metric, cell):
        return "workloads" not in metric or cell in metric["workloads"]

    layers = {}
    for m in bench["per_layer"]:
        assert m["moves"] in e2e, m["name"]
        for cell in cells:
            if reports(m, cell):
                assert reports(e2e[m["moves"]], cell), (m["name"], cell)
        layers.setdefault(m["layer"], []).append(m["name"])
    for cell in cells:  # every cell: setup, another end-to-end metric, a per-layer metric
        mine = [m["name"] for m in bench["end_to_end"] if reports(m, cell)]
        assert "setup_s" in mine and len(mine) >= 2
        assert any(reports(m, cell) for m in bench["per_layer"])
    for m in bench["per_layer"]:
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_cells_resolve_to_their_files(bench):
    for w in bench["workloads"]:
        cell = spec.cell(w["name"], bench)
        assert cell.config["name"] == w["config"] and cell.chips == w["chips"]
        assert {m["name"] for m in cell.end_to_end} >= {"setup_s"}


def test_new_traffic_and_metric_files_are_taken_without_an_edit(tmp_path, monkeypatch):
    for sub in ("configs", "traffic", "metrics"):
        shutil.copytree(spec.HERE / sub, tmp_path / sub)
    mix = json.loads((tmp_path / "traffic" / "archive_feat.json").read_text())
    mix.update(block=8, why="a new mix: smaller blocks")
    (tmp_path / "traffic" / "archive_feat_b8.json").write_text(json.dumps(mix))
    (tmp_path / "metrics" / "rows_per_block.py").write_text(
        "def read(run):\n    return run.window.rows / run.window.blocks\n")
    monkeypatch.setattr(spec, "TRAFFIC", tmp_path / "traffic")
    monkeypatch.setattr(spec, "METRICS", tmp_path / "metrics")
    assert "archive_feat_b8" in spec.traffic_names()
    assert "rows_per_block" in spec.metric_names()
    bench = spec.benchmark()
    bench["per_layer"] = bench["per_layer"] + [
        {"name": "rows_per_block", "unit": "rows", "better": "higher", "source": "host_clock",
         "layer": "whole forward", "moves": "windows_per_s"}]
    cell = spec.cell("shield8_int8.archive_feat_b8", bench)
    assert cell.traffic["block"] == 8 and cell.config["name"] == "shield8_int8"
    window = harness.Window(blocks=3, rows=24, seconds=1.0, latencies_s=[0.1] * 3,
                            enqueue_s=[0.01] * 3, results=[])
    run = harness.Run(cell, 1.0, window, [], None)
    got = harness.read_metrics(run, cell.per_layer)
    assert got["rows_per_block"] == {"value": 8.0, "unit": "rows"}
    assert "k2_roofline" not in got  # no trace: the reader finds nothing and is left out


def test_each_configuration_names_a_program_and_a_reference_that_exist(bench):
    for c in bench["configs"]:
        conf = spec.load_json(spec.ROOT / c["file"])
        assert spec.program_path(conf).is_file(), (c["name"], spec.program_path(conf))
        if "reference" in conf:
            assert (spec.REFERENCES / f"{conf['reference']}.py").is_file(), c["name"]
        assert "limits" in conf and conf["limits"], c["name"]
        assert all(v is not None for v in conf["limits"].values() if not isinstance(v, dict))


def test_each_listed_metric_reads_the_runs_of_one_program(bench):
    """A reader reads one program's run record: a metric that lists its
    cells lists the cells of one program."""
    program = {w["name"]: spec.program_name(spec.cell(w["name"], bench).config)
               for w in bench["workloads"]}
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            assert len({program[w] for w in m["workloads"]}) == 1, m["name"]
