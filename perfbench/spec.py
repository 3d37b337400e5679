"""What a cell is: ``BENCHMARK.json``'s entry, its configuration file and its
traffic file, all found by name.

A cell ``<config>.<traffic>`` names a configuration,
``perfbench/configs/<config>.json`` (the model's sizes, the precision it is
served in, the program that serves it, and the limits of the comparison
that decides ``correct``), and a traffic mix,
``perfbench/traffic/<traffic>.json`` (the parameters its program's
generator reads).  A configuration's ``"program"`` (``"detector"`` where it
names none) is ``perfbench/programs/<program>.py``, which validates its
traffic and runs the cell; its ``"reference"``, where it names one, is
``perfbench/references/<reference>.py``.  A metric is a reader,
``perfbench/metrics/<name>.py``.  Adding any of them adds a file; no module
here lists them.
"""
from __future__ import annotations

import dataclasses
import fnmatch
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
CONFIGS = HERE / "configs"
TRAFFIC = HERE / "traffic"
METRICS = HERE / "metrics"
PROGRAMS = HERE / "programs"
REFERENCES = HERE / "references"
BENCHMARK = ROOT / "BENCHMARK.json"

#: layer precisions whose layers run on the 8-bit kernels (K2 convs, K1 dense)
EIGHT_BIT = ("int8", "fxp8")
#: the program of a configuration that names none
DEFAULT_PROGRAM = "detector"


@dataclasses.dataclass(frozen=True)
class Cell:
    """One cell: its name, its configuration and its traffic (parsed files),
    and the metrics it reports (``BENCHMARK.json`` entries)."""

    name: str
    config: dict
    traffic: dict
    end_to_end: tuple[dict, ...]
    per_layer: tuple[dict, ...]
    chips: int = 1


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return load_json(BENCHMARK)


def config_names() -> list[str]:
    return sorted(p.stem for p in CONFIGS.glob("*.json"))


def traffic_names() -> list[str]:
    return sorted(p.stem for p in TRAFFIC.glob("*.json"))


def metric_names() -> list[str]:
    return sorted(p.stem for p in METRICS.glob("*.py") if not p.stem.startswith("_"))


def config(name: str) -> dict:
    return load_json(CONFIGS / f"{name}.json")


def traffic(name: str) -> dict:
    """The mix's parameters; its program validates them."""
    return load_json(TRAFFIC / f"{name}.json")


def program_name(conf: dict) -> str:
    return conf.get("program") or DEFAULT_PROGRAM


def program_path(conf: dict) -> Path:
    """The file of the configuration's program, which may not exist."""
    return PROGRAMS / f"{program_name(conf)}.py"


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def _trial_reports(metric: dict, program: str, bench: dict) -> bool:
    """A trial cell of ``program`` reports a metric that lists no cells, or
    one that lists a cell of a configuration served by the same program."""
    if "workloads" not in metric:
        return True
    configs = {c["name"]: c["file"] for c in bench["configs"]}
    cells = {w["name"]: w["config"] for w in bench["workloads"]}
    return any(program_name(load_json(ROOT / configs[cells[w]])) == program
               for w in metric["workloads"] if w in cells)


def cell(name: str, bench: dict | None = None) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json``.  A name that is not there but
    is ``<config>.<traffic>`` of two files is a trial cell: it reports every
    metric that does not list its workloads and every metric of its
    program's cells (:func:`_trial_reports`) whose reader finds something
    to read."""
    bench = benchmark() if bench is None else bench
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is not None:
        conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
        return Cell(
            name=name,
            config=load_json(ROOT / conf["file"]),
            traffic=traffic(entry["traffic"]),
            end_to_end=tuple(m for m in bench["end_to_end"] if _reports(m, name)),
            per_layer=tuple(m for m in bench["per_layer"] if _reports(m, name)),
            chips=int(entry["chips"]),
        )
    conf_name, _, mix_name = name.partition(".")
    if conf_name not in config_names() or mix_name not in traffic_names():
        raise KeyError(f"no cell {name!r} in BENCHMARK.json, and no files "
                       f"configs/{conf_name}.json and traffic/{mix_name}.json")
    conf = config(conf_name)
    program = program_name(conf)
    return Cell(
        name=name,
        config=conf,
        traffic=traffic(mix_name),
        end_to_end=tuple(m for m in bench["end_to_end"] if _trial_reports(m, program, bench)),
        per_layer=tuple(m for m in bench["per_layer"] if _trial_reports(m, program, bench)),
    )


def layer_names(conf: dict) -> list[str]:
    n_convs = len(conf["cnn"]["channels"])
    return [f"conv{i}" for i in range(n_convs)] + ["dense0", "dense1"]


def layer_modes(conf: dict) -> dict[str, str]:
    """Each layer's precision: the configuration's ``precision``, overridden
    by its ``policy`` rules (``"conv0/w=bf16,dense1/w=fp32"``: the longest
    glob matching ``<layer>/w`` wins)."""
    rules = {}
    for item in (conf.get("policy") or "").split(","):
        if item.strip():
            pat, _, mode = item.partition("=")
            rules[pat.strip()] = mode.strip()
    modes = {}
    for name in layer_names(conf):
        hits = [p for p in rules if fnmatch.fnmatch(f"{name}/w", p)]
        modes[name] = rules[max(hits, key=len)] if hits else conf["precision"]
    return modes
