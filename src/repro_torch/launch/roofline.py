"""Roofline terms of the dry run's cells on the H100.

Counterpart of ``benchmarks/roofline.py``'s per-cell terms, over the
records of ``launch/dryrun.py`` and the constants of ``launch/hw.py``:

* compute: FLOPs a device at the bf16 tensor-core peak (989 TFLOP/s);
* memory: bytes a device at the HBM3 rate (3.35 TB/s); the dry run's bytes
  are the eager program's upper bound (every op's operands and results),
  so this term is too;
* collective: collective bytes a device over NVLink 4 (450 GB/s a
  direction), all-reduce counted twice (a ring), one card's links taken
  together, as the reference takes one ICI link.

``model_flops`` is 6·N·D for train and 2·N·D for prefill (N the params,
active params for MoE; D the tokens), 2·N a token for decode.

The time scans' FLOPs.  The reference adds an analytic term for the
SSM/RWKV scans, which XLA's ``cost_analysis`` cannot see inside a while
loop: 4·B·H·N² a step and layer for rwkv6 (decay, ``k^T v``, ``r S``, the
bonus) and 6·B·H·N·P for mamba2 (decay, ``dt B x``, ``C^T S``), three
times that for a train step.  The port's scans are Python loops that
``FlopCounterMode`` follows, but it counts only their contractions
(rwkv6's ``r S``, mamba2's ``C^T S``: 2·B·H·N² and 2·B·H·N·P a step); the
outer products ``k^T v`` and ``B x`` are broadcast multiplies, elementwise
like the decay.  So the correction is ported as what the counter misses,
the reference's term less the counted part (2·B·H·N² and 4·B·H·N·P a
step), per device: B the rows a device holds and H the heads it holds (a
scan's heads over their cut under the record's mesh and rules: rwkv6's
from ``wr``'s spec where its time mix is cut on whole heads, mamba2's from
``a_log``'s; the reference divides its global term by every chip), and
applied to every mamba2 block, zamba2's shared-attention slot's too (the
reference's loop skips ``mamba2_shared``).  Decode steps get none, as in
the reference.

    PYTHONPATH=src python -m repro_torch.launch.roofline [--out DIR] [--mesh pod_16x16]
    PYTHONPATH=src python -m repro_torch.launch.roofline --markdown   # the PERF.md table
"""
from __future__ import annotations

import argparse
import json
import math
from pathlib import Path

from repro_torch.configs import get_config
from repro_torch.distributed.sharding import LONG_CONTEXT_OVERRIDES, ShardingRules, use_rules
from repro_torch.launch.hw import BF16_FLOPS_PER_S, HBM_BYTES_PER_S, NVLINK_BYTES_PER_S
from repro_torch.launch.specs import SHAPES
from repro_torch.models import mamba2 as M2
from repro_torch.models import rwkv6 as R6

#: the production meshes' axes (``launch/mesh.make_production_mesh``)
MESHES = {"pod_16x16": {"data": 16, "model": 16},
          "multipod_2x16x16": {"pod": 2, "data": 16, "model": 16}}
CHIPS = {name: math.prod(axes.values()) for name, axes in MESHES.items()}

ARTIFACTS = Path(__file__).resolve().parents[3] / "artifacts" / "dryrun_torch"


def model_flops(rec: dict, shape_name: str) -> float:
    shape = SHAPES[shape_name]
    n = rec.get("n_params_active") or rec.get("n_params")
    if shape.kind == "train":
        return 6.0 * n * shape.seq_len * shape.global_batch
    if shape.kind == "prefill":
        return 2.0 * n * shape.seq_len * shape.global_batch
    return 2.0 * n * shape.global_batch  # decode: one token per sequence


def mesh_rules(mesh: str | None, shape_name: str) -> ShardingRules | None:
    """The rules a dry-run cell of ``mesh`` (a name of :data:`MESHES`) and
    ``shape_name`` runs under (the long-context rules for long_500k), over
    a mesh of that shape without process groups; ``None`` for no mesh."""
    if mesh is None:
        return None

    class Mesh:
        shape = dict(MESHES[mesh])
        axis_names = tuple(shape)

    return ShardingRules(Mesh(), LONG_CONTEXT_OVERRIDES if shape_name == "long_500k" else None)


def recurrence_flops_correction(arch: str, shape_name: str, rows: int,
                                mesh: str | None = None) -> float:
    """The time scans' FLOPs a device that ``FlopCounterMode`` does not
    count (module docstring), for ``rows`` sequences a device and the heads
    a device holds on ``mesh`` (a name of :data:`MESHES`; ``None``: every
    head)."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    if shape.kind == "decode":
        return 0.0
    with use_rules(mesh_rules(mesh, shape_name)):
        tm, ssm = R6.rwkv6_cuts(cfg)["tm"], M2.head_cut(cfg)
    per_step = 0.0
    for kind in cfg.pattern:
        if kind == "rwkv6":
            n = cfg.rwkv_head_dim
            heads = cfg.d_model // n // (tm.size if tm else 1)
            per_step += 2.0 * rows * heads * n * n
        elif kind in ("mamba2", "mamba2_shared"):
            heads = cfg.ssm_expand * cfg.d_model // cfg.ssm_head_dim // (ssm.size if ssm else 1)
            per_step += 4.0 * rows * heads * cfg.ssm_state * cfg.ssm_head_dim
    total = per_step * shape.seq_len * cfg.n_groups
    return 3.0 * total if shape.kind == "train" else total


def terms(flops: float, n_bytes: float, coll_bytes: float) -> dict:
    """The three roofline terms (seconds), the dominant one and the bound."""
    t = {"compute": flops / BF16_FLOPS_PER_S, "memory": n_bytes / HBM_BYTES_PER_S,
         "collective": coll_bytes / NVLINK_BYTES_PER_S}
    dominant = max(t, key=t.get)
    return {"t_compute_s": t["compute"], "t_memory_s": t["memory"],
            "t_collective_s": t["collective"], "dominant": dominant, "bound_s": t[dominant]}


def cell_roofline(rec: dict) -> dict | None:
    """One ``ok`` record's terms; ``None`` for a skipped or failed cell."""
    if rec.get("status") != "ok":
        return None
    chips = CHIPS.get(rec["mesh"], 1)
    corr = recurrence_flops_correction(rec["arch"], rec["shape"], rec["rows_per_device"],
                                       rec["mesh"] if rec["mesh"] in MESHES else None)
    flops = rec["flops_per_device"] + corr
    out = {"arch": rec["arch"], "shape": rec["shape"], "mesh": rec["mesh"],
           **terms(flops, rec["bytes_per_device"], rec["collectives"]["total_bytes"]),
           "recurrence_corr": corr}
    mf = model_flops(rec, rec["shape"])
    peak = rec["memory"]["peak_bytes"]
    out.update(model_flops=mf, flops_global=flops * chips,
               useful_ratio=mf / (flops * chips) if flops else 0.0,
               roofline_fraction=(mf / BF16_FLOPS_PER_S / chips) / out["bound_s"]
               if out["bound_s"] else 0.0,
               peak_gib=peak / 2 ** 30, fits_80gb=rec["memory"]["fits_80gb"],
               tag=rec.get("tag", ""))
    return out


def load_cells(out_dir: Path = ARTIFACTS, tag: str = "", mesh: str | None = "pod_16x16"
               ) -> list[dict]:
    """Roofline cells of the records under ``out_dir`` (one mesh, or every
    mesh with ``mesh=None``)."""
    cells = []
    for p in sorted(Path(out_dir).glob("*.json")):
        rec = json.loads(p.read_text())
        if rec.get("tag", "") != tag or (mesh and rec.get("mesh") != mesh):
            continue
        cell = cell_roofline(rec)
        if cell:
            cells.append(cell)
    return cells


def markdown_table(out_dir: Path = ARTIFACTS, tag: str = "") -> str:
    """The dry-run matrix as a markdown table: a row an (arch, shape) that
    ran, each cell ``pod_16x16 / multipod_2x16x16``; skipped and failed
    cells listed under it."""
    recs: dict[tuple, dict] = {}
    for p in sorted(Path(out_dir).glob("*.json")):
        rec = json.loads(p.read_text())
        if rec.get("tag", "") == tag:
            recs[(rec["arch"], rec["shape"], rec["mesh"])] = rec
    rows = ["| arch | shape | FLOPs / device | bytes / device | collective bytes | "
            "argument GiB | peak GiB | fits 80 GB | dominant |", "|" + " --- |" * 9]
    notes: dict[tuple, list] = {}
    for arch, shape in sorted({(a, s) for a, s, _ in recs}, key=lambda k: (
            k[0], list(SHAPES).index(k[1]))):
        pair = [r for r in (recs.get((arch, shape, m)) for m in CHIPS) if r]
        ok = [r for r in pair if r["status"] == "ok"]
        for r in pair:
            if r["status"] != "ok":
                key = (r["status"], shape, r.get("reason") or r.get("error"))
                notes.setdefault(key, {}).setdefault(arch, []).append(r["mesh"])
        if len(ok) != len(pair):
            continue
        a, b = ok[0], ok[1] if len(ok) > 1 else None

        def col(get, fmt):
            return fmt(get(a)) if b is None else f"{fmt(get(a))} / {fmt(get(b))}"

        sci = "{:.3e}".format
        gib = lambda v: f"{v / 2 ** 30:.2f}"  # noqa: E731
        dom = sorted({cell_roofline(r)["dominant"] for r in ok})
        est = " (est.)" if "extrapolated" in a else ""
        rows.append(" | ".join([
            f"| {arch}", shape, col(lambda r: r["flops_per_device"], sci),
            col(lambda r: r["bytes_per_device"], sci),
            col(lambda r: r["collectives"]["total_bytes"], sci),
            col(lambda r: r["memory"]["argument_bytes"], gib),
            col(lambda r: r["memory"]["peak_bytes"], gib) + est,
            col(lambda r: r["memory"]["fits_80gb"], str), " / ".join(dom)]) + " |")
    def cells(archs):
        return ", ".join(a if len(m) == len(CHIPS) else f"{a} ({', '.join(m)})"
                         for a, m in archs.items())

    return "\n".join(rows + [""] + [f"- {status} x {shape}: {cells(archs)}: {why}"
                                      for (status, shape, why), archs in notes.items()])


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="Roofline terms of the dry run's cells (H100).")
    ap.add_argument("--out", default=str(ARTIFACTS))
    ap.add_argument("--mesh", default="pod_16x16", help="a mesh name, or 'all'")
    ap.add_argument("--tag", default="")
    ap.add_argument("--markdown", action="store_true",
                    help="print the matrix as a markdown table (both meshes)")
    args = ap.parse_args(argv)
    if args.markdown:
        print(markdown_table(Path(args.out), args.tag))
        return
    cells = load_cells(Path(args.out), args.tag, None if args.mesh == "all" else args.mesh)
    for c in cells:
        print(f"roofline/{c['arch']}/{c['shape']}/{c['mesh']} "
              f"compute={c['t_compute_s'] * 1e3:.3f}ms memory={c['t_memory_s'] * 1e3:.3f}ms "
              f"collective={c['t_collective_s'] * 1e3:.3f}ms dominant={c['dominant']} "
              f"useful={c['useful_ratio'] * 100:.1f}% "
              f"roofline_frac={c['roofline_fraction'] * 100:.1f}% peak={c['peak_gib']:.2f}GiB "
              f"fits_80gb={c['fits_80gb']}")
    if not cells:
        print("roofline: no dry-run records found; run repro_torch.launch.dryrun first")


if __name__ == "__main__":
    main()
