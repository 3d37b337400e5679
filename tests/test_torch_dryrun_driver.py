"""The dry run's extrapolated cells, its step meter, the driver and the
roofline, on the CPU (``launch/dryrun.py``, ``launch/roofline.py``).

* A time-scan cell's Lagrange extrapolation over depth, microbatches and
  length equals a full trace where both can run (smoke configs, a few
  positions): FLOPs, collectives and bytes exactly, the peak (an
  estimate) within 5 %.
* ``FlopCounterMode`` counts the scans' contractions and the roofline's
  correction adds the rest of the reference's analytic term.
* The meter's peak over a fake trace equals its peak over the same step on
  real CPU tensors; a kernel wrapper refuses a fake tensor.
* ``python -m repro_torch.launch.dryrun`` on the CPU writes records (one on
  the 256-rank production mesh, one skipped) that the roofline reads.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
N_MICRO = 2
SEQ = 64


def smoke(arch, **extra):
    from repro_torch.configs import get_config

    return get_config(arch).smoke().replace(n_kv_heads=4, param_dtype="float32",
                                            act_dtype="float32", **extra)


@pytest.mark.parametrize("arch,kind", [("rwkv6-7b", "train"), ("zamba2-7b", "prefill"),
                                       ("rwkv6-7b", "prefill")])
def test_scan_extrapolation_equals_a_full_trace(monkeypatch, arch, kind):
    """Two groups, two microbatches and 16 positions traced whole, against
    the Lagrange extrapolation from one and two groups and microbatches
    and 4, 8 and 12 positions (4 and 8: a prefill that does not attend):
    FLOPs, collective counts and bytes exactly (within 1e-9: float sums),
    and the peak within 5 %."""
    from repro_torch.distributed.sharding import HostMesh, ShardingRules
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.specs import ShapeSpec

    monkeypatch.setattr(D, "SCAN_SEQ", 4)
    cfg = smoke(arch)
    shape = ShapeSpec("t", 16, 4, kind)
    rules = ShardingRules(HostMesh(("data", "model")))
    axes = D.extrapolation_axes(cfg, shape, N_MICRO)
    assert [a for a, _, _ in axes] == (["groups", "n_micro", "seq_len"] if kind == "train"
                                       else ["groups", "seq_len"])
    assert axes[-1][1] == ((4, 8) if (arch, kind) == ("rwkv6-7b", "prefill") else (4, 8, 12))
    got = D._extrapolated(cfg, shape, rules, N_MICRO, axes, quantize=False, device="cpu")
    want = D.trace_cell(cfg, shape, rules, N_MICRO, device="cpu")
    assert got["flops_per_device"] == want["flops_per_device"]
    assert got["bytes_per_device"] == pytest.approx(want["bytes_per_device"], rel=1e-9)
    assert got["collectives"]["counts"] == want["collectives"]["counts"]
    assert got["memory"]["argument_bytes"] == want["memory"]["argument_bytes"]
    # the peak, a maximum over the step's phases, is an estimate (measured:
    # +0.0 %, -0.8 % and -2.3 % of the full traces' in these three cells)
    assert got["memory"]["peak_bytes"] == pytest.approx(want["memory"]["peak_bytes"], rel=0.05)


def test_scan_flops_counted_and_the_correction_for_the_rest():
    """``FlopCounterMode`` counts the scans' contractions (rwkv6's ``r S``,
    mamba2's ``C^T S``) and not their outer products and decay; the
    roofline's correction adds the rest, so that both together are the
    reference's analytic term (4·B·H·N² and 6·B·H·N·P a step and layer)."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.configs import get_config
    from repro_torch.launch import roofline
    from repro_torch.launch.specs import SHAPES
    from repro_torch.models import mamba2 as M2
    from repro_torch.models import rwkv6 as R6

    b, t, h, n, p = 2, 5, 3, 4, 6
    r, k, v, w = (torch.rand(b, t, h, n) for _ in range(4))
    with FlopCounterMode(display=False) as fc:
        R6._wkv_scan(r, k, v, w, torch.rand(h, n), torch.zeros(b, h, n, n))
    assert fc.get_total_flops() == t * 2 * b * h * n * n
    cfg = get_config("zamba2-7b").smoke()
    x = torch.rand(b, t, h, p)
    bc = [torch.rand(b, t, n) for _ in range(2)]
    with FlopCounterMode(display=False) as fc:
        M2._ssm_scan((x, *bc, torch.rand(b, t, h), torch.rand(b, t, h), torch.rand(h)), cfg,
                     torch.zeros(b, h, n, p))
    assert fc.get_total_flops() == t * 2 * b * h * n * p

    shape = SHAPES["prefill_32k"]
    rw = get_config("rwkv6-7b")
    hh, nn = rw.d_model // rw.rwkv_head_dim, rw.rwkv_head_dim
    counted = 2.0 * 2 * hh * nn * nn * shape.seq_len * rw.n_groups
    assert roofline.recurrence_flops_correction("rwkv6-7b", "prefill_32k", 2) + counted == (
        4.0 * 2 * hh * nn * nn * shape.seq_len * rw.n_groups)
    assert roofline.recurrence_flops_correction("rwkv6-7b", "train_4k", 2) == 3 * (
        2.0 * 2 * hh * nn * nn * 4096 * rw.n_groups)
    assert roofline.recurrence_flops_correction("rwkv6-7b", "decode_32k", 8) == 0.0
    assert roofline.recurrence_flops_correction("gemma-2b", "train_4k", 16) == 0.0


@pytest.mark.parametrize("mesh", ["pod_16x16", "multipod_2x16x16"])
@pytest.mark.parametrize("arch,shape", [("rwkv6-7b", "train_4k"), ("rwkv6-7b", "prefill_32k"),
                                        ("zamba2-7b", "train_4k"), ("zamba2-7b", "prefill_32k")])
def test_scan_correction_counts_this_devices_heads(arch, shape, mesh):
    """On a production mesh a device holds a 16th of rwkv6's time-mix heads
    (64 over "model" = 16) and of zamba2's ssm heads (112), so its
    correction is the no-cut value over 16, as the reference's global term
    over every chip is for the same rows (its ``/ chips``, 256 or 512 chips
    of 1/16 or 1/32 of the rows); ``cell_roofline`` reads the record's
    mesh."""
    from repro_torch.launch import roofline

    whole = roofline.recurrence_flops_correction(arch, shape, 16)
    assert whole > 0
    assert roofline.recurrence_flops_correction(arch, shape, 16, mesh) == whole / 16
    rec = {"status": "ok", "arch": arch, "shape": shape, "mesh": mesh, "rows_per_device": 16,
           "n_params": 1,
           "flops_per_device": 1.0, "bytes_per_device": 1.0,
           "collectives": {"total_bytes": 0.0}, "memory": {"peak_bytes": 1, "fits_80gb": True}}
    assert roofline.cell_roofline(rec)["recurrence_corr"] == whole / 16


def test_fake_peak_equals_a_real_run():
    """The meter's peak over a fake trace equals its peak over the same step
    on real CPU tensors: the fake path holds the same storages."""
    from repro_torch.distributed.sharding import HostMesh, ShardingRules, use_rules
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.specs import ShapeSpec
    from repro_torch.models import transformer as T

    cfg = smoke("gemma-2b").replace(remat=True)
    shape = ShapeSpec("t", SEQ, 4, "train")
    rules = ShardingRules(HostMesh(("data", "model")))
    fake = D.trace_cell(cfg, shape, rules, N_MICRO, device="cpu")
    fn, args = D.build_cell(cfg, shape, rules, N_MICRO, device="cpu")
    params = T.init_params(0, cfg, device="cpu")
    tokens, labels = (torch.randint(0, cfg.vocab, (4, SEQ), dtype=torch.int32)
                      for _ in range(2))
    args = (params, args[1], {"tokens": tokens, "labels": labels})
    meter = D.StepMeter()
    argument = meter.track(args)
    with use_rules(rules), meter:
        fn(*args)
    assert argument == fake["memory"]["argument_bytes"]
    assert meter.peak == fake["memory"]["peak_bytes"]
    assert meter.bytes == fake["bytes_per_device"]


#: the quantised decode cell on a fake ("data", "model") = (1, 2) mesh,
#: in a subprocess (a process has one default process group)
CUT_QUANTIZED = """\
import json, torch
from torch.distributed.device_mesh import init_device_mesh
from repro_torch.configs import get_config
from repro_torch.distributed.sharding import ShardingRules
from repro_torch.launch import dryrun as D
from repro_torch.launch.specs import ShapeSpec

D.fake_world(2)
rules = ShardingRules(init_device_mesh("cpu", (1, 2), mesh_dim_names=("data", "model")))
cfg = get_config("gemma-2b").smoke().replace(n_kv_heads=4, param_dtype="bfloat16",
                                             act_dtype="bfloat16")
shape = ShapeSpec("t", {seq}, 4, "decode")
out = {{k: D.trace_cell(cfg, shape, rules, 1, quantize=k == "q", device="cpu")
       for k in ("plain", "q")}}
print("RESULT:" + json.dumps(out))
""".format(seq=SEQ)


def test_quantized_cell_holds_int8_weights():
    """``quantize=True`` traces the step on the served int8 weights: the
    same FLOPs (weight-only int8 dequantises into the same einsums), fewer
    argument bytes; a train cell refuses it.  Under a cut model axis (2
    ranks) the weights are placed as ``sharding.shard`` places them, so a
    rank's arguments are, reckoned from the specs: each int8 payload's part
    (its weight's spec), each fp32 scale whole, the other leaves' parts,
    the rank's tokens and caches (kv heads cut), each storage in 512-byte
    blocks."""
    from repro_torch.distributed import sharding as SH
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.specs import ShapeSpec
    from repro_torch.models import transformer as T
    from repro_torch.models.quantized import default_lm_policy, quantize_lm_params

    cfg = smoke("gemma-2b").replace(param_dtype="bfloat16", act_dtype="bfloat16")
    rules = SH.ShardingRules(SH.HostMesh(("data", "model")))
    shape = ShapeSpec("t", SEQ, 4, "decode")
    plain = D.trace_cell(cfg, shape, rules, 1, device="cpu")
    q = D.trace_cell(cfg, shape, rules, 1, quantize=True, device="cpu")
    assert q["flops_per_device"] == plain["flops_per_device"]
    assert q["memory"]["argument_bytes"] < plain["memory"]["argument_bytes"]
    with pytest.raises(ValueError, match="gradient"):
        D.trace_cell(cfg, ShapeSpec("t", SEQ, 4, "train"), rules, 1, quantize=True,
                     device="cpu")

    proc = subprocess.run([sys.executable, "-c", CUT_QUANTIZED], capture_output=True,
                          text=True, timeout=300, cwd=ROOT,
                          env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = [ln for ln in proc.stdout.splitlines() if ln.startswith("RESULT:")][-1]
    cut = json.loads(line[len("RESULT:"):])

    class Two:
        axis_names, shape = ("data", "model"), {"data": 1, "model": 2}

    two = SH.ShardingRules(Two())
    block = lambda nb: -(-nb // 512) * 512  # noqa: E731
    whole = quantize_lm_params(T.init_params(0, cfg, device="cpu"), default_lm_policy(cfg))
    specs = SH.tree_shardings(two, T.abstract_params(cfg), T.logical_axes(cfg))
    pairs = []
    SH.map_specs(lambda t, spec: pairs.append((t, spec)), whole, specs)

    def part(t, spec):
        return t.numel() // two.size(tuple(a for e in spec for a in SH._entry_axes(e))) * \
            t.element_size()

    want, n_q = 0, 0
    for t, spec in pairs:
        if isinstance(t, SH.QTensor):
            n_q += 1
            want += block(part(t.q, spec)) + block(t.scale.numel() * 4)
        else:
            want += block(part(t, spec))
    rows, kv = 4, cfg.n_kv_heads // 2  # data = 1: every row; 4 kv heads cut over 2
    cache = cfg.n_groups * rows * SEQ * kv * cfg.head_dim * 2
    want += block(rows * 4) + 2 * len(cfg.pattern) * block(cache)
    assert n_q > 0 and cut["q"]["memory"]["argument_bytes"] == want
    assert cut["q"]["flops_per_device"] == cut["plain"]["flops_per_device"]
    assert cut["q"]["memory"]["argument_bytes"] < cut["plain"]["memory"]["argument_bytes"]


def test_kernel_wrapper_refuses_a_fake_tensor():
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.kernels import cordic_act

    with FakeTensorMode():
        x = torch.zeros(4, 8)
        with pytest.raises(RuntimeError, match="fake"):
            cordic_act.cordic_softmax(x)


def test_driver_writes_records_the_roofline_reads(tmp_path):
    """``python -m repro_torch.launch.dryrun`` on the CPU: gemma-2b's
    decode_32k cell on the 256-rank production mesh in-process, and a
    skipped cell; the roofline reads the record."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    for shape in ("decode_32k", "long_500k"):
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "gemma-2b",
             "--shape", shape, "--mesh", "single", "--device", "cpu", "--out", str(tmp_path)],
            capture_output=True, text=True, timeout=300, cwd=ROOT, env=env)
        assert proc.returncode == 0, proc.stderr[-3000:]
    rec = json.loads((tmp_path / "gemma-2b__decode_32k__pod_16x16.json").read_text())
    assert rec["status"] == "ok" and rec["device"] == "cpu"
    # the model axis of 16 cuts gemma-2b's MLP (16,384) and vocab (256,000),
    # not its 8 heads: the 18 MLPs' all-reduces and the embedding's, of bf16
    # rows (twice their bytes), and the logits' all-gather; its one kv head
    # puts the caches' sequence on "model", so each of the 18 attention
    # layers combines its ring-decode statistics: the fp32 max of every
    # row's 8 heads, and their sums and 256-wide accumulators
    rows = 128 // 16
    ring = 2 * 18 * (rows * 8 * 4 + rows * 8 * (256 + 1) * 4)
    coll = 2 * 19 * rows * 2048 * 2 + rows * 256_000 * 4 + ring
    assert rec["rows_per_device"] == rows and rec["collectives"]["total_bytes"] == coll
    assert not rec["memory"]["fits_80gb"] or rec["memory"]["peak_bytes"] <= 80e9
    skip = json.loads((tmp_path / "gemma-2b__long_500k__pod_16x16.json").read_text())
    assert skip["status"] == "skip" and "sub-quadratic" in skip["reason"]
    from repro_torch.launch import roofline

    (cell,) = roofline.load_cells(tmp_path)
    assert cell["dominant"] == "memory" and cell["t_collective_s"] == pytest.approx(
        coll / roofline.NVLINK_BYTES_PER_S)
    assert cell["model_flops"] == 2.0 * rec["n_params"] * 128
    assert cell["t_compute_s"] == pytest.approx(rec["flops_per_device"] / 989e12)
    table = roofline.markdown_table(tmp_path).splitlines()
    # a rank's decode FLOPs: attention's heads whole (q, k, v, o; scores and
    # values over the rank's 2,048 of the cache's 32,768 slots), the MLP and
    # the unembedding a 16th
    r, d, hd, ctx = rows, 2048, 8 * 256, 32_768 // 16
    layer = 2 * r * d * (hd + 2 * 256) + 2 * r * hd * d + 2 * 2 * r * hd * ctx \
        + 3 * 2 * r * d * 16_384 // 16
    assert rec["flops_per_device"] == 18 * layer + 2 * r * d * 256_000 // 16
    assert table[2].startswith("| gemma-2b | decode_32k | 7.470e+09") and table[2].endswith(
        "memory |")
    assert table[-1] == ("- skip x long_500k: gemma-2b (pod_16x16): pure full-attention "
                         "arch: long_500k needs sub-quadratic attention")


_ROUTE_SCRIPT = """
import json
from torch.distributed.device_mesh import init_device_mesh
from repro_torch.configs import get_config
from repro_torch.distributed.sharding import ShardingRules
from repro_torch.launch import dryrun as D
from repro_torch.launch.specs import ShapeSpec
from repro_torch.models import mamba2 as M2

D.SCAN_SEQ = 4
D.fake_world(4)
rules = ShardingRules(init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model")))
cfg = get_config("zamba2-7b").smoke().replace(n_kv_heads=4)
shape = ShapeSpec("t", 16, 16, "prefill")
axes = D.extrapolation_axes(cfg, shape, 1)
got = D._extrapolated(cfg, shape, rules, 1, axes, quantize=False, device="cpu")
want = D.trace_cell(cfg, shape, rules, 1, device="cpu")
seq = [s for a, s, _ in axes if a == "seq_len"][0]
routes = [M2.in_route(cfg, 8 * n, M2.torch.empty(0)) for n in (*seq, 16)]
print("RESULT:" + json.dumps({"got": got, "want": want, "routes": routes}))
"""


def test_scan_extrapolation_keeps_the_cells_mamba2_route():
    """zamba2's smoke prefill of 16 rows x 16 positions on a fake (2, 2)
    mesh: a rank's 8 x 16 = 128 tokens take mamba2's weight route, and its
    samples' 8 x 4 = 32 would take the activation route (8 x 8 and 8 x 12
    the weight route); traced as the cell's program (``route_tokens``), the
    extrapolation's FLOPs and collectives equal the full trace's."""
    proc = subprocess.run([sys.executable, "-c", _ROUTE_SCRIPT], capture_output=True, text=True,
                          timeout=300, cwd=ROOT, env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = [ln for ln in proc.stdout.splitlines() if ln.startswith("RESULT:")][-1]
    r = json.loads(line[len("RESULT:"):])
    assert r["routes"] == ["activation", "weight", "weight", "weight"]
    got, want = r["got"], r["want"]
    assert got["flops_per_device"] == pytest.approx(want["flops_per_device"], rel=1e-9)
    assert got["collectives"]["counts"] == want["collectives"]["counts"]
    assert got["collectives"]["per_op_bytes"] == pytest.approx(
        want["collectives"]["per_op_bytes"], rel=1e-9)
