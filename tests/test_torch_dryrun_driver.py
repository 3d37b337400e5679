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


def test_quantized_cell_holds_int8_weights():
    """``quantize=True`` traces the step on ``abstract_quantized`` weights:
    the same FLOPs (weight-only int8 dequantises into the same einsums),
    fewer argument bytes; a train cell refuses it."""
    from repro_torch.distributed.sharding import HostMesh, ShardingRules
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.specs import ShapeSpec

    cfg = smoke("gemma-2b").replace(param_dtype="bfloat16", act_dtype="bfloat16")
    rules = ShardingRules(HostMesh(("data", "model")))
    shape = ShapeSpec("t", SEQ, 4, "decode")
    plain = D.trace_cell(cfg, shape, rules, 1, device="cpu")
    q = D.trace_cell(cfg, shape, rules, 1, quantize=True, device="cpu")
    assert q["flops_per_device"] == plain["flops_per_device"]
    assert q["memory"]["argument_bytes"] < plain["memory"]["argument_bytes"]
    with pytest.raises(ValueError, match="gradient"):
        D.trace_cell(cfg, ShapeSpec("t", SEQ, 4, "train"), rules, 1, quantize=True,
                     device="cpu")


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
    assert rec["rows_per_device"] == 128 // 16 and rec["collectives"]["total_bytes"] == 0
    assert not rec["memory"]["fits_80gb"] or rec["memory"]["peak_bytes"] <= 80e9
    skip = json.loads((tmp_path / "gemma-2b__long_500k__pod_16x16.json").read_text())
    assert skip["status"] == "skip" and "sub-quadratic" in skip["reason"]
    from repro_torch.launch import roofline

    (cell,) = roofline.load_cells(tmp_path)
    assert cell["dominant"] == "memory" and cell["t_collective_s"] == 0
    assert cell["model_flops"] == 2.0 * rec["n_params"] * 128
    assert cell["t_compute_s"] == pytest.approx(rec["flops_per_device"] / 989e12)
    table = roofline.markdown_table(tmp_path).splitlines()
    assert table[2].startswith("| gemma-2b | decode_32k | 7.") and table[2].endswith("memory |")
    assert table[-1] == ("- skip x long_500k: gemma-2b (pod_16x16): pure full-attention "
                         "arch: long_500k needs sub-quadratic attention")
