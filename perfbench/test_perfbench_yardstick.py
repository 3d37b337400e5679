"""The yardstick's operation counts and bounds, the trace reduction, and the
readers built on them."""
import math
from types import SimpleNamespace

import pytest
import torch

from perfbench import harness, spec, tracing, yardstick

#: operations a window, counted by hand (conv: 2 L K Cin Cout; dense: 2 K N)
HAND = {
    "shield8_int8": {"conv0": 420_864, "conv1": 26_935_296, "conv2": 53_870_592,
                     "dense0": 4_489_216, "dense1": 256},
    "shield8_pruned_mixed": {"conv0": 420_864, "conv1": 26_935_296, "conv2": 13_467_648,
                             "dense0": 1_114_112, "dense1": 256},
}


@pytest.mark.parametrize("name,total", [("shield8_int8", 85_716_224),
                                        ("shield8_pruned_mixed", 41_938_176)])
def test_operations_a_window_match_the_hand_count(name, total):
    conf = spec.config(name)
    layers = yardstick.layers(conf, 1)
    assert {l.name: l.ops_per_row for l in layers} == HAND[name]
    assert sum(l.ops_per_row for l in layers) == total == sum(HAND[name].values())


def test_kernels_and_bounds_at_a_block_of_1024():
    int8 = {l.name: l for l in yardstick.layers(spec.config("shield8_int8"), 1024)}
    mixed = {l.name: l for l in yardstick.layers(spec.config("shield8_pruned_mixed"), 1024)}
    assert [int8[n].kernel for n in HAND["shield8_int8"]] == ["K2", "K2", "K2", "K1", "K1"]
    assert [mixed[n].kernel for n in HAND["shield8_pruned_mixed"]] == [
        "project_rows", "K2", "K2", "K1", "project_rows"]
    # K2's fp32 output dominates: 287 MB a conv at 1,024 rows, so the bytes bound it
    assert int8["conv0"].bound_s_per_call == pytest.approx(86.0e-6, rel=0.01)
    assert int8["conv1"].bound_s_per_call == pytest.approx(96.5e-6, rel=0.01)
    assert int8["conv2"].bound_s_per_call == pytest.approx(96.5e-6, rel=0.01)
    assert mixed["conv0"].bound_s_per_call == pytest.approx(90.0e-6, rel=0.01)
    for layer in int8.values():
        assert layer.ops_per_call == 1024 * layer.ops_per_row


def test_ideal_time_a_window_at_the_stated_peaks():
    ideal = {n: sum(l.ideal_s_per_row for l in yardstick.layers(spec.config(n), 1))
             for n in HAND}
    assert ideal["shield8_int8"] == pytest.approx(43.3e-9, rel=0.01)
    assert ideal["shield8_pruned_mixed"] == pytest.approx(21.4e-9, rel=0.01)


def test_cost_functions_count_each_byte_once():
    assert yardstick.qmm_cost(8, 35072, 64) == (8 * 35072 + 35072 * 64 + 4 * (8 + 128)
                                                 + 4 * 8 * 64, 2 * 8 * 35072 * 64)
    nbytes, ops = yardstick.conv_cost(2, 10, 4, 8, 3)
    assert nbytes == 2 * 10 * 4 + 3 * 4 * 8 + 4 * (2 + 16) + 4 * 2 * 10 * 8
    assert ops == 2 * 2 * 10 * 3 * 4 * 8
    assert yardstick.project_cost(5, 3, 7) == (4 * (15 + 21 + 35), 2 * 5 * 3 * 7)
    assert yardstick.bound_s(3.35e12, 0, 1) == pytest.approx(1.0)
    assert yardstick.bound_s(0, 1.979e15, yardstick.INT8_OPS_PER_S) == pytest.approx(1.0)


class _Event:
    """A stand-in of the profiler's raw event."""

    def __init__(self, name, start, dur, cuda):
        from torch.autograd import DeviceType

        self._v = (name, start, dur, DeviceType.CUDA if cuda else DeviceType.CPU)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def duration_ns(self):
        return self._v[2]

    def device_type(self):
        return self._v[3]

    def is_user_annotation(self):
        return self._v[0].startswith("perfbench.")


def _trace():
    ev = [
        _Event(tracing.TRACED, 0, 1000, False),
        _Event("perfbench.forward", 0, 300, False),
        _Event("aten::div", 10, 50, False),
        _Event("perfbench.wait", 300, 700, False),
        _Event("void conv1d_mma_kernel<64, 64, true>(ConvShape, imma::Epilogue)", 100, 200, True),
        _Event("void conv1d_small_cin_kernel<true>(...)", 250, 100, True),  # overlaps: union
        _Event("Memcpy HtoD (Pinned -> Device)", 600, 100, True),
        _Event("qmm_kernel", 800, 50, True),
        _Event("perfbench.forward", 0, 300, True),  # the span's shadow on the device
    ]
    return tracing.reduce(ev, blocks=2)


def test_trace_reduction_union_gaps_and_labels():
    tr = _trace()
    assert tr.window_s == pytest.approx(1e-6)
    assert tr.busy_s == pytest.approx(400e-9)  # [100, 350] + [600, 700] + [800, 850]
    assert sum(secs for secs, _ in tr.gaps) == pytest.approx(600e-9)
    assert tr.gaps[0] == (pytest.approx(100e-9), "forward > aten::div")  # [0, 100)
    assert [label for _, label in tr.gaps[1:]] == ["wait"] * 3
    assert tr.kernel_seconds("conv1d_mma_kernel", "conv1d_small_cin_kernel") == (
        pytest.approx(300e-9), 2)
    assert tr.datapath_seconds() == pytest.approx(350e-9)  # the staging copy left out
    bd = tr.breakdown()
    assert bd["device_ops"][0][0].startswith("void conv1d_mma_kernel")
    assert len(bd["idle_gaps"]) <= 10 and len(bd["device_ops"]) <= 10


def test_roofline_readers_share_and_silence():
    tr = _trace()
    conf = spec.config("shield8_int8")
    layers = yardstick.layers(conf, 1024)
    run = SimpleNamespace(trace=tr, layers=layers, window=SimpleNamespace(rows=1024, seconds=1.0))
    k2 = harness.load_reader("k2_roofline")(run)
    bound = sum(l.bound_s_per_call for l in layers if l.kernel == "K2") * tr.blocks
    assert k2 == pytest.approx(100 * bound / 300e-9)
    assert harness.load_reader("project_rows_roofline")(run) is None  # no such layer
    run.trace = None
    assert all(harness.load_reader(n)(run) is None for n in (
        "k1_roofline", "k2_roofline", "device_idle_share", "datapath_device_ms_per_block"))
    mfu = harness.load_reader("mfu")(run)
    assert mfu == pytest.approx(100 * 1024 * 43.3e-9, rel=0.01)
    assert not math.isnan(mfu)


def test_closed_loop_keeps_order_and_counts_on_the_host():
    ring = torch.arange(3 * 4 * 2, dtype=torch.float32).reshape(3, 4, 2)
    loop = harness.Loop(lambda rows: rows * 2, ring, torch.device("cpu"), inflight=2,
                        n_classes=2)
    w = loop.run(blocks=7)
    assert w.blocks == 7 and w.rows == 28 and len(w.results) == 7
    for j, got in enumerate(w.results):
        assert torch.equal(torch.from_numpy(got), ring[j % 3] * 2)
    assert len(w.latencies_s) == 7 and all(t >= 0 for t in w.latencies_s)
    assert len(loop.run(seconds=0.05).results) >= 1
