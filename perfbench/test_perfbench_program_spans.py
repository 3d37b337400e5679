"""The reduction of the program's spans (``program_spans.reduce``): device
time by innermost span through the launches' correlation ids, the blocking
runtime calls, and the harness's trace left as it is without the spans."""
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from perfbench import program_spans, tracing
from perfbench.test_perfbench_yardstick import _Event as _PlainEvent

P = program_spans.PROGRAM_PREFIX


class _Event(_PlainEvent):
    """A stand-in raw event that carries the profiler's correlation ids."""

    def __init__(self, name, start, dur, cuda, corr=0, linked=0):
        super().__init__(name, start, dur, cuda)
        self._ids = (corr, linked)

    def correlation_id(self):
        return self._ids[0]

    def linked_correlation_id(self):
        return self._ids[1]

    def is_user_annotation(self):
        return self.name().startswith(("perfbench.", P))


def _events(program: bool = True):
    """One traced block: the harness's phases, two nested program spans
    (``conv0`` and its ``quantize``), operators and runtime calls under them,
    a device op launched from each span (one only through its operator's
    id), the shadows of the spans on the device, and the harness's copy."""
    ev = [
        _Event(tracing.TRACED, 0, 1000, False),
        _Event("perfbench.forward", 0, 400, False, corr=1),
        _Event("aten::mul", 35, 30, False, corr=7),
        _Event("cudaLaunchKernel", 40, 5, False, corr=101, linked=7),
        _Event("cudaStreamSynchronize", 60, 50, False, corr=102),
        _Event("cudaLaunchKernel", 150, 5, False, corr=103),
        _Event("aten::div", 300, 20, False, corr=8),
        _Event("perfbench.wait", 400, 600, False, corr=2),
        _Event("vectorized_elementwise_kernel<mul>", 100, 40, True, corr=101, linked=7),
        _Event("reduce_kernel<amax>", 140, 10, True, corr=0, linked=7),
        _Event("conv1d_mma_kernel<64, 64>", 220, 80, True, corr=103),
        _Event("Memcpy HtoD (Pinned -> Device)", 500, 100, True, corr=104),
    ]
    if program:
        ev += [
            _Event(P + "forward", 10, 380, False, corr=3),
            _Event(P + "conv0", 20, 280, False, corr=4),
            _Event(P + "conv0.quantize", 30, 90, False, corr=5),
            _Event(P + "conv0", 100, 200, True),  # shadows on the device
            _Event(P + "conv0.quantize", 100, 50, True),
        ]
    return ev


def test_device_time_follows_the_launch_to_its_innermost_span():
    _, prog = program_spans.reduce(_events(), blocks=2)
    assert prog.by_span() == pytest.approx({
        "conv0.quantize": 50 / 2 / 1e6,  # one by its runtime call, one by its operator
        "conv0": 80 / 2 / 1e6,
        "(the harness's copies)": 100 / 2 / 1e6,
    })
    assert prog.unattributed() == []
    assert [f.name for f in prog.forwards] == [P + "forward"]


def test_blocking_calls_their_wait_and_the_issue_time():
    _, prog = program_spans.reduce(_events(), blocks=2)
    assert [(s.name, s.dur_ns, s.span, s.forward) for s in prog.syncs] == [
        ("cudaStreamSynchronize", 50, P + "conv0.quantize", 0)]
    got = prog.metrics(["conv0"])
    assert got["host_sync_wait_ms_per_block"] == pytest.approx(50 / 2 / 1e6)
    assert got["host_issue_ms_per_block"] == pytest.approx((380 - 50) / 2 / 1e6)
    assert got["quantize_device_ms_per_block"] == pytest.approx(50 / 2 / 1e6)
    assert got["pool_device_ms_per_block"] == 0.0
    assert got["float_layers_device_ms_per_block"] == 0.0  # conv0's kernel launched nothing
    assert prog.metrics([])["float_layers_device_ms_per_block"] is None
    issue, wait = prog.per_forward()
    assert list(issue) == pytest.approx([330e-6]) and list(wait) == pytest.approx([50e-6])
    assert "0.50 blocking calls a block" in prog.tables()


def test_the_harness_trace_reads_as_without_the_program_spans():
    with_spans, _ = program_spans.reduce(_events(), blocks=2)
    without = tracing.reduce(_events(program=False), blocks=2)
    assert with_spans.gaps == without.gaps
    assert with_spans.datapath_seconds() == without.datapath_seconds()
    assert with_spans.busy_s == without.busy_s
    assert with_spans.device_ops == without.device_ops
    assert with_spans.breakdown() == without.breakdown()
    labels = [label for _, label in with_spans.gaps]
    assert not any(P in label for label in labels)
    assert labels == ["forward > aten::mul", "forward", "wait", "wait"]


def test_idle_gaps_are_labelled_by_the_innermost_program_span():
    _, prog = program_spans.reduce(_events(), blocks=2)
    idle = {}
    for secs, label in prog.gaps:
        idle[label] = idle.get(label, 0.0) + secs
    assert idle == pytest.approx({
        "conv0.quantize > aten::mul": 100e-9,  # [0, 100): at 50 the multiply is issued
        "conv0": 70e-9,  # [150, 220): conv0's launch has returned
        "outside the program": 600e-9,  # [300, 500) after the forward, [600, 1000)
    })


def test_no_program_spans_no_metrics_and_plain_events_reduce_unchanged():
    trace, prog = program_spans.reduce(_events(program=False), blocks=2)
    assert prog.metrics(["conv0"]) == dict.fromkeys(program_spans.METRICS)
    assert prog.syncs == [] and prog.forwards == []
    # the yardstick test's stand-ins carry no correlation ids
    plain = [_PlainEvent(tracing.TRACED, 0, 1000, False),
             _PlainEvent("perfbench.forward", 0, 300, False),
             _PlainEvent("aten::div", 10, 50, False), _PlainEvent("qmm_kernel", 800, 50, True)]
    trace, prog = program_spans.reduce(plain, blocks=2)
    assert trace.gaps == tracing.reduce(plain, blocks=2).gaps
    assert prog.unattributed() == ["qmm_kernel"]


def test_prefix_is_the_ports():
    from repro_torch.kernels import backend

    assert program_spans.PROGRAM_PREFIX == backend.SPAN_PREFIX
    assert program_spans.FORWARD in program_spans.__doc__


def test_a_profiled_forward_of_the_port_reduces_to_its_spans():
    from repro_torch.kernels import backend
    from repro_torch.models import cnn1d
    from repro_torch.serving.accelerator import accelerator_forward
    from repro_torch.serving.quantized_params import quantize_params

    cfg = cnn1d.CNNConfig(input_len=40, channels=(4, 8), hidden=8)
    qp = quantize_params(cnn1d.init_params(cfg, torch.Generator().manual_seed(1)), cfg,
                         mode="int8", device="cpu")
    x = torch.randn(2, cfg.input_len)
    with profile(activities=[ProfilerActivity.CPU]) as prof, backend.program_spans():
        with record_function(tracing.TRACED):
            for _ in range(3):
                accelerator_forward(qp, x, cfg, device="cpu")
    trace, prog = program_spans.reduce(prof.profiler.kineto_results.events(), blocks=3)
    assert len(prog.forwards) == 3 and prog.syncs == []
    assert all(P not in label for _, label in trace.gaps)
    got = prog.metrics([])
    assert got["host_sync_wait_ms_per_block"] == 0.0
    assert got["host_issue_ms_per_block"] == pytest.approx(
        sum(f.end_ns - f.start_ns for f in prog.forwards) / 3 / 1e6)
