"""``tracing.reduce`` on synthetic profiler events: the program's
``repro_torch.`` spans kept by name apart from the device's work, and a
detector segment's reading the same with them as without."""
import dataclasses

import pytest
from torch.autograd import DeviceType

from perfbench import tracing


@dataclasses.dataclass
class Event:
    """The fields of a ``_KinetoEvent`` that ``reduce`` reads."""

    label: str
    start: int
    dur: int
    cuda: bool = False
    annotation: bool | None = None  # None: a profiler that does not flag annotations

    def name(self):
        return self.label

    def start_ns(self):
        return self.start

    def duration_ns(self):
        return self.dur

    def device_type(self):
        return DeviceType.CUDA if self.cuda else DeviceType.CPU

    def __getattr__(self, attr):
        if attr == "is_user_annotation" and self.annotation is not None:
            return lambda: self.annotation
        raise AttributeError(attr)


#: one detector block as the harness traces it: stage, forward (a quantiser
#: and a K2 launch), send home, and the card's ops with the harness's span
#: shadows on the device timeline
DETECTOR = [
    Event(tracing.TRACED, 0, 1_000),
    Event("perfbench.stage", 10, 40),
    Event("aten::copy_", 12, 30),
    Event("perfbench.forward", 60, 400),
    Event("aten::amax", 70, 100),
    Event("aten::mul", 180, 50),
    Event("cudaLaunchKernel", 250, 20),
    Event("perfbench.send_home", 500, 30),
    Event("aten::copy_", 505, 20),
    Event("Memcpy HtoD (Pinned -> Device)", 30, 50, cuda=True),
    Event("perfbench.forward", 100, 500, cuda=True, annotation=True),
    Event("reduce_kernel", 100, 150, cuda=True),
    Event("elementwise_kernel", 300, 100, cuda=True),
    Event("conv1d_mma_kernel", 450, 150, cuda=True),
    Event("Memcpy DtoH (Device -> Pinned)", 700, 60, cuda=True),
]
#: the program's spans inside that forward, on the host and their shadows
#: on the device (one flagged as an annotation, one known by its name only)
PROGRAM = [
    Event("repro_torch.forward", 65, 380),
    Event("repro_torch.conv1.quantize", 68, 170),
    Event("repro_torch.conv1.kernel", 245, 40),
    Event("repro_torch.forward", 100, 500, cuda=True, annotation=True),
    Event("repro_torch.conv1.quantize", 100, 300, cuda=True),
    Event("repro_torch.conv1.kernel", 450, 150, cuda=True, annotation=True),
    Event("repro_torch.late", 1_200, 10),  # outside the traced segment
]


def test_the_detector_segment_reads_as_before():
    """The readings the harness's reduce gave this segment before it kept
    the program's spans."""
    trace = tracing.reduce(DETECTOR, blocks=1)
    assert [op.name for op in trace.device_ops] == [
        "Memcpy HtoD (Pinned -> Device)", "reduce_kernel", "elementwise_kernel",
        "conv1d_mma_kernel", "Memcpy DtoH (Device -> Pinned)"]
    assert trace.busy_s == pytest.approx(510e-9) and trace.window_s == pytest.approx(1e-6)
    assert trace.gaps == [(pytest.approx(30e-9), "stage > aten::copy_"),
                          (pytest.approx(20e-9), "forward > aten::amax"),
                          (pytest.approx(50e-9), "forward"), (pytest.approx(50e-9), "forward"),
                          (pytest.approx(100e-9), "between phases"),
                          (pytest.approx(240e-9), "between phases")]
    assert trace.breakdown() == {
        "device_ops": [["reduce_kernel", pytest.approx(150e-9)],
                       ["conv1d_mma_kernel", pytest.approx(150e-9)],
                       ["elementwise_kernel", pytest.approx(100e-9)],
                       ["Memcpy DtoH (Device -> Pinned)", pytest.approx(60e-9)],
                       ["Memcpy HtoD (Pinned -> Device)", pytest.approx(50e-9)]],
        "idle_gaps": [["between phases", pytest.approx(340e-9)], ["forward", pytest.approx(100e-9)],
                      ["stage > aten::copy_", pytest.approx(30e-9)],
                      ["forward > aten::amax", pytest.approx(20e-9)]]}
    assert trace.spans == {}


def test_the_programs_spans_are_kept_by_name_and_change_no_reading():
    plain = tracing.reduce(DETECTOR, blocks=1)
    both = tracing.reduce(DETECTOR + PROGRAM, blocks=1)
    for field in ("device_ops", "busy_s", "window_s", "gaps"):
        assert getattr(both, field) == getattr(plain, field), field
    assert both.breakdown() == plain.breakdown()
    assert both.datapath_seconds() == plain.datapath_seconds()
    assert set(both.spans) == {"repro_torch.forward", "repro_torch.conv1.quantize",
                               "repro_torch.conv1.kernel"}
    fwd = both.spans["repro_torch.forward"]
    assert (fwd.calls, fwd.host_s, fwd.device_s) == (1, pytest.approx(380e-9),
                                                     pytest.approx(500e-9))
    q = both.spans["repro_torch.conv1.quantize"]
    assert (q.calls, q.host_s, q.device_s) == (1, pytest.approx(170e-9), pytest.approx(300e-9))


def test_a_span_that_launched_nothing_has_no_device_time():
    both = tracing.reduce(DETECTOR + [Event("repro_torch.idle", 600, 5)], blocks=1)
    assert both.spans["repro_torch.idle"] == tracing.SpanTime(1, pytest.approx(5e-9), 0.0)
