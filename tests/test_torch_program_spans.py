"""The program's profiler spans inside ``forward_quantized``.

A forward recorded inside ``backend.program_spans()`` under a CPU profiler
holds one ``repro_torch.forward`` span a call; under it ``input``, one span
a layer with the children its mode implies (an 8-bit layer quantises, then
runs its kernel; a bf16 or fp32 layer runs the float path; a conv pools),
``flatten`` and ``softmax``, in the datapath's order; and every operator of
the forward lies under one of them.  Without a profiler, or outside
``program_spans()``, ``span()`` is one shared null context and no
``record_function`` is made.
"""
import pytest

torch = pytest.importorskip("torch")

from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch.core.precision_policy import PrecisionPolicy  # noqa: E402
from repro_torch.core.pruning import plan_prune  # noqa: E402
from repro_torch.kernels import backend  # noqa: E402
from repro_torch.models import cnn1d  # noqa: E402
from repro_torch.serving.accelerator import accelerator_forward  # noqa: E402
from repro_torch.serving.quantized_params import quantize_params  # noqa: E402

torch.set_num_threads(1)

P = backend.SPAN_PREFIX
CFG = cnn1d.CNNConfig(input_len=40, channels=(4, 8, 8), hidden=8)
MIXED = "conv0/w=bf16,dense1/w=fp32"
#: each artifact's layer modes: convs, then denses
MODES = {
    "int8": (("int8",) * 3, ("int8",) * 2),
    "pruned_mixed": (("bf16", "int8", "int8"), ("int8", "fp32")),
}


def _artifact(kind: str):
    params = cnn1d.init_params(CFG, torch.Generator().manual_seed(11))
    if kind == "int8":
        return quantize_params(params, CFG, mode="int8", device="cpu")
    return quantize_params(
        params, CFG, mode="int8", device="cpu",
        prune=plan_prune(params["conv2"]["w"], CFG.n_frames, keep=4, trim_frames=1),
        policy=PrecisionPolicy.parse(MIXED, default="int8"))


def _profiled_spans(kind: str, calls: int = 1):
    """Host events (name, start, end) of ``calls`` forwards recorded with the
    program's spans on."""
    qp = _artifact(kind)
    x = torch.randn(3, CFG.input_len, generator=torch.Generator().manual_seed(5))
    with profile(activities=[ProfilerActivity.CPU]) as prof, backend.program_spans():
        for _ in range(calls):
            accelerator_forward(qp, x, CFG, device="cpu")
    assert qp.layer_modes == MODES[kind]
    return sorted(((e.name(), int(e.start_ns()), int(e.start_ns() + e.duration_ns()))
                   for e in prof.profiler.kineto_results.events()), key=lambda e: e[1])


def _children(spans, parent):
    """The program spans directly under ``parent``, in order."""
    _, s0, e0 = parent
    inside = [s for s in spans if s is not parent and s0 <= s[1] and s[2] <= e0]
    return [s for s in inside
            if not any(o is not s and o[1] <= s[1] and s[2] <= o[2] for o in inside)]


@pytest.mark.parametrize("kind", sorted(MODES))
def test_one_forward_span_per_call(kind):
    events = _profiled_spans(kind, calls=3)
    assert [e[0] for e in events].count(P + "forward") == 3


@pytest.mark.parametrize("kind", sorted(MODES))
def test_layer_spans_nest_the_children_their_modes_imply(kind):
    events = _profiled_spans(kind)
    spans = [e for e in events if e[0].startswith(P)]
    (forward,) = [s for s in spans if s[0] == P + "forward"]
    convs, denses = MODES[kind]
    layers = _children(spans, forward)
    assert [s[0][len(P):] for s in layers] == (
        ["input"] + [f"conv{i}" for i in range(len(convs))] + ["flatten"]
        + [f"dense{i}" for i in range(len(denses))] + ["softmax"])
    for layer in layers:
        name = layer[0][len(P):]
        kinds = [s[0][len(layer[0]) + 1:] for s in _children(spans, layer)]
        if name.startswith(("conv", "dense")):
            mode = (convs if name.startswith("conv") else denses)[int(name[-1])]
            want = (["quantize"] if mode in ("int8", "fxp8") else []) + ["kernel"]
            want += ["pool"] if name.startswith("conv") else []
            assert kinds == want, (name, mode)
            assert all(s[0].startswith(layer[0] + ".") for s in _children(spans, layer))
        else:
            assert kinds == []


@pytest.mark.parametrize("kind", sorted(MODES))
def test_every_operator_of_the_forward_lies_under_a_layer_span(kind):
    events = _profiled_spans(kind)
    spans = [e for e in events if e[0].startswith(P)]
    (forward,) = [s for s in spans if s[0] == P + "forward"]
    layers = _children(spans, forward)
    ops = [e for e in events if e[0].startswith("aten::")
           and forward[1] <= e[1] and e[2] <= forward[2]]
    assert len(ops) > 20
    stray = [op[0] for op in ops if not any(s[1] <= op[1] and op[2] <= s[2] for s in layers)]
    assert stray == []


def test_span_is_one_shared_null_context_unless_recorded(monkeypatch):
    def no_record(name):
        raise AssertionError(f"record_function({name!r}) made with nothing to record")

    monkeypatch.setattr(torch.profiler, "record_function", no_record)
    assert not torch.autograd._profiler_enabled()
    null = backend.span("forward")
    assert backend.span("conv1.quantize") is null
    with backend.program_spans():  # asked for, but no profiler records
        assert backend.span("conv1.kernel") is null
    with profile(activities=[ProfilerActivity.CPU]):  # a profiler, spans not asked for
        assert backend.span("softmax") is null
    monkeypatch.undo()
    with profile(activities=[ProfilerActivity.CPU]), backend.program_spans():
        assert backend.span("softmax") is not null
    assert backend._span_scopes == 0


def test_spans_leave_the_forward_bitwise_unchanged():
    qp = _artifact("pruned_mixed")
    x = torch.randn(4, CFG.input_len, generator=torch.Generator().manual_seed(2))
    plain = accelerator_forward(qp, x, CFG, device="cpu")
    with profile(activities=[ProfilerActivity.CPU]), backend.program_spans():
        spanned = accelerator_forward(qp, x, CFG, device="cpu")
    assert torch.equal(plain, spanned)
