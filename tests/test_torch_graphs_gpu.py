"""``accelerator_forward``'s CUDA graphs on the card: a replay gives the
eager forward's bits for an int8, an FXP8 and a pruned mixed-precision
artifact (bf16 conv0, fp32 dense1) at 1, 7 and 1,024 rows; inputs from two
alternating buffers and outputs held across calls stay intact; the counters
read one capture and ``n - 1`` replays after ``n`` calls (the capturing call
is served from a replay), and the kernels' launch counters count a replay
as one forward; a new shape, a new stream or
a new activation scaling captures a graph of its own, and past the bound
a new key stays eager while no graph goes; threads sharing an artifact and
a stream each get their own rows; a replayed and a warm eager forward
neither wait on the card nor copy from pageable memory, and the profiler
sees a replay's kernels under their own names, each wrapper's as often as
the launches the replay adds; a weight written in place or
swapped is never served from a stale graph; a sync inside the forward makes
the capture raise.

Marked ``gpu``: every test skips without a CUDA device.  The file imports
neither JAX nor ``repro``:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_graphs_gpu.py
"""
import sys
import threading

import pytest

torch = pytest.importorskip("torch")

from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch.core import quantization  # noqa: E402
from repro_torch.core.precision_policy import PrecisionPolicy  # noqa: E402
from repro_torch.core.pruning import plan_prune  # noqa: E402
from repro_torch.kernels.conv1d_fused import conv1d_fused_q  # noqa: E402
from repro_torch.kernels.cordic_act import cordic_softmax  # noqa: E402
from repro_torch.kernels import graphs  # noqa: E402
from repro_torch.kernels.frontend import project_rows  # noqa: E402
from repro_torch.kernels.quant_matmul import quant_matmul  # noqa: E402
from repro_torch.models import cnn1d  # noqa: E402
from repro_torch.serving import accelerator  # noqa: E402
from repro_torch.serving.accelerator import accelerator_forward, forward_quantized  # noqa: E402
from repro_torch.serving.quantized_params import quantize_params  # noqa: E402

CFG = cnn1d.CANONICAL
MIXED = "conv0/w=bf16,dense1/w=fp32"
KINDS = ("int8", "fxp8", "pruned_mixed")
KERNELS = (conv1d_fused_q, quant_matmul, project_rows, cordic_softmax)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    accelerator_forward.graph_captures = accelerator_forward.graph_replays = 0
    return torch.device("cuda")


def _artifact(kind: str, dev):
    params = cnn1d.init_params(CFG, torch.Generator().manual_seed(3))
    if kind == "pruned_mixed":
        return quantize_params(
            params, CFG, mode="int8", device=dev,
            prune=plan_prune(params["conv2"]["w"], CFG.n_frames, keep=64, trim_frames=1),
            policy=PrecisionPolicy.parse(MIXED, default="int8"))
    return quantize_params(params, CFG, mode=kind, device=dev)


def _rows(b: int, dev, seed: int = 0) -> torch.Tensor:
    g = torch.Generator().manual_seed(seed)
    return (8.0 * torch.randn(b, CFG.input_len, generator=g)).to(dev)


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int32).cpu()


def _forward(qp, x, dev, **kw):
    return accelerator_forward(qp, x, CFG, device=dev, **kw)


def _counts():
    return (accelerator_forward.graph_captures, accelerator_forward.graph_replays)


@pytest.mark.gpu
@pytest.mark.parametrize("b", [1, 7, 1024])
@pytest.mark.parametrize("kind", KINDS)
def test_replay_is_bitwise_the_eager_forward(card, kind, b):
    qp = _artifact(kind, card)
    x = _rows(b, card)
    want = _bits(forward_quantized(qp, x))
    outs = [_forward(qp, x, card) for _ in range(4)]
    assert _counts() == (1, 3)
    for out in outs:
        assert torch.equal(_bits(out), want)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", KINDS)
def test_alternating_inputs_and_held_outputs_stay_intact(card, kind):
    qp = _artifact(kind, card)
    xs = [_rows(1024, card, seed=s) for s in (1, 2)]
    want = [_bits(forward_quantized(qp, x)) for x in xs]
    assert not torch.equal(want[0], want[1])
    outs = [_forward(qp, xs[i % 2], card) for i in range(7)]
    torch.cuda.synchronize()
    assert _counts() == (1, 6)
    for i, out in enumerate(outs):
        assert torch.equal(_bits(out), want[i % 2]), f"call {i}"


@pytest.mark.gpu
@pytest.mark.parametrize("n,captures,replays", [(1, 0, 0), (2, 1, 1), (3, 1, 2), (9, 1, 8)])
def test_counters_read_one_capture_and_n_minus_1_replays(card, n, captures, replays):
    qp = _artifact("int8", card)
    x = _rows(16, card)
    for _ in range(n):
        _forward(qp, x, card)
    assert _counts() == (captures, replays)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", KINDS)
def test_kernel_launch_counters_count_a_replay_as_one_forward(card, kind):
    qp = _artifact(kind, card)
    x = _rows(64, card)
    per_call = []
    for _ in range(4):  # eager, capture, replay, replay
        for k in KERNELS:
            k.launches = 0
        _forward(qp, x, card)
        per_call.append({k.__name__: k.launches for k in KERNELS})
    assert _counts() == (1, 3)
    assert per_call[0]["conv1d_fused_q"] >= 2 and per_call[0]["cordic_softmax"] == 1
    assert all(c == per_call[0] for c in per_call), per_call


@pytest.mark.gpu
def test_a_new_shape_stream_or_scaling_captures_a_graph_of_its_own(card):
    qp = _artifact("int8", card)
    calls = [(_rows(7, card), {}), (_rows(8, card), {}),
             (_rows(8, card), {"per_sample_acts": False})]
    for i, (x, kw) in enumerate(calls, start=1):
        want = _bits(forward_quantized(qp, x, **kw))
        for _ in range(3):
            assert torch.equal(_bits(_forward(qp, x, card, **kw)), want)
        assert _counts() == (i, 2 * i)
    side = torch.cuda.Stream(card)
    x = calls[0][0]
    with torch.cuda.stream(side):
        side.wait_stream(torch.cuda.default_stream(card))
        outs = [_forward(qp, x, card) for _ in range(3)]
        torch.cuda.current_stream(card).synchronize()
    assert _counts() == (4, 8)
    want = _bits(forward_quantized(qp, x))
    assert all(torch.equal(_bits(o), want) for o in outs)


@pytest.mark.gpu
def test_threads_sharing_an_artifact_and_a_stream_get_their_own_rows(card):
    qp = _artifact("int8", card)
    xs = [_rows(64, card, seed=s) for s in range(4)]
    want = [_bits(forward_quantized(qp, x)) for x in xs]
    got = [[] for _ in xs]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda i=i: got[i].extend(
            _forward(qp, xs[i], card) for _ in range(12))) for i in range(len(xs))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    torch.cuda.synchronize()
    assert _counts() == (1, 4 * 12 - 1)
    for i, outs in enumerate(got):
        assert len(outs) == 12 and all(torch.equal(_bits(o), want[i]) for o in outs), i


@pytest.mark.gpu
def test_keys_past_the_bound_stay_eager_and_no_graph_goes(card):
    qp = _artifact("int8", card)
    side = torch.cuda.Stream(card)
    side.wait_stream(torch.cuda.current_stream(card))
    with torch.cuda.stream(side):
        for _ in range(3):  # a graph of its own pool on the side stream
            _forward(qp, _rows(3, card), card)
        torch.cuda.current_stream(card).synchronize()
    held = graphs.KEYS_PER_OWNER
    shapes = list(range(4, 4 + held))
    for b in shapes:  # one more shape than the bound leaves room for
        for _ in range(2):
            _forward(qp, _rows(b, card), card)
    entries = accelerator._graphs_of(qp).entries
    # the side stream's capture and replays, then each shape's capturing call
    assert len(entries) == held and _counts() == (held, held + 1)
    assert (3,) + (CFG.input_len,) in {k[0] for k in entries}
    last = shapes[-1]
    x = _rows(last, card, seed=9)
    want = _bits(forward_quantized(qp, x))
    outs = [_forward(qp, x, card) for _ in range(3)]  # the last shape stays eager
    assert _counts() == (held, held + 1) and all(torch.equal(_bits(o), want) for o in outs)
    for b in shapes[:-1]:  # every captured shape still replays
        x = _rows(b, card, seed=b)
        assert torch.equal(_bits(_forward(qp, x, card)), _bits(forward_quantized(qp, x)))
    with torch.cuda.stream(side):
        x = _rows(3, card, seed=4)
        out = _forward(qp, x, card)
        torch.cuda.current_stream(card).synchronize()
    assert torch.equal(_bits(out), _bits(forward_quantized(qp, x)))
    assert _counts() == (held, held + 1 + len(shapes) - 1 + 1)


def _host_and_device_events(fn):
    """The names of the host's events and, apart, of the card's kernels."""
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.events()
    on_card = [e.name for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    return [e.name for e in events], on_card


#: the name every kernel a wrapper launches has in a trace
KERNEL_NAMES = {conv1d_fused_q: "conv1d_", quant_matmul: "qmm_kernel",
                project_rows: "project_rows_kernel", cordic_softmax: "cordic_softmax"}


@pytest.mark.gpu
@pytest.mark.parametrize("kind", KINDS)
def test_replayed_and_warm_eager_forwards_never_wait_or_copy_pageable(card, kind):
    qp = _artifact(kind, card)
    x = _rows(1024, card)
    for _ in range(3):
        _forward(qp, x, card)
    torch.cuda.synchronize()
    replayed, replayed_kernels = _host_and_device_events(lambda: _forward(qp, x, card))
    eager, _ = _host_and_device_events(lambda: forward_quantized(qp, x))
    assert _counts() == (1, 3)
    for names in (replayed, eager):
        assert "cudaStreamSynchronize" not in names
        assert not any("Pageable" in n for n in names), [n for n in names if "Pageable" in n]
    # the replay's kernels reach the trace under their own names
    kernels = ["conv1d_mma_kernel", "qmm_kernel", "cordic_softmax_kernel"]
    kernels.append("project_rows_kernel" if kind == "pruned_mixed" else "conv1d_small_cin_kernel")
    for kernel in kernels:
        assert any(kernel in n for n in replayed_kernels), kernel
    # and each wrapper's kernels ran as often as the launches a replay adds
    ((_, (graph,)),) = accelerator._graphs_of(qp).entries.values()
    for wrapper, name in KERNEL_NAMES.items():
        ran = sum(name in n for n in replayed_kernels)
        assert ran == graph.launches.get((wrapper, "launches"), 0), (wrapper.__name__, ran)


@pytest.mark.gpu
@pytest.mark.parametrize("how", ["written_in_place", "swapped"])
def test_a_changed_weight_is_never_served_from_a_stale_graph(card, how):
    qp = _artifact("int8", card)
    x = _rows(32, card)
    for _ in range(3):
        before = _bits(_forward(qp, x, card))
    if how == "written_in_place":
        w = qp.convs[1]["w"].q
        w.copy_(torch.flip(w, dims=[2]))
    else:
        qp.denses[0]["b"] = qp.denses[0]["b"] + 1.0
    want = _bits(forward_quantized(qp, x))
    assert not torch.equal(want, before)
    outs = [_bits(_forward(qp, x, card)) for _ in range(3)]
    assert all(torch.equal(o, want) for o in outs)
    assert _counts() == (2, 4)


@pytest.mark.gpu
def test_a_sync_inside_the_forward_makes_the_capture_raise(card, monkeypatch):
    monkeypatch.setattr(quantization, "const_f32",
                        lambda v, like: torch.tensor(v, dtype=torch.float32, device=like.device))
    qp = _artifact("int8", card)
    x = _rows(8, card)
    _forward(qp, x, card)
    with pytest.raises(RuntimeError):
        _forward(qp, x, card)
    assert _counts() == (0, 0)
    monkeypatch.undo()
    torch.cuda.synchronize()
    qp = _artifact("int8", card)
    want = _bits(forward_quantized(qp, x))
    assert all(torch.equal(_bits(_forward(qp, x, card)), want) for _ in range(3))
