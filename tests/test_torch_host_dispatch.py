"""Host dispatch of the forward, on the CPU: the quantisers' device
constants are made once a value and device (outside inference mode, so a
training path may save them, outside every dispatch mode, and never for a
fake tensor) and give the bits
of constants made anew on each call; the conditions under which
``accelerator_forward`` replays a CUDA graph; the kernel launches a graph's
capture records and each replay adds; and what the graphs are keyed on to
never serve a changed weight.  The replays themselves run only on the card
(``tests/test_torch_graphs_gpu.py``).
"""
import contextlib
import dataclasses
import sys
import threading
import types

import pytest

torch = pytest.importorskip("torch")

from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from repro_torch.core import f32_math, quantization  # noqa: E402
from repro_torch.core.quantization import fxp8_quantize, int8_symmetric  # noqa: E402
from repro_torch.data.features import FEATURE_DIMS, N_SAMPLES  # noqa: E402
from repro_torch.kernels import backend, graphs  # noqa: E402
from repro_torch.models import cnn1d  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.serving import accelerator  # noqa: E402
from repro_torch.serving.accelerator import accelerator_forward  # noqa: E402
from repro_torch.serving.quantized_params import quantize_params  # noqa: E402

torch.set_num_threads(1)

CFG = cnn1d.CNNConfig(input_len=40, channels=(4, 8, 8), hidden=8)
#: the two module-level constant makers
MAKERS = {"quantization._const": quantization._const, "f32_math._f": f32_math._f}


def _uncached(v, like):
    return torch.tensor(v, dtype=torch.float32, device=like.device)


@pytest.mark.parametrize("device", ["cpu", "meta"])
@pytest.mark.parametrize("maker", sorted(MAKERS))
def test_one_constant_per_value_and_device(maker, device):
    make = MAKERS[maker]
    like = torch.empty(3, device=device)
    with torch.inference_mode():  # the first use may come from an inference path
        first = make(0.3217, like)
    assert not first.is_inference() and not first.requires_grad
    assert make(0.3217, like) is first
    assert make(0.3217, torch.empty(2, dtype=torch.float64, device=device)) is first
    assert make(0.3218, like) is not first
    assert make(-0.0, like) is not make(0.0, like)
    assert first.dtype == torch.float32 and first.ndim == 0 and first.device == like.device
    if device == "cpu":
        assert float(first) == float(torch.tensor(0.3217, dtype=torch.float32))
        other = make(0.3217, torch.empty(3, device="meta"))
        assert other is not first and other.device.type == "meta"


def test_a_constant_first_made_in_inference_mode_can_be_saved_for_backward():
    like = torch.empty(1)
    with torch.inference_mode():
        c = quantization._const(0.40625, like)
    x = torch.ones(3, requires_grad=True)
    (x * c).sum().backward()
    assert torch.equal(x.grad, torch.full((3,), 0.40625))


def test_a_fake_operand_gets_a_constant_that_is_not_kept():
    kept = dict(f32_math._consts)
    with FakeTensorMode() as mode:
        like = mode.from_tensor(torch.empty(4))
        c = f32_math._f(0.8125, like)
    assert isinstance(c, FakeTensor)
    assert f32_math._consts == kept


class _Recorder(TorchDispatchMode):
    """Records every op dispatched under it (as the dry run's meters count)."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(func)
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("fake", [False, True], ids=["real", "fake"])
def test_a_kept_tensor_is_made_outside_the_dispatch_modes(fake):
    """A dispatch mode around a kept tensor's first use records no op of
    its making: it is set-up, not part of the step a meter counts."""
    key = ("made outside the modes", fake)
    with contextlib.ExitStack() as stack:
        like = torch.empty(1)
        if fake:
            like = stack.enter_context(FakeTensorMode()).from_tensor(like)
        rec = stack.enter_context(_Recorder())
        t = f32_math.kept(key, like, lambda dev: torch.full((3,), 0.3, device=dev) * 2)
        assert rec.ops == [] and t.shape == (3,) and isinstance(t, FakeTensor) == fake
    assert (key + (like.device,) in f32_math._consts) != fake


def _data(seed: int, shape=(6, 40)) -> torch.Tensor:
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(shape, generator=g) * torch.logspace(-3, 2, shape[0])[:, None]
    x[0, :5] = torch.tensor([0.0, -0.0, 127.0, -128.0, 1e-30])
    return x


@pytest.mark.parametrize("axis", [None, 0])
@pytest.mark.parametrize("jitted", [True, False])
@pytest.mark.parametrize("quant", [int8_symmetric, fxp8_quantize], ids=["int8", "fxp8"])
def test_quantisers_give_the_bits_of_uncached_constants(monkeypatch, quant, jitted, axis):
    x = _data(7)
    got = quant(x, axis=axis, jitted=jitted)
    with monkeypatch.context() as m:
        m.setattr(quantization, "const_f32", _uncached)
        m.setattr(f32_math, "const_f32", _uncached)
        want = quant(x, axis=axis, jitted=jitted)
    assert torch.equal(got.q, want.q)
    assert torch.equal(got.scale.view(torch.int32), want.scale.view(torch.int32))


def _artifact(cfg=CFG, **kw):
    params = cnn1d.init_params(cfg, torch.Generator().manual_seed(11))
    return params, quantize_params(params, cfg, mode="int8", device="cpu", **kw)


@pytest.mark.parametrize("how", ["artifact", "raw_fp32_dict", "raw_windows", "program_spans"])
def test_cpu_calls_leave_the_graph_counters_at_zero(monkeypatch, how):
    monkeypatch.setattr(accelerator_forward, "graph_captures", 0)
    monkeypatch.setattr(accelerator_forward, "graph_replays", 0)
    raw = how == "raw_windows"
    cfg = dataclasses.replace(CFG, input_len=FEATURE_DIMS["zcr"]) if raw else CFG
    params, qp = _artifact(cfg, feature_kind="zcr" if raw else None)
    g = torch.Generator().manual_seed(2)
    x = torch.randn((2, N_SAMPLES) if raw else (3, cfg.input_len), generator=g)
    arg = params if how == "raw_fp32_dict" else qp
    spans = how == "program_spans"
    with profile(activities=[ProfilerActivity.CPU]) if spans else contextlib.nullcontext(), \
            backend.program_spans() if spans else contextlib.nullcontext():
        for _ in range(3):
            out = accelerator_forward(arg, x, cfg, device="cpu", raw_windows=raw)
    assert out.shape == (x.shape[0], cfg.n_classes)
    assert (accelerator_forward.graph_captures, accelerator_forward.graph_replays) == (0, 0)


CUDA_ART = types.SimpleNamespace(device=torch.device("cuda", 0))
ROWS = torch.empty(4, CFG.input_len)


@pytest.mark.parametrize("case,params,qp,x,raw,spans,want", [
    ("baked artifact on the card", CUDA_ART, CUDA_ART, ROWS, False, False, True),
    ("fp32 dict baked per call", {}, CUDA_ART, ROWS, False, False, False),
    ("artifact on the CPU", None, None, ROWS, False, False, False),
    ("raw windows", CUDA_ART, CUDA_ART, ROWS, True, False, False),
    ("no rows", CUDA_ART, CUDA_ART, ROWS[:0], False, False, False),
    ("program spans recorded", CUDA_ART, CUDA_ART, ROWS, False, True, False),
])
def test_which_calls_replay_a_graph(case, params, qp, x, raw, spans, want):
    if qp is None:
        _, qp = _artifact()
        params = qp
    if spans:
        with profile(activities=[ProfilerActivity.CPU]), backend.program_spans():
            got = accelerator._graphed(params, qp, x, raw)
    else:
        got = accelerator._graphed(params, qp, x, raw)
    assert got is want, case


def test_program_spans_without_a_profiler_still_replay():
    with backend.program_spans():
        assert accelerator._graphed(CUDA_ART, CUDA_ART, ROWS, False)
        assert not backend.spans_recording()


def test_a_capture_records_launches_and_each_replay_adds_them():
    def wrapper():
        pass

    wrapper.launches = 0
    other = []
    with backend.record_launches() as rec:
        backend.count_launch(wrapper)
        backend.count_launch(wrapper)
        # another thread's launches are not the capture's: they count at once
        t = threading.Thread(target=lambda: other.append(backend.count_launch(wrapper)))
        t.start()
        t.join()
    assert wrapper.launches == 1 and rec == {(wrapper, "launches"): 2}
    backend.count_launch(wrapper)
    assert wrapper.launches == 2
    for _ in range(3):
        backend.add_launches(rec)
    assert wrapper.launches == 8


def test_count_launch_bumps_a_named_counter():
    def wrapper():
        pass

    wrapper.launches, wrapper.graph_replays = 0, 5
    backend.count_launch(wrapper, "graph_replays")
    assert (wrapper.launches, wrapper.graph_replays) == (0, 6)


def test_split_scratch_of_a_stream_is_what_its_graph_keeps():
    scratch = backend.SplitScratch(torch.int32)
    cpu = torch.device("cpu")
    ws, counters = scratch.get(cpu, 123456789, 10, 3)
    held = backend.split_scratch_of(cpu, 123456789)
    assert any(t is ws for t in held) and any(t is counters for t in held)
    grown, _ = scratch.get(cpu, 123456789, 20, 3)
    assert grown is not ws and any(t is grown for t in backend.split_scratch_of(cpu, 123456789))
    assert backend.split_scratch_of(cpu, 987654321) == []


class _Owner:
    """One owner of a :class:`~repro_torch.kernels.graphs.GraphCache` on the
    CPU, with the card's side stubbed: a capture runs each body once and
    records a graph whose replay only counts; the owner's eager path counts
    and returns zeros.  ``detector``: an artifact's feature-row forward;
    ``lm``: a server's decode step, on the smoke phi4 params of the graphed
    decode tests (``tests/test_torch_granite_hybrid.py``)."""

    def __init__(self, name, monkeypatch):
        self.name, self.calls = name, {"eager": 0, "capture": 0, "replay": 0}
        monkeypatch.setattr(torch.cuda, "current_stream",
                            lambda dev=None: types.SimpleNamespace(cuda_stream=17))
        monkeypatch.setattr(graphs.GraphCache, "_capture",
                            lambda cache, dev, caller, bodies: self._capture(bodies))
        if name == "detector":
            _, self.qp = _artifact()
            self.counters, self.bodies = accelerator_forward, 1
            self.cache = accelerator._graphs_of(self.qp)
            monkeypatch.setattr(accelerator, "forward_quantized", self._eager_forward)
        else:
            from repro_torch.configs import get_config
            from repro_torch.launch.serve import DecodeGraphs
            from repro_torch.models import transformer

            cfg = get_config("phi4_mini").smoke()
            self.params = transformer.init_params(0, cfg, device="cpu")
            self.counters, self.bodies = DecodeGraphs, 2
            self.decode = DecodeGraphs(cfg, self.params, 8)
            self.cache = self.decode.graphs
            monkeypatch.setattr(transformer, "decode_step", self._eager_step)
        monkeypatch.setattr(self.counters, "graph_captures", 0)
        monkeypatch.setattr(self.counters, "graph_replays", 0)

    def _capture(self, bodies):
        self.calls["capture"] += 1
        replay = types.SimpleNamespace(
            replay=lambda: self.calls.__setitem__("replay", self.calls["replay"] + 1))
        return [graphs.Graph(replay, body(), {}, []) for body in bodies]

    def _eager_forward(self, qp, x, per_sample_acts=True, raw_windows=False):
        self.calls["eager"] += 1
        return torch.zeros(x.shape[0], CFG.n_classes)

    def _eager_step(self, params, tok, caches, pos, cfg, max_seq, out=None):
        self.calls["eager"] += 1
        return torch.zeros(tok.shape[0], 1, cfg.vocab), caches if out is None else out

    def call(self, b: int) -> torch.Tensor:
        """One call of ``b`` rows through the owner's graphs."""
        if self.name == "detector":
            return accelerator._forward_graphed(self.qp, torch.empty(b, CFG.input_len), True)
        caches = {"k": torch.zeros(b, 3), "v": {"x": torch.zeros(2, b)}}
        logits, new = self.decode(self.params, torch.zeros(b, 1, dtype=torch.int32), caches, 5)
        assert set(new) == {"k", "v"}
        return logits[:, 0]

    def change(self, how: str) -> None:
        """One weight written in place, or swapped for a copy, or none."""
        if how == "written_in_place":
            (self.qp.convs[1]["w"].q if self.name == "detector" else
             self.params["groups"]["pos0"]["attn"]["wq"]).add_(0)
        elif how == "swapped" and self.name == "detector":
            self.qp.denses[0]["b"] = self.qp.denses[0]["b"].clone()
        elif how == "swapped":
            self.params["final_norm"]["scale"] = self.params["final_norm"]["scale"].clone()

    def counts(self) -> tuple:
        return (self.counters.graph_captures, self.counters.graph_replays)


OWNERS = ["detector", "lm"]


@pytest.mark.parametrize("change", ["written_in_place", "swapped", "none"])
@pytest.mark.parametrize("owner", OWNERS)
def test_graph_key_follows_every_weight(monkeypatch, owner, change):
    """The graphs are keyed on every leaf's identity and in-place write
    count: a weight written in place or swapped drops every graph the owner
    holds, so the next call runs eagerly and the one after captures again;
    with no change the call replays."""
    o = _Owner(owner, monkeypatch)
    for _ in range(3):  # eager, capture, replay
        o.call(4)
    assert o.counts() == (1, 2) and len(o.cache.entries) == 1
    tensors = [t for t in o.cache.leaves if isinstance(t, torch.Tensor)]
    if owner == "detector":  # payload, scale, bias
        assert len(tensors) == len(o.cache.leaves) == 3 * (len(o.qp.convs) + len(o.qp.denses))
    else:  # beside the dicts that hold them
        assert len(tensors) == len(L.tree_leaves(o.params))
    o.change(change)
    eager = o.calls["eager"]
    o.call(4)
    if change == "none":
        assert o.counts() == (1, 3) and o.calls["eager"] == eager
    else:
        assert not o.cache.entries and o.counts() == (1, 2) and o.calls["eager"] == eager + 1
        o.call(4)
        assert o.counts() == (2, 3) and len(o.cache.entries) == 1


@pytest.mark.parametrize("where", ["top", "nested"])
def test_a_swapped_dict_and_a_leaf_swapped_in_it_later_are_both_seen(monkeypatch, where):
    """A server's params dict replaced by a copy drops the decode's graphs;
    once they are captured again, a leaf swapped in the new dict drops them
    too: the guard reads the dicts the params hold now."""
    o = _Owner("lm", monkeypatch)
    for _ in range(3):
        o.call(4)
    parent, name = ((o.params, "final_norm") if where == "top" else
                    (o.params["groups"]["pos0"], "attn"))
    parent[name] = dict(parent[name])
    leaf = next(k for k, v in parent[name].items() if isinstance(v, torch.Tensor))
    o.call(4)
    assert not o.cache.entries and o.counts() == (1, 2)
    for _ in range(2):
        o.call(4)
    assert o.counts() == (2, 4) and len(o.cache.entries) == 1
    parent[name][leaf] = parent[name][leaf].clone()
    o.call(4)
    assert not o.cache.entries and o.counts() == (2, 4)
    o.call(4)
    assert o.counts() == (3, 5)


class _FakeCard:
    """The card's side of a real :meth:`GraphCache._capture` on the CPU:
    streams that order nothing, a pool handle, and graphs that note their
    capture's begin and end and whose replay runs nothing."""

    def __init__(self, monkeypatch):
        self.ends = 0
        card = self
        stream = types.SimpleNamespace(cuda_stream=17, wait_stream=lambda other: None)
        side = types.SimpleNamespace(cuda_stream=18, wait_stream=lambda other: None)

        class Graph:
            def capture_begin(self, pool=None, capture_error_mode=None):
                assert capture_error_mode == "thread_local"

            def capture_end(self):
                card.ends += 1

            def replay(self):
                pass

        monkeypatch.setattr(torch.cuda, "current_stream", lambda dev=None: stream)
        monkeypatch.setattr(torch.cuda, "stream", lambda s: contextlib.nullcontext())
        monkeypatch.setattr(torch.cuda, "CUDAGraph", Graph)
        monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: (0, 1))
        monkeypatch.setattr(graphs, "_capture_stream", lambda dev, caller: side)
        monkeypatch.setattr(backend, "split_scratch_of", lambda dev, stream: [])


def _kernel():
    pass


_kernel.launches = 0


@pytest.mark.parametrize("n", [1, 2, 3, 6])
def test_every_call_counts_one_forward_s_launches(monkeypatch, n):
    """Through the cache's own capture: the capturing call's warm run adds
    no launches and its replay adds the capture's, so each of ``n`` calls
    counts the two launches one forward makes, and the counters read one
    capture and ``n - 1`` replays."""
    _FakeCard(monkeypatch)
    monkeypatch.setattr(_kernel, "launches", 0)
    owner = types.SimpleNamespace(graph_captures=0, graph_replays=0)
    cache = graphs.GraphCache(owner)
    w = torch.ones(3)

    def forward():
        backend.count_launch(_kernel)
        backend.count_launch(_kernel)
        return w * 2

    per_call = []
    for _ in range(n):
        before = _kernel.launches
        out = cache(("k",), [w], forward, lambda: (None, [forward]),
                    lambda state, gs: gs[0].replay() or gs[0].out)
        per_call.append(_kernel.launches - before)
        assert torch.equal(out, w * 2)
    assert per_call == [2] * n
    assert (owner.graph_captures, owner.graph_replays) == (min(n - 1, 1), max(n - 1, 0))


def test_a_failed_capture_ends_it_and_raises(monkeypatch):
    """A body that fails while captured: the capture is ended, the error
    reaches the caller, no graph is kept, and the next call tries again."""
    card = _FakeCard(monkeypatch)
    owner = types.SimpleNamespace(graph_captures=0, graph_replays=0)
    cache = graphs.GraphCache(owner)
    w = torch.ones(3)
    runs = []

    def body():
        runs.append(1)
        if len(runs) == 2:  # the first capture; its warm run passed
            raise RuntimeError("not capturable")
        return w + 1

    call = lambda: cache(("k",), [w], lambda: w + 1, lambda: (None, [body]),  # noqa: E731
                         lambda state, gs: gs[0].out)
    call()
    with pytest.raises(RuntimeError, match="not capturable"):
        call()
    assert card.ends == 1 and not cache.entries and owner.graph_captures == 0
    assert torch.equal(call(), w + 1)
    assert card.ends == 2 and len(cache.entries) == 1 and owner.graph_captures == 1


@pytest.mark.parametrize("extra", [0, 3])
@pytest.mark.parametrize("owner", OWNERS)
def test_keys_past_the_bound_stay_eager_for_good(monkeypatch, owner, extra):
    """Each key runs eagerly, then captures and serves a replay, then
    replays, until the owner holds ``KEYS_PER_OWNER`` keys' graphs; later
    keys run eagerly on every call, and no graph is ever dropped."""
    o = _Owner(owner, monkeypatch)
    n = graphs.KEYS_PER_OWNER + extra
    for _ in range(4):
        for b in range(1, n + 1):
            out = o.call(b)
            assert out.shape[0] == b
    held = graphs.KEYS_PER_OWNER
    assert len(o.cache.entries) == held and o.calls["capture"] == held
    assert {k[0][0] for k in o.cache.entries} == set(range(1, held + 1))
    assert o.calls["replay"] == o.counts()[1] == 3 * held
    assert o.calls["eager"] == (1 + o.bodies) * held + 4 * extra
    assert len(o.cache.seen) == held + extra


def _stress(fn, workers: int = 16):
    """``fn(i)`` on ``workers`` threads at once under a short switch
    interval; each thread's result, in order."""
    out = [None] * workers
    barrier = threading.Barrier(workers)

    def run(i):
        barrier.wait(timeout=30)
        out[i] = fn(i)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=run, args=(i,)) for i in range(workers)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    return out


def test_threads_racing_for_new_constants_get_one_tensor_each():
    like = torch.empty(1)
    values = [0.1 + k / 997 for k in range(50)]
    got = _stress(lambda i: [f32_math.const_f32(v, like) for v in values])
    for k in range(len(values)):
        assert len({id(g[k]) for g in got}) == 1


def test_threads_racing_for_an_artifacts_graphs_get_one_cache():
    _, qp = _artifact()
    got = _stress(lambda i: accelerator._graphs_of(qp))
    assert len({id(g) for g in got}) == 1


@pytest.mark.parametrize("owner", OWNERS)
def test_threads_racing_through_one_cache_capture_once(monkeypatch, owner):
    """Threads calling one owner with one key at once: one call runs
    eagerly, one captures, and every other call is served from a replay."""
    o = _Owner(owner, monkeypatch)
    _stress(lambda i: [o.call(4) for _ in range(6)])
    assert o.counts() == (1, 16 * 6 - 1) and o.calls["replay"] == 16 * 6 - 1
    assert o.calls["capture"] == 1 and o.calls["eager"] == 1 + o.bodies
