"""granite-4.0-h-micro on the port: the published Mamba2 mixer beside NoPE
GQA attention, the four multipliers, the chunked SSD scan, the counters and
the LM path's spans.

The reference is the benchmark's plain one (``perfbench/references/
granite_hybrid.py``: float32, no cache, the recurrence step by step); the
port runs a reduced config of one whole period (10 layers, tiny widths,
float32) on weights drawn as the benchmark draws them.  The chunked scan is
held against the per-step recurrence in float64.
"""
import dataclasses
import importlib.util
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from perfbench import lm_weights  # noqa: E402
from repro_torch.configs import ARCHS, get_config  # noqa: E402
from repro_torch.configs.base import ArchConfig, HybridConfig  # noqa: E402
from repro_torch.distributed import sharding as SH  # noqa: E402
from repro_torch.kernels import backend  # noqa: E402
from repro_torch.kernels import graphs as G  # noqa: E402
from repro_torch.models import mamba2 as M2  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402

CONF_FILE = ROOT / "perfbench" / "configs" / "granite4_h_micro_bf16.json"
SEED = 2**33 + 30
#: the reduced config in the file's keys: one period, tiny widths, float32;
#: weights of std 0.2, so that the recurrence moves the logits
SMALL = dict(num_hidden_layers=10, hidden_size=64, num_attention_heads=4, num_key_value_heads=2,
             shared_intermediate_size=96, vocab_size=256, mamba_n_heads=16, mamba_d_head=8,
             mamba_d_state=8, torch_dtype="float32", initializer_range=0.2)
ROWS, PROMPT, STEPS, MAX_SEQ = 3, 21, 5, 40


@pytest.fixture(autouse=True)
def small_chunks(monkeypatch):
    """Chunks of 8, so that a 21-token prefill runs two whole chunks and a
    short one (the scan test passes its own chunk)."""
    monkeypatch.setattr(M2, "SSD_CHUNK", 8)


def _reference():
    spec = importlib.util.spec_from_file_location(
        "granite_hybrid_ref", ROOT / "perfbench" / "references" / "granite_hybrid.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


REF = _reference()


def _small():
    """(reference conf, port cfg, drawn weights, port params)."""
    import json

    conf = json.loads(CONF_FILE.read_text())
    conf = {**conf, **SMALL, "layer_types": conf["layer_types"][:10]}
    cfg = get_config("granite4_h_micro").replace(**REF.port_fields(conf))
    weights = lm_weights.draw(REF, conf, 7, "cpu")
    return conf, cfg, weights, lm_weights.nest(weights, T.abstract_params(cfg))


def _tokens(n=PROMPT + STEPS):
    return torch.from_numpy(np.random.default_rng(3).integers(0, 256, (ROWS, n)))


def _gap(got, want):
    """The widest |got - want| of each row over the reference row's spread."""
    return float(((got - want).abs().amax(-1) / want.std(-1, unbiased=False)).max())


def test_the_published_config():
    cfg = get_config("granite4_h_micro")
    assert isinstance(cfg, HybridConfig) and cfg.n_groups == 4
    attn = [l for l in range(cfg.n_layers) if cfg.pattern[l % len(cfg.pattern)] == "attn"]
    assert attn == [5, 15, 25, 35]
    assert (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_ff, cfg.vocab) == (
        2048, 32, 8, 64, 8192, 100352)
    assert (cfg.ssm_expand * cfg.d_model // cfg.ssm_head_dim, cfg.ssm_state) == (64, 128)
    assert (cfg.nope, cfg.attn_scale, cfg.embed_mult, cfg.residual_mult, cfg.logits_div) == (
        True, 0.015625, 12.0, 0.22, 8.0)
    assert T.param_count(cfg) == 3_191_396_096
    shapes = T.cache_shapes(cfg, 64, 2048)["pos0"]
    assert shapes["conv"][0] == (4, 64, 3, 4096 + 2 * 128)  # the conv over [x, B, C]
    assert shapes["ssm"][0] == (4, 64, 64, 128, 64)


@pytest.mark.parametrize("arch", [a for a in ARCHS if a != "shield8_cnn"])
def test_the_new_fields_leave_every_other_config_as_it_was(arch):
    """The hybrid fields are ``ArchConfig`` class attributes, not fields:
    ``asdict`` (which the JAX-parity tests hold equal) has none of them."""
    cfg = get_config(arch)
    new = {f.name for f in dataclasses.fields(HybridConfig)} - {
        f.name for f in dataclasses.fields(ArchConfig)}
    assert new == {"nope", "attn_scale", "embed_mult", "residual_mult", "logits_div",
                   "ssm_published"}
    assert type(cfg) is ArchConfig and not new & set(dataclasses.asdict(cfg))
    assert (cfg.nope, cfg.attn_scale, cfg.embed_mult, cfg.residual_mult, cfg.logits_div,
            cfg.ssm_published) == (False, None, 1.0, 1.0, 1.0, False)


@pytest.mark.parametrize("arch", ["phi4_mini", "zamba2_7b"])
def test_a_hybrid_config_at_its_defaults_computes_the_same_bits(arch):
    base = get_config(arch).smoke()
    hybrid = HybridConfig(**dataclasses.asdict(base))
    params = T.init_params(0, base, device="cpu")
    tokens = {"tokens": _tokens(12)}
    with torch.inference_mode():
        assert torch.equal(T.forward(params, tokens, base), T.forward(params, tokens, hybrid))
        last, caches = T.forward_with_cache(params, {"tokens": tokens["tokens"][:, :8]}, base, 16)
        step = T.decode_step(params, tokens["tokens"][:, 8:9], caches, 8, base, 16)[0]
        again = T.decode_step(params, tokens["tokens"][:, 8:9], caches, 8, hybrid, 16)[0]
    assert torch.equal(step, again)


def test_forward_matches_the_reference():
    """float32 on both sides: the chunked scan and the products' other
    orders move the logits by about 3e-7 of a row's spread; 1e-4 leaves a
    three-hundredfold room."""
    conf, cfg, weights, params = _small()
    tokens = _tokens()
    with torch.inference_mode():
        got = T.forward(params, {"tokens": tokens}, cfg)
    want = REF.unembed(weights, conf)(REF.hidden(weights, conf, tokens, 0))
    assert got.shape == want.shape == (ROWS, PROMPT + STEPS, 256)
    assert _gap(got, want) < 1e-4


def test_prefill_then_decode_matches_the_reference():
    """The prefill (chunked: 8 + 8 + 5 tokens) and 5 decode steps through
    the caches, against one full forward of the reference."""
    conf, cfg, weights, params = _small()
    tokens = _tokens()
    got = []
    with torch.inference_mode():
        logits, caches = T.forward_with_cache(params, {"tokens": tokens[:, :PROMPT]}, cfg, MAX_SEQ)
        got.append(logits[:, 0])
        for k in range(STEPS):
            tok = tokens[:, PROMPT + k:PROMPT + k + 1]
            logits, caches = T.decode_step(params, tok, caches, PROMPT + k, cfg, MAX_SEQ)
            got.append(logits[:, 0])
    want = REF.unembed(weights, conf)(REF.hidden(weights, conf, tokens, PROMPT - 1))
    assert _gap(torch.stack(got, 1), want[:, :STEPS + 1]) < 1e-4


def _scan_inputs(t, b=2, h=3, n=4, p=5):
    g = torch.Generator().manual_seed(t)
    r = lambda *s: torch.randn(*s, generator=g, dtype=torch.float64)
    dt = torch.rand(b, t, h, generator=g, dtype=torch.float64)
    log_a = -dt * torch.rand(h, generator=g, dtype=torch.float64) * 2
    return r(b, t, h, p), r(b, t, n), r(b, t, n), dt, log_a, r(h), r(b, h, n, p)


def _recurrence(x, b, c, dt, log_a, d, s0):
    """The scan step by step: ``S_t = exp(log_a_t) S_{t-1} + dt_t (B_t ⊗
    x_t)``, ``y_t = C_t^T S_t + D x_t``; S (B, H, N, P)."""
    S, ys = s0, []
    for t in range(x.shape[1]):
        S = (torch.exp(log_a[:, t])[..., None, None] * S
             + dt[:, t, :, None, None] * b[:, t, None, :, None] * x[:, t, :, None, :])
        ys.append(torch.einsum("bn,bhnp->bhp", c[:, t], S) + d[:, None] * x[:, t])
    return S, torch.stack(ys, 1)


@pytest.mark.parametrize("t", [1, 255, 256, 257, 600])
def test_the_chunked_scan_is_the_recurrence(t):
    """float64, chunks of 256, a nonzero initial state: the outputs and the
    state handed on agree with the step-by-step recurrence to rounding."""
    x, b, c, dt, log_a, d, s0 = _scan_inputs(t)
    want_s, want_y = _recurrence(x, b, c, dt, log_a, d, s0)
    before = M2.chunked_chunks
    got_s, got_y = M2._ssd_chunked(x, b, c, dt, log_a, d, s0, 256)
    assert M2.chunked_chunks - before == -(-t // 256)
    torch.testing.assert_close(got_y, want_y, rtol=1e-11, atol=1e-11)
    torch.testing.assert_close(got_s, want_s, rtol=1e-11, atol=1e-11)


@pytest.mark.parametrize("published", [True, False])
def test_the_conv_state_continues_across_prefill_and_decode(published, monkeypatch):
    """A mixer run over 19 tokens at once equals a prefill of 13 (chunks
    of 4: 4 + 4 + 4 + 1) handing its conv and ssm states to 6 decode
    steps: the conv's window spans the boundary.  The two sum in other
    orders in float32: up to 5e-7 of the mixer's output scale apart over
    five seeds and 1-6 threads; a zeroed conv state moves it by 0.19 of
    that scale and more."""
    cfg = _small()[1] if published else get_config("zamba2_7b").smoke()
    cfg = HybridConfig(**{**dataclasses.asdict(cfg), "ssm_published": published})
    monkeypatch.setattr(M2, "SSD_CHUNK", 4)
    gen = torch.Generator().manual_seed(2)
    p = T._group(T.init_params(1, cfg, device="cpu")["groups"], 0)["pos0"]["mamba"]
    p = {**p, "conv_b": torch.randn(p["conv_b"].shape, generator=gen),
         "a_log": torch.randn(p["a_log"].shape, generator=gen)}
    x = torch.randn(2, 19, cfg.d_model, generator=gen)
    with torch.inference_mode():
        whole, _ = M2.mamba2_fwd(p, x, cfg)
        part, st = M2.mamba2_fwd(p, x[:, :13], cfg, emit_state=True)
        outs = [part]
        for t in range(13, 19):
            y, st = M2.mamba2_decode(p, x[:, t:t + 1], st, cfg)
            outs.append(y)
    assert st["conv"].shape == (2, 3, M2._conv_width(cfg))
    scale = float((whole - x).abs().max())
    assert float((torch.cat(outs, 1) - whole).abs().max()) <= 2e-6 * scale


def test_the_counters_count_chunks_and_single_step_updates():
    """A prefill of 21 tokens at chunks of 8 adds 3 chunks a mixer (9 in
    one period's 9 mixers) and no single-step update; a decode step adds
    one update a mixer and no chunk."""
    _, cfg, _, params = _small()
    tokens = _tokens()
    with torch.inference_mode():
        chunks, steps = M2.chunked_chunks, M2.step_updates
        _, caches = T.forward_with_cache(params, {"tokens": tokens[:, :PROMPT]}, cfg, MAX_SEQ)
        assert (M2.chunked_chunks - chunks, M2.step_updates - steps) == (9 * 3, 0)
        chunks, steps = M2.chunked_chunks, M2.step_updates
        T.decode_step(params, tokens[:, PROMPT:PROMPT + 1], caches, PROMPT, cfg, MAX_SEQ)
        assert (M2.chunked_chunks - chunks, M2.step_updates - steps) == (0, 9)


class _FourWayMesh:
    """A mesh of four ranks along ``"model"`` with no process group: enough
    for the rules to cut the heads, not to run a collective."""

    axis_names = ("data", "model")
    shape = {"data": 1, "model": 4}


def test_the_published_mixer_refuses_rules_that_cut_its_heads():
    _, cfg, _, params = _small()
    p = T._group(params["groups"], 0)["pos0"]["mamba"]
    with SH.use_rules(SH.ShardingRules(_FourWayMesh())):
        assert M2.head_cut(cfg).size == 4
        with pytest.raises(NotImplementedError, match="one device"):
            M2.mamba2_fwd(p, torch.zeros(1, 2, cfg.d_model), cfg)


def test_the_lm_spans_record_under_any_profiler():
    """With a profiler on and no ``program_spans()`` scope: a decode step
    of one period holds a ``mamba2`` span and a ``mamba2.scan`` span inside
    it for each of its 9 mixers, an ``attn`` span for its attention layer
    and an ``mlp`` span for each of its 10 MLPs.  With no profiler
    ``lm_span`` makes no ``record_function``."""
    _, cfg, _, params = _small()
    tokens = _tokens()
    with torch.inference_mode():
        _, caches = T.forward_with_cache(params, {"tokens": tokens[:, :PROMPT]}, cfg, MAX_SEQ)
        assert backend.lm_span("mamba2") is backend._NO_SPAN
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            T.decode_step(params, tokens[:, PROMPT:PROMPT + 1], caches, PROMPT, cfg, MAX_SEQ)
    events = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
              for e in prof.profiler.kineto_results.events()]
    names = [n for n, _, _ in events]
    P = backend.SPAN_PREFIX
    assert (names.count(P + "mamba2"), names.count(P + "mamba2.scan"), names.count(P + "attn"),
            names.count(P + "mlp")) == (9, 9, 1, 10)
    mixers = [(s, e) for n, s, e in events if n == P + "mamba2"]
    for _, s, e in [ev for ev in events if ev[0] == P + "mamba2.scan"]:
        assert any(ms <= s and e <= me for ms, me in mixers)


def _chain(decode, caches, first, steps, pos0):
    """``steps`` greedy decode steps from ``caches``: (logits of each step,
    the caches after the last)."""
    got, cur = [], first
    for k in range(steps):
        logits, caches = decode(cur, caches, pos0 + k)
        got.append(logits.clone())
        cur = torch.argmax(logits, dim=-1)
    return got, caches


#: the graphed decode's configs: granite's period (NoPE, Mamba2 mixers)
#: and a small dense RoPE config (phi4-mini's family)
GRAPHED = ["granite", "phi4"]


def _graphed_case(name):
    """(cfg, params) of a config :data:`GRAPHED` names."""
    if name == "granite":
        _, cfg, _, params = _small()
        return cfg, params
    cfg = get_config("phi4_mini").smoke()
    return cfg, T.init_params(0, cfg, device="cpu")


@pytest.mark.parametrize("case", GRAPHED)
def test_decode_with_its_position_on_the_device_is_the_int_path(case):
    """A decode step handed its position as a 0-d tensor, with its new
    caches written into buffers of its own (what a captured graph replays),
    gives the int path's logits and caches bit for bit, and leaves the
    caches it was handed as they were: with RoPE as without."""
    cfg, params = _graphed_case(case)
    tokens = _tokens()
    with torch.inference_mode():
        _, caches = T.forward_with_cache(params, {"tokens": tokens[:, :PROMPT]}, cfg, MAX_SEQ)
        before = T.L.tree_map(torch.clone, caches)
        for k in range(3):
            tok = tokens[:, PROMPT + k:PROMPT + k + 1]
            want, want_c = T.decode_step(params, tok, caches, PROMPT + k, cfg, MAX_SEQ)
            out = T.L.tree_map(torch.empty_like, caches)
            got, got_c = T.decode_step(params, tok, caches, torch.tensor(PROMPT + k), cfg,
                                       MAX_SEQ, out=out)
            assert got_c is out and torch.equal(got, want)
            assert all(torch.equal(a, b) for a, b in
                       zip(T.L.tree_leaves(got_c), T.L.tree_leaves(want_c)))
            assert all(torch.equal(a, b) for a, b in
                       zip(T.L.tree_leaves(caches), T.L.tree_leaves(before)))
            caches, before = want_c, T.L.tree_map(torch.clone, want_c)


def test_only_a_step_that_reads_its_position_on_the_device_is_graphable():
    """granite's step is, and so is phi4's (its RoPE frequencies and score
    divisor are kept on the device); a shared attention block (zamba2),
    ring caches and scaled embeddings (gemma3), an RWKV mixer, int8 weights
    or a CPU server are not, and the CPU server decodes eagerly."""
    from repro_torch.launch.serve import BatchedServer, DecodeGraphs
    from repro_torch.models.quantized import quantize_lm_params

    _, cfg, _, params = _small()
    assert T.decode_graphable(cfg, params)
    assert not T.decode_graphable(cfg, quantize_lm_params(params, cfg=cfg))
    phi4 = get_config("phi4_mini").smoke()
    assert T.decode_graphable(phi4, T.abstract_params(phi4))
    for arch in ("zamba2_7b", "gemma3_12b", "rwkv6_7b"):
        other = get_config(arch).smoke()
        assert not T.decode_graphable(other, T.abstract_params(other))
    server = BatchedServer(cfg, params, batch_slots=ROWS, max_seq=MAX_SEQ, device="cpu")
    assert not isinstance(server._decode, DecodeGraphs)


class _EagerGraph:
    """Stands in for a captured graph on the CPU: a replay runs the graph's
    body again into what its capture returned."""

    def __init__(self, body, out):
        self.body, self.out = body, out

    def replay(self):
        with backend.record_launches():  # a replay's counts: added from the capture's
            self.out.copy_(self.body())


def _eager_capture(self, dev, caller, bodies):
    """``GraphCache._capture`` on the CPU: each body run once, its launches
    recorded, with an :class:`_EagerGraph` for its graph."""
    captured = []
    for body in bodies:
        with backend.record_launches() as launches:
            out = body()
        captured.append(G.Graph(_EagerGraph(body, out), out, launches, []))
    return captured


def _graphs_on_the_cpu(monkeypatch):
    """The graph cache's card side stood in for: the capture, and one
    calling stream."""
    monkeypatch.setattr(G.GraphCache, "_capture", _eager_capture)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: SimpleNamespace(cuda_stream=17))


@pytest.mark.parametrize("case", GRAPHED)
def test_decode_graphs_replay_the_eager_chain(monkeypatch, case):
    """Through ``DecodeGraphs`` (its capture stood in for on the CPU): the
    first call runs eagerly and the second captures, unless a profiler
    records; each step's caches feed the next with no copy, the prefill's
    caches are copied in at a restart and left as they were; the logits
    and the caches are the eager chain's bit for bit; a replay adds its
    capture's launch counts; ``graph_captures`` counts the one batch shape
    and ``graph_replays`` every step after it; other weights run eagerly."""
    from repro_torch.launch.serve import DecodeGraphs

    _graphs_on_the_cpu(monkeypatch)
    monkeypatch.setattr(DecodeGraphs, "graph_captures", 0)
    monkeypatch.setattr(DecodeGraphs, "graph_replays", 0)
    counts = lambda: (DecodeGraphs.graph_captures, DecodeGraphs.graph_replays)  # noqa: E731
    cfg, params = _graphed_case(case)
    tokens = _tokens()
    eager = lambda tok, c, pos: T.decode_step(params, tok, c, pos, cfg, MAX_SEQ)  # noqa: E731
    with torch.inference_mode():
        logits, prefilled = T.forward_with_cache(params, {"tokens": tokens[:, :PROMPT]}, cfg,
                                                 MAX_SEQ)
        first = torch.argmax(logits, dim=-1)
        kept = T.L.tree_map(torch.clone, prefilled)
        want, want_c = _chain(eager, prefilled, first, 6, PROMPT)
        graphs = DecodeGraphs(cfg, params, MAX_SEQ)
        graphed = lambda tok, c, pos: graphs(params, tok, c, pos)  # noqa: E731
        with profile(activities=[ProfilerActivity.CPU]):
            graphed(first, prefilled, PROMPT)
            graphed(first, prefilled, PROMPT)
        assert not graphs.graphs.entries and counts() == (0, 0)  # none while a profiler records
        steps = M2.step_updates
        got, got_c = _chain(graphed, prefilled, first, 6, PROMPT)
        (state, _), = graphs.graphs.entries.values()
        assert got_c is state.bufs[0] and counts() == (1, 6)
        if case == "granite":
            assert M2.step_updates - steps == 6 * 9
        for a, b in zip(got, want):
            assert torch.equal(a, b)
        assert all(torch.equal(a, b) for a, b in
                   zip(T.L.tree_leaves(got_c), T.L.tree_leaves(want_c)))
        again, _ = _chain(graphed, prefilled, first, 3, PROMPT)  # a restart
        assert all(torch.equal(a, b) for a, b in zip(again, want[:3])) and counts() == (1, 9)
        assert all(torch.equal(a, b) for a, b in
                   zip(T.L.tree_leaves(prefilled), T.L.tree_leaves(kept)))
        other = T.L.tree_map(torch.clone, params)
        logits, _ = graphs(other, first, prefilled, PROMPT)
        assert torch.equal(logits, want[0]) and counts() == (1, 9)


@pytest.mark.parametrize("device", ["cpu", pytest.param("cuda", marks=pytest.mark.gpu)])
@pytest.mark.parametrize("change", ["swapped", "written_in_place"])
@pytest.mark.parametrize("case", GRAPHED)
def test_a_changed_server_weight_is_never_decoded_from_a_stale_graph(monkeypatch, case, change,
                                                                     device):
    """A leaf of the server's params swapped for another tensor, or written
    in place, after the decode has captured: the next step runs eagerly and
    the one after captures again, and every step's logits are the eager
    step's on the weights of that moment.  On the CPU the capture is stood
    in for; on the card the graphs are real."""
    from repro_torch.launch.serve import BatchedServer, DecodeGraphs

    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: a CUDA graph has no CPU mode")
    if device == "cpu":
        _graphs_on_the_cpu(monkeypatch)
    monkeypatch.setattr(DecodeGraphs, "graph_captures", 0)
    monkeypatch.setattr(DecodeGraphs, "graph_replays", 0)
    cfg, params = _graphed_case(case)
    if device == "cuda":
        server = BatchedServer(cfg, params, batch_slots=ROWS, max_seq=MAX_SEQ, device=device)
        p, decode = server.params, server._decode
        assert isinstance(decode, DecodeGraphs)
    else:
        p = params
        decode = DecodeGraphs(cfg, p, MAX_SEQ)
    tokens = _tokens().to(device)
    with torch.inference_mode():
        logits, caches = T.forward_with_cache(p, {"tokens": tokens[:, :PROMPT]}, cfg, MAX_SEQ)
    cur, pos = torch.argmax(logits, dim=-1), PROMPT
    counts = []
    for k in range(6):
        if k == 3:
            with torch.inference_mode():
                stale = T.decode_step(p, cur, caches, pos, cfg, MAX_SEQ)[0]
            if change == "swapped":
                p["final_norm"]["scale"] = p["final_norm"]["scale"] * 1.5
            else:
                p["final_norm"]["scale"].mul_(1.5)
        with torch.inference_mode():
            want = T.decode_step(p, cur, caches, pos, cfg, MAX_SEQ)[0]
            got, caches = decode(p, cur, caches, pos)
            assert torch.equal(got, want), k
            if k == 3:
                assert not torch.equal(want, stale)
            cur, pos = torch.argmax(got, dim=-1), pos + 1
        counts.append((DecodeGraphs.graph_captures, DecodeGraphs.graph_replays))
    # eager, captured, replayed; the change: eager, captured, replayed
    assert counts == [(0, 0), (1, 1), (1, 2), (1, 2), (2, 3), (2, 4)]


@pytest.mark.gpu
@pytest.mark.parametrize("case", GRAPHED)
def test_decode_graphs_on_the_card_give_the_eager_bits(monkeypatch, case):
    """On the card, the server's graphed decode of granite's period and of a
    small dense RoPE config gives the eager step's logits and caches bit
    for bit over a chain and a restart, and replays after its second call:
    one batch shape captured, every later step replayed."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: a CUDA graph has no CPU mode")
    from repro_torch.launch.serve import BatchedServer, DecodeGraphs

    monkeypatch.setattr(DecodeGraphs, "graph_captures", 0)
    monkeypatch.setattr(DecodeGraphs, "graph_replays", 0)
    cfg, params = _graphed_case(case)
    dev = torch.device("cuda")
    server = BatchedServer(cfg, params, batch_slots=ROWS, max_seq=MAX_SEQ, device=dev)
    assert isinstance(server._decode, DecodeGraphs)
    p = server.params
    tokens = _tokens().to(dev)
    eager = lambda tok, c, pos: T.decode_step(p, tok, c, pos, cfg, MAX_SEQ)  # noqa: E731
    graphed = lambda tok, c, pos: server._decode(p, tok, c, pos)  # noqa: E731
    with torch.inference_mode():
        logits, prefilled = server._prefill(p, {"tokens": tokens[:, :PROMPT]})
        first = torch.argmax(logits, dim=-1)
        want, want_c = _chain(eager, prefilled, first, 6, PROMPT)
        for _ in range(2):  # the second pass restarts from the prefill
            got, got_c = _chain(graphed, prefilled, first, 6, PROMPT)
            assert server._decode.graphs.entries
            for a, b in zip(got, want):
                assert torch.equal(a, b)
            assert all(torch.equal(a, b) for a, b in
                       zip(T.L.tree_leaves(got_c), T.L.tree_leaves(want_c)))
    # the first step eager, the second captured and replayed, then replays
    assert (DecodeGraphs.graph_captures, DecodeGraphs.graph_replays) == (1, 11)
