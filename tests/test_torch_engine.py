"""The port's MonitorEngine against the JAX MonitorEngine, and its own
streaming contracts.

On a seeded ``synth_scene`` delivered in uneven chunks, the port's
``WindowScore``s and finalized ``TrackEvent``s equal the reference's
exactly for int8 and fxp8 artifacts, and with the front-end on the device
(``on_device_features=True``) as well.  Inside the port, streaming ==
batched == adaptive-slot (with host or on-device features), ``step()`` is
transactional under a raising ``fault_hook``, and snapshot/restore resumes
bitwise.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.launch.monitor import synth_scene  # noqa: E402
from repro.models import cnn1d as jcnn  # noqa: E402
from repro.serving import quantized_params as jqp  # noqa: E402
from repro.serving.engine import MonitorEngine as JEngine  # noqa: E402
from repro_torch.data import features  # noqa: E402
from repro_torch.models import cnn1d as tcnn  # noqa: E402
from repro_torch.serving.accelerator import accelerator_forward  # noqa: E402
from repro_torch.serving.batching import AdmissionPolicy  # noqa: E402
from repro_torch.serving.engine import MonitorEngine, SanitizePolicy, StreamRing  # noqa: E402
from repro_torch.serving.quantized_params import quantize_params  # noqa: E402
from repro_torch.serving.tracker import track_stream  # noqa: E402

torch.set_num_threads(1)

TRACK_KW = dict(ema_alpha=0.7, enter_threshold=0.02, exit_threshold=0.01, min_duration=1)
N_STREAMS = 3


@pytest.fixture(scope="module")
def detector():
    cfg = jcnn.CNNConfig(input_len=features.FEATURE_DIMS["zcr"], channels=(4, 8), hidden=8)
    np_params = jax.tree.map(np.asarray, jcnn.init_params(jax.random.PRNGKey(0), cfg))
    tcfg = tcnn.CNNConfig(input_len=cfg.input_len, channels=(4, 8), hidden=8)
    return cfg, np_params, tcfg, tcnn.params_from_numpy(np_params)


@pytest.fixture(scope="module")
def scene():
    rng = np.random.default_rng(2024)
    audio = np.stack([synth_scene(4.0, rng)[0] for _ in range(N_STREAMS)]).astype(np.float32)
    chunks = []  # uneven delivery rounds, never window-aligned
    cursors = [0] * N_STREAMS
    while any(c < audio.shape[1] for c in cursors):
        rnd = []
        for s in range(N_STREAMS):
            n = int(rng.uniform(0.3, 1.7) * features.N_SAMPLES)
            rnd.append((s, cursors[s], min(audio.shape[1], cursors[s] + n)))
            cursors[s] += n
        chunks.append(rnd)
    return audio, chunks


def _run(engine, audio, chunks):
    scores = []
    for rnd in chunks:
        for s, lo, hi in rnd:
            if lo < hi:
                engine.push(s, audio[s, lo:hi])
        scores.extend(engine.step())
    scores.extend(engine.drain())
    return scores, engine.finalize()


def _as_tuples(scores):
    return [dataclasses.astuple(ws) for ws in scores]


@pytest.mark.parametrize("mode", ["int8", "fxp8"])
def test_engine_equals_reference_engine(detector, scene, mode):
    cfg, np_params, tcfg, tparams = detector
    audio, chunks = scene
    jart = jqp.quantize_params(jax.tree.map(jax.numpy.asarray, np_params), cfg, mode=mode)
    jeng = JEngine(jart, cfg, n_streams=N_STREAMS, feature_kind="zcr", batch_slots=2,
                   interpret=True, **TRACK_KW)
    teng = MonitorEngine(tparams, tcfg, n_streams=N_STREAMS, feature_kind="zcr",
                         batch_slots=2, precision=mode, device="cpu", **TRACK_KW)
    j_scores, j_events = _run(jeng, audio, chunks)
    t_scores, t_events = _run(teng, audio, chunks)
    assert len(t_scores) == N_STREAMS * 5
    assert _as_tuples(t_scores) == _as_tuples(j_scores)
    assert [[dataclasses.astuple(e) for e in evs] for evs in t_events] == \
        [[dataclasses.astuple(e) for e in evs] for evs in j_events]
    assert sum(len(e) for e in t_events) > 0
    assert (teng.windows_scored, teng.rounds, teng.forward_calls, teng.padded_slots) == \
        (jeng.windows_scored, jeng.rounds, jeng.forward_calls, jeng.padded_slots)


def test_on_device_engine_equals_reference_engine(detector, scene):
    cfg, np_params, tcfg, tparams = detector
    audio, chunks = scene
    jart = jqp.quantize_params(jax.tree.map(jax.numpy.asarray, np_params), cfg,
                               feature_kind="zcr")
    jeng = JEngine(jart, cfg, n_streams=N_STREAMS, feature_kind="zcr", on_device_features=True,
                   batch_slots=2, interpret=True, **TRACK_KW)
    teng = MonitorEngine(tparams, tcfg, n_streams=N_STREAMS, feature_kind="zcr",
                         on_device_features=True, batch_slots=2, device="cpu", **TRACK_KW)
    assert teng.artifact.feature_kind == "zcr"
    j_scores, j_events = _run(jeng, audio, chunks)
    t_scores, t_events = _run(teng, audio, chunks)
    assert len(t_scores) == N_STREAMS * 5
    assert [a[:2] for a in _as_tuples(t_scores)] == [b[:2] for b in _as_tuples(j_scores)]
    np.testing.assert_allclose([ws.p_uav for ws in t_scores], [ws.p_uav for ws in j_scores],
                               rtol=0, atol=1e-6)
    assert [[(e.onset_idx, e.offset_idx) for e in evs] for evs in t_events] == \
        [[(e.onset_idx, e.offset_idx) for e in evs] for evs in j_events]
    assert sum(len(e) for e in t_events) > 0


def test_on_device_streaming_equals_batched_equals_adaptive(detector, scene):
    _, _, tcfg, tparams = detector
    audio, chunks = scene
    qp = quantize_params(tparams, tcfg, device="cpu", feature_kind="zcr")
    kw = dict(n_streams=N_STREAMS, feature_kind="zcr", on_device_features=True, device="cpu",
              **TRACK_KW)
    fixed, fixed_events = _run(MonitorEngine(qp, tcfg, batch_slots=2, **kw), audio, chunks)
    adaptive_eng = MonitorEngine(qp, tcfg, batch_slots=4, adaptive_slots=True, **kw)
    assert adaptive_eng.precompile() == (1, 2, 4)
    adaptive, adaptive_events = _run(adaptive_eng, audio, chunks)
    assert _as_tuples(adaptive) == _as_tuples(fixed) and adaptive_events == fixed_events
    n_win = audio.shape[1] // features.N_SAMPLES
    for s in range(N_STREAMS):
        wins = audio[s].reshape(n_win, features.N_SAMPLES)
        probs = accelerator_forward(qp, wins, tcfg, device="cpu", raw_windows=True).numpy()[:, 1]
        got = [ws.p_uav for ws in fixed if ws.stream == s]
        np.testing.assert_array_equal(np.asarray(got), probs.astype(np.float64))
        assert fixed_events[s] == track_stream(probs, **TRACK_KW)
    with pytest.raises(ValueError, match="baked for feature kind 'zcr', got None"):
        MonitorEngine(quantize_params(tparams, tcfg, device="cpu"), tcfg, batch_slots=2, **kw)


def test_streaming_equals_batched_equals_adaptive(detector, scene):
    _, _, tcfg, tparams = detector
    audio, chunks = scene
    qp = quantize_params(tparams, tcfg, device="cpu")
    fixed, fixed_events = _run(MonitorEngine(qp, tcfg, n_streams=N_STREAMS, feature_kind="zcr",
                                             batch_slots=2, device="cpu", **TRACK_KW), audio, chunks)
    adaptive_eng = MonitorEngine(qp, tcfg, n_streams=N_STREAMS, feature_kind="zcr", batch_slots=4,
                                 adaptive_slots=True, device="cpu", **TRACK_KW)
    assert adaptive_eng.precompile() == (1, 2, 4)
    adaptive, adaptive_events = _run(adaptive_eng, audio, chunks)
    assert _as_tuples(adaptive) == _as_tuples(fixed) and adaptive_events == fixed_events
    assert set(adaptive_eng.slot_histogram) <= {1, 2, 4}
    n_win = audio.shape[1] // features.N_SAMPLES
    for s in range(N_STREAMS):
        feats = features.batch_features(audio[s].reshape(n_win, features.N_SAMPLES), "zcr")
        probs = accelerator_forward(qp, feats, tcfg, device="cpu").numpy()[:, 1]
        got = [ws.p_uav for ws in fixed if ws.stream == s]
        np.testing.assert_array_equal(np.asarray(got), probs.astype(np.float64))
        assert fixed_events[s] == track_stream(probs, **TRACK_KW)


def test_multi_window_rounds_equal_classic_beat(detector, scene):
    _, _, tcfg, tparams = detector
    audio, _ = scene
    qp = quantize_params(tparams, tcfg, device="cpu")
    whole = [[(s, 0, audio.shape[1]) for s in range(N_STREAMS)]]
    classic = _run(MonitorEngine(qp, tcfg, n_streams=N_STREAMS, feature_kind="zcr",
                                 batch_slots=2, device="cpu", **TRACK_KW), audio, whole)
    burst = MonitorEngine(qp, tcfg, n_streams=N_STREAMS, feature_kind="zcr", batch_slots=4,
                          device="cpu", admission=AdmissionPolicy(max_per_stream_per_round=3,
                                                                  round_budget=5), **TRACK_KW)
    got = _run(burst, audio, whole)
    key = lambda ws: (ws.stream, ws.window_idx)  # noqa: E731
    assert sorted(_as_tuples(got[0])) == sorted(_as_tuples(classic[0]))
    assert sorted(got[0], key=key) == sorted(classic[0], key=key) and got[1] == classic[1]
    assert burst.rounds < len(classic[0]) // N_STREAMS + 1


def test_step_is_transactional_under_faults(detector, scene):
    _, _, tcfg, tparams = detector
    audio, chunks = scene
    qp = quantize_params(tparams, tcfg, device="cpu")
    clean = _run(MonitorEngine(qp, tcfg, n_streams=N_STREAMS, feature_kind="zcr",
                               batch_slots=2, device="cpu", **TRACK_KW), audio, chunks)
    eng = MonitorEngine(qp, tcfg, n_streams=N_STREAMS, feature_kind="zcr", batch_slots=2,
                        device="cpu", **TRACK_KW)
    calls = {"n": 0}

    def hook(items):
        calls["n"] += 1
        if calls["n"] % 3 == 1:
            raise RuntimeError("injected crash")

    eng.fault_hook = hook
    scores = []

    def step_retrying():
        while True:
            heads = [r._r for r in eng._rings]
            ema = eng.tracker._ema.copy()
            try:
                return eng.step()
            except RuntimeError:
                assert [r._r for r in eng._rings] == heads
                np.testing.assert_array_equal(eng.tracker._ema, ema)

    for rnd in chunks:
        for s, lo, hi in rnd:
            if lo < hi:
                eng.push(s, audio[s, lo:hi])
        scores.extend(step_retrying())
    while True:
        got = step_retrying()
        if not got:
            break
        scores.extend(got)
    assert _as_tuples(scores) == _as_tuples(clean[0]) and eng.finalize() == clean[1]
    assert calls["n"] > len(chunks)


def test_snapshot_restore_resumes_bitwise(detector, scene):
    _, _, tcfg, tparams = detector
    audio, chunks = scene
    qp = quantize_params(tparams, tcfg, device="cpu")
    kw = dict(n_streams=N_STREAMS, feature_kind="zcr", batch_slots=2, device="cpu", **TRACK_KW)
    clean = _run(MonitorEngine(qp, tcfg, **kw), audio, chunks)
    first = MonitorEngine(qp, tcfg, **kw)
    cut = len(chunks) // 2
    head = []
    for rnd in chunks[:cut]:
        for s, lo, hi in rnd:
            if lo < hi:
                first.push(s, audio[s, lo:hi])
        head.extend(first.step())
    snap = first.snapshot()
    second = MonitorEngine(qp, tcfg, **kw)
    second.restore(snap)
    tail, events = _run(second, audio, chunks[cut:])
    assert _as_tuples(head + tail) == _as_tuples(clean[0]) and events == clean[1]
    assert second.windows_scored == N_STREAMS * 5


def test_ring_sanitize_and_validation(detector):
    _, _, tcfg, tparams = detector
    r = StreamRing(window=10, hop=5, capacity_windows=4)
    r.push(np.arange(20))
    assert r.ready == 3
    np.testing.assert_array_equal(r.pop_window(), np.arange(10))
    assert StreamRing(window=10, hop=10, capacity_windows=2).push(np.arange(55)) == 40
    eng = MonitorEngine(tparams, tcfg, n_streams=2, feature_kind="zcr", device="cpu",
                        sanitize=SanitizePolicy())
    bad = np.ones(100, np.float32)
    bad[3] = np.nan
    assert eng.push(0, bad) == 0 and eng.rejected_chunks[0] == 1
    with pytest.raises(ValueError, match="out of range"):
        eng.push(2, bad)
    with pytest.raises(ValueError, match="feature dim"):
        MonitorEngine(tparams, tcfg, n_streams=1, feature_kind="mfcc20", device="cpu")
    # sharded dispatch (ROADMAP M8) is ported: shards=2 serves what the
    # unsharded engine serves, bitwise
    scenes = np.random.default_rng(8).standard_normal((2, 2 * features.N_SAMPLES))
    scored = []
    for shards in (None, 2):
        sharded = MonitorEngine(tparams, tcfg, n_streams=2, feature_kind="zcr", device="cpu",
                                batch_slots=2, shards=shards)
        assert sharded.shards == (shards or 1)
        for s in range(2):
            sharded.push(s, scenes[s].astype(np.float32))
        scored.append([dataclasses.astuple(w) for w in sharded.drain()])
    assert len(scored[0]) == 4 and scored[0] == scored[1]
    # the snapshot's byte codec round-trips the engine's state exactly
    eng.push(1, np.ones(3 * features.N_SAMPLES // 2, np.float32))
    blob = eng.snapshot_bytes()
    back = MonitorEngine(tparams, tcfg, n_streams=2, feature_kind="zcr", device="cpu",
                         sanitize=SanitizePolicy())
    back.restore_bytes(blob)
    assert back.snapshot_bytes() == blob
    assert back.rejected_chunks[0] == 1 and back.ready_windows().tolist() == [0, 1]
