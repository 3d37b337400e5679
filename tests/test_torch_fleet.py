"""The port's fault-tolerant fleet against the reference's, and its own
fleet contracts.

The port's ``FleetSupervisor(device="cpu")`` gives per-stream scores and
``TrackEvent`` lists bitwise equal to the JAX ``FleetSupervisor`` on the
same scene, delivery schedule and seeded ``FaultPlan`` (crash, stall, kill,
chunk faults, reassignment), for int8 and fxp8 artifacts and with
execution lanes.  Inside the port the chaos, lane, elasticity and SLO-loop
contracts of ``tests/test_fault_tolerance.py`` and
``tests/test_lane_fleet.py`` hold on the torch engine: the fleet equals
the monolith bitwise, recovery is lossless, lanes equal the sequential
fleet, spawn/retire/retune are lossless, and a rebuilt worker serves the
fleet's one artifact without quantising or copying it again.
"""
import dataclasses
import threading

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.models import cnn1d as jcnn  # noqa: E402
from repro.serving import quantized_params as jqp  # noqa: E402
from repro.serving.batching import AdmissionPolicy as JAdmission  # noqa: E402
from repro.serving.engine import SanitizePolicy as JSanitize  # noqa: E402
from repro.serving.faults import FaultClock as JClock  # noqa: E402
from repro.serving.faults import FaultPlan as JPlan  # noqa: E402
from repro.serving.supervisor import FleetSupervisor as JFleet  # noqa: E402
from repro_torch.data import features  # noqa: E402
from repro_torch.models import cnn1d as tcnn  # noqa: E402
from repro_torch.serving import faults as tfaults  # noqa: E402
from repro_torch.serving import quantized_params as tqp  # noqa: E402
from repro_torch.serving.batching import AdmissionPolicy, IngestQueue  # noqa: E402
from repro_torch.serving.controller import FleetController, SLOTarget  # noqa: E402
from repro_torch.serving.engine import MonitorEngine, SanitizePolicy  # noqa: E402
from repro_torch.serving.faults import Fault, FaultClock, FaultPlan  # noqa: E402
from repro_torch.serving.supervisor import FleetSupervisor  # noqa: E402

torch.set_num_threads(1)

TRACK_KW = dict(ema_alpha=0.7, enter_threshold=0.02, exit_threshold=0.01, min_duration=1)
ENGINE_KW = dict(feature_kind="zcr", batch_slots=2, **TRACK_KW)
SUP_KW = dict(ENGINE_KW, sanitize=SanitizePolicy(nonfinite="reject"), device="cpu")
J_SUP_KW = dict(ENGINE_KW, sanitize=JSanitize(nonfinite="reject"))
W = features.N_SAMPLES

#: the handcrafted chaos plan: every worker and chunk kind once
CHAOS = [
    Fault("raise_forward", round=1, worker=0, magnitude=2),
    Fault("stall_forward", round=2, worker=1, magnitude=5.0),
    Fault("kill_worker", round=3, worker=0),
    Fault("drop_chunk", round=1, stream=3),
    Fault("corrupt_chunk", round=2, stream=0),
    Fault("jitter_chunk", round=2, stream=1, magnitude=0.4),
]


@pytest.fixture(scope="module")
def detector(tmp_path_factory):
    """{mode: (jax cfg, jax artifact, port cfg, port artifact)}: the
    reference's small detector baked by JAX, carried into the port by
    ``save_artifact`` / ``load_artifact``."""
    cfg = jcnn.CNNConfig(input_len=features.FEATURE_DIMS["zcr"], channels=(4, 8), hidden=8)
    params = jcnn.init_params(jax.random.PRNGKey(0), cfg)
    tcfg = tcnn.CNNConfig(input_len=cfg.input_len, channels=(4, 8), hidden=8)
    out = {}
    for mode in ("int8", "fxp8"):
        jart = jqp.quantize_params(params, cfg, mode=mode)
        path = tmp_path_factory.mktemp("art") / f"{mode}.npz"
        jqp.save_artifact(path, jart)
        out[mode] = (cfg, jart, tcfg, tqp.load_artifact(path, device="cpu"))
    return out


def _scene(rng, n_streams, n_win):
    audio = rng.standard_normal((n_streams, n_win * W)).astype(np.float32)
    schedule, cursors, total = [], [0] * n_streams, audio.shape[1]
    while any(c < total for c in cursors):
        rnd = []
        for s in range(n_streams):
            if cursors[s] >= total:
                continue
            n = int(rng.uniform(0.3, 1.7) * W)
            rnd.append((s, cursors[s], min(total, cursors[s] + n)))
            cursors[s] += n
        schedule.append(rnd)
    return audio, schedule


def _drive(engine, audio, schedule):
    scores = {s: [] for s in range(audio.shape[0])}
    for rnd in schedule:
        for s, lo, hi in rnd:
            engine.push(s, audio[s, lo:hi])
        for ws in engine.step():
            scores[ws.stream].append(ws.p_uav)
    while True:
        scored = engine.step()
        if not scored:
            return scores
        for ws in scored:
            scores[ws.stream].append(ws.p_uav)


def _events(evs):
    return [[dataclasses.astuple(e) for e in es] for es in evs]


def _assert_streams_bitwise(scores, events, ref_scores, ref_events, streams):
    for s in streams:
        np.testing.assert_array_equal(np.asarray(scores[s], np.float64),
                                      np.asarray(ref_scores[s], np.float64),
                                      err_msg=f"stream {s} scores diverged")
        assert _events(events)[s] == _events(ref_events)[s], f"stream {s} events diverged"


def _plan_kw(faults, package="torch"):
    if faults is None:
        return {}
    plan = (FaultPlan if package == "torch" else JPlan).from_json(faults.to_json())
    return dict(faults=plan, clock=(FaultClock if package == "torch" else JClock)())


def _fleet(detector, n_streams, n_workers, mode="int8", faults=None, **kw):
    _, _, tcfg, tart = detector[mode]
    kw = {"clock": FaultClock(), "dispatch_deadline_s": 1.0, **SUP_KW, **_plan_kw(faults), **kw}
    return FleetSupervisor(tart, tcfg, n_streams=n_streams, n_workers=n_workers, **kw)


def _jfleet(detector, n_streams, n_workers, mode="int8", faults=None, **kw):
    cfg, jart, _, _ = detector[mode]
    kw = {"clock": JClock(), "dispatch_deadline_s": 1.0, **J_SUP_KW, **_plan_kw(faults, "jax"),
          **kw}
    return JFleet(jart, cfg, n_streams=n_streams, n_workers=n_workers, **kw)


def _mono(detector, n_streams, mode="int8", **kw):
    _, _, tcfg, tart = detector[mode]
    return MonitorEngine(tart, tcfg, n_streams=n_streams, **SUP_KW, **kw)


@pytest.fixture(scope="module")
def fleet_scene(detector):
    """4 streams of 5 windows in uneven chunks, and the fault-free port
    fleet's scores and events on them."""
    audio, schedule = _scene(np.random.default_rng(21), 4, 5)
    sup = _fleet(detector, 4, 2)
    scores = _drive(sup, audio, schedule)
    events = sup.finalize()
    assert sum(len(e) for e in events) > 0
    return audio, schedule, scores, events


@pytest.fixture(scope="module")
def lane_scene(detector):
    """6 streams of 5 windows, and the port monolith's scores and events."""
    audio, schedule = _scene(np.random.default_rng(51), 6, 5)
    mono = _mono(detector, 6)
    scores = _drive(mono, audio, schedule)
    events = mono.finalize()
    assert sum(len(e) for e in events) > 0
    return audio, schedule, scores, events


# ---------------------------------------------------------------------------
# The port's fleet equals the reference's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["int8", "fxp8"])
def test_fleet_equals_reference_fleet_and_monolith(detector, fleet_scene, mode):
    audio, schedule, _, _ = fleet_scene
    sup, jsup = _fleet(detector, 4, 2, mode), _jfleet(detector, 4, 2, mode)
    scores, jscores = _drive(sup, audio, schedule), _drive(jsup, audio, schedule)
    events, jevents = sup.finalize(), jsup.finalize()
    _assert_streams_bitwise(scores, events, jscores, jevents, range(4))
    mono = _mono(detector, 4, mode)
    _assert_streams_bitwise(scores, events, _drive(mono, audio, schedule), mono.finalize(),
                            range(4))
    np.testing.assert_array_equal(sup.served_windows, jsup.served_windows)
    assert (sup.windows_scored, sup.forward_calls, sup.round) == \
        (jsup.windows_scored, jsup.forward_calls, jsup.round)


def _per_worker(sup):
    out = {}
    for i in sup.incidents:
        out.setdefault(i["worker"], []).append((i["round"], i["kind"]))
    return out


@pytest.mark.parametrize("mode,plan,lanes", [
    ("int8", "chaos", None), ("fxp8", "chaos", None), ("int8", "chaos", "threads"),
    ("int8", 0, None), ("int8", 1, "threads"),
])
def test_fleet_under_fault_plan_equals_reference_fleet(detector, fleet_scene, mode, plan, lanes):
    """The same seeded plan through both packages' fleets: every stream
    (faulted ones included), the incident log and the fault counters are
    equal; streams no lossy fault touched equal the fault-free run."""
    audio, schedule, ref_scores, ref_events = fleet_scene
    if plan == "chaos":
        faults = FaultPlan(list(CHAOS), seed=None)
    else:
        faults = FaultPlan.generate(plan, n_streams=4, n_workers=2, n_rounds=len(schedule),
                                    n_faults=6)
    sup = _fleet(detector, 4, 2, mode, faults, lanes=lanes)
    jsup = _jfleet(detector, 4, 2, mode, faults)
    scores, jscores = _drive(sup, audio, schedule), _drive(jsup, audio, schedule)
    events, jevents = sup.finalize(), jsup.finalize()
    _assert_streams_bitwise(scores, events, jscores, jevents, range(4))
    assert _per_worker(sup) == _per_worker(jsup)
    assert sup.faulted_chunks.tolist() == jsup.faulted_chunks.tolist()
    assert [w.rebuilds for w in sup.workers] == [w.rebuilds for w in jsup.workers]
    if mode == "int8":
        _assert_streams_bitwise(scores, events, ref_scores, ref_events,
                                set(range(4)) - faults.affected_streams)
    sup.close()


def test_reassignment_equals_reference_fleet(detector, fleet_scene):
    """A worker killed past ``max_rebuilds`` is retired and its streams move
    to the survivor in both packages alike, losslessly."""
    audio, schedule, ref_scores, ref_events = fleet_scene
    faults = FaultPlan([Fault("kill_worker", round=1, worker=0),
                        Fault("kill_worker", round=2, worker=0)])
    sup = _fleet(detector, 4, 2, faults=faults, max_rebuilds=1)
    jsup = _jfleet(detector, 4, 2, faults=faults, max_rebuilds=1)
    scores, jscores = _drive(sup, audio, schedule), _drive(jsup, audio, schedule)
    events = sup.finalize()
    _assert_streams_bitwise(scores, events, jscores, jsup.finalize(), range(4))
    _assert_streams_bitwise(scores, events, ref_scores, ref_events, range(4))
    assert sup.workers[1].streams == jsup.workers[1].streams == [2, 3, 0, 1]
    assert [i["kind"] for i in sup.incidents] == [i["kind"] for i in jsup.incidents] == \
        ["kill", "kill", "reassign"]


@pytest.mark.parametrize("seed", [0, 7, 42])
def test_fault_plans_equal_reference_json(tmp_path, seed):
    kw = dict(n_streams=8, n_workers=2, n_rounds=30)
    plan = FaultPlan.generate(seed, **kw)
    assert plan.to_json() == JPlan.generate(seed, **kw).to_json()
    assert FaultPlan.from_json(JPlan.generate(seed, **kw).to_json()).faults == plan.faults
    assert plan.faults == FaultPlan.generate(seed, **kw).faults
    out = tmp_path / "plan.json"
    tfaults.main(["--seed", str(seed), "--streams", "4", "--workers", "2", "--rounds", "10",
                  "--out", str(out)])
    assert out.read_text() == JPlan.generate(seed, n_streams=4, n_workers=2,
                                             n_rounds=10).to_json()


def test_fault_validation():
    with pytest.raises(ValueError, match="unknown fault kind"):
        Fault("explode", 0, stream=1)
    with pytest.raises(ValueError, match="target stream"):
        Fault("drop_chunk", 0)
    with pytest.raises(ValueError, match="target worker"):
        Fault("kill_worker", 0)


# ---------------------------------------------------------------------------
# Chaos contracts on the torch engine
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_workers", [2, 4])
def test_fleet_without_faults_matches_single_engine(detector, fleet_scene, n_workers):
    audio, schedule, _, _ = fleet_scene
    mono = _mono(detector, 4)
    ref_scores = _drive(mono, audio, schedule)
    sup = _fleet(detector, 4, n_workers)
    _assert_streams_bitwise(_drive(sup, audio, schedule), sup.finalize(), ref_scores,
                            mono.finalize(), range(4))


def test_lossy_chunk_faults_isolate_target_streams(detector, fleet_scene):
    audio, schedule, ref_scores, ref_events = fleet_scene
    plan = FaultPlan([Fault("drop_chunk", round=1, stream=0),
                      Fault("corrupt_chunk", round=2, stream=3)])
    assert plan.affected_streams == {0, 3}
    sup = _fleet(detector, 4, 2, faults=plan)
    scores = _drive(sup, audio, schedule)
    _assert_streams_bitwise(scores, sup.finalize(), ref_scores, ref_events, {1, 2})
    assert sup.faulted_chunks.tolist() == [1, 0, 0, 1]
    w, local = sup._route[3]
    assert sup.workers[w].engine.rejected_chunks[local] == 1
    assert len(scores[0]) < len(ref_scores[0])


def test_jitter_resegmentation_is_bitwise_invisible(detector, fleet_scene):
    audio, schedule, ref_scores, ref_events = fleet_scene
    plan = FaultPlan([Fault("jitter_chunk", round=0, stream=1, magnitude=0.4),
                      Fault("jitter_chunk", round=3, stream=2, magnitude=0.7)])
    assert plan.affected_streams == set()
    sup = _fleet(detector, 4, 2, faults=plan)
    _assert_streams_bitwise(_drive(sup, audio, schedule), sup.finalize(), ref_scores,
                            ref_events, range(4))
    assert sup.faulted_chunks.sum() == 2


def test_worker_crash_stall_kill_are_lossless(detector, fleet_scene):
    audio, schedule, ref_scores, ref_events = fleet_scene
    plan = FaultPlan([Fault("raise_forward", round=1, worker=0),
                      Fault("stall_forward", round=2, worker=1, magnitude=5.0),
                      Fault("kill_worker", round=3, worker=0)])
    sup = _fleet(detector, 4, 2, faults=plan)
    _assert_streams_bitwise(_drive(sup, audio, schedule), sup.finalize(), ref_scores,
                            ref_events, range(4))
    assert [i["kind"] for i in sup.incidents] == ["crash", "stall", "kill"]
    assert [i["worker"] for i in sup.incidents] == [0, 1, 0]
    assert sup.workers[0].rebuilds == 2 and sup.workers[1].rebuilds == 1


def test_back_to_back_worker_failures_never_escape_step(detector, fleet_scene):
    audio, schedule, ref_scores, ref_events = fleet_scene
    sup = _fleet(detector, 4, 2, faults=FaultPlan([
        Fault("raise_forward", round=1, worker=0, magnitude=2)]))
    _assert_streams_bitwise(_drive(sup, audio, schedule), sup.finalize(), ref_scores,
                            ref_events, range(4))
    assert [(i["round"], i["kind"]) for i in sup.incidents] == [(1, "crash"), (1, "crash")]
    assert sup.workers[0].rebuilds == 2 and all(w.alive for w in sup.workers)


def test_transient_fault_outliving_rebuild_budget_retires_losslessly(detector, fleet_scene):
    audio, schedule, ref_scores, ref_events = fleet_scene
    sup = _fleet(detector, 4, 2, max_rebuilds=1,
                 faults=FaultPlan([Fault("raise_forward", round=1, worker=0, magnitude=5)]))
    _assert_streams_bitwise(_drive(sup, audio, schedule), sup.finalize(), ref_scores,
                            ref_events, range(4))
    assert [i["kind"] for i in sup.incidents] == ["crash", "crash", "reassign"]
    assert not sup.workers[0].alive and sup.workers[1].streams == [2, 3, 0, 1]
    health = sup.health()
    assert health[0]["alive"] is False and health[0]["streams"] == []


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_generated_plans_complete_and_isolate(detector, fleet_scene, seed):
    audio, schedule, ref_scores, ref_events = fleet_scene
    plan = FaultPlan.generate(seed, n_streams=4, n_workers=2, n_rounds=len(schedule),
                              n_faults=5)
    sup = _fleet(detector, 4, 2, faults=plan)
    _assert_streams_bitwise(_drive(sup, audio, schedule), sup.finalize(), ref_scores,
                            ref_events, set(range(4)) - plan.affected_streams)
    assert len(sup.health()) == 2


def test_revived_workers_share_the_artifact(detector, fleet_scene, monkeypatch):
    """Recovery rebuilds engines around the fleet's one artifact: no
    quantisation and no copy of the weights, whatever the faults."""
    audio, schedule, _, _ = fleet_scene
    sup = _fleet(detector, 4, 2, faults=FaultPlan(list(CHAOS)), max_rebuilds=1)
    calls = tqp.quantize_calls
    moved = []
    monkeypatch.setattr(tqp.QuantizedParams, "to",
                        lambda self, device: moved.append(device) or self)
    _drive(sup, audio, schedule)
    assert tqp.quantize_calls == calls and moved == []
    assert sum(w.rebuilds for w in sup.workers) >= 3
    assert all(w.engine.artifact is sup._qp for w in sup.workers if w.alive)


def test_supervisor_health_heartbeat_and_validation(detector):
    _, _, tcfg, tart = detector["int8"]
    sup = FleetSupervisor(tart, tcfg, n_streams=2, n_workers=2, clock=FaultClock(tick=0.25),
                          **SUP_KW)
    assert all(h["heartbeat_age_s"] is None for h in sup.health())
    sup.push(0, np.zeros(W, np.float32))
    sup.step()
    h = sup.health()
    assert h[0]["rounds"] == 1 and h[1]["rounds"] == 0
    assert all(hh["heartbeat_age_s"] is not None and hh["heartbeat_age_s"] >= 0 for hh in h)
    with pytest.raises(ValueError, match="out of range"):
        sup.push(5, np.zeros(4, np.float32))
    params = tcnn.init_params(tcfg, torch.Generator().manual_seed(1))
    with pytest.raises(ValueError, match="pre-baked"):
        FleetSupervisor(params, tcfg, n_streams=2, **SUP_KW)
    with pytest.raises(ValueError, match="n_workers"):
        FleetSupervisor(tart, tcfg, n_streams=2, n_workers=3, **SUP_KW)
    with pytest.raises(ValueError, match="dispatch_deadline_s"):
        FleetSupervisor(tart, tcfg, n_streams=2, dispatch_deadline_s=0, **SUP_KW)
    with pytest.raises(ValueError, match="lanes"):
        FleetSupervisor(tart, tcfg, n_streams=2, lanes="processes", **SUP_KW)


# ---------------------------------------------------------------------------
# Admission and overflow eviction through the supervisor
# ---------------------------------------------------------------------------


def _firehose_run(engine, audio, n_win):
    """Stream 0 pushes 2 windows a round into a 1-window ring; 1-3 one."""
    scores = {s: [] for s in range(4)}
    for r in range(n_win):
        engine.push(0, audio[0, : 2 * W])
        for s in (1, 2, 3):
            engine.push(s, audio[s, r * W:(r + 1) * W])
        for ws in engine.step():
            scores[ws.stream].append(ws.p_uav)
    return scores


def test_supervisor_evicts_persistently_overflowing_stream(detector):
    audio = np.random.default_rng(33).standard_normal((4, 6 * W)).astype(np.float32)
    kw = dict(capacity_windows=1, admission=AdmissionPolicy(evict_overflow_rounds=2))
    sup = _fleet(detector, 4, 2, **kw)
    jsup = _jfleet(detector, 4, 2, capacity_windows=1,
                   admission=JAdmission(evict_overflow_rounds=2))
    scores = _firehose_run(sup, audio, 6)
    jscores = _firehose_run(jsup, audio, 6)
    events = sup.finalize()
    _assert_streams_bitwise(scores, events, jscores, jsup.finalize(), range(4))
    assert [i["kind"] for i in sup.incidents] == ["evict"] and "[0]" in sup.incidents[0]["detail"]
    assert sup.evicted == {0} and sup.workers[0].streams == [1]
    assert sup._route[1] == (0, 0) and 0 not in sup._route
    assert sup.refused_chunks[0] == 6 - 2 and len(scores[0]) == 2
    mono = _mono(detector, 4, capacity_windows=1)
    _assert_streams_bitwise(scores, events, _firehose_run(mono, audio, 6), mono.finalize(),
                            (1, 2, 3))
    np.testing.assert_array_equal(sup.served_windows[1:], mono.served_windows[1:])


def test_evicted_and_retired_streams_keep_final_counter_totals(detector):
    rng = np.random.default_rng(36)
    sup = _fleet(detector, 2, 2, capacity_windows=1,
                 admission=AdmissionPolicy(evict_overflow_rounds=1))
    for _ in range(2):
        sup.push(0, rng.standard_normal(2 * W).astype(np.float32))
        sup.push(1, rng.standard_normal(W).astype(np.float32))
        sup.step()
    assert sup.evicted == {0}
    assert not sup.workers[0].alive and sup.workers[0].streams == []
    assert sup.served_windows[0] == 1 and sup.served_windows[1] == 2
    sup.push(1, rng.standard_normal(W).astype(np.float32))
    assert [ws.stream for ws in sup.step()] == [1]


def test_fleet_admission_cap_refuses_late_streams(detector):
    rng = np.random.default_rng(37)
    sup = _fleet(detector, 4, 2, admission=AdmissionPolicy(max_streams=2))

    def win():
        return rng.standard_normal(W).astype(np.float32)

    assert sup.push(0, win()) == 0 and sup.push(3, win()) == 0
    assert sup.push(1, win()) == 0 and sup.push(2, win()) == 0
    assert sorted(ws.stream for ws in sup.step()) == [0, 3]
    np.testing.assert_array_equal(sup.refused_chunks, [0, 1, 1, 0])
    sup.push(1, win())
    assert sup.refused_chunks[1] == 2
    with pytest.raises(ValueError, match="out of range"):
        sup.push(7, win())


# ---------------------------------------------------------------------------
# Execution lanes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_workers", [2, 3, 6])
def test_lane_fleet_bitwise_equals_sequential_and_monolithic(detector, lane_scene, n_workers):
    audio, schedule, ref_scores, ref_events = lane_scene
    seq = _fleet(detector, 6, n_workers)
    seq_scores = _drive(seq, audio, schedule)
    lanes = _fleet(detector, 6, n_workers, lanes="threads")
    lane_scores = _drive(lanes, audio, schedule)
    _assert_streams_bitwise(seq_scores, seq.finalize(), ref_scores, ref_events, range(6))
    _assert_streams_bitwise(lane_scores, lanes.finalize(), ref_scores, ref_events, range(6))
    np.testing.assert_array_equal(lanes.served_windows, seq.served_windows)
    np.testing.assert_array_equal(lanes.deferred_windows, seq.deferred_windows)
    assert (lanes.windows_scored, lanes.round) == (seq.windows_scored, seq.round)
    lanes.close()


@pytest.mark.parametrize("plan", ["handcrafted", 0, 1])
def test_lane_fleet_bitwise_equals_sequential_under_fault_plans(detector, lane_scene, plan):
    audio, schedule, ref_scores, ref_events = lane_scene
    if plan == "handcrafted":
        faults = FaultPlan([
            Fault("raise_forward", round=1, worker=0, magnitude=2),
            Fault("stall_forward", round=2, worker=1, magnitude=5.0),
            Fault("kill_worker", round=3, worker=2),
            Fault("drop_chunk", round=1, stream=4),
            Fault("jitter_chunk", round=2, stream=0, magnitude=0.4),
        ])
    else:
        faults = FaultPlan.generate(plan, n_streams=6, n_workers=3, n_rounds=len(schedule),
                                    n_faults=5)
    seq = _fleet(detector, 6, 3, faults=faults)
    seq_scores = _drive(seq, audio, schedule)
    seq_events = seq.finalize()
    lanes = _fleet(detector, 6, 3, faults=faults, lanes="threads")
    lane_scores = _drive(lanes, audio, schedule)
    lane_events = lanes.finalize()
    _assert_streams_bitwise(lane_scores, lane_events, seq_scores, seq_events, range(6))
    _assert_streams_bitwise(lane_scores, lane_events, ref_scores, ref_events,
                            set(range(6)) - faults.affected_streams)
    assert _per_worker(lanes) == _per_worker(seq)
    np.testing.assert_array_equal(lanes.faulted_chunks, seq.faulted_chunks)
    lanes.close()


def test_lane_push_defers_delivery_to_step(detector):
    sup = _fleet(detector, 2, 2, lanes="threads")
    win = np.zeros(W, np.float32)
    assert sup.push(0, win) == 0 and len(sup._ingest) == 1
    assert all(len(w.journal) == 0 for w in sup.workers)
    with pytest.raises(ValueError, match="out of range"):
        sup.push(9, win)
    assert [ws.stream for ws in sup.step()] == [0] and len(sup._ingest) == 0
    sup.push(1, win)
    sup.close()
    assert sup._ingest is None
    assert [ws.stream for ws in sup.step()] == [1]


def test_lanes_are_named_threads(detector):
    sup = _fleet(detector, 2, 2, lanes="threads")
    seen = {}
    orig = sup._step_worker

    def spy(w):
        seen[w.idx] = threading.current_thread().name
        return orig(w)

    sup._step_worker = spy
    for s in range(2):
        sup.push(s, np.zeros(W, np.float32))
    sup.step()
    assert seen == {0: "lane-0", 1: "lane-1"}
    assert [h["lane"] for h in sup.health()] == ["lane-0", "lane-1"]
    sup.close()


def test_ingest_queue_is_thread_safe():
    q = IngestQueue()
    n_threads, per = 8, 200

    def feed(t):
        for i in range(per):
            q.append((t, i))

    threads = [threading.Thread(target=feed, args=(t,)) for t in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    items = q.drain()
    assert len(items) == n_threads * per and len(q) == 0 and q.drain() == []
    for t in range(n_threads):
        assert [i for tt, i in items if tt == t] == list(range(per))


# ---------------------------------------------------------------------------
# Elasticity: spawn / retire / retune
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("lanes", [None, "threads"])
def test_spawn_and_retire_mid_scene_are_lossless(detector, lane_scene, lanes):
    audio, schedule, ref_scores, ref_events = lane_scene
    sup = _fleet(detector, 6, 1, lanes=lanes)
    third = len(schedule) // 3
    scores = {s: [] for s in range(6)}

    def play(rounds):
        for rnd in rounds:
            for s, lo, hi in rnd:
                sup.push(s, audio[s, lo:hi])
            for ws in sup.step():
                scores[ws.stream].append(ws.p_uav)

    play(schedule[:third])
    assert sup.spawn_worker() == 1 and sup.n_live_workers == 2
    assert sup.workers[0].streams == [0, 1, 2] and sup.workers[1].streams == [3, 4, 5]
    assert sup._route[4] == (1, 1)
    play(schedule[third:2 * third])
    assert sup.retire_worker(1) and sup.n_live_workers == 1
    assert sup.workers[0].streams == [0, 1, 2, 3, 4, 5]
    assert [i["kind"] for i in sup.incidents] == ["spawn", "retire"]
    play(schedule[2 * third:])
    while True:
        scored = sup.step()
        if not scored:
            break
        for ws in scored:
            scores[ws.stream].append(ws.p_uav)
    _assert_streams_bitwise(scores, sup.finalize(), ref_scores, ref_events, range(6))
    assert sup.windows_scored == 6 * 5
    sup.close()


def test_spawn_retire_edge_cases(detector):
    sup = _fleet(detector, 2, 2)
    assert sup.retire_worker() is True and sup.retire_worker() is False
    assert sup.n_live_workers == 1
    solo = _fleet(detector, 2, 2)
    assert solo.spawn_worker() is None
    lanes = _fleet(detector, 4, 1, lanes="threads")
    idx = lanes.spawn_worker()
    assert idx == 1
    for s in range(4):
        lanes.push(s, np.zeros(W, np.float32))
    assert sorted(ws.stream for ws in lanes.step()) == [0, 1, 2, 3]
    assert lanes.health()[idx]["lane"] == f"lane-{idx}"
    lanes.close()


def test_retune_admission_updates_every_live_worker(detector):
    sup = _fleet(detector, 4, 2,
                 admission=AdmissionPolicy(max_per_stream_per_round=1, round_budget=2))
    assert sup.admission.round_budget == 2
    sup.retune_admission(dataclasses.replace(sup.admission, round_budget=8))
    assert sup.admission.round_budget == 8
    for w in sup.workers:
        assert w.engine.admission.round_budget == 8 and w.engine.admission.max_streams is None
    sup._revive(sup.workers[0])
    assert sup.workers[0].engine.admission.round_budget == 8


# ---------------------------------------------------------------------------
# The SLO loop
# ---------------------------------------------------------------------------


def test_slo_target_validation():
    with pytest.raises(ValueError, match="min_workers"):
        SLOTarget(min_workers=0)
    with pytest.raises(ValueError, match="max_workers"):
        SLOTarget(min_workers=4, max_workers=2)
    with pytest.raises(ValueError, match="round_p95_ms"):
        SLOTarget(round_p95_ms=0.0)
    with pytest.raises(ValueError, match="max_defer_rate"):
        SLOTarget(max_defer_rate=-0.1)


def test_controller_latency_breach_spawns_and_headroom_retires(detector):
    sup = _fleet(detector, 4, 1)
    ctrl = FleetController(sup, SLOTarget(round_p95_ms=10.0, min_workers=1, max_workers=2),
                           window=4, cooldown_rounds=0)
    for _ in range(3):
        assert ctrl.step(50.0) is None
    action = ctrl.step(50.0)
    assert action is not None and action["kind"] == "spawn" and sup.n_live_workers == 2
    for _ in range(4):
        last = ctrl.step(1.0)
    assert last is not None and last["kind"] == "retire" and sup.n_live_workers == 1
    assert [a["kind"] for a in ctrl.actions] == ["spawn", "retire"]


def test_controller_retunes_budget_at_size_cap(detector):
    sup = _fleet(detector, 4, 2, admission=AdmissionPolicy(round_budget=2))
    ctrl = FleetController(sup, SLOTarget(max_defer_rate=0.2, min_workers=1, max_workers=2),
                           window=2, cooldown_rounds=0)
    rng = np.random.default_rng(61)
    for s in range(4):
        sup.push(s, rng.standard_normal(3 * W).astype(np.float32))
    sup.step()
    action = ctrl.step(1.0)
    assert action is not None and action["kind"] == "retune"
    assert sup.admission.round_budget == 4
    assert all(w.engine.admission.round_budget == 4 for w in sup.workers)


def test_controller_retires_stale_heartbeat_worker(detector):
    sup = _fleet(detector, 4, 2)
    ctrl = FleetController(sup, SLOTarget(max_heartbeat_age_s=30.0, min_workers=1,
                                          max_workers=4), window=2, cooldown_rounds=0)
    for s in range(4):
        sup.push(s, np.zeros(W, np.float32))
    sup.step()
    sup.workers[1].last_heartbeat -= 1000.0
    action = ctrl.step(1.0)
    assert action is not None and action["kind"] == "retire_stale" and action["worker"] == 1
    assert not sup.workers[1].alive and sup.workers[0].streams == [0, 1, 2, 3]


def test_slo_loop_resizes_fleet_losslessly_under_bursty_arrivals(detector):
    n_streams, burst = 8, 3
    kw = dict(capacity_windows=burst + 1, admission=AdmissionPolicy(max_per_stream_per_round=1))
    audio = np.random.default_rng(71).standard_normal((n_streams, burst * W)).astype(np.float32)

    def run(engine, ctrl=None):
        scores = {s: [] for s in range(n_streams)}
        for wave in range(2):
            for s in range(n_streams):
                lo = wave * burst * W // 2
                engine.push(s, audio[s, lo:lo + burst * W // 2])
            for _ in range(6):
                for ws in engine.step():
                    scores[ws.stream].append(ws.p_uav)
                if ctrl is not None:
                    ctrl.step(1.0)
        while True:
            scored = engine.step()
            if not scored:
                return scores
            for ws in scored:
                scores[ws.stream].append(ws.p_uav)

    mono = _mono(detector, n_streams, **kw)
    ref_scores = run(mono)
    sup = _fleet(detector, n_streams, 1, **kw)
    ctrl = FleetController(sup, SLOTarget(max_defer_rate=0.3, min_workers=1, max_workers=4),
                           window=3, cooldown_rounds=1, scale_down_margin=0.5)
    scores = run(sup, ctrl)
    kinds = [a["kind"] for a in ctrl.actions]
    assert "spawn" in kinds and "retire" in kinds, kinds
    assert max(a["metrics"]["n_live"] for a in ctrl.actions) >= 2
    assert sum(len(v) for v in scores.values()) == n_streams * burst
    _assert_streams_bitwise(scores, sup.finalize(), ref_scores, mono.finalize(),
                            range(n_streams))


def test_launch_counter_is_exact_under_threads():
    """Fleet lanes count kernel launches from several threads at once: with
    the interpreter switching threads every microsecond, no count is lost."""
    import sys

    from repro_torch.kernels import backend

    def wrapper():
        pass

    wrapper.launches = 0
    n_threads, per = 16, 2000
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [backend.count_launch(wrapper)
                                                    for _ in range(per)])
                   for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert wrapper.launches == n_threads * per
