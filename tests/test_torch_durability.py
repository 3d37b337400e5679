"""The port's durable fleet state against the reference's.

The port's ``repro_torch.serving.durability`` is byte-compatible with
``repro.serving.durability``: for the same engine state both packages'
``snapshot_bytes()`` are the same bytes, each package's ``loads_state``
reads the other's bytes back field for field, frames and WAL records are
laid out the same, and a state dir written by one fleet restores into the
other.  The CRC framing, ``write_atomic``, ``CheckpointStore`` retention
and corrupt-newest fallback, ``ChunkWAL`` replay with torn-tail truncation
and fsync counts, ``FaultyFilesystem`` and the disk fault kinds mirror
``tests/test_durability.py``; the cold restart of the port's fleet (a
clean crash, a crash mid-round under a fault plan, and with execution
lanes) equals the uninterrupted run bitwise, and the uninterrupted run
equals the reference fleet's.
"""
import dataclasses
import errno
import os

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.models import cnn1d as jcnn  # noqa: E402
from repro.serving import durability as jdur  # noqa: E402
from repro.serving import quantized_params as jqp  # noqa: E402
from repro.serving.engine import MonitorEngine as JEngine  # noqa: E402
from repro.serving.engine import SanitizePolicy as JSanitize  # noqa: E402
from repro.serving.faults import FaultClock as JClock  # noqa: E402
from repro.serving.faults import FaultPlan as JPlan  # noqa: E402
from repro.serving.supervisor import FleetSupervisor as JFleet  # noqa: E402
from repro.serving.tracker import TrackEvent as JEvent  # noqa: E402
from repro_torch.data import features  # noqa: E402
from repro_torch.models import cnn1d as tcnn  # noqa: E402
from repro_torch.serving import faults as tfaults  # noqa: E402
from repro_torch.serving.durability import (  # noqa: E402
    FRAME_HEADER,
    WAL_DROPPED,
    WAL_FAULTED,
    CheckpointStore,
    ChunkWAL,
    CorruptRecord,
    LocalFilesystem,
    dumps_state,
    frame,
    loads_state,
    read_frames,
    write_atomic,
)
from repro_torch.serving.engine import MonitorEngine, SanitizePolicy  # noqa: E402
from repro_torch.serving.faults import (  # noqa: E402
    DISK_KINDS,
    KINDS,
    Fault,
    FaultClock,
    FaultPlan,
    FaultyFilesystem,
    InjectedFault,
)
from repro_torch.serving.quantized_params import load_artifact  # noqa: E402
from repro_torch.serving.supervisor import FleetSupervisor  # noqa: E402
from repro_torch.serving.tracker import TrackEvent  # noqa: E402

torch.set_num_threads(1)

TRACK_KW = dict(ema_alpha=0.7, enter_threshold=0.02, exit_threshold=0.01, min_duration=1)
ENGINE_KW = dict(feature_kind="zcr", batch_slots=2, **TRACK_KW)
SUP_KW = dict(ENGINE_KW, sanitize=SanitizePolicy(nonfinite="reject"), device="cpu")
J_SUP_KW = dict(ENGINE_KW, sanitize=JSanitize(nonfinite="reject"))
N_STREAMS, N_WORKERS, N_ROUNDS = 6, 2, 16


@pytest.fixture(scope="module")
def detector(tmp_path_factory):
    """The reference's small detector baked once by JAX, and the same
    artifact carried into the port through ``save_artifact`` /
    ``load_artifact``: {mode: (jax cfg, jax artifact, port cfg, port artifact)}."""
    cfg = jcnn.CNNConfig(input_len=features.FEATURE_DIMS["zcr"], channels=(4, 8), hidden=8)
    params = jcnn.init_params(jax.random.PRNGKey(0), cfg)
    tcfg = tcnn.CNNConfig(input_len=cfg.input_len, channels=(4, 8), hidden=8)
    out = {}
    for mode in ("int8", "fxp8"):
        jart = jqp.quantize_params(params, cfg, mode=mode)
        path = tmp_path_factory.mktemp("art") / f"{mode}.npz"
        jqp.save_artifact(path, jart)
        out[mode] = (cfg, jart, tcfg, load_artifact(path, device="cpu"))
    return out


def _plain(x):
    """A decoded state with every TrackEvent as a tuple, so the two
    packages' (distinct) event classes compare by value."""
    if isinstance(x, (TrackEvent, JEvent)):
        return ("ev", *dataclasses.astuple(x))
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_plain(v) for v in x)
    return x


def _assert_state_equal(a, b, path="$"):
    """Exact equality: dtypes, shapes, scalar types and values."""
    if isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray), f"{path}: {type(b)} is not ndarray"
        assert a.dtype == b.dtype and a.shape == b.shape, f"{path}: {a.dtype}{a.shape}"
        np.testing.assert_array_equal(a, b, err_msg=path)
    elif isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), f"{path}: keys differ"
        for k in a:
            _assert_state_equal(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), f"{path}: {a} != {b}"
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_state_equal(x, y, f"{path}[{i}]")
    else:
        assert type(a) is type(b), f"{path}: {type(a)} != {type(b)}"
        assert a == b, f"{path}: {a!r} != {b!r}"


# ---------------------------------------------------------------------------
# CRC framing and the exact state codec
# ---------------------------------------------------------------------------


def test_frame_roundtrip_and_damage_detection():
    payloads = [b"alpha", b"bravo-bravo", b"charlie" * 9]
    blob = b"".join(frame(p) for p in payloads)
    assert blob == b"".join(jdur.frame(p) for p in payloads)
    out, clean = read_frames(blob)
    assert out == payloads and clean == len(blob)
    out, clean = read_frames(blob[:-3])  # torn tail
    assert out == payloads[:2]
    assert clean == len(frame(payloads[0])) + len(frame(payloads[1]))
    rot = bytearray(blob)  # bit rot mid-stream
    rot[len(frame(payloads[0])) + FRAME_HEADER.size + 2] ^= 0x10
    out, clean = read_frames(bytes(rot))
    assert out == payloads[:1] and clean == len(frame(payloads[0]))
    assert jdur.read_frames(bytes(rot)) == (out, clean)
    out, clean = read_frames(frame(b""))
    assert out == [b""] and clean == FRAME_HEADER.size


def _codec_payload(event_cls):
    return {
        "f32": np.linspace(-1.0, 1.0, 7, dtype=np.float32),
        "f64": np.array([1e-300, np.pi, -0.0]),
        "i64": np.arange(-3, 4, dtype=np.int64),
        "bools": np.array([True, False, True]),
        "mat": np.arange(6, dtype=np.float32).reshape(2, 3),
        "scalar_i": np.int64(-7),
        "scalar_f": np.float32(0.1),
        3: "int keys survive",
        "tuple": (1, 2.5, "x", None),
        "set": {4, 1, 2},
        "events": [event_cls(onset_idx=1, offset_idx=5, peak_score=0.9, mean_score=0.5)],
        "nested": {"d": {0: np.float64(2.0)}, "l": [[1], [2, 3]]},
    }


def test_state_codec_exact_roundtrip_and_reference_bytes():
    payload = _codec_payload(TrackEvent)
    blob = dumps_state(payload)
    assert blob == jdur.dumps_state(_codec_payload(JEvent))
    out = loads_state(blob)
    _assert_state_equal(_plain(payload), _plain(out))
    assert isinstance(out["events"][0], TrackEvent)
    assert dumps_state(out) == blob
    assert loads_state(dumps_state(np.bool_(True))) is True
    with pytest.raises(TypeError):
        dumps_state(object())
    with pytest.raises(TypeError, match="Tensor"):
        dumps_state({"x": torch.zeros(2)})  # a snapshot holds numpy only
    with pytest.raises(CorruptRecord):
        loads_state(b"\x01\x02\x03")


def _scene(seed, n_streams, n_rounds):
    rng = np.random.default_rng(seed)
    return [
        [(s, rng.normal(size=int(rng.uniform(0.4, 1.6) * features.N_SAMPLES)).astype(np.float32))
         for s in range(n_streams)]
        for _ in range(n_rounds)
    ]


@pytest.mark.parametrize("mode", ["int8", "fxp8"])
def test_engine_snapshot_bytes_equal_reference(detector, mode):
    """For the same pushes and rounds the port engine's ``snapshot_bytes``
    are the reference engine's, byte for byte, at every round; each
    package's ``loads_state`` reads the other's bytes back field for field,
    and each engine restores the other's snapshot and serves on equal."""
    cfg, jart, tcfg, tart = detector[mode]
    jeng = JEngine(jart, cfg, n_streams=3, interpret=True, **ENGINE_KW)
    teng = MonitorEngine(tart, tcfg, n_streams=3, device="cpu", **ENGINE_KW)
    schedule = _scene(11, 3, 6)
    for pushes in schedule[:5]:
        for s, chunk in pushes:
            jeng.push(s, chunk)
            teng.push(s, chunk)
        assert [dataclasses.astuple(w) for w in teng.step()] == \
            [dataclasses.astuple(w) for w in jeng.step()]
        assert teng.snapshot_bytes() == jeng.snapshot_bytes()
    tblob, jblob = teng.snapshot_bytes(), jeng.snapshot_bytes()
    _assert_state_equal(_plain(loads_state(jblob)), _plain(teng.snapshot()))
    _assert_state_equal(_plain(jdur.loads_state(tblob)), _plain(jeng.snapshot()))

    # cross-restore, then both serve the last round on equal
    t2 = MonitorEngine(tart, tcfg, n_streams=3, device="cpu", **ENGINE_KW)
    t2.restore_bytes(jblob)
    j2 = JEngine(jart, cfg, n_streams=3, interpret=True, **ENGINE_KW)
    j2.restore_bytes(tblob)
    for s, chunk in schedule[5]:
        t2.push(s, chunk)
        j2.push(s, chunk)
    assert [dataclasses.astuple(w) for w in t2.drain()] == \
        [dataclasses.astuple(w) for w in j2.drain()]
    t2.finalize(), j2.finalize()  # closed tracks ride the snapshot as events
    assert sum(len(e) for e in t2.snapshot()["tracker"]["events"]) > 0
    assert t2.snapshot_bytes() == j2.snapshot_bytes()


# ---------------------------------------------------------------------------
# CheckpointStore, write_atomic, ChunkWAL
# ---------------------------------------------------------------------------


def test_checkpoint_store_retention_and_corrupt_fallback(tmp_path):
    store = CheckpointStore(str(tmp_path / "ck"), retain=2)
    jstore = jdur.CheckpointStore(str(tmp_path / "jck"), retain=2)
    for v in range(1, 6):
        store.save(v, {"v": v, "arr": np.full(3, v, np.int64)})
        jstore.save(v, {"v": v, "arr": np.full(3, v, np.int64)})
    assert store.versions() == [4, 5]
    for v in (4, 5):  # the same file bytes in both packages
        assert store.fs.read_bytes(store._path(v)) == jstore.fs.read_bytes(jstore._path(v))
    v, payload = store.load_latest(at_or_before=4)
    assert v == 4 and payload["v"] == 4
    blob = bytearray(store.fs.read_bytes(store._path(5)))
    blob[-1] ^= 0xFF
    with open(store._path(5), "wb") as fh:
        fh.write(bytes(blob))
    with pytest.raises(CorruptRecord):
        store.load(5)
    v, payload = store.load_latest()
    assert v == 4 and payload["v"] == 4 and store.corrupt_skipped == 1
    assert CheckpointStore(str(tmp_path / "empty")).load_latest() is None
    with pytest.raises(ValueError):
        CheckpointStore(str(tmp_path / "bad"), retain=0)


def test_write_atomic_publishes_all_or_nothing(tmp_path):
    fs = FaultyFilesystem(LocalFilesystem(), FaultPlan([Fault("torn_write", 0, magnitude=0.5)]))
    target = str(tmp_path / "pub.bin")
    with pytest.raises(InjectedFault):
        write_atomic(fs, target, b"hello world")
    assert not os.path.exists(target) and not os.path.exists(target + ".tmp")
    write_atomic(fs, target, b"hello world")
    assert fs.read_bytes(target) == b"hello world"


def test_chunk_wal_replay_and_tail_truncation(tmp_path):
    path = str(tmp_path / "wal.log")
    wal = ChunkWAL(path, fsync="always")
    jwal = jdur.ChunkWAL(str(tmp_path / "jwal.log"), fsync="always")
    c0 = np.arange(4, dtype=np.float32)
    records = [dict(stream=0, seq=0, round_=1, chunk=c0),
               dict(stream=1, seq=0, round_=1, chunk=c0 * 2.0, flags=WAL_FAULTED),
               dict(stream=0, seq=1, round_=2, flags=WAL_FAULTED | WAL_DROPPED)]
    for rec in records:
        wal.append(**rec)
        jwal.append(**rec)
    assert wal.fs.read_bytes(path) == jwal.fs.read_bytes(jwal.path)  # same journal bytes
    recs = wal.replay()
    assert [(r.stream, r.seq, r.round, r.flags) for r in recs] == [
        (0, 0, 1, 0), (1, 0, 1, WAL_FAULTED), (0, 1, 2, WAL_FAULTED | WAL_DROPPED)]
    np.testing.assert_array_equal(recs[0].chunk, c0)
    assert recs[0].chunk.dtype == np.float32 and recs[2].chunk.size == 0
    assert wal.truncations == 0
    blob = wal.fs.read_bytes(path)
    wal.fs.truncate(path, len(blob) - 3)  # torn mid-frame
    assert [(r.stream, r.seq) for r in wal.replay()] == [(0, 0), (1, 0)]
    assert wal.truncations == 1 and len(wal.fs.read_bytes(path)) < len(blob) - 3
    assert len(wal.replay()) == 2 and wal.truncations == 1
    with open(path, "ab") as fh:
        fh.write(b"\x00garbage-not-a-frame")
    assert len(wal.replay()) == 2 and wal.truncations == 2
    wal.reset()
    assert wal.replay() == [] and not wal.fs.exists(path)
    wal.close()
    jwal.close()
    with pytest.raises(ValueError):
        ChunkWAL(str(tmp_path / "w2.log"), fsync="sometimes")
    with pytest.raises(ValueError):
        ChunkWAL(str(tmp_path / "w3.log"), fsync_interval=0)


@pytest.mark.parametrize("policy,interval,expect", [("always", 1, 6), ("interval", 3, 2),
                                                    ("never", 1, 0)])
def test_chunk_wal_fsync_policies_count_flushes(tmp_path, policy, interval, expect):
    class CountingFS(LocalFilesystem):
        synced = 0

        def fsync(self, fh):
            self.synced += 1
            super().fsync(fh)

    fs = CountingFS()
    wal = ChunkWAL(str(tmp_path / f"{policy}.log"), fs=fs, fsync=policy, fsync_interval=interval)
    for i in range(6):
        wal.append(stream=0, seq=i, round_=0, chunk=np.zeros(2, np.float32))
    assert fs.synced == expect
    assert len(wal.replay()) == 6


# ---------------------------------------------------------------------------
# FaultyFilesystem and the disk fault kinds
# ---------------------------------------------------------------------------


def test_faulty_filesystem_injects_deterministically(tmp_path):
    plan = FaultPlan([Fault("enospc", 0), Fault("torn_write", 1, magnitude=0.25),
                      Fault("bit_flip", 2, magnitude=3.0)])
    fs = FaultyFilesystem(LocalFilesystem(), plan)
    path = str(tmp_path / "f.bin")
    fh = fs.open_write(path)
    with pytest.raises(OSError) as ei:
        fs.write(fh, b"doomed")
    assert ei.value.errno == errno.ENOSPC
    with pytest.raises(InjectedFault):
        fs.write(fh, b"xxxxxxxx")
    fs.write(fh, b"ABCD")
    fs.close(fh)
    data = fs.read_bytes(path)
    assert data[:2] == b"xx" and len(data) == 6
    assert sum(bin(a ^ b).count("1") for a, b in zip(data[2:], b"ABCD")) == 1
    assert fs.injected == [("enospc", 0), ("torn_write", 1), ("bit_flip", 2)]
    fs2 = FaultyFilesystem(LocalFilesystem(), FaultPlan([Fault("bit_flip", 0, magnitude=40.0)]))
    p2 = str(tmp_path / "framed.bin")
    fh = fs2.open_write(p2)
    fs2.write(fh, frame(b"precious payload"))
    fs2.close(fh)
    assert read_frames(fs2.read_bytes(p2)) == ([], 0)
    clock = FaultClock()  # a slow fsync advances an injected clock
    fs3 = FaultyFilesystem(LocalFilesystem(), FaultPlan([Fault("slow_fsync", 0, magnitude=2.0)]),
                           clock=clock)
    fh = fs3.open_write(str(tmp_path / "s.bin"))
    fs3.fsync(fh)
    fs3.close(fh)
    assert fs3.injected == [("slow_fsync", 0)] and clock.now() > 2.0


@pytest.mark.parametrize("seed", [9, 42])
def test_fault_plan_disk_kinds_generate_equal_reference(tmp_path, capsys, seed):
    gen_kw = dict(n_streams=4, n_workers=2, n_rounds=10, n_faults=12, kinds=KINDS)
    p1 = FaultPlan.generate(seed, **gen_kw)
    assert p1.to_json() == JPlan.generate(seed, **gen_kw).to_json()
    assert p1.faults == FaultPlan.generate(seed, **gen_kw).faults
    assert any(f.kind in DISK_KINDS for f in p1.faults) and p1.has_disk_faults
    assert FaultPlan.from_json(p1.to_json()).faults == p1.faults
    default = FaultPlan.generate(seed, n_streams=4, n_workers=2, n_rounds=10)
    assert not default.has_disk_faults
    with pytest.raises(ValueError, match="unknown fault kind"):
        FaultPlan.generate(0, n_streams=2, n_workers=1, n_rounds=4, kinds=("nope",))
    out = tmp_path / "plan.json"
    tfaults.main(["--seed", str(seed), "--rounds", "6", "--faults", "8",
                  "--kinds", "torn_write,enospc,drop_chunk", "--out", str(out)])
    plan = FaultPlan.from_json(out.read_text())
    assert len(plan.faults) == 8 and {f.kind for f in plan.faults} <= {
        "torn_write", "enospc", "drop_chunk"}
    assert plan.to_json() == JPlan.generate(
        seed, n_streams=8, n_workers=2, n_rounds=6, n_faults=8,
        kinds=("torn_write", "enospc", "drop_chunk")).to_json()
    capsys.readouterr()
    with pytest.raises(SystemExit):
        tfaults.main(["--kinds", "bogus", "--out", str(out)])
    assert "unknown fault kind" in capsys.readouterr().err


# ---------------------------------------------------------------------------
# Cold restart of the port's fleet
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def fleet_scene():
    plan = FaultPlan.generate(42, n_streams=N_STREAMS, n_workers=N_WORKERS, n_rounds=N_ROUNDS,
                              n_faults=6)
    return _scene(7, N_STREAMS, N_ROUNDS), plan


def _plan_kw(plan, package="torch"):
    if plan is None:
        return {}
    cls, clock = (FaultPlan, FaultClock) if package == "torch" else (JPlan, JClock)
    return dict(faults=cls.from_json(plan.to_json()), clock=clock(), dispatch_deadline_s=1.0)


def _fleet(art, plan=None, **kw):
    _, _, tcfg, tart = art
    return FleetSupervisor(tart, tcfg, n_streams=N_STREAMS, n_workers=N_WORKERS,
                           **SUP_KW, **_plan_kw(plan), **kw)


def _jfleet(art, plan=None, **kw):
    cfg, jart, _, _ = art
    return JFleet(jart, cfg, n_streams=N_STREAMS, n_workers=N_WORKERS, **J_SUP_KW,
                  **_plan_kw(plan, "jax"), **kw)


def _drive(sup, schedule, *, start=0, cursor=None, upto=None):
    """Deliver the schedule, skipping what a restored cursor and round say
    is held; ``upto=k`` crashes mid-round k (pushes delivered, no step)."""
    out = []
    cursor = np.zeros(N_STREAMS, np.int64) if cursor is None else cursor
    ordinals = np.zeros(N_STREAMS, np.int64)
    for r, pushes in enumerate(schedule):
        for s, chunk in pushes:
            if ordinals[s] >= cursor[s]:
                sup.push(s, chunk)
            ordinals[s] += 1
        if r < start:
            continue
        if upto is not None and r >= upto:
            return out
        out.extend(sup.step())
    return out


def _score_map(scored):
    return {(w.stream, w.window_idx): (w.p_uav, w.smoothed, w.active) for w in scored}


def _events(evs):
    return [[dataclasses.astuple(e) for e in es] for es in evs]


@pytest.fixture(scope="module")
def references(detector, fleet_scene):
    """Uninterrupted runs, fault-free and under the plan, of the port fleet
    and of the reference fleet (int8): the port's equal the reference's."""
    schedule, plan = fleet_scene
    out = {}
    for key, p in (("clean", None), ("faults", plan)):
        ref = _fleet(detector["int8"], p)
        scores = _score_map(_drive(ref, schedule))
        events = _events(ref.finalize())
        jref = _jfleet(detector["int8"], p)
        assert _score_map(_drive(jref, schedule)) == scores
        assert _events(jref.finalize()) == events
        assert ref.faulted_chunks.tolist() == jref.faulted_chunks.tolist()
        assert len(scores) > 0 and sum(len(e) for e in events) > 0
        out[key] = (scores, events, ref.faulted_chunks.copy())
    return out


def test_cold_restart_bitwise_equal_clean_crash(detector, fleet_scene, references, tmp_path):
    schedule, _ = fleet_scene
    refd, ref_events, _ = references["clean"]
    d = str(tmp_path / "state")
    sup1 = _fleet(detector["int8"], state_dir=d)
    merged = _score_map(_drive(sup1, schedule[:7]))
    del sup1  # the crash: no close()
    _, _, tcfg, tart = detector["int8"]
    sup2 = FleetSupervisor.restore_from_dir(tart, tcfg, state_dir=d, **SUP_KW)
    assert sup2 is not None and sup2.round == 7 and sup2.replayed_chunks == 0
    for k, v in _score_map(_drive(sup2, schedule, start=sup2.round,
                                  cursor=sup2.pushed_chunks.copy())).items():
        assert merged.get(k, v) == v, f"overlap mismatch at {k}"
        merged[k] = v
    assert merged == refd
    assert _events(sup2.finalize()) == ref_events


@pytest.mark.parametrize("lanes,upto", [(None, 6), ("threads", 9)])
def test_cold_restart_bitwise_equal_midround_crash_with_faults(
        detector, fleet_scene, references, tmp_path, lanes, upto):
    """A crash mid-round (the round's chunks pushed, ``step`` never ran)
    under the seeded plan, sequential and with lanes: scores, events and
    fault counters equal the uninterrupted faulted run."""
    schedule, plan = fleet_scene
    refd, ref_events, ref_faulted = references["faults"]
    d = str(tmp_path / "state")
    sup1 = _fleet(detector["int8"], plan, state_dir=d, lanes=lanes)
    merged = _score_map(_drive(sup1, schedule, upto=upto))
    del sup1
    _, _, tcfg, tart = detector["int8"]
    sup2 = FleetSupervisor.restore_from_dir(tart, tcfg, state_dir=d, lanes=lanes,
                                            **SUP_KW, **_plan_kw(plan))
    assert sup2 is not None
    if lanes is None:
        assert sup2.replayed_chunks > 0  # the WAL did work
    s2 = _drive(sup2, schedule, start=sup2.round, cursor=sup2.pushed_chunks.copy())
    sup2.close()
    for k, v in _score_map(s2).items():
        assert merged.get(k, v) == v, f"overlap mismatch at {k}"
        merged[k] = v
    assert merged == refd
    assert _events(sup2.finalize()) == ref_events
    assert sup2.faulted_chunks.tolist() == ref_faulted.tolist()


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_state_dir_restores_across_frameworks(detector, fleet_scene, references, tmp_path,
                                              writer):
    """A state dir written by one package's fleet (abandoned mid-round under
    the plan) restores into the other's: the later scores and the events
    equal the uninterrupted run (int8)."""
    schedule, plan = fleet_scene
    refd, ref_events, ref_faulted = references["faults"]
    cfg, jart, tcfg, tart = detector["int8"]
    d = str(tmp_path / "state")
    make = _jfleet if writer == "jax" else _fleet
    sup1 = make(detector["int8"], plan, state_dir=d)
    merged = _score_map(_drive(sup1, schedule, upto=6))
    del sup1
    if writer == "jax":
        sup2 = FleetSupervisor.restore_from_dir(tart, tcfg, state_dir=d, **SUP_KW,
                                                **_plan_kw(plan))
    else:
        sup2 = JFleet.restore_from_dir(jart, cfg, state_dir=d, **J_SUP_KW,
                                       **_plan_kw(plan, "jax"))
    assert sup2 is not None and sup2.replayed_chunks > 0
    for k, v in _score_map(_drive(sup2, schedule, start=sup2.round,
                                  cursor=sup2.pushed_chunks.copy())).items():
        assert merged.get(k, v) == v, f"overlap mismatch at {k}"
        merged[k] = v
    assert merged == refd
    assert _events(sup2.finalize()) == ref_events
    assert sup2.faulted_chunks.tolist() == ref_faulted.tolist()


def test_restore_from_empty_dir_returns_none(detector, tmp_path):
    _, _, tcfg, tart = detector["int8"]
    assert FleetSupervisor.restore_from_dir(
        tart, tcfg, state_dir=str(tmp_path / "nothing"), **SUP_KW) is None


def test_supervisor_truncates_torn_wal_tail(detector, tmp_path):
    _, _, tcfg, tart = detector["int8"]
    d = str(tmp_path / "state")
    rng = np.random.default_rng(3)
    chunks = [[rng.standard_normal(features.N_SAMPLES).astype(np.float32) for _ in range(2)]
              for _ in range(3)]
    sup = FleetSupervisor(tart, tcfg, n_streams=2, n_workers=1, state_dir=d, **SUP_KW)
    for r in range(2):
        for s in range(2):
            sup.push(s, chunks[r][s])
        sup.step()
    for s in range(2):  # crash mid-round 2
        sup.push(s, chunks[2][s])
    del sup
    wal_path = os.path.join(d, "worker-000", "wal.log")
    assert os.path.exists(wal_path)
    with open(wal_path, "ab") as fh:
        fh.write(b"\x00half-written-frame")
    sup2 = FleetSupervisor.restore_from_dir(tart, tcfg, state_dir=d, n_streams=2, n_workers=1,
                                            **SUP_KW)
    assert sup2 is not None and sup2.wal_truncations == 1
    assert sup2.replayed_chunks == 2 and sup2.round == 2
    assert len(sup2.step()) > 0


def test_disk_faults_degrade_durability_not_serving(detector, tmp_path):
    _, _, tcfg, tart = detector["int8"]
    plan = FaultPlan([Fault("slow_fsync", 1, magnitude=2.0), Fault("enospc", 2),
                      Fault("torn_write", 5, magnitude=0.5), Fault("bit_flip", 7, magnitude=9.0)])
    sup = FleetSupervisor(tart, tcfg, n_streams=2, n_workers=1,
                          state_dir=str(tmp_path / "state"), faults=plan, clock=FaultClock(),
                          dispatch_deadline_s=30.0, fsync="always", **SUP_KW)
    ref = FleetSupervisor(tart, tcfg, n_streams=2, n_workers=1, **SUP_KW)
    rng = np.random.default_rng(5)
    scored, ref_scored = [], []
    for _ in range(4):
        for s in range(2):
            chunk = rng.standard_normal(features.N_SAMPLES).astype(np.float32)
            sup.push(s, chunk)
            ref.push(s, chunk)
        scored.extend(sup.step())
        ref_scored.extend(ref.step())
    sup.close()
    assert isinstance(sup._fs, FaultyFilesystem) and sup._fs.injected
    assert sup.wal_errors + sup.ckpt_errors >= 1
    assert _score_map(scored) == _score_map(ref_scored)
    assert _events(sup.finalize()) == _events(ref.finalize())
