"""The port's driver, ``python -m repro_torch.launch.monitor``, against the
reference's.

``synth_scene`` draws the reference's scenes bit for bit; ``main`` serves
seeded random weights, and a baked artifact with the front-end on the
device, where its scores and events equal the reference ``MonitorEngine``
fed the same delivery schedule; every fleet flag serves through the
port's ``FleetSupervisor`` with the events of the plain run (a rerun on the
same ``--state-dir`` resumes, and ends with the same events); ``--shards``
serves the plain run's scores and events, alone and with the fleet; the
default path quick-trains a detector and ``--trained`` serves the cached
one, both on the card unless ``--device cpu``.
"""
import dataclasses
import functools
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro.launch.monitor import synth_scene as j_synth_scene  # noqa: E402
from repro.models import cnn1d as jcnn  # noqa: E402
from repro.serving.engine import MonitorEngine as JEngine  # noqa: E402
from repro.serving.quantized_params import load_artifact as j_load  # noqa: E402
from repro_torch.data import features  # noqa: E402
from repro_torch.launch import monitor  # noqa: E402
from repro_torch.serving.faults import Fault, FaultPlan  # noqa: E402
from repro_torch.serving.supervisor import FleetSupervisor  # noqa: E402
from repro_torch.training import detector_artifact as tdet  # noqa: E402

torch.set_num_threads(1)

GOLDEN = Path(__file__).resolve().parents[1] / "artifacts" / "golden"
ONDEVICE = str(GOLDEN / "detector_int8_ondevice.npz")


@pytest.mark.parametrize("seed,seconds", [(0, 2.0), (7, 4.0), (123, 6.4)])
def test_synth_scene_bitwise_equal_to_reference(seed, seconds):
    j_rng, t_rng = np.random.default_rng(seed), np.random.default_rng(seed)
    for _ in range(2):
        want, want_truth = j_synth_scene(seconds, j_rng)
        got, got_truth = monitor.synth_scene(seconds, t_rng)
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
        assert got_truth == want_truth
    assert t_rng.random() == j_rng.random()  # same number of draws


def test_main_serves_random_weights(capsys):
    run = monitor.main(["--random", "--device", "cpu", "--seconds", "2", "--streams", "3"])
    out = capsys.readouterr().out
    assert run.engine.windows_scored == 3 * 2 == len(run.scores)
    assert len(run.events) == 3 and len(run.round_seconds) >= 1
    assert "monitor: --random weights" in out and "windows/s" in out
    assert "stream 2: ground truth UAV" in out


def test_main_on_device_artifact_matches_reference_engine(capsys):
    argv = ["--artifact", ONDEVICE, "--device-features", "--device", "cpu",
            "--streams", "3", "--seconds", "4", "--slots", "2", "--seed", "5"]
    run = monitor.main(argv)
    out = capsys.readouterr().out
    assert "on-device zcr front-end" in out
    assert run.engine.on_device_features and run.engine.artifact.feature_kind == "zcr"

    # the reference engine, fed the same scenes through the same schedule
    rng = np.random.default_rng(5 + 1)
    scenes = [j_synth_scene(4.0, rng)[0] for _ in range(3)]
    schedule = monitor.delivery_schedule(scenes, rng)
    cfg = jcnn.CNNConfig(input_len=features.FEATURE_DIMS["zcr"], channels=(4, 8), hidden=8)
    jeng = JEngine(j_load(ONDEVICE), cfg, n_streams=3, feature_kind="zcr",
                   on_device_features=True, batch_slots=2, interpret=True)
    want = []
    for pushes in schedule:
        for s, lo, hi in pushes:
            jeng.push(s, scenes[s][lo:hi])
        want.extend(jeng.step())
    want.extend(jeng.drain())
    assert [dataclasses.astuple(w) for w in run.scores] == [dataclasses.astuple(w) for w in want]
    assert [[dataclasses.astuple(e) for e in evs] for evs in run.events] == \
        [[dataclasses.astuple(e) for e in evs] for evs in jeng.finalize()]
    assert len(run.scores) == 3 * 5


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA device")


@pytest.mark.parametrize("extra", [[], ["--trained"]])
def test_training_paths_raise_without_gpu_unless_cpu(no_card, monkeypatch, extra):
    """The default quick-train path and ``--trained`` ask for the card
    first: without one they exit before any training or corpus work."""
    def never(*a, **k):
        raise AssertionError("trained without a device")

    monkeypatch.setattr(monitor, "quick_detector", never)
    monkeypatch.setattr(tdet, "get_detector", never)
    with pytest.raises(SystemExit, match="no CUDA device"):
        monitor.main([*extra, "--seconds", "2", "--streams", "2"])


def test_main_quick_trains_a_detector_by_default(capsys, monkeypatch):
    """Neither --artifact nor --random: a psd detector (SMALL_CFG) is
    trained in process, at a tiny corpus here, and serves; the seeded
    training is deterministic, so a rerun serves the same scores."""
    monkeypatch.setattr(monitor, "quick_detector", functools.partial(monitor.quick_detector, n=40))
    argv = ["--device", "cpu", "--seconds", "2", "--streams", "2"]
    run = monitor.main(argv)
    out = capsys.readouterr().out
    assert "monitor: quick-trained psd detector, val_acc=" in out
    assert "--random" not in out and run.engine.windows_scored == 2 * 2 == len(run.scores)
    assert run.engine.artifact.convs[0]["w"].q.shape == (3, 1, 4)  # SMALL_CFG, int8
    again = monitor.main(argv)
    assert [dataclasses.astuple(w) for w in again.scores] == \
        [dataclasses.astuple(w) for w in run.scores]


def test_main_trained_serves_the_cached_detector(tmp_path, capsys, monkeypatch):
    """``--trained`` serves ``get_detector(feature)``: the first run trains
    the canonical widths on a tiny corpus and caches it, the second
    restores the cache and serves the same scores."""
    monkeypatch.setattr(tdet, "ARTIFACTS", tmp_path)
    monkeypatch.setattr(tdet, "DATASET", dict(n=96, seed=7, snr_range=(-12.0, 18.0), p_clean=0.08))
    monkeypatch.setattr(tdet, "SPLIT", (72, 12))
    argv = ["--trained", "--feature", "zcr", "--device", "cpu", "--seconds", "2",
            "--streams", "2"]
    first = monitor.main(argv)
    assert (tmp_path / "model_zcr" / "step_0000000001" / "MANIFEST.json").exists()
    assert first.engine.artifact.convs[2]["w"].q.shape == (3, 128, 256)  # canonical widths
    second = monitor.main(argv)
    assert len(first.scores) == 2 * 2
    assert [dataclasses.astuple(w) for w in second.scores] == \
        [dataclasses.astuple(w) for w in first.scores]
    with pytest.raises(SystemExit):
        monitor.main(["--trained", "--artifact", ONDEVICE, "--device", "cpu"])


def test_artifact_flag_errors(capsys):
    with pytest.raises(SystemExit) as exc:
        monitor.main(["--artifact", ONDEVICE, "--prune", "2", "--device", "cpu"])
    assert exc.value.code == 2 and "baked --artifact" in capsys.readouterr().err
    with pytest.raises(SystemExit, match="flatten"):
        monitor.main(["--artifact", ONDEVICE, "--feature", "psd", "--device", "cpu"])
    with pytest.raises(SystemExit, match="baked for feature kind"):
        monitor.main(["--artifact", str(GOLDEN / "detector_int8.npz"), "--feature", "zcr",
                      "--device-features", "--device", "cpu"])


#: a lossless plan for the driver's 3 x 2 s scene: crash, stall, kill, jitter
LOSSLESS_PLAN = FaultPlan([
    Fault("raise_forward", round=0, worker=0), Fault("stall_forward", round=1, worker=1),
    Fault("kill_worker", round=1, worker=0),
    Fault("jitter_chunk", round=0, stream=2, magnitude=0.5),
], seed=None)
PLAIN = ["--random", "--device", "cpu", "--seconds", "2", "--streams", "3", "--seed", "3"]


@pytest.fixture(scope="module")
def plain_run():
    run = monitor.main(PLAIN)
    return [dataclasses.astuple(w) for w in run.scores], run.events


@pytest.mark.parametrize("extra", [
    ["--workers", "2"], ["--workers", "3", "--lanes", "threads"], ["--faults", "PLAN"],
    ["--lanes", "threads"], ["--autoscale"], ["--state-dir", "STATE"],
    ["--state-dir", "STATE", "--fsync", "always"],
    ["--state-dir", "STATE", "--checkpoint-interval", "2", "--lanes", "threads"],
])
def test_fleet_flags_serve_with_the_plain_runs_events(plain_run, tmp_path, capsys, extra):
    plan = tmp_path / "plan.json"
    plan.write_text(LOSSLESS_PLAN.to_json())
    argv = [*PLAIN, *(str(plan) if a == "PLAN" else str(tmp_path / "state") if a == "STATE"
                      else a for a in extra)]
    run = monitor.main(argv)
    out = capsys.readouterr().out
    assert isinstance(run.engine, FleetSupervisor)
    want_workers = int(extra[1]) if extra[0] == "--workers" else 2
    assert f"fleet supervisor, {want_workers} worker(s)" in out
    scores, events = plain_run
    assert sorted(dataclasses.astuple(w) for w in run.scores) == sorted(scores)
    assert run.events == events
    if "--faults" in extra:
        assert "survived 3 incident(s)" in out  # the jitter is no incident
    if "--autoscale" in extra:
        assert "SLO autoscaler on" in out and "autoscaler took" in out
    if "--state-dir" in extra:  # a rerun resumes from the state dir, same events
        again = monitor.main(argv)
        assert "resumed from state dir" in capsys.readouterr().out
        assert again.events == events


@pytest.mark.parametrize("extra", [["--shards", "1"], ["--shards", "4", "--slots", "8"],
                                   ["--shards", "2", "--workers", "2"]])
def test_shards_flag_serves_with_the_plain_runs_events(plain_run, capsys, extra):
    """``--shards k`` (ROADMAP M8) on the CPU: k CPU entries, every slot
    block split over them, the plain run's scores and events; with the
    fleet flags every worker's engine shards its blocks."""
    run = monitor.main([*PLAIN, *extra])
    out = capsys.readouterr().out
    k = int(extra[1])
    assert f"sharded dispatch over {k} device(s)" in out
    engines = [w.engine for w in run.engine.workers] if "--workers" in extra else [run.engine]
    assert all(e.shards == k for e in engines)
    scores, events = plain_run
    assert sorted(dataclasses.astuple(w) for w in run.scores) == sorted(scores)
    assert run.events == events
    with pytest.raises(SystemExit, match="divide evenly"):
        monitor.main([*PLAIN, "--shards", "3"])
