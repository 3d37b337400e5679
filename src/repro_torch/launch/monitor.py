"""Multi-stream continuous-monitoring driver of the port —
``python -m repro_torch.launch.monitor --streams 4 --duration 30``.

Counterpart of ``repro/launch/monitor.py``.  Simulates N always-on
microphones: each stream is a synthetic acoustic scene (background clutter
with one UAV pass over a random interval), delivered to the
:class:`~repro_torch.serving.engine.MonitorEngine` in uneven chunks that
never align with window boundaries.  The engine windows each stream,
scores ready windows in micro-batches on the kernel datapath, and the
vectorised tracker's per-stream detection events are printed against the
known ground-truth pass.  Scenes, chunk schedule, printed lines and the
final summary are the reference driver's, draw for draw.

The weights come from where the reference's do.  By default a small psd
detector (``SMALL_CFG``) is trained in process on the synthetic corpus
(:func:`quick_detector`, the reference's settings); ``--trained`` serves
the cached canonical detector of
:func:`repro_torch.training.detector_artifact.get_detector` (mfcc20
unless ``--feature`` says otherwise), trained and cached on first use,
and wins over ``--random`` as there; ``--random`` serves seeded random
weights (``torch.Generator``, so not the reference's values).  The port adds ``--artifact PATH.npz``, a baked
artifact written by either package (``save_artifact``); ``--prune`` and
``--policy`` are baking decisions, an error with it, as in
``MonitorEngine``.  And ``--device {cuda,cpu}``, CUDA by default: PyTorch
needs the device named, where JAX picks it itself.  Without a GPU,
``cuda`` fails before any training.

The fleet flags serve through the port's
:class:`~repro_torch.serving.supervisor.FleetSupervisor` as the
reference's do: ``--workers N``; ``--faults PLAN.json`` (written by
``python -m repro_torch.serving.faults`` or the reference's CLI, the same
plan), ``--lanes threads``, ``--autoscale`` and ``--state-dir DIR`` each
imply ``--workers 2``; ``--fsync`` and ``--checkpoint-interval`` tune
``--state-dir``.  A rerun with the same ``--state-dir`` and seed resumes
from :meth:`~repro_torch.serving.supervisor.FleetSupervisor.restore_from_dir`
and re-delivers only what the restored fleet does not hold.  ``--shards k``
splits every slot block over ``k`` devices, as in the reference: ``k``
cards with ``--device cuda`` (fewer cards is an error), ``k`` CPU entries
with ``--device cpu``; with the fleet flags every worker's engine shards
its blocks.  :func:`main` returns a :class:`MonitorRun`
(engine or fleet, scores, events, scenes, timings) instead of the events
alone.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
import time

import numpy as np
import torch

from repro_torch.data import acoustic, features
from repro_torch.kernels.backend import resolve_device
from repro_torch.models import cnn1d
from repro_torch.serving.engine import MonitorEngine, SanitizePolicy, WindowScore
from repro_torch.serving.quantized_params import QuantizedParams, load_artifact, quantize_params
from repro_torch.serving.supervisor import FleetSupervisor
from repro_torch.serving.tracker import TrackEvent

SMALL_CFG = dict(channels=(4, 8), hidden=8)


def quick_detector(kind: str, cfg: cnn1d.CNNConfig, *, n: int = 240, seed: int = 0,
                   device="cuda") -> dict:
    """Train a small detector in process on the synthetic corpus (the
    reference's settings), on ``device``."""
    from repro_torch.training import loop

    ds = acoustic.make_dataset(n, seed=seed, snr_range=(0.0, 20.0))
    feats = features.batch_features(ds.audio, kind)
    n_tr = int(0.8 * n)
    res = loop.train_detector(
        feats[:n_tr], ds.labels[:n_tr], feats[n_tr:], ds.labels[n_tr:],
        cfg, epochs=12, batch=32, patience=12, device=device,
    )
    print(f"monitor: quick-trained {kind} detector, val_acc={res.best_val_acc:.2f}")
    return res.params


def synth_scene(seconds: float, rng: np.random.Generator):
    """One stream's audio: background everywhere except one UAV pass.

    Returns (samples, (t_on, t_off)) with the pass interval in seconds.
    """
    n_win = max(1, int(seconds / features.WINDOW_S))
    if n_win >= 6:
        on = int(rng.integers(1, n_win - 4))
        off = int(min(n_win - 1, on + rng.integers(3, max(4, n_win // 2))))
    else:
        on, off = 0, n_win  # short scene: all UAV
    wins = []
    for i in range(n_win):
        x = acoustic.synth_uav(rng) if on <= i < off else acoustic.synth_background(rng)
        wins.append(acoustic.add_noise_snr(x, float(rng.uniform(8, 20)), rng))
    return np.concatenate(wins), (on * features.WINDOW_S, off * features.WINDOW_S)


def delivery_schedule(scenes, rng: np.random.Generator) -> list[list[tuple[int, int, int]]]:
    """Uneven chunk deliveries, one engine round per entry: one chunk-size
    draw per stream per round, finished streams included (the reference's
    draw order), as ``(stream, lo, hi)`` slices."""
    schedule = []
    cursors = [0] * len(scenes)
    while any(c < len(s) for c, s in zip(cursors, scenes)):
        round_pushes = []
        for s in range(len(scenes)):
            chunk = int(rng.uniform(0.3, 1.7) * features.N_SAMPLES)
            if cursors[s] < len(scenes[s]):
                round_pushes.append((s, cursors[s], cursors[s] + chunk))
                cursors[s] += chunk
        schedule.append(round_pushes)
    return schedule


def config_for_artifact(qp: QuantizedParams, feature_kind: str) -> cnn1d.CNNConfig:
    """The model configuration an artifact serves for ``feature_kind``
    inputs (channels, taps and widths read from its layers)."""
    channels = tuple(int(layer["b"].numel()) for layer in qp.convs)
    cfg = cnn1d.CNNConfig(
        input_len=features.FEATURE_DIMS[feature_kind],
        channels=channels,
        kernel=int(qp.convs[0]["w"].shape[0]),
        hidden=int(qp.denses[0]["b"].numel()),
        n_classes=int(qp.denses[1]["b"].numel()),
    )
    frames = qp.keep_frames if qp.keep_frames is not None else cfg.n_frames
    flatten = int(qp.denses[0]["w"].shape[0])
    if frames * channels[-1] != flatten:
        raise SystemExit(
            f"monitor: the artifact's dense0 takes {flatten} inputs, but "
            f"{feature_kind} features ({cfg.input_len} values) flatten to "
            f"{frames * channels[-1]}; pass the --feature it was trained on"
        )
    return cfg


@dataclasses.dataclass
class MonitorRun:
    """What one driver run served."""

    engine: MonitorEngine | FleetSupervisor
    scores: list[WindowScore]
    events: list[list[TrackEvent]]
    scenes: list[np.ndarray]
    truths: list[tuple[float, float]]
    seconds: float  # wall time of the serving loop
    round_seconds: list[float]  # wall time of each step() that scored windows


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--streams", type=int, default=4)
    ap.add_argument("--duration", "--seconds", type=float, default=16.0,
                    dest="duration", help="seconds per stream")
    ap.add_argument("--precision", choices=("int8", "fxp8"), default="int8")
    ap.add_argument("--prune", type=int, default=None, metavar="KEEP",
                    help="bake a structured channel prune into the served "
                         "artifact: keep this many output channels of the "
                         "last conv block (+1 boundary-frame trim, paper "
                         "SIII-C)")
    ap.add_argument("--policy", default=None, metavar="SPEC",
                    help="bake a per-layer precision policy into the served "
                         "artifact: a PrecisionPolicy JSON file/string, or "
                         "inline 'conv0/w=bf16,dense1/w=fp32' rules "
                         "(default mode = --precision)")
    ap.add_argument("--shards", type=int, default=None,
                    help="shard each micro-batch over this many devices "
                         "(sharded-batch dispatch; bitwise-identical results)")
    ap.add_argument("--feature", default=None, choices=sorted(features.FEATURE_DIMS),
                    help="feature set (default: the artifact's baked kind, mfcc20 "
                         "with --trained, else psd)")
    ap.add_argument("--device-features", action="store_true",
                    help="run the DSP front-end on the device (the engine "
                         "submits raw windows; no host feature extraction on "
                         "the serving path)")
    ap.add_argument("--slots", type=int, default=8, help="micro-batch slot count")
    ap.add_argument("--adaptive-slots", action="store_true",
                    help="grow/shrink micro-batch blocks over a power-of-two "
                         "slot ladder to fit the ready backlog instead of "
                         "padding dead slots with silence (bitwise-identical "
                         "scores; every shape is warmed up front)")
    ap.add_argument("--max-streams", type=int, default=None, metavar="N",
                    help="admit at most N distinct streams (first come, "
                         "first served); chunks for later streams are "
                         "refused and counted, never scored")
    ap.add_argument("--workers", type=int, default=None, metavar="N",
                    help="serve through the fault-tolerant fleet supervisor "
                         "with N health-checked workers instead of one "
                         "monolithic engine (bitwise-identical results)")
    ap.add_argument("--faults", default=None, metavar="PLAN.json",
                    help="inject a deterministic fault plan (written by "
                         "python -m repro_torch.serving.faults) through the "
                         "fleet supervisor; implies --workers 2 unless given")
    ap.add_argument("--lanes", choices=("threads",), default=None,
                    help="give each fleet worker a named execution lane "
                         "(thread) so workers' rounds overlap (bitwise-"
                         "identical results); implies --workers 2 unless given")
    ap.add_argument("--autoscale", action="store_true",
                    help="close the SLO loop: a FleetController watches "
                         "round latency and defer/drop rates and resizes "
                         "the fleet against a default target; implies "
                         "--workers 2 unless given")
    ap.add_argument("--state-dir", default=None, metavar="DIR",
                    help="durable crash-safe fleet state: per-worker "
                         "checkpoints + write-ahead chunk journals under "
                         "DIR; rerun with the same DIR (and seed) after a "
                         "SIGKILL to resume bitwise where the fleet left "
                         "off; implies --workers 2 unless given")
    ap.add_argument("--fsync", choices=("always", "interval", "never"),
                    default="interval", help="WAL fsync policy with --state-dir")
    ap.add_argument("--checkpoint-interval", type=int, default=1, metavar="R",
                    help="checkpoint every R rounds with --state-dir (R>1 "
                         "lowers overhead; 1 is the exact-restart setting)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--random", action="store_true",
                    help="seeded random-init weights (plumbing smoke, no real detections)")
    ap.add_argument("--artifact", default=None, metavar="PATH.npz",
                    help="serve a baked artifact (save_artifact of either package)")
    ap.add_argument("--trained", action="store_true",
                    help="the cached canonical detector (trained and cached under "
                         "artifacts/detector_torch/ on first use)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    return ap


def _build_engine(args, ap: argparse.ArgumentParser) -> MonitorEngine | FleetSupervisor:
    try:
        dev = resolve_device(args.device)
    except RuntimeError as exc:
        raise SystemExit(f"monitor: {exc}") from exc
    prune_spec = policy = None
    if args.artifact is not None:
        if args.prune is not None or args.policy is not None:
            ap.error("--prune/--policy are baking decisions and cannot be applied "
                     "to a baked --artifact")
        if args.random or args.trained:
            ap.error("--artifact serves its own weights; drop --random/--trained")
        params = load_artifact(args.artifact, device=dev)
        if args.feature is None:
            args.feature = params.feature_kind or "psd"
        cfg = config_for_artifact(params, args.feature)
        print(f"monitor: serving artifact {args.artifact} "
              f"({params.mode}, flatten {int(params.denses[0]['w'].shape[0])})")
    else:
        if args.feature is None:
            # --trained serves the cached mfcc20 detector; another feature
            # trains a canonical model of its own on a cache miss.
            args.feature = "mfcc20" if args.trained else "psd"
        if args.trained:
            from repro_torch.training.detector_artifact import get_detector

            det = get_detector(args.feature, device=dev)
            params, cfg = det["params"], det["cfg"]
        else:
            cfg = cnn1d.CNNConfig(input_len=features.FEATURE_DIMS[args.feature], **SMALL_CFG)
            if args.random:
                params = cnn1d.init_params(cfg, torch.Generator().manual_seed(args.seed))
                print("monitor: --random weights; probabilities are meaningless")
            else:
                params = quick_detector(args.feature, cfg, seed=args.seed, device=dev)
        # Deploy-time decisions baked into the served artifact (quantise-once).
        if args.prune is not None:
            from repro_torch.core.pruning import plan_prune

            last = len(cfg.channels) - 1
            prune_spec = plan_prune(
                params[f"conv{last}"]["w"], cfg.n_frames, keep=args.prune, trim_frames=1,
            )
            print(
                f"monitor: pruned artifact — flatten {prune_spec.flatten_before} "
                f"-> {prune_spec.flatten_after} (-{prune_spec.reduction:.0%})"
            )
        if args.policy is not None:
            from repro_torch.core.precision_policy import PrecisionPolicy

            policy = PrecisionPolicy.parse(args.policy, default=args.precision)
            modes = {pat: prec.value for pat, prec in sorted(policy.rules.items())}
            print(f"monitor: mixed-precision artifact — {modes}, "
                  f"default {policy.default.value}")

    admission = None
    if args.max_streams is not None:
        from repro_torch.serving.batching import AdmissionPolicy

        admission = AdmissionPolicy(max_streams=args.max_streams)
        print(f"monitor: admission cap {args.max_streams} stream(s)")
    if _fleet_requested(args):
        return _build_fleet(args, params, cfg, dev, prune_spec, policy, admission)
    try:
        return MonitorEngine(
            params, cfg,
            n_streams=args.streams,
            feature_kind=args.feature,
            on_device_features=args.device_features,
            batch_slots=args.slots,
            precision=args.precision,
            prune=prune_spec,
            policy=policy,
            shards=args.shards,
            adaptive_slots=args.adaptive_slots,
            admission=admission,
            device=dev,
        )
    except ValueError as exc:
        raise SystemExit(f"monitor: {exc}") from exc


def _fleet_requested(args) -> bool:
    return (args.workers is not None or args.faults is not None or args.lanes is not None
            or args.autoscale or args.state_dir is not None)


def _build_fleet(args, params, cfg, dev, prune_spec, policy, admission) -> FleetSupervisor:
    """The fleet the fleet flags ask for: resumed from ``--state-dir`` when
    it holds a fleet, else a new one over ``--workers`` (2 by default)."""
    from repro_torch.serving.faults import FaultClock, FaultPlan

    plan = None
    if args.faults is not None:
        with open(args.faults) as fh:
            plan = FaultPlan.from_json(fh.read())
        print(f"monitor: fault plan {args.faults} "
              f"({len(plan.faults)} fault(s), seed {plan.seed})")
    # The supervisor serves an immutable baked artifact (that is what makes
    # rebuilding a dead worker exact): bake the deploy-time decisions here.
    if not isinstance(params, QuantizedParams):
        params = quantize_params(
            params, cfg, mode=args.precision, prune=prune_spec, policy=policy,
            feature_kind=args.feature if args.device_features else None, device=dev,
        )
    sup_kw = dict(
        lanes=args.lanes,
        faults=plan,
        clock=FaultClock() if plan is not None else None,
        fsync=args.fsync,
        checkpoint_interval=args.checkpoint_interval,
        sanitize=SanitizePolicy(),
        feature_kind=args.feature,
        on_device_features=args.device_features,
        batch_slots=args.slots,
        shards=args.shards,
        adaptive_slots=args.adaptive_slots,
        admission=admission,
        device=dev,
    )
    try:
        fleet = None
        if args.state_dir is not None:
            fleet = FleetSupervisor.restore_from_dir(params, cfg, state_dir=args.state_dir,
                                                     **sup_kw)
        if fleet is not None:
            if fleet.n_streams != args.streams:
                raise SystemExit(
                    f"monitor: --streams {args.streams} does not match the state dir "
                    f"({fleet.n_streams} stream(s)); rerun with the original arguments "
                    f"or a fresh --state-dir"
                )
            print(f"monitor: resumed from state dir at round {fleet.round}, "
                  f"replayed {fleet.replayed_chunks} chunk(s)")
        else:
            fleet = FleetSupervisor(
                params, cfg, n_streams=args.streams,
                n_workers=args.workers if args.workers is not None else 2,
                state_dir=args.state_dir, **sup_kw,
            )
    except ValueError as exc:
        raise SystemExit(f"monitor: {exc}") from exc
    lane_note = "" if args.lanes is None else f", {args.lanes} execution lanes"
    print(f"monitor: fleet supervisor, {fleet.n_live_workers} worker(s) "
          f"over {args.streams} stream(s){lane_note}")
    return fleet


def main(argv=None) -> MonitorRun:
    ap = _parser()
    args = ap.parse_args(argv)
    engine = _build_engine(args, ap)
    fleet = isinstance(engine, FleetSupervisor)
    controller = None
    if args.autoscale:
        from repro_torch.serving.controller import FleetController, SLOTarget

        controller = FleetController(
            engine,
            SLOTarget(max_defer_rate=0.25, max_drop_rate=0.05, min_workers=1,
                      max_workers=max(2, args.streams // 2)),
            window=8, cooldown_rounds=4,
        )
        print("monitor: SLO autoscaler on (defer<=25%, drop<=5%, "
              f"workers 1..{controller.slo.max_workers})")
    if args.adaptive_slots:
        ladder = engine.precompile()
        print(f"monitor: adaptive slots, warmed ladder {list(ladder)}")
    if args.shards:
        print(f"monitor: sharded dispatch over {args.shards} device(s)")
    if args.device_features:
        print(f"monitor: on-device {args.feature} front-end (raw-window dispatch)")

    rng = np.random.default_rng(args.seed + 1)
    scenes, truths = zip(*(synth_scene(args.duration, rng) for _ in range(args.streams)))
    schedule = delivery_schedule(scenes, rng)

    def show(scored):
        for ws in scored:
            flag = "TRACK" if ws.active else ""
            print(
                f"  stream {ws.stream} t={ws.window_idx * features.WINDOW_S:5.1f}s "
                f"p={ws.p_uav:.2f} ema={ws.smoothed:.2f} {flag}"
            )

    scores: list[WindowScore] = []
    rounds: list[float] = []

    def step() -> list[WindowScore]:
        t_round = time.perf_counter()
        got = engine.step()
        if got:
            rounds.append(time.perf_counter() - t_round)
        scores.extend(got)
        show(got)
        return got

    # A fleet resumed from --state-dir already holds each stream's chunks
    # below its ``pushed_chunks`` cursor and the windows of the rounds below
    # its round counter: skip exactly those (a new engine or fleet: none).
    done = np.asarray(getattr(engine, "pushed_chunks", np.zeros(args.streams, np.int64))).copy()
    skip_rounds = int(getattr(engine, "round", 0))
    ordinals = [0] * args.streams

    t0 = time.perf_counter()
    for r, round_pushes in enumerate(schedule):
        for s, lo, hi in round_pushes:
            if ordinals[s] >= done[s]:
                engine.push(s, scenes[s][lo:hi])
            ordinals[s] += 1
        if r < skip_rounds:
            continue  # this round's windows were scored before the restart
        t_round = time.perf_counter()
        step()
        if controller is not None:
            controller.step((time.perf_counter() - t_round) * 1e3)
    while step():  # backlogged windows: delivery outpaces 1/round
        pass
    dt = time.perf_counter() - t0
    events = engine.finalize()

    print(
        f"\nmonitor: {args.streams} stream(s) x {args.duration:.1f}s "
        f"({engine.windows_scored} windows) in {dt:.2f}s "
        f"-> {engine.windows_scored / dt:.1f} windows/s, "
        f"{engine.forward_calls} forward calls, "
        f"{engine.padded_slots} padded slots, "
        f"{engine.dropped_samples} dropped samples"
    )
    if args.adaptive_slots:
        hist = ", ".join(f"{k}x{v}" for k, v in sorted(engine.slot_histogram.items()))
        print(f"monitor: slot histogram {hist or '(no blocks)'}")
    if args.max_streams is not None:
        refused = engine.refused_chunks
        n_refused = int(np.count_nonzero(refused))
        print(f"monitor: {n_refused} stream(s) refused at admission, "
              f"{int(refused.sum())} chunk(s) dropped")
    if fleet:
        for h in engine.health():
            age = "never" if h["heartbeat_age_s"] is None else f"{h['heartbeat_age_s']:.3f}s ago"
            state = "alive" if h["alive"] else "RETIRED"
            print(f"  worker {h['worker']}: {state}, streams {h['streams']}, "
                  f"{h['rebuilds']} rebuild(s), last heartbeat {age}")
        if engine.incidents:
            print(f"monitor: survived {len(engine.incidents)} incident(s):")
            for i in engine.incidents:
                print(f"    round {i['round']:3d} worker {i['worker']} [{i['kind']}] {i['detail']}")
        if controller is not None:
            print(f"monitor: autoscaler took {len(controller.actions)} action(s), fleet "
                  f"ended at {engine.n_live_workers} live worker(s)")
            for a in controller.actions:
                m = a["metrics"]
                print(f"    round {a['round']:3d} [{a['kind']}] defer={m['defer_rate']:.2f} "
                      f"drop={m['drop_rate']:.2f} live={m['n_live']}")
        engine.close()
    for s, (evs, (t_on, t_off)) in enumerate(zip(events, truths)):
        print(f"stream {s}: ground truth UAV at {t_on:.1f}-{t_off:.1f}s, {len(evs)} event(s)")
        for e in evs:
            print(
                f"    onset={e.onset_idx * features.WINDOW_S:.1f}s "
                f"offset={e.offset_idx * features.WINDOW_S:.1f}s "
                f"peak={e.peak_score:.2f} mean={e.mean_score:.2f}"
            )
    return MonitorRun(
        engine=engine, scores=scores, events=events, scenes=list(scenes),
        truths=list(truths), seconds=dt, round_seconds=rounds,
    )


if __name__ == "__main__":
    main(sys.argv[1:])
