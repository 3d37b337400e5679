"""Continuous UAV monitoring with temporal tracking, on the PyTorch port.

Counterpart of ``examples/serve_acoustic.py`` through ``repro_torch``
alone: streams a synthetic 60 s acoustic scene (UAV pass + bird/aircraft
clutter) through the trained detector window-by-window; the
TemporalTracker smooths scores and emits onset/offset events.  The
detector is ``training.detector_artifact.get_detector``'s (trained on the
device and cached on first use).

    PYTHONPATH=src python examples/torch_serve_acoustic.py [--device cpu]
    # a quick detector: W windows, N epochs, cached in DIR (not the default cache)
    PYTHONPATH=src python examples/torch_serve_acoustic.py --windows W --epochs N --cache DIR
"""
from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from repro_torch.data import acoustic, features
from repro_torch.serving.tracker import TemporalTracker
from repro_torch.training import detector_artifact, loop


def synth_scene(seconds: float = 60.0, seed: int = 3):
    """A scene: background everywhere, a UAV pass in [20s, 38s)."""
    rng = np.random.default_rng(seed)
    n_win = int(seconds / features.WINDOW_S)
    windows, truth = [], []
    for i in range(n_win):
        t = i * features.WINDOW_S
        uav = 20.0 <= t < 38.0
        x = acoustic.synth_uav(rng) if uav else acoustic.synth_background(rng)
        x = acoustic.add_noise_snr(x, rng.uniform(0, 15), rng)
        windows.append(x)
        truth.append(uav)
    return np.stack(windows), np.asarray(truth)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--epochs", type=int, default=14,
                    help="epochs of the detector's training where none is cached")
    ap.add_argument("--cache", type=Path, default=None,
                    help="where the corpus and the detector are cached "
                         "(default: artifacts/detector_torch)")
    ap.add_argument("--windows", type=int, default=None,
                    help="with --cache: the corpus's windows (default: get_detector's 2,400), "
                         "three quarters trained on, an eighth for validation")
    args = ap.parse_args(argv)
    if args.windows is not None:
        if args.cache is None:
            ap.error("--windows needs --cache: a detector of a smaller corpus must not "
                     "take the default cache")
        detector_artifact.DATASET = {**detector_artifact.DATASET, "n": args.windows}
        detector_artifact.SPLIT = (args.windows * 3 // 4, args.windows // 8)
    if args.cache is not None:
        detector_artifact.ARTIFACTS = args.cache

    det = detector_artifact.get_detector("mfcc20", epochs=args.epochs, device=args.device)
    windows, truth = synth_scene()
    feats = features.batch_features(windows, "mfcc20")
    logits = loop.predict(det["params"], feats, det["cfg"])
    probs = np.exp(logits[:, 1]) / np.exp(logits).sum(axis=1)

    tracker = TemporalTracker(ema_alpha=0.4, enter_threshold=0.65, exit_threshold=0.35)
    print("t(s)  p_uav  ema    state")
    for i, p in enumerate(probs):
        st = tracker.update(float(p))
        flag = "TRACK" if st["active"] else ""
        if i % 5 == 0 or st["active"]:
            print(f"{i*0.8:5.1f}  {p:.2f}  {st['smoothed']:.2f}  {flag}")
    events = tracker.finalize()
    print(f"\n{len(events)} event(s); ground truth: one UAV pass at 20.0-38.0s")
    for e in events:
        print(
            f"  onset={e.onset_idx*0.8:.1f}s offset={e.offset_idx*0.8:.1f}s "
            f"peak={e.peak_score:.2f} mean={e.mean_score:.2f}"
        )


if __name__ == "__main__":
    main()
