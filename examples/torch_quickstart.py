"""Quickstart on the PyTorch port: the paper's full pipeline in one script.

Counterpart of ``examples/quickstart.py`` through ``repro_torch`` alone:
synthesises UAV/background audio, extracts MFCC features, trains the
1D-F-CNN, scores layer sensitivity (eq. 2), runs all four precision modes,
applies the serialisation-aware structured prune (Table I), and reports the
cycle-model latency (eqs. 9-10).  Training and inference run on the GPU
(``--device cpu`` for the plain path).

    PYTHONPATH=src python examples/torch_quickstart.py [--n 600] [--epochs 6] [--device cpu]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.core import timing_model as TM
from repro_torch.core.precision_policy import Precision, PrecisionPolicy
from repro_torch.data import acoustic, features
from repro_torch.kernels.backend import resolve_device
from repro_torch.models import cnn1d
from repro_torch.training import loop
from repro_torch.training.detector_artifact import sensitivity_policy


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=1000)
    ap.add_argument("--epochs", type=int, default=10)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    print("== 1. synthetic acoustic corpus ==")
    ds = acoustic.make_dataset(args.n, seed=0, snr_range=(-12, 18), p_clean=0.08)
    print(f"   {args.n} windows of {features.WINDOW_S}s @ {features.SR}Hz, {ds.labels.mean()*100:.0f}% UAV")

    print("== 2. MFCC-20 feature vectors (1x1096) ==")
    feats = features.batch_features(ds.audio, "mfcc20")

    print("== 3. train 1D-F-CNN (Adam + early stopping) ==")
    n_tr = int(args.n * 0.7)
    n_va = int(args.n * 0.15)
    res = loop.train_detector(
        feats[:n_tr], ds.labels[:n_tr],
        feats[n_tr : n_tr + n_va], ds.labels[n_tr : n_tr + n_va],
        cnn1d.CANONICAL, epochs=args.epochs, batch=64, verbose=True, device=dev,
    )
    test_x, test_y = feats[n_tr + n_va :], ds.labels[n_tr + n_va :]

    print("== 4. precision sweep (the multi-precision datapath) ==")
    for prec in Precision:
        m = loop.evaluate_logits(
            loop.predict(res.params, test_x, res.cfg, policy=PrecisionPolicy.uniform(prec)), test_y
        )
        print(f"   {prec.value:5s}: acc={m.accuracy*100:.2f}%  f1={m.f1*100:.2f}%")

    print("== 5. sensitivity-driven mixed precision (eqs. 2-3) ==")
    det = {"params": res.params, "cfg": res.cfg, "feats": feats, "labels": ds.labels}
    pol = sensitivity_policy(det)
    m = loop.evaluate_logits(loop.predict(res.params, test_x, res.cfg, policy=pol), test_y)
    print(f"   mixed: acc={m.accuracy*100:.2f}%  rules={pol.to_json()}")

    print("== 6. structured pruning (Table I) ==")
    pruned, pcfg, spec = cnn1d.prune_model(res.params, res.cfg)
    with torch.no_grad(), cnn1d.fp32_numerics():
        logits = cnn1d.forward_pruned(pruned, torch.as_tensor(np.asarray(test_x, np.float32),
                                                              device=dev), pcfg, spec)
    mp = loop.evaluate_logits(logits.cpu().numpy(), test_y)
    print(f"   flatten {spec.flatten_before} -> {spec.flatten_after} ({spec.reduction*100:.1f}%), acc={mp.accuracy*100:.2f}%")

    print("== 7. cycle-accurate latency (eqs. 9-10) ==")
    for pruned_flag in (False, True):
        lat = TM.shield8_latency(pruned=pruned_flag)
        print(f"   {'pruned' if pruned_flag else 'unpruned'}: {lat['seconds']*1e3:.1f} ms @100MHz (paper deployed: 116 ms)")


if __name__ == "__main__":
    main()
