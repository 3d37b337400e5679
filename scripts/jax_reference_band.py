"""Accuracy band of the JAX reference's trained detector, for the port's check.

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/jax_reference_band.py 0 1 2

Trains the canonical mfcc20 1D-F-CNN with the JAX package (``repro``) on
the corpus and split of ``repro.training.detector_artifact`` (``DATASET``,
``SPLIT``), once per seed given (``train_detector(seed=...)`` with
``get_detector``'s settings: 14 epochs, batch 64, patience 5), calibrates
its PACT clips as ``get_detector`` does, and prints one JSON line a seed:
the training history, the calibrated clips, and the test accuracy under
FP32, BF16, INT8 and FXP8 emulation, under the sensitivity policy, and of
``prune_model(keep=64)`` under FP32 and INT8.  ``chip_smoke.py`` holds the
port's FP32 accuracy on the card to these seeds' range.  It runs on any
JAX device (about a minute a seed on a CPU); nothing is cached.
"""
from __future__ import annotations

import json
import sys
import time

import jax.numpy as jnp
import numpy as np

from repro.core.precision_policy import Precision, PrecisionPolicy
from repro.data import acoustic, features
from repro.models import cnn1d
from repro.training import loop
from repro.training.detector_artifact import DATASET, SPLIT, sensitivity_policy


def band(seeds: list[int]) -> list[dict]:
    ds = acoustic.make_dataset(**DATASET)
    feats = features.batch_features(ds.audio, "mfcc20")
    cfg = cnn1d.CNNConfig(input_len=features.FEATURE_DIMS["mfcc20"])
    n_tr, n_va = SPLIT
    test_x, test_y = feats[n_tr + n_va:], ds.labels[n_tr + n_va:]
    rows = []
    for seed in seeds:
        t0 = time.perf_counter()
        res = loop.train_detector(feats[:n_tr], ds.labels[:n_tr], feats[n_tr:n_tr + n_va],
                                  ds.labels[n_tr:n_tr + n_va], cfg, epochs=14, batch=64,
                                  patience=5, seed=seed)
        train_s = time.perf_counter() - t0
        params = cnn1d.calibrate_alphas(res.params, jnp.asarray(feats[:256]), cfg)
        row = {"seed": seed, "train_s": train_s, "history": res.history,
               "best_val_acc": res.best_val_acc,
               "alphas": {k: float(v["alpha"]) for k, v in params.items() if "alpha" in v}}
        for prec in Precision:
            logits = loop.predict(params, test_x, cfg, PrecisionPolicy.uniform(prec))
            row[prec.value] = loop.evaluate_logits(logits, test_y).accuracy
        det = {"params": params, "cfg": cfg, "feats": feats, "labels": ds.labels}
        policy = sensitivity_policy(det)
        row["sensitivity_rules"] = policy.to_dict()
        row["sensitivity"] = loop.evaluate_logits(loop.predict(params, test_x, cfg, policy),
                                                  test_y).accuracy
        pruned, pcfg, spec = cnn1d.prune_model(params, cfg, keep=64)
        for prec in (Precision.FP32, Precision.INT8):
            logits = np.concatenate([
                np.asarray(cnn1d.forward_pruned(pruned, jnp.asarray(test_x[i:i + 100]), pcfg,
                                                spec, policy=PrecisionPolicy.uniform(prec)))
                for i in range(0, len(test_x), 100)])
            row[f"pruned_{prec.value}"] = loop.evaluate_logits(logits, test_y).accuracy
        print(json.dumps(row), flush=True)
        rows.append(row)
    return rows


if __name__ == "__main__":
    band([int(s) for s in sys.argv[1:]] or [0, 1, 2])
