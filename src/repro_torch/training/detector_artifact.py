"""Build-once, cached detectors: the corpus, the trained 1D-F-CNN and its
sensitivity-driven precision policy.

Counterpart of ``repro/training/detector_artifact.py``: trains the
1D-F-CNN per feature set on the synthetic UAV corpus (paper §IV-A/B) with
the reference's corpus, split and settings, calibrates its PACT clips,
scores it on the test split, and caches the corpus, the features and the
model under ``artifacts/detector_torch/`` (the reference caches under
``artifacts/detector/``, so a port-trained model is never served as the
reference's).  Training runs on ``device`` (``"cuda"`` by default).
"""
from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from repro_torch.core.precision_policy import Precision, PrecisionPolicy
from repro_torch.core.sensitivity import assign_precisions, sensitivity_scores, value_and_grad
from repro_torch.data import acoustic, features
from repro_torch.kernels.backend import resolve_device
from repro_torch.models import cnn1d
from repro_torch.training import loop
from repro_torch.training.checkpoint import restore_checkpoint, save_checkpoint

ARTIFACTS = Path(__file__).resolve().parents[3] / "artifacts" / "detector_torch"

# dataset difficulty chosen so the FP32/MFCC headline lands near the paper's
# ~90 % operating point (the reference's settings)
DATASET = dict(n=2400, seed=7, snr_range=(-12.0, 18.0), p_clean=0.08)
SPLIT = (1800, 300)  # train, val (rest = test)


def dataset_cached() -> acoustic.AcousticDataset:
    """The corpus of :data:`DATASET`, built once and cached."""
    path = ARTIFACTS / "dataset.npz"
    if path.exists():
        z = np.load(path)
        return acoustic.AcousticDataset(z["audio"], z["labels"], z["snr"])
    ds = acoustic.make_dataset(**DATASET)
    ARTIFACTS.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(path, audio=ds.audio, labels=ds.labels, snr=ds.snr_db)
    return ds


def features_cached(ds: acoustic.AcousticDataset, kind: str) -> np.ndarray:
    """The corpus's ``kind`` features (host numpy), computed once and cached."""
    path = ARTIFACTS / f"feats_{kind}.npy"
    if path.exists():
        return np.load(path)
    f = features.batch_features(ds.audio, kind)
    ARTIFACTS.mkdir(parents=True, exist_ok=True)
    np.save(path, f)
    return f


def model_dir(kind: str) -> Path:
    """Where the trained ``kind`` detector's checkpoint lives."""
    return ARTIFACTS / f"model_{kind}"


def get_detector(kind: str = "mfcc20", *, epochs: int = 14, force: bool = False,
                 device="cuda") -> dict:
    """Returns dict(params, cfg, feats, labels, snr, split, metrics, kind),
    the params on ``device``: the cached model, or one trained now (and
    cached) when there is none or ``force``."""
    dev = resolve_device(device)
    ds = dataset_cached()
    feats = features_cached(ds, kind)
    cfg = cnn1d.CNNConfig(input_len=features.FEATURE_DIMS[kind])
    ck = model_dir(kind)
    n_tr, n_va = SPLIT
    if ck.exists() and not force:
        like = cnn1d.init_params(cfg, torch.Generator().manual_seed(0))
        _, params = restore_checkpoint(ck / "step_0000000001", like, device=dev)
    else:
        res = loop.train_detector(
            feats[:n_tr], ds.labels[:n_tr],
            feats[n_tr : n_tr + n_va], ds.labels[n_tr : n_tr + n_va],
            cfg, epochs=epochs, batch=64, patience=5, device=dev,
        )
        params = res.params
        save_checkpoint(ck, 1, params)
    # learned-clipping deployment step (paper eq. 7): calibrate PACT alphas
    params = cnn1d.calibrate_alphas(params, torch.as_tensor(feats[:256], device=dev), cfg)
    test_logits = loop.predict(params, feats[n_tr + n_va :], cfg)
    metrics = loop.evaluate_logits(test_logits, ds.labels[n_tr + n_va :])
    return {
        "params": params, "cfg": cfg, "feats": feats, "labels": ds.labels,
        "snr": ds.snr_db, "split": SPLIT, "metrics": metrics, "kind": kind,
    }


def sensitivity_policy(det: dict, n_batch: int = 256) -> PrecisionPolicy:
    """Eq. (2)-(3) scoring on a training batch -> per-layer precision map,
    the classifier head pinned at FP32 and INT8 elsewhere by default."""
    params, cfg, feats, labels = det["params"], det["cfg"], det["feats"], det["labels"]
    dev = params["dense1"]["w"].device
    x = torch.as_tensor(feats[:n_batch], device=dev)
    y = torch.as_tensor(labels[:n_batch], device=dev)

    def loss(p):
        return loop.cross_entropy(cnn1d.forward(p, x, cfg), y)

    with cnn1d.fp32_numerics():
        _, grads = value_and_grad(loss, params)
    flat_p = {f"{k}/w": v["w"] for k, v in params.items()}
    flat_g = {f"{k}/w": v["w"] for k, v in grads.items()}
    rules = assign_precisions(
        sensitivity_scores(flat_p, flat_g),
        high_fraction=0.25,
        pinned={"dense1/w": Precision.FP32},  # classifier head stays FP32
    )
    return PrecisionPolicy(rules=rules, default=Precision.INT8)
