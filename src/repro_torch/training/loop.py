"""Training loop of the 1D-F-CNN detector (paper §IV-B).

Counterpart of ``repro/training/loop.py``: Adam + cross-entropy + early
stopping on validation accuracy; metrics are accuracy, precision, recall,
F1 and the continuous-monitoring false-alarm and missed-detection rates
(Figs. 4-5).

The reference jits its step; here every step runs the emulation forward
and ``torch.autograd`` on ``device`` (``"cuda"`` by default; without a GPU
that raises unless ``device="cpu"``) inside
:func:`~repro_torch.models.cnn1d.fp32_numerics`, so the card computes in
IEEE fp32 with deterministic cuDNN algorithms: two runs from one seed give
the same weights, bit for bit.  Initialisation and dropout draw from one
``torch.Generator`` on the training device, seeded with ``seed``; the
batch order comes from ``numpy.random.default_rng(seed)``, as in the
reference.  ``jax.random`` has no PyTorch counterpart, so a run is held to
the reference by its accuracy, not its bits.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core.precision_policy import PrecisionPolicy
from repro_torch.core.sensitivity import value_and_grad
from repro_torch.kernels.backend import resolve_device
from repro_torch.models import cnn1d
from repro_torch.training.optimizer import Adam, AdamState


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.mean(torch.gather(logp, 1, labels.to(torch.int64)[:, None]))


@dataclasses.dataclass
class Metrics:
    accuracy: float
    precision: float
    recall: float
    f1: float
    false_alarm_rate: float  # FP / negatives  (Fig. 5a)
    missed_detection_rate: float  # FN / positives  (Fig. 5b)

    def row(self) -> dict:
        return dataclasses.asdict(self)


def evaluate_logits(logits: np.ndarray, labels: np.ndarray) -> Metrics:
    pred = np.argmax(logits, axis=1)
    tp = int(np.sum((pred == 1) & (labels == 1)))
    tn = int(np.sum((pred == 0) & (labels == 0)))
    fp = int(np.sum((pred == 1) & (labels == 0)))
    fn = int(np.sum((pred == 0) & (labels == 1)))
    acc = (tp + tn) / max(len(labels), 1)
    prec = tp / max(tp + fp, 1)
    rec = tp / max(tp + fn, 1)
    f1 = 2 * prec * rec / max(prec + rec, 1e-9)
    far = fp / max(fp + tn, 1)
    mdr = fn / max(fn + tp, 1)
    return Metrics(acc, prec, rec, f1, far, mdr)


OPT = Adam(lr=1e-3)


def train_step(params: dict, opt_state: AdamState, x: torch.Tensor, y: torch.Tensor,
               generator: torch.Generator, cfg: cnn1d.CNNConfig):
    """One Adam step on a batch (dropout on): (params, opt_state, loss)."""

    def loss_fn(p):
        return cross_entropy(cnn1d.forward(p, x, cfg, train=True, generator=generator), y)

    with cnn1d.fp32_numerics():
        loss, grads = value_and_grad(loss_fn, params)
        params, opt_state = OPT.update(grads, opt_state, params)
    return params, opt_state, loss


@torch.no_grad()
def predict(params: dict, feats: np.ndarray, cfg: cnn1d.CNNConfig,
            policy: Optional[PrecisionPolicy] = None, batch: int = 256) -> np.ndarray:
    """Logits of ``feats`` (host rows) under ``policy``'s emulation, on the
    params' device, ``batch`` rows a forward."""
    dev = params["dense1"]["w"].device
    outs = []
    with cnn1d.fp32_numerics():
        for i in range(0, len(feats), batch):
            x = torch.as_tensor(np.asarray(feats[i : i + batch], np.float32), device=dev)
            outs.append(cnn1d.forward(params, x, cfg, policy=policy).cpu().numpy())
    return np.concatenate(outs)


@dataclasses.dataclass
class TrainResult:
    params: dict
    cfg: cnn1d.CNNConfig
    history: list[dict]
    best_val_acc: float


def train_detector(
    feats_train: np.ndarray,
    y_train: np.ndarray,
    feats_val: np.ndarray,
    y_val: np.ndarray,
    cfg: cnn1d.CNNConfig,
    *,
    epochs: int = 30,
    batch: int = 64,
    patience: int = 5,
    seed: int = 0,
    verbose: bool = False,
    device="cuda",
) -> TrainResult:
    """Adam + cross-entropy + early stopping on val accuracy (paper §IV-B),
    on ``device``; the returned params (the best epoch's) live there."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = cnn1d.init_params(cfg, gen)
    opt_state = OPT.init(params)
    x_train = torch.as_tensor(np.asarray(feats_train, np.float32), device=dev)
    y_train = torch.as_tensor(np.asarray(y_train), device=dev)
    n = len(x_train)
    best = (-1.0, params)
    bad_epochs = 0
    history = []
    order_rng = np.random.default_rng(seed)
    for epoch in range(epochs):
        order = order_rng.permutation(n)
        losses = []
        for i in range(0, n - batch + 1, batch):
            idx = torch.as_tensor(order[i : i + batch], device=dev)
            params, opt_state, loss = train_step(
                params, opt_state, x_train[idx], y_train[idx], gen, cfg
            )
            losses.append(loss)
        mean_loss = float(np.mean(torch.stack(losses).double().cpu().numpy())) if losses \
            else float("nan")
        m = evaluate_logits(predict(params, feats_val, cfg), y_val)
        history.append({"epoch": epoch, "loss": mean_loss, "val_acc": m.accuracy})
        if verbose:
            print(f"epoch {epoch}: loss={mean_loss:.4f} val_acc={m.accuracy:.4f}")
        if m.accuracy > best[0]:
            best = (m.accuracy, params)  # the step makes new tensors, so no copy
            bad_epochs = 0
        else:
            bad_epochs += 1
            if bad_epochs >= patience:
                break
    return TrainResult(params=best[1], cfg=cfg, history=history, best_val_acc=best[0])
