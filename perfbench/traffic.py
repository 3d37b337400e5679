"""The one traffic generator: every mix is a file of parameters it reads.

A mix (``perfbench/traffic/<mix>.json``) gives:

* ``input``: ``"feat"`` (stored mfcc20 rows, 1,096 values a window) or
  ``"raw"`` (0.8 s windows of 12,800 samples, scored with the program's
  on-device front-end);
* ``bank``: how many distinct windows set-up synthesises, as monitored
  scenes of ``scene_windows`` windows each (UAV and background in the
  proportions of the program's ``monitor.synth_scene``), on up to
  ``bank_workers`` processes;
* ``block``: windows a forward scores; ``inflight``: blocks queued on the
  card at once; ``ring``: distinct blocks, each a seeded draw of ``block``
  bank rows, staged in pinned host memory and sent in turn;
* ``warmup_blocks``: blocks run before the window; ``trace_blocks``: blocks
  profiled after it in a ``--trace 1`` run.

Everything is drawn from the run's seed: the same seed gives the same bank,
the same blocks and the same weights (:func:`seeds`).
"""
from __future__ import annotations

import concurrent.futures
import dataclasses
import multiprocessing
import os

import numpy as np

from perfbench.frozen import acoustic, features


@dataclasses.dataclass(frozen=True)
class Seeds:
    """Independent streams of one run's seed: the weights' generator seed,
    and the bank's and the blocks' numpy seeds."""

    weights: int
    bank: np.random.SeedSequence
    blocks: np.random.SeedSequence


def seeds(seed: int) -> Seeds:
    """Split a run's seed (any non-negative whole number) into its streams."""
    if seed < 0:
        raise ValueError(f"seed must be non-negative, got {seed}")
    weights, bank, blocks = np.random.SeedSequence(seed).spawn(3)
    return Seeds(int(weights.generate_state(1, np.uint64)[0] >> np.uint64(1)), bank, blocks)


@dataclasses.dataclass(frozen=True)
class Bank:
    """The archive the blocks are drawn from: what the program is sent
    (mfcc20 rows for ``"feat"`` traffic, raw windows for ``"raw"``) and the
    windows' labels."""

    rows: np.ndarray  # (n, 1096) or (n, 12800) float32
    labels: np.ndarray  # (n,) int32, 1 = UAV
    input: str


def _scene(n_win: int, seq: np.random.SeedSequence, feat: bool):
    """One scene's rows and labels, from its own seed."""
    wins, labels = acoustic.scene_windows(n_win, np.random.default_rng(seq))
    windows = np.stack(wins).astype(np.float32)
    return (features.batch_features(windows) if feat else windows), labels


def make_bank(mix: dict, seq: np.random.SeedSequence) -> Bank:
    """``mix["bank"]`` windows from consecutive scenes, each scene drawn from
    its own child of ``seq``, so the bank does not depend on how many worker
    processes (at most ``mix["bank_workers"]``, spawned and joined here)
    synthesise it."""
    n, n_win = int(mix["bank"]), int(mix["scene_windows"])
    n_scenes = -(-n // n_win)
    feat = mix["input"] == "feat"
    args = [(n_win, np.random.SeedSequence(seq.entropy, spawn_key=(*seq.spawn_key, i)), feat)
            for i in range(n_scenes)]
    workers = min(int(mix.get("bank_workers", 1)), n_scenes // 8, os.cpu_count() or 1)
    if workers > 1:
        ctx = multiprocessing.get_context("spawn")
        with concurrent.futures.ProcessPoolExecutor(workers, mp_context=ctx) as pool:
            scenes = list(pool.map(_scene, *zip(*args)))
    else:
        scenes = [_scene(*a) for a in args]
    rows = np.concatenate([r for r, _ in scenes])[:n]
    labels = np.concatenate([lab for _, lab in scenes])[:n].astype(np.int32)
    return Bank(rows, labels, mix["input"])


def draw_ring(mix: dict, n_bank: int, seq: np.random.SeedSequence) -> np.ndarray:
    """(ring, block) bank indices: each block a seeded draw, with repeats,
    from the whole bank.  A row's result does not depend on its co-batch,
    so a repeat changes no arithmetic."""
    rng = np.random.default_rng(seq)
    return rng.integers(0, n_bank, size=(int(mix["ring"]), int(mix["block"])))
