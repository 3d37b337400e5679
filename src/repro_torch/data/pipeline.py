"""Async data pipeline: a prefetch thread that places batches on a device.

Counterpart of ``repro/data/pipeline.py``.  A background thread produces
batches ahead of the training step and moves them onto ``device`` (the
reference's ``sharding=`` placement; here every rank receives its own rows
and places them on its card).  ``close()`` keeps the reference's shutdown
semantics: the worker's put re-checks the stop flag on a timeout, close
drains the queue while joining, and leaves one final sentinel so a
consumer still iterating ends.
"""
from __future__ import annotations

import queue
import threading
import time
from typing import Callable, Iterator, Optional

import numpy as np
import torch

from repro_torch.kernels.backend import resolve_device


class PrefetchingLoader:
    """Wraps a batch-producing callable with a prefetch thread; each batch
    (a dict of numpy arrays) arrives as tensors on ``device`` (CUDA unless
    ``device="cpu"``; raises without a GPU)."""

    def __init__(
        self,
        make_batch: Callable[[int], dict],
        *,
        prefetch: int = 2,
        device="cuda",
    ):
        self._make = make_batch
        self._device = resolve_device(device)
        self._q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        step = 0
        while not self._stop.is_set():
            batch = self._make(step)
            if batch is None:
                self._put(None)
                return
            batch = {k: torch.as_tensor(v).to(self._device) for k, v in batch.items()}
            if not self._put(batch):
                return  # close() raced us while the queue was full
            step += 1

    def _put(self, batch) -> bool:
        """Enqueue, re-checking the stop flag while the queue is full.

        A plain ``Queue.put`` blocks forever on a full queue, so a worker
        parked there would never see ``close()`` set the flag — the shutdown
        deadlock this timeout loop exists to break.
        """
        while not self._stop.is_set():
            try:
                self._q.put(batch, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    def __iter__(self) -> Iterator[dict]:
        while True:
            batch = self._q.get()
            if batch is None:
                return
            yield batch

    def close(self, timeout: float = 5.0):
        """Stop the worker and join it; safe to call with a full queue.

        Bounded: a ``make_batch`` stuck inside a blocking call cannot
        observe the stop flag, so after ``timeout`` seconds the daemon
        thread is abandoned rather than hanging shutdown forever.
        """
        self._stop.set()
        deadline = time.monotonic() + timeout
        # Drain so a worker mid-`put` can cycle its timeout loop and exit.
        while self._thread.is_alive() and time.monotonic() < deadline:
            try:
                while True:
                    self._q.get_nowait()
            except queue.Empty:
                pass
            self._thread.join(timeout=0.1)
        # Discard anything enqueued after the last drain, then leave one
        # sentinel so any consumer still iterating terminates cleanly.
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        try:
            self._q.put_nowait(None)
        except queue.Full:
            pass


def synthetic_lm_batches(vocab: int, batch: int, seq: int, seed: int = 0, n_steps: Optional[int] = None):
    """Deterministic synthetic token stream (markov-ish structure so loss can
    actually fall) for the end-to-end train driver; numpy, the reference's
    bits."""
    rng = np.random.default_rng(seed)
    trans = rng.integers(0, vocab, size=(256,))

    def make(step: int):
        if n_steps is not None and step >= n_steps:
            return None
        r = np.random.default_rng(seed * 1_000_003 + step)
        toks = np.empty((batch, seq + 1), np.int32)
        toks[:, 0] = r.integers(0, vocab, size=batch)
        noise = r.random((batch, seq))
        nxt = r.integers(0, vocab, size=(batch, seq))
        for t in range(seq):
            det = trans[toks[:, t] % 256]
            toks[:, t + 1] = np.where(noise[:, t] < 0.85, det, nxt[:, t])
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    return make
