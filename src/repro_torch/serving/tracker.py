"""Temporal tracking of UAV detections (the title's "Temporal Tracking").

The port's own copy of ``repro/serving/tracker.py``; its events must stay
equal to the reference's.

Continuous monitoring emits a per-window UAV probability every 0.8 s; raw
thresholding chatters under noise.  The tracker smooths scores with an EMA
and applies hysteresis (enter/exit thresholds) plus a minimum-duration
filter, producing stable *events* (onset, offset, peak confidence) — the
false-alarm behaviour that Fig. 5 measures is what the hysteresis
suppresses.

Two implementations share the exact same semantics:

* :class:`TemporalTracker` — scalar, one stream, one ``update`` per window.
* :class:`VectorTemporalTracker` — EMA/hysteresis/min-duration state held in
  ``(n_streams,)`` float64/bool arrays so tracking N concurrent streams is
  one numpy pass per window round, not N Python loops.  This is what the
  multi-stream monitor engine uses.

Both accumulate event statistics incrementally (running sum / count / max in
float64, the same left-to-right order), so their :class:`TrackEvent` outputs
are *identical*, not merely close — the streaming-parity tests compare them
with ``==``.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, Optional

import numpy as np


@dataclasses.dataclass
class TrackEvent:
    onset_idx: int
    offset_idx: int
    peak_score: float
    mean_score: float

    @property
    def duration(self) -> int:
        return self.offset_idx - self.onset_idx + 1


@dataclasses.dataclass
class TemporalTracker:
    ema_alpha: float = 0.4
    enter_threshold: float = 0.65
    exit_threshold: float = 0.35
    min_duration: int = 2  # windows (>= 1.6 s of sustained detection)

    def __post_init__(self):
        self.reset()

    def reset(self):
        self._ema: Optional[float] = None
        self._active = False
        self._onset = 0
        # Incremental event statistics (not a score list): count/sum/peak over
        # the windows that are *part of the event* — the exit window (EMA at
        # or below exit_threshold) never contributes.
        self._count = 0
        self._sum = 0.0
        self._peak = -np.inf
        self._idx = -1
        self.events: list[TrackEvent] = []

    @property
    def smoothed(self) -> float:
        return self._ema if self._ema is not None else 0.0

    def update(self, p_uav: float) -> dict:
        """Feed one window's UAV probability; returns the tracker state."""
        # Coerce to a Python float: a np.float32 input would otherwise run
        # the whole EMA/stats chain in float32 (NEP 50) and break the
        # bitwise scalar-vs-vector parity contract.
        p_uav = float(p_uav)
        self._idx += 1
        self._ema = (
            p_uav
            if self._ema is None
            else self.ema_alpha * p_uav + (1 - self.ema_alpha) * self._ema
        )
        if not self._active and self._ema >= self.enter_threshold:
            self._active = True
            self._onset = self._idx
            self._count, self._sum, self._peak = 0, 0.0, -np.inf
        if self._active:
            if self._ema <= self.exit_threshold:
                # The current window broke the track: it is NOT part of the
                # event, so the event ends at the previous window.
                self._close(self._idx - 1)
            else:
                self._count += 1
                self._sum += self._ema
                self._peak = max(self._peak, self._ema)
        return {"idx": self._idx, "smoothed": self._ema, "active": self._active}

    def _close(self, offset_idx: int):
        self._active = False
        # Duration gate agrees with TrackEvent.duration: an event spanning
        # exactly min_duration windows is kept.  self._count always equals
        # offset_idx - self._onset + 1 here.
        if self._count >= max(self.min_duration, 1):
            self.events.append(
                TrackEvent(
                    onset_idx=self._onset,
                    offset_idx=offset_idx,
                    peak_score=float(self._peak),
                    mean_score=float(self._sum / self._count),
                )
            )

    def finalize(self) -> list[TrackEvent]:
        if self._active:
            # The final window is genuinely active (the EMA never fell below
            # exit_threshold), so it closes the event *inclusively*.
            self._close(self._idx)
        return self.events


class VectorTemporalTracker:
    """Track N streams at once; state lives in ``(n_streams,)`` arrays.

    ``update(p, mask)`` advances only the streams selected by ``mask`` (a
    stream that produced no window this round keeps its state frozen,
    including its per-stream window index), which is exactly what the
    monitor engine's uneven-arrival rounds need.

    Semantics are window-for-window identical to :class:`TemporalTracker`;
    see the module docstring for why the event statistics match bitwise.
    """

    def __init__(
        self,
        n_streams: int,
        *,
        ema_alpha: float = 0.4,
        enter_threshold: float = 0.65,
        exit_threshold: float = 0.35,
        min_duration: int = 2,
    ):
        self.n_streams = n_streams
        self.ema_alpha = ema_alpha
        self.enter_threshold = enter_threshold
        self.exit_threshold = exit_threshold
        self.min_duration = min_duration
        self.reset()

    def reset(self):
        n = self.n_streams
        self._ema = np.zeros(n, np.float64)
        self._seen = np.zeros(n, bool)  # has stream ever produced a window?
        self._active = np.zeros(n, bool)
        self._onset = np.zeros(n, np.int64)
        self._count = np.zeros(n, np.int64)
        self._sum = np.zeros(n, np.float64)
        self._peak = np.full(n, -np.inf, np.float64)
        self._idx = np.full(n, -1, np.int64)  # per-stream window index
        self.events: list[list[TrackEvent]] = [[] for _ in range(n)]

    @property
    def smoothed(self) -> np.ndarray:
        return np.where(self._seen, self._ema, 0.0)

    @property
    def active(self) -> np.ndarray:
        return self._active.copy()

    def update(self, p_uav: np.ndarray, mask: np.ndarray | None = None) -> dict:
        """Feed one window round: ``p_uav[i]`` is stream i's probability.

        ``mask[i]`` False freezes stream i this round (``p_uav[i]`` ignored).
        Returns arrays ``{"idx", "smoothed", "active"}`` mirroring the scalar
        tracker's state dict.
        """
        p = np.asarray(p_uav, np.float64)
        assert p.shape == (self.n_streams,), p.shape
        m = (
            np.ones(self.n_streams, bool)
            if mask is None
            else np.asarray(mask, bool)
        )
        a = self.ema_alpha

        self._idx[m] += 1
        # First-ever window seeds the EMA directly (scalar: self._ema is None).
        new_ema = np.where(self._seen, a * p + (1 - a) * self._ema, p)
        self._ema = np.where(m, new_ema, self._ema)
        self._seen |= m

        entering = m & ~self._active & (self._ema >= self.enter_threshold)
        self._active |= entering
        self._onset[entering] = self._idx[entering]
        self._count[entering] = 0
        self._sum[entering] = 0.0
        self._peak[entering] = -np.inf

        exiting = m & self._active & (self._ema <= self.exit_threshold)
        staying = m & self._active & ~exiting
        self._count[staying] += 1
        self._sum[staying] += self._ema[staying]
        self._peak[staying] = np.maximum(self._peak[staying], self._ema[staying])

        if exiting.any():
            # The exiting window is not part of the event: offset = idx - 1.
            self._close(np.flatnonzero(exiting), self._idx[exiting] - 1)
        return {
            "idx": self._idx.copy(),
            "smoothed": self.smoothed,
            "active": self._active.copy(),
        }

    def _close(self, streams: np.ndarray, offsets: np.ndarray):
        self._active[streams] = False
        for s, off in zip(streams, offsets):
            if self._count[s] >= max(self.min_duration, 1):
                self.events[s].append(
                    TrackEvent(
                        onset_idx=int(self._onset[s]),
                        offset_idx=int(off),
                        peak_score=float(self._peak[s]),
                        mean_score=float(self._sum[s] / self._count[s]),
                    )
                )

    def finalize(self) -> list[list[TrackEvent]]:
        open_ = np.flatnonzero(self._active)
        if open_.size:
            # Still-active streams close inclusively at their last window.
            self._close(open_, self._idx[open_])
        return self.events

    # -- crash-recoverable state ---------------------------------------------

    #: array fields captured by state_dict (events are handled separately)
    _STATE_ARRAYS = (
        "_ema", "_seen", "_active", "_onset", "_count", "_sum", "_peak", "_idx"
    )

    def state_dict(self) -> dict:
        """Deep-copied snapshot of every per-stream array plus the emitted
        events.  Feeding it back through :meth:`load_state_dict` — on this
        instance or a freshly built one — reproduces the tracker *exactly*:
        replaying the same probability sequence afterwards yields bitwise
        identical EMA trajectories and ``TrackEvent`` lists (the
        crash-recovery conformance tests pin this)."""
        sd = {name: getattr(self, name).copy() for name in self._STATE_ARRAYS}
        # TrackEvent instances are never mutated after emission, so copying
        # the per-stream lists (not the events) is a full deep copy.
        sd["events"] = [list(evs) for evs in self.events]
        return sd

    def load_state_dict(self, sd: dict):
        """Restore a :meth:`state_dict` snapshot; the tracker must have been
        built with the same ``n_streams``."""
        n = len(sd["_ema"])
        if n != self.n_streams:
            raise ValueError(
                f"state_dict holds {n} stream(s) but this tracker was built "
                f"for {self.n_streams}"
            )
        for name in self._STATE_ARRAYS:
            cur = getattr(self, name)
            arr = np.asarray(sd[name], cur.dtype)
            if arr.shape != cur.shape:
                raise ValueError(
                    f"state_dict field {name} has shape {arr.shape}, "
                    f"expected {cur.shape}"
                )
            setattr(self, name, arr.copy())
        self.events = [list(evs) for evs in sd["events"]]


def track_stream(probs: Iterable[float], **kw) -> list[TrackEvent]:
    tr = TemporalTracker(**kw)
    for p in probs:
        tr.update(float(p))
    return tr.finalize()
