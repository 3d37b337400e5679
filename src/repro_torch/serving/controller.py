"""Closed-loop SLO autoscaler for the fleet supervisor.

Counterpart of ``repro/serving/controller.py``.  The supervisor exports the
raw signals — per-stream ``served_windows`` / ``deferred_windows``, fleet
``dropped_samples``, per-worker heartbeat age — and its snapshot/splice
machinery moves streams between workers bitwise-losslessly.  This module closes the loop: a
:class:`FleetController` watches round latency percentiles (p50/p95/p99)
and drop/defer rates over a sliding window, compares them against a
declarative :class:`SLOTarget`, and resizes the fleet through three
actuators on :class:`~repro_torch.serving.supervisor.FleetSupervisor`:

* ``spawn_worker()`` — scale up when latency or loss breaches the target:
  the most-loaded worker's streams split in half onto a new worker (and,
  with lanes, a new execution lane running concurrently);
* ``retire_worker()`` — scale down when every watched signal sits
  comfortably under target (margin-scaled), or immediately when a worker's
  heartbeat goes stale past ``max_heartbeat_age_s`` (presumed hung);
* ``retune_admission()`` — when the fleet is already at ``max_workers``
  and windows are being *deferred* (not dropped), widen the per-round
  admission budget instead of spawning.

Every actuation is bitwise lossless for every stream (the same invariant
the chaos suite pins for crash recovery), so the controller can act as
aggressively as its cooldown allows without ever perturbing the numbers —
autoscaling changes *when* windows are scored, never *what* they score.

The controller is deliberately deterministic and injectable: latencies
arrive via :meth:`observe` (the caller times its own rounds — tests inject
synthetic latencies), counters are read off the supervisor, and decisions
fire in a fixed priority order (liveness > pressure > headroom) with a
cooldown between actions so one burst cannot thrash the fleet.  Every
decision lands in :attr:`actions` with the metrics that justified it.
"""
from __future__ import annotations

import collections
import dataclasses

import numpy as np

from repro_torch.serving.supervisor import FleetSupervisor


@dataclasses.dataclass(frozen=True)
class SLOTarget:
    """Declarative serving objective the controller steers toward.

    Any threshold left ``None`` is simply not watched.  ``min_workers`` /
    ``max_workers`` bound the fleet size the controller may steer to — it
    never spawns past the cap or retires below the floor.
    """

    round_p95_ms: float | None = None  # p95 round latency ceiling
    max_defer_rate: float | None = None  # deferred/(served+deferred) ceiling
    max_drop_rate: float | None = None  # overflow-dropped sample fraction
    max_heartbeat_age_s: float | None = None  # stale-worker liveness bound
    min_workers: int = 1
    max_workers: int = 8

    def __post_init__(self):
        if self.min_workers < 1:
            raise ValueError(f"min_workers must be >= 1, got {self.min_workers}")
        if self.max_workers < self.min_workers:
            raise ValueError(
                f"max_workers ({self.max_workers}) must be >= min_workers "
                f"({self.min_workers})"
            )
        for name in ("round_p95_ms", "max_defer_rate", "max_drop_rate",
                     "max_heartbeat_age_s"):
            v = getattr(self, name)
            if v is not None and v <= 0:
                raise ValueError(f"{name} must be positive, got {v}")


def _percentile(values: list[float], q: float) -> float | None:
    return None if not values else float(np.percentile(values, q))


class FleetController:
    """Watches a fleet's SLO signals and resizes it against a target.

    Parameters
    ----------
    fleet:
        The supervisor to steer (sequential or lane-parallel).
    slo:
        The :class:`SLOTarget` to hold.
    window:
        Sliding-window length, in rounds, over which latencies and counter
        deltas are aggregated.
    cooldown_rounds:
        Rounds to hold fire after any action (lets the previous action's
        effect show up in the window before judging again).
    scale_down_margin:
        Scale-down requires every watched signal below ``margin * target``
        — hysteresis so the fleet doesn't oscillate at the threshold.
    budget_growth:
        Multiplier applied to the admission round budget (or the per-stream
        cap when no budget is set) by the retune actuator.
    """

    def __init__(
        self,
        fleet: FleetSupervisor,
        slo: SLOTarget,
        *,
        window: int = 16,
        cooldown_rounds: int = 4,
        scale_down_margin: float = 0.5,
        budget_growth: int = 2,
    ):
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        if not 0 < scale_down_margin < 1:
            raise ValueError(
                f"scale_down_margin must be in (0, 1), got {scale_down_margin}"
            )
        self.fleet = fleet
        self.slo = slo
        self.cooldown_rounds = int(cooldown_rounds)
        self.scale_down_margin = float(scale_down_margin)
        self.budget_growth = int(budget_growth)
        self._round_ms: collections.deque = collections.deque(maxlen=window)
        self._served_d: collections.deque = collections.deque(maxlen=window)
        self._deferred_d: collections.deque = collections.deque(maxlen=window)
        self._dropped_d: collections.deque = collections.deque(maxlen=window)
        self._last = self._counters()
        self._cooldown = 0
        #: audit log: one dict per actuation, with the metrics behind it
        self.actions: list[dict] = []

    # -- observation ---------------------------------------------------------

    def _counters(self) -> dict:
        f = self.fleet
        return {
            "served": int(f.served_windows.sum()),
            "deferred": int(f.deferred_windows.sum()),
            "dropped": int(f.dropped_samples),
        }

    def observe(self, round_ms: float) -> None:
        """Record one completed fleet round: its wall-clock latency plus the
        served/deferred/dropped deltas since the previous observation."""
        self._round_ms.append(float(round_ms))
        cur = self._counters()
        self._served_d.append(cur["served"] - self._last["served"])
        self._deferred_d.append(cur["deferred"] - self._last["deferred"])
        # dropped_samples sums live workers only, so retiring a worker can
        # step the total; clamp deltas at 0 rather than report phantom drops
        self._dropped_d.append(max(0, cur["dropped"] - self._last["dropped"]))
        self._last = cur

    def metrics(self) -> dict:
        """Aggregate SLO signals over the sliding window."""
        lat = list(self._round_ms)
        served = sum(self._served_d)
        deferred = sum(self._deferred_d)
        dropped = sum(self._dropped_d)
        health = self.fleet.health()
        ages = [
            h["heartbeat_age_s"]
            for h in health
            if h["alive"] and h["heartbeat_age_s"] is not None
        ]
        return {
            "rounds": len(lat),
            "p50_ms": _percentile(lat, 50),
            "p95_ms": _percentile(lat, 95),
            "p99_ms": _percentile(lat, 99),
            "defer_rate": deferred / max(1, served + deferred),
            # dropped counts samples, served counts windows: normalise drops
            # per served window so the rate is dimensionless and bounded-ish
            "drop_rate": dropped / max(1, dropped + served),
            "max_heartbeat_age_s": max(ages) if ages else None,
            "n_live": self.fleet.n_live_workers,
        }

    # -- decision ------------------------------------------------------------

    def _breach(self, m: dict) -> str | None:
        """Name of the first watched signal above target, or None."""
        slo = self.slo
        if (
            slo.round_p95_ms is not None
            and m["p95_ms"] is not None
            and m["rounds"] >= self._round_ms.maxlen
            and m["p95_ms"] > slo.round_p95_ms
        ):
            return "p95_ms"
        if slo.max_drop_rate is not None and m["drop_rate"] > slo.max_drop_rate:
            return "drop_rate"
        if slo.max_defer_rate is not None and m["defer_rate"] > slo.max_defer_rate:
            return "defer_rate"
        return None

    def _headroom(self, m: dict) -> bool:
        """True when every watched signal sits under margin * target."""
        slo, margin = self.slo, self.scale_down_margin
        if m["rounds"] < self._round_ms.maxlen:
            return False  # not enough evidence to shrink on
        if slo.round_p95_ms is not None and not (
            m["p95_ms"] is not None and m["p95_ms"] < margin * slo.round_p95_ms
        ):
            return False
        if slo.max_drop_rate is not None and not (
            m["drop_rate"] < margin * slo.max_drop_rate
        ):
            return False
        if slo.max_defer_rate is not None and not (
            m["defer_rate"] < margin * slo.max_defer_rate
        ):
            return False
        return True

    def _stale_worker(self) -> int | None:
        if self.slo.max_heartbeat_age_s is None:
            return None
        stale = [
            h["worker"]
            for h in self.fleet.health()
            if h["alive"]
            and h["heartbeat_age_s"] is not None
            and h["heartbeat_age_s"] > self.slo.max_heartbeat_age_s
        ]
        return stale[0] if stale else None

    def _grown_admission(self):
        adm = self.fleet.admission
        if adm.round_budget is not None:
            return dataclasses.replace(
                adm, round_budget=adm.round_budget * self.budget_growth
            )
        return dataclasses.replace(
            adm,
            max_per_stream_per_round=(
                adm.max_per_stream_per_round * self.budget_growth
            ),
        )

    def actuate(self) -> dict | None:
        """Judge the current window and fire at most one actuator.  Returns
        the action record (also appended to :attr:`actions`), or None."""
        if self._cooldown > 0:
            self._cooldown -= 1
            return None
        m = self.metrics()
        slo = self.slo
        action: dict | None = None

        # 1) liveness: a stale heartbeat means a presumed-hung worker; fold
        #    its streams into a survivor (lossless) rather than wait on it
        stale = self._stale_worker()
        if stale is not None and m["n_live"] > slo.min_workers:
            if self.fleet.retire_worker(stale, reason="stale heartbeat"):
                action = {"kind": "retire_stale", "worker": stale}

        # 2) pressure: a breached target wants more parallelism — spawn a
        #    worker (a lane, when lanes are on); at the size cap, widen the
        #    admission budget instead if the pain is deferral
        if action is None:
            breach = self._breach(m)
            if breach is not None:
                if m["n_live"] < slo.max_workers:
                    idx = self.fleet.spawn_worker()
                    if idx is not None:
                        action = {"kind": "spawn", "worker": idx,
                                  "breach": breach}
                elif breach == "defer_rate":
                    adm = self._grown_admission()
                    self.fleet.retune_admission(adm)
                    action = {
                        "kind": "retune",
                        "breach": breach,
                        "round_budget": adm.round_budget,
                        "max_per_stream_per_round": adm.max_per_stream_per_round,
                    }

        # 3) headroom: everything comfortably under target — give back a
        #    worker (fold the least-loaded into the survivors, lossless)
        if (
            action is None
            and m["n_live"] > slo.min_workers
            and self._headroom(m)
        ):
            if self.fleet.retire_worker(reason="SLO headroom"):
                action = {"kind": "retire"}

        if action is not None:
            action["round"] = self.fleet.round
            action["metrics"] = m
            self.actions.append(action)
            self._cooldown = self.cooldown_rounds
        return action

    def step(self, round_ms: float) -> dict | None:
        """Convenience: :meth:`observe` then :meth:`actuate`."""
        self.observe(round_ms)
        return self.actuate()
