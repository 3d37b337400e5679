"""Shared continuous-batching/dispatch core for every serving surface.

The port's own copy of ``SlotPolicy``, ``BlockPool``, ``IngestQueue``,
``DispatchCore``, ``AdmissionPolicy`` and ``fair_allocation`` from
``repro/serving/batching.py``.  On the card, ``MonitorEngine`` copies each
packed block to the device before the forward returns, and on the CPU
``torch.from_numpy`` aliases the block; the ``inflight + 1`` rotation below
keeps both safe.

The paper's datapath wins by keeping *one* sequential engine saturated
instead of replicating hardware; the serving layer follows the same shape:
work items (ready acoustic windows, queued LM requests) are packed into
slot-blocks of a compiled program and rotated through a bounded in-flight
pipeline.  Before this module, the detector fleet
(``MonitorEngine``) and the LM side
(``BatchedServer``, ``repro_torch/launch/serve.py``) each carried a
private half-copy of that machinery; both now run on :class:`DispatchCore`.

The pieces, bottom up:

* :class:`SlotPolicy` — which slot counts (block batch sizes) a server may
  dispatch.  Fixed mode always uses ``max_slots`` (dead slots
  padded with silence/dead requests).  Adaptive mode grows and
  shrinks the block over a small power-of-two *ladder* between
  ``min_slots`` and ``max_slots`` to fit the ready backlog — at 1 live
  stream the engine dispatches 1-slot blocks instead of padding 7/8 slots.
  The ladder is deliberately tiny (``O(log2 max_slots)`` shapes) so a
  jitted forward compiles a bounded set of batch shapes instead of
  retracing per backlog size; every ladder value is a multiple of
  ``multiple`` so sharded dispatch keeps dividing evenly.
* :class:`BlockPool` — preallocated ``(slots, width)`` dispatch buffers,
  one rotation of ``inflight + 1`` buffers per slot shape.  a host-to-device
  transfer may alias host memory zero-copy, so a buffer must never be
  rewritten while its dispatch is still in flight; rotating ``inflight +
  1`` deep guarantees the buffer being packed is older than every
  unharvested submission (the invariant is held in one place for
  all slot shapes).
* :class:`DispatchCore` — the ready-work queue and the dispatch loop:
  split items into slot-blocks via the policy, ``submit`` each block
  (async handles welcome), harvest with at most ``inflight`` blocks
  outstanding, and reassemble per-item results *in submission order*.
  ``dispatch`` is all-or-nothing: either every item's result is returned
  (commit) or the exception propagates and the optional rollback hook
  fires with no partial results observable — the transactional-round
  protocol the monitor engine and the fleet supervisor's crash recovery
  are built on.  ``pre_dispatch`` is the fault-injection seam
  (the fleet's fault harness): called with the items before anything is
  submitted, it may raise (simulated crash) or stall, and the rollback
  guarantee makes the failed round re-runnable.
* :class:`AdmissionPolicy` / :func:`fair_allocation` — fleet-scale stream
  admission and per-tenant fairness on top of the core: cap how many
  ready windows one stream may drain per round, bound the total round
  budget with depth-fair allocation (no stream gets its second window
  before every ready stream got its first, so a firehose cannot starve a
  trickle), cap how many distinct streams are admitted at all, and evict
  streams that persistently overflow their ingest rings.

Every row's result is bitwise independent of its co-batch (per-sample
activation scales), which is exactly what makes elastic
re-batching safe: any grow/shrink schedule over any backlog produces the
same per-item numbers as the fixed-slot engine, and the conformance suites
hold that to ``==``, not a tolerance.
"""
from __future__ import annotations

import collections
import dataclasses
import threading
from typing import Any, Callable, Sequence

import numpy as np


class SlotPolicy:
    """Slot-count selection for one dispatch block.

    ``adaptive=False`` always dispatches
    ``max_slots`` and pads dead slots.  ``adaptive=True`` picks from a
    power-of-two ladder of multiples of ``multiple`` in
    ``[min_slots, max_slots]``: for a backlog of ``n`` items it chooses the
    largest ladder value that fits (``<= n``), falling back to the smallest
    ladder value that covers a sub-``min_slots`` remainder — so padding is
    bounded by ``min_slots``-granularity instead of ``max_slots``.
    """

    def __init__(
        self,
        max_slots: int,
        *,
        adaptive: bool = False,
        min_slots: int = 1,
        multiple: int = 1,
    ):
        if max_slots < 1:
            raise ValueError(f"max_slots must be >= 1, got {max_slots}")
        if min_slots < 1:
            raise ValueError(f"min_slots must be >= 1, got {min_slots}")
        if min_slots > max_slots:
            raise ValueError(
                f"min_slots {min_slots} must be <= max_slots {max_slots}"
            )
        if multiple < 1:
            raise ValueError(f"multiple must be >= 1, got {multiple}")
        if max_slots % multiple != 0:
            raise ValueError(
                f"max_slots {max_slots} must be a multiple of {multiple} "
                f"(sharded dispatch splits every block evenly)"
            )
        self.max_slots = int(max_slots)
        self.min_slots = int(min_slots)
        self.multiple = int(multiple)
        self.adaptive = bool(adaptive)
        if not adaptive:
            ladder = [self.max_slots]
        else:
            ladder, v = [self.max_slots], self.multiple
            while v < self.max_slots:
                if v >= self.min_slots:
                    ladder.append(v)
                v *= 2
        #: the complete set of block shapes this policy will ever dispatch —
        #: pre-jit each once (see ``MonitorEngine.precompile``) and adaptive
        #: serving never hits a compile stall mid-round.
        self.ladder: tuple[int, ...] = tuple(sorted(set(ladder)))

    @classmethod
    def fixed(cls, slots: int, *, multiple: int = 1) -> "SlotPolicy":
        return cls(slots, adaptive=False, multiple=multiple)

    def pick(self, backlog: int) -> int:
        """Slot count for the next block given ``backlog`` remaining items."""
        if backlog < 1:
            raise ValueError(f"backlog must be >= 1, got {backlog}")
        if not self.adaptive or backlog >= self.max_slots:
            return self.max_slots
        fitting = [s for s in self.ladder if s <= backlog]
        if fitting:
            return fitting[-1]  # largest block that fits: zero padding
        return self.ladder[0]  # sub-min remainder: smallest block, some pad

    def __repr__(self):
        mode = "adaptive" if self.adaptive else "fixed"
        return f"SlotPolicy({mode}, ladder={self.ladder})"


class BlockPool:
    """Preallocated dispatch buffers: ``inflight + 1`` rotating ``(slots,
    width)`` float32 blocks per slot shape, allocated lazily per shape.

    The rotation depth is the aliasing-safety invariant: with at most
    ``inflight`` submissions unharvested, the buffer being packed is always
    older than every in-flight one, so a zero-copy transfer can never
    observe a rewrite.  Shapes rotate independently — an in-flight block of
    one shape is untouched by packing another shape.
    """

    def __init__(self, width: int, inflight: int, dtype=np.float32):
        if width < 1:
            raise ValueError(f"width must be >= 1, got {width}")
        if inflight < 1:
            raise ValueError(f"inflight must be >= 1, got {inflight}")
        self.width = int(width)
        self.depth = int(inflight) + 1
        self.dtype = dtype
        self._pools: dict[int, list[np.ndarray]] = {}
        self._next: dict[int, int] = {}

    def pack(self, rows: Sequence[np.ndarray] | np.ndarray, slots: int) -> np.ndarray:
        """Copy ``rows`` into the next rotation buffer of shape ``(slots,
        width)``; dead-slot tails carry zeros (silence)."""
        n = len(rows)
        if n > slots:
            raise ValueError(f"{n} rows do not fit {slots} slots")
        pool = self._pools.get(slots)
        if pool is None:
            pool = [
                np.zeros((slots, self.width), self.dtype)
                for _ in range(self.depth)
            ]
            self._pools[slots] = pool
            self._next[slots] = 0
        i = self._next[slots]
        self._next[slots] = (i + 1) % self.depth
        block = pool[i]
        block[:n] = rows
        if n < slots:
            block[n:] = 0.0  # dead slots carry silence
        return block


class IngestQueue:
    """Thread-safe front-of-fleet ingest queue for lane-parallel serving.

    With execution lanes enabled, the fleet supervisor's ``push`` must never
    touch a worker engine directly — a lane may be mid-round on that engine.
    Producers ``append`` (never blocks, only a lock-protected deque append);
    the supervisor ``drain``s the whole backlog at the top of each round, on
    its own thread, and routes the items through the exact same admission /
    fault-injection / journal path the sequential fleet uses — so queued
    ingest changes *when* a chunk is delivered, never *what* is delivered,
    and the lane-parallel fleet stays bitwise equal to the sequential one.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._items: collections.deque = collections.deque()

    def append(self, item) -> None:
        with self._lock:
            self._items.append(item)

    def drain(self) -> list:
        """Swap out and return the queued items, oldest first."""
        with self._lock:
            items, self._items = self._items, collections.deque()
        return list(items)

    def __len__(self) -> int:
        with self._lock:
            return len(self._items)


class DispatchCore:
    """Queue → slot-blocks → bounded in-flight rotation → ordered results.

    Generic over the work item and the block program:

    ``submit(live_items, slots)``
        Dispatch one block of ``slots`` slots holding ``live_items`` (at
        most ``slots`` of them; the callee pads dead slots).  May return an
        async handle (e.g. an in-flight device tensor) — submission must not
        block on the result, that is what gives the double-buffered
        overlap.
    ``harvest(handle)``
        Block until the handle's results are ready; return an indexable of
        per-slot results (only the first ``len(live_items)`` are read).
        ``None`` means ``submit`` is synchronous and already returns the
        per-item results.

    ``dispatch(items)`` is all-or-nothing: the optional ``pre_dispatch``
    hook (the fault-injection seam) runs first and may raise; any exception
    from it, ``submit`` or ``harvest`` triggers ``on_rollback`` and
    propagates with no partial results observable, so a transactional
    caller can simply retry the identical round.  On success ``on_commit``
    fires and every item's result is returned in input order.
    """

    def __init__(
        self,
        *,
        submit: Callable[[Any, int], Any],
        harvest: Callable[[Any], Any] | None = None,
        slot_policy: SlotPolicy,
        inflight: int = 1,
        pre_dispatch: Callable[[Any], None] | None = None,
        on_commit: Callable[[Any, list], None] | None = None,
        on_rollback: Callable[[Any], None] | None = None,
    ):
        if inflight < 1:
            raise ValueError(f"inflight must be >= 1, got {inflight}")
        self._submit = submit
        self._harvest = harvest
        self.slot_policy = slot_policy
        self.inflight = int(inflight)
        self.pre_dispatch = pre_dispatch
        self.on_commit = on_commit
        self.on_rollback = on_rollback
        self.queue: collections.deque = collections.deque()
        # observability: what the dispatch loop actually did
        self.blocks_dispatched = 0
        self.padded_slots = 0
        self.slot_histogram: dict[int, int] = {}

    # -- ready-work queue ----------------------------------------------------

    def enqueue(self, items) -> None:
        """Append work items to the ready queue (see :meth:`drain`)."""
        self.queue.extend(items)

    def drain(self) -> list:
        """Dispatch everything currently queued, in arrival order."""
        items = list(self.queue)
        self.queue.clear()
        if not items:
            return []
        try:
            return self.dispatch(items)
        except Exception:
            # rollback: the work is not lost — it goes back to the front of
            # the queue so a recovered caller can drain() again
            self.queue.extendleft(reversed(items))
            raise

    # -- the dispatch loop ---------------------------------------------------

    def dispatch(self, items) -> list:
        """Run ``items`` through slot-blocks; all-or-nothing (see class
        docstring).  Returns one result per item, in input order."""
        try:
            if self.pre_dispatch is not None:
                # fault-injection seam: may raise (crash) or stall; nothing
                # has been submitted yet either way
                self.pre_dispatch(items)
            results = self._run(items)
        except Exception:
            if self.on_rollback is not None:
                self.on_rollback(items)
            raise
        if self.on_commit is not None:
            self.on_commit(items, results)
        return results

    def _run(self, items) -> list:
        n = len(items)
        results: list = [None] * n
        pending: collections.deque[tuple[int, int, Any]] = collections.deque()

        def harvest_one():
            # blocking on the oldest in-flight block also means the device
            # has consumed its input buffer, so the BlockPool rotation may
            # safely rewrite it on a later turn
            start, n_live, handle = pending.popleft()
            out = self._harvest(handle)
            for j in range(n_live):
                results[start + j] = out[j]

        i = 0
        while i < n:
            slots = self.slot_policy.pick(n - i)
            live = items[i : i + slots]
            n_live = len(live)
            out = self._submit(live, slots)
            self.blocks_dispatched += 1
            self.padded_slots += slots - n_live
            self.slot_histogram[slots] = self.slot_histogram.get(slots, 0) + 1
            if self._harvest is None:  # synchronous program
                for j in range(n_live):
                    results[i + j] = out[j]
            else:
                pending.append((i, n_live, out))
                if len(pending) >= self.inflight:
                    harvest_one()
            i += n_live
        while pending:
            harvest_one()
        return results


@dataclasses.dataclass(frozen=True)
class AdmissionPolicy:
    """Stream admission, per-tenant fairness and eviction knobs for a
    fleet-scale monitor (consumed by :class:`~repro_torch.serving.engine.
    MonitorEngine`; the defaults serve every stream, one window per round).

    ``max_streams``
        At most this many *distinct* streams are admitted, first come first
        served; pushes to a stream refused at admission are dropped and
        counted (``refused_chunks``), never scored.  ``None`` admits every
        stream the engine was built for.
    ``max_per_stream_per_round``
        A stream with backlog may drain up to this many ready windows in
        one ``step()`` round (1 = the classic one-window beat).  Raising it
        lets a stream catch up after a stall without unbounded rounds.
    ``round_budget``
        Cap on the total windows scored per round.  When the fleet backlog
        exceeds it, :func:`fair_allocation` serves streams depth-fair: no
        stream gets its second window before every ready stream got its
        first, so one firehose stream cannot starve a trickle stream's
        latency.  ``None`` = unbounded.
    ``evict_overflow_rounds``
        A stream whose ring overflowed (dropped samples) in this many
        *consecutive* committed rounds is evicted: de-admitted, its pushes
        refused from then on.  The fleet supervisor additionally rebuilds
        the worker without the stream (the reassignment machinery), so the
        abusive tenant stops costing slots entirely.  ``None`` disables
        eviction.
    """

    max_streams: int | None = None
    max_per_stream_per_round: int = 1
    round_budget: int | None = None
    evict_overflow_rounds: int | None = None

    def __post_init__(self):
        if self.max_streams is not None and self.max_streams < 1:
            raise ValueError(
                f"max_streams must be >= 1 or None, got {self.max_streams}"
            )
        if self.max_per_stream_per_round < 1:
            raise ValueError(
                f"max_per_stream_per_round must be >= 1, got "
                f"{self.max_per_stream_per_round}"
            )
        if self.round_budget is not None and self.round_budget < 1:
            raise ValueError(
                f"round_budget must be >= 1 or None, got {self.round_budget}"
            )
        if (
            self.evict_overflow_rounds is not None
            and self.evict_overflow_rounds < 1
        ):
            raise ValueError(
                f"evict_overflow_rounds must be >= 1 or None, got "
                f"{self.evict_overflow_rounds}"
            )


def fair_allocation(want: np.ndarray, budget: int | None) -> np.ndarray:
    """Depth-fair allocation of ``budget`` units over per-stream demands.

    ``want[i]`` is how many windows stream ``i`` wants this round (already
    capped by ``max_per_stream_per_round``).  With no budget, or a budget
    that covers the total demand, everyone gets what they want.  Otherwise
    units are granted depth by depth — every stream with unmet demand gets
    its d-th unit before any stream gets its (d+1)-th — and ties at the
    budget boundary break by stream index (deterministic).  This is the
    fairness guarantee: a firehose stream's backlog can never displace
    another stream's *first* window of the round.
    """
    want = np.asarray(want, np.int64)
    if (want < 0).any():
        raise ValueError("want must be non-negative")
    if budget is None or int(want.sum()) <= budget:
        return want.copy()
    alloc = np.zeros_like(want)
    remaining = int(budget)
    depth = 0
    while remaining > 0:
        eligible = np.flatnonzero(want > depth)
        if eligible.size == 0:
            break
        grant = eligible[:remaining]
        alloc[grant] += 1
        remaining -= grant.size
        depth += 1
    return alloc
