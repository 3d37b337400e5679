"""Fault-tolerant fleet supervisor over a pool of monitor engines.

Counterpart of ``repro/serving/supervisor.py``.  Every worker is the port's
:class:`~repro_torch.serving.engine.MonitorEngine` on the fleet's device
(``device`` in the engine keywords, CUDA by default; without a GPU the
fleet raises unless ``device="cpu"`` is given), built from one artifact
that is moved to that device once, here: a rebuilt worker neither
quantises nor copies weights, and on the card it finds K2's packed weights
already cached (``conv1d_fused.packed_weight``).  With ``lanes="threads"``
the lanes launch K1, K2 and K3 concurrently on the device's current
stream, which orders the launches (K1's split-K workspace is one per
stream) and which each lane's harvest (``.cpu()``) waits on.

A field deployment runs for weeks: microphones emit garbage, a driver bug
raises mid-forward, a dispatch hangs, a worker process dies.  The
supervisor keeps the *fleet* alive through all of it while preserving the
repo's central numeric contract — per-sample activation scales make every
window's score independent of its co-batch, so recovery can be held to a
bitwise standard, not a tolerance:

* **worker pool** — global streams are partitioned into contiguous groups,
  one :class:`~repro_torch.serving.engine.MonitorEngine` per group, all built
  from the *same immutable baked artifact* (weights are never part of any
  recovery path, so rebuilding a worker is cheap and exact);
* **execution lanes** — with ``lanes="threads"`` every worker gets a named
  lane thread that runs its engine's ingest→dispatch→harvest beat, so one
  worker's host feature extraction overlaps another worker's device
  scoring through the dispatch core's in-flight rotation.  Ingest enters a
  shared front-of-fleet :class:`~repro_torch.serving.batching.IngestQueue` and
  is routed to workers through the ``_route`` table at the top of each
  round on the supervisor thread, so delivery (admission, chunk faults,
  journaling) is identical to the sequential fleet; fleet-level mutations
  (eviction, retirement, spawning) are deferred to the supervisor thread
  at the end of the round.  Per-stream outputs are bitwise equal across
  {lane-parallel fleet, sequential fleet, monolithic engine} — the lane
  conformance tests pin all three, with and without fault plans;
* **health** — each worker carries a heartbeat (clock time of its last
  successful round); a round that overruns ``dispatch_deadline_s`` on the
  supervisor's clock is classified as a *stall* rather than a crash;
* **crash recovery** — after every successful round a worker's state is
  snapshotted (``last_good``) and its push journal cleared; on a crash,
  stall, or kill the supervisor rebuilds the engine from the artifact,
  ``restore``s ``last_good``, replays the journal (chunks pushed since the
  snapshot), and re-runs the round.  The transactional
  :meth:`~repro_torch.serving.engine.MonitorEngine.step` guarantees the failed
  attempt committed nothing, so the re-run scores the *same* windows —
  recovery is lossless and bitwise.  The re-run happens *inside* the same
  revive/retire loop, so a second consecutive failure (or a transient
  error during the recovery re-run itself) is absorbed the same way,
  bounded by ``max_rebuilds`` — ``step()`` never raises on worker faults;
* **reassignment** — a worker that keeps dying (``rebuilds >
  max_rebuilds``) is retired: its revived per-stream state (ring
  snapshots, tracker arrays, events, counters) is spliced into a surviving
  worker rebuilt for the combined stream set.  The migrated streams keep
  their exact EMA trajectories and window indices, so even a permanently
  dead worker costs zero samples and zero numeric drift;
* **durability** — with ``state_dir`` the same ``last_good`` + journal
  machinery is mirrored to disk (:mod:`repro_torch.serving.durability`): each
  worker's snapshots go to a versioned CRC-framed checkpoint store, every
  delivered chunk is appended to a per-worker write-ahead journal *before*
  it reaches the engine, and a fleet meta-checkpoint — always written last,
  always the restore authority — pins topology, counters, admission state
  and per-worker checkpoint versions.  :meth:`restore_from_dir` rebuilds
  the fleet after a SIGKILL / power loss from artifact + newest valid meta
  + pinned checkpoints + WAL replay (torn tails truncated, never raised);
  the driver then re-delivers each stream from the restored
  ``pushed_chunks`` cursor and the resumed run is bitwise identical to an
  uninterrupted one (``tests/test_torch_durability.py`` pins this cold-restart
  contract; disk faults are injected through the
  :class:`~repro_torch.serving.faults.FaultyFilesystem` seam);
* **elasticity** — the same snapshot/splice machinery powers deliberate
  resizing for the SLO loop (:mod:`repro_torch.serving.controller`):
  :meth:`spawn_worker` splits the most-loaded worker's streams into a new
  worker, :meth:`retire_worker` folds a worker back into the survivors,
  and :meth:`retune_admission` swaps the fleet's admission budgets — all
  bitwise lossless for every stream.

Fault injection (:mod:`repro_torch.serving.faults`) enters through exactly two
seams — chunk faults in :meth:`push`, worker faults via the engine's
``fault_hook`` — and is ``None`` in production.  Worker faults are keyed on
``(round, worker)`` and each worker's beat runs in its own named lane, so a
plan injects deterministically into the same lane with and without
concurrency.  The chaos suite in ``tests/test_torch_fleet.py`` drives
seeded plans through this class and asserts the fleet never crashes and
unaffected streams are bitwise identical to a fault-free run.
"""
from __future__ import annotations

import dataclasses
import os
import queue
import threading
import time

import numpy as np

from repro_torch.kernels.backend import resolve_device
from repro_torch.models.cnn1d import CNNConfig
from repro_torch.serving.batching import AdmissionPolicy, IngestQueue
from repro_torch.serving.durability import (
    WAL_DROPPED,
    WAL_FAULTED,
    CheckpointStore,
    ChunkWAL,
    LocalFilesystem,
)
from repro_torch.serving.engine import MonitorEngine, WindowScore
from repro_torch.serving.faults import (
    FaultPlan,
    FaultyFilesystem,
    InjectedFault,
    StalledForward,
)
from repro_torch.serving.quantized_params import QuantizedParams
from repro_torch.serving.tracker import TrackEvent

#: engine counters that describe the whole engine's history (scalars), as
#: opposed to the per-stream arrays; a spawned worker starts these at zero
#: so fleet-level sums stay conserved across a split.
_SCALAR_COUNTERS = (
    "windows_scored", "forward_calls", "padded_slots", "rounds",
    "dropped_samples",
)


class _Worker:
    """Bookkeeping for one engine in the pool (not part of the public API)."""

    def __init__(self, idx: int, engine: MonitorEngine | None,
                 streams: list[int]):
        self.idx = idx
        self.engine: MonitorEngine | None = engine
        self.streams = list(streams)  # global ids; position = local stream id
        # state after the last good round (None only for a worker being
        # rebuilt dead from the durable meta-checkpoint)
        self.last_good = None if engine is None else engine.snapshot()
        self.journal: list[tuple[int, np.ndarray]] = []  # pushes since then
        # per-global-stream delivery cursor / transport-fault count at the
        # moment last_good was taken: a durable checkpoint of last_good must
        # pin the same cursor, or WAL replay and driver re-delivery would
        # double- or under-apply chunks after a cold restart
        self.good_pushed: dict[int, int] = {int(g): 0 for g in self.streams}
        self.good_faulted: dict[int, int] = {int(g): 0 for g in self.streams}
        self.rebuilds = 0
        self.alive = True
        self.last_heartbeat: float | None = None
        # Deferred fleet-level actions: a lane must never splice streams into
        # another worker (its lane may be mid-round), so eviction and
        # retirement are recorded here and applied by the supervisor thread
        # at the end of the round.
        self.pending_evict: list[int] = []
        self.retire_pending = False


class _ExecutionLane:
    """One worker's execution lane: a named daemon thread that runs the
    worker's round beat when the supervisor signals it, independently of
    every other lane.  The lane name (``lane-<worker>``) shows up in
    faulthandler dumps and ties fault injection — keyed on the worker
    index — to the thread that executes it."""

    def __init__(self, idx: int):
        self.name = f"lane-{idx}"
        self._work: queue.SimpleQueue = queue.SimpleQueue()
        self._done: queue.SimpleQueue = queue.SimpleQueue()
        self._thread = threading.Thread(
            target=self._loop, name=self.name, daemon=True
        )
        self._thread.start()

    def submit(self, fn, *args) -> None:
        self._work.put((fn, args))

    def result(self):
        ok, val = self._done.get()
        if ok:
            return val
        raise val

    def _loop(self):
        while True:
            item = self._work.get()
            if item is None:
                return
            fn, args = item
            try:
                self._done.put((True, fn(*args)))
            except BaseException as exc:  # noqa: BLE001 — relayed to caller
                self._done.put((False, exc))

    def close(self):
        self._work.put(None)
        self._thread.join(timeout=5.0)


class _LanePool:
    """The fleet's named execution lanes, one per worker index.  Lanes are
    created on demand (spawned workers get a fresh lane) and retired lanes
    simply idle — a lane is only ever driven by the supervisor thread."""

    def __init__(self):
        self._lanes: dict[int, _ExecutionLane] = {}

    def ensure(self, idx: int) -> None:
        if idx not in self._lanes:
            self._lanes[idx] = _ExecutionLane(idx)

    def name(self, idx: int) -> str | None:
        lane = self._lanes.get(idx)
        return None if lane is None else lane.name

    def submit(self, idx: int, fn, *args) -> None:
        self._lanes[idx].submit(fn, *args)

    def result(self, idx: int):
        return self._lanes[idx].result()

    def close(self):
        for lane in self._lanes.values():
            lane.close()
        self._lanes.clear()


def _merge_snapshots(dst: dict, src: dict) -> dict:
    """Splice ``src``'s per-stream state after ``dst``'s: the combined
    snapshot restores into an engine built for the combined stream count.
    Per-stream fields concatenate; whole-engine counters add; pending
    eviction ids (local stream indices) are re-based onto the combined
    numbering."""
    tracker = {
        k: (dst["tracker"][k] + src["tracker"][k]
            if k == "events"
            else np.concatenate([dst["tracker"][k], src["tracker"][k]]))
        for k in dst["tracker"]
    }
    counters = {}
    for k, v in dst["counters"].items():
        sv = src["counters"][k]
        counters[k] = (
            np.concatenate([v, sv]) if isinstance(v, np.ndarray) else v + sv
        )
    n_dst = len(dst["rings"])
    pending = list(dst.get("pending_evictions", [])) + [
        n_dst + int(l) for l in src.get("pending_evictions", [])
    ]
    return {
        "rings": list(dst["rings"]) + list(src["rings"]),
        "pending_evictions": pending,
        "tracker": tracker,
        "counters": counters,
    }


def _subset_snapshot(snap: dict, keep: list[int], *, zero_scalars: bool = False) -> dict:
    """Project a snapshot onto the ``keep`` local-stream indices (in order):
    the inverse of :func:`_merge_snapshots`, used when eviction removes
    streams from a worker and when :meth:`FleetSupervisor.spawn_worker`
    splits one.  Per-stream fields are sliced; pending eviction ids are
    remapped (dropped streams' pending evictions vanish with them);
    whole-engine scalar counters are kept as-is (they describe the engine's
    history, which includes the departed streams) unless ``zero_scalars``
    — the spawn path zeroes them on the spun-off half so fleet-level sums
    stay conserved."""
    tracker = {
        k: ([snap["tracker"][k][i] for i in keep]
            if k == "events"
            else np.asarray(snap["tracker"][k])[keep])
        for k in snap["tracker"]
    }
    counters = {}
    for k, v in snap["counters"].items():
        if isinstance(v, np.ndarray):
            counters[k] = np.asarray(v)[keep]
        else:
            counters[k] = 0 if (zero_scalars and k in _SCALAR_COUNTERS) else v
    remap = {int(old): new for new, old in enumerate(keep)}
    pending = [
        remap[int(l)]
        for l in snap.get("pending_evictions", [])
        if int(l) in remap
    ]
    return {
        "rings": [snap["rings"][i] for i in keep],
        "pending_evictions": pending,
        "tracker": tracker,
        "counters": counters,
    }


class FleetSupervisor:
    """Health-checked pool of monitor engines with lossless recovery.

    Parameters
    ----------
    artifact:
        A pre-baked :class:`QuantizedParams`.  The supervisor deliberately
        refuses an fp32 checkpoint: workers must be rebuildable from an
        immutable shared artifact, and quantise-once is what makes a
        rebuilt worker numerically identical to the dead one.
    n_streams / n_workers:
        Global stream count, partitioned contiguously over the workers.
    lanes:
        ``None`` (default) steps the workers sequentially on the caller's
        thread.  ``"threads"`` gives each worker a named execution lane:
        all live workers' round beats run concurrently (host feature
        extraction for one overlaps device scoring for another) and
        :meth:`push` becomes a non-blocking enqueue onto a shared ingest
        queue drained at the top of each round.  Per-stream results are
        bitwise identical either way.
    dispatch_deadline_s:
        A worker round that takes longer than this (on ``clock``) is
        classified as a stall in the incident log.
    max_rebuilds:
        After this many revivals a worker is retired and its streams are
        migrated (statefully, bitwise) to the least-loaded survivor.
    clock:
        Zero-arg monotonic-seconds callable, or an object with ``now()``
        (e.g. :class:`~repro_torch.serving.faults.FaultClock` in tests).
    faults:
        Optional :class:`FaultPlan` — the deterministic chaos harness.
        ``None`` (production) makes every fault seam a no-op.  A plan with
        disk faults auto-wraps the filesystem seam in
        :class:`~repro_torch.serving.faults.FaultyFilesystem` (unless ``fs`` is
        given explicitly).
    state_dir:
        Directory for durable crash-safe state (``None`` = in-memory
        recovery only).  Each worker gets a versioned
        :class:`~repro_torch.serving.durability.CheckpointStore` of its
        ``last_good`` snapshots plus a
        :class:`~repro_torch.serving.durability.ChunkWAL` of delivered chunks;
        a ``fleet/`` meta-checkpoint pins the topology, counters and
        checkpoint versions.  Restart via :meth:`restore_from_dir`.
    fs / fsync / fsync_interval / checkpoint_interval / retain_checkpoints:
        Durability knobs (with ``state_dir``): the injectable filesystem
        seam, the WAL fsync policy (``always`` | ``interval`` | ``never``),
        checkpoint cadence in rounds (1 = every round, the exact-restart
        setting), and how many checkpoint versions to keep per store.
    """

    def __init__(
        self,
        artifact: QuantizedParams,
        cfg: CNNConfig,
        *,
        n_streams: int,
        n_workers: int = 2,
        lanes: str | None = None,
        dispatch_deadline_s: float = 30.0,
        max_rebuilds: int = 3,
        clock=None,
        faults: FaultPlan | None = None,
        state_dir: str | None = None,
        fs=None,
        fsync: str = "interval",
        fsync_interval: int = 8,
        checkpoint_interval: int = 1,
        retain_checkpoints: int = 3,
        **engine_kw,
    ):
        if not isinstance(artifact, QuantizedParams):
            raise ValueError(
                "FleetSupervisor requires a pre-baked QuantizedParams "
                "artifact (quantize_params(...)): worker recovery rebuilds "
                "engines from it, so it must be immutable and shared"
            )
        if n_streams < 1:
            raise ValueError(f"n_streams must be >= 1, got {n_streams}")
        if not 1 <= n_workers <= n_streams:
            raise ValueError(
                f"n_workers must be in 1..{n_streams} (one stream per worker "
                f"minimum), got {n_workers}"
            )
        if dispatch_deadline_s <= 0:
            raise ValueError(
                f"dispatch_deadline_s must be positive, got {dispatch_deadline_s}"
            )
        if lanes not in (None, "threads"):
            raise ValueError(
                f"lanes must be None (sequential) or 'threads', got {lanes!r}"
            )
        # the fleet's device: every worker's engine runs there, and the
        # artifact is moved there once so that no rebuild copies weights
        self.device = resolve_device(engine_kw.get("device", "cuda"))
        self._qp = (artifact if artifact.device.type == self.device.type
                    else artifact.to(self.device))
        self.cfg = cfg
        self.n_streams = n_streams
        self.dispatch_deadline_s = float(dispatch_deadline_s)
        self.max_rebuilds = int(max_rebuilds)
        self._engine_kw = dict(engine_kw, device=self.device)
        self._clock_obj = clock if clock is not None else time.monotonic
        self._now = getattr(self._clock_obj, "now", self._clock_obj)
        self.faults = faults
        self.round = 0  # ingest/scoring round counter (fault plans key on it)
        self.incidents: list[dict] = []
        self._incident_lock = threading.Lock()
        # chunk-fault observability (distinct from the engines' sanitize
        # counters: these count what the *transport* did, per global stream)
        self.faulted_chunks = np.zeros(n_streams, np.int64)
        # Fleet-level admission: ``max_streams`` is a *fleet* cap, so the
        # first-come gate lives here (workers would otherwise each admit
        # their first max_streams local streams); the rest of the policy —
        # per-round fairness budget, overflow eviction — stays per worker
        # and travels down via engine_kw.  Evicted streams are removed from
        # their worker outright (the reassignment machinery, in reverse);
        # pushes to refused or evicted streams are counted and dropped.
        adm = self._engine_kw.get("admission")
        self._max_streams = None if adm is None else adm.max_streams
        if self._max_streams is not None:
            self._engine_kw["admission"] = dataclasses.replace(
                adm, max_streams=None
            )
        self._seen: set[int] = set()
        self._refused: set[int] = set()
        self.evicted: set[int] = set()
        self.refused_chunks = np.zeros(n_streams, np.int64)
        self._evicted_events: dict[int, list[TrackEvent]] = {}
        # Final per-stream counter totals of evicted streams, stashed at
        # eviction time so ``served_windows``/``deferred_windows`` keep
        # reporting them after the worker is rebuilt without the stream.
        self._final_counters: dict[int, dict[str, int]] = {}

        # -- durable state (checkpoints + write-ahead chunk journals) ------
        # ``pushed_chunks`` is the per-global-stream delivery cursor: every
        # driver push attempt (admitted, faulted, refused) advances it, so a
        # restarted driver knows exactly which chunks the restored state
        # already embeds and re-delivers only the rest.
        if checkpoint_interval < 1:
            raise ValueError(
                f"checkpoint_interval must be >= 1, got {checkpoint_interval}"
            )
        self.state_dir = state_dir
        self.checkpoint_interval = int(checkpoint_interval)
        self._fsync = fsync
        self._fsync_interval = int(fsync_interval)
        self._retain_checkpoints = int(retain_checkpoints)
        self.pushed_chunks = np.zeros(n_streams, np.int64)
        self.replayed_chunks = 0  # chunks rebuilt from WAL on restore
        self.wal_errors = 0  # WAL appends/resets lost to disk faults
        self.ckpt_errors = 0  # checkpoint saves/loads lost to disk faults
        self._ckpt_seq = 0  # monotonic version shared by worker+fleet ckpts
        self._ckpt_versions: dict[int, int] = {}  # worker -> last saved ver
        self._splice_dirty = False  # topology changed since the last persist
        self._fs = None
        self._fleet_store: CheckpointStore | None = None
        self._stores: dict[int, CheckpointStore] = {}
        self._wals: dict[int, ChunkWAL] = {}
        if state_dir is not None:
            f = fs if fs is not None else LocalFilesystem()
            if fs is None and faults is not None and faults.has_disk_faults:
                f = FaultyFilesystem(f, faults, clock=self._clock_obj)
            self._fs = f
            self._fleet_store = CheckpointStore(
                os.path.join(state_dir, "fleet"), fs=f,
                retain=self._retain_checkpoints,
            )

        groups = np.array_split(np.arange(n_streams), n_workers)
        self.workers = [
            _Worker(i, self._build_engine(len(g)), [int(s) for s in g])
            for i, g in enumerate(groups)
        ]
        self._route: dict[int, tuple[int, int]] = {}
        for w in self.workers:
            for local, g in enumerate(w.streams):
                self._route[g] = (w.idx, local)
        self.lanes = lanes
        self._lanes: _LanePool | None = None
        self._ingest: IngestQueue | None = None
        if lanes == "threads":
            self._lanes = _LanePool()
            for w in self.workers:
                self._lanes.ensure(w.idx)
            self._ingest = IngestQueue()
        for w in self.workers:
            self._attach_worker_storage(w.idx)

    def _build_engine(self, n_streams: int) -> MonitorEngine:
        return MonitorEngine(
            self._qp, self.cfg, n_streams=n_streams, **self._engine_kw
        )

    def _attach_worker_storage(self, idx: int) -> None:
        """Create (idempotently) the checkpoint store + WAL for one worker
        index.  No-op without a state dir."""
        if self.state_dir is None or idx in self._wals:
            return
        root = os.path.join(self.state_dir, f"worker-{idx:03d}")
        self._stores[idx] = CheckpointStore(
            root, fs=self._fs, retain=self._retain_checkpoints
        )
        self._wals[idx] = ChunkWAL(
            os.path.join(root, "wal.log"), fs=self._fs,
            fsync=self._fsync, fsync_interval=self._fsync_interval,
        )

    def _stamp_good(self, w: _Worker) -> None:
        """Mark the worker's current engine state as its last good state
        and pin the per-stream delivery cursors / fault counts that state
        embeds (what a durable checkpoint of it must record)."""
        w.last_good = w.engine.snapshot()
        w.journal.clear()
        w.good_pushed = {
            int(g): int(self.pushed_chunks[g]) for g in w.streams
        }
        w.good_faulted = {
            int(g): int(self.faulted_chunks[g]) for g in w.streams
        }

    # -- ingest --------------------------------------------------------------

    def push(self, stream: int, samples: np.ndarray) -> int:
        """Route one chunk to its worker (journaled for crash replay).

        Chunks for streams refused at the fleet admission cap, or evicted
        for persistent overflow, are dropped (counted in
        ``refused_chunks``) — only a stream id the fleet was never built
        for raises.

        With execution lanes the push is a non-blocking append onto the
        shared front-of-fleet ingest queue (safe while a round is in
        flight); delivery — admission, chunk faults, journaling — happens
        on the supervisor thread at the top of the next :meth:`step`,
        through the identical routing path, and the return value is 0
        (overflow is still visible in ``dropped_samples``)."""
        if self._ingest is not None:
            if not 0 <= stream < self.n_streams:
                raise ValueError(
                    f"stream index {stream} out of range for a fleet with "
                    f"{self.n_streams} stream(s)"
                )
            # np.array copies: the caller may reuse its chunk buffer before
            # the queue is drained.
            self._ingest.append(
                (stream, np.array(samples, np.float32).reshape(-1))
            )
            return 0
        return self._ingest_one(stream, samples)

    def _ingest_one(self, stream: int, samples: np.ndarray) -> int:
        """Deliver one chunk: fleet admission, fault injection, journal,
        worker push.  Runs on the supervisor thread in both lane modes."""
        if stream in self.evicted or stream in self._refused:
            self.refused_chunks[stream] += 1
            self.pushed_chunks[stream] += 1  # the cursor counts refusals too
            return 0
        if stream not in self._route:
            raise ValueError(
                f"stream index {stream} out of range for a fleet with "
                f"{self.n_streams} stream(s)"
            )
        if stream not in self._seen:
            if (
                self._max_streams is not None
                and len(self._seen) >= self._max_streams
            ):
                self._refused.add(stream)
                self.refused_chunks[stream] += 1
                self.pushed_chunks[stream] += 1
                return 0
            self._seen.add(stream)
        seq = int(self.pushed_chunks[stream])
        self.pushed_chunks[stream] += 1
        w_idx, local = self._route[stream]
        w = self.workers[w_idx]
        x = np.asarray(samples, np.float32).reshape(-1)

        fault = (
            self.faults.chunk_fault(self.round, stream) if self.faults else None
        )
        flags = 0
        if fault is not None:
            self.faulted_chunks[stream] += 1
            flags = WAL_FAULTED
            if fault.kind == "drop_chunk":
                # the transport ate it — a WAL marker record keeps the
                # delivery cursor and fault counter exact across a restart
                # even though nothing reaches the engine
                self._journal_disk(
                    w, stream=stream, seq=seq,
                    flags=WAL_FAULTED | WAL_DROPPED,
                )
                return 0
            if fault.kind == "corrupt_chunk":
                x = x.copy()
                x[::7] = np.nan  # deterministic poison pattern
            elif fault.kind == "jitter_chunk" and len(x) >= 2:
                # content-preserving re-segmentation: same samples, two
                # pushes sharing one cursor seq; only the first record
                # carries FAULTED so replay counts the fault once
                cut = max(1, min(len(x) - 1, int(len(x) * fault.magnitude)))
                return self._deliver(
                    w, local, x[:cut], stream=stream, seq=seq, flags=flags
                ) + self._deliver(w, local, x[cut:], stream=stream, seq=seq)
        return self._deliver(w, local, x, stream=stream, seq=seq, flags=flags)

    def _deliver(self, w: _Worker, local: int, chunk: np.ndarray, *,
                 stream: int, seq: int, flags: int = 0) -> int:
        # Journal BEFORE delivery — in memory for in-process revives, on
        # disk for cold restarts: if the push itself dies mid-flight both
        # replays still re-attempt it.  The journals store the raw chunk
        # (post-transport-fault, pre-sanitize); replaying through
        # engine.push re-applies the same deterministic sanitize decisions
        # and counters.
        w.journal.append((local, chunk.copy()))
        self._journal_disk(w, stream=stream, seq=seq, chunk=chunk, flags=flags)
        return w.engine.push(local, chunk)

    def _journal_disk(self, w: _Worker, *, stream: int, seq: int,
                      chunk: np.ndarray | None = None, flags: int = 0) -> None:
        wal = self._wals.get(w.idx)
        if wal is None:
            return
        try:
            wal.append(stream=stream, seq=seq, round_=self.round,
                       chunk=chunk, flags=flags)
        except (OSError, InjectedFault):
            # durability degraded (counted), never fatal: the chunk is
            # still delivered and still in the in-memory journal
            self.wal_errors += 1

    # -- scoring -------------------------------------------------------------

    def step(self) -> list[WindowScore]:
        """Score one fleet round: at most one window per stream, across all
        live workers.  Never raises on worker faults — crashes, stalls and
        kills are caught, logged to :attr:`incidents`, and recovered
        losslessly before the round completes.

        With execution lanes every live worker's beat runs concurrently in
        its named lane; results are joined in worker order, and deferred
        fleet-level actions (eviction, retirement) are applied serially on
        this thread afterwards, so the observable per-stream behaviour is
        identical to the sequential fleet."""
        if self._ingest is not None:
            for stream, samples in self._ingest.drain():
                self._ingest_one(stream, samples)
        live = [w for w in self.workers if w.alive]
        if self._lanes is None:
            results = [self._step_worker(w) for w in live]
        else:
            for w in live:
                self._lanes.submit(w.idx, self._step_worker, w)
            results = [self._lanes.result(w.idx) for w in live]
        out: list[WindowScore] = []
        for r in results:
            out.extend(r)
        # Deferred fleet-level mutations, serialized in worker order: a lane
        # must never rebuild another worker's engine mid-round.
        for w in live:
            if w.alive and w.pending_evict:
                evictions, w.pending_evict = list(w.pending_evict), []
                self._evict(w, evictions)
            if w.alive and w.retire_pending:
                w.retire_pending = False
                self._reassign(w)
        self.round += 1
        self._persist()
        return out

    def _step_worker(self, w: _Worker) -> list[WindowScore]:
        hook = None
        if self.faults is not None:
            for f in self.faults.worker_faults(self.round, w.idx):
                if f.kind == "kill_worker":
                    # the process died between rounds: the engine object is
                    # simply gone — rebuild from artifact + snapshot + journal
                    w.engine = None
                    self._incident(w, "kill", "worker process died")
                    self._revive(w)
                    if w.retire_pending:  # retires into another worker
                        return []
                elif f.kind == "raise_forward":
                    hook = self._raise_hook(f.magnitude)
                elif f.kind == "stall_forward":
                    hook = self._stall_hook(f.magnitude)

        # The revive/retry loop (never raises on worker faults): each failed
        # attempt — including a failure during a recovery re-run — is logged,
        # the worker revived, and the identical round re-scored; the rebuild
        # counter bounds the loop, tipping a persistently-failing worker into
        # retirement instead of letting a second consecutive fault escape.
        while True:
            t0 = self._now()
            # re-install on every attempt: the hooks are stateful (a
            # transient fault raises on its first k attempts, then clears)
            w.engine.fault_hook = hook
            try:
                scored = w.engine.step()
                break
            except Exception as exc:  # noqa: BLE001 — the point is to survive
                elapsed = self._now() - t0
                stalled = elapsed > self.dispatch_deadline_s
                self._incident(
                    w,
                    "stall" if stalled else "crash",
                    f"{type(exc).__name__}: {exc} (round took {elapsed:.3f}s)",
                )
                self._revive(w)
                if w.retire_pending:
                    return []
                # transactional step committed nothing, so the re-run scores
                # the exact same windows the failed attempt peeked
            finally:
                if w.engine is not None:
                    w.engine.fault_hook = None

        # Collect evictions BEFORE snapshotting last_good: a snapshot taken
        # between de-admission and collection would otherwise revive into a
        # stream that is refused but never evicted (no event stash, stale
        # route, journal growing forever).
        evictions = w.engine.take_evictions()
        self._stamp_good(w)
        w.last_heartbeat = self._now()
        # map local -> global ids BEFORE eviction renumbers w.streams
        out = [
            dataclasses.replace(ws, stream=w.streams[ws.stream]) for ws in scored
        ]
        if evictions:
            w.pending_evict.extend(evictions)
        return out

    def _raise_hook(self, magnitude: float = 0.0):
        # magnitude = consecutive failing attempts (0/1 = classic one crash):
        # the hook object survives the revive, so the recovery re-run fails
        # too until the budget is spent — the back-to-back-failure case the
        # revive/retry loop exists for.
        state = {"left": max(1, int(magnitude))}

        def hook(ids):
            if state["left"] > 0:
                state["left"] -= 1
                raise InjectedFault("injected forward crash")

        return hook

    def _stall_hook(self, magnitude: float):
        hang = max(float(magnitude), 2.0 * self.dispatch_deadline_s)
        state = {"left": 1}  # one hang; the revived worker's re-run proceeds

        def hook(ids):
            if state["left"] <= 0:
                return
            state["left"] -= 1
            # simulate the hang on the injectable clock, then fail the way a
            # real watchdog does: abandon the dispatch
            advance = getattr(self._clock_obj, "advance", None)
            if advance is not None:
                advance(hang)
            raise StalledForward(f"forward hung {hang:.1f}s past deadline")

        return hook

    # -- recovery ------------------------------------------------------------

    def _revive(self, w: _Worker):
        """Rebuild a dead/crashed worker: fresh engine from the baked
        artifact, restore the last-good snapshot, replay the journal.  The
        result is bitwise the state at the moment of death.  A worker past
        its rebuild budget is flagged for retirement — applied on the
        supervisor thread at the end of the round, never inside a lane."""
        w.rebuilds += 1
        engine = self._build_engine(len(w.streams))
        engine.restore(w.last_good)
        for local, chunk in w.journal:
            engine.push(local, chunk)
        w.engine = engine
        if w.rebuilds > self.max_rebuilds:
            w.retire_pending = True

    def _reassign(self, w: _Worker, *, kind: str = "reassign",
                  detail: str | None = None):
        """Retire a worker: migrate its streams — with their full revived
        state — into the least-loaded survivor, rebuilt for the combined
        stream set.  Migration is bitwise lossless.  Used both for workers
        that keep dying (``kind="reassign"``) and for deliberate scale-down
        (:meth:`retire_worker`, ``kind="retire"``)."""
        survivors = [o for o in self.workers if o.alive and o is not w]
        if not survivors:
            # nowhere to move the streams: keep limping on rebuilds
            return
        target = min(survivors, key=lambda o: len(o.streams))
        merged = _merge_snapshots(target.engine.snapshot(), w.engine.snapshot())
        engine = self._build_engine(len(target.streams) + len(w.streams))
        engine.restore(merged)
        target.engine = engine
        base = len(target.streams)
        migrated = list(w.streams)
        target.streams.extend(migrated)
        for off, g in enumerate(migrated):
            self._route[g] = (target.idx, base + off)
        # the merged engine IS the new last-good state; pending journal
        # entries from both workers are already baked into it
        self._stamp_good(target)
        self._incident(
            w,
            kind,
            detail
            or f"retired after {w.rebuilds} rebuilds; streams "
               f"{migrated} -> worker {target.idx}",
        )
        w.alive = False
        w.engine = None
        w.streams = []
        w.journal.clear()
        self._splice_dirty = True

    def _evict(self, w: _Worker, locals_: list[int]):
        """Remove persistently-overflowing streams from a worker: the
        reassignment machinery run in reverse.  The worker is rebuilt from a
        snapshot projected onto its surviving streams
        (:func:`_subset_snapshot`) — survivors keep their exact ring
        contents, EMA trajectories and window indices — while the evicted
        streams' already-closed track events and final per-stream counter
        totals are stashed (for :meth:`finalize` and the fleet counter
        gathers) and further pushes to them are refused."""
        drop = set(locals_)
        keep = [l for l in range(len(w.streams)) if l not in drop]
        snap = w.engine.snapshot()
        evicted_globals = sorted(w.streams[l] for l in drop)
        for l in drop:
            g = w.streams[l]
            self.evicted.add(g)
            self._evicted_events[g] = list(snap["tracker"]["events"][l])
            self._final_counters[g] = {
                k: int(np.asarray(v)[l])
                for k, v in snap["counters"].items()
                if isinstance(v, np.ndarray)
            }
            del self._route[g]
        self._incident(
            w,
            "evict",
            f"streams {evicted_globals} evicted after persistent ring "
            f"overflow",
        )
        if not keep:
            # every stream evicted: nothing left to serve
            w.alive = False
            w.engine = None
            w.streams = []
            w.journal.clear()
            self._splice_dirty = True
            return
        engine = self._build_engine(len(keep))
        engine.restore(_subset_snapshot(snap, keep))
        w.engine = engine
        w.streams = [w.streams[l] for l in keep]
        for local, g in enumerate(w.streams):
            self._route[g] = (w.idx, local)
        # the projected engine IS the new last-good state; the journal was
        # cleared by the round that triggered the eviction
        self._stamp_good(w)
        self._splice_dirty = True

    def _incident(self, w: _Worker, kind: str, detail: str):
        # lock-protected: lanes report their own incidents concurrently;
        # within one worker the order stays causal.
        with self._incident_lock:
            self.incidents.append(
                {"round": self.round, "worker": w.idx, "kind": kind,
                 "detail": detail}
            )

    # -- durability (cold-restart checkpoints + WAL) ---------------------------

    def _persist(self, *, force: bool = False) -> None:
        """Publish the fleet's durable view: each live worker's last-good
        checkpoint (snapshot + the delivery cursors it embeds), WAL resets
        for journals those checkpoints made redundant, then the fleet
        meta-checkpoint that pins it all together.  Runs on the supervisor
        thread at the end of a round (every ``checkpoint_interval`` rounds,
        or forced after a topology splice).

        The meta is written *last* and is the restore authority: a crash
        anywhere mid-persist leaves worker checkpoints the meta never
        references (orphans, skipped on restore) or WALs the meta's cursors
        already cover (stale prefixes, filtered on replay) — never a state
        that restores wrong.  Disk faults are counted
        (``ckpt_errors``/``wal_errors``), not raised: durability degrades
        to the previous checkpoint + WAL replay + driver re-delivery, but
        serving never stops."""
        if self.state_dir is None:
            return
        if not (force or self._splice_dirty
                or self.round % self.checkpoint_interval == 0):
            return
        self._ckpt_seq += 1
        ver = self._ckpt_seq
        for w in self.workers:
            if not w.alive or w.last_good is None:
                continue
            payload = {
                "snapshot": w.last_good,
                "pushed": dict(w.good_pushed),
                "faulted": dict(w.good_faulted),
            }
            try:
                self._stores[w.idx].save(ver, payload)
            except (OSError, InjectedFault):
                self.ckpt_errors += 1
                continue  # keep the WAL: it still covers the gap
            self._ckpt_versions[w.idx] = ver
            if not w.journal:
                # empty journal -> every WAL record is baked into last_good
                try:
                    self._wals[w.idx].reset()
                except (OSError, InjectedFault):
                    self.wal_errors += 1
        adm = self._engine_kw.get("admission")
        meta = {
            "round": self.round,
            "ckpt_seq": ver,
            "n_streams": self.n_streams,
            "max_streams": self._max_streams,
            "admission": None if adm is None else dataclasses.asdict(adm),
            "workers": [
                {"idx": w.idx, "alive": w.alive,
                 "streams": list(map(int, w.streams)),
                 "rebuilds": w.rebuilds}
                for w in self.workers
            ],
            "versions": dict(self._ckpt_versions),
            "seen": sorted(self._seen),
            "refused": sorted(self._refused),
            "evicted": sorted(self.evicted),
            "pushed_chunks": self.pushed_chunks.copy(),
            "faulted_chunks": self.faulted_chunks.copy(),
            "refused_chunks": self.refused_chunks.copy(),
            "evicted_events": {
                g: list(v) for g, v in self._evicted_events.items()
            },
            "final_counters": {
                g: dict(v) for g, v in self._final_counters.items()
            },
            "incidents": [dict(i) for i in self.incidents],
        }
        try:
            self._fleet_store.save(ver, meta)
        except (OSError, InjectedFault):
            self.ckpt_errors += 1
            return  # keep _splice_dirty: retry the full publish next round
        self._splice_dirty = False
        # a dead worker's journal is redundant once a meta that records the
        # splice is on disk (its state lives in a survivor's checkpoint)
        for idx, wal in self._wals.items():
            w = self.workers[idx] if idx < len(self.workers) else None
            if w is not None and not w.alive and wal.appended:
                try:
                    wal.reset()
                except (OSError, InjectedFault):
                    self.wal_errors += 1

    @property
    def wal_truncations(self) -> int:
        """Torn/corrupt WAL tails truncated by replay across the fleet."""
        return sum(w.truncations for w in self._wals.values())

    @classmethod
    def restore_from_dir(cls, artifact: QuantizedParams, cfg: CNNConfig, *,
                         state_dir: str, fs=None, **kw):
        """Rebuild a fleet from its durable on-disk state: artifact + newest
        valid fleet meta-checkpoint + per-worker checkpoints (pinned to the
        versions the meta references — a newer orphan is never resurrected)
        + WAL replay, with any torn/corrupt WAL tail truncated, never
        raised.  Returns ``None`` when the state dir holds no loadable
        meta (caller starts a fresh fleet).

        After restore, ``pushed_chunks`` is the per-stream delivery cursor:
        the driver re-delivers each stream's chunks from that ordinal on
        (then re-runs rounds from ``self.round``) and the resumed run is
        bitwise identical to an uninterrupted one."""
        resolve_device(kw.get("device", "cuda"))  # no GPU, no restore
        probe_fs = fs if fs is not None else LocalFilesystem()
        meta_store = CheckpointStore(
            os.path.join(state_dir, "fleet"), fs=probe_fs
        )
        loaded = meta_store.load_latest()
        if loaded is None:
            return None
        _, meta = loaded
        kw.pop("n_streams", None)
        kw.pop("n_workers", None)
        sup = cls(artifact, cfg, n_streams=int(meta["n_streams"]),
                  n_workers=1, state_dir=state_dir, fs=fs, **kw)
        sup.round = int(meta["round"])
        sup._ckpt_seq = int(meta["ckpt_seq"])
        sup._ckpt_versions = {
            int(k): int(v) for k, v in meta["versions"].items()
        }
        sup._max_streams = meta["max_streams"]
        if meta["admission"] is not None:
            sup._engine_kw["admission"] = AdmissionPolicy(**meta["admission"])
        sup._seen = {int(s) for s in meta["seen"]}
        sup._refused = {int(s) for s in meta["refused"]}
        sup.evicted = {int(s) for s in meta["evicted"]}
        sup.pushed_chunks = np.asarray(meta["pushed_chunks"], np.int64).copy()
        sup.faulted_chunks = np.asarray(
            meta["faulted_chunks"], np.int64
        ).copy()
        sup.refused_chunks = np.asarray(
            meta["refused_chunks"], np.int64
        ).copy()
        sup._evicted_events = {
            int(g): list(v) for g, v in meta["evicted_events"].items()
        }
        sup._final_counters = {
            int(g): dict(v) for g, v in meta["final_counters"].items()
        }
        sup.incidents = [dict(i) for i in meta["incidents"]]

        workers: list[_Worker] = []
        sup._route = {}
        for rec in meta["workers"]:
            idx = int(rec["idx"])
            if not rec["alive"]:
                w = _Worker(idx, None, [])
                w.alive = False
                w.rebuilds = int(rec["rebuilds"])
                workers.append(w)
                continue
            streams = [int(g) for g in rec["streams"]]
            sup._attach_worker_storage(idx)
            engine = sup._build_engine(len(streams))
            w = _Worker(idx, engine, streams)
            w.rebuilds = int(rec["rebuilds"])
            pinned = sup._ckpt_versions.get(idx)
            ck = (
                sup._stores[idx].load_latest(at_or_before=pinned)
                if pinned is not None else None
            )
            if ck is not None and (
                len(ck[1]["snapshot"]["rings"]) != len(streams)
            ):
                ck = None  # checkpoint predates a splice the meta recorded
            if ck is None:
                # degraded restore: no usable checkpoint — start this
                # worker fresh and zero its cursors so the driver
                # re-delivers its streams from chunk 0
                sup.ckpt_errors += 1
                for g in streams:
                    sup.pushed_chunks[g] = 0
                    sup.faulted_chunks[g] = 0
                try:
                    sup._wals[idx].reset()
                except (OSError, InjectedFault):
                    sup.wal_errors += 1
                sup._stamp_good(w)
                sup._incident(
                    w, "restore-degraded",
                    "no loadable checkpoint; rebuilt fresh — the driver "
                    "must re-deliver from chunk 0",
                )
            else:
                _, payload = ck
                engine.restore(payload["snapshot"])
                for g, v in payload["pushed"].items():
                    sup.pushed_chunks[int(g)] = int(v)
                for g, v in payload["faulted"].items():
                    sup.faulted_chunks[int(g)] = int(v)
                sup._stamp_good(w)
                # WAL replay: everything delivered after that checkpoint.
                # The seq filter drops stale pre-checkpoint prefixes (a
                # reset that failed or never ran); it compares against the
                # checkpoint's cursor, not the advancing one, so jittered
                # pushes sharing a seq both replay.
                base = {g: int(sup.pushed_chunks[g]) for g in streams}
                local_of = {g: l for l, g in enumerate(streams)}
                for r in sup._wals[idx].replay():
                    g = int(r.stream)
                    if g not in local_of or r.seq < base[g]:
                        continue
                    if r.flags & WAL_FAULTED:
                        sup.faulted_chunks[g] += 1
                    if not (r.flags & WAL_DROPPED):
                        engine.push(local_of[g], r.chunk)
                        w.journal.append((local_of[g], r.chunk))
                        sup.replayed_chunks += 1
                    sup.pushed_chunks[g] = max(
                        sup.pushed_chunks[g], r.seq + 1
                    )
            workers.append(w)
        sup.workers = workers
        for w in workers:
            for local, g in enumerate(w.streams):
                sup._route[g] = (w.idx, local)
        if sup._lanes is not None:
            for w in workers:
                if w.alive:
                    sup._lanes.ensure(w.idx)
        return sup

    # -- elasticity (the SLO controller's actuators) --------------------------

    def spawn_worker(self) -> int | None:
        """Scale up: split the most-loaded live worker's streams in half and
        move the tail half — with its full per-stream state, via the same
        snapshot/splice machinery reassignment uses — into a brand-new
        worker (and lane).  Bitwise lossless for every stream; whole-engine
        scalar counters stay with the donor so fleet totals are conserved.
        Returns the new worker index, or None when no live worker has two
        streams to split."""
        donors = [w for w in self.workers if w.alive and len(w.streams) >= 2]
        if not donors:
            return None
        donor = max(donors, key=lambda o: len(o.streams))
        snap = donor.engine.snapshot()
        cut = len(donor.streams) // 2  # donor keeps the head half
        keep, move = list(range(cut)), list(range(cut, len(donor.streams)))
        moved = [donor.streams[l] for l in move]
        engine = self._build_engine(len(keep))
        engine.restore(_subset_snapshot(snap, keep))
        donor.engine = engine
        donor.streams = [donor.streams[l] for l in keep]
        self._stamp_good(donor)
        idx = len(self.workers)
        spawned_engine = self._build_engine(len(move))
        spawned_engine.restore(_subset_snapshot(snap, move, zero_scalars=True))
        spawned = _Worker(idx, spawned_engine, moved)
        spawned.last_heartbeat = self._now()
        self.workers.append(spawned)
        self._stamp_good(spawned)
        for local, g in enumerate(donor.streams):
            self._route[g] = (donor.idx, local)
        for local, g in enumerate(moved):
            self._route[g] = (idx, local)
        if self._lanes is not None:
            self._lanes.ensure(idx)
        self._attach_worker_storage(idx)
        self._incident(
            spawned, "spawn",
            f"streams {moved} <- worker {donor.idx} (scale-up)",
        )
        # splices must keep the on-disk view consistent: publish the new
        # topology now (spawn/retire run between rounds, not inside step)
        self._splice_dirty = True
        self._persist(force=True)
        return idx

    def retire_worker(self, idx: int | None = None, *,
                      reason: str = "scale-down") -> bool:
        """Scale down: retire one live worker (the least-loaded by default),
        splicing its streams — with their full state — into a surviving
        worker.  Bitwise lossless; refuses (returns False) when it is the
        last live worker."""
        live = [w for w in self.workers if w.alive]
        if len(live) < 2:
            return False
        w = self.workers[idx] if idx is not None else min(
            live, key=lambda o: len(o.streams)
        )
        if not w.alive:
            return False
        streams = list(w.streams)
        self._reassign(
            w, kind="retire", detail=f"{reason}: streams {streams} folded "
            f"into the survivors",
        )
        if not w.alive:
            self._persist(force=True)
        return not w.alive

    def retune_admission(self, admission: AdmissionPolicy) -> None:
        """Swap the fleet's admission policy in place (the SLO controller's
        budget actuator).  The fleet-level ``max_streams`` cap updates here;
        the per-round knobs land on every live worker's engine and on the
        kwargs future rebuilds use.  Note streams already refused at the old
        cap stay refused — first-come admission is sticky by design."""
        self._max_streams = admission.max_streams
        worker_adm = dataclasses.replace(admission, max_streams=None)
        self._engine_kw["admission"] = worker_adm
        for w in self.workers:
            if w.alive:
                w.engine.admission = worker_adm
        # the active policy rides the fleet meta-checkpoint so a cold
        # restart resumes with the retuned budgets, not the boot-time ones
        self._persist(force=True)

    @property
    def admission(self) -> AdmissionPolicy:
        """The currently-active fleet admission policy (fleet-level
        ``max_streams`` re-folded in)."""
        adm = self._engine_kw.get("admission") or AdmissionPolicy()
        return dataclasses.replace(adm, max_streams=self._max_streams)

    # -- introspection / lifecycle -------------------------------------------

    @property
    def n_live_workers(self) -> int:
        return sum(1 for w in self.workers if w.alive)

    @property
    def windows_scored(self) -> int:
        return sum(w.engine.windows_scored for w in self.workers if w.alive)

    @property
    def forward_calls(self) -> int:
        return sum(w.engine.forward_calls for w in self.workers if w.alive)

    @property
    def padded_slots(self) -> int:
        return sum(w.engine.padded_slots for w in self.workers if w.alive)

    @property
    def dropped_samples(self) -> int:
        return sum(w.engine.dropped_samples for w in self.workers if w.alive)

    @property
    def served_windows(self) -> np.ndarray:
        """Windows actually scored, per *global* stream (fairness
        observability); evicted streams keep their final totals."""
        return self._gather_per_stream("served_windows")

    @property
    def deferred_windows(self) -> np.ndarray:
        """Ready windows deferred past their round by the per-stream cap /
        fairness budget, per global stream; evicted streams keep their
        final totals."""
        return self._gather_per_stream("deferred_windows")

    @property
    def slot_histogram(self) -> dict[int, int]:
        """Blocks dispatched per slot shape, summed over live workers."""
        out: dict[int, int] = {}
        for w in self.workers:
            if not w.alive:
                continue
            for k, v in w.engine.slot_histogram.items():
                out[k] = out.get(k, 0) + v
        return out

    def _gather_per_stream(self, attr: str) -> np.ndarray:
        out = np.zeros(self.n_streams, np.int64)
        for w in self.workers:
            if not w.alive:
                continue
            vals = getattr(w.engine, attr)
            for local, g in enumerate(w.streams):
                out[g] = vals[local]
        # evicted (and retired-with-their-worker) streams report the totals
        # stashed when they left the fleet, not zeros
        for g, totals in self._final_counters.items():
            out[g] = totals.get(attr, 0)
        return out

    def precompile(self) -> tuple[int, ...]:
        """Warm every worker's datapath over its slot-shape ladder (the
        workers share one artifact, so this is cheap past the first worker);
        returns the last live worker's ladder."""
        ladder: tuple[int, ...] = ()
        for w in self.workers:
            if w.alive:
                ladder = w.engine.precompile()
        return ladder

    def health(self) -> list[dict]:
        """Per-worker health: liveness, lane, stream assignment, rebuild
        count, heartbeat age on the supervisor's clock."""
        now = self._now()
        report = []
        for w in self.workers:
            report.append(
                {
                    "worker": w.idx,
                    "alive": w.alive,
                    "lane": (
                        None if self._lanes is None else self._lanes.name(w.idx)
                    ),
                    "streams": list(w.streams),
                    "rebuilds": w.rebuilds,
                    "heartbeat_age_s": (
                        None if w.last_heartbeat is None else now - w.last_heartbeat
                    ),
                    "rounds": None if w.engine is None else w.engine.rounds,
                }
            )
        return report

    def drain(self) -> list[WindowScore]:
        """Run rounds until no worker has a complete window buffered."""
        out: list[WindowScore] = []
        while True:
            scored = self.step()
            if not scored:
                return out
            out.extend(scored)

    def close(self) -> None:
        """Shut down the execution lanes (no-op for the sequential fleet)
        and publish a final durable checkpoint (no-op without a state dir).
        The supervisor remains usable afterwards only in sequential mode."""
        if self._lanes is not None:
            self._lanes.close()
            self._lanes = None
            # queued-but-undelivered ingest would be lost with the lanes;
            # deliver it so close() is not a silent drop
            if self._ingest is not None:
                for stream, samples in self._ingest.drain():
                    self._ingest_one(stream, samples)
                self._ingest = None
        if self.state_dir is not None:
            # chunks delivered since the last step stay journaled on disk
            # (their workers' journals are non-empty, so _persist leaves
            # those WALs alone and replay covers them)
            self._persist(force=True)
            for wal in self._wals.values():
                wal.close()

    def finalize(self) -> list[list[TrackEvent]]:
        """Flush still-open tracks; returns per-GLOBAL-stream event lists.
        Evicted streams report the events they had closed before eviction."""
        out: list[list[TrackEvent]] = [[] for _ in range(self.n_streams)]
        for g, evs in self._evicted_events.items():
            out[g] = list(evs)
        for w in self.workers:
            if not w.alive:
                continue
            events = w.engine.finalize()
            for local, g in enumerate(w.streams):
                out[g] = events[local]
        return out
