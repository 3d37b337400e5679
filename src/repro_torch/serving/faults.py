"""Deterministic fault injection for the fleet supervisor's chaos suite.

Counterpart of ``repro/serving/faults.py``: ``FaultPlan.generate`` draws
the same plan for the same seed and ``to_json`` writes the same text, so
one plan file drives the JAX fleet and this one alike.

A :class:`FaultPlan` is a seeded, JSON-serialisable list of :class:`Fault`
records, each pinned to an ingest round and a target (a global stream for
chunk faults, a worker index for worker faults).  The supervisor consults
the plan at exactly two seams — ``push()`` for chunk faults, and the shared
dispatch core's ``pre_dispatch`` hook (exposed as the engine's
``fault_hook`` property, fired at the top of every
:class:`~repro_torch.serving.batching.DispatchCore` dispatch before anything is
submitted) for worker faults — so a plan replays *identically* on every
run: same seed, same faults, same rounds, same blast radius.  That
determinism is what lets the chaos tests assert bitwise equality of the
unaffected streams instead of "mostly worked".  Routing worker faults
through the core seam means the same harness exercises every server built
on the core, and the core's all-or-nothing dispatch contract is what makes
a faulted round cleanly re-runnable.

Fault kinds and their contracts:

``drop_chunk``
    The chunk never reaches the worker (lossy transport).  Only the target
    stream's windows shift; every other stream is bitwise unaffected.
``corrupt_chunk``
    The chunk's payload is deterministically poisoned with NaN before
    delivery (truncated packet decoded as garbage).  With a reject
    sanitize policy the worker refuses it — same blast radius as a drop.
``jitter_chunk``
    The chunk is split and delivered as two back-to-back pushes
    (re-segmented transport).  Content-preserving: *no* stream's output
    may change, not even the target's.
``raise_forward``
    The worker's forward raises mid-round (driver bug, device loss).
    Lossless: the transactional round plus snapshot/restore recovery must
    leave every stream bitwise identical to the fault-free run.
    ``magnitude`` is the number of *consecutive* dispatch attempts that
    raise (``0``/``1`` = the classic single crash): the supervisor's revive
    path re-runs the round after rebuilding the worker, and a magnitude of
    ``k`` makes the first ``k`` attempts — the original round plus ``k - 1``
    recovery re-runs — fail, modelling a genuinely transient error that
    outlives one rebuild.  Bounded recovery (``max_rebuilds``) must absorb
    every value without the fault ever escaping ``step()``.
``stall_forward``
    The forward hangs past the dispatch deadline; the watchdog abandons it
    (:class:`StalledForward`).  Detected via the supervisor's deadline
    check on the injected clock.  Lossless, like ``raise_forward``.
``kill_worker``
    The worker process dies between rounds; its engine object is gone.
    The supervisor rebuilds from the baked artifact + last-good snapshot +
    journal.  Lossless.

Disk faults (``--state-dir`` durability, :mod:`repro_torch.serving.durability`)
enter through the injectable filesystem seam — :class:`FaultyFilesystem`
wraps the production ``LocalFilesystem`` and consults the plan on every
``write``/``fsync`` op.  For these kinds the :class:`Fault` ``round`` field
is the *0-based filesystem operation index* (write ops for the write
kinds, fsync ops for ``slow_fsync``), not an ingest round: disk activity
is not round-synchronous, and an op counter is the deterministic clock the
seam actually has.

``torn_write``
    Only a prefix of the buffer reaches the file, then the write errors —
    a crash mid-write.  ``magnitude`` = surviving fraction (default 0.5).
    WAL replay must truncate the torn tail, never raise.
``bit_flip``
    One bit of the buffer is flipped *silently* (``magnitude`` = bit
    index).  The CRC-32 frame check must catch it on read-back.
``enospc``
    The write fails upfront with ``OSError(ENOSPC)`` (disk full).  The
    supervisor counts the durability degradation and keeps serving.
``slow_fsync``
    The fsync blocks ``magnitude`` seconds (advanced on the injectable
    clock when one is provided) — a saturated device.  Visible only as
    latency.

``python -m repro_torch.serving.faults --seed 7 --streams 8 --workers 2
--rounds 20 --out plan.json`` writes a plan for the ``launch/monitor
--faults`` demo; ``--kinds`` restricts (or extends, e.g. to the disk
kinds) the generated mix and rejects unknown kind names with the full
known list in the error.
"""
from __future__ import annotations

import argparse
import dataclasses
import errno
import json
import threading
import time

import numpy as np

#: chunk faults target one global stream's ingest
CHUNK_KINDS = ("drop_chunk", "jitter_chunk", "corrupt_chunk")
#: worker faults target one worker's scoring round
WORKER_KINDS = ("raise_forward", "stall_forward", "kill_worker")
#: disk faults target the Nth filesystem op on the durability seam
#: (``round`` = op index; no stream/worker target)
DISK_KINDS = ("torn_write", "bit_flip", "enospc", "slow_fsync")
KINDS = CHUNK_KINDS + WORKER_KINDS + DISK_KINDS

#: kinds that destroy data on their target stream — everything else must be
#: bitwise invisible in the output
LOSSY_KINDS = ("drop_chunk", "corrupt_chunk")


class InjectedFault(RuntimeError):
    """Raised inside a worker round to simulate a crash."""


class StalledForward(InjectedFault):
    """A forward that hung past the dispatch deadline (watchdog fired)."""


class FaultClock:
    """Deterministic stand-in for ``time.monotonic`` so stall detection is
    testable: each ``now()`` ticks a fixed amount, and a stalling fault
    ``advance()``s it past the supervisor's dispatch deadline.

    Lock-protected: with execution lanes every worker thread reads the one
    shared clock concurrently, and a torn ``+=`` would lose a stall's
    ``advance`` and misclassify it as a crash."""

    def __init__(self, start: float = 0.0, tick: float = 1e-4):
        self._t = float(start)
        self._tick = float(tick)
        self._lock = threading.Lock()

    def now(self) -> float:
        with self._lock:
            self._t += self._tick  # time only moves forward
            return self._t

    def advance(self, dt: float):
        with self._lock:
            self._t += float(dt)


@dataclasses.dataclass(frozen=True)
class Fault:
    """One injected fault, pinned to an ingest round and a target."""

    kind: str
    round: int  # ingest round; for DISK_KINDS: filesystem op index
    stream: int | None = None  # chunk faults: global stream id
    worker: int | None = None  # worker faults: worker index
    # jitter: split fraction; stall: hang seconds; raise: consecutive
    # failing dispatch attempts (0/1 = the classic single crash);
    # torn_write: surviving fraction; bit_flip: bit index; slow_fsync:
    # hang seconds
    magnitude: float = 0.0

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r} (one of {KINDS})")
        if self.round < 0:
            raise ValueError(f"round must be >= 0, got {self.round}")
        if self.kind in CHUNK_KINDS and self.stream is None:
            raise ValueError(f"{self.kind} needs a target stream")
        if self.kind in WORKER_KINDS and self.worker is None:
            raise ValueError(f"{self.kind} needs a target worker")


@dataclasses.dataclass
class FaultPlan:
    """An ordered set of faults plus the seed that generated them."""

    faults: list[Fault]
    seed: int | None = None

    def __post_init__(self):
        self.faults = [
            f if isinstance(f, Fault) else Fault(**f) for f in self.faults
        ]
        self._chunk: dict[tuple[int, int], Fault] = {}
        self._worker: dict[tuple[int, int], list[Fault]] = {}
        self._disk: dict[int, list[Fault]] = {}
        for f in self.faults:
            if f.kind in CHUNK_KINDS:
                # first fault wins on a (round, stream) collision
                self._chunk.setdefault((f.round, f.stream), f)
            elif f.kind in DISK_KINDS:
                self._disk.setdefault(f.round, []).append(f)
            else:
                self._worker.setdefault((f.round, f.worker), []).append(f)

    # -- lookups the supervisor uses ----------------------------------------

    def chunk_fault(self, round_: int, stream: int) -> Fault | None:
        return self._chunk.get((round_, stream))

    def worker_faults(self, round_: int, worker: int) -> list[Fault]:
        return self._worker.get((round_, worker), [])

    def disk_faults(self, op: int) -> list[Fault]:
        """Disk faults pinned to the ``op``-th filesystem operation (see
        :class:`FaultyFilesystem` for which counter each kind consults)."""
        return self._disk.get(op, [])

    @property
    def has_disk_faults(self) -> bool:
        return bool(self._disk)

    @property
    def affected_streams(self) -> set[int]:
        """Streams hit by data-destroying faults; every stream NOT in this
        set must be bitwise identical to the fault-free run."""
        return {f.stream for f in self.faults if f.kind in LOSSY_KINDS}

    # -- construction / serialisation ---------------------------------------

    @classmethod
    def generate(
        cls,
        seed: int,
        *,
        n_streams: int,
        n_workers: int,
        n_rounds: int,
        n_faults: int = 6,
        kinds: tuple[str, ...] = CHUNK_KINDS + WORKER_KINDS,
    ) -> "FaultPlan":
        """Seeded random plan: same arguments, same plan, every time.

        The default mix covers the transport and worker kinds (the fleet
        chaos sweep); pass ``kinds`` explicitly — e.g. ``KINDS`` or just
        ``DISK_KINDS`` — to include disk faults.  Unknown kind names are
        rejected upfront with the full known list, instead of surfacing
        later as a bare lookup error."""
        unknown = [k for k in kinds if k not in KINDS]
        if unknown:
            raise ValueError(
                f"unknown fault kind(s) {unknown} (known kinds: {list(KINDS)})"
            )
        rng = np.random.default_rng(seed)
        faults = []
        for _ in range(n_faults):
            kind = kinds[int(rng.integers(len(kinds)))]
            rnd = int(rng.integers(n_rounds))
            if kind in CHUNK_KINDS:
                mag = float(rng.uniform(0.2, 0.8)) if kind == "jitter_chunk" else 0.0
                faults.append(
                    Fault(kind, rnd, stream=int(rng.integers(n_streams)),
                          magnitude=mag)
                )
            elif kind in DISK_KINDS:
                # round = filesystem op index: disk activity runs several
                # ops per ingest round, so spread over a wider range
                op = int(rng.integers(n_rounds * 8))
                mag = {
                    "torn_write": float(rng.uniform(0.1, 0.9)),
                    "bit_flip": float(rng.integers(0, 256)),
                    "slow_fsync": float(rng.uniform(0.5, 5.0)),
                }.get(kind, 0.0)
                faults.append(Fault(kind, op, magnitude=mag))
            else:
                mag = float(rng.uniform(2.0, 10.0)) if kind == "stall_forward" else 0.0
                faults.append(
                    Fault(kind, rnd, worker=int(rng.integers(n_workers)),
                          magnitude=mag)
                )
        faults.sort(key=lambda f: (f.round, KINDS.index(f.kind),
                                   -1 if f.stream is None else f.stream,
                                   -1 if f.worker is None else f.worker))
        return cls(faults, seed=seed)

    def to_json(self) -> str:
        return json.dumps(
            {"seed": self.seed,
             "faults": [dataclasses.asdict(f) for f in self.faults]},
            indent=2,
        )

    @classmethod
    def from_json(cls, text: str) -> "FaultPlan":
        d = json.loads(text)
        return cls([Fault(**f) for f in d["faults"]], seed=d.get("seed"))


class FaultyFilesystem:
    """Deterministic disk-fault injection on the durability seam.

    Wraps a :class:`~repro_torch.serving.durability.LocalFilesystem` (any object
    with the same duck type) and consults the plan's :meth:`disk faults
    <FaultPlan.disk_faults>` on every ``write`` (op counter ``writes``) and
    every ``fsync`` (op counter ``fsyncs``).  All other operations pass
    straight through.  The same plan replays the same faults at the same
    ops on every run, which is what lets the durability tests assert exact
    truncation/fallback behaviour instead of "eventually recovered".

    Injected faults are recorded in :attr:`injected` as
    ``(kind, op_index)`` pairs."""

    def __init__(self, inner, plan: FaultPlan, clock=None):
        self._inner = inner
        self.plan = plan
        self._clock = clock
        self._lock = threading.Lock()
        self.writes = 0
        self.fsyncs = 0
        self.injected: list[tuple[str, int]] = []

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def write(self, fh, data: bytes) -> int:
        with self._lock:
            op = self.writes
            self.writes += 1
        for f in self.plan.disk_faults(op):
            if f.kind == "enospc":
                self.injected.append((f.kind, op))
                raise OSError(errno.ENOSPC, "injected: no space left on device")
            if f.kind == "torn_write":
                self.injected.append((f.kind, op))
                frac = f.magnitude if 0.0 < f.magnitude < 1.0 else 0.5
                keep = max(1, int(len(data) * frac)) if data else 0
                self._inner.write(fh, data[:keep])
                raise InjectedFault(
                    f"torn write: {keep}/{len(data)} byte(s) reached disk"
                )
            if f.kind == "bit_flip" and data:
                # silent corruption: the write "succeeds"; only the CRC
                # framing can catch it on read-back
                self.injected.append((f.kind, op))
                flipped = bytearray(data)
                bit = int(f.magnitude) % (len(flipped) * 8)
                flipped[bit // 8] ^= 1 << (bit % 8)
                data = bytes(flipped)
        return self._inner.write(fh, data)

    def fsync(self, fh) -> None:
        with self._lock:
            op = self.fsyncs
            self.fsyncs += 1
        for f in self.plan.disk_faults(op):
            if f.kind == "slow_fsync":
                self.injected.append((f.kind, op))
                advance = getattr(self._clock, "advance", None)
                if advance is not None:
                    advance(float(f.magnitude))  # deterministic test clock
                else:
                    # real clock: a token stall, capped so no test hangs
                    time.sleep(min(float(f.magnitude), 0.05))
        self._inner.fsync(fh)


def _parse_kinds(spec: str) -> tuple[str, ...]:
    kinds = tuple(k.strip() for k in spec.split(",") if k.strip())
    unknown = [k for k in kinds if k not in KINDS]
    if unknown:
        raise argparse.ArgumentTypeError(
            f"unknown fault kind(s) {unknown} (known kinds: {list(KINDS)})"
        )
    if not kinds:
        raise argparse.ArgumentTypeError("--kinds needs at least one kind")
    return kinds


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Write a seeded fault plan (JSON) for the chaos demo."
    )
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--streams", type=int, default=8)
    ap.add_argument("--workers", type=int, default=2)
    ap.add_argument("--rounds", type=int, default=20)
    ap.add_argument("--faults", type=int, default=6)
    ap.add_argument("--kinds", type=_parse_kinds,
                    default=CHUNK_KINDS + WORKER_KINDS,
                    help="comma-separated fault kinds to draw from "
                         f"(known: {','.join(KINDS)}; default excludes the "
                         "disk kinds — add them for --state-dir runs)")
    ap.add_argument("--out", default="fault_plan.json")
    args = ap.parse_args(argv)
    plan = FaultPlan.generate(
        args.seed, n_streams=args.streams, n_workers=args.workers,
        n_rounds=args.rounds, n_faults=args.faults, kinds=args.kinds,
    )
    with open(args.out, "w") as fh:
        fh.write(plan.to_json())
    print(f"wrote {len(plan.faults)} fault(s) to {args.out}")
    for f in plan.faults:
        if f.stream is not None:
            target = f"stream {f.stream}"
        elif f.worker is not None:
            target = f"worker {f.worker}"
        else:
            target = "fs op"  # disk fault: round IS the op index
        print(f"  round {f.round:3d}  {f.kind:14s}  {target}")


if __name__ == "__main__":
    main()
