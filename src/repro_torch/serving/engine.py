"""Multi-stream streaming detection engine (the paper's deployment scenario).

Counterpart of ``repro/serving/engine.py`` (``StreamRing``,
``SanitizePolicy``, ``WindowScore``, ``MonitorEngine``).  Raw microphone
audio arrives per stream in arbitrary chunks; per-stream rings cut
hop-aligned 0.8 s windows; each round's ready windows go through the host
feature front-end and are packed into slot blocks of the kernel datapath
(:func:`~repro_torch.serving.accelerator.accelerator_forward`) by the shared
:class:`~repro_torch.serving.batching.DispatchCore`; a vectorised tracker
turns the per-window probabilities into detection events.

Because activations are quantised per sample, a window's probability is
bitwise independent of its co-batch: streaming, batched and adaptive-slot
dispatch give identical numbers.  ``step()`` is transactional: windows are
peeked, scored, tracked, and only then consumed.

Dispatch on the card: a packed host block is copied to the device (a
synchronous copy from pageable memory, so the ``BlockPool`` rotation may
rewrite the host block on its next turn), the forward is enqueued without
waiting, and harvest is ``.cpu().numpy()`` of the result, which waits for
it.  Up to ``inflight`` blocks are in flight at once.

``on_device_features=True`` moves the DSP front-end onto the device: the
engine submits raw ``(slots, 12800)`` window blocks and the artifact's
baked front-end runs ahead of the first layer, so no host feature work
sits in a round.  Its features agree with the host front-end within
``features_torch.PARITY_ATOL``; streaming == batched stays bitwise.

``shards=k`` (or a ``mesh``) splits every slot block over the ``k``
entries of a 1-D :class:`~repro_torch.distributed.sharding.StreamMesh`,
one artifact replica an entry
(:func:`~repro_torch.serving.accelerator.accelerator_forward_sharded`); the
scores are bitwise the unsharded engine's.  ``shards=k`` alone takes the
first ``k`` devices of the engine's kind (``k`` CPU entries on the CPU);
several shards on one card need a mesh with that card repeated.

``snapshot()`` holds numpy only, with the reference's keys, dtypes and
Python scalar types, so ``snapshot_bytes()`` gives the reference engine's
bytes for the same state (:mod:`repro_torch.serving.durability`).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.data import features
from repro_torch.distributed.sharding import stream_mesh
from repro_torch.kernels.backend import resolve_device
from repro_torch.models.cnn1d import CNNConfig
from repro_torch.serving.accelerator import (
    accelerator_forward,
    accelerator_forward_sharded,
    precompile_slot_shapes,
)
from repro_torch.serving.batching import (
    AdmissionPolicy,
    BlockPool,
    DispatchCore,
    SlotPolicy,
    fair_allocation,
)
from repro_torch.serving.quantized_params import (
    QuantizedParams,
    quantize_params,
    replicate_params,
)
from repro_torch.serving.tracker import TrackEvent, VectorTemporalTracker


class StreamRing:
    """Fixed-capacity ring buffer over one stream's raw samples.

    ``push`` accepts arbitrary chunk sizes; ``pop_window`` emits the next
    hop-aligned window of ``window`` samples and advances the read head by
    ``hop``.  On overflow the oldest *whole hops* are dropped (keeping the
    stream hop-aligned) and counted in ``dropped``.
    """

    def __init__(self, window: int, hop: int, capacity_windows: int = 8):
        if window <= 0:
            raise ValueError(f"window must be positive, got {window}")
        if hop <= 0:
            raise ValueError(f"hop must be positive, got {hop}")
        if capacity_windows < 1:
            raise ValueError(f"capacity_windows must be >= 1, got {capacity_windows}")
        self.window = window
        self.hop = hop
        self.capacity = window + (capacity_windows - 1) * hop
        self._buf = np.zeros(self.capacity, np.float32)
        self._w = 0  # absolute count of samples written
        self._r = 0  # absolute index of the next window's first sample
        self.dropped = 0  # samples lost to overflow

    @property
    def ready(self) -> int:
        """Number of complete windows currently extractable."""
        avail = self._w - self._r
        return 0 if avail < self.window else 1 + (avail - self.window) // self.hop

    def push(self, samples: np.ndarray) -> int:
        """Append raw audio; returns the number of samples dropped."""
        x = np.asarray(samples, np.float32).reshape(-1)
        avail = self._w - self._r
        total = avail + len(x)
        dropped = 0
        if total > self.capacity:
            need = total - self.capacity
            dropped = min(((need + self.hop - 1) // self.hop) * self.hop, total)
            # Oldest first: the buffered backlog, then (for a chunk bigger
            # than the buffer) the incoming head passes through unrecorded.
            drop_buffered = min(dropped, avail)
            self._r += drop_buffered
            skip = dropped - drop_buffered
            self._w += skip
            self._r += skip
            x = x[skip:]
            self.dropped += dropped
        pos = self._w % self.capacity
        first = min(len(x), self.capacity - pos)
        self._buf[pos : pos + first] = x[:first]
        self._buf[: len(x) - first] = x[first:]
        self._w += len(x)
        return dropped

    def peek_window(self) -> np.ndarray | None:
        """Next hop-aligned window without consuming it (None if short)."""
        if self._w - self._r < self.window:
            return None
        idx = (self._r + np.arange(self.window)) % self.capacity
        return self._buf[idx].copy()

    def peek_windows(self, k: int) -> np.ndarray:
        """The next ``k`` windows without consuming them, ``(k, window)``."""
        if k < 1:
            raise ValueError(f"k must be >= 1, got {k}")
        if self.ready < k:
            raise ValueError(f"{k} window(s) requested, only {self.ready} ready")
        idx = (
            self._r
            + np.arange(k)[:, None] * self.hop
            + np.arange(self.window)[None, :]
        ) % self.capacity
        return self._buf[idx]

    def advance(self):
        """Consume one hop off the front (commit the last peeked window)."""
        if self._w - self._r < self.window:
            raise ValueError("advance() without a complete window buffered")
        self._r += self.hop

    def pop_window(self) -> np.ndarray | None:
        out = self.peek_window()
        if out is not None:
            self._r += self.hop
        return out

    def state_dict(self) -> dict:
        return {
            "window": self.window,
            "hop": self.hop,
            "capacity": self.capacity,
            "buf": self._buf.copy(),
            "w": self._w,
            "r": self._r,
            "dropped": self.dropped,
        }

    def load_state_dict(self, sd: dict):
        for field in ("window", "hop", "capacity"):
            if sd[field] != getattr(self, field):
                raise ValueError(
                    f"state_dict {field}={sd[field]} does not match this "
                    f"ring's {field}={getattr(self, field)}"
                )
        self._buf = np.asarray(sd["buf"], np.float32).copy()
        self._w = int(sd["w"])
        self._r = int(sd["r"])
        self.dropped = int(sd["dropped"])


@dataclasses.dataclass(frozen=True)
class SanitizeReport:
    """What :meth:`SanitizePolicy.apply` did to one chunk."""

    rejected: bool = False
    reason: str | None = None  # "nonfinite" | "clipped" when rejected
    zeroed: int = 0
    clipped: bool = False


@dataclasses.dataclass(frozen=True)
class SanitizePolicy:
    """Ingest hardening for one microphone chunk: reject (or zero) NaN/Inf
    samples before they can poison a tracker EMA, and count or reject
    clipped chunks (more than ``max_clip_fraction`` of samples at or beyond
    ``clip_level``)."""

    nonfinite: str = "reject"  # "reject" | "zero"
    clip_level: float | None = None
    max_clip_fraction: float = 0.05
    clipped_action: str = "count"  # "count" | "reject"

    def __post_init__(self):
        if self.nonfinite not in ("reject", "zero"):
            raise ValueError(f"nonfinite must be 'reject' or 'zero', got {self.nonfinite!r}")
        if self.clipped_action not in ("count", "reject"):
            raise ValueError(
                f"clipped_action must be 'count' or 'reject', got {self.clipped_action!r}"
            )
        if self.clip_level is not None and self.clip_level <= 0:
            raise ValueError(f"clip_level must be positive, got {self.clip_level}")
        if not 0.0 <= self.max_clip_fraction <= 1.0:
            raise ValueError(
                f"max_clip_fraction must be in [0, 1], got {self.max_clip_fraction}"
            )

    def apply(self, x: np.ndarray) -> tuple[np.ndarray | None, SanitizeReport]:
        """Returns ``(clean_chunk_or_None, report)``."""
        bad = ~np.isfinite(x)
        n_bad = int(bad.sum())
        if n_bad and self.nonfinite == "reject":
            return None, SanitizeReport(rejected=True, reason="nonfinite")
        clipped = False
        if self.clip_level is not None and len(x):
            frac = float(np.mean(np.abs(np.where(bad, 0.0, x)) >= self.clip_level))
            clipped = frac > self.max_clip_fraction
            if clipped and self.clipped_action == "reject":
                return None, SanitizeReport(rejected=True, reason="clipped", clipped=True)
        if n_bad:
            x = np.where(bad, np.float32(0.0), x)
        return x, SanitizeReport(zeroed=n_bad, clipped=clipped)


@dataclasses.dataclass
class WindowScore:
    """One scored window: raw probability plus the tracker's view of it."""

    stream: int
    window_idx: int  # per-stream window index (tracker idx)
    p_uav: float
    smoothed: float
    active: bool


class MonitorEngine:
    """N-stream continuous monitor over the quantised kernel datapath.

    ``push`` raw audio per stream in any chunking; each ``step`` scores one
    round (by default at most one ready window per stream), micro-batched
    in ``batch_slots`` blocks (or an adaptive ladder of block sizes);
    ``drain`` loops until no stream has a complete window; ``finalize``
    flushes the trackers and returns per-stream event lists.

    ``device`` (CUDA by default; ``"cpu"`` runs the kernels' plain
    versions) is where the artifact lives and the forward runs.  A baked
    :class:`QuantizedParams` on another device is moved once, here.
    ``prune``/``policy`` bake a structured prune and a per-layer precision
    policy into the served artifact at construction.
    ``on_device_features=True`` submits raw windows; the artifact then
    carries ``feature_kind`` (baked here, or checked on a pre-baked one).
    """

    def __init__(
        self,
        params: dict | QuantizedParams,
        cfg: CNNConfig,
        *,
        n_streams: int,
        feature_kind: str = "mfcc20",
        on_device_features: bool = False,
        hop_samples: int | None = None,
        batch_slots: int = 8,
        precision: str = "int8",
        prune=None,
        policy=None,
        sanitize: SanitizePolicy | None = None,
        capacity_windows: int = 8,
        device="cuda",
        shards: int | None = None,
        mesh=None,
        inflight: int = 2,
        adaptive_slots: bool = False,
        min_slots: int = 1,
        admission: AdmissionPolicy | None = None,
        ema_alpha: float = 0.4,
        enter_threshold: float = 0.65,
        exit_threshold: float = 0.35,
        min_duration: int = 2,
    ):
        if feature_kind not in features.FEATURE_DIMS:
            raise ValueError(f"unknown feature kind {feature_kind!r}")
        if cfg.input_len != features.FEATURE_DIMS[feature_kind]:
            raise ValueError(
                f"model input_len {cfg.input_len} != {feature_kind} feature "
                f"dim {features.FEATURE_DIMS[feature_kind]}"
            )
        if n_streams < 1:
            raise ValueError(f"n_streams must be >= 1, got {n_streams}")
        if batch_slots < 1:
            raise ValueError(f"batch_slots must be >= 1, got {batch_slots}")
        if inflight < 1:
            raise ValueError(f"inflight must be >= 1, got {inflight}")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.n_streams = n_streams
        self.feature_kind = feature_kind
        self.on_device_features = on_device_features
        self.batch_slots = batch_slots
        self.window = features.N_SAMPLES
        self.hop = hop_samples if hop_samples is not None else features.N_SAMPLES
        # one micro-batch row: raw samples when the front-end runs on the
        # device, extracted features otherwise
        self._in_width = features.N_SAMPLES if on_device_features else cfg.input_len
        if isinstance(params, QuantizedParams):
            if prune is not None or policy is not None:
                raise ValueError(
                    "prune/policy are quantise-once decisions and cannot be "
                    "applied to an already-baked QuantizedParams artifact; "
                    "pass the fp32 checkpoint instead"
                )
            if on_device_features and params.feature_kind != feature_kind:
                raise ValueError(
                    f"on_device_features=True needs an artifact baked for "
                    f"feature kind {feature_kind!r}, got "
                    f"{params.feature_kind!r}; re-bake with "
                    f"quantize_params(..., feature_kind={feature_kind!r})"
                )
            self._qp = params if params.device.type == self.device.type else params.to(self.device)
        else:
            self._qp = quantize_params(
                params, cfg, mode=precision, prune=prune, policy=policy,
                feature_kind=feature_kind if on_device_features else None,
                device=self.device,
            )
        # Sharded-batch dispatch: split each slot block along a 1-D mesh
        # ("streams" axis), one artifact replica an entry.  shards=None keeps
        # the single-device path; shards=k (k=1 included) routes every
        # forward through accelerator_forward_sharded.
        if mesh is None and shards is not None:
            mesh = stream_mesh(shards, device=self.device.type)
        self._mesh = mesh
        self._mesh_axis = None
        self._replicas = None
        if mesh is not None:
            if len(mesh.axis_names) != 1:
                raise ValueError(
                    f"MonitorEngine needs a 1-D mesh (one batch-sharding "
                    f"axis), got axes {mesh.axis_names}"
                )
            if shards is not None and mesh.size != shards:
                raise ValueError(
                    f"mesh has {mesh.size} device(s) but shards={shards}; pass "
                    f"one or make them agree"
                )
            self._mesh_axis = mesh.axis_names[0]
            n_shards = mesh.shape[self._mesh_axis]
            if batch_slots % n_shards != 0:
                raise ValueError(
                    f"batch_slots {batch_slots} must divide evenly over {n_shards} shards"
                )
            self._replicas = replicate_params(self._qp, mesh)
        self.shards = 1 if mesh is None else mesh.shape[self._mesh_axis]
        self._rings = [
            StreamRing(self.window, self.hop, capacity_windows) for _ in range(n_streams)
        ]
        self.tracker = VectorTemporalTracker(
            n_streams,
            ema_alpha=ema_alpha,
            enter_threshold=enter_threshold,
            exit_threshold=exit_threshold,
            min_duration=min_duration,
        )
        self.slot_policy = SlotPolicy(
            batch_slots, adaptive=adaptive_slots, min_slots=min_slots, multiple=self.shards
        )
        self.adaptive_slots = self.slot_policy.adaptive
        self._pool = BlockPool(self._in_width, inflight)
        self._core = DispatchCore(
            submit=self._submit_rows,
            harvest=lambda out: out.cpu().numpy(),
            slot_policy=self.slot_policy,
            inflight=inflight,
        )
        self.admission = admission if admission is not None else AdmissionPolicy()
        self._admitted = np.ones(n_streams, bool)
        self._seen = np.zeros(n_streams, bool)
        self._n_seen = 0
        self._overflow_rounds = np.zeros(n_streams, np.int64)
        self._dropped_since_round = np.zeros(n_streams, np.int64)
        self._pending_evictions: list[int] = []
        self._ready_counts = np.zeros(n_streams, np.int64)
        self.sanitize = sanitize
        self.rejected_chunks = np.zeros(n_streams, np.int64)
        self.zeroed_samples = np.zeros(n_streams, np.int64)
        self.clipped_chunks = np.zeros(n_streams, np.int64)
        self.windows_scored = 0
        self.rounds = 0
        self._dropped_samples = 0
        self.served_windows = np.zeros(n_streams, np.int64)
        self.deferred_windows = np.zeros(n_streams, np.int64)
        self.refused_chunks = np.zeros(n_streams, np.int64)

    @property
    def artifact(self) -> QuantizedParams:
        return self._qp

    # -- ingest --------------------------------------------------------------

    def push(self, stream: int, samples: np.ndarray) -> int:
        """Append raw audio to one stream; returns samples dropped (overflow).
        Chunks for streams refused at admission (or evicted) are counted in
        ``refused_chunks`` and never reach a ring."""
        if not 0 <= stream < self.n_streams:
            raise ValueError(
                f"stream index {stream} out of range for an engine with "
                f"{self.n_streams} stream(s) (valid: 0..{self.n_streams - 1})"
            )
        if not self._seen[stream]:
            self._seen[stream] = True
            self._n_seen += 1
            max_streams = self.admission.max_streams
            if max_streams is not None and self._n_seen > max_streams:
                self._admitted[stream] = False
        if not self._admitted[stream]:
            self.refused_chunks[stream] += 1
            return 0
        x = np.asarray(samples, np.float32).reshape(-1)
        if self.sanitize is not None:
            x, rep = self.sanitize.apply(x)
            self.zeroed_samples[stream] += rep.zeroed
            if rep.clipped:
                self.clipped_chunks[stream] += 1
            if rep.rejected:
                self.rejected_chunks[stream] += 1
                return 0
        ring = self._rings[stream]
        dropped = ring.push(x)
        self._dropped_samples += dropped
        if dropped:
            self._dropped_since_round[stream] += dropped
        self._ready_counts[stream] = ring.ready
        return dropped

    def ready_windows(self) -> np.ndarray:
        return self._ready_counts.copy()

    @property
    def dropped_samples(self) -> int:
        return self._dropped_samples

    @property
    def admitted(self) -> np.ndarray:
        return self._admitted.copy()

    def take_evictions(self) -> list[int]:
        """Stream ids evicted since the last call (overflow eviction)."""
        out, self._pending_evictions = self._pending_evictions, []
        return out

    # -- core counter shims --------------------------------------------------

    @property
    def fault_hook(self):
        """Fault-injection seam: called with the round's items before
        anything is submitted; it may raise, and ``step()`` then leaves
        rings and tracker untouched."""
        return self._core.pre_dispatch

    @fault_hook.setter
    def fault_hook(self, hook):
        self._core.pre_dispatch = hook

    @property
    def forward_calls(self) -> int:
        return self._core.blocks_dispatched

    @forward_calls.setter
    def forward_calls(self, v: int):
        self._core.blocks_dispatched = int(v)

    @property
    def padded_slots(self) -> int:
        return self._core.padded_slots

    @padded_slots.setter
    def padded_slots(self, v: int):
        self._core.padded_slots = int(v)

    @property
    def slot_histogram(self) -> dict[int, int]:
        return dict(self._core.slot_histogram)

    # -- scoring -------------------------------------------------------------

    def _submit(self, block: np.ndarray) -> torch.Tensor:
        """Dispatch one slot block; returns the (possibly in-flight) result."""
        x = torch.from_numpy(block).to(self.device)
        if self._mesh is not None:
            return accelerator_forward_sharded(
                self._replicas, x, self.cfg, mesh=self._mesh, axis_name=self._mesh_axis,
                raw_windows=self.on_device_features,
            )
        return accelerator_forward(
            self._qp, x, self.cfg, device=self.device, raw_windows=self.on_device_features
        )

    def _submit_rows(self, rows, slots: int) -> torch.Tensor:
        return self._submit(self._pool.pack(rows, slots))

    def _forward(self, rows: np.ndarray) -> np.ndarray:
        return np.stack(self._core.dispatch(list(rows)))

    def precompile(self) -> tuple[int, ...]:
        """Warm the datapath once per dispatchable slot shape; returns the ladder."""
        precompile_slot_shapes(
            self._qp if self._mesh is None else self._replicas, self.cfg,
            self.slot_policy.ladder, row_width=self._in_width, mesh=self._mesh,
            axis_name=self._mesh_axis, raw_windows=self.on_device_features,
        )
        return self.slot_policy.ladder

    def step(self) -> list[WindowScore]:
        """Score one round over the admitted backlog (transactional: if the
        forward raises, every ring and the tracker stay as they were)."""
        adm = self.admission
        cand = np.flatnonzero((self._ready_counts > 0) & self._admitted)
        if cand.size == 0:
            return []
        ready = self._ready_counts[cand]
        want = np.minimum(ready, adm.max_per_stream_per_round)
        alloc = fair_allocation(want, adm.round_budget)
        offs = np.zeros(cand.size, np.int64)
        np.cumsum(alloc[:-1], out=offs[1:])
        wins = [self._rings[s].peek_windows(int(k)) for s, k in zip(cand, alloc) if k]
        stacked = np.concatenate(wins, axis=0)
        if self.on_device_features:
            rows = stacked  # raw windows; the front-end runs on the device
        else:
            rows = features.batch_features(stacked, self.feature_kind)
        p_uav = self._forward(rows)[:, 1]  # may raise: nothing committed yet
        # Tracker rounds go depth by depth so each stream's probabilities
        # reach its EMA in push order.
        out: list[WindowScore] = []
        for d in range(int(alloc.max())):
            m = alloc > d
            sel = cand[m]
            full = np.zeros(self.n_streams, np.float64)
            mask = np.zeros(self.n_streams, bool)
            full[sel] = p_uav[offs[m] + d]  # exact float32 -> float64 widening
            mask[sel] = True
            state = self.tracker.update(full, mask)
            out.extend(
                WindowScore(
                    stream=int(s),
                    window_idx=int(state["idx"][s]),
                    p_uav=float(full[s]),
                    smoothed=float(state["smoothed"][s]),
                    active=bool(state["active"][s]),
                )
                for s in sel
            )
        # Commit only now that the forward and the tracker rounds succeeded.
        for s, k in zip(cand, alloc):
            for _ in range(int(k)):
                self._rings[s].advance()
            self._ready_counts[s] = self._rings[s].ready
        self.windows_scored += int(alloc.sum())
        self.rounds += 1
        self.served_windows[cand] += alloc
        self.deferred_windows[cand] += ready - alloc
        overflowed = self._dropped_since_round > 0
        self._overflow_rounds = np.where(overflowed, self._overflow_rounds + 1, 0)
        self._dropped_since_round[:] = 0
        if adm.evict_overflow_rounds is not None:
            evict = np.flatnonzero(
                self._admitted & (self._overflow_rounds >= adm.evict_overflow_rounds)
            )
            for s in evict:
                self._admitted[s] = False
                self._pending_evictions.append(int(s))
        return out

    def drain(self) -> list[WindowScore]:
        """Run rounds until every buffered window has been scored."""
        out: list[WindowScore] = []
        while True:
            scored = self.step()
            if not scored:
                return out
            out.extend(scored)

    def finalize(self) -> list[list[TrackEvent]]:
        """Flush still-open tracks; returns per-stream event lists."""
        return self.tracker.finalize()

    # -- crash recovery ------------------------------------------------------

    def snapshot(self) -> dict:
        """Deep-copied numpy snapshot of all serving state (rings, tracker,
        counters, pending evictions); weights are not part of it."""
        return {
            "rings": [r.state_dict() for r in self._rings],
            "pending_evictions": [int(s) for s in self._pending_evictions],
            "tracker": self.tracker.state_dict(),
            "counters": {
                "windows_scored": self.windows_scored,
                "forward_calls": self.forward_calls,
                "padded_slots": self.padded_slots,
                "rounds": self.rounds,
                "dropped_samples": self._dropped_samples,
                "rejected_chunks": self.rejected_chunks.copy(),
                "zeroed_samples": self.zeroed_samples.copy(),
                "clipped_chunks": self.clipped_chunks.copy(),
                "served_windows": self.served_windows.copy(),
                "deferred_windows": self.deferred_windows.copy(),
                "refused_chunks": self.refused_chunks.copy(),
                "overflow_rounds": self._overflow_rounds.copy(),
                "dropped_since_round": self._dropped_since_round.copy(),
                "admitted": self._admitted.copy(),
                "seen": self._seen.copy(),
            },
        }

    def restore(self, snap: dict):
        """Load a :meth:`snapshot` (same ``n_streams`` and geometry)."""
        if len(snap["rings"]) != self.n_streams:
            raise ValueError(
                f"snapshot holds {len(snap['rings'])} stream(s) but this "
                f"engine was built for {self.n_streams}"
            )
        for ring, sd in zip(self._rings, snap["rings"]):
            ring.load_state_dict(sd)
        self.tracker.load_state_dict(snap["tracker"])
        c = snap["counters"]
        self.windows_scored = int(c["windows_scored"])
        self.forward_calls = int(c["forward_calls"])
        self.padded_slots = int(c["padded_slots"])
        self.rounds = int(c["rounds"])
        self._dropped_samples = int(c["dropped_samples"])
        for name in (
            "rejected_chunks", "zeroed_samples", "clipped_chunks",
            "served_windows", "deferred_windows", "refused_chunks",
        ):
            setattr(self, name, np.asarray(c[name], np.int64).copy())
        self._overflow_rounds = np.asarray(c["overflow_rounds"], np.int64).copy()
        self._dropped_since_round = np.asarray(c["dropped_since_round"], np.int64).copy()
        self._admitted = np.asarray(c["admitted"], bool).copy()
        self._seen = np.asarray(c["seen"], bool).copy()
        self._n_seen = int(self._seen.sum())
        self._pending_evictions = [int(s) for s in snap.get("pending_evictions", [])]
        self._ready_counts = np.array([r.ready for r in self._rings], np.int64)

    def snapshot_bytes(self) -> bytes:
        """:meth:`snapshot` serialised through the exact on-disk codec
        (:func:`repro_torch.serving.durability.dumps_state`): dtypes, shapes
        and scalar counters survive the byte round-trip bit-for-bit."""
        from repro_torch.serving.durability import dumps_state

        return dumps_state(self.snapshot())

    def restore_bytes(self, data: bytes) -> None:
        """Inverse of :meth:`snapshot_bytes`."""
        from repro_torch.serving.durability import loads_state

        self.restore(loads_state(data))
