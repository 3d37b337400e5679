"""Durable crash-safe serving state: checkpoints + a write-ahead chunk log.

Counterpart of ``repro/serving/durability.py``, kept byte-compatible with
it: the same snapshot gives the same :func:`dumps_state` bytes in both
packages, and the frames, checkpoint files and WAL records are laid out the
same, so a state dir written by either fleet restores into the other.
A snapshot holds numpy only; a ``torch.Tensor`` in it makes
:func:`dumps_state` raise ``TypeError``.

Every recovery mechanism above this module (``last_good`` snapshots, push
journals, revive/splice) lives in process memory: it survives a worker
*fault*, not a process *death*.  A field deployment is duty-cycled and
brown-out-prone — SIGKILL, watchdog restart, power loss — so the mutable
serving state must also live on disk:

* :class:`CheckpointStore` — versioned snapshot files.  Each file is one
  CRC-32-framed record holding a :func:`dumps_state` payload, published
  with the temp-file + ``os.replace`` idiom:
  a reader sees the old bytes or the new bytes, never a torn file.
  Superseded versions are compacted away (``retain`` newest kept), and a
  corrupt newest version falls back to the previous one instead of
  crashing the restart.
* :class:`ChunkWAL` — a per-worker append-only journal of admitted chunks,
  the on-disk twin of the supervisor's in-memory push journal.  Appends are
  CRC-32-framed; the fsync policy (``always`` | ``interval`` | ``never``)
  trades durability of the last few chunks against append latency.
  :meth:`ChunkWAL.replay` verifies every frame CRC and *truncates* the log
  at the first torn or corrupt tail record — the expected end state of a
  crash mid-append — instead of raising.
* :func:`dumps_state` / :func:`loads_state` — an exact byte codec for the
  engine's ``snapshot()`` payloads: numpy arrays keep dtype and shape
  bit-for-bit (``.npy`` framing), scalar counters and
  :class:`~repro_torch.serving.tracker.TrackEvent` records round-trip through a
  JSON skeleton (Python's shortest-repr floats make that exact too).  The
  bitwise cold-restart contract in ``tests/test_torch_durability.py`` rests on
  this codec being lossless.
* :class:`LocalFilesystem` — the injectable seam every byte passes through.
  Production uses this thin ``os`` wrapper; the chaos harness wraps it in
  :class:`~repro_torch.serving.faults.FaultyFilesystem` to inject deterministic
  torn writes, bit flips, ENOSPC and slow fsyncs.

Nothing here imports the engine or the supervisor: this module is the
bottom of the durability stack and is reused by both.
"""
from __future__ import annotations

import io
import json
import os
import struct
import typing
import zlib

import numpy as np

from repro_torch.serving.tracker import TrackEvent

#: WAL/checkpoint fsync policies (see :class:`ChunkWAL`)
FSYNC_POLICIES = ("always", "interval", "never")

#: one frame = <payload length u32, CRC-32 of payload u32> + payload
FRAME_HEADER = struct.Struct("<II")

#: WAL record header inside a frame: global stream id, per-stream push
#: sequence number, ingest round at push time, flags
_WAL_HEADER = struct.Struct("<IIII")

#: WAL record flags: FAULTED = this record accounts for one transport-level
#: chunk fault (replay re-increments the supervisor's ``faulted_chunks``);
#: DROPPED = marker only — the fault ate the chunk, nothing to push (the
#: marker keeps the per-stream delivery cursor and fault counter exact
#: across a crash).
WAL_FAULTED = 0x1
WAL_DROPPED = 0x2


class CorruptRecord(ValueError):
    """A framed record failed its CRC / structure check."""


# -- CRC-32 record framing ----------------------------------------------------

def frame(payload: bytes) -> bytes:
    """Wrap a payload in the length+CRC frame both stores use."""
    return FRAME_HEADER.pack(len(payload), zlib.crc32(payload)) + payload


def read_frames(blob: bytes) -> tuple[list[bytes], int]:
    """Parse consecutive frames; returns ``(payloads, clean_length)``.

    Stops — without raising — at the first torn header, short payload, or
    CRC mismatch: ``clean_length`` is the byte offset of the first bad
    frame, i.e. everything before it verified.  ``clean_length <
    len(blob)`` is how a caller detects a torn/corrupt tail.
    """
    out: list[bytes] = []
    off = 0
    while off + FRAME_HEADER.size <= len(blob):
        n, crc = FRAME_HEADER.unpack_from(blob, off)
        start = off + FRAME_HEADER.size
        end = start + n
        if end > len(blob):
            break  # torn tail: frame promises more bytes than exist
        payload = blob[start:end]
        if zlib.crc32(payload) != crc:
            break  # corrupt frame (bit rot / flipped bits)
        out.append(payload)
        off = end
    return out, off


# -- exact state codec --------------------------------------------------------

def _encode(obj, arrays: list[np.ndarray]):
    if isinstance(obj, np.ndarray):
        arrays.append(obj)
        return {"t": "nd", "i": len(arrays) - 1}
    if isinstance(obj, TrackEvent):
        return {
            "t": "ev",
            "v": [obj.onset_idx, obj.offset_idx, obj.peak_score,
                  obj.mean_score],
        }
    if isinstance(obj, np.bool_):
        return {"t": "s", "v": bool(obj)}
    if isinstance(obj, np.integer):
        return {"t": "np", "d": str(obj.dtype), "v": int(obj)}
    if isinstance(obj, np.floating):
        return {"t": "np", "d": str(obj.dtype), "v": float(obj)}
    if isinstance(obj, dict):
        # tagged pairs, not a JSON object: integer keys (eviction stashes
        # are keyed by global stream id) must survive the round-trip
        return {
            "t": "d",
            "v": [[_encode(k, arrays), _encode(v, arrays)]
                  for k, v in obj.items()],
        }
    if isinstance(obj, tuple):
        return {"t": "tu", "v": [_encode(x, arrays) for x in obj]}
    if isinstance(obj, list):
        return {"t": "l", "v": [_encode(x, arrays) for x in obj]}
    if isinstance(obj, set):
        return {"t": "set", "v": [_encode(x, arrays) for x in sorted(obj)]}
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return {"t": "s", "v": obj}
    raise TypeError(f"dumps_state cannot serialise {type(obj).__name__}")


def _decode(node, arrays: list[np.ndarray]):
    t = node["t"]
    if t == "nd":
        return arrays[node["i"]]
    if t == "ev":
        on, off, peak, mean = node["v"]
        return TrackEvent(onset_idx=int(on), offset_idx=int(off),
                          peak_score=float(peak), mean_score=float(mean))
    if t == "np":
        return np.dtype(node["d"]).type(node["v"])
    if t == "d":
        return {
            _decode(k, arrays): _decode(v, arrays) for k, v in node["v"]
        }
    if t == "tu":
        return tuple(_decode(x, arrays) for x in node["v"])
    if t == "l":
        return [_decode(x, arrays) for x in node["v"]]
    if t == "set":
        return {_decode(x, arrays) for x in node["v"]}
    if t == "s":
        return node["v"]
    raise CorruptRecord(f"unknown state-codec tag {t!r}")


def dumps_state(obj) -> bytes:
    """Serialise a (possibly nested) state payload to bytes, exactly.

    Arrays are written in ``.npy`` framing (dtype, shape and byte order
    preserved bit-for-bit, including bool and float64); everything else —
    ints, floats, strings, ``TrackEvent``s, dicts with non-string keys,
    tuples, sets — rides a tagged JSON skeleton.  ``loads_state`` is the
    exact inverse: the serialisation round-trip tests pin ``==`` on every
    field, not closeness."""
    arrays: list[np.ndarray] = []
    skeleton = json.dumps(
        _encode(obj, arrays), separators=(",", ":")
    ).encode()
    buf = io.BytesIO()
    buf.write(struct.pack("<II", len(skeleton), len(arrays)))
    buf.write(skeleton)
    for a in arrays:
        np.lib.format.write_array(
            buf, np.ascontiguousarray(a), version=(1, 0), allow_pickle=False
        )
    return buf.getvalue()


def loads_state(data: bytes):
    """Inverse of :func:`dumps_state`; raises :class:`CorruptRecord` on any
    structural damage (a CRC frame normally catches that first)."""
    try:
        buf = io.BytesIO(data)
        n_skel, n_arrays = struct.unpack("<II", buf.read(8))
        skeleton = json.loads(buf.read(n_skel).decode())
        arrays = [
            np.lib.format.read_array(buf, allow_pickle=False)
            for _ in range(n_arrays)
        ]
        return _decode(skeleton, arrays)
    except CorruptRecord:
        raise
    except Exception as exc:  # struct/json/npy damage -> one error type
        raise CorruptRecord(f"undecodable state payload: {exc}") from exc


# -- filesystem seam ----------------------------------------------------------

class LocalFilesystem:
    """The injectable filesystem seam all durable I/O goes through.

    Production code uses this thin wrapper over ``os``; the chaos harness
    substitutes :class:`~repro_torch.serving.faults.FaultyFilesystem` (same duck
    type) to inject deterministic disk faults at the ``write``/``fsync``
    ops.  Keeping the surface small — open/write/fsync/replace and a few
    directory ops — is what makes the fault injection exhaustive."""

    def makedirs(self, path: str) -> None:
        os.makedirs(path, exist_ok=True)

    def exists(self, path: str) -> bool:
        return os.path.exists(path)

    def listdir(self, path: str) -> list[str]:
        try:
            return sorted(os.listdir(path))
        except FileNotFoundError:
            return []

    def remove(self, path: str) -> None:
        try:
            os.remove(path)
        except FileNotFoundError:
            pass

    def read_bytes(self, path: str) -> bytes:
        with open(path, "rb") as fh:
            return fh.read()

    def open_write(self, path: str):
        return open(path, "wb")

    def open_append(self, path: str):
        return open(path, "ab")

    def write(self, fh, data: bytes) -> int:
        return fh.write(data)

    def fsync(self, fh) -> None:
        fh.flush()
        os.fsync(fh.fileno())

    def close(self, fh) -> None:
        fh.close()

    def replace(self, src: str, dst: str) -> None:
        os.replace(src, dst)

    def truncate(self, path: str, size: int) -> None:
        with open(path, "r+b") as fh:
            fh.truncate(size)


def write_atomic(fs, path: str, data: bytes) -> None:
    """Temp-file + fsync + rename publish: a reader (or a restart) sees the
    old bytes or the new bytes, never a torn file.  On a failed write the
    temp file is removed and the published file is untouched."""
    tmp = path + ".tmp"
    try:
        fh = fs.open_write(tmp)
        try:
            fs.write(fh, data)
            fs.fsync(fh)
        finally:
            fs.close(fh)
    except BaseException:
        fs.remove(tmp)
        raise
    fs.replace(tmp, path)


# -- versioned checkpoint store -----------------------------------------------

class CheckpointStore:
    """Versioned, CRC-framed, atomically-published snapshot files.

    One file per version (``ckpt-<version>.bin``), each a single framed
    :func:`dumps_state` record.  ``save`` publishes atomically then
    compacts superseded versions down to ``retain``; ``load_latest`` walks
    versions newest-first and *skips* corrupt files (counted in
    ``corrupt_skipped``) so one damaged checkpoint degrades to the previous
    version instead of a crash."""

    PREFIX = "ckpt-"
    SUFFIX = ".bin"

    def __init__(self, root: str, *, fs=None, retain: int = 2):
        if retain < 1:
            raise ValueError(f"retain must be >= 1, got {retain}")
        self.root = root
        self.fs = fs if fs is not None else LocalFilesystem()
        self.retain = int(retain)
        self.corrupt_skipped = 0
        self.fs.makedirs(root)

    def _path(self, version: int) -> str:
        return os.path.join(
            self.root, f"{self.PREFIX}{int(version):010d}{self.SUFFIX}"
        )

    def versions(self) -> list[int]:
        out = []
        for name in self.fs.listdir(self.root):
            if name.startswith(self.PREFIX) and name.endswith(self.SUFFIX):
                try:
                    out.append(int(name[len(self.PREFIX):-len(self.SUFFIX)]))
                except ValueError:
                    continue
        return sorted(out)

    def save(self, version: int, payload) -> str:
        """Atomically publish ``payload`` as ``version``; compacts after."""
        path = self._path(version)
        write_atomic(self.fs, path, frame(dumps_state(payload)))
        self.compact()
        return path

    def load(self, version: int):
        """Load one version; raises :class:`CorruptRecord` if the file is
        torn, bit-rotted, or structurally damaged."""
        blob = self.fs.read_bytes(self._path(version))
        payloads, clean = read_frames(blob)
        if len(payloads) != 1 or clean != len(blob):
            raise CorruptRecord(
                f"checkpoint version {version} failed CRC framing "
                f"({clean}/{len(blob)} clean byte(s))"
            )
        return loads_state(payloads[0])

    def load_latest(self, *, at_or_before: int | None = None):
        """Newest valid ``(version, payload)``, or ``None`` when nothing
        loads.  ``at_or_before`` pins the search below a known version (the
        fleet meta's pinned version on restore: a newer orphan checkpoint —
        written just before the crash, never referenced by any meta — must
        not be resurrected)."""
        for v in reversed(self.versions()):
            if at_or_before is not None and v > at_or_before:
                continue
            try:
                return v, self.load(v)
            except (OSError, CorruptRecord):
                self.corrupt_skipped += 1
        return None

    def compact(self) -> None:
        """Drop superseded versions beyond the newest ``retain``."""
        for v in self.versions()[: -self.retain]:
            self.fs.remove(self._path(v))


# -- write-ahead chunk journal ------------------------------------------------

class WALRecord(typing.NamedTuple):
    stream: int  # global stream id
    seq: int  # per-stream push sequence number at push time
    round: int  # ingest round at push time
    flags: int  # WAL_FAULTED / WAL_DROPPED
    chunk: np.ndarray  # float32 payload (empty for DROPPED markers)


class ChunkWAL:
    """Append-only, CRC-framed journal of one worker's admitted chunks.

    The on-disk twin of the supervisor's in-memory push journal: every
    delivered chunk is appended *before* it reaches the engine, so the
    state at any crash instant is reconstructible as
    ``checkpoint + replay(wal)``.

    fsync policy:

    * ``always`` — fsync after every append: nothing acknowledged is ever
      lost, at ~one disk flush per chunk.
    * ``interval`` — fsync every ``fsync_interval`` appends: bounds the
      loss window to the last few chunks (the OS page cache still makes
      them visible to a same-host restart that didn't lose power).
    * ``never`` — leave flushing to the OS entirely.

    :meth:`replay` verifies every frame CRC and truncates the file at the
    first torn/corrupt tail record — counted in :attr:`truncations`, never
    raised — because a crash mid-append *routinely* leaves a half-written
    final frame."""

    def __init__(self, path: str, *, fs=None, fsync: str = "interval",
                 fsync_interval: int = 8):
        if fsync not in FSYNC_POLICIES:
            raise ValueError(
                f"fsync policy must be one of {FSYNC_POLICIES}, got {fsync!r}"
            )
        if fsync_interval < 1:
            raise ValueError(
                f"fsync_interval must be >= 1, got {fsync_interval}"
            )
        self.path = path
        self.fs = fs if fs is not None else LocalFilesystem()
        self.fsync = fsync
        self.fsync_interval = int(fsync_interval)
        self.fs.makedirs(os.path.dirname(path) or ".")
        self._fh = None
        self._since_sync = 0
        self.appended = 0  # records appended over this object's lifetime
        self.truncations = 0  # torn/corrupt tails truncated by replay()

    def append(self, *, stream: int, seq: int, round_: int,
               chunk: np.ndarray | None = None, flags: int = 0) -> None:
        """Append one framed record (chunk may be None for marker records)
        and fsync per policy.  Raises OSError/InjectedFault upward on a
        disk fault — the caller decides whether durability degradation is
        fatal (the supervisor counts it and keeps serving)."""
        payload = _WAL_HEADER.pack(int(stream), int(seq), int(round_),
                                   int(flags))
        if chunk is not None:
            payload += np.ascontiguousarray(chunk, np.float32).tobytes()
        if self._fh is None:
            self._fh = self.fs.open_append(self.path)
        self.fs.write(self._fh, frame(payload))
        self.appended += 1
        if self.fsync == "always":
            self.fs.fsync(self._fh)
        elif self.fsync == "interval":
            self._since_sync += 1
            if self._since_sync >= self.fsync_interval:
                self.fs.fsync(self._fh)
                self._since_sync = 0

    def sync(self) -> None:
        if self._fh is not None:
            self.fs.fsync(self._fh)
            self._since_sync = 0

    def replay(self) -> list[WALRecord]:
        """Parse the journal back into records, truncating any torn or
        corrupt tail in place (the file is cut back to its last clean
        frame; :attr:`truncations` counts it).  Never raises on damage."""
        self._close_handle()
        if not self.fs.exists(self.path):
            return []
        blob = self.fs.read_bytes(self.path)
        payloads, clean = read_frames(blob)
        records: list[WALRecord] = []
        off = 0
        for p in payloads:
            if len(p) < _WAL_HEADER.size or (
                (len(p) - _WAL_HEADER.size) % 4 != 0
            ):
                # CRC-valid but structurally short: treat as damage from
                # this record on (defensive; framing bugs, not bit rot)
                clean = off
                break
            stream, seq, rnd, flags = _WAL_HEADER.unpack_from(p)
            chunk = np.frombuffer(p[_WAL_HEADER.size:], np.float32).copy()
            records.append(WALRecord(stream, seq, rnd, flags, chunk))
            off += FRAME_HEADER.size + len(p)
        if clean < len(blob):
            self.truncations += 1
            self.fs.truncate(self.path, clean)
        return records

    def reset(self) -> None:
        """Start a fresh journal (called right after a checkpoint makes the
        current one redundant).  Removal is atomic; a crash between the
        checkpoint publish and this reset leaves stale records whose
        sequence numbers the restore path filters out."""
        self._close_handle()
        self.fs.remove(self.path)
        self._since_sync = 0

    def _close_handle(self) -> None:
        if self._fh is not None:
            try:
                self.fs.close(self._fh)
            finally:
                self._fh = None

    def close(self) -> None:
        """Flush (per policy — ``never`` stays unflushed) and close."""
        if self._fh is not None and self.fsync != "never":
            try:
                self.fs.fsync(self._fh)
            except OSError:
                pass
        self._close_handle()
