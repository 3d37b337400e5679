"""Device resolution and the CUDA kernel library.

Counterpart of ``repro/kernels/backend.py``.  There, one switch picked the
Pallas interpreter off the TPU; here the device of the tensor decides:

* a CPU tensor goes to the kernel's plain PyTorch version (the CPU tests'
  path, and the oracle the card is held against);
* a CUDA tensor goes to the hand-written kernel, or the call raises.  No
  path falls back from the card to the plain version.

The kernels (``csrc/*.cu``, which include the shared headers
``csrc/*.cuh``) are compiled on first use, one ``nvcc`` per source, all
started together, and linked into one shared library with a plain C
interface under ``build/repro_torch/`` at the root of the checkout, loaded
with ``ctypes``.  The library name carries a hash of every source and
header, so an edited kernel or header is never served from a stale build.
Every C entry point returns ``cudaGetLastError()`` after its launches;
:func:`check` turns a non-zero code into an exception.

The program's own instrumentation lives here too: the wrappers' launch
counters (:func:`count_launch`; a CUDA graph's capture records them with
:func:`record_launches` and each replay adds them with :func:`add_launches`)
and the profiler spans (:func:`span`, recorded inside :func:`program_spans`;
the LM path's :func:`lm_span`, whenever a profiler records) that mark its
layers in a ``torch.profiler`` trace.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch
from torch._subclasses.fake_tensor import FakeTensor

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3",
    # no contraction of a*b+c into an FMA: the epilogues and the CORDIC
    # range reduction must round each multiply and add like the reference
    "--fmad=false",
    "-Xcompiler", "-fPIC",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

#: C signature of every entry point: (argtypes) -> int (a cudaError_t)
SIGNATURES = {
    # x, w, acc, out, x_scale, w_scale, bias, clip, has_clip, relu,
    # xs_per_row, ws_per_col, M, K, N, workspace, counters, bm,
    # chunks_per_block, splits, stream
    "quant_matmul_i8": (
        _P, _P, _P, _P, _P, _P, _P, _F, _I, _I, _I, _I, _I, _I, _I, _P, _P, _I, _I, _I, _P
    ),
    # x, w, w packed, acc, out, x_scale, w_scale, bias, clip, has_clip, relu,
    # xs_per_row, ws_per_col, B, L, Cin, Cout, K, bm, bn, stages, stream
    "conv1d_fused_i8": (
        _P, _P, _P, _P, _P, _P, _P, _P, _F, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
        _P,
    ),
    # x, out, rows, cols, stream
    "cordic_softmax_f32": (_P, _P, _I, _I, _P),
    # x, out, n, mode, stream
    "cordic_activation_f32": (_P, _P, _I, _I, _P),
    # x, m, out, R, K, N, tile, workspace, counters, stream
    "project_rows_f32": (_P, _P, _P, _I, _I, _I, _I, _P, _P, _P),
    # the chunk of k project_rows sums in ascending order (PROJECT_CHUNK)
    "project_rows_chunk": (),
    # x, out, R, n, stream
    "row_sum_f32": (_P, _P, _I, _I, _P),
    # stream: an empty kernel, the launch floor chip_smoke.py measures
    "empty_launch": (_P,),
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
#: seconds the last build took (0.0 when the library was already built)
build_seconds: float = 0.0


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; asking for CUDA without a GPU raises
    (entry points never drop to the CPU on their own)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device='cuda' was requested but no CUDA device is available; "
                "pass device='cpu' to run the plain PyTorch path"
            )
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r} (use 'cuda' or 'cpu')")
    return dev


def on_card(*tensors: torch.Tensor) -> bool:
    """True when every tensor is on a CUDA device, False when every one is
    on the CPU; mixed or other devices raise, and so does a fake tensor
    (``FakeTensorMode``, the dry run): a kernel launched on one would read
    a pointer to nothing, and its plain twin would hide that it was met."""
    if any(isinstance(t, FakeTensor) for t in tensors):
        raise RuntimeError("a hand-written kernel was reached with a fake tensor "
                           "(FakeTensorMode); it cannot be traced")
    kinds = {t.device.type for t in tensors}
    if kinds == {"cuda"}:
        if len({t.device for t in tensors}) != 1:
            raise ValueError("kernel operands lie on different CUDA devices")
        return True
    if kinds == {"cpu"}:
        return False
    raise ValueError(f"kernel operands on devices {sorted(kinds)}")


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    h = hashlib.sha1()
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"librepro_torch_kernels_{h.hexdigest()[:12]}.so"


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    cand = Path(CUDA_HOME) / "bin" / "nvcc" if CUDA_HOME else None
    if cand is not None and cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def build() -> Path:
    """Compile ``csrc/*.cu`` into the kernel library unless the current
    sources are already built; returns the library path.  Each source is
    compiled by its own ``nvcc`` process, all running at once, then the
    objects are linked."""
    global build_seconds
    out = library_path()
    if out.exists():
        build_seconds = 0.0
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{out.stem}.{os.getpid()}"
    t0 = time.perf_counter()
    objs, procs = [], []
    for src in sorted(CSRC.glob("*.cu")):
        obj = out.parent / f"{tag}.{src.stem}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(src), "-o", str(obj)]
        objs.append(obj)
        procs.append((cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    failed = []
    for cmd, proc in procs:
        _, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{err}")
    try:
        if failed:
            raise RuntimeError("\n".join(failed))
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, "-shared", "-o", str(tmp), *map(str, objs)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc link failed ({proc.returncode}):\n{' '.join(cmd)}\n{proc.stderr}"
            )
        os.replace(tmp, out)
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    build_seconds = time.perf_counter() - t0
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib


#: every :class:`SplitScratch` made, so that a CUDA graph can hold the pairs it reads
_split_scratches: list["SplitScratch"] = []


class SplitScratch:
    """The workspace and tile counters of a kernel whose grid splits a sum
    over blocks (K1's K splits, ``project_rows``'s chunks of k), one pair
    per device and stream, so that two streams never share one.  Both are
    zeroed when allocated; each split call leaves the counters (and K1 its
    workspace) as it found them.  Fleet lanes launch from several threads:
    the table is locked (the launches themselves are ordered by their
    stream)."""

    def __init__(self, dtype: torch.dtype):
        self.dtype = dtype
        self._table: dict[tuple, tuple[torch.Tensor, torch.Tensor]] = {}
        self._lock = threading.Lock()
        _split_scratches.append(self)

    def __getitem__(self, key: tuple) -> tuple[torch.Tensor, torch.Tensor]:
        return self._table[key]

    def get(self, device: torch.device, stream: int, values: int, tiles: int):
        """``(workspace, counters)`` for ``device`` and ``stream``, grown to
        at least ``values`` and ``tiles`` entries."""
        key = (device, stream)
        with self._lock:
            ws, counters = self._table.get(key, (None, None))
            if ws is None or ws.numel() < values or counters.numel() < tiles:
                size = max(values, 0 if ws is None else ws.numel())
                count = max(tiles, 0 if counters is None else counters.numel())
                ws = torch.zeros(size, dtype=self.dtype, device=device)
                counters = torch.zeros(count, dtype=torch.int32, device=device)
                self._table[key] = (ws, counters)
        return ws, counters

    def drop(self, device: torch.device, stream: int) -> None:
        """Forget the pair after a failed launch, which may have left a
        partial sum or a counter behind."""
        with self._lock:
            self._table.pop((device, stream), None)


def split_scratch_of(device: torch.device, stream: int) -> list[torch.Tensor]:
    """The workspaces and counters every :class:`SplitScratch` holds for
    ``device`` and ``stream`` now: what a graph captured on that stream
    reads, and keeps alive after a larger call has grown the table."""
    out = []
    for scratch in _split_scratches:
        with scratch._lock:
            out.extend(scratch._table.get((device, stream), ()))
    return out


_count_lock = threading.Lock()
#: the launches a thread's graph capture records (:func:`record_launches`)
_recording = threading.local()


def count_launch(wrapper, counter: str = "launches") -> None:
    """Add one to ``wrapper.<counter>``: ``launches`` is the counter a
    kernel's wrapper bumps where it launches its kernel.  Under a lock: the
    fleet's execution lanes launch kernels from several threads at once, and
    an unlocked ``+= 1`` could lose a count.  Inside :func:`record_launches`
    on this thread the launch is recorded instead: a captured launch runs
    only when its graph is replayed."""
    rec = getattr(_recording, "launches", None)
    if rec is not None:
        rec[wrapper, counter] = rec.get((wrapper, counter), 0) + 1
        return
    with _count_lock:
        setattr(wrapper, counter, getattr(wrapper, counter) + 1)


@contextlib.contextmanager
def record_launches():
    """Record, not count, this thread's :func:`count_launch` calls inside
    the scope (a CUDA graph's capture); yields the record, which
    :func:`add_launches` adds to the counters once per replay."""
    rec: dict = {}
    _recording.launches = rec
    try:
        yield rec
    finally:
        _recording.launches = None


def add_launches(rec: dict) -> None:
    """Add a :func:`record_launches` record to its counters."""
    with _count_lock:
        for (wrapper, counter), n in rec.items():
            setattr(wrapper, counter, getattr(wrapper, counter) + n)


#: prefix of every program span's name (what a trace reader matches)
SPAN_PREFIX = "repro_torch."
_NO_SPAN = contextlib.nullcontext()
#: open :func:`program_spans` scopes, over every thread
_span_scopes = 0


@contextlib.contextmanager
def program_spans():
    """Record the program's spans (:func:`span`) inside this scope while a
    ``torch.profiler`` session runs.  Off by default: a reader of the trace
    that counts every host event as an operator would take a span for one."""
    global _span_scopes
    with _count_lock:
        _span_scopes += 1
    try:
        yield
    finally:
        with _count_lock:
            _span_scopes -= 1


def spans_recording() -> bool:
    """True inside :func:`program_spans` while a profiler records."""
    return bool(_span_scopes) and torch.autograd._profiler_enabled()


def span(name: str):
    """A profiler span ``repro_torch.<name>`` (``record_function``) around a
    part of the program, inside :func:`program_spans` while a profiler
    records; else one shared null context, so that a span costs a flag
    check and no ``record_function`` when nothing reads it."""
    if spans_recording():
        return torch.profiler.record_function(SPAN_PREFIX + name)
    return _NO_SPAN


def lm_span(name: str):
    """A profiler span ``repro_torch.<name>`` of the LM path, recorded
    whenever a profiler records, with no :func:`program_spans` scope (the
    detector's forward keeps :func:`span`, whose scope also decides whether
    it replays its CUDA graph); else the shared null context."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(SPAN_PREFIX + name)
    return _NO_SPAN


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")


def stream_ptr(t: torch.Tensor) -> int:
    """PyTorch's current stream on ``t``'s device, as a raw handle."""
    return torch.cuda.current_stream(t.device).cuda_stream


def ptr(t: torch.Tensor | None) -> int | None:
    return None if t is None else t.data_ptr()
