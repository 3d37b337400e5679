"""The port's one CUDA-graph cache, through which the detector's forward
(``serving/accelerator.py``) and the LM decode step (``launch/serve.py``)
replay.  An owner holds one :class:`GraphCache`, keyed by the owner's key
and the calling stream.  A key's first call runs eagerly (the kernel
library, the kept constants); the second captures and is served from a
replay, as is every later call, unless a profiler records (the capture
waits) or the owner holds :data:`KEYS_PER_OWNER` keys' graphs (the key
stays eager for good; no graph is evicted).  A leaf swapped or written in
place (an inference tensor keeps no count) drops the owner's graphs.  The
owner's ``graph_captures`` counts the keys captured, ``graph_replays`` the
calls served from a replay: 1 and ``n - 1`` over ``n`` calls of a key.
"""
from __future__ import annotations

import contextlib
import dataclasses
import operator
import threading

import torch

from repro_torch.kernels import backend

#: keys one owner holds graphs of, at most: an engine's slot ladder 1, 2, 4, ..., 128 fits
KEYS_PER_OWNER = 8
_version = operator.attrgetter("_version")


@dataclasses.dataclass
class Graph:
    """A captured graph, its output (written anew by each replay), the
    launches a replay makes and the split scratch it reads, kept alive."""

    graph: "torch.cuda.CUDAGraph"
    out: object
    launches: dict
    scratch: list

    def replay(self) -> None:
        self.graph.replay()
        backend.add_launches(self.launches)


class GraphCache:
    """One owner's graphs by key and calling stream; ``owner`` holds the
    ``graph_captures`` and ``graph_replays`` counters."""

    def __init__(self, owner):
        self.owner, self.lock = owner, threading.Lock()
        # the last call's leaves, those that keep a write count, their counts, their device
        self.leaves, self.tracked, self.versions, self.device = [], [], [], None
        # keys called; key -> (state, graphs); calling stream -> pool
        self.seen, self.entries, self.pools = set(), {}, {}

    def __call__(self, key: tuple, leaves: list, eager, build, replay):
        """One call of ``key`` on ``leaves`` (the tensors the graphs read,
        and any dicts holding them): ``eager()`` runs it; ``build()`` returns
        ``(state, bodies)``, static buffers holding this call's inputs and
        what each graph computes from them; ``replay(state, graphs)`` serves it."""
        with self.lock:
            if not self._same_weights(leaves):
                self.seen, self.entries, self.pools = set(), {}, {}
            caller = torch.cuda.current_stream(self.device)
            key = key + (caller.cuda_stream,)
            entry = self.entries.get(key)
            if entry is None and len(self.entries) < KEYS_PER_OWNER:
                if key in self.seen and not torch.autograd._profiler_enabled():
                    state, bodies = build()
                    entry = self.entries[key] = (state, self._capture(self.device, caller, bodies))
                    backend.count_launch(self.owner, "graph_captures")
                else:
                    self.seen.add(key)
            if entry is not None:
                out = replay(*entry)
                backend.count_launch(self.owner, "graph_replays")
                return out
        return eager()

    def _same_weights(self, leaves: list) -> bool:
        """Whether ``leaves`` are the last call's, as often written; if not, held from now on."""
        if (len(leaves) == len(self.leaves) and all(map(operator.is_, leaves, self.leaves))
                and list(map(_version, self.tracked)) == self.versions):
            return True
        self.leaves = leaves
        tensors = [t for t in leaves if isinstance(t, torch.Tensor)]
        self.device = tensors[0].device
        self.tracked = [t for t in tensors if not t.is_inference()]
        self.versions = list(map(_version, self.tracked))
        return False

    def _capture(self, dev: torch.device, caller, bodies) -> list[Graph]:
        """On a stream of its own for each (device, calling stream), warmed
        by one eager run whose launches no call counts (a call counts its
        replay's), into one pool per calling stream (its replays are ordered)."""
        cap = _capture_stream(dev, caller)
        pool = self.pools.setdefault(caller.cuda_stream, torch.cuda.graph_pool_handle())
        cap.wait_stream(caller)
        graphs, scratch = [], []
        with torch.cuda.stream(cap):
            with backend.record_launches():
                bodies[0]()
            for body in bodies:
                graph = torch.cuda.CUDAGraph()
                with backend.record_launches() as launches:
                    graph.capture_begin(pool=pool, capture_error_mode="thread_local")
                    try:
                        out = body()
                    except BaseException:
                        with contextlib.suppress(RuntimeError):
                            graph.capture_end()
                        raise
                    graph.capture_end()
                graphs.append(Graph(graph, out, launches, scratch))
        caller.wait_stream(cap)
        scratch += backend.split_scratch_of(dev, cap.cuda_stream)
        for t in scratch:
            t.record_stream(caller)
        return graphs


_streams_lock = threading.Lock()
_capture_streams: dict[tuple, "torch.cuda.Stream"] = {}  # (device, calling stream) -> stream


def _capture_stream(dev: torch.device, caller: "torch.cuda.Stream") -> "torch.cuda.Stream":
    """The stream the graphs of ``caller`` are captured on.  PyTorch hands
    out streams from a pool round-robin: one that is a calling stream or
    another capture stream is passed over."""
    key = (dev, caller.cuda_stream)
    with _streams_lock:
        cap = _capture_streams.get(key)
        if cap is None:
            taken = {k[1] for k in _capture_streams} | {
                s.cuda_stream for s in _capture_streams.values()}
            for _ in range(64):
                cap = torch.cuda.Stream(dev)
                if cap.cuda_stream not in taken and cap.cuda_stream != caller.cuda_stream:
                    break
            else:
                raise RuntimeError(f"no free stream on {dev} to capture a graph on")
            _capture_streams[key] = cap
        return cap
