"""LM serving driver: batched prefill + decode with a continuous-batching
queue — ``python -m repro_torch.launch.serve --arch <id> --smoke``.

Counterpart of ``repro/launch/serve.py``.  Requests enter the shared
:class:`~repro_torch.serving.batching.DispatchCore` queue (the same core
the detector's ``MonitorEngine`` runs on), are batched to a fixed slot
count (padding slots carry a dead request, or, with
``adaptive_slots=True``, the block shrinks over the power-of-two ladder to
fit the tail of the queue), prefilled in one shot, then decoded
step-locked with per-slot stop handling.

LM decode is *not* batch-composition independent (prompts are left-padded
to the batch's longest prompt with no pad masking), as in the reference,
so the core runs with synchronous submit and makes no cross-batch bitwise
claim: what it shares is the queue/slot/commit machinery.

The CLI is the reference's, ``--smoke`` included (a ``store_true`` that
defaults to true, so the CLI always serves the smoke config), plus
``--device {cuda,cpu}``, CUDA by default: without a GPU, ``cuda`` fails
before anything is built.  The reference's host mesh and sharding rules
are identities on one device and are not built here.  The weights are
seeded random (``init_params(0, cfg)``, a ``torch.Generator``, so not the
reference's values).  Each decode step reads every slot's token back to
the host (``int(cur[i, 0])``), as the reference does.  On a CUDA device, a
config whose decode step reads its position only in device ops
(``transformer.decode_graphable``: phi4-mini's and granite-4.0-h-micro's)
replays that step as CUDA graphs (:class:`DecodeGraphs`); every other
decodes eagerly.
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import itertools
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.kernels.backend import resolve_device
from repro_torch.kernels.graphs import GraphCache
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.serving.batching import DispatchCore, SlotPolicy


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray  # (S,) int32
    max_new: int = 16
    out: Optional[np.ndarray] = None


@dataclasses.dataclass
class _StepBuffers:
    """One batch shape's buffers: graph ``i`` reads the caches in
    ``bufs[i]`` and writes the new ones into ``bufs[1 - i]``, from the token
    in ``tok`` and the position in ``pos``."""

    bufs: list
    tok: torch.Tensor
    pos: torch.Tensor
    #: the buffer the last step wrote
    last: int = 1

    def step(self, graphs, tok: torch.Tensor, caches, pos: int):
        i = 0 if caches is self.bufs[0] else 1 if caches is self.bufs[1] else None
        if i is None:  # the caller's own caches, into the buffer the last step read
            i = 1 - self.last
            T.copy_into(self.bufs[i], caches)
        self.tok.copy_(tok)
        self.pos.fill_(pos)
        graphs[i].replay()
        self.last = 1 - i
        return graphs[i].out, self.bufs[1 - i]


class DecodeGraphs:
    """``transformer.decode_step`` replayed as CUDA graphs (when:
    :mod:`repro_torch.kernels.graphs`), two a batch shape over two cache
    buffers (:class:`_StepBuffers`).  Caches the last step returned are
    read in place, others (a prefill's) copied into the buffer it read: a
    step's caches hold until the second call after it or a call handed
    other caches, its logits until the next call.  Other weights than the
    server's run eagerly."""

    #: batch shapes captured, and steps served from a replay, over every instance
    graph_captures = 0
    graph_replays = 0

    def __init__(self, cfg, params, max_seq: int):
        self.cfg, self.params, self.max_seq = cfg, params, max_seq
        self.graphs = GraphCache(DecodeGraphs)
        self.nodes = L.tree_nodes(params)

    def __call__(self, params, tok: torch.Tensor, caches, pos: int):
        eager = functools.partial(T.decode_step, params, tok, caches, pos, self.cfg, self.max_seq)
        if params is not self.params:
            return eager()
        # the weight guard's leaves: every dict's values, a swapped leaf or dict among them
        slots = list(itertools.chain.from_iterable(map(dict.values, self.nodes)))
        out = self.graphs((tuple(tok.shape),), slots, eager,
                          lambda: self._buffers(tok, caches, pos),
                          lambda state, graphs: state.step(graphs, tok, caches, pos))
        if self.graphs.leaves is slots:  # the guard took them anew: a dict may be new too
            self.nodes = L.tree_nodes(params)
        return out

    def _buffers(self, tok: torch.Tensor, caches, pos: int):
        """A batch shape's buffers, the first holding ``caches``, and the
        work of its two graphs."""
        bufs = [L.tree_map(lambda t: torch.empty_like(t, memory_format=torch.contiguous_format),
                           caches) for _ in range(2)]
        T.copy_into(bufs[0], caches)
        state = _StepBuffers(bufs, tok.clone(),
                             torch.full((), int(pos), dtype=torch.int64, device=tok.device))

        def run(i):
            return T.decode_step(self.params, state.tok, bufs[i], state.pos, self.cfg,
                                 self.max_seq, out=bufs[1 - i])[0]

        return state, [lambda: run(0), lambda: run(1)]


class BatchedServer:
    """Continuous-batching server over prefill/decode, running on the shared
    :class:`~repro_torch.serving.batching.DispatchCore`.

    ``batch_slots`` fixes the batch size; dead slots in a partial final
    batch carry a dead request (``rid=-1``, the block's first prompt).
    ``adaptive_slots=True`` instead lets the slot policy shrink the final
    blocks over a power-of-two ladder, so no dead slot is decoded.  The
    params are moved to ``device`` (CUDA unless ``device="cpu"``; raises
    without a GPU).
    """

    def __init__(
        self,
        cfg,
        params,
        *,
        batch_slots: int = 4,
        max_seq: int = 256,
        adaptive_slots: bool = False,
        device="cuda",
    ):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = T.params_to(params, self.device)
        self.slots = batch_slots
        self.max_seq = max_seq
        self._prefill = lambda p, b: T.forward_with_cache(p, b, cfg, max_seq)
        if self.device.type == "cuda" and T.decode_graphable(cfg, self.params):
            self._decode = DecodeGraphs(cfg, self.params, max_seq)
        else:
            self._decode = lambda p, tok, c, pos: T.decode_step(p, tok, c, pos, cfg, max_seq)
        self._greedy = True  # per-serve() decode mode, read by _submit
        # Synchronous: prefill+decode completes before the next block is
        # packed, so no harvest stage and a single in-flight slot.
        self._core = DispatchCore(
            submit=self._submit,
            harvest=None,
            slot_policy=SlotPolicy(batch_slots, adaptive=adaptive_slots),
            inflight=1,
        )

    @property
    def slot_histogram(self) -> dict[int, int]:
        """Blocks dispatched per slot shape (adaptive observability)."""
        return dict(self._core.slot_histogram)

    def _submit(self, live: list[Request], slots: int) -> list[Request]:
        batch = list(live) + [  # pad dead slots
            Request(rid=-1, prompt=live[0].prompt, max_new=0)
            for _ in range(slots - len(live))
        ]
        return self._serve_batch(batch, self._greedy)[: len(live)]

    def serve(self, requests: list[Request], greedy: bool = True) -> list[Request]:
        """Serve the requests in arrival order; returns them completed."""
        self._greedy = greedy
        self._core.enqueue(requests)
        return self._core.drain()

    @torch.inference_mode()
    def _serve_batch(self, batch: list[Request], greedy: bool) -> list[Request]:
        s = max(len(r.prompt) for r in batch)
        toks = np.zeros((len(batch), s), np.int32)
        for i, r in enumerate(batch):
            toks[i, s - len(r.prompt) :] = r.prompt  # left-pad
        tokens = torch.from_numpy(toks).to(self.device)
        logits, caches = self._prefill(self.params, {"tokens": tokens})
        outs = [[] for _ in batch]
        cur = torch.argmax(logits[:, -1:, :], dim=-1).to(torch.int32)
        max_new = max(r.max_new for r in batch)
        for step in range(max_new):
            for i, r in enumerate(batch):
                if step < r.max_new:
                    outs[i].append(int(cur[i, 0]))
            logits, caches = self._decode(self.params, cur, caches, s + step)
            cur = torch.argmax(logits, dim=-1).to(torch.int32)
        for r, o in zip(batch, outs):
            r.out = np.asarray(o[: r.max_new], np.int32)
        return batch


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma-2b")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument(
        "--adaptive-slots", action="store_true",
        help="shrink final blocks over the slot ladder instead of padding "
             "dead requests",
    )
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
    params = T.init_params(0, cfg, device=dev)
    server = BatchedServer(
        cfg, params, batch_slots=args.slots,
        adaptive_slots=args.adaptive_slots, device=dev,
    )
    rng = np.random.default_rng(0)
    reqs = [
        Request(rid=i, prompt=rng.integers(0, cfg.vocab, rng.integers(4, 24)).astype(np.int32),
                max_new=args.max_new)
        for i in range(args.requests)
    ]
    t0 = time.time()
    done = server.serve(reqs)
    dt = time.time() - t0
    n_tok = sum(len(r.out) for r in done)
    print(f"served {len(done)} requests, {n_tok} tokens in {dt:.2f}s ({n_tok/dt:.1f} tok/s)")
    print(f"slot histogram: {server.slot_histogram}")
    for r in done:
        print(f"  req {r.rid}: prompt[{len(r.prompt)}] -> {list(r.out)}")
    return done


if __name__ == "__main__":
    main()
