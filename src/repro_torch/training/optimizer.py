"""Adam with fp32 states, global-norm clipping and a warmup-cosine schedule.

Counterpart of ``repro/training/optimizer.py``: the states are plain dicts
mirroring the params tree, and :meth:`Adam.update` is functional (new
params and state out), as the reference's is.  The bias corrections are
computed from the step as a float32 tensor (the jitted reference traces
``t``), not in Python's float64 ``b1 ** t``; the constants are float32
tensors on the params' device.  Leaves are walked in the trees' insertion
order.  The reference's ``jax.tree_util`` walks sorted keys; the LM params
are built in sorted-key order (``layers.init_from_specs``), so their global
norm sums in the reference's order, while the detector's (``w``, ``b``,
``alpha`` a layer) keep the order its seeded training was calibrated with.
The update works leaf by leaf (clip, moments, step), so beyond the new
params and moments it holds one leaf's temporaries, never a clipped copy
of the whole gradient tree.  Under tensor parallelism each leaf is this
rank's part and its moments are parts alike, with no change to the update;
only the clip's global norm reads across ranks (``cuts``: a cut leaf's
squares are summed over its group, a whole leaf's counted once).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Mapping, NamedTuple

import torch
import torch.distributed as dist

from repro_torch.distributed.sharding import group_of


class AdamState(NamedTuple):
    step: torch.Tensor  # int32 scalar
    mu: Any
    nu: Any


def _map(fn, *trees):
    """``jax.tree_util.tree_map`` over nested dicts of tensors."""
    first = trees[0]
    if isinstance(first, Mapping):
        return {k: _map(fn, *(t[k] for t in trees)) for k in first}
    return fn(*trees)


def _leaves(tree):
    if isinstance(tree, Mapping):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def _f32(v: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32, device=like.device)


@dataclasses.dataclass(frozen=True)
class Adam:
    lr: float | Callable[[torch.Tensor], torch.Tensor] = 1e-3
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    grad_clip_norm: float | None = 1.0

    def init(self, params) -> AdamState:
        dev = next(_leaves(params)).device
        zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)  # noqa: E731
        return AdamState(
            step=torch.zeros((), dtype=torch.int32, device=dev),
            mu=_map(zeros, params),
            nu=_map(zeros, params),
        )

    def _lr(self, step):
        return self.lr(step) if callable(self.lr) else self.lr

    @torch.no_grad()
    def update(self, grads, state: AdamState, params, *, cuts=None):
        """Returns (new_params, new_state); the inputs are left as they were.
        ``cuts`` mirrors ``grads`` with each leaf's ``sharding.Cut`` (``None``
        for a whole leaf), or is ``None`` where every leaf is whole."""
        scale = None
        if self.grad_clip_norm is not None:
            gnorm = global_norm(grads, cuts)
            scale = torch.clamp_max(_f32(self.grad_clip_norm, gnorm) / (gnorm + 1e-9), 1.0)
        step = state.step + 1
        like = state.step
        b1, b2 = _f32(self.b1, like), _f32(self.b2, like)
        c1, c2 = _f32(1 - self.b1, like), _f32(1 - self.b2, like)
        t = step.to(torch.float32)
        one = _f32(1.0, like)
        mhat_scale = one / (one - torch.pow(b1, t))
        vhat_scale = one / (one - torch.pow(b2, t))
        lr = self._lr(step)
        eps = _f32(self.eps, like)

        def leaf(p, m, v, g):
            if scale is not None:
                g = g * scale
            g = g.to(torch.float32)
            m = b1 * m + c1 * g
            v = b2 * v + c2 * torch.square(g)
            delta = lr * (m * mhat_scale) / (torch.sqrt(v * vhat_scale) + eps)
            if self.weight_decay:
                delta = delta + lr * self.weight_decay * p.to(torch.float32)
            return (p.to(torch.float32) - delta).to(p.dtype), m, v

        out = _map(leaf, params, state.mu, state.nu, grads)
        part = lambda i: _map(lambda o: o[i], out)  # noqa: E731
        return part(0), AdamState(step=step, mu=part(1), nu=part(2))


def global_norm(tree, cuts=None) -> torch.Tensor:
    """The whole tree's l2 norm.  With ``cuts`` (a tree of ``sharding.Cut``
    or ``None`` a leaf), the squares of the cut leaves are summed over
    their groups (one all-reduce a group) and each whole leaf, the same on
    every rank, is counted once."""
    sq = lambda g: torch.sum(torch.square(g.to(torch.float32)))  # noqa: E731
    if cuts is None:
        return torch.sqrt(sum(sq(g) for g in _leaves(tree)))
    total, parts = None, {}
    for g, cut in zip(_leaves(tree), _leaves(cuts)):
        if cut is None:
            total = sq(g) if total is None else total + sq(g)
        else:
            group = group_of(cut)
            key = id(group)
            parts[key] = (group, sq(g) if key not in parts else parts[key][1] + sq(g))
    for group, part in parts.values():
        dist.all_reduce(part, group=group)
        total = part if total is None else total + part
    return torch.sqrt(total)


def cosine_warmup_schedule(peak_lr: float, warmup: int, total: int, floor: float = 0.1):
    """Linear warmup -> cosine decay to floor*peak; ``lr(step)`` of an
    integer step tensor."""

    def lr(step):
        step = step.to(torch.float32)
        warm = peak_lr * step / max(warmup, 1)
        prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = peak_lr * (floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * prog)))
        return torch.where(step < warmup, warm, cos)

    return lr
