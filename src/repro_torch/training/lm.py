"""LM-scale train and serve steps.

Counterpart of ``repro/training/lm.py``.

train_step: gradient accumulation over microbatches taken from the batch's
leading dim (bounds the fp32-logit working set under 200k+ vocabs): the
gradients are summed in fp32 from zeros in micro order, divided by the
micro count, optionally round-tripped through int8
(``fake_compress_grads``), and applied by Adam with fp32 states; remat per
block group comes from ``cfg.remat``.  Inside the reference's ``jax.jit``
XLA divides by the constant micro count as a multiply by its float32
reciprocal, in the gradient mean and in the loss mean alike, and the port
does the same.

Data parallel: with active sharding rules whose batch axes span several
ranks, each rank passes its own rows of the global batch (``shard_rows``:
its share of every microbatch, so the microbatches are the global ones);
every microbatch's loss is divided by the global count of unmasked labels,
and the gradient sums and the losses are all-reduced over the batch axes,
so every rank gets the global batch's mean loss and gradient (what GSPMD
gives the reference for a batch-sharded input).  Masks may hold different
counts on different ranks; the numerator and the count are reduced, never
per-rank means.

Tensor parallel over ``"model"``: the params and Adam states are this
rank's parts of their specs (``distributed/sharding.shard_tree``), the
blocks run the Megatron-style collectives, and a cut leaf's gradient is
this rank's part of the whole one, so it is summed over the batch axes
only, as every leaf is.  A whole leaf used in full on inputs ``copy_to``
makes identical has the same gradient on every rank of the model group
already; one a rank uses only in part enters through ``copy_to`` in its
block, which sums it.  The clip's global norm and the int8 round trip's
scale read across the cut groups (``cuts``).

serve steps: prefill (build the caches), decode (one token) and the
encoder's full forward.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch
import torch.distributed as dist

from repro_torch.configs.base import ArchConfig
from repro_torch.core.sensitivity import value_and_grad
from repro_torch.distributed import sharding as SH
from repro_torch.distributed.sharding import active_rules
from repro_torch.models import transformer as T
from repro_torch.models.layers import tree_leaves, tree_map
from repro_torch.training.compression import fake_compress_grads
from repro_torch.training.optimizer import Adam, AdamState


@dataclasses.dataclass(frozen=True)
class TrainSettings:
    n_micro: int = 8
    compress_pod_grads: bool = False  # int8 round trip of every gradient


def shard_rows(x, n_micro: int, n_ranks: int, idx: int):
    """Rank ``idx``'s rows of a global batch array for a data-parallel
    step: its share of every microbatch.  The step takes microbatch ``i``
    as the ``i``-th block of the global rows, so each rank holds the
    ``idx``-th part of each block, in block order."""
    b = x.shape[0]
    assert b % (n_micro * n_ranks) == 0, (b, n_micro, n_ranks)
    rows = x.reshape(n_micro, n_ranks, b // (n_micro * n_ranks), *x.shape[1:])[:, idx]
    return rows.reshape(b // n_ranks, *x.shape[1:])


def _batch_group():
    """The process group of the batch axes when the active rules split the
    batch over several ranks, else ``None``."""
    return SH.group_of(SH.batch_cut())


def param_cuts(cfg: ArchConfig, params):
    """Each param's whole-leaf ``sharding.Cut`` under the active rules
    (``None`` where whole), mirroring ``params``; ``None`` when no leaf is
    cut."""
    rules = active_rules()
    if rules is None:
        return None
    # the PSpecs give the global shapes without making a tensor (a dry
    # run's meter would count meta tensors made inside the step)
    specs = SH.tree_shardings(rules, T.build_specs(cfg), T.logical_axes(cfg), record=False)
    cuts = SH.map_specs(lambda _, spec: SH.spec_cut(spec, rules), params, specs)
    return cuts if any(c is not None for c in tree_leaves(cuts)) else None


def make_train_step(cfg: ArchConfig, opt: Adam, settings: TrainSettings = TrainSettings()
                    ) -> Callable:
    """Returns train_step(params, opt_state, batch) -> (params, opt_state,
    metrics); the params and state passed in are left as they were."""

    def train_step(params, opt_state: AdamState, batch: dict):
        n_micro = settings.n_micro
        b = next(iter(batch.values())).shape[0]
        assert b % n_micro == 0, (b, n_micro)
        micro = {k: v.reshape(n_micro, b // n_micro, *v.shape[1:]) for k, v in batch.items()}
        group = _batch_group()
        dev = tree_leaves(params)[0].device
        inv_n = torch.tensor(1.0 / n_micro, dtype=torch.float32, device=dev)

        gsum = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                        params)  # the step's own buffers: written in place below
        losses = []
        for i in range(n_micro):
            mb = {k: v[i] for k, v in micro.items()}
            count = None
            if group is not None:
                count = (mb["labels"] >= 0).sum().to(dev)
                dist.all_reduce(count, group=group)
            loss, grads = value_and_grad(lambda p: T.loss_fn(p, mb, cfg, count=count), params)
            for a, g in zip(tree_leaves(gsum), tree_leaves(grads)):
                a.add_(g.to(torch.float32))
            del grads  # one microbatch's gradients held at a time
            losses.append(loss)
        loss = losses[0]
        for extra in losses[1:]:
            loss = loss + extra
        if group is not None:
            for a in tree_leaves(gsum):
                dist.all_reduce(a, group=group)
            dist.all_reduce(loss, group=group)
        grads = tree_map(lambda g: g.mul_(inv_n), gsum)
        del gsum  # so that the compression's input is freed as it returns
        cuts = param_cuts(cfg, params)
        if settings.compress_pod_grads:
            grads = fake_compress_grads(grads, jitted=True, cuts=cuts)
        new_params, new_opt = opt.update(grads, opt_state, params, cuts=cuts)
        return new_params, new_opt, {"loss": loss * inv_n}

    return train_step


def make_prefill_step(cfg: ArchConfig, max_seq: int) -> Callable:
    def prefill(params, batch: dict):
        return T.forward_with_cache(params, batch, cfg, max_seq)

    return prefill


def make_decode_step(cfg: ArchConfig, max_seq: int) -> Callable:
    def decode(params, token, caches, pos):
        return T.decode_step(params, token, caches, pos, cfg, max_seq)

    return decode


def make_encoder_step(cfg: ArchConfig) -> Callable:
    """Encoder-only 'serve' = full forward returning framewise logits."""

    def encode(params, batch: dict):
        return T.forward(params, batch, cfg)

    return encode
