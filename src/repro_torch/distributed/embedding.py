"""Distributed embedding gather (the vocab-parallel, Megatron-style path).

Counterpart of ``repro/distributed/embedding.py``.  With the vocab axis
cut over the mesh, each rank holds its contiguous part of the table's rows
(``distributed/sharding.shard_tree``), so a gather of ``table[ids]``
becomes a shard-local gather: each rank gathers the ids that fall inside
its rows (clipped, zero elsewhere), and the partial embeddings are summed
over the vocab cut's process group with ``reduce_from`` (all-reduce
forward, identity backward) — one activation all-reduce, no one-hot
product.  A masked sum of one value and zeros is exact, so the result is
the plain gather's bit for bit; the gradient each rank gets is its own
rows' part of the whole table's.

The caller names the cut (``sharding.dim_cut`` of the table's vocab
dimension); a whole table (no rules, a vocab the mesh axis does not
divide, or an axis of one rank) takes the plain gather, as the reference
falls back to it.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.distributed.sharding import Cut, group_of, reduce_from


def embedding_gather(table: torch.Tensor, ids: torch.Tensor,
                     cut: Optional[Cut] = None) -> torch.Tensor:
    """(V, D) table, or this rank's (V / n, D) part of it under ``cut``;
    (...,) integer ids -> (..., D)."""
    ids = ids.to(device=table.device, dtype=torch.long)
    if cut is None:
        return table[ids]
    shard_v = table.shape[0]
    lo = cut.index * shard_v
    rel = ids.reshape(-1) - lo
    hit = (rel >= 0) & (rel < shard_v)
    rel = torch.clamp(rel, 0, shard_v - 1)
    out = table[rel]
    out = torch.where(hit[:, None], out, torch.zeros((), dtype=out.dtype, device=out.device))
    out = reduce_from(out, group_of(cut))
    return out.reshape(ids.shape + (table.shape[1],))
