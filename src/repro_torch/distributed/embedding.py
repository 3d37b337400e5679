"""Distributed embedding gather (the vocab-parallel, Megatron-style path).

Counterpart of ``repro/distributed/embedding.py``.  With the vocab axis
sharded over the mesh, a gather of ``table[ids]`` becomes a shard-local
gather: each rank of the vocab axes takes its contiguous slice of the
table's rows, gathers the ids that fall inside it (clipped, zero
elsewhere), and the partial embeddings are summed over the vocab axes'
process group — one activation all-reduce, no one-hot product.

Enabled by ``ArchConfig.sharded_embed_gather``.  Falls back to the plain
gather when no rules are active or no vocab axis divides the vocab, as the
reference does.  Every rank of the port holds the whole table (there is no
parameter sharding in the port), so the table enters through
``copy_to`` (its gradient summed over the group) and the partials leave
through ``reduce_from`` (all-reduce forward, identity backward): the
gradient each rank sees is the whole table's.
"""
from __future__ import annotations

import math

import torch

from repro_torch.distributed.sharding import active_rules, copy_to, reduce_from


def embedding_gather(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """(V, D) table, (...,) integer ids -> (..., D); vocab-parallel when the
    active sharding rules shard the vocab axis."""
    ids = ids.to(device=table.device, dtype=torch.long)
    rules = active_rules()
    if rules is None:
        return table[ids]
    shape = rules.shape
    vocab_axes = tuple(a for a in rules.mesh_axes_for("vocab") if table.shape[0] % shape[a] == 0)
    if not vocab_axes:
        return table[ids]
    n_shards = math.prod(shape[a] for a in vocab_axes)
    shard_v = table.shape[0] // n_shards
    group = rules.group(vocab_axes)
    lo = rules.axis_index(vocab_axes) * shard_v
    tbl = copy_to(table, group)[lo:lo + shard_v]
    rel = ids.reshape(-1) - lo
    hit = (rel >= 0) & (rel < shard_v)
    rel = torch.clamp(rel, 0, shard_v - 1)
    out = tbl[rel]
    out = torch.where(hit[:, None], out, torch.zeros((), dtype=out.dtype, device=out.device))
    out = reduce_from(out, group)
    return out.reshape(ids.shape + (table.shape[1],))
