"""Mixture-of-Experts FFN with capacity-based scatter dispatch.

Counterpart of ``repro/models/moe.py`` (phi3.5-moe: 16e top-2; olmoe: 64e
top-8).  Tokens are scattered into an (E, C, d) buffer, every expert runs
one grouped product over its C slots, and the results are gathered back and
combined with the renormalised gate weights.  Tokens beyond an expert's
capacity C = ceil(T * top_k / E * capacity_factor), rounded up to 8, are
dropped for that expert; the residual path carries them.  The router stays
fp32.

Two places where the obvious PyTorch call differs from the reference:

* ``jax.lax.top_k`` breaks ties toward the lower expert index, and
  ``torch.topk`` promises no order among ties: the port takes the first k
  of a stable descending sort, which keeps the lower index first.
* Dropped (token, k) pairs are routed to slot ``(E-1, C-1)`` with a zero
  source and combined with ``.at[].add``: the port accumulates
  (``index_put_(..., accumulate=True)``), so a dropped zero never
  overwrites that slot's real writer.

``moe_fwd_a2a`` is the expert-parallel path (the reference's ``shard_map``
+ ``all_to_all``): each rank of the ``"model"`` axis routes its share of
the tokens, sends them to the ranks that hold their experts with one
``all_to_all`` and takes the results back with another, all with autograd
(``distributed/sharding.py``'s collectives over process groups).

Under active rules the expert weights are this rank's part of their spec:
cut over ``"experts"`` where the mesh axis divides the expert count, else
over ``"mlp"``.  The dense ``moe_fwd`` then routes every token on every
rank (the normed tokens and the whole router enter through ``copy_to``),
runs the experts (or the hidden slice) it holds, and sums the combine over
the cut's group with ``reduce_from``.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed import sharding as SH
from repro_torch.models.layers import PSpec, dequantize_as, qeinsum, rmsnorm, rmsnorm_specs


def moe_specs(cfg: ArchConfig) -> dict:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    return {
        "norm": rmsnorm_specs(d),
        "router": PSpec((d, e), ("embed", None), dtype="float32"),
        "wi_gate": PSpec((e, d, f), ("experts", "embed", "mlp")),
        "wi_up": PSpec((e, d, f), ("experts", "embed", "mlp")),
        "wo": PSpec((e, f, d), ("experts", "mlp", "embed")),
    }


def capacity(n_tokens: int, cfg: ArchConfig) -> int:
    c = int(math.ceil(n_tokens * cfg.top_k / cfg.n_experts * cfg.capacity_factor))
    return max(8, -(-c // 8) * 8)  # round up to 8 for clean layouts


def top_k(probs: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k`` over the last axis: the k largest values, ties
    taken in ascending index order."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route(ht: torch.Tensor, router: torch.Tensor, cfg: ArchConfig):
    """Router logits (T, E) and the renormalised top-k gates and experts."""
    logits = torch.einsum("td,de->te", ht.to(torch.float32), router)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, gate_idx = top_k(probs, cfg.top_k)  # (T, k)
    gate_vals = gate_vals / _renorm_floor(gate_vals)
    return logits, gate_vals, gate_idx


def _renorm_floor(gv: torch.Tensor) -> torch.Tensor:
    """``jnp.maximum(gv.sum(-1, keepdims=True), 1e-9)``: ``torch.maximum``
    splits a tie's gradient as ``jnp.maximum`` does (``clamp_min`` would
    not)."""
    return torch.maximum(gv.sum(-1, keepdim=True),
                         torch.tensor(1e-9, dtype=gv.dtype, device=gv.device))


def moe_cuts(cfg: ArchConfig):
    """The cuts of the expert weights' ``"experts"`` and ``"mlp"``
    dimensions (at most one is cut: a mesh axis cuts one dimension)."""
    s = moe_specs(cfg)["wi_gate"]
    return SH.dim_cut(s.logical, s.shape, 0), SH.dim_cut(s.logical, s.shape, 2)


def _capacity_keep(flatoh, pos, gate_idx, t: int, cfg: ArchConfig):
    """``(cap, slots, keep)``: the capacity, the buffer's slots an expert
    and the kept (token, k) pairs.  With the batch split over several ranks
    (data parallel), the reference's capacity and positions are those of
    the global batch, whose rows hold the ranks' rows in rank order: the
    capacity is the global token count's, a pair's global position adds
    the counts of its expert on the ranks before (one all-gather of the
    per-expert counts), and the buffer keeps the local positions (at most
    ``min(t, cap)`` a expert)."""
    bc = SH.batch_cut()
    if bc is None:
        cap = capacity(t, cfg)
        return cap, cap, pos < cap
    cap = capacity(t * bc.size, cfg)
    counts = flatoh.sum(0, dtype=torch.int32).contiguous()
    every = [torch.empty_like(counts) for _ in range(bc.size)]
    dist.all_gather(every, counts, group=SH.group_of(bc))
    offset = torch.stack(every[:bc.index]).sum(0) if bc.index else torch.zeros_like(counts)
    return cap, min(cap, t), pos + offset[gate_idx] < cap


def moe_fwd(p, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """x: (B, S, D) -> (B, S, D) with residual."""
    b, s, d = x.shape
    ecut, fcut = moe_cuts(cfg)
    grp = SH.group_of(ecut or fcut)
    h = rmsnorm(p["norm"], x, cfg.norm_eps)
    t = b * s
    ht = SH.copy_to(h.reshape(t, d), grp)
    e, k = cfg.n_experts, cfg.top_k
    _, gate_vals, gate_idx = route(ht, SH.copy_to(p["router"], grp), cfg)

    # position of each (token, k) within its expert's capacity buffer
    flatoh = F.one_hot(gate_idx, e).to(torch.int32).reshape(t * k, e)
    pos_in_e = torch.cumsum(flatoh, dim=0, dtype=torch.int32) - flatoh  # exclusive rank
    pos = (pos_in_e * flatoh).sum(-1).reshape(t, k)  # (T, k)
    cap, slots, keep = _capacity_keep(flatoh, pos, gate_idx, t, cfg)
    # this rank's experts (all of them unless "experts" is cut)
    e_loc = e // ecut.size if ecut else e
    lo = ecut.index * e_loc if ecut else 0
    if ecut:
        keep = keep & (gate_idx >= lo) & (gate_idx < lo + e_loc)

    # scatter tokens into the (E, C, D) dispatch buffer
    e_flat = torch.where(keep, gate_idx - lo, e_loc - 1).reshape(-1)
    p_flat = torch.where(keep, pos, slots - 1).reshape(-1).to(torch.long)
    tok_idx = torch.arange(t, device=x.device).repeat_interleave(k)
    src = torch.where(keep.reshape(-1, 1), ht[tok_idx], torch.zeros((), dtype=ht.dtype,
                                                                       device=ht.device))
    buf = torch.zeros((e_loc, slots, d), dtype=h.dtype, device=x.device)
    buf.index_put_((e_flat, p_flat), src, accumulate=True)  # one real writer a slot

    # expert computation (grouped einsum)
    g = F.silu(qeinsum("ecd,edf->ecf", buf, p["wi_gate"]))
    u = qeinsum("ecd,edf->ecf", buf, p["wi_up"])
    eo = qeinsum("ecf,efd->ecd", g * u, p["wo"])

    # gather back and combine with gate weights
    out_tk = eo[e_flat, p_flat].reshape(t, k, d)
    out_tk = torch.where(keep[..., None], out_tk, torch.zeros((), dtype=out_tk.dtype,
                                                               device=x.device))
    out = SH.reduce_from((out_tk * gate_vals[..., None].to(out_tk.dtype)).sum(dim=1), grp)
    y = out.reshape(b, s, d).to(x.dtype)
    return x + y


def moe_fwd_a2a(p, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """Expert-parallel MoE: tokens split over the batch axes and
    ``"model"``, routed with ``all_to_all`` to the ranks that hold their
    experts and back.

    ``x`` is this rank's rows of the batch (every rank of the ``"model"``
    axis holds the same rows, and its ``e / n_ep`` resident experts: the
    expert weights are cut over ``"experts"``).  Rank
    ``r`` of ``"model"`` takes the ``r``-th of its rows' ``t_loc``-token
    slices, routes them with the reference's local capacity
    ``max(8, ceil8(t_loc * k / e * cf))``, packs a ``(n_ep, e_loc, cap,
    d)`` send buffer, runs its ``e_loc`` resident experts on what it
    receives, and reverses the route; the ranks' outputs are then gathered
    back into every rank's rows.  The replicated inputs (the normed tokens
    and the router) enter through ``copy_to``, so their gradients are
    summed over ``"model"`` as ``shard_map`` sums a replicated input's; a
    resident expert's gradient is whole on its rank.

    Falls back to ``moe_fwd`` as the reference does: no rules active, no
    ``"model"`` axis, ``e % n_ep``, or the global token count not divisible
    by the token shards.
    """
    rules = SH.active_rules()
    if rules is None or "model" not in rules.axis_names:
        return moe_fwd(p, x, cfg)
    shape = rules.shape
    n_ep = shape["model"]
    e, k = cfg.n_experts, cfg.top_k
    if e % n_ep != 0:
        return moe_fwd(p, x, cfg)
    b, s, d = x.shape
    batch_axes = rules.mesh_axes_for("batch")
    tok_axes = tuple(a for a in (*batch_axes, "model") if a in rules.axis_names)
    n_tok_shards = rules.size(tok_axes)
    t = b * s * rules.size(batch_axes)  # the global token count the reference sees
    if t % n_tok_shards != 0:
        return moe_fwd(p, x, cfg)
    t_loc = t // n_tok_shards
    cap = max(8, -(-int(t_loc * k / e * cfg.capacity_factor) // 8) * 8)
    e_loc = e // n_ep

    group = rules.group(("model",))
    r = rules.axis_index(("model",))
    h = rmsnorm(p["norm"], x, cfg.norm_eps)
    ht = SH.copy_to(h.reshape(b * s, d), group)[r * t_loc:(r + 1) * t_loc]
    router = SH.copy_to(p["router"], group)
    wi_g, wi_u, wo = (_deq(p[n]) for n in ("wi_gate", "wi_up", "wo"))  # resident experts

    logits = torch.einsum("td,de->te", ht.to(torch.float32), router)
    probs = torch.softmax(logits, dim=-1)
    gv, gi = top_k(probs, k)  # (t_loc, k)
    gv = gv / _renorm_floor(gv)
    oh = F.one_hot(gi, e).to(torch.int32).reshape(t_loc * k, e)
    pos = torch.cumsum(oh, dim=0, dtype=torch.int32) - oh
    pos = (pos * oh).sum(-1).reshape(t_loc, k)
    keep = pos < cap
    ef = torch.where(keep, gi, e - 1).reshape(-1)
    pf = torch.where(keep, pos, cap - 1).reshape(-1).to(torch.long)
    zero = torch.zeros((), dtype=ht.dtype, device=ht.device)
    src = torch.where(keep.reshape(-1, 1), ht[torch.arange(t_loc, device=ht.device)
                                             .repeat_interleave(k)], zero)
    send = torch.zeros((e, cap, d), dtype=ht.dtype, device=ht.device)
    send = send.index_put((ef, pf), src, accumulate=True)
    # route: (e, cap, d) -> (n_ep, e_loc, cap, d) -> all_to_all over model
    recv = SH.all_to_all(send.reshape(n_ep, e_loc, cap, d), group)
    # recv: (n_ep senders, e_loc, cap, d) for this rank's resident experts
    buf = recv.permute(1, 0, 2, 3).reshape(e_loc, n_ep * cap, d)  # slots = (sender, cap)
    g = F.silu(torch.einsum("ecd,edf->ecf", buf, wi_g))
    u = torch.einsum("ecd,edf->ecf", buf, wi_u)
    eo = torch.einsum("ecf,efd->ecd", g * u, wo)  # (e_loc, slots, d)
    back = eo.permute(1, 0, 2).reshape(n_ep, cap, e_loc, d).permute(0, 2, 1, 3)
    out = SH.all_to_all(back.contiguous(), group).reshape(e, cap, d)
    got = out[ef, pf].reshape(t_loc, k, d)
    got = torch.where(keep[..., None], got, zero.to(got.dtype))
    y = (got * gv[..., None].to(got.dtype)).sum(dim=1)
    y = SH.gather_from(y, group)  # every rank's t_loc tokens, in rank order
    return (x.reshape(b * s, d) + y.to(x.dtype)).reshape(b, s, d)


def _deq(w):
    """The reference's ``_deq``: an int8 ``QTensor`` as bf16, payload times
    scale; float weights as they are."""
    return dequantize_as(w, torch.bfloat16)


def moe_block(p, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """Dispatch on ``cfg.moe_impl``."""
    if cfg.moe_impl == "a2a":
        return moe_fwd_a2a(p, x, cfg)
    return moe_fwd(p, x, cfg)


def load_balance_loss(logits: torch.Tensor, gate_idx: torch.Tensor, n_experts: int) -> torch.Tensor:
    """Switch-style auxiliary load-balance loss (exposed for training)."""
    probs = torch.softmax(logits, dim=-1)
    me = probs.mean(dim=0)
    ce = torch.bincount(gate_idx.reshape(-1), minlength=n_experts).to(probs.dtype) / gate_idx.numel()
    return n_experts * torch.sum(me * ce)
