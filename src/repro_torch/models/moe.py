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

Only the ``"dense"`` implementation is ported; the expert-parallel
``"a2a"`` path (``shard_map`` + ``all_to_all``) belongs to the training
slice and raises here.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers import PSpec, qeinsum, rmsnorm, rmsnorm_specs


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
    gate_vals = gate_vals / torch.clamp_min(gate_vals.sum(-1, keepdim=True), 1e-9)
    return logits, gate_vals, gate_idx


def moe_fwd(p, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """x: (B, S, D) -> (B, S, D) with residual."""
    b, s, d = x.shape
    h = rmsnorm(p["norm"], x, cfg.norm_eps)
    t = b * s
    ht = h.reshape(t, d)
    e, k = cfg.n_experts, cfg.top_k
    cap = capacity(t, cfg)
    _, gate_vals, gate_idx = route(ht, p["router"], cfg)

    # position of each (token, k) within its expert's capacity buffer
    flatoh = F.one_hot(gate_idx, e).to(torch.int32).reshape(t * k, e)
    pos_in_e = torch.cumsum(flatoh, dim=0, dtype=torch.int32) - flatoh  # exclusive rank
    pos = (pos_in_e * flatoh).sum(-1).reshape(t, k)  # (T, k)
    keep = pos < cap  # capacity-dropped mask

    # scatter tokens into the (E, C, D) dispatch buffer
    e_flat = torch.where(keep, gate_idx, e - 1).reshape(-1)
    p_flat = torch.where(keep, pos, cap - 1).reshape(-1).to(torch.long)
    tok_idx = torch.arange(t, device=x.device).repeat_interleave(k)
    src = torch.where(keep.reshape(-1, 1), ht[tok_idx], torch.zeros((), dtype=ht.dtype,
                                                                       device=ht.device))
    buf = torch.zeros((e, cap, d), dtype=h.dtype, device=x.device)
    buf.index_put_((e_flat, p_flat), src, accumulate=True)  # one real writer a slot

    # expert computation (grouped einsum)
    g = F.silu(qeinsum("ecd,edf->ecf", buf, p["wi_gate"]))
    u = qeinsum("ecd,edf->ecf", buf, p["wi_up"])
    eo = qeinsum("ecf,efd->ecd", g * u, p["wo"])

    # gather back and combine with gate weights
    out_tk = eo[e_flat, p_flat].reshape(t, k, d)
    out_tk = torch.where(keep[..., None], out_tk, torch.zeros((), dtype=out_tk.dtype,
                                                               device=x.device))
    out = (out_tk * gate_vals[..., None].to(out_tk.dtype)).sum(dim=1)
    y = out.reshape(b, s, d).to(x.dtype)
    return x + y


def moe_block(p, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """Dispatch on ``cfg.moe_impl``."""
    if cfg.moe_impl == "a2a":
        raise NotImplementedError(
            "moe_impl='a2a' (expert-parallel all-to-all) is ported with the LM "
            "training slice; use moe_impl='dense'")
    return moe_fwd(p, x, cfg)


def load_balance_loss(logits: torch.Tensor, gate_idx: torch.Tensor, n_experts: int) -> torch.Tensor:
    """Switch-style auxiliary load-balance loss (exposed for training)."""
    probs = torch.softmax(logits, dim=-1)
    me = probs.mean(dim=0)
    ce = torch.bincount(gate_idx.reshape(-1), minlength=n_experts).to(probs.dtype) / gate_idx.numel()
    return n_experts * torch.sum(me * ce)
