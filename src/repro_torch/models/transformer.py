"""Generic LM assembly: pattern-based blocks over layer-stacked parameters.

Counterpart of ``repro/models/transformer.py``.  One module drives all ten
assigned architectures.  An ``ArchConfig.pattern`` names the block kinds in
one repeating group; the depth is ``n_groups`` repetitions.  The group
parameters stay stacked with ``(n_groups, ...)`` leading, as the
reference's ``lax.scan`` takes them; the port runs one Python loop over the
groups, slicing group ``gi`` of every leaf (a ``QTensor``'s payload and its
scale alike), so ``stack_mode="scan"`` and ``"unroll"`` are the same loop.

Entry points:
  init_params(seed, cfg, device="cuda")         seeded params on the device
  forward(params, batch, cfg)                   full-seq logits (encoder too)
  forward_with_cache(params, batch, cfg, L)     prefill -> (last_logits, caches)
  decode_step(params, token, caches, pos, cfg, L)  single-token serve step
  loss_fn(params, batch, cfg)                   causal-LM / framewise cross entropy
  abstract_params / logical_axes                specs on the ``meta`` device, axis names
  params_from_numpy / params_to_numpy           the weight carry between packages

``cfg.remat`` recomputes each pattern group in the backward pass
(``torch.utils.checkpoint``, the counterpart of the reference's
``jax.checkpoint(nothing_saveable)`` on its scan body): only the group's
input is kept; the recomputation runs the same ops on the same inputs, so
it changes no value.
"""
from __future__ import annotations

import math
from typing import Any, Mapping, Optional

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.core.quantization import QTensor
from repro_torch.distributed.embedding import embedding_gather
from repro_torch.kernels.backend import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import mamba2 as M2
from repro_torch.models import moe as MOE
from repro_torch.models import rwkv6 as R6
from repro_torch.models.layers import PSpec


# ---------------------------------------------------------------------------
# parameter specs
# ---------------------------------------------------------------------------


def _block_specs(kind: str, cfg: ArchConfig) -> dict:
    if kind in ("attn", "local"):
        return {"attn": L.attn_specs(cfg), "mlp": L.mlp_specs(cfg)}
    if kind == "moe":
        return {"attn": L.attn_specs(cfg), "moe": MOE.moe_specs(cfg)}
    if kind == "shared_attn":
        return {}  # weights live in params["shared"]
    if kind in ("mamba2", "mamba2_shared"):
        return {"mamba": M2.mamba2_specs(cfg)}
    if kind == "rwkv6":
        return {"rwkv": R6.rwkv6_specs(cfg)}
    raise ValueError(f"unknown block kind {kind!r}")


def build_specs(cfg: ArchConfig) -> dict:
    d = cfg.d_model
    group = {f"pos{i}": _block_specs(k, cfg) for i, k in enumerate(cfg.pattern)}
    specs: dict = {
        "embed": {"tok": PSpec((cfg.vocab, d), ("vocab", "embed"))},
        "groups": L.stack_specs(group, cfg.n_groups),
        "final_norm": L.rmsnorm_specs(d),
    }
    if "shared_attn" in cfg.pattern or "mamba2_shared" in cfg.pattern:
        specs["shared"] = {"attn": L.attn_specs(cfg), "mlp": L.mlp_specs(cfg)}
    if not cfg.tie_embeddings:
        specs["lm_head"] = PSpec((d, cfg.vocab), ("embed", "vocab"))
    if cfg.frontend == "audio_frames":
        specs["frontend"] = {
            "proj": PSpec((cfg.frontend_dim, d), ("frontend", "embed")),
            "norm": L.rmsnorm_specs(d),
        }
    elif cfg.frontend == "vision_patches":
        specs["frontend"] = {
            "norm_in": L.rmsnorm_specs(cfg.frontend_dim),
            "proj1": PSpec((cfg.frontend_dim, d), ("frontend", "embed")),
            "proj2": PSpec((d, d), ("embed", "embed")),
        }
    return specs


def init_params(seed: int, cfg: ArchConfig, *, device="cuda"):
    """Seeded params (``torch.Generator(device).manual_seed(seed)``) on
    ``device``; the reference takes a ``jax.random`` key in ``seed``'s
    place.  Raises without a GPU unless ``device="cpu"``."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return L.init_from_specs(gen, build_specs(cfg), cfg)


def abstract_params(cfg: ArchConfig):
    """The params tree as tensors on the ``meta`` device: shapes and dtypes,
    nothing allocated (the reference's ``ShapeDtypeStruct`` tree)."""
    return L.tree_map(
        lambda s: torch.empty(s.shape, dtype=L.torch_dtype(s.dtype or cfg.param_dtype),
                              device="meta"),
        build_specs(cfg))


def logical_axes(cfg: ArchConfig):
    """The params tree with each leaf's logical axis names."""
    return L.tree_map(lambda s: s.logical, build_specs(cfg))


def param_count(cfg: ArchConfig) -> int:
    """Parameters of ``cfg``, from its specs (nothing is allocated)."""
    return sum(math.prod(s.shape) for s in L.tree_leaves(build_specs(cfg)))


def active_param_count(cfg: ArchConfig) -> int:
    """Params touched per token (MoE: top_k of n_experts)."""
    n = param_count(cfg)
    if cfg.n_experts and cfg.top_k:
        specs = build_specs(cfg)
        e_params = 0
        for sub in _find_subtrees(specs["groups"], "moe"):
            for name in ("wi_gate", "wi_up", "wo"):
                e_params += math.prod(sub[name].shape)
        n -= int(e_params * (1 - cfg.top_k / cfg.n_experts))
    return n


def _find_subtrees(tree, key):
    out = []
    if isinstance(tree, dict):
        for k, v in tree.items():
            if k == key and isinstance(v, dict):
                out.append(v)
            elif isinstance(v, dict):
                out.extend(_find_subtrees(v, key))
    return out


# ---------------------------------------------------------------------------
# the weight carry
# ---------------------------------------------------------------------------


def params_from_numpy(tree: Mapping, cfg: ArchConfig) -> dict:
    """The port's params, on the host, from a numpy tree of the same layout
    (the reference's params through ``jax.tree.map(np.asarray, ...)``, float
    leaves of any float dtype): each float leaf is cast to its spec's dtype,
    and a ``QTensor`` leaf travels as a tuple ``(q, scale, axis)``.
    :func:`params_to` moves the result to a device."""
    def walk(a, spec):
        if isinstance(a, Mapping):
            return {k: walk(v, spec[k]) for k, v in a.items()}
        if isinstance(a, tuple):
            q, scale, axis = a
            return QTensor(torch.from_numpy(np.array(q, np.int8)),
                           torch.from_numpy(np.array(scale, np.float32)), axis)
        t = torch.from_numpy(np.array(a, np.float32))
        return t.to(dtype=L.torch_dtype(spec.dtype or cfg.param_dtype))

    return walk(tree, build_specs(cfg))


def params_to_numpy(params: Mapping) -> dict:
    """The reverse of :func:`params_from_numpy`: float leaves as float32
    numpy arrays (bf16 widens exactly), ``QTensor`` leaves as
    ``(q, scale, axis)``."""
    def leaf(t):
        if isinstance(t, QTensor):
            return (t.q.cpu().numpy(), t.scale.cpu().numpy(), t.axis)
        return t.detach().to(torch.float32).cpu().numpy()

    return L.tree_map(leaf, params)


def params_to(params: Mapping, device) -> dict:
    """The params tree with every tensor on ``device``."""
    return L.tree_map(lambda t: t.to(device), params)


# ---------------------------------------------------------------------------
# embedding / frontend
# ---------------------------------------------------------------------------


def embed_fwd(params, batch: dict, cfg: ArchConfig) -> torch.Tensor:
    act = L.torch_dtype(cfg.act_dtype)
    if cfg.frontend == "audio_frames":
        h = L.qeinsum("bsf,fd->bsd", batch["frames"].to(act), params["frontend"]["proj"])
        h = L.rmsnorm(params["frontend"]["norm"], h, cfg.norm_eps)
    else:
        table = params["embed"]["tok"]
        if cfg.sharded_embed_gather:
            tok = embedding_gather(table, batch["tokens"])
        else:
            tok = table[batch["tokens"].to(device=table.device, dtype=torch.long)]
        if cfg.scale_embed:
            tok = tok * torch.tensor(np.sqrt(cfg.d_model), dtype=tok.dtype, device=tok.device)
        h = tok
        if cfg.frontend == "vision_patches" and "patches" in batch:  # prefill/train only
            f = params["frontend"]
            pe = L.rmsnorm(f["norm_in"], batch["patches"].to(tok.dtype), cfg.norm_eps)
            pe = L.gelu(L.qeinsum("bpf,fd->bpd", pe, f["proj1"]))
            pe = L.qeinsum("bpd,de->bpe", pe, f["proj2"])
            h = torch.cat([pe, tok], dim=1)
    return h.to(act)


def unembed(params, h: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    if cfg.tie_embeddings:
        logits = L.qeinsum("bsd,vd->bsv", h, params["embed"]["tok"])
    else:
        logits = L.qeinsum("bsd,dv->bsv", h, params["lm_head"])
    return logits.to(torch.float32)


# ---------------------------------------------------------------------------
# block dispatch
# ---------------------------------------------------------------------------


def _window_for(kind: str, cfg: ArchConfig) -> Optional[int]:
    return cfg.window if kind == "local" else None


def block_fwd(kind, p, x, cfg: ArchConfig, shared, cache_len: Optional[int] = None):
    """Full-seq block.  Returns (x, cache_or_none); cache emitted only when
    ``cache_len`` is given (prefill)."""
    window = _window_for(kind, cfg)
    if kind in ("attn", "local", "moe", "shared_attn"):
        ap = shared["attn"] if kind == "shared_attn" else p["attn"]
        emit = None
        if cache_len is not None:
            emit = L.attn_cache_shape(cfg, x.shape[0], cache_len, window)
        x, cache = L.attn_fwd(ap, x, cfg, window=window, emit_cache=emit)
        if kind == "moe":
            x = MOE.moe_block(p["moe"], x, cfg)
        elif kind == "shared_attn":
            x = L.mlp_fwd(shared["mlp"], x, cfg)
        else:
            x = L.mlp_fwd(p["mlp"], x, cfg)
        return x, cache
    if kind == "mamba2":
        return M2.mamba2_fwd(p["mamba"], x, cfg, emit_state=cache_len is not None)
    if kind == "mamba2_shared":
        # zamba2: a mamba block followed by the *shared* attention+MLP block
        x, st = M2.mamba2_fwd(p["mamba"], x, cfg, emit_state=cache_len is not None)
        emit = None
        if cache_len is not None:
            emit = L.attn_cache_shape(cfg, x.shape[0], cache_len, None)
        x, kv = L.attn_fwd(shared["attn"], x, cfg, window=None, emit_cache=emit)
        x = L.mlp_fwd(shared["mlp"], x, cfg)
        if cache_len is not None:
            return x, {"mamba": st, "attn": kv}
        return x, None
    if kind == "rwkv6":
        return R6.rwkv6_fwd(p["rwkv"], x, cfg, emit_state=cache_len is not None)
    raise ValueError(kind)


def block_decode(kind, p, x, cache, pos: int, cfg: ArchConfig, shared, max_seq: int):
    window = _window_for(kind, cfg)
    if kind in ("attn", "local", "moe", "shared_attn"):
        ap = shared["attn"] if kind == "shared_attn" else p["attn"]
        spec = L.attn_cache_shape(cfg, x.shape[0], max_seq, window)
        x, cache = L.attn_decode(ap, x, cache, pos, cfg, window=window, spec=spec)
        if kind == "moe":
            x = MOE.moe_block(p["moe"], x, cfg)
        elif kind == "shared_attn":
            x = L.mlp_fwd(shared["mlp"], x, cfg)
        else:
            x = L.mlp_fwd(p["mlp"], x, cfg)
        return x, cache
    if kind == "mamba2":
        return M2.mamba2_decode(p["mamba"], x, cache, cfg)
    if kind == "mamba2_shared":
        x, st = M2.mamba2_decode(p["mamba"], x, cache["mamba"], cfg)
        spec = L.attn_cache_shape(cfg, x.shape[0], max_seq, None)
        x, kv = L.attn_decode(shared["attn"], x, cache["attn"], pos, cfg, window=None, spec=spec)
        x = L.mlp_fwd(shared["mlp"], x, cfg)
        return x, {"mamba": st, "attn": kv}
    if kind == "rwkv6":
        return R6.rwkv6_decode(p["rwkv"], x, cache, cfg)
    raise ValueError(kind)


# ---------------------------------------------------------------------------
# stacked execution: one loop over the groups
# ---------------------------------------------------------------------------


def _group(tree: Any, gi: int) -> Any:
    """Group ``gi`` of a layer-stacked tree (``QTensor``: payload and scale)."""
    def take(t):
        if isinstance(t, QTensor):
            return QTensor(t.q[gi], t.scale[gi], t.axis)
        return t[gi]

    return L.tree_map(take, tree)


def _stack(trees: list) -> Any:
    """Stack a list of same-structure trees along a new leading axis."""
    first = trees[0]
    if isinstance(first, Mapping):
        return {k: _stack([t[k] for t in trees]) for k in first}
    return torch.stack(trees)


def _group_fwd(cfg: ArchConfig, shared, cache_len):
    def body(gp, x):
        caches = {}
        for i, kind in enumerate(cfg.pattern):
            x, c = block_fwd(kind, gp[f"pos{i}"], x, cfg, shared, cache_len)
            if cache_len is not None:
                caches[f"pos{i}"] = c if c is not None else {}
        return x, caches

    return body


def run_stack(params, x, cfg: ArchConfig, cache_len: Optional[int] = None):
    shared = params.get("shared")
    body = _group_fwd(cfg, shared, cache_len)
    remat = cfg.remat and cache_len is None and torch.is_grad_enabled()
    caches_list = []
    for gi in range(cfg.n_groups):
        gp = _group(params["groups"], gi)
        if remat:
            x, caches = checkpoint(body, gp, x, use_reentrant=False)
        else:
            x, caches = body(gp, x)
        caches_list.append(caches)
    return x, (_stack(caches_list) if cache_len is not None else None)


def run_stack_decode(params, x, caches, pos: int, cfg: ArchConfig, max_seq: int):
    shared = params.get("shared")
    ncs = []
    for gi in range(cfg.n_groups):
        gp, gc = _group(params["groups"], gi), _group(caches, gi)
        new_caches = {}
        for i, kind in enumerate(cfg.pattern):
            x, c = block_decode(kind, gp[f"pos{i}"], x, gc[f"pos{i}"], pos, cfg, shared,
                                max_seq)
            new_caches[f"pos{i}"] = c
        ncs.append(new_caches)
    return x, _stack(ncs)


# ---------------------------------------------------------------------------
# public entry points
# ---------------------------------------------------------------------------


def forward(params, batch: dict, cfg: ArchConfig, *, last_only: bool = False) -> torch.Tensor:
    h = embed_fwd(params, batch, cfg)
    h, _ = run_stack(params, h, cfg)
    h = L.rmsnorm(params["final_norm"], h, cfg.norm_eps)
    if last_only:
        h = h[:, -1:]
    return unembed(params, h, cfg)


def forward_with_cache(params, batch: dict, cfg: ArchConfig, max_seq: int):
    """Prefill: returns (last-token logits, caches sized for max_seq decode)."""
    h = embed_fwd(params, batch, cfg)
    h, caches = run_stack(params, h, cfg, cache_len=max_seq)
    h = L.rmsnorm(params["final_norm"], h[:, -1:], cfg.norm_eps)
    return unembed(params, h, cfg), caches


def decode_step(params, token: torch.Tensor, caches, pos: int, cfg: ArchConfig, max_seq: int):
    """One serve step: token (B, 1) int, absolute position ``pos``; returns
    (logits (B, 1, V), new caches).  The caches passed in are not changed."""
    h = embed_fwd(params, {"tokens": token}, cfg)
    h, new_caches = run_stack_decode(params, h, caches, int(pos), cfg, max_seq)
    h = L.rmsnorm(params["final_norm"], h, cfg.norm_eps)
    return unembed(params, h, cfg), new_caches


def cache_shapes(cfg: ArchConfig, batch: int, max_seq: int):
    """``(shape, dtype)`` of every cache tensor a decode step takes, layer
    axis leading (the reference's abstract cache tree)."""
    act = L.torch_dtype(cfg.act_dtype)
    group = {}
    for i, kind in enumerate(cfg.pattern):
        window = _window_for(kind, cfg)
        if kind in ("attn", "local", "moe", "shared_attn"):
            spec = L.attn_cache_shape(cfg, batch, max_seq, window)
            shp = (batch, spec.length, cfg.n_kv_heads, cfg.head_dim)
            group[f"pos{i}"] = {"k": (shp, act), "v": (shp, act)}
        elif kind == "mamba2":
            group[f"pos{i}"] = M2.mamba2_state_shapes(cfg, batch)
        elif kind == "mamba2_shared":
            spec = L.attn_cache_shape(cfg, batch, max_seq, None)
            shp = (batch, spec.length, cfg.n_kv_heads, cfg.head_dim)
            group[f"pos{i}"] = {
                "mamba": M2.mamba2_state_shapes(cfg, batch),
                "attn": {"k": (shp, act), "v": (shp, act)},
            }
        elif kind == "rwkv6":
            group[f"pos{i}"] = R6.rwkv6_state_shapes(cfg, batch)
    return L.tree_map(lambda s: ((cfg.n_groups,) + s[0], s[1]), group)


# ---------------------------------------------------------------------------
# loss
# ---------------------------------------------------------------------------


def loss_fn(params, batch: dict, cfg: ArchConfig, *,
            count: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Causal-LM (or framewise, for encoders) cross entropy.  Labels of -1
    are masked; for ``vision_patches`` the loss runs over the text
    positions.  ``count``, when given, replaces the number of unmasked
    labels as the divisor: a rank holding part of a global batch divides
    its sum by the global count, so the ranks' losses (and gradients) add
    up to the whole batch's."""
    logits = forward(params, batch, cfg)
    labels = batch["labels"].to(device=logits.device, dtype=torch.long)
    if cfg.frontend == "vision_patches":
        logits = logits[:, -labels.shape[1]:]  # loss over the text positions
    mask = labels >= 0
    labels_safe = torch.clamp_min(labels, 0)
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    ll = torch.gather(logp, -1, labels_safe[..., None])[..., 0]
    if count is None:
        count = mask.sum()
    return -(ll * mask).sum() / torch.clamp_min(count, 1).to(torch.float32)
