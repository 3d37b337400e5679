"""Generic LM assembly: pattern-based blocks over layer-stacked parameters.

Counterpart of ``repro/models/transformer.py``.  One module drives all ten
assigned architectures.  An ``ArchConfig.pattern`` names the block kinds in
one repeating group; the depth is ``n_groups`` repetitions.  The group
parameters stay stacked with ``(n_groups, ...)`` leading, as the
reference's ``lax.scan`` takes them; the port runs one Python loop over the
groups, slicing group ``gi`` of every leaf (a ``QTensor``'s payload and its
scale alike), so ``stack_mode="scan"`` and ``"unroll"`` are the same loop.

The published hybrids' fields (``configs.base.HybridConfig``): the
embeddings times ``cfg.embed_mult`` and the logits over
``cfg.logits_div``, each a constant made once a device and no op at its
default; ``"mamba2_mlp"`` is a mamba2 mixer followed by an MLP.

Entry points:
  init_params(seed, cfg, device="cuda")         seeded params on the device
  forward(params, batch, cfg)                   full-seq logits (encoder too)
  forward_with_cache(params, batch, cfg, L)     prefill -> (last_logits, caches)
  decode_step(params, token, caches, pos, cfg, L)  single-token serve step
  loss_fn(params, batch, cfg)                   causal-LM / framewise cross entropy
  abstract_params / logical_axes                specs on the ``meta`` device, axis names
  cache_shapes / cache_logical_axes             a decode step's caches: shapes, axis names
  params_from_numpy / params_to_numpy           the weight carry between packages

``cfg.remat`` recomputes each pattern group in the backward pass
(``torch.utils.checkpoint``, the counterpart of the reference's
``jax.checkpoint(nothing_saveable)`` on its scan body): only the group's
input is kept; the recomputation runs the same ops on the same inputs, so
it changes no value.

Tensor parallelism.  Under active rules whose ``"vocab"`` axis is cut, the
embedding table (and ``lm_head``) is this rank's vocab part: the token
lookup is the masked, summed one (``distributed/embedding.py``), the
unembedding gives this rank's vocab part of the logits, ``loss_fn`` is a
vocab-parallel cross entropy (a max all-reduce, a sum-of-exp all-reduce and
the label's logit from its owning rank), and ``forward``,
``forward_with_cache`` and ``decode_step`` gather whole logits.  The
blocks cut themselves (``layers``, ``moe``, ``rwkv6``, ``mamba2``); the
layer-stacked leading axis is never cut, so group slicing is unchanged (a
``QTensor`` part keeps its whole scale and where it starts).  The decode
caches are this rank's (``cache_shapes``): attention caches cut along the
sequence where the rules cut it (``layers.cache_seq_cut``), recurrent
states on their heads (an RWKV or mamba2 block's cut), and every emitted
cache and state holds a decode's rows (``"decode_batch"``).
"""
from __future__ import annotations

import math
from typing import Any, Mapping, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.core.f32_math import const_f32
from repro_torch.core.quantization import QTensor
from repro_torch.distributed import sharding as SH
from repro_torch.distributed.embedding import embedding_gather
from repro_torch.kernels.backend import lm_span, resolve_device
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
    if kind == "mamba2_mlp":
        return {"mamba": M2.mamba2_specs(cfg), "mlp": L.mlp_specs(cfg)}
    if kind == "rwkv6":
        return {"rwkv": R6.rwkv6_specs(cfg)}
    raise ValueError(f"unknown block kind {kind!r}")


def _tok_spec(cfg: ArchConfig) -> PSpec:
    return PSpec((cfg.vocab, cfg.d_model), ("vocab", "embed"))


def _head_spec(cfg: ArchConfig) -> PSpec:
    return PSpec((cfg.d_model, cfg.vocab), ("embed", "vocab"))


def build_specs(cfg: ArchConfig) -> dict:
    d = cfg.d_model
    group = {f"pos{i}": _block_specs(k, cfg) for i, k in enumerate(cfg.pattern)}
    specs: dict = {
        "embed": {"tok": _tok_spec(cfg)},
        "groups": L.stack_specs(group, cfg.n_groups),
        "final_norm": L.rmsnorm_specs(d),
    }
    if "shared_attn" in cfg.pattern or "mamba2_shared" in cfg.pattern:
        specs["shared"] = {"attn": L.attn_specs(cfg), "mlp": L.mlp_specs(cfg)}
    if not cfg.tie_embeddings:
        specs["lm_head"] = _head_spec(cfg)
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
    return L.abstract_from_specs(build_specs(cfg), cfg)


def logical_axes(cfg: ArchConfig):
    """The params tree with each leaf's logical axis names."""
    return L.logical_from_specs(build_specs(cfg))


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
        t = _tok_spec(cfg)
        # a cut table takes the vocab-parallel lookup whatever
        # ``sharded_embed_gather`` says (its result is the plain gather's)
        tok = embedding_gather(table, batch["tokens"], SH.dim_cut(t.logical, t.shape, 0))
        if cfg.scale_embed:
            tok = tok * torch.tensor(np.sqrt(cfg.d_model), dtype=tok.dtype, device=tok.device)
        if cfg.embed_mult != 1.0:
            tok = tok * const_f32(cfg.embed_mult, tok)
        h = tok
        if cfg.frontend == "vision_patches" and "patches" in batch:  # prefill/train only
            f = params["frontend"]
            pe = L.rmsnorm(f["norm_in"], batch["patches"].to(tok.dtype), cfg.norm_eps)
            pe = L.gelu(L.qeinsum("bpf,fd->bpd", pe, f["proj1"]))
            pe = L.qeinsum("bpd,de->bpe", pe, f["proj2"])
            h = torch.cat([pe, tok], dim=1)
    return h.to(act)


def vocab_cut(cfg: ArchConfig) -> Optional[SH.Cut]:
    """The cut of the unembedding's vocab dimension, ``None`` where whole."""
    if cfg.tie_embeddings:
        return SH.dim_cut(_tok_spec(cfg).logical, _tok_spec(cfg).shape, 0)
    return SH.dim_cut(_head_spec(cfg).logical, _head_spec(cfg).shape, 1)


def unembed_local(params, h: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """fp32 logits over this rank's part of the vocab (:func:`vocab_cut`;
    all of it where whole)."""
    h = SH.copy_to(h, SH.group_of(vocab_cut(cfg)))
    if cfg.tie_embeddings:
        logits = L.qeinsum("bsd,vd->bsv", h, params["embed"]["tok"])
    else:
        logits = L.qeinsum("bsd,dv->bsv", h, params["lm_head"])
    logits = logits.to(torch.float32)
    if cfg.logits_div != 1.0:
        logits = logits / const_f32(cfg.logits_div, logits)
    return logits


def unembed(params, h: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """fp32 logits over the whole vocab."""
    return SH.gather_dim(unembed_local(params, h, cfg), vocab_cut(cfg), -1)


# ---------------------------------------------------------------------------
# block dispatch
# ---------------------------------------------------------------------------


def _window_for(kind: str, cfg: ArchConfig) -> Optional[int]:
    return cfg.window if kind == "local" else None


def _mlp(p, x, cfg: ArchConfig):
    with lm_span("mlp"):
        return L.mlp_fwd(p, x, cfg)


def block_fwd(kind, p, x, cfg: ArchConfig, shared, cache_len: Optional[int] = None):
    """Full-seq block.  Returns (x, cache_or_none); cache emitted only when
    ``cache_len`` is given (prefill).  Spans ``attn`` and ``mlp`` mark the
    attention and the MLP (``backend.lm_span``); mamba2 marks its own."""
    window = _window_for(kind, cfg)
    if kind in ("attn", "local", "moe", "shared_attn"):
        ap = shared["attn"] if kind == "shared_attn" else p["attn"]
        emit = None
        if cache_len is not None:
            emit = L.attn_cache_shape(cfg, x.shape[0], cache_len, window)
        with lm_span("attn"):
            x, cache = L.attn_fwd(ap, x, cfg, window=window, emit_cache=emit)
        if kind == "moe":
            x = MOE.moe_block(p["moe"], x, cfg)
        elif kind == "shared_attn":
            x = _mlp(shared["mlp"], x, cfg)
        else:
            x = _mlp(p["mlp"], x, cfg)
        return x, cache
    if kind in ("mamba2", "mamba2_mlp"):
        x, st = M2.mamba2_fwd(p["mamba"], x, cfg, emit_state=cache_len is not None)
        if kind == "mamba2_mlp":
            x = _mlp(p["mlp"], x, cfg)
        return x, _state_rows(st)
    if kind == "mamba2_shared":
        # zamba2: a mamba block followed by the *shared* attention+MLP block
        x, st = M2.mamba2_fwd(p["mamba"], x, cfg, emit_state=cache_len is not None)
        st = _state_rows(st)
        emit = None
        if cache_len is not None:
            emit = L.attn_cache_shape(cfg, x.shape[0], cache_len, None)
        with lm_span("attn"):
            x, kv = L.attn_fwd(shared["attn"], x, cfg, window=None, emit_cache=emit)
        x = _mlp(shared["mlp"], x, cfg)
        if cache_len is not None:
            return x, {"mamba": st, "attn": kv}
        return x, None
    if kind == "rwkv6":
        x, st = R6.rwkv6_fwd(p["rwkv"], x, cfg, emit_state=cache_len is not None)
        return x, _state_rows(st)
    raise ValueError(kind)


def _state_rows(state):
    """A prefill's emitted recurrent state (or ``None``) with the rows a
    decode cache holds (``sharding.to_cache_rows``)."""
    return None if state is None else L.tree_map(SH.to_cache_rows, state)


def block_decode(kind, p, x, cache, pos: int, cfg: ArchConfig, shared, max_seq: int):
    window = _window_for(kind, cfg)
    if kind in ("attn", "local", "moe", "shared_attn"):
        ap = shared["attn"] if kind == "shared_attn" else p["attn"]
        spec = L.attn_cache_shape(cfg, x.shape[0], max_seq, window)
        with lm_span("attn"):
            x, cache = L.attn_decode(ap, x, cache, pos, cfg, window=window, spec=spec)
        if kind == "moe":
            x = MOE.moe_block(p["moe"], x, cfg)
        elif kind == "shared_attn":
            x = _mlp(shared["mlp"], x, cfg)
        else:
            x = _mlp(p["mlp"], x, cfg)
        return x, cache
    if kind == "mamba2":
        return M2.mamba2_decode(p["mamba"], x, cache, cfg)
    if kind == "mamba2_mlp":
        x, st = M2.mamba2_decode(p["mamba"], x, cache, cfg)
        return _mlp(p["mlp"], x, cfg), st
    if kind == "mamba2_shared":
        x, st = M2.mamba2_decode(p["mamba"], x, cache["mamba"], cfg)
        spec = L.attn_cache_shape(cfg, x.shape[0], max_seq, None)
        with lm_span("attn"):
            x, kv = L.attn_decode(shared["attn"], x, cache["attn"], pos, cfg, window=None,
                                  spec=spec)
        x = _mlp(shared["mlp"], x, cfg)
        return x, {"mamba": st, "attn": kv}
    if kind == "rwkv6":
        return R6.rwkv6_decode(p["rwkv"], x, cache, cfg)
    raise ValueError(kind)


# ---------------------------------------------------------------------------
# stacked execution: one loop over the groups
# ---------------------------------------------------------------------------


def _group(tree: Any, gi: int) -> Any:
    """Group ``gi`` of a layer-stacked tree (``QTensor``: payload and scale,
    and where a rank's part of the payload starts; the layer axis is never
    cut)."""
    def take(t):
        if isinstance(t, QTensor):
            return QTensor(t.q[gi], t.scale[gi], t.axis,
                           None if t.start is None else t.start[1:])
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
    group_fwd = _group_fwd(cfg, shared, cache_len)
    rules = SH.active_rules()

    def body(gp, x):
        # remat recomputes the group in the backward, which autograd may run
        # on another thread (a CUDA device's): the rules go with it
        with SH.use_rules(rules):
            return group_fwd(gp, x)

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


def copy_into(dst: Any, src: Any) -> None:
    """Copy a tree of tensors into a tree of the same structure."""
    if isinstance(dst, Mapping):
        for k in dst:
            copy_into(dst[k], src[k])
    else:
        dst.copy_(src)


def run_stack_decode(params, x, caches, pos, cfg: ArchConfig, max_seq: int, out=None):
    """``out``, where given, is a cache tree that each layer's new caches are
    copied into as the layer ends (in place of the stack at the end)."""
    shared = params.get("shared")
    ncs = []
    for gi in range(cfg.n_groups):
        gp, gc = _group(params["groups"], gi), _group(caches, gi)
        go = None if out is None else _group(out, gi)
        new_caches = {}
        for i, kind in enumerate(cfg.pattern):
            x, c = block_decode(kind, gp[f"pos{i}"], x, gc[f"pos{i}"], pos, cfg, shared,
                                max_seq)
            if go is None:
                new_caches[f"pos{i}"] = c
            else:
                copy_into(go[f"pos{i}"], c)
        ncs.append(new_caches)
    return x, (_stack(ncs) if out is None else out)


# ---------------------------------------------------------------------------
# public entry points
# ---------------------------------------------------------------------------


def _hidden(params, batch: dict, cfg: ArchConfig, last_only: bool) -> torch.Tensor:
    h = embed_fwd(params, batch, cfg)
    h, _ = run_stack(params, h, cfg)
    h = L.rmsnorm(params["final_norm"], h, cfg.norm_eps)
    if last_only:
        h = h[:, -1:]
    return h


def forward(params, batch: dict, cfg: ArchConfig, *, last_only: bool = False) -> torch.Tensor:
    return unembed(params, _hidden(params, batch, cfg, last_only), cfg)


def forward_with_cache(params, batch: dict, cfg: ArchConfig, max_seq: int):
    """Prefill: returns (last-token logits, caches sized for max_seq decode)."""
    h = embed_fwd(params, batch, cfg)
    h, caches = run_stack(params, h, cfg, cache_len=max_seq)
    h = L.rmsnorm(params["final_norm"], h[:, -1:], cfg.norm_eps)
    return unembed(params, h, cfg), caches


def decode_step(params, token: torch.Tensor, caches, pos, cfg: ArchConfig, max_seq: int,
                out=None):
    """One serve step: token (B, 1) int, absolute position ``pos`` (an int,
    or a 0-d int64 tensor on the device: see :func:`decode_graphable`);
    returns (logits (B, 1, V), new caches).  The caches passed in are not
    changed.  ``out``, where given, is a cache tree of the caches' shapes
    that the new caches are written into and returned as."""
    h = embed_fwd(params, {"tokens": token}, cfg)
    pos = pos if isinstance(pos, torch.Tensor) else int(pos)
    h, new_caches = run_stack_decode(params, h, caches, pos, cfg, max_seq, out)
    h = L.rmsnorm(params["final_norm"], h, cfg.norm_eps)
    return unembed(params, h, cfg), new_caches


def decode_graphable(cfg: ArchConfig, params) -> bool:
    """Whether :func:`decode_step` can take its position as a tensor on the
    device, and so be captured once into a CUDA graph that replays at any
    position: a step that reads the position only in device ops and makes
    no constant on the host.  Attention, rotary or not (RoPE's frequencies
    and the scores' divisor are kept a device), over whole linear caches
    (no ``"local"`` ring caches), Mamba2 mixers, token embeddings not
    scaled by ``sqrt(d)`` (a host-made constant), plain weights (no int8
    ``QTensor``) and no sharding rules."""
    return (not cfg.scale_embed and cfg.frontend is None
            and set(cfg.pattern) <= {"attn", "mamba2", "mamba2_mlp"}
            and SH.active_rules() is None
            and not any(isinstance(t, QTensor) for t in L.tree_leaves(params)))


def cache_shapes(cfg: ArchConfig, batch: int, max_seq: int):
    """``(shape, dtype)`` of every cache tensor a decode step takes, layer
    axis leading (the reference's abstract cache tree).  Under active
    rules, this rank's: the kv heads where they are cut, the sequence
    where it is cut (``layers.cache_seq_cut``), an RWKV state's heads where
    its time mix is cut, and a mamba2 state's parts as its logical axes cut
    them (``mamba2.state_cuts``: ``conv`` on ``d_in``, ``ssm`` on the
    heads); ``batch`` is the rows the caller holds."""
    act = L.torch_dtype(cfg.act_dtype)
    kvc = L.attn_cuts(cfg)[1]
    kvh = cfg.n_kv_heads // (kvc.size if kvc else 1)

    def kv_shape(window):
        length = L.attn_cache_shape(cfg, batch, max_seq, window).length
        seq = L.cache_seq_cut(cfg, length)
        return (batch, length // (seq.size if seq else 1), kvh, cfg.head_dim)

    group = {}
    for i, kind in enumerate(cfg.pattern):
        window = _window_for(kind, cfg)
        if kind in ("attn", "local", "moe", "shared_attn"):
            shp = kv_shape(window)
            group[f"pos{i}"] = {"k": (shp, act), "v": (shp, act)}
        elif kind in ("mamba2", "mamba2_mlp"):
            group[f"pos{i}"] = M2.mamba2_state_shapes(cfg, batch)
        elif kind == "mamba2_shared":
            shp = kv_shape(None)
            group[f"pos{i}"] = {
                "mamba": M2.mamba2_state_shapes(cfg, batch),
                "attn": {"k": (shp, act), "v": (shp, act)},
            }
        elif kind == "rwkv6":
            group[f"pos{i}"] = R6.rwkv6_state_shapes(cfg, batch)
    return L.tree_map(lambda s: ((cfg.n_groups,) + s[0], s[1]), group)


def cache_logical_axes(cfg: ArchConfig, seq_axis: str = "kv_seq"):
    """Logical axes mirroring :func:`cache_shapes`.  ``seq_axis`` is
    ``"kv_seq_model"`` when the kv heads cannot shard over the model axis
    (the launcher decides by divisibility)."""
    kv = ("layers", "decode_batch", seq_axis, "kv_heads", "head_dim")
    mamba = M2.state_axes(cfg)
    group = {}
    for i, kind in enumerate(cfg.pattern):
        if kind in ("attn", "local", "moe", "shared_attn"):
            group[f"pos{i}"] = {"k": kv, "v": kv}
        elif kind in ("mamba2", "mamba2_mlp"):
            group[f"pos{i}"] = dict(mamba)
        elif kind == "mamba2_shared":
            group[f"pos{i}"] = {"mamba": dict(mamba), "attn": {"k": kv, "v": kv}}
        elif kind == "rwkv6":
            group[f"pos{i}"] = {
                "tm_shift": ("layers", "decode_batch", None, "embed"),
                "wkv": ("layers", "decode_batch", "heads", "head_dim", None),
                "cm_shift": ("layers", "decode_batch", None, "embed"),
            }
    return group


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
    logits = unembed_local(params, _hidden(params, batch, cfg, False), cfg)
    labels = batch["labels"].to(device=logits.device, dtype=torch.long)
    if cfg.frontend == "vision_patches":
        logits = logits[:, -labels.shape[1]:]  # loss over the text positions
    mask = labels >= 0
    labels_safe = torch.clamp_min(labels, 0)
    cut = vocab_cut(cfg)
    if cut is None:
        logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
        ll = torch.gather(logp, -1, labels_safe[..., None])[..., 0]
    else:
        ll = _vocab_parallel_ll(logits.to(torch.float32), labels_safe, cut)
    if count is None:
        count = mask.sum()
    return -(ll * mask).sum() / torch.clamp_min(count, 1).to(torch.float32)


def _vocab_parallel_ll(logits: torch.Tensor, labels: torch.Tensor, cut: SH.Cut) -> torch.Tensor:
    """log p(label) from this rank's vocab part of the logits: the rows'
    max all-reduced (a constant shift: no gradient), their sums of exp
    all-reduced, and each label's logit taken on the rank that holds it
    and all-reduced (``reduce_from``: the backward is an identity, each
    rank keeping its part's gradient)."""
    group = SH.group_of(cut)
    m = logits.detach().amax(dim=-1, keepdim=True)
    dist.all_reduce(m, op=dist.ReduceOp.MAX, group=group)
    se = SH.reduce_from(torch.exp(logits - m).sum(dim=-1), group)
    n = logits.shape[-1]
    rel = labels - cut.index * n
    hit = (rel >= 0) & (rel < n)
    picked = torch.gather(logits, -1, torch.clamp(rel, 0, n - 1)[..., None])[..., 0]
    picked = SH.reduce_from(torch.where(hit, picked, torch.zeros((), dtype=picked.dtype,
                                                                  device=picked.device)),
                            group)
    return picked - m[..., 0] - torch.log(se)
