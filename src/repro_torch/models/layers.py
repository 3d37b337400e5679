"""Shared LM building blocks: param specs, norms, RoPE, attention, MLPs.

Counterpart of ``repro/models/layers.py``.

Conventions
-----------
* Params are nested dicts of tensors.  Every layer declares its parameters
  as ``PSpec`` (shape + logical axes + init), from which real init and the
  parameter count derive without allocating anything.
* ``qeinsum`` is the precision-aware matmul: weights may be ``QTensor``
  (int8 + scale) per the precision policy.  It is weight-only: the int8
  payload is dequantised into the activation dtype and the product is a
  plain ``torch.einsum``, as the reference leaves it to ``jnp.einsum``.
* Attention supports GQA/MQA, RoPE, causal + sliding-window masks, dense or
  KV-chunked (online-softmax) computation, prefill cache emission, and
  single-token decode against linear or ring (windowed) caches.

Where the reference places a dtype cast, the port casts in the same place
(RoPE's cos/sin to ``x.dtype`` before the multiply, attention weights to
``q.dtype`` after an fp32 softmax, ``rmsnorm`` in fp32 and back), so bf16
rounds at the same points; the products themselves come from another BLAS
and agree within a tolerance, not bitwise.  ``jax.nn.gelu`` is the tanh
approximation, so every GELU here is ``approximate="tanh"``.  The
reference's sharding annotations (``constrain``, ``kv_seq_axis``) are
left out: the port places tensors by process group, and
``distributed/sharding.constrain`` is an identity.

Tensor parallelism (Megatron-style, cut by the specs alone).  Under
active rules a leaf is this rank's part of its spec (``sharding.dim_cut``
says which dimensions are cut).  Attention: ``wq``/``wo`` cut over
``"heads"`` and ``wk``/``wv`` over ``"kv_heads"``; the normed input enters
through ``copy_to`` and ``wo``'s partial product leaves through
``reduce_from``.  Where the heads are cut and the kv heads are not
(GQA/MQA with few kv heads), ``wk``/``wv`` are whole: they enter through
``copy_to`` (each rank reads only its query heads' kv heads), k and v are
computed whole, and each local query head reads the kv head of its
*global* index.  Where the heads are not cut the block runs whole, with no
collective.  The MLP: ``wi*`` column-parallel over ``"mlp"``, ``wo``
row-parallel, ``copy_to`` in and ``reduce_from`` out.

Decode caches follow the reference's rules: a cache's logical axes are
``("layers", "decode_batch", kv_seq_axis(n_kv), "kv_heads", "head_dim")``
and :func:`cache_seq_cut` reads its sequence's cut from them (over
``"model"`` where the kv heads do not divide the model axis; the
long-context rules cut over ``"data"`` too).  The prefill builds the whole
padded or rolled cache, with the rows a decode holds
(``sharding.to_cache_rows``), and keeps this rank's slots.  The decode
(:func:`attn_decode`) is then ring-decode attention: the rank owning the
token's global slot writes its k and v, every rank scores its own slots
(validity from the global slot index) with every query head it needs (all
of them, gathered over the heads' group, where the heads are cut over
whole kv heads), and the ranks of the sequence's group combine their fp32
partial max, sum and value accumulator; this rank's heads of the result
go into ``wo``.  A cache whose sequence is whole decodes as before.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Mapping, NamedTuple, Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.core.quantization import QTensor
from repro_torch.distributed import sharding as SH

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class PSpec(NamedTuple):
    shape: tuple[int, ...]
    logical: tuple[Optional[str], ...]
    init: str = "normal"  # normal | zeros | ones
    dtype: Optional[str] = None  # override cfg.param_dtype


def torch_dtype(name: str) -> torch.dtype:
    return DTYPES[name]


def tree_map(fn: Callable, tree: Any) -> Any:
    """``fn`` over the leaves of a nested dict (``PSpec``, tensors and
    ``QTensor`` are leaves)."""
    if isinstance(tree, Mapping):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def tree_leaves(tree: Any) -> list:
    """Leaves in sorted-key order (``jax.tree_util``'s order for dicts)."""
    if isinstance(tree, Mapping):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def init_from_specs(generator: torch.Generator, specs: Any, cfg: ArchConfig):
    """Materialise a PSpec tree into real parameters on ``generator``'s
    device: normals over ``sqrt(fan_in)`` (the first axis of a matrix, the
    last of a vector) drawn in fp32, then cast; the leaves draw in sorted
    key order, the reference's leaf order.  The values come from ``generator`` and differ
    from ``jax.random``'s."""
    dev = generator.device

    def make(s: PSpec) -> torch.Tensor:
        dt = torch_dtype(s.dtype or cfg.param_dtype)
        if s.init == "zeros":
            return torch.zeros(s.shape, dtype=dt, device=dev)
        if s.init == "ones":
            return torch.ones(s.shape, dtype=dt, device=dev)
        fan_in = s.shape[0] if len(s.shape) >= 2 else max(s.shape[-1], 1)
        w = torch.randn(s.shape, generator=generator, dtype=torch.float32, device=dev)
        return (w / math.sqrt(fan_in)).to(dt)

    def walk(tree):
        if isinstance(tree, Mapping):
            return {k: walk(tree[k]) for k in sorted(tree)}
        return make(tree)

    return walk(specs)


def abstract_from_specs(specs: Any, cfg: ArchConfig):
    """A PSpec tree as tensors on the ``meta`` device: shapes and dtypes,
    nothing allocated (the reference's ``ShapeDtypeStruct`` tree)."""
    return tree_map(lambda s: torch.empty(s.shape, dtype=torch_dtype(s.dtype or cfg.param_dtype),
                                          device="meta"), specs)


def logical_from_specs(specs: Any):
    """A PSpec tree with each leaf's logical axis names."""
    return tree_map(lambda s: s.logical, specs)


def stack_specs(specs: Any, n: int, axis_name: str = "layers"):
    """Prepend a stacked 'layers' axis to every PSpec (groups of layers)."""
    return tree_map(lambda s: PSpec((n,) + s.shape, (axis_name,) + s.logical, s.init, s.dtype),
                    specs)


# ---------------------------------------------------------------------------
# precision-aware matmul
# ---------------------------------------------------------------------------


def dequantize_as(w, dtype: torch.dtype) -> torch.Tensor:
    """``w`` as a float tensor: a ``QTensor``'s payload times its scale's
    channels of that payload (``QTensor.local_scale``: a rank's part of a
    cut weight dequantises with its part of the whole scale), both cast to
    ``dtype`` first (the reference's ``q.astype * scale.astype``)."""
    if isinstance(w, QTensor):
        return w.q.to(dtype) * w.local_scale().to(dtype)
    return w


def qeinsum(spec: str, x: torch.Tensor, w) -> torch.Tensor:
    """einsum that accepts QTensor weights (weight-only int8 execution)."""
    return torch.einsum(spec, x, dequantize_as(w, x.dtype))


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------


def rmsnorm_specs(d: int) -> dict:
    return {"scale": PSpec((d,), ("embed",), init="ones", dtype="float32")}


def rmsnorm(p, x: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.to(torch.float32)
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * p["scale"]).to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, H, Dh); positions: broadcastable to (..., S)."""
    dh = x.shape[-1]
    half = dh // 2
    expo = -torch.arange(0, half, dtype=torch.float32, device=x.device) / half
    freq = torch.pow(torch.tensor(theta, dtype=torch.float32, device=x.device), expo)
    ang = positions[..., None].to(torch.float32) * freq  # (..., S, half)
    cos = torch.cos(ang)[..., None, :].to(x.dtype)
    sin = torch.sin(ang)[..., None, :].to(x.dtype)
    x1, x2 = x[..., :half], x[..., half : 2 * half]
    rot = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    if 2 * half != dh:  # odd head_dim tail passes through
        rot = torch.cat([rot, x[..., 2 * half :]], dim=-1)
    return rot


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

ATTN_CHUNK = 1024  # KV-chunked (online softmax) path beyond this seq length
NEG_INF = -1e30


def attn_specs(cfg: ArchConfig) -> dict:
    d, h, kv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    return {
        "norm": rmsnorm_specs(d),
        "wq": PSpec((d, h, dh), ("embed", "heads", "head_dim")),
        "wk": PSpec((d, kv, dh), ("embed", "kv_heads", "head_dim")),
        "wv": PSpec((d, kv, dh), ("embed", "kv_heads", "head_dim")),
        "wo": PSpec((h, dh, d), ("heads", "head_dim", "embed")),
    }


@dataclasses.dataclass(frozen=True)
class AttnCacheSpec:
    length: int  # buffer length (== window for ring caches)
    ring: bool


def attn_cache_shape(cfg: ArchConfig, batch: int, max_seq: int, window: Optional[int]):
    """Cache buffer spec: windowed layers get ring buffers of window length."""
    if window is not None and window < max_seq:
        return AttnCacheSpec(length=window, ring=True)
    return AttnCacheSpec(length=max_seq, ring=False)


def attn_cuts(cfg: ArchConfig) -> tuple[Optional[SH.Cut], Optional[SH.Cut]]:
    """The cuts of the query heads (``wq``/``wo``) and of the kv heads
    (``wk``/``wv``) under the active rules; ``None`` where whole."""
    s = attn_specs(cfg)
    return (SH.dim_cut(s["wq"].logical, s["wq"].shape, 1),
            SH.dim_cut(s["wk"].logical, s["wk"].shape, 1))


def cache_seq_cut(cfg: ArchConfig, length: int) -> Optional[SH.Cut]:
    """How the sequence dimension of a decode cache of global length
    ``length`` is held under the active rules: read with ``dim_cut`` from
    the cache's logical axes (``("layers", "decode_batch",
    kv_seq_axis(n_kv), "kv_heads", "head_dim")``), so a length the axes do
    not divide stays whole and an axis the rows took is dropped.  The rows
    are taken to divide over their axes (the repo's rules give the rows and
    the sequence disjoint mesh axes, so the rows' count never moves the
    sequence's cut).  ``None`` where every rank holds it whole."""
    rules = SH.active_rules()
    if rules is None:
        return None
    rows = rules.size(rules.mesh_axes_for("decode_batch"))
    logical = ("layers", "decode_batch", SH.kv_seq_axis(cfg.n_kv_heads), "kv_heads", "head_dim")
    return SH.dim_cut(logical, (1, rows, length, cfg.n_kv_heads, cfg.head_dim), 2)


def _tp_in(p, h, heads, kv):
    """The normed input and ``wk``/``wv`` as this rank's heads read them:
    through ``copy_to`` where the query heads are cut (a whole ``wk``/``wv``
    too, since a rank reads only some of its kv heads)."""
    g = SH.group_of(heads)
    wk, wv = p["wk"], p["wv"]
    if heads is not None and kv is None:
        wk, wv = SH.copy_to(wk, g), SH.copy_to(wv, g)
    return SH.copy_to(h, g), wk, wv


def _kv_for_heads(k, v, cfg: ArchConfig, heads, kv):
    """k and v (..., Hkv, Dh) as this rank's query heads read them: as
    they are unless the query heads are cut over whole kv heads; then the
    kv heads of the local heads' global indices, a slice where they group
    evenly, else one kv head a local head."""
    if heads is None or kv is not None:
        return k, v
    hl = cfg.n_heads // heads.size
    g = cfg.n_heads // cfg.n_kv_heads
    first = heads.index * hl
    want = [(first + i) // g for i in range(hl)]
    lo, n = want[0], want[-1] - want[0] + 1
    if hl % n == 0 and all(w - lo == i // (hl // n) for i, w in enumerate(want)):
        return k.narrow(-2, lo, n), v.narrow(-2, lo, n)
    idx = torch.tensor(want, device=k.device)
    return k.index_select(-2, idx), v.index_select(-2, idx)


def _qkv(p, x, cfg: ArchConfig, positions, wk, wv):
    q = qeinsum("bsd,dhk->bshk", x, p["wq"])
    k = qeinsum("bsd,dhk->bshk", x, wk)
    v = qeinsum("bsd,dhk->bshk", x, wv)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    return q, k, v


def _scale_const(dh: int, like: torch.Tensor) -> torch.Tensor:
    """``1 / sqrt(dh)`` as an fp32 tensor on ``like``'s device."""
    return torch.tensor(1.0 / math.sqrt(dh), dtype=torch.float32, device=like.device)


def _dense_attention(q, k, v, cfg: ArchConfig, window, causal: bool):
    """Materialised-scores path for short sequences."""
    b, s, h, dh = q.shape
    kvh = k.shape[2]
    g = h // kvh
    qg = q.reshape(b, s, kvh, g, dh)
    scores = torch.einsum("bskgd,btkd->bkgst", qg, k).to(torch.float32)
    scores = scores * _scale_const(dh, scores)
    i = torch.arange(s, device=q.device)[:, None]
    j = torch.arange(s, device=q.device)[None, :]
    mask = torch.ones((s, s), dtype=torch.bool, device=q.device)
    if causal:
        mask &= j <= i
    if window is not None:
        mask &= j > i - window
    scores = torch.where(mask, scores, NEG_INF)
    w = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bkgst,btkd->bskgd", w, v)
    return out.reshape(b, s, h, dh)


def _chunked_attention(q, k, v, cfg: ArchConfig, window, causal: bool):
    """KV-chunked online-softmax attention: memory O(S * chunk), not O(S^2).
    Reads :data:`ATTN_CHUNK` at call time."""
    b, s, h, dh = q.shape
    kvh = k.shape[2]
    g = h // kvh
    c = ATTN_CHUNK
    n_chunks = (s + c - 1) // c
    pad = n_chunks * c - s
    kp = F.pad(k, (0, 0, 0, 0, 0, pad)).reshape(b, n_chunks, c, kvh, dh)
    vp = F.pad(v, (0, 0, 0, 0, 0, pad)).reshape(b, n_chunks, c, kvh, dh)
    qg = q.reshape(b, s, kvh, g, dh)
    scale = _scale_const(dh, q)
    i_pos = torch.arange(s, device=q.device)
    m = torch.full((b, kvh, g, s, 1), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, kvh, g, s, 1), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, kvh, g, s, dh), dtype=torch.float32, device=q.device)
    for idx in range(n_chunks):
        kc, vc = kp[:, idx], vp[:, idx]
        j_pos = idx * c + torch.arange(c, device=q.device)
        sc = torch.einsum("bskgd,btkd->bkgst", qg, kc).to(torch.float32) * scale
        mask = (j_pos[None, :] < s).expand(s, c)  # drop padded kv
        if causal:
            mask = mask & (j_pos[None, :] <= i_pos[:, None])
        if window is not None:
            mask = mask & (j_pos[None, :] > i_pos[:, None] - window)
        sc = torch.where(mask, sc, NEG_INF)
        m_new = torch.maximum(m, sc.amax(dim=-1, keepdim=True))
        p = torch.exp(sc - m_new)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1, keepdim=True)
        acc = acc * corr.to(acc.dtype) + torch.einsum(
            "bkgst,btkd->bkgsd", p.to(vc.dtype), vc
        ).to(acc.dtype)
        m = m_new
    out = (acc / torch.clamp_min(l, 1e-30)).to(q.dtype)
    return out.permute(0, 3, 1, 2, 4).reshape(b, s, h, dh)


def attn_fwd(
    p,
    x: torch.Tensor,
    cfg: ArchConfig,
    *,
    window: Optional[int] = None,
    positions: Optional[torch.Tensor] = None,
    emit_cache: Optional[AttnCacheSpec] = None,
):
    """Full-sequence attention block (pre-norm, residual).  Returns
    (y, cache | None) where cache = {k, v} trimmed/rolled per the spec."""
    b, s, _ = x.shape
    if positions is None:
        positions = torch.arange(s, device=x.device)[None, :]
    heads, kvc = attn_cuts(cfg)
    h = rmsnorm(p["norm"], x, cfg.norm_eps)
    h, wk, wv = _tp_in(p, h, heads, kvc)
    q, k, v = _qkv(p, h, cfg, positions, wk, wv)
    kq, vq = _kv_for_heads(k, v, cfg, heads, kvc)
    if s <= ATTN_CHUNK:
        out = _dense_attention(q, kq, vq, cfg, window, cfg.causal)
    else:
        out = _chunked_attention(q, kq, vq, cfg, window, cfg.causal)
    y = SH.reduce_from(qeinsum("bshk,hkd->bsd", out, p["wo"]), SH.group_of(heads))
    cache = None
    if emit_cache is not None:
        L = emit_cache.length
        seq = cache_seq_cut(cfg, L)
        SH.group_of(seq)  # a cut the decode cannot combine raises here
        k, v = SH.to_cache_rows(k), SH.to_cache_rows(v)
        if emit_cache.ring and s >= L:
            # last L positions, laid out so slot = pos % L
            shift = s % L
            cache = {"k": torch.roll(k[:, -L:], shift, dims=1),
                     "v": torch.roll(v[:, -L:], shift, dims=1)}
        else:
            cache = {"k": _pad_to(k, L), "v": _pad_to(v, L)}
        if seq is not None:  # this rank's slots of the whole cache
            cache = {n: t[:, seq.part(L)].clone(memory_format=torch.contiguous_format)
                     for n, t in cache.items()}
    return x + y, cache


def _pad_to(t: torch.Tensor, L: int) -> torch.Tensor:
    s = t.shape[1]
    if s == L:
        return t
    if s > L:
        return t[:, :L]
    return F.pad(t, (0, 0, 0, 0, 0, L - s))


def cache_slot(pos: int, spec: AttnCacheSpec) -> int:
    """The cache slot a decode step at absolute position ``pos`` writes:
    ``pos % L`` for a ring, ``pos`` for a linear cache, clamped into the
    buffer as ``jax.lax.dynamic_update_slice`` clamps its start (a linear
    cache written at ``pos >= L`` lands in slot ``L - 1``)."""
    slot = pos % spec.length if spec.ring else pos
    return min(max(slot, 0), spec.length - 1)


def _valid_slots(t: torch.Tensor, pos: int, spec: AttnCacheSpec, window) -> torch.Tensor:
    """Which of the cache slots ``t`` (global indices) a decode step at
    ``pos`` attends to."""
    if spec.ring:
        # absolute position stored in slot t: largest value <= pos congruent t mod L
        abs_pos = pos - torch.remainder(pos - t, spec.length)
        valid = abs_pos >= 0
        if window is not None:
            valid &= abs_pos > pos - window
    else:
        valid = t <= pos
        if window is not None:
            valid &= t > pos - window
    return valid


def _decode_scores(q, k, valid):
    """fp32 scores of one token's query heads (B, 1, H, Dh) over the cache
    slots of ``k`` (B, T, Hkv, Dh), invalid slots at :data:`NEG_INF`:
    (B, Hkv, H / Hkv, T)."""
    b, _, hq, dh = q.shape
    kvh = k.shape[2]
    qg = q.reshape(b, kvh, hq // kvh, dh)
    scores = torch.einsum("bkgd,btkd->bkgt", qg, k).to(torch.float32)
    scores = torch.div(scores, torch.tensor(math.sqrt(dh), dtype=torch.float32,
                                            device=q.device))
    return torch.where(valid[None, None, None, :], scores, NEG_INF)


def _ring_decode(q, ck, cv, valid, heads, kvc, seq: SH.Cut):
    """Ring-decode attention: this rank's cache slots score every query
    head it needs (all of them, gathered over the heads' group, where the
    heads are cut over whole kv heads), give fp32 partial statistics (max,
    sum of ``exp``, value accumulator, ``p`` cast to the value dtype for
    the product as in ``_chunked_attention``), and the ranks of the
    sequence's group combine them: the max all-reduced, each rank's sum and
    accumulator rescaled by ``exp(m_local - m_global)`` and summed.  A rank
    whose slots are all invalid has a local max of ``NEG_INF`` and sums of
    ones: the rescale, ``exp(NEG_INF - m_global) = 0``, makes its share
    exactly zero.  Returns this rank's heads of the output (B, 1, Hl, Dh)."""
    gathered = heads is not None and kvc is None
    if gathered:
        q = SH.gather_dim(q, heads, 2)
    b, _, hq, dh = q.shape
    scores = _decode_scores(q, ck, valid)
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.exp(scores - m)
    acc = torch.einsum("bkgt,btkd->bkgd", p.to(cv.dtype), cv).to(torch.float32)
    group = SH.group_of(seq)
    m_all = m.clone()
    dist.all_reduce(m_all, op=dist.ReduceOp.MAX, group=group)
    corr = torch.exp(m - m_all)
    stats = torch.cat([acc * corr, p.sum(dim=-1, keepdim=True) * corr], dim=-1)
    dist.all_reduce(stats, group=group)
    out = (stats[..., :dh] / stats[..., dh:]).to(cv.dtype).reshape(b, 1, hq, dh)
    if gathered:
        hl = hq // heads.size
        out = out.narrow(2, heads.index * hl, hl)
    return out


def attn_decode(
    p,
    x: torch.Tensor,  # (B, 1, D)
    cache: dict,  # {"k": (B, L, Hkv, Dh), "v": ...}: this rank's slots
    pos: int,  # absolute position of the new token
    cfg: ArchConfig,
    *,
    window: Optional[int] = None,
    spec: AttnCacheSpec,
):
    """Single-token decode with linear or ring cache.  Returns (y, new_cache);
    the cache passed in is left as it was.  Where the cache's sequence is
    cut (:func:`cache_seq_cut`), the rank holding the global slot writes
    the new token and the ranks combine their slots' attention
    (:func:`_ring_decode`)."""
    b = x.shape[0]
    pos = int(pos)
    heads, kvc = attn_cuts(cfg)
    L = spec.length
    seq = cache_seq_cut(cfg, L)
    h = rmsnorm(p["norm"], x, cfg.norm_eps)
    h, wk, wv = _tp_in(p, h, heads, kvc)
    positions = torch.full((1, 1), pos, dtype=torch.int32, device=x.device)
    q, k, v = _qkv(p, h, cfg, positions, wk, wv)  # (B, 1, H/Hkv, Dh)
    slot = cache_slot(pos, spec)
    first, n = (0, L) if seq is None else (seq.part(L).start, L // seq.size)
    ck, cv = cache["k"].clone(), cache["v"].clone()
    if first <= slot < first + n:  # this rank holds the slot
        ck[:, slot - first] = k[:, 0].to(ck.dtype)
        cv[:, slot - first] = v[:, 0].to(cv.dtype)
    valid = _valid_slots(torch.arange(first, first + n, device=x.device), pos, spec, window)
    if seq is None:
        kq, vq = _kv_for_heads(ck, cv, cfg, heads, kvc)
        hq, kvh, dh = q.shape[2], kq.shape[2], q.shape[3]
        w = torch.softmax(_decode_scores(q, kq, valid), dim=-1).to(cv.dtype)
        out = torch.einsum("bkgt,btkd->bkgd", w, vq).reshape(b, 1, hq, dh)
    else:
        out = _ring_decode(q, ck, cv, valid, heads, kvc, seq)
    y = SH.reduce_from(qeinsum("bshk,hkd->bsd", out.to(x.dtype), p["wo"]), SH.group_of(heads))
    return x + y, {"k": ck, "v": cv}


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default, the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def mlp_specs(cfg: ArchConfig) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    base = {"norm": rmsnorm_specs(d)}
    if cfg.mlp_kind in ("swiglu", "geglu"):
        base.update(
            wi_gate=PSpec((d, f), ("embed", "mlp")),
            wi_up=PSpec((d, f), ("embed", "mlp")),
            wo=PSpec((f, d), ("mlp", "embed")),
        )
    else:  # gelu
        base.update(
            wi=PSpec((d, f), ("embed", "mlp")),
            wo=PSpec((f, d), ("mlp", "embed")),
        )
    return base


def mlp_cut(cfg: ArchConfig) -> Optional[SH.Cut]:
    """The cut of the MLP's hidden (``"mlp"``) dimension, ``None`` where
    whole."""
    s = mlp_specs(cfg)["wo"]
    return SH.dim_cut(s.logical, s.shape, 0)


def mlp_fwd(p, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    grp = SH.group_of(mlp_cut(cfg))
    h = SH.copy_to(rmsnorm(p["norm"], x, cfg.norm_eps), grp)
    if cfg.mlp_kind in ("swiglu", "geglu"):
        act = F.silu if cfg.mlp_kind == "swiglu" else gelu
        g = act(qeinsum("bsd,df->bsf", h, p["wi_gate"]))
        u = qeinsum("bsd,df->bsf", h, p["wi_up"])
        y = qeinsum("bsf,fd->bsd", g * u, p["wo"])
    else:
        ff = gelu(qeinsum("bsd,df->bsf", h, p["wi"]))
        y = qeinsum("bsf,fd->bsd", ff, p["wo"])
    return x + SH.reduce_from(y, grp)
