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
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Mapping, NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.core.quantization import QTensor

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
    """``w`` as a float tensor: a ``QTensor``'s payload times its scale, both
    cast to ``dtype`` first (the reference's ``q.astype * scale.astype``)."""
    if isinstance(w, QTensor):
        return w.q.to(dtype) * w.scale.to(dtype)
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


def _qkv(p, x, cfg: ArchConfig, positions):
    q = qeinsum("bsd,dhk->bshk", x, p["wq"])
    k = qeinsum("bsd,dhk->bshk", x, p["wk"])
    v = qeinsum("bsd,dhk->bshk", x, p["wv"])
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
    h = rmsnorm(p["norm"], x, cfg.norm_eps)
    q, k, v = _qkv(p, h, cfg, positions)
    if s <= ATTN_CHUNK:
        out = _dense_attention(q, k, v, cfg, window, cfg.causal)
    else:
        out = _chunked_attention(q, k, v, cfg, window, cfg.causal)
    y = qeinsum("bshk,hkd->bsd", out, p["wo"])
    cache = None
    if emit_cache is not None:
        L = emit_cache.length
        if emit_cache.ring and s >= L:
            # last L positions, laid out so slot = pos % L
            shift = s % L
            cache = {"k": torch.roll(k[:, -L:], shift, dims=1),
                     "v": torch.roll(v[:, -L:], shift, dims=1)}
        else:
            cache = {"k": _pad_to(k, L), "v": _pad_to(v, L)}
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


def attn_decode(
    p,
    x: torch.Tensor,  # (B, 1, D)
    cache: dict,  # {"k": (B, L, Hkv, Dh), "v": ...}
    pos: int,  # absolute position of the new token
    cfg: ArchConfig,
    *,
    window: Optional[int] = None,
    spec: AttnCacheSpec,
):
    """Single-token decode with linear or ring cache.  Returns (y, new_cache);
    the cache passed in is left as it was."""
    b = x.shape[0]
    pos = int(pos)
    h = rmsnorm(p["norm"], x, cfg.norm_eps)
    positions = torch.full((1, 1), pos, dtype=torch.int32, device=x.device)
    q, k, v = _qkv(p, h, cfg, positions)  # (B, 1, H/Hkv, Dh)
    L = spec.length
    slot = cache_slot(pos, spec)
    ck, cv = cache["k"].clone(), cache["v"].clone()
    ck[:, slot] = k[:, 0].to(ck.dtype)
    cv[:, slot] = v[:, 0].to(cv.dtype)
    hq, kvh, dh = q.shape[2], ck.shape[2], q.shape[3]
    g = hq // kvh
    qg = q.reshape(b, kvh, g, dh)
    scores = torch.einsum("bkgd,btkd->bkgt", qg, ck).to(torch.float32)
    scores = torch.div(scores, torch.tensor(math.sqrt(dh), dtype=torch.float32,
                                            device=x.device))
    t = torch.arange(L, device=x.device)
    if spec.ring:
        # absolute position stored in slot t: largest value <= pos congruent t mod L
        abs_pos = pos - torch.remainder(pos - t, L)
        valid = abs_pos >= 0
        if window is not None:
            valid &= abs_pos > pos - window
    else:
        valid = t <= pos
        if window is not None:
            valid &= t > pos - window
    scores = torch.where(valid[None, None, None, :], scores, NEG_INF)
    w = torch.softmax(scores, dim=-1).to(cv.dtype)
    out = torch.einsum("bkgt,btkd->bkgd", w, cv).reshape(b, 1, hq, dh)
    y = qeinsum("bshk,hkd->bsd", out.to(x.dtype), p["wo"])
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


def mlp_fwd(p, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    h = rmsnorm(p["norm"], x, cfg.norm_eps)
    if cfg.mlp_kind in ("swiglu", "geglu"):
        act = F.silu if cfg.mlp_kind == "swiglu" else gelu
        g = act(qeinsum("bsd,df->bsf", h, p["wi_gate"]))
        u = qeinsum("bsd,df->bsf", h, p["wi_up"])
        y = qeinsum("bsf,fd->bsd", g * u, p["wo"])
    else:
        ff = gelu(qeinsum("bsd,df->bsf", h, p["wi"]))
        y = qeinsum("bsf,fd->bsd", ff, p["wo"])
    return x + y
