"""Mamba2 SSM block (SSD parameterisation) for the hybrids.

Counterpart of ``repro/models/mamba2.py``.  Structure per layer (d_inner =
expand * d_model, heads = d_inner/P, P = head dim, N = ssm_state):
    in_proj: x -> [z, xc, B, C, dt]
    causal conv1d (k=4) over xc, silu
    selective scan with scalar-per-head decay a_t = exp(-softplus(dt) e^{A})
    y = C^T S + D x, gated by silu(z), out_proj back to d_model.

That is zamba2's block (the reference's): the conv over ``xc`` alone, the
gate after the norm, ``rmsnorm(y) * silu(z)``.  ``cfg.ssm_published``
selects the published Mamba2 mixer (Hugging Face's ``Mamba2Mixer``, as in
Granite-4.0-H): the conv, with its bias, over ``[x, B, C]`` (so its decode
state holds ``d_inner + 2N`` channels), and the gate before the norm,
``rmsnorm(y * silu(z))`` over all of ``d_inner``.  It runs on one device:
under rules that cut its heads it raises ``NotImplementedError``.

The scan over a sequence of more than one token is the chunked SSD scan
of arXiv:2405.21060 section 6 (:func:`_ssd_chunked`, chunks of
:data:`SSD_CHUNK`): each chunk's output from its masked decay matrix and
from the state entering it, the chunks' states by one recurrence over the
chunks.  A decode step (one token) takes the single-step update
(:func:`_ssm_step`) and one window of the conv.  The
state is (B, H, N, P); decode carries (conv_state, ssm_state), O(1) in
context.  Counters, module attributes
bumped by ``backend.count_launch``: :data:`chunked_chunks` (chunks a
multi-token scan ran, one a chunk and layer) and :data:`step_updates`
(single-step updates, one a layer and step).  Spans (``backend.lm_span``):
``mamba2`` around the mixer, ``mamba2.scan`` around its conv and scan.

Tensor parallelism (under active rules; ``sharding.dim_cut`` reads each
cut from the leaf's logical axes and global shape).  Where ``"ssm_heads"``
cuts the heads (``a_log``'s cut, :func:`head_cut`), the block runs
head-parallel, as the reference's GSPMD places it:

* ``w_in`` holds a *contiguous* part of the fused ``[z, x, B, C, dt]``
  columns, which does not follow the segments; a rank needs its own heads'
  ``z``, ``x`` and ``dt`` columns and all of ``B`` and ``C``.  Of two
  routes it takes the one that moves fewer bytes (:func:`in_route`): the
  *activation* route computes its part of the projection column-parallel
  and gathers the projection (``tokens x E`` values of the activations'
  dtype), the *weight* route gathers ``w_in`` (``d_model x E`` of its own)
  and computes only the columns it needs; so the activation route where a
  rank's ``tokens x act bytes < d_model x weight bytes`` (a decode step's
  few tokens), else the weight route (a train step's thousands).  Both
  gathers are ``sharding.gather_partials`` (the backward reduce-scatters:
  each rank's gradient covers only its columns, and a part of B's and C's),
  and the normed input enters through ``copy_to``.  A ``w_in`` whose
  columns the axis does not divide is whole on every rank and enters
  through ``copy_to`` before its columns are taken;
* ``conv_w``, ``conv_b``, ``a_log``, ``d_skip`` and ``dt_bias`` are cut in
  step with the heads and used as held; the conv, the scan and the gate
  ``silu(z)`` run on the local heads;
* ``out_norm`` normalises over all of ``d_in``: the local sums of squares
  are summed over the group (``sharding.sum_partials``, whose backward is
  an all-reduce) and divided by the whole ``d_in``; its whole scale enters
  through ``copy_to`` before the local channels are taken;
* ``w_out`` is row-parallel (``reduce_from``).  Int8 ``QTensor`` leaves
  dequantise their part with ``QTensor.local_scale``.

The decode state is held as its logical axes (:data:`STATE_AXES`) cut it:
the local heads' ``conv`` and ``ssm``.  Where the heads are not cut (a head
count the axis does not divide), the block runs whole: the leaves of
:data:`GATHERED` that are cut (``w_in`` where its columns divide, and
``conv_w``, ``conv_b`` and ``w_out`` on ``d_in``, which may still divide)
are gathered at use (``sharding.gather_dim``), and a state part its axes
cut (``conv`` on ``d_in``) is gathered on entry and this rank's part kept
on exit.
"""
from __future__ import annotations

import contextlib
import sys

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.core.quantization import QTensor
from repro_torch.distributed import sharding as SH
from repro_torch.kernels import backend
from repro_torch.models.layers import (
    PSpec, dequantize_as, qeinsum, residual, rmsnorm, rmsnorm_specs, torch_dtype)

#: tokens a chunk of the multi-token scan (:func:`_ssd_chunked`) holds, read
#: at call time: zamba2's and granite's published ``chunk_size``
SSD_CHUNK = 256
#: chunks the multi-token scans ran (:func:`_ssd_chunked`), one a chunk and layer
chunked_chunks = 0
#: single-step state updates (:func:`_ssm_step` at one token), one a layer and step
step_updates = 0
_COUNTERS = sys.modules[__name__]

#: the decode state's logical axes, layer axis leading (the reference's
#: ``transformer.cache_logical_axes``)
STATE_AXES = {"conv": ("layers", "decode_batch", None, "ssm_heads"),
              "ssm": ("layers", "decode_batch", "ssm_heads", "ssm_state", None)}

#: where the heads are not cut: the cut leaves gathered at use, and the
#: dimension each is cut on
GATHERED = {"w_in": 1, "conv_w": 1, "conv_b": 0, "a_log": 0, "d_skip": 0, "dt_bias": 0,
            "w_out": 0}


def _dims(cfg: ArchConfig):
    d_in = cfg.ssm_expand * cfg.d_model
    n_heads = d_in // cfg.ssm_head_dim
    return d_in, n_heads, cfg.ssm_head_dim, cfg.ssm_state


def _conv_width(cfg: ArchConfig) -> int:
    """The conv's channels: ``[x, B, C]``'s for the published mixer, ``x``'s
    for zamba2's."""
    d_in, _, _, n = _dims(cfg)
    return d_in + 2 * n if cfg.ssm_published else d_in


def mamba2_specs(cfg: ArchConfig) -> dict:
    d = cfg.d_model
    d_in, nh, p_, n = _dims(cfg)
    k = cfg.conv_kernel
    conv, conv_axis = _conv_width(cfg), None if cfg.ssm_published else "ssm_heads"
    return {
        "norm": rmsnorm_specs(d),
        "w_in": PSpec((d, 2 * d_in + 2 * n + nh), ("embed", "ssm_heads")),
        "conv_w": PSpec((k, conv), ("conv_kernel", conv_axis), dtype="float32"),
        "conv_b": PSpec((conv,), (conv_axis,), init="zeros", dtype="float32"),
        "a_log": PSpec((nh,), ("ssm_heads",), init="zeros", dtype="float32"),
        "d_skip": PSpec((nh,), ("ssm_heads",), init="ones", dtype="float32"),
        "dt_bias": PSpec((nh,), ("ssm_heads",), init="zeros", dtype="float32"),
        "out_norm": rmsnorm_specs(d_in),
        "w_out": PSpec((d_in, d), ("ssm_heads", "embed")),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, state: torch.Tensor | None):
    """Depthwise causal conv over time in fp32 (``x`` of any float dtype is
    widened as it is joined to the state).  x: (B, T, C), w: (K, C).
    state: (B, K-1, C) fp32 trailing context from the previous segment."""
    k = w.shape[0]
    if state is None:
        state = torch.zeros((x.shape[0], k - 1, x.shape[2]), dtype=torch.float32,
                            device=x.device)
    xp = torch.cat([state, x], dim=1)
    if x.shape[1] == 1:  # a decode step: its one window
        return torch.sum(xp * w, dim=1, keepdim=True) + b, xp[:, 1:]
    out = 0
    for i in range(k):  # the reference's Python ``sum``: 0 + term 0 + term 1 ...
        out = out + xp[:, i : i + x.shape[1], :] * w[i][None, None, :]
    # a copy: a view would keep the whole sequence alive in the cache
    return out + b[None, None, :], xp[:, -(k - 1) :, :].clone()


def _ssm_step(x, bmat, cmat, dt, a, S):
    """One token's update, x (B,H,P), B/C (B,N), dt and a (B,H), S (B,H,N,P):
    ``S' = a S + (dt B) ⊗ x`` in one fused multiply-add over the state, and
    ``C^T S'`` (B,H,P) as a batched product."""
    S = torch.addcmul(a[..., None, None] * S, (dt[..., None] * bmat[:, None])[..., None],
                      x[:, :, None, :])
    return S, torch.matmul(cmat[:, None, None, :], S)[:, :, 0]


def _segsum(x: torch.Tensor) -> torch.Tensor:
    """(..., T) -> (..., T, T): ``[i, j]`` is ``x[j+1] + ... + x[i]`` for
    ``j <= i`` (0 on the diagonal), ``-inf`` above it; summed along the
    columns of a masked copy, not as a difference of cumulative sums, so
    that no entry loses precision to a long sum (and ``exp`` of it is the
    masked decay matrix, with no ``inf`` whose gradient is NaN)."""
    t = x.shape[-1]
    ones = torch.ones((t, t), dtype=torch.bool, device=x.device)
    xx = x[..., None].expand(*x.shape, t).masked_fill(~torch.tril(ones, -1), 0)
    return torch.cumsum(xx, dim=-2).masked_fill(~torch.tril(ones), float("-inf"))


def _ssd_chunked(x, bmat, cmat, dt, log_a, d_skip, state0, chunk: int):
    """The chunked SSD scan (arXiv:2405.21060 section 6, its "minimal SSD"
    form) of the recurrence ``S_t = a_t S_{t-1} + dt_t (B_t ⊗ x_t)``, ``y_t =
    C_t^T S_t + D x_t``, with ``a = exp(log_a)``: x (B, T, H, P), B/C (B, T, N), dt and log_a (B, T, H),
    state0 (B, H, N, P) -> (the state after the last token, y (B, T, H,
    P)).  Chunks of ``chunk`` tokens (of T where T is shorter); a last
    chunk that T leaves short is padded with tokens that neither decay nor
    add to the state."""
    b, t, h, p = x.shape
    n = bmat.shape[-1]
    ln = min(chunk, t)
    c = -(-t // ln)
    pad = c * ln - t
    xdt = x * dt[..., None]
    if pad:
        xdt, bmat, cmat, log_a = (F.pad(v, (0, 0) * (v.dim() - 2) + (0, pad))
                                  for v in (xdt, bmat, cmat, log_a))
    X = xdt.reshape(b, c, ln, h, p)
    Bc, Cc = bmat.reshape(b, c, ln, n), cmat.reshape(b, c, ln, n)
    A = log_a.reshape(b, c, ln, h).permute(0, 3, 1, 2)  # (B, H, c, l)
    A_cs = torch.cumsum(A, dim=-1)
    # 1. within each chunk: C_i B_s over the masked decay matrix
    M = torch.exp(_segsum(A)) * torch.einsum("bcln,bcsn->bcls", Cc, Bc)[:, None]
    y = torch.einsum("bhcls,bcshp->bclhp", M, X)
    # 2. each chunk's state from its own tokens, decayed to its end
    decay = torch.exp(A_cs[..., -1:] - A_cs).permute(0, 2, 3, 1)  # (B, c, l, H)
    states = torch.einsum("bcln,bclhp->bchnp", Bc, X * decay[..., None])
    # 3. the recurrence over the chunks: the state entering each, and the last
    states = torch.cat([state0[:, None], states], dim=1)
    chunk_decay = torch.exp(_segsum(F.pad(A_cs[..., -1], (1, 0))))  # (B, H, c+1, c+1)
    states = torch.einsum("bhzc,bchnp->bzhnp", chunk_decay, states)
    # 4. each chunk's output from the state entering it
    into = torch.exp(A_cs).permute(0, 2, 3, 1)[..., None]  # (B, c, l, H, 1)
    y = y + torch.einsum("bcln,bchnp->bclhp", Cc, states[:, :-1]) * into
    y = y.reshape(b, c * ln, h, p)[:, :t] + d_skip[None, None, :, None] * x
    for _ in range(c):
        backend.count_launch(_COUNTERS, "chunked_chunks")
    return states[:, -1].clone(), y


def head_cut(cfg: ArchConfig):
    """How the heads are cut under the active rules (``a_log``'s cut of
    ``"ssm_heads"``), or ``None`` where every rank holds them all."""
    if SH.active_rules() is None:
        return None
    s = mamba2_specs(cfg)["a_log"]
    return SH.dim_cut(s.logical, s.shape, 0)


def state_cuts(cfg: ArchConfig) -> dict:
    """The decode state's cuts under the active rules, read from
    :data:`STATE_AXES` with the state's global shape: ``{"conv": cut of
    d_in, "ssm": cut of the heads}`` (``None`` where whole).  The rows are
    taken to divide over their axes, as ``layers.cache_seq_cut`` takes
    them."""
    rules = SH.active_rules()
    if rules is None:
        return {"conv": None, "ssm": None}
    rows = rules.size(rules.mesh_axes_for("decode_batch"))
    d_in, nh, pdim, n = _dims(cfg)
    axes = state_axes(cfg)
    return {"conv": SH.dim_cut(axes["conv"], (1, rows, cfg.conv_kernel - 1, _conv_width(cfg)), 3),
            "ssm": SH.dim_cut(axes["ssm"], (1, rows, nh, n, pdim), 2)}


def state_axes(cfg: ArchConfig) -> dict:
    """The decode state's logical axes: :data:`STATE_AXES`; the published
    mixer's conv state over ``[x, B, C]`` is never cut."""
    if cfg.ssm_published:
        return {**STATE_AXES, "conv": ("layers", "decode_batch", None, None)}
    return dict(STATE_AXES)


#: the tokens a rank :func:`in_route` reckons with in place of each call's
#: own (:func:`route_tokens`); ``None``: each call's
_ROUTE_TOKENS = None


@contextlib.contextmanager
def route_tokens(tokens: int | None):
    """Take :func:`in_route`'s route as if every block saw ``tokens`` tokens
    a rank.  The dry run traces a time-scan cell at shorter sequences and
    extrapolates to the cell's own length; those traces must run the
    cell's program, whose route depends on its length.  Process-wide, not
    per thread: remat recomputes a block on autograd's device thread."""
    global _ROUTE_TOKENS
    prev, _ROUTE_TOKENS = _ROUTE_TOKENS, tokens
    try:
        yield
    finally:
        _ROUTE_TOKENS = prev


def in_route(cfg: ArchConfig, tokens: int, w_in) -> str:
    """``"activation"`` where gathering a rank's ``tokens`` rows of the
    projection moves fewer bytes than gathering ``w_in`` (``tokens x
    act bytes < d_model x weight bytes``; the backward's reduce-scatter
    moves the same sizes), else ``"weight"``."""
    w = w_in.q if isinstance(w_in, QTensor) else w_in
    act = torch_dtype(cfg.act_dtype).itemsize
    return "activation" if tokens * act < cfg.d_model * w.element_size() else "weight"


def _in_columns(cfg: ArchConfig, heads) -> list[tuple[int, int]]:
    """``(start, length)`` in ``w_in``'s fused columns of this rank's ``z``,
    ``x``, ``B``, ``C`` and ``dt``: its heads' ``z``, ``x`` and ``dt``, all
    of ``B`` and ``C``."""
    d_in, nh, _, n = _dims(cfg)
    dl, hl = d_in // heads.size, nh // heads.size
    return [(heads.index * dl, dl), (d_in + heads.index * dl, dl), (2 * d_in, n),
            (2 * d_in + n, n), (2 * d_in + 2 * n + heads.index * hl, hl)]


def _in_proj(w_in, h: torch.Tensor, cfg: ArchConfig, heads):
    """This rank's ``z``, ``x``, ``B``, ``C`` and ``dt`` from ``h`` (which
    entered through ``copy_to``), by :func:`in_route`'s route."""
    s = mamba2_specs(cfg)["w_in"]
    cut = SH.dim_cut(s.logical, s.shape, 1)
    cols = _in_columns(cfg, heads)
    tokens = h.shape[0] * h.shape[1] if _ROUTE_TOKENS is None else _ROUTE_TOKENS
    if cut is not None and in_route(cfg, tokens, w_in) == "activation":
        proj = SH.gather_partials(qeinsum("btd,de->bte", h, w_in), cut, -1)
        return [proj.narrow(-1, a, k) for a, k in cols]
    w = SH.gather_partials(w_in, cut, 1) if cut is not None else SH.copy_to(
        w_in, SH.group_of(heads))
    w = dequantize_as(w, h.dtype)
    w = torch.cat([w.narrow(1, a, k) for a, k in cols], dim=1)
    return torch.split(torch.einsum("btd,de->bte", h, w), [k for _, k in cols], dim=-1)


def _local_norm(p, y: torch.Tensor, cfg: ArchConfig, heads) -> torch.Tensor:
    """``rmsnorm(p, y)`` over all of ``d_in`` of the heads' channels ``y``
    holds: the sums of squares summed over the heads' group."""
    d_in = _dims(cfg)[0]
    dl = d_in // heads.size
    yf = y.to(torch.float32)
    var = SH.sum_partials(torch.sum(torch.square(yf), dim=-1, keepdim=True), heads) / d_in
    scale = SH.copy_to(p["scale"], SH.group_of(heads)).narrow(0, heads.index * dl, dl)
    return (yf * torch.rsqrt(var + cfg.norm_eps) * scale).to(y.dtype)


def _conv_scan(p, xc, bmat, cmat, dt, st: dict, cfg: ArchConfig):
    """The causal conv, the gates and the scan over the heads ``xc`` and
    ``dt`` hold (all, or this rank's), from ``st``'s state where given:
    (new conv state, new ssm state, y (B, T, heads x P) in fp32).  For the
    published mixer ``xc`` holds ``[x, B, C]``, which the conv runs over,
    and ``bmat`` and ``cmat`` are ``None``."""
    with backend.lm_span("mamba2.scan"):
        b, t, _ = xc.shape
        hh, pdim, n = dt.shape[-1], cfg.ssm_head_dim, cfg.ssm_state
        xc, conv_state = _causal_conv(xc, p["conv_w"], p["conv_b"], st.get("conv"))
        xc = F.silu(xc)
        if bmat is None:
            xc, bmat, cmat = torch.split(xc, [hh * pdim, n, n], dim=-1)

        dt = F.softplus(dt + p["dt_bias"])  # (B,T,H), fp32 as the bias is
        log_a = -dt * torch.exp(p["a_log"])  # (B,T,H): a = exp(log_a) in (0,1)
        xh = xc.reshape(b, t, hh, pdim)
        s0 = st.get("ssm")
        if s0 is None:
            s0 = torch.zeros((b, hh, n, pdim), dtype=torch.float32, device=xc.device)
        bmat, cmat = bmat.to(torch.float32), cmat.to(torch.float32)
        if t == 1:
            S, y = _ssm_step(xh[:, 0], bmat[:, 0], cmat[:, 0], dt[:, 0], torch.exp(log_a[:, 0]), s0)
            y = torch.addcmul(y, p["d_skip"][:, None], xh[:, 0])[:, None]
            backend.count_launch(_COUNTERS, "step_updates")
        else:
            S, y = _ssd_chunked(xh, bmat, cmat, dt, log_a, p["d_skip"], s0, SSD_CHUNK)
        return conv_state, S, y.reshape(b, t, hh * pdim)


def mamba2_fwd(p, x: torch.Tensor, cfg: ArchConfig, state: dict | None = None,
               emit_state: bool = False):
    """state: {"conv": (B, K-1, conv channels), "ssm": (B, H, N, P)}, this
    rank's parts under active rules (:func:`state_cuts`)."""
    with backend.lm_span("mamba2"):
        heads = head_cut(cfg)
        if heads is None:
            return _whole_fwd(p, x, cfg, state, emit_state)
        if cfg.ssm_published:
            raise NotImplementedError(
                f"{cfg.name}: the published Mamba2 mixer runs on one device; the rules cut "
                f"its {_dims(cfg)[1]} heads {heads.size} ways")
        return _head_parallel_fwd(p, x, cfg, state, emit_state, heads)


def _head_parallel_fwd(p, x, cfg: ArchConfig, state, emit_state: bool, heads):
    """zamba2's block on this rank's heads (module docstring)."""
    h = SH.copy_to(rmsnorm(p["norm"], x, cfg.norm_eps), SH.group_of(heads))
    z, xc, bmat, cmat, dt = _in_proj(p["w_in"], h, cfg, heads)
    conv_state, S, y = _conv_scan(p, xc, bmat, cmat, dt, state or {}, cfg)
    y = _local_norm(p["out_norm"], y.to(x.dtype), cfg, heads) * F.silu(z)
    x = residual(x, SH.reduce_from(qeinsum("bte,ed->btd", y, p["w_out"]), SH.group_of(heads)),
                 cfg)
    if emit_state:
        return x, {"conv": conv_state, "ssm": S}
    return x, None


def _whole_fwd(p, x: torch.Tensor, cfg: ArchConfig, state: dict | None, emit_state: bool):
    """The block run whole on every rank (no rules, or heads the axis does
    not divide): cut leaves gathered at use, a cut state part gathered on
    entry and this rank's part kept on exit."""
    d_in, nh, _, n = _dims(cfg)
    dims = {"conv": 2, "ssm": 1}  # the dimension each state part is cut on
    cuts, st = {}, state or {}
    if SH.active_rules() is not None:
        specs = mamba2_specs(cfg)
        p = {**p, **{k: SH.gather_dim(p[k], SH.dim_cut(specs[k].logical, specs[k].shape, dim),
                                      dim) for k, dim in GATHERED.items()}}
        cuts = state_cuts(cfg)
        st = {k: SH.gather_dim(v, cuts[k], dims[k]) for k, v in st.items()}
    h = rmsnorm(p["norm"], x, cfg.norm_eps)
    proj = qeinsum("btd,de->bte", h, p["w_in"])
    if cfg.ssm_published:
        z, xbc, dt = torch.split(proj, [d_in, d_in + 2 * n, nh], dim=-1)
        conv_state, S, y = _conv_scan(p, xbc, None, None, dt, st, cfg)
        y = rmsnorm(p["out_norm"], y * F.silu(z.to(torch.float32)), cfg.norm_eps).to(x.dtype)
    else:
        z, xc, bmat, cmat, dt = torch.split(proj, [d_in, d_in, n, n, nh], dim=-1)
        conv_state, S, y = _conv_scan(p, xc, bmat, cmat, dt, st, cfg)
        y = rmsnorm(p["out_norm"], y.to(x.dtype), cfg.norm_eps) * F.silu(z)
    x = residual(x, qeinsum("bte,ed->btd", y, p["w_out"]), cfg)
    if emit_state:
        new = {"conv": conv_state, "ssm": S}
        for k, c in cuts.items():
            if c is not None:
                part = c.part(new[k].shape[dims[k]])
                new[k] = new[k].narrow(dims[k], part.start, part.stop - part.start)
        return x, new
    return x, None


def mamba2_decode(p, x: torch.Tensor, state: dict, cfg: ArchConfig):
    return mamba2_fwd(p, x, cfg, state=state, emit_state=True)


def mamba2_state_shapes(cfg: ArchConfig, batch: int) -> dict:
    """``(shape, dtype)`` of each decode-state tensor: under active rules
    this rank's parts (:func:`state_cuts`)."""
    d_in, nh, pdim, n = _dims(cfg)
    cuts = state_cuts(cfg)
    conv, ssm = (1 if cuts[k] is None else cuts[k].size for k in ("conv", "ssm"))
    return {
        "conv": ((batch, cfg.conv_kernel - 1, _conv_width(cfg) // conv), torch.float32),
        "ssm": ((batch, nh // ssm, n, pdim), torch.float32),
    }
