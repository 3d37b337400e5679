"""Mamba2 SSM block (SSD parameterisation) for the zamba2-7b hybrid.

Counterpart of ``repro/models/mamba2.py``.  Structure per layer (d_inner =
expand * d_model, heads = d_inner/P, P = head dim, N = ssm_state):
    in_proj: x -> [z, xc, B, C, dt]
    causal conv1d (k=4) over xc, silu
    selective scan with scalar-per-head decay a_t = exp(-softplus(dt) e^{A})
    y = C^T S + D x, gated by silu(z), out_proj back to d_model.

The reference's ``lax.scan`` over time is a Python loop over steps here
(state (B, H, N, P)); decode carries (conv_state, ssm_state), O(1) in
context.  Each step is a few small launches on the card: a host-launch
cost, recorded, not optimised in this port.

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

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.core.quantization import QTensor
from repro_torch.distributed import sharding as SH
from repro_torch.models.layers import (
    PSpec, dequantize_as, qeinsum, rmsnorm, rmsnorm_specs, torch_dtype)

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


def mamba2_specs(cfg: ArchConfig) -> dict:
    d = cfg.d_model
    d_in, nh, p_, n = _dims(cfg)
    k = cfg.conv_kernel
    return {
        "norm": rmsnorm_specs(d),
        "w_in": PSpec((d, 2 * d_in + 2 * n + nh), ("embed", "ssm_heads")),
        "conv_w": PSpec((k, d_in), ("conv_kernel", "ssm_heads"), dtype="float32"),
        "conv_b": PSpec((d_in,), ("ssm_heads",), init="zeros", dtype="float32"),
        "a_log": PSpec((nh,), ("ssm_heads",), init="zeros", dtype="float32"),
        "d_skip": PSpec((nh,), ("ssm_heads",), init="ones", dtype="float32"),
        "dt_bias": PSpec((nh,), ("ssm_heads",), init="zeros", dtype="float32"),
        "out_norm": rmsnorm_specs(d_in),
        "w_out": PSpec((d_in, d), ("ssm_heads", "embed")),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, state: torch.Tensor | None):
    """Depthwise causal conv over time.  x: (B, T, C), w: (K, C).
    state: (B, K-1, C) trailing context from the previous segment."""
    k = w.shape[0]
    if state is None:
        state = torch.zeros((x.shape[0], k - 1, x.shape[2]), dtype=x.dtype, device=x.device)
    xp = torch.cat([state, x], dim=1)
    out = 0
    for i in range(k):  # the reference's Python ``sum``: 0 + term 0 + term 1 ...
        out = out + xp[:, i : i + x.shape[1], :] * w[i][None, None, :]
    new_state = xp[:, -(k - 1) :, :]
    return out + b[None, None, :], new_state


def _ssm_scan(xbcdt, cfg: ArchConfig, state0):
    """Selective scan.  Inputs per step: x (B,H,P), B/C (B,N), dt (B,H).
    S_t = a_t S_{t-1} + dt_t * (B_t ⊗ x_t);  y_t = C_t^T S_t + D x_t."""
    x, bmat, cmat, dt, a, d_skip = xbcdt
    S = state0
    ys = []
    for t in range(x.shape[1]):
        xt, bt, ct, at, dtt = x[:, t], bmat[:, t], cmat[:, t], a[:, t], dt[:, t]
        dBx = torch.einsum("bn,bhp->bhnp", bt, xt) * dtt[..., None, None]
        S = at[..., None, None] * S + dBx
        ys.append(torch.einsum("bn,bhnp->bhp", ct, S))
    y = torch.stack(ys, dim=1) + d_skip[None, None, :, None] * x
    return S, y


def head_cut(cfg: ArchConfig):
    """How the heads are cut under the active rules (``a_log``'s cut of
    ``"ssm_heads"``), or ``None`` where every rank holds them all."""
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
    return {"conv": SH.dim_cut(STATE_AXES["conv"], (1, rows, cfg.conv_kernel - 1, d_in), 3),
            "ssm": SH.dim_cut(STATE_AXES["ssm"], (1, rows, nh, n, pdim), 2)}


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
    (new conv state, new ssm state, y (B, T, heads x P) in fp32)."""
    b, t, _ = xc.shape
    hh, pdim, n = dt.shape[-1], cfg.ssm_head_dim, cfg.ssm_state
    xc, conv_state = _causal_conv(
        xc.to(torch.float32), p["conv_w"], p["conv_b"], st.get("conv")
    )
    xc = F.silu(xc)

    dt = F.softplus(dt.to(torch.float32) + p["dt_bias"])  # (B,T,H)
    a = torch.exp(-dt * torch.exp(p["a_log"]))  # (B,T,H) in (0,1)
    xh = xc.reshape(b, t, hh, pdim)
    s0 = st.get("ssm")
    if s0 is None:
        s0 = torch.zeros((b, hh, n, pdim), dtype=torch.float32, device=xc.device)
    S, y = _ssm_scan(
        (xh, bmat.to(torch.float32), cmat.to(torch.float32), dt, a, p["d_skip"]),
        cfg,
        s0,
    )
    return conv_state, S, y.reshape(b, t, hh * pdim)


def mamba2_fwd(p, x: torch.Tensor, cfg: ArchConfig, state: dict | None = None,
               emit_state: bool = False):
    """state: {"conv": (B, K-1, d_in), "ssm": (B, H, N, P)}, this rank's
    parts under active rules (:func:`state_cuts`)."""
    heads = head_cut(cfg)
    if heads is None:
        return _whole_fwd(p, x, cfg, state, emit_state)
    h = SH.copy_to(rmsnorm(p["norm"], x, cfg.norm_eps), SH.group_of(heads))
    z, xc, bmat, cmat, dt = _in_proj(p["w_in"], h, cfg, heads)
    conv_state, S, y = _conv_scan(p, xc, bmat, cmat, dt, state or {}, cfg)
    y = _local_norm(p["out_norm"], y.to(x.dtype), cfg, heads) * F.silu(z)
    x = x + SH.reduce_from(qeinsum("bte,ed->btd", y, p["w_out"]), SH.group_of(heads))
    if emit_state:
        return x, {"conv": conv_state, "ssm": S}
    return x, None


def _whole_fwd(p, x: torch.Tensor, cfg: ArchConfig, state: dict | None, emit_state: bool):
    """The block run whole on every rank (no rules, or heads the axis does
    not divide): cut leaves gathered at use, a cut state part gathered on
    entry and this rank's part kept on exit."""
    d_in, nh, _, n = _dims(cfg)
    specs = mamba2_specs(cfg)
    p = {**p, **{k: SH.gather_dim(p[k], SH.dim_cut(specs[k].logical, specs[k].shape, dim), dim)
                 for k, dim in GATHERED.items()}}
    cuts = state_cuts(cfg)
    dims = {"conv": 2, "ssm": 1}  # the dimension each state part is cut on
    st = {k: SH.gather_dim(v, cuts[k], dims[k]) for k, v in (state or {}).items()}
    h = rmsnorm(p["norm"], x, cfg.norm_eps)
    proj = qeinsum("btd,de->bte", h, p["w_in"])
    z, xc, bmat, cmat, dt = torch.split(proj, [d_in, d_in, n, n, nh], dim=-1)
    conv_state, S, y = _conv_scan(p, xc, bmat, cmat, dt, st, cfg)
    y = rmsnorm(p["out_norm"], y.to(x.dtype), cfg.norm_eps) * F.silu(z)
    out = qeinsum("bte,ed->btd", y, p["w_out"])
    x = x + out
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
        "conv": ((batch, cfg.conv_kernel - 1, d_in // conv), torch.float32),
        "ssm": ((batch, nh // ssm, n, pdim), torch.float32),
    }
