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

Tensor parallelism: the block runs whole on every rank.  Under active
rules its ``"ssm_heads"`` leaves are held as this rank's part (so the
params and their Adam moments are cut), and ``w_in``, ``conv_w``,
``conv_b``, ``a_log``, ``d_skip``, ``dt_bias`` and ``w_out`` are gathered
at use (``sharding.gather_dim``; the backward keeps this rank's part of
the gradient every rank computes whole).  ``w_in``'s columns are the fused
``[z, x, B, C, dt]`` segments, which a contiguous cut does not follow, and
``out_norm`` normalises over all of ``d_in``, so the block does not split.
Its decode state is whole.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed import sharding as SH
from repro_torch.models.layers import PSpec, qeinsum, rmsnorm, rmsnorm_specs

#: the cut leaves gathered at use, and the dimension each is cut on
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


def mamba2_fwd(p, x: torch.Tensor, cfg: ArchConfig, state: dict | None = None,
               emit_state: bool = False):
    """state: {"conv": (B, K-1, d_in), "ssm": (B, H, N, P)}."""
    b, t, d = x.shape
    d_in, nh, pdim, n = _dims(cfg)
    st = state or {}
    specs = mamba2_specs(cfg)
    p = {**p, **{k: SH.gather_dim(p[k], SH.dim_cut(specs[k].logical, specs[k].shape, dim), dim)
                 for k, dim in GATHERED.items()}}
    h = rmsnorm(p["norm"], x, cfg.norm_eps)
    proj = qeinsum("btd,de->bte", h, p["w_in"])
    z, xc, bmat, cmat, dt = torch.split(proj, [d_in, d_in, n, n, nh], dim=-1)
    xc, conv_state = _causal_conv(
        xc.to(torch.float32), p["conv_w"], p["conv_b"], st.get("conv")
    )
    xc = F.silu(xc)

    dt = F.softplus(dt.to(torch.float32) + p["dt_bias"])  # (B,T,H)
    a = torch.exp(-dt * torch.exp(p["a_log"]))  # (B,T,H) in (0,1)
    xh = xc.reshape(b, t, nh, pdim)
    s0 = st.get("ssm")
    if s0 is None:
        s0 = torch.zeros((b, nh, n, pdim), dtype=torch.float32, device=x.device)
    S, y = _ssm_scan(
        (xh, bmat.to(torch.float32), cmat.to(torch.float32), dt, a, p["d_skip"]),
        cfg,
        s0,
    )
    y = y.reshape(b, t, d_in).to(x.dtype)
    y = rmsnorm(p["out_norm"], y, cfg.norm_eps) * F.silu(z)
    out = qeinsum("bte,ed->btd", y, p["w_out"])
    x = x + out
    if emit_state:
        return x, {"conv": conv_state, "ssm": S}
    return x, None


def mamba2_decode(p, x: torch.Tensor, state: dict, cfg: ArchConfig):
    return mamba2_fwd(p, x, cfg, state=state, emit_state=True)


def mamba2_state_shapes(cfg: ArchConfig, batch: int) -> dict:
    """``(shape, dtype)`` of each decode-state tensor."""
    d_in, nh, pdim, n = _dims(cfg)
    return {
        "conv": ((batch, cfg.conv_kernel - 1, d_in), torch.float32),
        "ssm": ((batch, nh, n, pdim), torch.float32),
    }
