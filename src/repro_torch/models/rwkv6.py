"""RWKV6 "Finch" block (arXiv:2404.05892): attention-free time-mix with
data-dependent per-channel decay + channel-mix FFN.

Counterpart of ``repro/models/rwkv6.py``, with its simplifications:

* data-dependent decay w_t = exp(-exp(w0 + lora_w(x'_t))), its parameters
  fp32;
* token-shift interpolation with the learned static mix (mu) per
  projection (the dynamic LoRA mix only on the decay path);
* the WKV recurrence over time, state (B, H, N, N) with N = head_dim: the
  reference's ``lax.scan`` is a Python loop over steps here, so decode
  carries that state, O(1) in context.  Each step is a few small launches
  on the card (a host-launch cost, recorded, not optimised here);
* the wkv output normalised per head (a GroupNorm over heads).

Tensor parallelism (under active rules; ``sharding.dim_cut`` names the
cuts).  Time mix, where ``"heads"`` cuts ``wr``/``wk``/``wv``/``wg`` on
whole heads: column-parallel, each mixed input entering through
``copy_to``; the decay ``w`` is computed whole from its whole LoRA, ``w0``
and ``mu_w`` and enters through ``copy_to`` before this rank takes its
heads' columns, as do the whole ``u`` and ``ln_x`` (so their gradients are
summed over the group, and every rank steps the same leaf); the wkv
state, its per-head norm and the gate are local; ``wo`` is row-parallel
(``reduce_from``).  Where the cut falls inside heads, ``wr``/``wk``/
``wv``/``wg``/``wo`` are gathered at use and the time mix runs whole.
Channel mix: ``cm_k`` column-parallel over ``"mlp"`` and ``cm_v``
row-parallel (``reduce_from``); ``cm_r`` column-parallel over
``"heads"``, its gate gathered whole (``gather_dim``) to multiply the
whole ``cv``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed import sharding as SH
from repro_torch.models.layers import PSpec, qeinsum, rmsnorm, rmsnorm_specs, torch_dtype


def rwkv6_specs(cfg: ArchConfig) -> dict:
    d, f, r = cfg.d_model, cfg.d_ff, cfg.rwkv_lora_rank

    def mix():
        return PSpec((d,), ("embed",), init="zeros", dtype="float32")

    return {
        "tm_norm": rmsnorm_specs(d),
        "mu_r": mix(), "mu_k": mix(), "mu_v": mix(), "mu_g": mix(), "mu_w": mix(),
        "w0": PSpec((d,), ("embed",), init="zeros", dtype="float32"),
        "w_lora_a": PSpec((d, r), ("embed", None), dtype="float32"),
        "w_lora_b": PSpec((r, d), (None, "embed"), dtype="float32", init="zeros"),
        "wr": PSpec((d, d), ("embed", "heads")),
        "wk": PSpec((d, d), ("embed", "heads")),
        "wv": PSpec((d, d), ("embed", "heads")),
        "wg": PSpec((d, d), ("embed", "heads")),
        "wo": PSpec((d, d), ("heads", "embed")),
        "u": PSpec((d,), ("embed",), init="zeros", dtype="float32"),  # bonus
        "ln_x": rmsnorm_specs(d),
        "cm_norm": rmsnorm_specs(d),
        "cm_mu_k": mix(), "cm_mu_r": mix(),
        "cm_k": PSpec((d, f), ("embed", "mlp")),
        "cm_v": PSpec((f, d), ("mlp", "embed")),
        "cm_r": PSpec((d, d), ("embed", "heads")),
    }


def rwkv6_cuts(cfg: ArchConfig) -> dict:
    """The block's cuts: ``"tm"`` the time mix's heads where the cut of
    ``"heads"`` falls on whole heads, ``"tm_gather"`` where it does not
    (the time mix's matrices are gathered at use), ``"mlp"`` the channel
    mix's hidden dimension, ``"r"`` ``cm_r``'s output columns."""
    s = rwkv6_specs(cfg)
    heads = SH.dim_cut(s["wr"].logical, s["wr"].shape, 1)
    whole_heads = heads is not None and (cfg.d_model // cfg.rwkv_head_dim) % heads.size == 0
    return {"tm": heads if whole_heads else None,
            "tm_gather": None if whole_heads else heads,
            "mlp": SH.dim_cut(s["cm_k"].logical, s["cm_k"].shape, 1),
            "r": SH.dim_cut(s["cm_r"].logical, s["cm_r"].shape, 1)}


def _shift(x: torch.Tensor, prev: torch.Tensor | None = None) -> torch.Tensor:
    """Token shift: x_{t-1} (zeros / carried state at t=0)."""
    if prev is None:
        prev = torch.zeros_like(x[:, :1])
    return torch.cat([prev, x[:, :-1]], dim=1)


def _mix(x, xs, mu):
    return x + (xs - x) * mu.to(x.dtype)


def _wkv_scan(r, k, v, w, u, state0):
    """WKV recurrence.  r,k,v,w: (B, T, H, N); state: (B, H, N, N).

    S_t = diag(w_t) S_{t-1} + k_t^T v_t
    o_t = r_t (S_{t-1} + diag(u) k_t^T v_t)        (current-token bonus u)
    """
    S = state0
    outs = []
    for t in range(r.shape[1]):
        rt, kt, vt, wt = r[:, t], k[:, t], v[:, t], w[:, t]  # (B, H, N)
        kv = torch.einsum("bhk,bhv->bhkv", kt, vt)
        outs.append(torch.einsum("bhk,bhkv->bhv", rt, S + u[None, :, :, None] * kv))
        S = wt[..., None] * S + kv
    return S, torch.stack(outs, dim=1)  # (B, T, H, N)


def rwkv6_fwd(p, x: torch.Tensor, cfg: ArchConfig, state: dict | None = None,
              emit_state: bool = False):
    """Full-sequence RWKV6 block.  state (decode/prefill carry):
    {"tm_shift": (B,1,D), "wkv": (B,H,N,N), "cm_shift": (B,1,D)}."""
    b, t, d = x.shape
    n = cfg.rwkv_head_dim
    cuts = rwkv6_cuts(cfg)
    tm, tg = cuts["tm"], cuts["tm_gather"]
    g_tm = SH.group_of(tm)
    dl = d // tm.size if tm else d  # this rank's columns: whole heads
    cols = tm.part(d) if tm else slice(None)
    hh = dl // n
    st = state or {}
    wr, wk, wv, wg = (SH.gather_dim(p[k], tg, 1) for k in ("wr", "wk", "wv", "wg"))

    # ---- time mix ----
    h = rmsnorm(p["tm_norm"], x, cfg.norm_eps)
    hs = _shift(h, st.get("tm_shift"))
    r = qeinsum("btd,de->bte", SH.copy_to(_mix(h, hs, p["mu_r"]), g_tm), wr)
    k = qeinsum("btd,de->bte", SH.copy_to(_mix(h, hs, p["mu_k"]), g_tm), wk)
    v = qeinsum("btd,de->bte", SH.copy_to(_mix(h, hs, p["mu_v"]), g_tm), wv)
    g = F.silu(qeinsum("btd,de->bte", SH.copy_to(_mix(h, hs, p["mu_g"]), g_tm), wg))
    # data-dependent decay (Finch): w = exp(-exp(w0 + lora(mix_w)))
    xw = _mix(h, hs, p["mu_w"]).to(torch.float32)
    dlog = p["w0"] + torch.tanh(xw @ p["w_lora_a"]) @ p["w_lora_b"]
    w = torch.exp(-torch.exp(torch.clamp(dlog, -8.0, 4.0)))  # (B, T, D) in (0,1)
    w = SH.copy_to(w, g_tm)[..., cols]

    shape4 = (b, t, hh, n)
    rr, kk, vv, ww = (z.to(torch.float32).reshape(shape4) for z in (r, k, v, w))
    u = SH.copy_to(p["u"], g_tm)[cols].reshape(hh, n)
    s0 = st.get("wkv")
    if s0 is None:
        s0 = torch.zeros((b, hh, n, n), dtype=torch.float32, device=x.device)
    S, wkv = _wkv_scan(rr, kk, vv, ww, u, s0)
    var = torch.mean(torch.square(wkv), dim=-1, keepdim=True)
    wkv = wkv * torch.rsqrt(var + cfg.norm_eps)
    out = (wkv.reshape(b, t, dl) * SH.copy_to(p["ln_x"]["scale"], g_tm)[cols]).to(x.dtype) * g
    x = x + SH.reduce_from(qeinsum("btd,de->bte", out, SH.gather_dim(p["wo"], tg, 0)), g_tm)

    # ---- channel mix ----
    g_mlp, r_cut = SH.group_of(cuts["mlp"]), cuts["r"]
    c = rmsnorm(p["cm_norm"], x, cfg.norm_eps)
    cs = _shift(c, st.get("cm_shift"))
    ck = torch.square(F.relu(qeinsum("btd,df->btf", SH.copy_to(_mix(c, cs, p["cm_mu_k"]), g_mlp),
                                     p["cm_k"])))
    cv = SH.reduce_from(qeinsum("btf,fd->btd", ck, p["cm_v"]), g_mlp)
    cr = torch.sigmoid(qeinsum("btd,de->bte", SH.copy_to(_mix(c, cs, p["cm_mu_r"]),
                                                         SH.group_of(r_cut)), p["cm_r"]))
    x = x + SH.gather_dim(cr, r_cut, -1) * cv

    if emit_state:
        new_state = {"tm_shift": h[:, -1:], "wkv": S, "cm_shift": c[:, -1:]}
        return x, new_state
    return x, None


def rwkv6_decode(p, x: torch.Tensor, state: dict, cfg: ArchConfig):
    """Single-token step: same math with T=1 (the loop runs once)."""
    return rwkv6_fwd(p, x, cfg, state=state, emit_state=True)


def rwkv6_state_shapes(cfg: ArchConfig, batch: int) -> dict:
    """``(shape, dtype)`` of each decode-state tensor (under active rules
    this rank's: the wkv state's heads where the time mix is cut)."""
    d = cfg.d_model
    n = cfg.rwkv_head_dim
    act = torch_dtype(cfg.act_dtype)
    tm = rwkv6_cuts(cfg)["tm"]
    return {
        "tm_shift": ((batch, 1, d), act),
        "wkv": ((batch, d // n // (tm.size if tm else 1), n, n), torch.float32),
        "cm_shift": ((batch, 1, d), act),
    }
