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
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
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
    hh = d // n
    st = state or {}

    # ---- time mix ----
    h = rmsnorm(p["tm_norm"], x, cfg.norm_eps)
    hs = _shift(h, st.get("tm_shift"))
    r = qeinsum("btd,de->bte", _mix(h, hs, p["mu_r"]), p["wr"])
    k = qeinsum("btd,de->bte", _mix(h, hs, p["mu_k"]), p["wk"])
    v = qeinsum("btd,de->bte", _mix(h, hs, p["mu_v"]), p["wv"])
    g = F.silu(qeinsum("btd,de->bte", _mix(h, hs, p["mu_g"]), p["wg"]))
    # data-dependent decay (Finch): w = exp(-exp(w0 + lora(mix_w)))
    xw = _mix(h, hs, p["mu_w"]).to(torch.float32)
    dlog = p["w0"] + torch.tanh(xw @ p["w_lora_a"]) @ p["w_lora_b"]
    w = torch.exp(-torch.exp(torch.clamp(dlog, -8.0, 4.0)))  # (B, T, D) in (0,1)

    shape4 = (b, t, hh, n)
    rr, kk, vv, ww = (z.to(torch.float32).reshape(shape4) for z in (r, k, v, w))
    u = p["u"].reshape(hh, n)
    s0 = st.get("wkv")
    if s0 is None:
        s0 = torch.zeros((b, hh, n, n), dtype=torch.float32, device=x.device)
    S, wkv = _wkv_scan(rr, kk, vv, ww, u, s0)
    var = torch.mean(torch.square(wkv), dim=-1, keepdim=True)
    wkv = wkv * torch.rsqrt(var + cfg.norm_eps)
    out = (wkv.reshape(b, t, d) * p["ln_x"]["scale"]).to(x.dtype) * g
    x = x + qeinsum("btd,de->bte", out, p["wo"])

    # ---- channel mix ----
    c = rmsnorm(p["cm_norm"], x, cfg.norm_eps)
    cs = _shift(c, st.get("cm_shift"))
    ck = torch.square(F.relu(qeinsum("btd,df->btf", _mix(c, cs, p["cm_mu_k"]), p["cm_k"])))
    cv = qeinsum("btf,fd->btd", ck, p["cm_v"])
    cr = torch.sigmoid(qeinsum("btd,de->bte", _mix(c, cs, p["cm_mu_r"]), p["cm_r"]))
    x = x + cr * cv

    if emit_state:
        new_state = {"tm_shift": h[:, -1:], "wkv": S, "cm_shift": c[:, -1:]}
        return x, new_state
    return x, None


def rwkv6_decode(p, x: torch.Tensor, state: dict, cfg: ArchConfig):
    """Single-token step: same math with T=1 (the loop runs once)."""
    return rwkv6_fwd(p, x, cfg, state=state, emit_state=True)


def rwkv6_state_shapes(cfg: ArchConfig, batch: int) -> dict:
    """``(shape, dtype)`` of each decode-state tensor."""
    d = cfg.d_model
    n = cfg.rwkv_head_dim
    act = torch_dtype(cfg.act_dtype)
    return {
        "tm_shift": ((batch, 1, d), act),
        "wkv": ((batch, d // n, n, n), torch.float32),
        "cm_shift": ((batch, 1, d), act),
    }
