"""The plain reference of a Granite-4.0-H hybrid (Hugging Face's
``GraniteMoeHybrid`` with no experts, whose mixer is ``Mamba2Mixer``): the
port's ``granite4_h_micro`` HybridConfig.

Plain PyTorch in float32 with TF32 off, written from the model's equations;
it imports nothing of the port and takes nothing the port made.  No cache
and no batching tricks: one full causal forward over each sequence, layer
by layer, and the Mamba2 recurrence step by step over the positions, as
the equations state it (not in the chunked form the port's prefill runs).

The equations, for hidden size ``d``, a configuration in Hugging Face's
keys, ``rms(x) = x / sqrt(mean(x^2) + rms_norm_eps)``:

* ``x = embedding_multiplier * E[token]``, the table ``E`` (vocab, d);
* each of ``num_hidden_layers`` layers, its mixer by ``layer_types``:
  ``x += residual_multiplier * mixer(rms(x) * g1)``, then
  ``x += residual_multiplier * W_o (silu(W_gate h) * (W_up h))`` with
  ``h = rms(x) * g2`` (``shared_intermediate_size`` wide);
* ``"attention"``: ``q = h W_q``, ``k = h W_k``, ``v = h W_v``, no rotation
  (``position_embedding_type`` ``"nope"``); query head ``j`` reads
  key/value head ``j // (H / G)``; causal softmax of
  ``q k^T * attention_multiplier``; the heads through ``W_o``;
* ``"mamba"`` (``H = mamba_n_heads`` heads of ``P = mamba_d_head``,
  ``d_in = H P``, state ``N = mamba_d_state``, one group):
  ``[z, xBC, dt] = h W_in``; ``xBC = silu(conv(xBC) + b)``, a causal
  depthwise conv of ``mamba_d_conv`` taps over the ``d_in + 2N`` channels
  of ``[x, B, C]`` (tap ``i`` multiplies the token ``K - 1 - i`` back:
  Hugging Face's ``conv1d.weight[:, 0, i]``), split into ``x`` (H x P),
  ``B`` and ``C`` (N each); ``dt = softplus(dt + dt_bias)``,
  ``A = -exp(A_log)``; per head, from a zero state,
  ``S_t = exp(dt_t A) S_{t-1} + dt_t (x_t ⊗ B_t)`` and
  ``y_t = S_t C_t + D x_t``; ``out = W_out (rms(y * silu(z)) * g_y)``, the
  gate before the norm, the norm over all of ``d_in``;
* a final ``rms(x) * g``, and logits ``(x E^T) / logits_scaling`` (tied
  embeddings).

The leaves are named as the port's params tree names them (``mamba/...``,
``attn/...``, ``mlp/...``); the conv's weight is ``mamba/conv_w`` (K, d_in
+ 2N), tap first.  Every leaf is drawn as ``perfbench/lm_weights.py``
draws: the weight matrices, ``A_log``, ``dt_bias`` and the conv's bias are
seeded normals of std ``initializer_range``; ``D``, the norms' gains and
the conv's weights ones.  Ones make the conv a sum of four tokens, so
``x``, ``B`` and ``C`` are of order one and the recurrent state carries
about half of each mixer's output (with std-0.02 normals there it
carried a few thousandths of it, and a broken recurrence passed the
limits); the configuration lists this under ``assumed``.

``fp8=True`` computes every product with a weight matrix (the in and out
projections of the mixers and of attention, the MLP and the unembed) one
precision below the bf16 the configuration serves in: both operands
rounded to float8 e4m3 (``dense_lm._fp8``'s scheme: a scale per weight
column and per activation row), their products summed in float32.  The
depthwise conv and the recurrence stay float32.  That is the control, put
in the program's place.
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

from perfbench import lm_weights

#: query positions whose attention is computed at once (bounds the scores)
QUERY_BLOCK = 1024
#: the largest finite float8 e4m3 value
FP8_MAX = 448.0
#: ``layer_types`` -> the port's block kinds
KINDS = {"mamba": "mamba2_mlp", "attention": "attn"}


def _dims(conf: dict) -> dict:
    d, h, g = conf["hidden_size"], conf["num_attention_heads"], conf["num_key_value_heads"]
    nh, p, n = conf["mamba_n_heads"], conf["mamba_d_head"], conf["mamba_d_state"]
    return {"d": d, "h": h, "g": g, "dh": d // h, "ff": conf["shared_intermediate_size"],
            "nh": nh, "p": p, "n": n, "d_in": nh * p, "k": conf["mamba_d_conv"]}


def pattern(conf: dict) -> tuple[str, ...]:
    """The port's kinds of the shortest period of ``layer_types``."""
    types = conf["layer_types"]
    for period in range(1, len(types) + 1):
        if len(types) % period == 0 and types == types[:period] * (len(types) // period):
            return tuple(KINDS[t] for t in types[:period])
    raise AssertionError("unreachable")


def port_fields(conf: dict) -> dict:
    """The port's ``HybridConfig`` fields that the configuration sets."""
    if conf["position_embedding_type"] != "nope" or conf.get("rope_scaling") is not None:
        raise ValueError("a granite_hybrid configuration has no positional encoding")
    if conf["mamba_n_groups"] != 1 or not conf["mamba_conv_bias"] or conf["mamba_proj_bias"]:
        raise ValueError("the port's Mamba2 mixer has one group, a conv bias and no "
                         "projection bias")
    if conf["num_local_experts"] or conf["attention_bias"] or not conf["tie_word_embeddings"]:
        raise ValueError("a granite_hybrid configuration has no experts, no attention bias "
                         "and tied embeddings")
    if conf["hidden_act"] != "silu" or conf["normalization_function"] != "rmsnorm":
        raise ValueError("a granite_hybrid configuration has SwiGLU MLPs and RMS norms")
    dm = _dims(conf)
    if dm["d_in"] != conf["mamba_expand"] * dm["d"]:
        raise ValueError("mamba_n_heads x mamba_d_head must be mamba_expand x hidden_size")
    return {"n_layers": conf["num_hidden_layers"], "d_model": dm["d"], "n_heads": dm["h"],
            "n_kv_heads": dm["g"], "head_dim": dm["dh"], "d_ff": dm["ff"],
            "vocab": conf["vocab_size"], "pattern": pattern(conf), "mlp_kind": "swiglu",
            "ssm_state": dm["n"], "ssm_head_dim": dm["p"], "ssm_expand": conf["mamba_expand"],
            "conv_kernel": dm["k"], "norm_eps": float(conf["rms_norm_eps"]),
            "tie_embeddings": True, "nope": True,
            "attn_scale": float(conf["attention_multiplier"]),
            "embed_mult": float(conf["embedding_multiplier"]),
            "residual_mult": float(conf["residual_multiplier"]),
            "logits_div": float(conf["logits_scaling"]), "ssm_published": True,
            "param_dtype": conf["torch_dtype"], "act_dtype": conf["torch_dtype"]}


def global_leaves(conf: dict) -> dict:
    d = conf["hidden_size"]
    return {"embed/tok": ((conf["vocab_size"], d), "normal"),
            "final_norm/scale": ((d,), "ones")}


def layer_leaves(conf: dict, kind: str) -> dict:
    dm = _dims(conf)
    d, h, g, dh, ff = dm["d"], dm["h"], dm["g"], dm["dh"], dm["ff"]
    mlp = {"mlp/norm/scale": ((d,), "ones"), "mlp/wi_gate": ((d, ff), "normal"),
           "mlp/wi_up": ((d, ff), "normal"), "mlp/wo": ((ff, d), "normal")}
    if kind == "attn":
        return {"attn/norm/scale": ((d,), "ones"), "attn/wq": ((d, h, dh), "normal"),
                "attn/wk": ((d, g, dh), "normal"), "attn/wv": ((d, g, dh), "normal"),
                "attn/wo": ((h, dh, d), "normal"), **mlp}
    nh, n, d_in, k = dm["nh"], dm["n"], dm["d_in"], dm["k"]
    conv = d_in + 2 * n
    return {"mamba/norm/scale": ((d,), "ones"),
            "mamba/w_in": ((d, 2 * d_in + 2 * n + nh), "normal"),
            "mamba/conv_w": ((k, conv), "ones"), "mamba/conv_b": ((conv,), "normal"),
            "mamba/a_log": ((nh,), "normal"), "mamba/d_skip": ((nh,), "ones"),
            "mamba/dt_bias": ((nh,), "normal"), "mamba/out_norm/scale": ((d_in,), "ones"),
            "mamba/w_out": ((d_in, d), "normal"), **mlp}


def cost_terms(conf: dict) -> dict:
    """What a decode step must touch beyond the weights, by the equations:
    each position's keys and values in every attention layer (one slot,
    bytes in the served type), each mixer's float32 state read and written
    (its ``H x N x P`` recurrence and the conv's last ``K - 1`` inputs of
    its ``d_in + 2N`` channels), and each position's attention FLOPs for
    one token (its score and its weighted value, every query head)."""
    dm = _dims(conf)
    kinds = [KINDS[t] for t in conf["layer_types"]]
    attn, mixers = kinds.count("attn"), kinds.count("mamba2_mlp")
    size = lm_weights.DTYPES[conf["torch_dtype"]].itemsize
    state = 4 * (dm["nh"] * dm["n"] * dm["p"] + (dm["k"] - 1) * (dm["d_in"] + 2 * dm["n"]))
    return {"kv_bytes_per_position": attn * 2 * dm["g"] * dm["dh"] * size,
            "state_bytes_per_slot": mixers * state,
            "attn_flops_per_position": attn * 4 * dm["h"] * dm["dh"]}


def _fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 and back, one scale for each slice along
    ``dim`` (its amax at :data:`FP8_MAX`)."""
    scale = x.abs().amax(dim=dim, keepdim=True).clamp_min(1e-30) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def _matmul(a: torch.Tensor, w: torch.Tensor, fp8: bool) -> torch.Tensor:
    """``a`` (..., k) times ``w`` (k, n), in float32 or, with ``fp8``, on
    operands rounded to e4m3 (a scale per row of ``a``, per column of ``w``)."""
    return _fp8(a, -1) @ _fp8(w, 0) if fp8 else a @ w


def _rms(x: torch.Tensor, g: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + eps) * g


def _attention(q, k, v, scale: float) -> torch.Tensor:
    """One sequence, no rotation: q (S, H, dh), k and v (S, G, dh) -> (S, H * dh)."""
    s, h, dh = q.shape
    rep = h // k.shape[1]
    k, v = k.repeat_interleave(rep, dim=1), v.repeat_interleave(rep, dim=1)
    out = torch.empty_like(q)
    for lo in range(0, s, QUERY_BLOCK):
        hi = min(s, lo + QUERY_BLOCK)
        scores = torch.einsum("qhd,khd->hqk", q[lo:hi], k[:hi]) * scale
        causal = torch.arange(hi, device=q.device)[None, :] <= torch.arange(lo, hi,
                                                                          device=q.device)[:, None]
        scores = scores.masked_fill(~causal, float("-inf"))
        out[lo:hi] = torch.einsum("hqk,khd->qhd", torch.softmax(scores, dim=-1), v[:hi])
    return out.reshape(s, h * dh)


def _mixer(h: torch.Tensor, w: dict, conf: dict, fp8: bool) -> torch.Tensor:
    """The Mamba2 mixer of the normed input ``h`` (N, S, d), step by step."""
    dm = _dims(conf)
    nh, p, n, d_in, k = dm["nh"], dm["p"], dm["n"], dm["d_in"], dm["k"]
    rows, s, _ = h.shape
    z, xbc, dt = torch.split(_matmul(h, w["mamba/w_in"], fp8), [d_in, d_in + 2 * n, nh], dim=-1)
    past = F.pad(xbc, (0, 0, k - 1, 0))  # zeros before the first token
    conv = sum(past[:, i:i + s] * w["mamba/conv_w"][i] for i in range(k)) + w["mamba/conv_b"]
    x, b, c = torch.split(F.silu(conv), [d_in, n, n], dim=-1)
    x = x.reshape(rows, s, nh, p)
    dt = F.softplus(dt + w["mamba/dt_bias"])  # (N, S, H)
    a = -torch.exp(w["mamba/a_log"])
    d_skip = w["mamba/d_skip"]
    state = torch.zeros((rows, nh, p, n), dtype=torch.float32, device=h.device)
    y = torch.empty_like(x)
    for t in range(s):
        state = (torch.exp(dt[:, t] * a)[..., None, None] * state
                 + dt[:, t, :, None, None] * x[:, t, :, :, None] * b[:, t, None, None, :])
        y[:, t] = torch.einsum("rhpn,rn->rhp", state, c[:, t]) + d_skip[:, None] * x[:, t]
    y = y.reshape(rows, s, d_in) * F.silu(z)
    return _matmul(_rms(y, w["mamba/out_norm/scale"], float(conf["rms_norm_eps"])),
                   w["mamba/w_out"], fp8)


@contextlib.contextmanager
def _no_tf32():
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


@torch.no_grad()
def hidden(weights: dict, conf: dict, tokens: torch.Tensor, first: int, *,
           fp8: bool = False) -> torch.Tensor:
    """The final normed hidden states (N, S - first, d), float32, of the
    token rows ``tokens`` (N, S) at positions ``first`` .. S-1."""
    dm = _dims(conf)
    d, h, g, dh = dm["d"], dm["h"], dm["g"], dm["dh"]
    eps = float(conf["rms_norm_eps"])
    scale, res = float(conf["attention_multiplier"]), float(conf["residual_multiplier"])
    f32 = lambda t: t.to(torch.float32)
    with _no_tf32():
        x = f32(weights["embed/tok"][tokens]) * float(conf["embedding_multiplier"])
        for l in range(conf["num_hidden_layers"]):
            kind, w = lm_weights.layer(weights, pattern(conf), l)
            w = {key: f32(v) for key, v in w.items()}
            if kind == "attn":
                a = _rms(x, w["attn/norm/scale"], eps)
                q = _matmul(a, w["attn/wq"].reshape(d, h * dh), fp8)
                k = _matmul(a, w["attn/wk"].reshape(d, g * dh), fp8)
                v = _matmul(a, w["attn/wv"].reshape(d, g * dh), fp8)
                att = torch.stack([
                    _attention(q[r].reshape(-1, h, dh), k[r].reshape(-1, g, dh),
                               v[r].reshape(-1, g, dh), scale) for r in range(x.shape[0])])
                mixed = _matmul(att, w["attn/wo"].reshape(h * dh, d), fp8)
            else:
                mixed = _mixer(_rms(x, w["mamba/norm/scale"], eps), w, conf, fp8)
            x = x + res * mixed
            m = _rms(x, w["mlp/norm/scale"], eps)
            gate = F.silu(_matmul(m, w["mlp/wi_gate"], fp8)) * _matmul(m, w["mlp/wi_up"], fp8)
            x = x + res * _matmul(gate, w["mlp/wo"], fp8)
        return _rms(x[:, first:], f32(weights["final_norm/scale"]), eps)


def unembed(weights: dict, conf: dict, *, fp8: bool = False):
    """The tied unembed over ``logits_scaling``: a function of final hidden
    states ``h`` (..., d) to their float32 logits (..., vocab), holding the
    table widened once."""
    table = weights["embed/tok"].to(torch.float32).T
    if fp8:
        table = _fp8(table, 0)
    div = float(conf["logits_scaling"])

    @torch.no_grad()
    def logits(h: torch.Tensor) -> torch.Tensor:
        with _no_tf32():
            return ((_fp8(h, -1) if fp8 else h) @ table) / div

    return logits
