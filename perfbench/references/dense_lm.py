"""The plain reference of a dense decoder-only LM: Phi-3-style blocks (the
port's ``phi4_mini`` ArchConfig).

Plain PyTorch in float32 with TF32 off, written from the model's equations;
it imports nothing of the port and takes nothing the port made.  No cache
and no batching tricks: one full causal forward over each sequence, layer
by layer, every position at its index in the sequence.

The equations, for hidden size ``d``, ``H`` query heads and ``G`` key/value
heads of ``dh = d / H``, a configuration in Hugging Face's keys:

* ``x = E[token]``, the embedding table ``E`` (vocab, d);
* each of ``num_hidden_layers`` blocks, pre-norm with residuals:
  ``x += Attn(rms(x) * g1)``, ``x += W_o2 (silu(W_gate h) * (W_up h))`` with
  ``h = rms(x) * g2``, where ``rms(x) = x / sqrt(mean(x^2) + rms_norm_eps)``;
* ``Attn``: ``q = h W_q``, ``k = h W_k``, ``v = h W_v``; RoPE on ``q`` and
  ``k`` over every head dimension (pairs ``(i, i + dh/2)`` rotated by
  ``pos * rope_theta^(-i / (dh/2))``); query head ``j`` reads key/value
  head ``j // (H / G)``; causal softmax of ``q k^T / sqrt(dh)``; the heads'
  outputs through ``W_o``;
* a final ``rms(x) * g``, and logits ``x E^T`` (tied embeddings).

Departures from the published Phi-4-mini that the port's configuration
makes and this reference follows: RoPE over every head dimension (the
published ``partial_rotary_factor`` is 0.75) and no LongRoPE scaling;
:func:`port_fields` refuses a configuration that states either.

``fp8=True`` computes every product with a weight (the projections, the
MLP and the unembed) one precision below the bf16 the configuration serves
in: both operands rounded to float8 e4m3 (:func:`_fp8`: a scale per
weight column and per activation row, amax to e4m3's largest value),
their products summed in float32.  That is the control, put in the
program's place.
"""
from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

from perfbench import lm_weights

#: query positions whose attention is computed at once (bounds the scores)
QUERY_BLOCK = 1024
#: the largest finite float8 e4m3 value
FP8_MAX = 448.0


def _dims(conf: dict) -> tuple[int, int, int, int, int]:
    d, h, g = conf["hidden_size"], conf["num_attention_heads"], conf["num_key_value_heads"]
    return d, h, g, d // h, conf["intermediate_size"]


def port_fields(conf: dict) -> dict:
    """The port's ``ArchConfig`` fields that the configuration sets."""
    if conf.get("partial_rotary_factor", 1.0) != 1.0 or conf.get("rope_scaling") is not None:
        raise ValueError("the port rotates every head dimension with no RoPE scaling: "
                         "partial_rotary_factor must be 1.0 and rope_scaling null")
    if conf["hidden_act"] != "silu" or not conf["tie_word_embeddings"]:
        raise ValueError("a dense_lm configuration has SwiGLU blocks and tied embeddings")
    d, h, g, dh, ff = _dims(conf)
    return {"n_layers": conf["num_hidden_layers"], "d_model": d, "n_heads": h,
            "n_kv_heads": g, "head_dim": dh, "d_ff": ff, "vocab": conf["vocab_size"],
            "pattern": ("attn",), "mlp_kind": "swiglu", "rope_theta": float(conf["rope_theta"]),
            "norm_eps": float(conf["rms_norm_eps"]), "tie_embeddings": True,
            "param_dtype": conf["torch_dtype"], "act_dtype": conf["torch_dtype"]}


def pattern(conf: dict) -> tuple[str, ...]:
    return ("attn",)


def global_leaves(conf: dict) -> dict:
    d = conf["hidden_size"]
    return {"embed/tok": ((conf["vocab_size"], d), "normal"),
            "final_norm/scale": ((d,), "ones")}


def layer_leaves(conf: dict, kind: str) -> dict:
    d, h, g, dh, ff = _dims(conf)
    return {
        "attn/norm/scale": ((d,), "ones"),
        "attn/wq": ((d, h, dh), "normal"),
        "attn/wk": ((d, g, dh), "normal"),
        "attn/wv": ((d, g, dh), "normal"),
        "attn/wo": ((h, dh, d), "normal"),
        "mlp/norm/scale": ((d,), "ones"),
        "mlp/wi_gate": ((d, ff), "normal"),
        "mlp/wi_up": ((d, ff), "normal"),
        "mlp/wo": ((ff, d), "normal"),
    }


def cost_terms(conf: dict) -> dict:
    """What a decode step must touch beyond the weights, by the equations:
    each position's keys and values in every layer (one slot, bytes in the
    served type), and each position's attention FLOPs for one token (its
    score and its weighted value, every query head, every layer)."""
    d, h, g, dh, _ = _dims(conf)
    layers = conf["num_hidden_layers"]
    size = lm_weights.DTYPES[conf["torch_dtype"]].itemsize
    return {"kv_bytes_per_position": layers * 2 * g * dh * size,
            "state_bytes_per_slot": 0,
            "attn_flops_per_position": layers * 4 * h * dh}


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


def _rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (S, heads, dh) at positions 0..S-1."""
    s, _, dh = x.shape
    half = dh // 2
    inv = theta ** (-torch.arange(half, dtype=torch.float64, device=x.device) / half)
    ang = torch.arange(s, dtype=torch.float64, device=x.device)[:, None] * inv
    cos, sin = torch.cos(ang).float()[:, None, :], torch.sin(ang).float()[:, None, :]
    a, b = x[..., :half], x[..., half:]
    return torch.cat([a * cos - b * sin, b * cos + a * sin], dim=-1)


def _attention(q, k, v) -> torch.Tensor:
    """One sequence: q (S, H, dh), k and v (S, G, dh) -> (S, H * dh)."""
    s, h, dh = q.shape
    rep = h // k.shape[1]
    k, v = k.repeat_interleave(rep, dim=1), v.repeat_interleave(rep, dim=1)
    out = torch.empty_like(q)
    for lo in range(0, s, QUERY_BLOCK):
        hi = min(s, lo + QUERY_BLOCK)
        scores = torch.einsum("qhd,khd->hqk", q[lo:hi], k[:hi]) / math.sqrt(dh)
        causal = torch.arange(hi, device=q.device)[None, :] <= torch.arange(lo, hi,
                                                                          device=q.device)[:, None]
        scores = scores.masked_fill(~causal, float("-inf"))
        out[lo:hi] = torch.einsum("hqk,khd->qhd", torch.softmax(scores, dim=-1), v[:hi])
    return out.reshape(s, h * dh)


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
    d, h, g, dh, _ = _dims(conf)
    eps, theta = float(conf["rms_norm_eps"]), float(conf["rope_theta"])
    f32 = lambda t: t.to(torch.float32)
    with _no_tf32():
        x = f32(weights["embed/tok"][tokens])
        for l in range(conf["num_hidden_layers"]):
            _, w = lm_weights.layer(weights, pattern(conf), l)
            w = {k: f32(v) for k, v in w.items()}
            a = _rms(x, w["attn/norm/scale"], eps)
            q = _matmul(a, w["attn/wq"].reshape(d, h * dh), fp8)
            k = _matmul(a, w["attn/wk"].reshape(d, g * dh), fp8)
            v = _matmul(a, w["attn/wv"].reshape(d, g * dh), fp8)
            att = torch.stack([
                _attention(_rope(q[n].reshape(-1, h, dh), theta),
                           _rope(k[n].reshape(-1, g, dh), theta), v[n].reshape(-1, g, dh))
                for n in range(x.shape[0])])
            x = x + _matmul(att, w["attn/wo"].reshape(h * dh, d), fp8)
            m = _rms(x, w["mlp/norm/scale"], eps)
            gate = F.silu(_matmul(m, w["mlp/wi_gate"], fp8)) * _matmul(m, w["mlp/wi_up"], fp8)
            x = x + _matmul(gate, w["mlp/wo"], fp8)
        return _rms(x[:, first:], f32(weights["final_norm/scale"]), eps)


def unembed(weights: dict, conf: dict, *, fp8: bool = False):
    """The tied unembed: a function of final hidden states ``h`` (..., d) to
    their float32 logits (..., vocab), holding the table widened once."""
    table = weights["embed/tok"].to(torch.float32).T
    if fp8:
        table = _fp8(table, 0)

    @torch.no_grad()
    def logits(h: torch.Tensor) -> torch.Tensor:
        with _no_tf32():
            return (_fp8(h, -1) if fp8 else h) @ table

    return logits
