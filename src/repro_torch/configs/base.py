"""ArchConfig: the selectable architecture description consumed by
``repro_torch.models.transformer`` and the LM server (``--arch <id>``).

The port's own copy of ``repro/configs/base.py``, field for field, so that a
config compares equal with the reference's.  Some fields only steer the
reference's XLA program and change no value here: ``remat`` (each group
recomputed in the backward pass, ``torch.utils.checkpoint``),
``stack_mode`` (``"scan"`` and ``"unroll"`` are one loop over the stacked
groups in the port), ``unroll_attn`` (the KV-chunk loop is a Python loop
either way) and ``sharded_embed_gather`` (a vocab-cut table always takes the
masked lookup and a whole one the plain gather, whose results are equal).
``moe_impl="a2a"`` picks the expert-parallel MoE, which runs collectives
when sharding rules over several ranks are active."""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int

    # layer pattern, cycled over the depth; kinds:
    #   "attn"        full-attention block
    #   "local"       sliding-window attention block (cfg.window)
    #   "moe"         attention + MoE FFN block
    #   "mamba2"      Mamba2 SSM block
    #   "rwkv6"       RWKV6 (time-mix + channel-mix) block
    #   "shared_attn" attention block with weights shared across occurrences
    pattern: tuple[str, ...] = ("attn",)
    window: Optional[int] = None

    # MoE
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25

    # MLP
    mlp_kind: str = "swiglu"  # swiglu | geglu | gelu

    # SSM (mamba2 blocks)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    conv_kernel: int = 4

    # rwkv6 blocks use d_model/64 heads internally
    rwkv_head_dim: int = 64
    rwkv_lora_rank: int = 64

    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    causal: bool = True
    tie_embeddings: bool = False
    scale_embed: bool = False  # gemma-style sqrt(d) embedding scale

    # modality frontend stub: None | "audio_frames" | "vision_patches"
    frontend: Optional[str] = None
    frontend_dim: int = 0
    n_patches: int = 0  # vlm: image patches prepended to the text sequence

    # numerics / execution
    param_dtype: str = "bfloat16"
    act_dtype: str = "bfloat16"
    remat: bool = True
    stack_mode: str = "scan"  # "scan" (sequential shared datapath) | "unroll"
    unroll_attn: bool = False  # unroll KV-chunk loop (dry-run cost accounting)
    sharded_embed_gather: bool = False  # vocab-parallel gather (hillclimb)
    moe_impl: str = "dense"  # "dense" (capacity scatter) | "a2a" (shard_map all-to-all)

    # notes recorded in DESIGN/EXPERIMENTS (applicability, skips)
    notes: str = ""
    source: str = ""

    def __post_init__(self):
        assert self.n_layers % len(self.pattern) == 0, (
            f"{self.name}: n_layers={self.n_layers} not a multiple of "
            f"pattern={self.pattern}"
        )

    @property
    def n_groups(self) -> int:
        return self.n_layers // len(self.pattern)

    @property
    def is_encoder(self) -> bool:
        return not self.causal

    @property
    def attends(self) -> bool:
        return any(k in ("attn", "local", "moe", "shared_attn") for k in self.pattern)

    @property
    def subquadratic(self) -> bool:
        """True if decode over very long context is feasible (no full-attn
        layer with unbounded KV, or SSM/linear-attn)."""
        kinds = set(self.pattern)
        if kinds <= {"mamba2", "rwkv6"}:
            return True
        if "attn" in kinds or "moe" in kinds:
            return False
        # local-only or hybrid-with-attention: local windows are bounded;
        # shared_attn/global layers have unbounded KV but decode cost is
        # linear -> runnable; we treat archs with *any* full-attn layer as
        # runnable iff they also have sub-quadratic layers (gemma3, danube,
        # zamba2 per assignment).
        return True

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)

    def smoke(self) -> "ArchConfig":
        """Reduced same-family config for CPU smoke tests."""
        period = len(self.pattern)
        shrink = {
            "n_layers": 2 * period,
            "d_model": 64,
            "n_heads": 4,
            "n_kv_heads": max(1, min(self.n_kv_heads, 2) if self.n_kv_heads < self.n_heads else 4),
            "head_dim": 16,
            "d_ff": 96,
            "vocab": 256,
            "window": min(self.window, 16) if self.window else None,
            "n_experts": min(self.n_experts, 4) if self.n_experts else 0,
            "top_k": min(self.top_k, 2) if self.top_k else 0,
            "ssm_state": min(self.ssm_state, 8) if self.ssm_state else 0,
            "ssm_head_dim": 8,
            "rwkv_head_dim": 16,
            "rwkv_lora_rank": 8,
            "frontend_dim": 32 if self.frontend else 0,
            "n_patches": 4 if self.n_patches else 0,
            "param_dtype": "float32",
            "act_dtype": "float32",
            "remat": False,
        }
        return self.replace(**shrink)


# model-parameter counting (feeds MODEL_FLOPS = 6*N*D roofline term)
def param_counts(cfg: ArchConfig) -> dict[str, int]:
    d, ff, v = cfg.d_model, cfg.d_ff, cfg.vocab
    qkv = d * cfg.n_heads * cfg.head_dim + 2 * d * cfg.n_kv_heads * cfg.head_dim
    att = qkv + cfg.n_heads * cfg.head_dim * d
    mlp = {"swiglu": 3, "geglu": 3, "gelu": 2}[cfg.mlp_kind] * d * ff
    per_kind = {}
    counts = {"embed": v * d, "head": 0 if cfg.tie_embeddings else d * v}
    n_shared_attn = 0
    for kind in cfg.pattern:
        if kind in ("attn", "local"):
            per_kind[kind] = att + mlp
        elif kind == "moe":
            per_kind[kind] = att + cfg.n_experts * mlp + d * cfg.n_experts
        elif kind == "shared_attn":
            n_shared_attn += 1
            per_kind[kind] = att + mlp  # counted once below
        elif kind == "mamba2":
            d_in = cfg.ssm_expand * d
            nh = d_in // cfg.ssm_head_dim
            per_kind[kind] = (
                d * (2 * d_in + 2 * cfg.ssm_state + nh) + d_in * d + d_in * cfg.conv_kernel
            )
        elif kind == "rwkv6":
            lora = cfg.rwkv_lora_rank
            # time-mix r/k/v/g/o (5 d^2) + decay/mix LoRAs + channel-mix
            per_kind[kind] = 6 * d * d + 12 * d * lora + 2 * d * ff
    total = counts["embed"] + counts["head"]
    for kind in cfg.pattern:
        if kind == "shared_attn":
            continue
        total += per_kind[kind] * cfg.n_groups
    if n_shared_attn:
        total += per_kind["shared_attn"]  # one shared instance
    active = total
    if cfg.n_experts:
        moe_n = sum(1 for k in cfg.pattern if k == "moe") * cfg.n_groups
        active = total - moe_n * (cfg.n_experts - cfg.top_k) * mlp
    return {"total": total, "active": active}
