"""olmoe-1b-7b — 16L d2048 16H (kv=16) d_ff=1024, MoE 64e top-8.
[arXiv:2409.02060; hf]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="olmoe-1b-7b",
    family="moe",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=1024,
    vocab=50304,
    pattern=("moe",),
    n_experts=64,
    top_k=8,
    mlp_kind="swiglu",
    rope_theta=10_000.0,
    source="arXiv:2409.02060",
    notes=(
        "64-expert fine-grained MoE: dispatch/all-to-all dominates -> the "
        "collective-bound hillclimb candidate.  Full attention -> long_500k "
        "skipped."
    ),
)
