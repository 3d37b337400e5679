"""phi3.5-moe-42b-a6.6b — 32L d4096 32H (GQA kv=8) d_ff=6400, MoE 16e top-2.
[hf:microsoft/Phi-3.5-MoE-instruct; hf]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="phi3.5-moe-42b-a6.6b",
    family="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=6400,
    vocab=32064,
    pattern=("moe",),
    n_experts=16,
    top_k=2,
    mlp_kind="swiglu",
    rope_theta=10_000.0,
    source="hf:microsoft/Phi-3.5-MoE-instruct",
    notes=(
        "Full attention in every layer -> long_500k skipped (needs "
        "sub-quadratic attention).  Router pinned high-precision by the "
        "sensitivity policy; experts are the prime int8/pruning targets."
    ),
)
