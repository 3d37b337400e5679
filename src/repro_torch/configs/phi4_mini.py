"""phi4-mini-3.8b — dense 32L d3072 24H (GQA kv=8) d_ff=8192 vocab=200064.
[arXiv:2412.08905; hf]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="phi4-mini-3.8b",
    family="dense",
    n_layers=32,
    d_model=3072,
    n_heads=24,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab=200064,
    pattern=("attn",),
    mlp_kind="swiglu",
    rope_theta=10_000.0,
    tie_embeddings=True,  # hf config: tie_word_embeddings (200k vocab x2 would be ~4.5B)
    source="arXiv:2412.08905",
    notes=(
        "24 Q heads do not divide the 16-way model axis: head sharding falls "
        "back per the divisibility rule (GSPMD reshards around the softmax). "
        "200k vocab makes the unembed/loss the memory hot spot.  Full "
        "attention -> long_500k skipped."
    ),
)
