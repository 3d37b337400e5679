"""internvl2-1b — VLM: InternViT frontend (STUB) + InternLM2-0.5b text
backbone, 24L d896 14H (GQA kv=2) d_ff=4864 vocab=151655.
[arXiv:2404.16821; hf]

Only the transformer backbone is modelled; the vision tower is a stub whose
``input_specs()`` provides 256 precomputed patch embeddings (1024-d, the
InternViT-300M output width) passed through the mlp1-style projector.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-1b",
    family="vlm",
    n_layers=24,
    d_model=896,
    n_heads=14,
    n_kv_heads=2,
    head_dim=64,
    d_ff=4864,
    vocab=151655,
    pattern=("attn",),
    mlp_kind="swiglu",
    rope_theta=1_000_000.0,
    frontend="vision_patches",
    frontend_dim=1024,
    n_patches=256,
    source="arXiv:2404.16821",
    notes=(
        "14 heads / kv=2 don't divide the 16-way model axis -> divisibility "
        "fallback (documented).  Full attention -> long_500k skipped."
    ),
)
