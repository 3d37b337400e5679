"""gemma-2b — dense 18L d2048 8H (MQA kv=1) d_ff=16384 vocab=256000, GeGLU,
head_dim=256. [arXiv:2403.08295; hf]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="gemma-2b",
    family="dense",
    n_layers=18,
    d_model=2048,
    n_heads=8,
    n_kv_heads=1,
    head_dim=256,
    d_ff=16384,
    vocab=256000,
    pattern=("attn",),
    mlp_kind="geglu",
    rope_theta=10_000.0,
    scale_embed=True,
    tie_embeddings=True,
    source="arXiv:2403.08295",
    notes=(
        "MQA (kv_heads=1): KV tensors cannot shard on the model axis; the "
        "divisibility fallback replicates them (documented).  Full attention "
        "-> long_500k skipped."
    ),
)
