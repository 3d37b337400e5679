"""gemma3-12b — dense 48L d3840 16H (GQA kv=8) d_ff=15360 vocab=262144,
5:1 local:global sliding-window pattern, 128k context.
[hf:google/gemma-3-1b-pt; unverified]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="gemma3-12b",
    family="dense",
    n_layers=48,
    d_model=3840,
    n_heads=16,
    n_kv_heads=8,
    head_dim=256,
    d_ff=15360,
    vocab=262144,
    pattern=("local", "local", "local", "local", "local", "attn"),
    window=1024,
    mlp_kind="geglu",
    rope_theta=1_000_000.0,
    scale_embed=True,
    tie_embeddings=True,
    source="hf:google/gemma-3-1b-pt (family config, 12b dims per card)",
    notes=(
        "5:1 local:global -> long_500k RUNS: local layers use ring KV caches "
        "of window length (1k), only the 8 global layers hold full 512k KV "
        "(sharded over the data axis by the long-context rules)."
    ),
)
