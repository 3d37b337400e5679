"""h2o-danube-3-4b — dense 24L d3840 32H (GQA kv=8) d_ff=10240 vocab=32000,
llama+mistral mix with sliding-window attention. [arXiv:2401.16818; unverified]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="h2o-danube-3-4b",
    family="dense",
    n_layers=24,
    d_model=3840,
    n_heads=32,
    n_kv_heads=8,
    head_dim=120,
    d_ff=10240,
    vocab=32000,
    pattern=("local",),
    window=4096,
    mlp_kind="swiglu",
    rope_theta=10_000.0,
    source="arXiv:2401.16818",
    notes=(
        "All layers sliding-window (mistral-style) -> long_500k RUNS with "
        "ring KV caches of 4k.  head_dim=120 (3840/32) is not MXU-aligned: "
        "padding cost shows up in the roofline compute:model ratio."
    ),
)
