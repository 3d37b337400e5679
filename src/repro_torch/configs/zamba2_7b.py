"""zamba2-7b — 81L hybrid: Mamba2 backbone + shared attention blocks,
d3584 32H (kv=32) d_ff=14336 ssm_state=64. [arXiv:2411.15242; unverified]

81 mamba2 blocks with the *single shared* attention+MLP block interleaved
after every third mamba block (27 invocations of one weight set — the
paper's "one datapath reused across layers" idea realised at the parameter
level).  The shared block rides inside the ``mamba2_shared`` pattern slot so
the layer count stays the published 81 mamba layers.  LoRA per-invocation
adapters of the released model are omitted (documented simplification).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-7b",
    family="hybrid",
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    head_dim=112,
    d_ff=14336,
    vocab=32000,
    pattern=("mamba2", "mamba2", "mamba2_shared"),
    ssm_state=64,
    ssm_head_dim=64,
    ssm_expand=2,
    conv_kernel=4,
    mlp_kind="gelu",
    rope_theta=10_000.0,
    source="arXiv:2411.15242",
    notes=(
        "Hybrid SSM+attention -> long_500k RUNS: mamba layers carry O(1) "
        "state; the 27 shared-attn invocations each keep a full-length KV "
        "cache (sharded over data axis for long context)."
    ),
)
