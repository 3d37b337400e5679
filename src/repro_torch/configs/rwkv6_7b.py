"""rwkv6-7b "Finch" — 32L d4096 attention-free, d_ff=14336 vocab=65536,
data-dependent decay. [arXiv:2404.05892; hf]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="rwkv6-7b",
    family="ssm",
    n_layers=32,
    d_model=4096,
    n_heads=64,  # wkv heads = d_model / rwkv_head_dim
    n_kv_heads=64,
    head_dim=64,
    d_ff=14336,
    vocab=65536,
    pattern=("rwkv6",),
    rwkv_head_dim=64,
    rwkv_lora_rank=64,
    causal=True,
    source="arXiv:2404.05892",
    notes=(
        "Attention-free: O(1) decode state -> long_500k RUNS trivially (the "
        "500k context costs nothing at decode).  Decay params (double-exp) "
        "are pinned fp32 by the sensitivity policy.  The paper's attention-"
        "oriented pruning retargets to the channel-mix FFN."
    ),
)
