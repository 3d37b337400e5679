"""granite-4.0-h-micro — 40L hybrid: 36 Mamba2 mixers and 4 NoPE GQA
attention layers (at 5, 15, 25, 35), each followed by a SwiGLU MLP of
8192; d2048, 32H (kv=8) of 64, mamba2 64 heads of 64, state 128, one
group, conv 4 with bias over [x, B, C], chunk 256; vocab 100352, tied.
[hf: ibm-granite/granite-4.0-h-micro config.json, ``granitemoehybrid``]

The four multipliers of the published config: embeddings x 12
(``embedding_multiplier``), each residual branch x 0.22
(``residual_multiplier``), the softmax scale 1/64
(``attention_multiplier``), logits / 8 (``logits_scaling``).  Not in the
reference package's registry: a ``HybridConfig``.  One device only: the
published mixer refuses rules that cut its heads.
"""
from repro_torch.configs.base import HybridConfig

CONFIG = HybridConfig(
    name="granite-4.0-h-micro",
    family="hybrid",
    n_layers=40,
    d_model=2048,
    n_heads=32,
    n_kv_heads=8,
    head_dim=64,
    d_ff=8192,
    vocab=100352,
    pattern=("mamba2_mlp",) * 5 + ("attn",) + ("mamba2_mlp",) * 4,
    mlp_kind="swiglu",
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
    conv_kernel=4,
    rope_theta=10_000.0,  # published, unused: NoPE
    norm_eps=1e-5,
    tie_embeddings=True,
    nope=True,
    attn_scale=0.015625,
    embed_mult=12.0,
    residual_mult=0.22,
    logits_div=8.0,
    ssm_published=True,
    source="https://huggingface.co/ibm-granite/granite-4.0-h-micro/blob/main/config.json",
    notes=(
        "Mamba2 state is a fixed 77.4 MB a session (36 layers); the four "
        "attention layers keep full-length KV caches. One device: the "
        "published mixer is not head-parallel."
    ),
)
