"""hubert-xlarge — encoder-only audio transformer, 48L d1280 16H d_ff=5120
vocab=504 (cluster targets). [arXiv:2106.07447; unverified]

The conv waveform frontend is a STUB per the assignment: ``input_specs()``
provides precomputed frame embeddings (frontend_dim=512); only the
transformer backbone is modelled.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="hubert-xlarge",
    family="audio",
    n_layers=48,
    d_model=1280,
    n_heads=16,
    n_kv_heads=16,
    head_dim=80,
    d_ff=5120,
    vocab=504,
    pattern=("attn",),
    mlp_kind="gelu",
    causal=False,  # bidirectional encoder
    frontend="audio_frames",
    frontend_dim=512,
    source="arXiv:2106.07447",
    notes=(
        "Encoder-only: no decode step -> decode_32k and long_500k skipped "
        "per the assignment.  prefill_32k = full encoder forward."
    ),
)
