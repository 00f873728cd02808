"""MusicGen-medium — decoder-only transformer over EnCodec tokens.

[arXiv:2306.05284; hf] 48L d_model=1536 24H (MHA kv=24) d_ff=6144 vocab=2048.
Modality frontend (EnCodec) is a stub: inputs are precomputed token frames.
"""
from repro_torch.common.config import ModelConfig


CONFIG = ModelConfig(
    name="musicgen-medium",
    num_layers=48,
    d_model=1536,
    num_heads=24,
    num_kv_heads=24,
    d_ff=6144,
    vocab_size=2048,
    head_dim=64,
    block_pattern=("attn",),
    ffn_kind="dense",
    rope_theta=10000.0,
    max_seq_len=32768,
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="musicgen-smoke",
        num_layers=3, d_model=48, num_heads=4, num_kv_heads=4, d_ff=96,
        vocab_size=64, head_dim=12, block_pattern=("attn",),
        max_seq_len=256, remat=False)
