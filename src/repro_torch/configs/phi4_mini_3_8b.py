"""Phi-4-mini 3.8B — dense GQA, RoPE, SwiGLU, tied embeddings.

[arXiv:2412.08905; hf] 32L d_model=3072 24H (GQA kv=8) d_ff=8192 vocab=200064.
"""
from repro_torch.common.config import ModelConfig


CONFIG = ModelConfig(
    name="phi4-mini-3.8b",
    num_layers=32,
    d_model=3072,
    num_heads=24,
    num_kv_heads=8,
    d_ff=8192,
    vocab_size=200064,
    head_dim=128,
    block_pattern=("attn",),
    tie_embeddings=True,
    rope_theta=10000.0,
    max_seq_len=131072,
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="phi4-mini-smoke",
        num_layers=3, d_model=48, num_heads=4, num_kv_heads=2, d_ff=96,
        vocab_size=128, head_dim=12, block_pattern=("attn",),
        tie_embeddings=True, max_seq_len=512, remat=False)
