"""Llama-3.2-Vision 90B — text decoder with gated cross-attn image layers.

[hf:meta-llama/Llama-3.2-90B-Vision; unverified] 100L d_model=8192 64H
(GQA kv=8) d_ff=28672 vocab=128256; cross-attn every 5th layer; vision
frontend is a stub providing precomputed patch embeddings (dim 1280).
"""
from repro_torch.common.config import ModelConfig


CONFIG = ModelConfig(
    name="llama-3.2-vision-90b",
    num_layers=100,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=28672,
    vocab_size=128256,
    head_dim=128,
    block_pattern=("attn",),
    cross_attn_every=5,
    cross_attn_memory_len=1600,
    frontend_embed_dim=1280,
    rope_theta=500000.0,
    max_seq_len=131072,
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="llama-vision-smoke",
        num_layers=5, d_model=64, num_heads=4, num_kv_heads=2, d_ff=128,
        vocab_size=256, head_dim=16, block_pattern=("attn",),
        cross_attn_every=5, cross_attn_memory_len=16, frontend_embed_dim=24,
        max_seq_len=512, remat=False)
