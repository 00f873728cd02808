"""Zamba2-1.2B — hybrid Mamba2 backbone with periodic (shared) attention.

[arXiv:2411.15242; hf] 38L d_model=2048 32H (kv=32) d_ff=8192 ssm_state=64.
Pattern: 5 Mamba2 blocks then 1 attention(+FFN) block, repeating; FFN only on
attention layers (Mamba blocks carry their own mixer MLP capacity).
"""
from repro_torch.common.config import ModelConfig, SSMConfig


CONFIG = ModelConfig(
    name="zamba2-1.2b",
    num_layers=38,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    d_ff=8192,
    vocab_size=32000,
    head_dim=64,
    block_pattern=("mamba2", "mamba2", "mamba2", "mamba2", "mamba2", "attn"),
    ssm=SSMConfig(state_dim=64, head_dim=64, expand=2, conv_dim=4, chunk=256),
    rope_theta=10000.0,
    max_seq_len=1048576,
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-smoke",
        num_layers=8, d_model=64, num_heads=4, num_kv_heads=4, d_ff=128,
        vocab_size=256, head_dim=16,
        block_pattern=("mamba2", "mamba2", "attn"),
        ssm=SSMConfig(state_dim=16, head_dim=16, expand=2, conv_dim=4, chunk=32),
        max_seq_len=2048, remat=False)
