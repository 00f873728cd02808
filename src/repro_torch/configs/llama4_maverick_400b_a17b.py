"""Llama-4 Maverick 400B (17B active) — interleaved MoE, 128e top-1 + shared.

[hf:meta-llama/Llama-4; unverified] 48L d_model=5120 40H (GQA kv=8)
d_ff=8192 vocab=202048; MoE every other layer; early fusion (text backbone
here, frontend stubbed).
"""
from repro_torch.common.config import ModelConfig, MoEConfig


CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    d_ff=8192,
    vocab_size=202048,
    head_dim=128,
    block_pattern=("attn",),
    ffn_kind="moe",
    moe=MoEConfig(num_experts=128, num_shared_experts=1, top_k=1,
                  expert_d_ff=8192, shared_d_ff=8192, moe_layer_step=2),
    rope_theta=500000.0,
    max_seq_len=1048576,
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="llama4-maverick-smoke",
        num_layers=4, d_model=64, num_heads=4, num_kv_heads=2, d_ff=128,
        vocab_size=256, head_dim=16, block_pattern=("attn",), ffn_kind="moe",
        moe=MoEConfig(num_experts=8, num_shared_experts=1, top_k=1,
                      expert_d_ff=64, shared_d_ff=64, moe_layer_step=2),
        max_seq_len=512, remat=False)
