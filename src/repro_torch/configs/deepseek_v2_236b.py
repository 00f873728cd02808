"""DeepSeek-V2 236B — MLA + 160-expert MoE (2 shared, top-6).

[arXiv:2405.04434; hf] 60L d_model=5120 128H d_ff(expert)=1536 vocab=102400,
MLA kv_lora=512, q_lora=1536; layer 0 dense FFN (d_ff 12288), rest MoE.
"""
from repro_torch.common.config import MLAConfig, ModelConfig, MoEConfig


CONFIG = ModelConfig(
    name="deepseek-v2-236b",
    num_layers=60,
    d_model=5120,
    num_heads=128,
    num_kv_heads=128,
    d_ff=12288,                      # dense FFN for first_dense_layers
    vocab_size=102400,
    head_dim=192,                    # qk_nope(128) + qk_rope(64)
    block_pattern=("mla",),
    ffn_kind="moe",
    moe=MoEConfig(
        num_experts=160, num_shared_experts=2, top_k=6,
        expert_d_ff=1536, shared_d_ff=1536, first_dense_layers=1),
    mla=MLAConfig(kv_lora_rank=512, q_lora_rank=1536,
                  qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128),
    rope_theta=10000.0,
    max_seq_len=131072,
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-smoke",
        num_layers=3, d_model=64, num_heads=4, num_kv_heads=4, d_ff=128,
        vocab_size=256, head_dim=48, block_pattern=("mla",), ffn_kind="moe",
        moe=MoEConfig(num_experts=8, num_shared_experts=2, top_k=2,
                      expert_d_ff=32, shared_d_ff=32, first_dense_layers=1),
        mla=MLAConfig(kv_lora_rank=32, q_lora_rank=48,
                      qk_nope_head_dim=32, qk_rope_head_dim=16, v_head_dim=32),
        rope_theta=10000.0, max_seq_len=512, remat=False)
