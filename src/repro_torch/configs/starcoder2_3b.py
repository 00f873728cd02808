"""StarCoder2-3B — dense GQA (kv=2), RoPE.

[arXiv:2402.19173; hf] 30L d_model=3072 24H (GQA kv=2) d_ff=12288 vocab=49152.
"""
from repro_torch.common.config import ModelConfig


CONFIG = ModelConfig(
    name="starcoder2-3b",
    num_layers=30,
    d_model=3072,
    num_heads=24,
    num_kv_heads=2,
    d_ff=12288,
    vocab_size=49152,
    head_dim=128,
    block_pattern=("attn",),
    rope_theta=999999.0,
    max_seq_len=16384,
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="starcoder2-smoke",
        num_layers=3, d_model=48, num_heads=4, num_kv_heads=1, d_ff=96,
        vocab_size=128, head_dim=12, block_pattern=("attn",),
        max_seq_len=512, remat=False)
