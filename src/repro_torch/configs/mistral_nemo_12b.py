"""Mistral-NeMo 12B — dense GQA, 128k context.

[hf:mistralai/Mistral-Nemo-Base-2407; hf] 40L d_model=5120 32H (GQA kv=8)
d_ff=14336 vocab=131072, head_dim=128.
"""
from repro_torch.common.config import ModelConfig


CONFIG = ModelConfig(
    name="mistral-nemo-12b",
    num_layers=40,
    d_model=5120,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=131072,
    head_dim=128,
    block_pattern=("attn",),
    rope_theta=1000000.0,
    max_seq_len=131072,
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="mistral-nemo-smoke",
        num_layers=3, d_model=64, num_heads=4, num_kv_heads=2, d_ff=160,
        vocab_size=256, head_dim=16, block_pattern=("attn",),
        max_seq_len=512, remat=False)
