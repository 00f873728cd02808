"""Minitron-8B — width-pruned Nemotron-4, dense GQA.

[arXiv:2407.14679; hf] 32L d_model=4096 32H (GQA kv=8) d_ff=16384 vocab=256000.
"""
from repro_torch.common.config import ModelConfig


CONFIG = ModelConfig(
    name="minitron-8b",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=16384,
    vocab_size=256000,
    head_dim=128,
    block_pattern=("attn",),
    rope_theta=10000.0,
    max_seq_len=4096,
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="minitron-smoke",
        num_layers=3, d_model=64, num_heads=4, num_kv_heads=2, d_ff=192,
        vocab_size=512, head_dim=16, block_pattern=("attn",),
        max_seq_len=512, remat=False)
