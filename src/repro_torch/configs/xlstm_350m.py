"""xLSTM-350M — alternating mLSTM / sLSTM blocks, no FFN.

[arXiv:2405.04517; unverified] 24L d_model=1024 4H vocab=50304 d_ff=0.
"""
from repro_torch.common.config import ModelConfig, SSMConfig


CONFIG = ModelConfig(
    name="xlstm-350m",
    num_layers=24,
    d_model=1024,
    num_heads=4,
    num_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    block_pattern=("mlstm", "slstm"),
    ssm=SSMConfig(expand=2, chunk=256),
    max_seq_len=1048576,
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="xlstm-smoke",
        num_layers=4, d_model=64, num_heads=4, num_kv_heads=4, d_ff=0,
        vocab_size=256, block_pattern=("mlstm", "slstm"),
        ssm=SSMConfig(expand=2, chunk=32), max_seq_len=2048, remat=False)
