"""Configuration dataclasses for the repro framework.

A single ``ModelConfig`` describes every assigned architecture: dense GQA
transformers, MLA (DeepSeek-V2), MoE variants, Mamba2/xLSTM SSM blocks, hybrid
stacks, and cross-attention VLM layers.  The block layout is expressed as a
repeating ``block_pattern`` so heterogeneous stacks (zamba2, xlstm) lower to a
small number of scanned segments instead of 40+ unrolled layers.
"""

from __future__ import annotations

import dataclasses
import enum
import math
from typing import Optional, Sequence


class BlockKind(str, enum.Enum):
    ATTN = "attn"              # softmax attention (MHA / GQA)
    MLA = "mla"                # multi-head latent attention (DeepSeek-V2)
    CROSS_ATTN = "cross_attn"  # cross attention to vision/audio memory
    MAMBA2 = "mamba2"          # Mamba-2 SSD block
    SLSTM = "slstm"            # xLSTM sLSTM block
    MLSTM = "mlstm"            # xLSTM mLSTM block


class FFNKind(str, enum.Enum):
    DENSE = "dense"            # SwiGLU dense MLP
    MOE = "moe"                # routed mixture of experts
    NONE = "none"              # block has fused/no FFN (SSM blocks)


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 0
    num_shared_experts: int = 0
    top_k: int = 1
    expert_d_ff: int = 0            # per-expert hidden dim
    shared_d_ff: int = 0            # shared-expert hidden dim
    capacity_factor: float = 1.25
    router_aux_loss_coef: float = 0.001
    router_z_loss_coef: float = 0.0001
    # first N layers use dense FFN (e.g. deepseek layer 0 is dense)
    first_dense_layers: int = 0
    # layer i is MoE iff (i % moe_layer_step == moe_layer_step - 1)
    # (llama4-maverick interleaves MoE every other layer)
    moe_layer_step: int = 1


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    kv_lora_rank: int = 512
    q_lora_rank: int = 0            # 0 => full-rank q projection
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    state_dim: int = 64             # N: SSM state size per head
    num_heads: int = 0              # mamba2 heads (0 => derived)
    head_dim: int = 64
    expand: int = 2                 # d_inner = expand * d_model
    conv_dim: int = 4               # depthwise conv width
    chunk: int = 256                # SSD chunk length


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                     # 0 => d_model // num_heads
    block_pattern: Sequence[str] = ("attn",)   # repeats to cover num_layers
    ffn_kind: str = "dense"
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    # positions / norm
    rope_theta: float = 500000.0
    max_seq_len: int = 131072
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    # modality frontend stub: if >0, inputs may be precomputed embeddings with
    # this dimension (audio frames / image patches) instead of token ids.
    frontend_embed_dim: int = 0
    cross_attn_every: int = 0             # VLM: 1 cross-attn layer every N
    cross_attn_memory_len: int = 0        # image/audio memory tokens
    # numerics
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    # "per_use": cast weights to compute dtype at each use (baseline; FSDP
    # gathers move f32).  "once": cast the whole tree before the layer stack
    # so gathers move bf16 (§Perf hillclimb; ~2x weight-traffic saving).
    param_cast: str = "per_use"
    # dtype in which S^2 attention scores/probs are materialized (f32
    # baseline; bf16 halves the dominant HBM term on long-seq cells; §Perf)
    attn_scores_dtype: str = "float32"
    remat: bool = True
    remat_policy: str = "nothing_saveable"   # or "dots_saveable"
    scan_layers: bool = True
    logits_softcap: float = 0.0

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.num_heads)

    @property
    def pattern(self) -> tuple:
        """Full per-layer block kinds of length num_layers."""
        p = list(self.block_pattern)
        reps = math.ceil(self.num_layers / len(p))
        full = (p * reps)[: self.num_layers]
        if self.cross_attn_every > 0:
            for i in range(self.num_layers):
                if (i + 1) % self.cross_attn_every == 0:
                    full[i] = BlockKind.CROSS_ATTN.value
        return tuple(full)

    def _layer_ffn(self, kind: str) -> str:
        if kind in (BlockKind.MAMBA2.value, BlockKind.SLSTM.value, BlockKind.MLSTM.value):
            return FFNKind.NONE.value
        return self.ffn_kind


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One assigned input-shape cell."""
    name: str                 # train_4k | prefill_32k | decode_32k | long_500k
    seq_len: int
    global_batch: int
    kind: str                 # "train" | "prefill" | "decode"


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1000
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    microbatch: int = 0              # 0 => no gradient accumulation
    # dtype of the backward pass / cross-shard gradient reductions:
    # float32 (baseline) or bfloat16 (halves grad-reduce traffic; §Perf)
    grads_dtype: str = "float32"
    seed: int = 0
    checkpoint_every: int = 100
    checkpoint_dir: str = "/tmp/repro_ckpt"
    keep_checkpoints: int = 3
    grad_compression: str = "none"   # none | fp16 | int8
