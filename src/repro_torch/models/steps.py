"""Step functions of the serving path: prefill_step / decode_step.

The training steps (``cross_entropy``, ``loss_fn``, ``make_train_step``)
come with the training slice (ROADMAP queue 1, item 6).  Each step runs
under ``torch.inference_mode`` and takes the ``Transformer`` where the
reference takes its parameter tree.
"""

from __future__ import annotations

import torch

from repro_torch.common.config import ModelConfig
from repro_torch.models import transformer


def make_prefill_step(cfg: ModelConfig, capacity: int):
    """prefill_step(model, tokens[, valid_from, positions]) -> (state,
    last_logits); ``state`` is a KV cache of ``capacity`` slots allocated
    on the tokens' device."""

    @torch.inference_mode()
    def prefill_step(model, tokens, valid_from=None, positions=None):
        b = tokens.shape[0]
        state = transformer.init_state(cfg, b, capacity, tokens.device)
        logits, new_state, _ = model(tokens, positions=positions, state=state,
                                     valid_from=valid_from)
        return new_state, logits[:, -1]

    return prefill_step


def make_decode_step(cfg: ModelConfig):
    """decode_step(model, state, token, pos[, valid_from]) -> (state,
    logits); token: (B, 1) int; pos: (B, 1) positions.  The state's KV
    cache is written in place."""

    @torch.inference_mode()
    def decode_step(model, state, token, pos, valid_from=None):
        logits, new_state, _ = model(token, positions=pos, state=state,
                                     valid_from=valid_from)
        return new_state, logits[:, -1]

    return decode_step


def greedy_sample(logits: torch.Tensor) -> torch.Tensor:
    return torch.argmax(logits, dim=-1).to(torch.int32)
