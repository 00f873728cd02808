"""Batched serving engine: wave-scheduled continuous batching.

Requests are bucketed into *waves* of up to ``batch_slots``; each wave is
left-padded to its longest prompt (pad positions are masked end-to-end via
``valid_from``), prefilled in one batched call, then decoded in lockstep with
greedy sampling.  A slot whose request finishes keeps decoding garbage until
the wave drains (its output is truncated) — the fixed-shape trade-off that
keeps every step the same batch shape.  Each wave allocates one cache (KV,
or MLA's latent) on the model's device and decodes into it in place.  An
MoE layer routes the pads too, and its capacity follows the call's token
count (a wave's prefill, a decode step), as in the reference.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence

import numpy as np
import torch

from repro_torch.common.config import ModelConfig
from repro_torch.models import steps


@dataclasses.dataclass
class Request:
    prompt: np.ndarray               # (len,) int32
    max_new_tokens: int = 16
    eos_id: int = -1                 # -1: never
    out_tokens: list = dataclasses.field(default_factory=list)


def pad_wave(prompts: Sequence[np.ndarray], slots: int):
    """A wave's prefill inputs: tokens (slots, pmax) int32 left-padded to
    the longest prompt, ``valid_from`` (slots,) (empty slots: all pad) and
    the logical (RoPE) positions, which start at 0 at each request's first
    real token; cache masking stays on physical positions via
    ``valid_from``."""
    lens = [len(p) for p in prompts]
    pmax = max(lens)
    tokens = np.zeros((slots, pmax), np.int32)
    valid_from = np.full(slots, pmax, np.int32)
    for s, p in enumerate(prompts):
        tokens[s, pmax - lens[s]:] = p
        valid_from[s] = pmax - lens[s]
    logical = np.maximum(np.arange(pmax)[None, :] - valid_from[:, None], 0)
    return tokens, valid_from, logical.astype(np.int32)


class ServeEngine:
    """Serves ``model`` (a ``models.transformer.Transformer``) on the
    device its weights live on.  Construction casts the model's >= 2-D
    weights to the compute dtype in place: every forward casts them so at
    each use anyway, so the values are the same, and the f32 copies would
    double the weights' memory and each decode step's weight reads.  A
    module's ``keep_f32`` parameters (the MoE router, read in f32) stay
    as they are."""

    def __init__(self, cfg: ModelConfig, model, *, batch_slots: int = 8,
                 capacity: int = 512):
        self.cfg = cfg
        self.model = model
        self.b = batch_slots
        self.capacity = capacity
        self.device = model.embed["embedding"].device
        cdt = getattr(torch, cfg.dtype)
        with torch.no_grad():
            for mod in model.modules():
                keep = getattr(mod, "keep_f32", ())
                for name, p in mod.named_parameters(recurse=False):
                    if p.ndim >= 2 and p.dtype != cdt and name not in keep:
                        p.data = p.data.to(cdt)
        self._prefill = steps.make_prefill_step(cfg, capacity)
        self._decode = steps.make_decode_step(cfg)
        self.steps_executed = 0

    def _run_wave(self, wave: List[Request]) -> None:
        dev = self.device
        for r in wave:
            # a Request resubmitted to run() (retry, or reuse across
            # engines) must not carry the previous run's decode state: the
            # eos / max_new_tokens checks below read out_tokens, so stale
            # tokens would silently truncate or suppress this run
            r.out_tokens = []
        tokens, valid_from, logical = pad_wave([r.prompt for r in wave], self.b)
        pmax = tokens.shape[1]
        vf = torch.as_tensor(valid_from, device=dev)
        state, last_logits = self._prefill(
            self.model, torch.as_tensor(tokens, device=dev), vf,
            torch.as_tensor(logical, device=dev))
        tok = steps.greedy_sample(last_logits)
        last = tok.cpu().numpy()
        for s, r in enumerate(wave):
            r.out_tokens.append(int(last[s]))
        pos = pmax
        budget = max(r.max_new_tokens for r in wave) - 1
        for _ in range(max(budget, 0)):
            if pos >= self.capacity:
                break
            posv = (pos - vf).to(torch.int32)[:, None]          # logical
            state, logits = self._decode(self.model, state, tok[:, None],
                                         posv, vf)
            tok = steps.greedy_sample(logits)
            last = tok.cpu().numpy()
            self.steps_executed += 1
            alive = False
            for s, r in enumerate(wave):
                if len(r.out_tokens) >= r.max_new_tokens:
                    continue
                if r.out_tokens and r.out_tokens[-1] == r.eos_id:
                    continue
                r.out_tokens.append(int(last[s]))
                alive = True
            pos += 1
            if not alive:
                break

    def run(self, requests: Sequence[Request]) -> List[Request]:
        """Processes all requests; returns them with ``out_tokens`` filled."""
        reqs = sorted(requests, key=lambda r: len(r.prompt))  # length bucketing
        for w0 in range(0, len(reqs), self.b):
            wave = list(reqs[w0 : w0 + self.b])
            self._run_wave(wave)
        return list(requests)
