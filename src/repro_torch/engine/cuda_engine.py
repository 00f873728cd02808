"""Single-device CUDA backend.

Thin wrapper over ``kernels.fused_cnf_join.ops``: the fused kernel grids
over the padded (n_l, n_r) plane, writes the packed bitmask, and the mask
is pulled to the host and unpacked there — host traffic is
O(n_l · n_r / 8).  On ``device="cpu"`` the same loop runs the kernel's
plain-torch version.

Streaming: the kernel runs one ``l_block``-row strip at a time
(``ops.evaluate_corpus_stream``), yielding a ``CandidateChunk`` per strip,
so candidates for early rows reach the refinement pump while later strips
are still to run.
"""

from __future__ import annotations

from typing import Optional

from repro_torch.device import resolve_device
from repro_torch.engine.base import CnfEngine


class CudaEngine(CnfEngine):
    name = "cuda"

    def __init__(self, tl: int = 256, tr: int = 512,
                 l_block: Optional[int] = None, early_reject: bool = True,
                 device="cuda"):
        """l_block: rows per streamed chunk (multiple of tl; default 4*tl).
        early_reject=False forces full-width CNF on every tile (the A/B
        control for the conjunct_evals accounting)."""
        self.tl = int(tl)
        self.tr = int(tr)
        self.l_block = int(l_block) if l_block else 4 * self.tl
        self.early_reject = bool(early_reject)
        self.device = resolve_device(device)
        if self.l_block % self.tl != 0:
            raise ValueError(
                f"l_block={self.l_block} must be a multiple of tl={tl}")

    def _evaluate_stream(self, feats, clauses, thetas, n_l, n_r):
        from repro_torch.kernels.fused_cnf_join import ops as cnf_ops
        yield from cnf_ops.evaluate_corpus_stream(
            feats, clauses, thetas, tl=self.tl, tr=self.tr,
            l_block=self.l_block, early_reject=self.early_reject,
            device=self.device)
