"""Single-host blocked numpy backend (reference semantics).

This is the loop that used to live inline in ``core/join.py``: iterate
(L-block, R-block) tiles, build each clause's min-distance plane with
``FeatureData.distance_block``, AND the per-clause passes, and collect the
surviving indices.  Early exit when a block's conjunction empties
(``early_reject``; disable for the full-width A/B control).

Streaming: one ``CandidateChunk`` per L-row block (the outer loop), each
covering that row strip across all of R — so chunks arrive row-major
sorted and globally ordered.

It is the semantic oracle for the other backends — every engine must match
its candidate set exactly (tests/test_torch_engines.py).
Conjunct-eval accounting is per backend (block-granular here, tile/band-
granular on device), so only the candidate set — never the eval count —
is compared across backends.
"""

from __future__ import annotations

import numpy as np

from repro_torch.engine.base import ChunkDelta, CnfEngine


class NumpyEngine(CnfEngine):
    name = "numpy"

    def __init__(self, block: int = 4096, early_reject: bool = True):
        self.block = int(block)
        self.early_reject = bool(early_reject)

    def _evaluate_stream(self, feats, clauses, thetas, n_l, n_r):
        block = self.block
        early_reject = self.early_reject
        theta = np.asarray(thetas, np.float64)
        for i0 in range(0, n_l, block):
            il = np.arange(i0, min(i0 + block, n_l))
            out = []
            evals = 0                  # (pair, clause) evals for this strip
            for j0 in range(0, n_r, block):
                jr = np.arange(j0, min(j0 + block, n_r))
                ok = None
                for ci, clause in enumerate(clauses):
                    cd = None
                    for f in clause:
                        d = feats[f].distance_block(il, jr)
                        cd = d if cd is None else np.minimum(cd, d)
                    pas = cd <= theta[ci]
                    evals += il.size * jr.size
                    ok = pas if ok is None else (ok & pas)
                    if early_reject and not ok.any():
                        break
                if ok is None or not ok.any():
                    continue
                ii, jj = np.nonzero(ok)
                out.extend(zip((il[ii]).tolist(), (jr[jj]).tolist()))
            # host-resident compute: no device traffic in any direction
            yield ChunkDelta(out, conjunct_evals=evals)
