"""LLM / embedding-model interfaces and their simulated backends.

The paper's evaluation (§8.1) simulates every ``L_p`` call by returning the
known ground truth while charging the cost of the prompt that would have been
sent.  ``SimulatedOracle`` reproduces that exactly.

The embedding model E is simulated with a hashed character-n-gram encoder —
deterministic, cheap, and (by construction) exhibits the paper's failure
mode: similarity degrades as text accumulates join-irrelevant content.
"""

from __future__ import annotations

import dataclasses
import hashlib
import time
from typing import Callable, Optional, Sequence

import numpy as np

from repro_torch.core.costs import CostLedger, n_tokens


class Oracle:
    """Evaluates the join predicate L_p on pairs of texts."""

    def label_pairs(self, pairs: Sequence[tuple], kind: str = "labeling") -> np.ndarray:
        raise NotImplementedError


@dataclasses.dataclass
class SimulatedOracle(Oracle):
    """Ground-truth-backed oracle with token-accurate cost accounting.

    ``truth(i, j) -> bool`` resolves against dataset ground truth;
    texts_l/texts_r used only to build (and price) the prompt.

    ``latency_s`` models the API round-trip of the L_p backend: each
    ``label_pairs`` batch sleeps ``latency_s`` per pair, once, after
    labeling.  The sleep releases the GIL — exactly the wait a real
    deployment overlaps across concurrent queries, which is what makes
    the fleet's concurrent-vs-serial wall comparison honest instead of
    a pure-Python GIL fight.  Answers and dollar charges are unaffected.
    """
    texts_l: Sequence[str]
    texts_r: Sequence[str]
    truth: Callable[[int, int], bool]
    join_prompt: str = "Do {l} and {r} satisfy the join condition? Answer yes or no."
    ledger: CostLedger = dataclasses.field(default_factory=CostLedger)
    calls: int = 0
    latency_s: float = 0.0

    def label_pairs(self, pairs, kind: str = "labeling") -> np.ndarray:
        out = np.zeros(len(pairs), dtype=bool)
        for n, (i, j) in enumerate(pairs):
            prompt = self.join_prompt.format(l=self.texts_l[i], r=self.texts_r[j])
            tok = n_tokens(prompt)
            if kind == "labeling":
                self.ledger.charge_label(tok)
            else:
                self.ledger.charge_refine(tok)
            out[n] = bool(self.truth(i, j))
            self.calls += 1
        if self.latency_s and pairs:
            time.sleep(self.latency_s * len(pairs))
        return out


# ---------------------------------------------------------------------------
# Embedding model
# ---------------------------------------------------------------------------

def _stable_hash(s: str, seed: int = 0) -> int:
    return int.from_bytes(hashlib.blake2b(
        s.encode(), digest_size=8, key=seed.to_bytes(8, "little")).digest(), "little")


@dataclasses.dataclass
class HashedNgramEmbedder:
    """Deterministic hashed char-n-gram embedding (simulated E).

    Embeds the *whole string* into ``dim`` buckets of 3..5-grams, l2
    normalized. Cosine similarity behaves like a real text embedding for
    short homogeneous strings and dilutes as irrelevant text is added.
    """
    dim: int = 256
    ngram: tuple = (3, 4, 5)
    ledger: Optional[CostLedger] = None

    def embed(self, texts: Sequence[str]) -> np.ndarray:
        out = np.zeros((len(texts), self.dim), np.float32)
        for i, t in enumerate(texts):
            s = t.lower()
            if self.ledger is not None:
                self.ledger.charge_embedding(n_tokens(t))
            for n in self.ngram:
                for k in range(max(len(s) - n + 1, 1)):
                    h = _stable_hash(s[k : k + n], seed=n)
                    out[i, h % self.dim] += 1.0 if (h >> 32) % 2 else -1.0
            norm = np.linalg.norm(out[i])
            if norm > 0:
                out[i] /= norm
        return out


def semantic_distance_matrix(e_l: np.ndarray, e_r: np.ndarray) -> np.ndarray:
    """(1 - cosine)/2 in [0,1] for unit-normalized embeddings."""
    return (1.0 - e_l @ e_r.T) * 0.5
