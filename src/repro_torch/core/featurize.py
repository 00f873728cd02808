"""Featurizations at runtime.

A featurization φ = (d, X_L, X_R) is materialized as ``FeatureData``:
per-record extracted values vectorized into one of three representations so
the quadratic distance pass is pure array math (and kernel-friendly):

  * ``embed``    — unit vectors (n, D); d = clip(0.5 − 0.5·dot, 0, 1)
                   [semantic; also word_overlap via l2-normalized hashed
                   token k-hot vectors — one MXU-friendly dot-product path]
  * ``scalar``   — floats (n,); d = |x−y| / scale (clipped to 1)   [arithmetic/date]

All distances live in [0, 1]; missing extractions yield distance 1 (max),
matching Appx D's cross-featurization normalization so thresholds within a
clause can be tied (Lemma D.1 min-reduction).  Missing values are encoded
*inside* the arrays so the Pallas kernel needs no extra mask planes:
vector rows are augmented asymmetrically as [e, m, 1] (L) and [e, 1, m] (R)
with m = −2 for missing rows, making the pair dot ≤ −2 ⇒ clipped distance 1;
scalar missing is +1e9 on L and −1e9 on R.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

from repro_torch.core.llm import HashedNgramEmbedder

MISSING_DIST = 1.0
TOKENSET_DIM = 128


@dataclasses.dataclass(frozen=True)
class FeaturizationSpec:
    """What the generation LLM proposes (Alg 2 output)."""
    name: str
    description: str
    distance_kind: str          # semantic | word_overlap | arithmetic | date
    extractor_kind: str         # llm | code
    field: str                  # dataset field targeted by the extractor
    version: int = 0            # bumped when the LLM "fixes" an extractor

    @property
    def key(self) -> str:
        return f"{self.name}@v{self.version}"


@dataclasses.dataclass
class FeatureData:
    spec: FeaturizationSpec
    kind: str                   # embed | scalar
    data_l: np.ndarray          # embed: (n, D+2) augmented; scalar: (n,)
    data_r: np.ndarray
    scale: float = 1.0

    def distance_block(self, idx_l: np.ndarray, idx_r: np.ndarray) -> np.ndarray:
        """Dense block of pairwise distances (|idx_l|, |idx_r|) in [0,1]."""
        a = self.data_l[idx_l]
        b = self.data_r[idx_r]
        if self.kind == "embed":
            return np.clip(0.5 - 0.5 * (a @ b.T), 0.0, 1.0)
        if self.kind == "scalar":
            return np.clip(np.abs(a[:, None] - b[None, :]), 0.0, 1.0)
        raise ValueError(self.kind)

    def pair_distances(self, pairs: Sequence[tuple]) -> np.ndarray:
        """Distances for an explicit pair list (no n^2 materialization)."""
        il = np.asarray([p[0] for p in pairs])
        ir = np.asarray([p[1] for p in pairs])
        a = self.data_l[il]
        b = self.data_r[ir]
        if self.kind == "embed":
            return np.clip(0.5 - 0.5 * np.sum(a * b, axis=-1), 0.0, 1.0)
        if self.kind == "scalar":
            return np.clip(np.abs(a - b), 0.0, 1.0)
        raise ValueError(self.kind)


# ---------------------------------------------------------------------------
# vectorizers: raw extracted values -> FeatureData arrays
# ---------------------------------------------------------------------------

def _augment(vecs: np.ndarray, missing: np.ndarray, side: str) -> np.ndarray:
    """Append [m, 1] (L) / [1, m] (R) marker dims; m=-2 on missing rows."""
    n = vecs.shape[0]
    m = np.where(missing, -2.0, 0.0).astype(np.float32)
    one = np.ones(n, np.float32)
    cols = (m, one) if side == "l" else (one, m)
    return np.concatenate([vecs, cols[0][:, None], cols[1][:, None]], axis=1)


def vectorize(spec: FeaturizationSpec, values_l: list, values_r: list,
              embedder: Optional[HashedNgramEmbedder] = None) -> FeatureData:
    """values: list of str|float|None per record (None = failed extraction)."""
    if spec.distance_kind in ("semantic", "word_overlap"):
        if spec.distance_kind == "semantic":
            emb = embedder or HashedNgramEmbedder(dim=128)
            vl, ml = _embed_values(values_l, emb)
            vr, mr = _embed_values(values_r, emb)
        else:
            vl, ml = _tokenset(values_l)
            vr, mr = _tokenset(values_r)
        return FeatureData(spec, "embed",
                           _augment(vl, ml, "l"), _augment(vr, mr, "r"))
    if spec.distance_kind in ("arithmetic", "date"):
        a = np.asarray([np.nan if v is None else float(v) for v in values_l], np.float64)
        b = np.asarray([np.nan if v is None else float(v) for v in values_r], np.float64)
        finite = np.concatenate([a[np.isfinite(a)], b[np.isfinite(b)]])
        if spec.distance_kind == "date":
            scale = 30.0                       # one month normalizes to 1.0
        else:
            scale = float(np.percentile(finite, 95) - np.percentile(finite, 5)) \
                if finite.size else 1.0
            scale = max(scale, 1e-9)
        a = np.where(np.isnan(a), 1e9, a / scale).astype(np.float32)
        b = np.where(np.isnan(b), -1e9, b / scale).astype(np.float32)
        return FeatureData(spec, "scalar", a, b, scale=scale)
    raise ValueError(spec.distance_kind)


def _embed_values(values: list, emb: HashedNgramEmbedder):
    texts = ["" if v is None else str(v) for v in values]
    out = emb.embed(texts)
    missing = np.asarray([v is None or str(v) == "" for v in values], bool)
    out[missing] = 0.0
    return out, missing


def _tokenset(values: list):
    from repro_torch.core.llm import _stable_hash
    out = np.zeros((len(values), TOKENSET_DIM), np.float32)
    for i, v in enumerate(values):
        if v is None:
            continue
        for w in str(v).lower().replace(",", " ").replace(";", " ").split():
            out[i, _stable_hash(w, seed=7) % TOKENSET_DIM] = 1.0
    norms = np.linalg.norm(out, axis=1)
    missing = norms < 0.5
    out[~missing] /= norms[~missing][:, None]
    return out, missing


def distance_stack(feats: Sequence[FeatureData], pairs: Sequence[tuple]) -> np.ndarray:
    """(len(pairs), len(feats)) distance matrix for explicit pairs."""
    return np.stack([f.pair_distances(pairs) for f in feats], axis=1) \
        if feats else np.zeros((len(pairs), 0), np.float32)
