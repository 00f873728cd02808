"""Step-② evaluation engines.

``get_engine("numpy" | "cuda" | "sharded", **opts)`` is the single entry
point used by ``core.join`` and the launchers.
"""

from __future__ import annotations

from repro_torch.engine.base import (CandidateChunk, CnfEngine, EngineResult,
                                     EngineStats)

ENGINES = ("numpy", "cuda", "sharded")


def get_engine(name: str, **opts) -> CnfEngine:
    if name == "numpy":
        from repro_torch.engine.numpy_engine import NumpyEngine
        return NumpyEngine(**opts)
    if name == "cuda":
        from repro_torch.engine.cuda_engine import CudaEngine
        return CudaEngine(**opts)
    if name == "sharded":
        from repro_torch.engine.sharded import ShardedEngine
        return ShardedEngine(**opts)
    raise ValueError(f"unknown engine {name!r}; expected one of {ENGINES}")


__all__ = ["CandidateChunk", "CnfEngine", "EngineResult", "EngineStats",
           "ENGINES", "get_engine"]
