"""Training data pipeline: byte-level tokenizer, document packing, sharded
batching, prefetch with straggler mitigation.

Design for the production mesh (see DESIGN.md):
  * deterministic shard assignment — host h of H owns documents
    ``i % H == h``; any host can recompute any other host's batch stream
    (pure function of (seed, step)), which is what makes both *elastic
    rescale* (recompute assignment for a new H) and *straggler backup*
    (a fast host can serve a slow host's batch) correct by construction;
  * bounded prefetch queue on a background thread; if the producer misses
    the deadline the consumer synthesizes the batch itself (self-backup) —
    the CPU-container stand-in for cross-host work stealing.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Iterator, Optional, Sequence

import numpy as np


class ByteTokenizer:
    """Reversible byte-level tokenizer with a small special-token space."""
    PAD, BOS, EOS = 0, 1, 2
    OFFSET = 3

    def __init__(self, vocab_size: int = 259):
        self.vocab_size = max(vocab_size, 256 + self.OFFSET)

    def encode(self, text: str) -> np.ndarray:
        b = text.encode("utf-8", errors="replace")
        return np.frombuffer(b, np.uint8).astype(np.int32) + self.OFFSET

    def decode(self, ids: Sequence[int]) -> str:
        bs = bytes(int(i) - self.OFFSET for i in ids
                   if int(i) >= self.OFFSET and int(i) - self.OFFSET < 256)
        return bs.decode("utf-8", errors="replace")


@dataclasses.dataclass
class PackedLMConfig:
    seq_len: int = 256
    batch_size: int = 8
    seed: int = 0
    host_index: int = 0
    host_count: int = 1


class PackedLMDataset:
    """Packs a corpus of documents into fixed (batch, seq) LM examples.

    Batch generation is a pure function of (seed, step, host_index) so any
    host can reproduce any stream — see module docstring.
    """

    def __init__(self, texts: Sequence[str], cfg: PackedLMConfig,
                 tokenizer: Optional[ByteTokenizer] = None,
                 vocab_size: int = 259):
        self.cfg = cfg
        self.tok = tokenizer or ByteTokenizer(vocab_size)
        owned = [t for i, t in enumerate(texts)
                 if i % cfg.host_count == cfg.host_index]
        ids = [np.concatenate([[self.tok.BOS], self.tok.encode(t), [self.tok.EOS]])
               for t in owned] or [np.asarray([self.tok.BOS, self.tok.EOS])]
        self.stream = np.concatenate(ids).astype(np.int32)
        self.stream = np.clip(self.stream, 0, vocab_size - 1)

    def batch_at(self, step: int) -> dict:
        cfg = self.cfg
        rng = np.random.default_rng(
            (cfg.seed * 1_000_003 + step) * 65_537 + cfg.host_index)
        n = len(self.stream)
        need = cfg.seq_len + 1
        starts = rng.integers(0, max(n - need, 1), size=cfg.batch_size)
        rows = np.stack([self.stream[s : s + need] if s + need <= n
                         else np.pad(self.stream[s:], (0, s + need - n))
                         for s in starts])
        return {"tokens": rows[:, :-1], "labels": rows[:, 1:].astype(np.int32)}

    def __iter__(self) -> Iterator[dict]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


class PrefetchLoader:
    """Background-thread prefetch with self-backup on producer stall."""

    def __init__(self, dataset: PackedLMDataset, depth: int = 4,
                 timeout_s: float = 5.0):
        self.ds = dataset
        self.q: "queue.Queue" = queue.Queue(maxsize=depth)
        self.timeout_s = timeout_s
        self.step = 0
        self.backup_batches = 0                 # straggler-mitigation counter
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._produce, daemon=True)
        self._thread.start()

    def _produce(self):
        step = 0
        while not self._stop.is_set():
            batch = self.ds.batch_at(step)
            while not self._stop.is_set():
                try:
                    self.q.put((step, batch), timeout=0.25)
                    break
                except queue.Full:
                    continue
            step += 1

    def next(self) -> dict:
        try:
            step, batch = self.q.get(timeout=self.timeout_s)
        except queue.Empty:
            # producer is a straggler: synthesize deterministically
            batch = self.ds.batch_at(self.step)
            self.backup_batches += 1
        self.step += 1
        return batch

    def close(self):
        self._stop.set()
