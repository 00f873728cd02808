"""The port's copy of the training data pipeline (``data/pipeline.py``)
against the reference's: the byte tokenizer, host-sharded packing and the
prefetch loader's straggler backup."""

import numpy as np
import pytest

from repro.data import pipeline as ref_pipeline
from repro_torch.data.pipeline import (ByteTokenizer, PackedLMConfig,
                                       PackedLMDataset, PrefetchLoader)


@pytest.mark.parametrize("vocab", [128, 259, 512, 200064])
def test_byte_tokenizer_matches_reference(vocab):
    texts = ["Do records 12 and 34 refer to the same incident?", "",
             "héllo wörld — ✓", "\x00\x7f tabs\tand\nnewlines"]
    ours, ref = ByteTokenizer(vocab), ref_pipeline.ByteTokenizer(vocab)
    assert ours.vocab_size == ref.vocab_size
    for t in texts:
        ids = ours.encode(t)
        assert ids.dtype == np.int32
        np.testing.assert_array_equal(ids, ref.encode(t))
        assert ours.decode(ids) == ref.decode(ids) == t
    junk = [0, 1, 2, 3, 258, 259, 100000]
    assert ours.decode(junk) == ref.decode(junk)


@pytest.mark.parametrize("seed", range(4))
def test_tokenizer_roundtrip(seed):
    rng = np.random.default_rng(8000 + seed)
    tok = ByteTokenizer(512)
    for _ in range(10):
        text = "".join(chr(rng.integers(32, 127))
                       for _ in range(rng.integers(1, 80)))
        assert tok.decode(tok.encode(text)) == text


@pytest.mark.parametrize("seed", [0, 7, 123])
def test_pipeline_batches_deterministic_and_match_reference(seed):
    texts = [f"document {i} with some text body" for i in range(20)]
    for host in range(2):
        kw = dict(seq_len=32, batch_size=4, seed=seed, host_index=host,
                  host_count=2)
        a = PackedLMDataset(texts, PackedLMConfig(**kw)).batch_at(7)
        b = PackedLMDataset(texts, PackedLMConfig(**kw)).batch_at(7)
        ref = ref_pipeline.PackedLMDataset(
            texts, ref_pipeline.PackedLMConfig(**kw)).batch_at(7)
        for key in ("tokens", "labels"):
            assert np.array_equal(a[key], b[key])
            assert np.array_equal(a[key], ref[key])


def test_pipeline_host_sharding_partitions_docs():
    texts = [f"doc {i}" for i in range(10)]
    streams = []
    for h in range(2):
        cfg = PackedLMConfig(seq_len=8, batch_size=1, host_index=h, host_count=2)
        streams.append(PackedLMDataset(texts, cfg).stream)
    # different hosts own different documents
    assert not np.array_equal(streams[0], streams[1])


def test_prefetch_backup_on_straggler():
    texts = ["some training text here"] * 4
    ds = PackedLMDataset(texts, PackedLMConfig(seq_len=16, batch_size=2))

    class StalledLoader(PrefetchLoader):
        def _produce(self):     # producer never produces: permanent straggler
            pass

    loader = StalledLoader(ds, timeout_s=0.05)
    b = loader.next()
    assert b["tokens"].shape == (2, 16)
    assert loader.backup_batches == 1          # self-backup path exercised
    # deterministic: backup equals what the producer would have made
    np.testing.assert_array_equal(b["tokens"], ds.batch_at(0)["tokens"])
    loader.close()
