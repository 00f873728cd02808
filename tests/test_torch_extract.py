"""repro_torch on-device compaction vs the JAX reference's
``engine.extract`` (on the CPU: the compaction kernel's plain version).

Seeded numpy masks go through ``repro.engine.extract`` and through the
port's ``engine.extract``; buffers and counts must be bit-identical —
pairs in the same slots, -1 filler after the count, out-of-range slots
dropped, the count never clamped — at densities 0, 1e-3, 0.5 and 1, for
ragged word counts, non-zero offsets, overflow and appends across calls.
``grow_caps`` must agree.  The kernel itself is held against this plain
version on the card by tests/test_torch_cuda_kernels.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.engine import extract as j_extract
from repro_torch.engine import extract
from repro_torch.kernels.extract import kernel as ek


def _mask(seed, nl, nw, density):
    """Packed uint32 (nl, nw) words with each bit set at ``density``."""
    rng = np.random.default_rng(seed)
    bits = rng.random((nl, nw, 32)) < density
    words = (bits.astype(np.uint64) << np.arange(32, dtype=np.uint64)).sum(-1)
    return words.astype(np.uint32)


def _port(words):
    return torch.from_numpy(words.view(np.int32).copy())


def _assert_equal(got, want):
    buf, cnt = got
    jbuf, jcnt = want
    assert buf.dtype == torch.int32 and cnt.dtype == torch.int32
    np.testing.assert_array_equal(buf.numpy(), np.asarray(jbuf))
    assert int(cnt) == int(jcnt)


@pytest.mark.parametrize("density", [0.0, 1e-3, 0.5, 1.0])
@pytest.mark.parametrize("nl,nw", [(1, 1), (7, 3), (33, 5), (64, 12)])
def test_extract_pairs_matches_reference(nl, nw, density):
    words = _mask(nl * 100 + nw, nl, nw, density)
    n_set = int(np.unpackbits(words.view(np.uint8)).sum())
    cap = n_set + 16
    want = j_extract.extract_pairs(jnp.asarray(words), capacity=cap)
    got = extract.extract_pairs(_port(words), capacity=cap)
    _assert_equal(got, want)
    assert int(got[1]) == n_set
    assert (got[0][n_set:] == -1).all()


@pytest.mark.parametrize("row_offset,col_offset", [(0, 0), (100, 1000),
                                                    (4096, 262112)])
def test_extract_pairs_applies_offsets(row_offset, col_offset):
    words = _mask(5, 9, 4, 0.2)
    kw = dict(capacity=400, row_offset=row_offset, col_offset=col_offset)
    _assert_equal(extract.extract_pairs(_port(words), **kw),
                  j_extract.extract_pairs(jnp.asarray(words), **kw))


@pytest.mark.parametrize("density,cap", [(1.0, 10), (0.5, 100), (1e-3, 0),
                                         (0.5, 1)])
def test_extract_pairs_overflow_is_counted_not_clamped(density, cap):
    words = _mask(11, 16, 8, density)
    n_set = int(np.unpackbits(words.view(np.uint8)).sum())
    got = extract.extract_pairs(_port(words), capacity=cap)
    _assert_equal(got, j_extract.extract_pairs(jnp.asarray(words),
                                               capacity=cap))
    assert int(got[1]) == n_set                  # the true total
    assert got[0].shape == (cap, 2)
    if n_set > cap:
        assert (got[0] >= 0).all()               # the first cap slots hold pairs


def test_compact_append_across_calls_matches_reference():
    """Two chunks appended into one buffer, the second past the capacity."""
    a, b = _mask(1, 16, 2, 0.3), _mask(2, 16, 2, 0.3)
    n_a = int(np.unpackbits(a.view(np.uint8)).sum())
    cap = n_a + 20                               # b overflows the buffer
    jbuf = jnp.full((cap, 2), -1, jnp.int32)
    jbuf, jcnt = j_extract.compact_append(jnp.asarray(a), jbuf,
                                          jnp.zeros((), jnp.int32))
    jbuf, jcnt = j_extract.compact_append(jnp.asarray(b), jbuf, jcnt,
                                          row_offset=16, col_offset=64)
    buf = torch.full((cap, 2), -1, dtype=torch.int32)
    buf, cnt = extract.compact_append(_port(a), buf, 0)
    assert int(cnt) == n_a
    buf, cnt = extract.compact_append(_port(b), buf, cnt, row_offset=16,
                                      col_offset=64)
    _assert_equal((buf, cnt), (jbuf, jcnt))
    assert int(cnt) > cap


@pytest.mark.parametrize("caps,counts", [
    ([64], [64]), ([64], [65]), ([8], [5000]), ([1], [2]),
    ([1024, 4096, 16], [0, 20000, 17]),
])
def test_grow_caps_matches_reference(caps, counts):
    got = extract.grow_caps(caps, counts)
    np.testing.assert_array_equal(got, j_extract.grow_caps(caps, counts))
    assert got.dtype == np.int64


def test_compaction_rejects_masks_of_2_31_bits():
    """int32 counts, as the reference's: a band of 2**31 bits could wrap."""
    packed = torch.zeros((1, 1), dtype=torch.int32).expand(1 << 16, 1 << 10)
    buf = torch.empty((4, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="2\\*\\*31"):
        extract.compact_append(packed, buf, 0)
    with pytest.raises(ValueError, match="int32"):
        extract.compact_append(packed[:2], torch.empty((4, 2)), 0)


def test_cpu_compaction_launches_no_kernel():
    """On CPU tensors the wrapper runs the plain version and counts no
    launch."""
    ek.launches["compact"] = 0
    extract.extract_pairs(_port(_mask(0, 4, 2, 0.5)), capacity=8)
    assert ek.launches["compact"] == 0
