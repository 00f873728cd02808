"""What the one-pass compaction's wrapper reckons in Python, on the CPU.

``kernels/extract/kernel.py`` computes, without the card: the bytes bound
of a call (``bytes_bound``), the look-back state's size and its key by
(device, stream) with a per-call epoch (``LookBackState``), how ``count``
reaches the kernel (``count_arg``: an int by value, a device tensor by
pointer) and the C entry point's arguments (``launch_args``).  The
kernel itself is held against its plain version on the card by
``tests/test_torch_extract_cuda.py``; the constants it shares with
``csrc/extract.cu`` are read from the source here.
"""

import os
import re

import numpy as np
import pytest
import torch

from repro_torch.kernels.extract import kernel as ek

CSRC = os.path.join(os.path.dirname(ek.__file__), "..", "..", "csrc",
                    "extract.cu")


@pytest.mark.parametrize("nl,nw,n_pairs,cap,want", [
    # the ring main path's first band (PERF.md): every pair written
    (2816, 16, 25659, 45056, 4 * 2816 * 16 + 8 * 25659 + 8),
    # a production band: 2**30 bits, 1 632 pairs, the ring's capacity
    (262144, 128, 1632, 4 * 262144, 134217728 + 8 * 1632 + 8),
])
def test_bytes_bound_matches_hand_counts(nl, nw, n_pairs, cap, want):
    assert ek.bytes_bound(nl, nw, n_pairs, cap) == want
    assert want in (385504, 134230792)


@pytest.mark.parametrize("n_pairs,cap,count,written", [
    (100, 40, 0, 40),              # overflow: only the slots that exist
    (100, 1000, 950, 50),          # appended after 950: the tail dropped
    (100, 1000, -30, 70),          # negative start: its first 30 dropped
    (100, 1000, 2 ** 31 - 10, 0),  # near 2**31: nothing written
    (0, 1000, 0, 0),
])
def test_bytes_bound_counts_only_written_pairs(n_pairs, cap, count, written):
    assert ek.bytes_bound(3, 5, n_pairs, cap, count) == 60 + 8 * written + 8


def test_constants_match_the_kernel_source():
    with open(CSRC) as f:
        src = f.read()
    assert len(re.findall(r"__global__", src)) == 1
    assert "kTileWords = kRounds * kRoundWords" in src
    rounds = int(re.search(r"kRounds = (\d+);", src).group(1))
    threads = int(re.search(r"kThreads = (\d+);", src).group(1))
    assert rounds * 4 * threads == ek.TILE_WORDS
    assert re.search(r"kEpochLimit = 1u << (\d+);", src).group(1) == \
        str(ek.EPOCH_LIMIT.bit_length() - 1)
    assert re.search(r"kMaxWords = 1LL << (\d+);", src).group(1) == \
        str((ek.MAX_BITS // 32).bit_length() - 1)


def test_state_is_sized_for_the_largest_mask():
    """The largest mask a call takes has 2**26 - 1 words; its tiles and the
    ticket fit, so the state never grows."""
    largest = ek.MAX_BITS // 32 - 1
    assert -(-largest // ek.TILE_WORDS) + 1 == ek.STATE_WORDS
    assert ek.STATE_WORDS == 1 + 8192
    assert ek.EPOCH_LIMIT == 1 << 30


def test_state_is_kept_per_device_and_stream():
    st = ek.LookBackState()
    cpu, meta = torch.device("cpu"), torch.device("meta")
    a1, e1 = st.take(cpu, 11)
    a2, e2 = st.take(cpu, 11)
    b1, f1 = st.take(cpu, 12)
    c1, g1 = st.take(meta, 11)
    assert a1 is a2 and (e1, e2) == (1, 2)
    assert b1 is not a1 and f1 == 1
    assert c1 is not a1 and c1.device == meta and g1 == 1
    for t in (a1, b1):
        assert t.dtype == torch.int64 and t.numel() == ek.STATE_WORDS
        assert int(t.abs().sum()) == 0


def test_state_is_zeroed_before_an_epoch_repeats(monkeypatch):
    monkeypatch.setattr(ek, "EPOCH_LIMIT", 4)
    st = ek.LookBackState()
    dev = torch.device("cpu")
    epochs = []
    for i in range(8):
        state, epoch = st.take(dev, 0)
        if epoch == 1:
            assert int(state.abs().sum()) == 0
        state[1 + i] = (epoch << 34) | (2 << 32) | 5     # a written tile
        epochs.append(epoch)
    assert epochs == [1, 2, 3, 1, 2, 3, 1, 2]


@pytest.mark.parametrize("count,value", [
    (0, 0), (7, 7), (-3, -3), (2 ** 31 - 1, 2 ** 31 - 1), (-2 ** 31, -2 ** 31),
    (np.int64(9), 9), (np.int32(-9), -9)])
def test_an_int_count_goes_by_value(count, value):
    v, t = ek.count_arg(count, torch.device("cpu"))
    assert (v, t) == (value, None) and type(v) is int


@pytest.mark.parametrize("count", [2 ** 31, -2 ** 31 - 1, 2 ** 40])
def test_an_int_count_outside_int32_is_refused(count):
    with pytest.raises(ValueError, match="not an int32"):
        ek.count_arg(count, torch.device("cpu"))


@pytest.mark.parametrize("shape", [(), (1,), (1, 1)])
def test_a_tensor_count_goes_by_pointer(shape):
    c = torch.full(shape, 5, dtype=torch.int32)
    v, t = ek.count_arg(c, torch.device("cpu"))
    assert v == 0 and t.shape == () and t.data_ptr() == c.data_ptr()


@pytest.mark.parametrize("bad", [
    torch.zeros((), dtype=torch.int64), torch.zeros(2, dtype=torch.int32),
    torch.zeros((), dtype=torch.int32, device="meta")])
def test_a_bad_tensor_count_is_refused(bad):
    with pytest.raises(ValueError, match="int32 scalar"):
        ek.count_arg(bad, torch.device("cpu"))


@pytest.mark.parametrize("as_tensor", [False, True])
def test_launch_args_route_the_count(as_tensor):
    packed = torch.zeros((12, 5), dtype=torch.int32)
    buf = torch.full((64, 2), -1, dtype=torch.int32)
    state = torch.zeros(ek.STATE_WORDS, dtype=torch.int64)
    count = torch.full((), 9, dtype=torch.int32) if as_tensor else 9
    args, count_out = ek.launch_args(packed, buf, count, 3, 64, 1234, state,
                                     17)
    assert len(args) == len(ek._ARGTYPES)
    (mask, n_words, nw, ro, co, value, count_in, out, pairs, cap, st,
     st_words, epoch, stream) = args
    assert (mask, n_words, nw, ro, co) == (packed.data_ptr(), 60, 5, 3, 64)
    if as_tensor:
        assert (value, count_in) == (0, count.data_ptr())
    else:
        assert (value, count_in) == (9, None)
    assert out == count_out.data_ptr() and count_out.shape == ()
    assert count_out.dtype == torch.int32 and out != count_in
    assert (pairs, cap) == (buf.data_ptr(), 64)
    assert (st, st_words, epoch, stream) == (state.data_ptr(),
                                             ek.STATE_WORDS, 17, 1234)


def test_cpu_tensors_still_take_the_plain_version():
    """No launch on the CPU: the plain version, the counter untouched."""
    packed = torch.tensor([[0b1011, 0], [0, -2 ** 31]], dtype=torch.int32)
    buf = torch.full((8, 2), -1, dtype=torch.int32)
    before = ek.launches["compact"]
    buf, cnt = ek.compact_append(packed, buf, 2, row_offset=10)
    assert int(cnt) == 6 and ek.launches["compact"] == before
    assert buf[2:6].tolist() == [[10, 0], [10, 1], [10, 3], [11, 63]]
    assert (buf[:2] == -1).all() and (buf[6:] == -1).all()
