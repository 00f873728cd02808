"""The one-pass compaction kernel (``csrc/extract.cu``) against its plain
version, bit for bit, on the card.

These tests need a CUDA device (a CUDA kernel has no CPU mode) and skip
without one; the file imports neither jax nor the JAX package:

    python -m pytest -q tests/test_torch_extract_cuda.py

The kernel takes tiles from a ticket counter and finds each tile's base
by a decoupled look-back over state that lives on between calls, one
array per (device, stream), tagged with a per-call epoch.  So beside
masks of thousands of tiles, these cases hold it over 2 000 calls back
to back on one stream (with the epoch limit forced small, so the state is
zeroed and its epochs reused hundreds of times), on two streams from two
threads at once, with the count given as an int, as a device tensor and
near 2**31, and on views that start 4 bytes past a 16-byte boundary.
The plain version (``compact_append_ref``) runs on the same CUDA inputs;
``tests/test_torch_extract.py`` holds it against the JAX package.
"""

import threading

import numpy as np
import pytest
import torch

from repro_torch.kernels.extract import kernel as ek
from repro_torch.kernels.extract.ref import compact_append_ref


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _mask(seed, nl, nw, density):
    """int32 (nl, nw) words, each bit set at ``density``, on the host."""
    rng = np.random.default_rng(seed)
    if density == 1.0:
        words = np.full((nl, nw), 0xffffffff, np.uint32)
    elif density == 0.5:
        words = rng.integers(0, 1 << 32, (nl, nw), dtype=np.uint32)
    elif nl * nw > 1 << 20:
        n_bits = nl * nw * 32
        pos = np.unique(rng.integers(0, n_bits,
                                     size=rng.binomial(n_bits, density)))
        # distinct bits of a word never carry: the sum is their OR
        words = np.bincount(pos >> 5, weights=np.ldexp(1.0, pos & 31),
                            minlength=nl * nw).astype(np.uint64)
        words = words.astype(np.uint32).reshape(nl, nw)
    else:
        bits = rng.random((nl, nw, 32)) < density
        words = (bits.astype(np.uint64) << np.arange(32, dtype=np.uint64)
                 ).sum(-1).astype(np.uint32)
    return torch.from_numpy(words.view(np.int32))


def _n_set(packed):
    """Set bits of an int32 mask, counted where it lies (SWAR popcount)."""
    x = packed.reshape(-1).to(torch.int64) & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return int((((x * 0x01010101) & 0xFFFFFFFF) >> 24).sum())


def _both(packed, cap, count=0, **offsets):
    """(kernel buffer, count), (plain buffer, count) on the card."""
    dev = packed.device
    got = torch.full((cap, 2), -1, dtype=torch.int32, device=dev)
    want = got.clone()
    _, n_got = ek.compact_append(packed, got, count, **offsets)
    _, n_want = compact_append_ref(packed, want, int(count), **offsets)
    torch.cuda.synchronize()
    return (got, int(n_got)), (want, int(n_want))


def _assert_equal(got, want):
    assert got[1] == want[1]
    assert torch.equal(got[0], want[0])


@pytest.mark.parametrize("room", ["spare", "overflow"])
@pytest.mark.parametrize("nl,nw,density", [
    (1 << 18, 128, 0.0), (1 << 18, 128, 2e-6), (1 << 18, 128, 1e-3),
    (1 << 14, 128, 0.5), (1 << 14, 128, 1.0)])
def test_masks_of_thousands_of_tiles(cuda_device, nl, nw, density, room):
    packed = _mask(nl + int(density * 1e6), nl, nw, density).to(cuda_device)
    n = _n_set(packed)
    cap = n + 64 if room == "spare" else n // 3
    for count in (0, torch.full((), 5, dtype=torch.int32,
                                device=cuda_device)):
        got, want = _both(packed, cap, count, row_offset=7, col_offset=4096)
        _assert_equal(got, want)
        assert got[1] == n + int(count)


def test_back_to_back_calls_reuse_state(cuda_device, monkeypatch):
    """2 000 calls on one stream, no synchronisation between them, masks
    of 1 to 40 tiles in turn (an unaligned view among them; the largest
    overflows), the count as an int and as a device tensor in turn; the
    epoch limit forced to 7, so the state is zeroed and each epoch reused
    hundreds of times."""
    monkeypatch.setattr(ek, "EPOCH_LIMIT", 7)
    shapes = [(1280, 128, 0.02), (3, 5, 0.5), (40, 9, 0.3), (641, 37, 0.01)]
    masks = [_mask(i, *s).to(cuda_device) for i, s in enumerate(shapes)]
    flat = torch.zeros(masks[2].numel() + 1, dtype=torch.int32,
                       device=cuda_device)
    flat[1:] = masks[2].reshape(-1)
    masks.append(flat[1:].view(masks[2].shape))
    assert masks[-1].data_ptr() % 16 == 4
    cap = 8192
    wants = []
    for m in masks:
        (_, _), want = _both(m, cap, 3)
        wants.append(want[0])
    three = torch.full((), 3, dtype=torch.int32, device=cuda_device)
    before = ek.launches["compact"]
    bufs, counts = [], []
    for i in range(2000):
        buf = torch.full((cap, 2), -1, dtype=torch.int32, device=cuda_device)
        _, cnt = ek.compact_append(masks[i % len(masks)], buf,
                                   3 if i % 2 else three)
        bufs.append(buf)
        counts.append(cnt)
    torch.cuda.synchronize()
    assert ek.launches["compact"] == before + 2000
    n_sets = [_n_set(m) for m in masks]
    for i, (buf, cnt) in enumerate(zip(bufs, counts)):
        k = i % len(masks)
        assert int(cnt) == 3 + n_sets[k], i
        assert torch.equal(buf, wants[k]), i


def test_two_threads_on_two_streams(cuda_device):
    """Two threads compact at once, each on its own stream: each stream
    has its own state, and every result equals the plain version's."""
    masks = [_mask(30 + i, 2048, 128, 0.004).to(cuda_device)
             for i in range(2)]
    cap = 40000
    wants = [_both(m, cap, 11)[1] for m in masks]
    results, errors = [[], []], []
    streams = [torch.cuda.Stream(cuda_device) for _ in range(2)]
    barrier = threading.Barrier(2)

    def work(t):
        try:
            with torch.cuda.stream(streams[t]):
                barrier.wait()
                for _ in range(150):
                    buf = torch.full((cap, 2), -1, dtype=torch.int32,
                                     device=cuda_device)
                    _, cnt = ek.compact_append(masks[t], buf, 11)
                    results[t].append((buf, cnt))
            streams[t].synchronize()
        except Exception as e:       # re-raised in the main thread
            errors.append(e)

    threads = [threading.Thread(target=work, args=(t,)) for t in range(2)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    assert not errors, errors
    dev = results[0][0][0].device
    states = {id(ek._STATE._slots[dev, s.cuda_stream][0]) for s in streams}
    assert len(states) == 2
    for t in range(2):
        for buf, cnt in results[t]:
            assert int(cnt) == wants[t][1]
            assert torch.equal(buf, wants[t][0])


@pytest.mark.parametrize("count", [0, 1000, -40, 2 ** 31 - 100,
                                   -2 ** 31])
@pytest.mark.parametrize("as_tensor", [False, True])
def test_count_as_int_tensor_and_near_2_31(cuda_device, count, as_tensor):
    packed = _mask(5, 300, 17, 0.05).to(cuda_device)
    n = _n_set(packed)
    start = torch.full((), count, dtype=torch.int32, device=cuda_device) \
        if as_tensor else count
    got, want = _both(packed, 9000, start, row_offset=3)
    _assert_equal(got, want)
    assert got[1] == (count + n + 2 ** 31) % 2 ** 32 - 2 ** 31
    if count >= 2 ** 31 - 100 or count == -2 ** 31:
        assert (got[0] == -1).all()          # every slot out of range


@pytest.mark.parametrize("shift", [1, 2, 3])
@pytest.mark.parametrize("nl,nw", [(40, 9), (700, 13), (4099, 7)])
def test_views_past_a_16_byte_boundary(cuda_device, nl, nw, shift):
    packed = _mask(nl * nw + shift, nl, nw, 0.05)
    flat = torch.zeros(nl * nw + 4, dtype=torch.int32, device=cuda_device)
    flat[shift:shift + nl * nw] = packed.reshape(-1).to(cuda_device)
    view = flat[shift:shift + nl * nw].view(nl, nw)
    assert view.data_ptr() % 16 == 4 * shift
    got, want = _both(view, _n_set(packed) + 8, 2, col_offset=32)
    _assert_equal(got, want)
    aligned, _ = _both(packed.to(cuda_device), _n_set(packed) + 8, 2,
                       col_offset=32)
    _assert_equal(got, aligned)


def test_one_launch_a_call(cuda_device):
    packed = _mask(8, 1000, 64, 0.01).to(cuda_device)
    buf = torch.full((10000, 2), -1, dtype=torch.int32, device=cuda_device)
    for count in (0, torch.zeros((), dtype=torch.int32, device=cuda_device)):
        before = ek.launches["compact"]
        ek.compact_append(packed, buf, count)
        assert ek.launches["compact"] == before + 1
    empty = torch.zeros((0, 64), dtype=torch.int32, device=cuda_device)
    before = ek.launches["compact"]
    for count in (9, torch.full((), 9, dtype=torch.int32,
                                device=cuda_device)):
        _, cnt = ek.compact_append(empty, buf, count)
        assert int(cnt) == 9
    assert ek.launches["compact"] == before      # n_words 0: no launch
