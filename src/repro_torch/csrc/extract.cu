// On-device candidate compaction for Hopper (sm_90a), plain C interface.
//
// Replaces the JAX package's `compact_append` (src/repro/engine/
// extract.py:53), which XLA computes outside any Pallas kernel: the set
// bits of a packed uint32 (nl, nw) mask become (i, j) index pairs, appended
// to an int32 (capacity, 2) buffer at count_in + (the bit's rank in
// row-major word order, lowest bit of a word first):
//
//   pair = (row + row_offset, 32 * w + b + col_offset)
//
// A pair is written only where its slot is in [0, capacity); count_out =
// count_in + popcount(mask), in int32, never clamped, so the caller sees
// an overflow as count_out > capacity.  The order is the reference's, so
// the buffer is bit-identical to its, not merely the same set.
//
// Bound: bytes.  The mask must be read once (nl * nw * 4 bytes) and 8
// bytes written a pair; there is one popcount and a few integer ops a
// word.  A production band keeps ~2 in 10^6 bits, so there the mask's
// read is the whole bound; a dense band (the ring's main band keeps 1.8 %)
// adds its pair writes.
//
// One kernel, one pass (Merrill & Garland, "Single-pass Parallel Prefix
// Scan with Decoupled Look-back", 2016), so the mask is read once:
//
//   * a block takes the next tile of 8192 words (32 KB) from a ticket
//     counter, so every tile it waits on belongs to a block that is
//     already running;
//   * it loads the tile once, eight 16-byte loads a thread where the mask
//     is 16-byte aligned (a warp's load covers 512 consecutive bytes),
//     popcounts the words, and scans the counts inside the block;
//   * it publishes its aggregate, and one warp looks back over its
//     predecessors' aggregates and inclusive prefixes, 32 tiles a step,
//     until it has its base, then publishes its own inclusive prefix; the
//     block of the last tile writes count_out;
//   * a tile without pairs is done there (its other warps leave right
//     after the scan).  A tile with pairs keeps its words in shared
//     memory, not registers, through the look-back: holding them in
//     registers takes 56 registers a thread, four blocks an SM, and the
//     look-back then idles the SM's loads;
//   * each warp writes its pairs from those words: it stages up to 128
//     pairs at a time in shared memory in slot order and writes them with
//     consecutive lanes on consecutive slots, so a dense band's 8-byte
//     stores are coalesced.
//
// The look-back is what keeps the kernel from its bound: a block holds
// its SM slot until its predecessors have published, so the read runs
// below HBM's rate.  On an H100 a wider look-back (up to 16 tiles a
// lane), a block-wide one, relaxed polling and a back-off were each no
// faster, and holding the words in registers was slower.
//
// The look-back state outlives the call and needs no reset launch: each
// 64-bit state word carries the call's epoch (from the host), so a word of
// an earlier call never matches, and the block that draws the last ticket
// sets the counter back to 0.  The caller keeps one state array per
// (device, stream) and zeroes it before an epoch is reused.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRounds = 8;                         // 16-byte groups a thread
constexpr int kPacks = kRounds / 4;                // four 16-bit counts each
constexpr int kRoundWords = 4 * kThreads;          // a round: 1024 words
constexpr int kTileWords = kRounds * kRoundWords;  // 8192 words a tile
constexpr int kStage = 128;                        // pairs a warp stages
constexpr int kBlocksPerSM = 4;                    // 64 registers a thread
constexpr long long kMaxWords = 1LL << 26;         // 2^31 bits: int32 counts
constexpr unsigned int kEpochLimit = 1u << 30;

// A tile's state word: the value in bits 0-31, the flag in bits 32-33, the
// call's epoch in bits 34-63 (0 = never written).
constexpr unsigned long long kAggregate = 1ull << 32;
constexpr unsigned long long kPrefix = 2ull << 32;
constexpr int kEpochShift = 34;

__device__ __forceinline__ unsigned long long load_acquire(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];"
               : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_release(unsigned long long* p,
                                              unsigned long long v) {
  asm volatile("st.release.gpu.global.u64 [%0], %1;"
               :: "l"(p), "l"(v) : "memory");
}

// 16 bytes of the mask, read once: not kept in L1
__device__ __forceinline__ uint4 load_streaming(const uint32_t* p) {
  uint4 v;
  asm("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "l"(p));
  return v;
}

// the count of round q in a thread's packed counts (16 bits a round)
__device__ __forceinline__ unsigned int field(
    const unsigned long long (&v)[kPacks], int q) {
  return static_cast<unsigned int>(v[q / 4] >> (16 * (q % 4))) & 0xffffu;
}

__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
compact_onepass(const uint32_t* __restrict__ mask, int n_words, int nw,
                bool vec, int row_offset, int col_offset, long long count_value,
                const int* __restrict__ count_in, int* __restrict__ count_out,
                int2* __restrict__ pairs, long long capacity,
                unsigned long long* __restrict__ state, unsigned int epoch,
                int n_tiles) {
  __shared__ int s_tile;
  __shared__ unsigned int s_excl;
  __shared__ unsigned long long s_warp[kPacks][kWarps];
  __shared__ uint4 s_words[kRounds][kThreads];     // a tile that has pairs
  __shared__ int2 s_stage[kWarps][kStage];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  unsigned int* ticket = reinterpret_cast<unsigned int*>(state);
  unsigned long long* tiles = state + 1;

  if (tid == 0) {
    const int t = static_cast<int>(atomicAdd(ticket, 1u));
    if (t == n_tiles - 1) atomicExch(ticket, 0u);   // every ticket is drawn
    s_tile = t;
  }
  __syncthreads();
  const int tile = s_tile;

  // round q of thread t: words [tile * 8192 + q * 1024 + 4t, +4)
  const int w0 = tile * kTileWords + 4 * tid;
  uint4 w[kRounds];
#pragma unroll
  for (int q = 0; q < kRounds; ++q) {
    const int g = w0 + q * kRoundWords;
    if (vec && g + 4 <= n_words) {
      w[q] = load_streaming(mask + g);
    } else {
      uint32_t e[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        e[i] = g + i < n_words ? __ldg(mask + g + i) : 0u;
      w[q] = make_uint4(e[0], e[1], e[2], e[3]);
    }
  }
  unsigned long long counts[kPacks] = {}, incl[kPacks];
#pragma unroll
  for (int q = 0; q < kRounds; ++q)
    counts[q / 4] |= static_cast<unsigned long long>(
        __popc(w[q].x) + __popc(w[q].y) + __popc(w[q].z) + __popc(w[q].w))
        << (16 * (q % 4));

  // the rounds' counts scanned over the warp, four rounds a 64-bit word
#pragma unroll
  for (int p = 0; p < kPacks; ++p) {
    incl[p] = counts[p];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const unsigned long long y = __shfl_up_sync(0xffffffffu, incl[p], o);
      if (lane >= o) incl[p] += y;
    }
    if (lane == 31) s_warp[p][warp] = incl[p];
    counts[p] = incl[p] - counts[p];          // now the lane's exclusive
  }
  __syncthreads();
  unsigned int agg = 0;
#pragma unroll
  for (int p = 0; p < kPacks; ++p) {
    unsigned long long total = 0;
#pragma unroll
    for (int i = 0; i < kWarps; ++i) total += s_warp[p][i];
#pragma unroll
    for (int f = 0; f < 4; ++f)
      agg += static_cast<unsigned int>(total >> (16 * f)) & 0xffffu;
  }
  const unsigned long long tag =
      static_cast<unsigned long long>(epoch) << kEpochShift;
  if (tid == 0)
    store_release(&tiles[tile], tag | (tile ? kAggregate : kPrefix) | agg);
  // a tile with pairs keeps its words in shared memory, not in registers,
  // through the look-back; an empty tile needs only the look-back's warp
  if (agg != 0) {
#pragma unroll
    for (int q = 0; q < kRounds; ++q) s_words[q][tid] = w[q];
  } else if (warp != 0) {
    return;
  }

  if (warp == 0) {
    unsigned int excl = 0;
    if (tile > 0) {
      for (int pred = tile - 1;; pred -= 32) {
        const int idx = pred - lane;          // lane 0 is the nearest
        unsigned long long s;
        do {
          s = idx >= 0 ? load_acquire(&tiles[idx]) : (tag | kPrefix);
        } while (__any_sync(0xffffffffu, (s >> kEpochShift) != epoch));
        const unsigned int prefixes = __ballot_sync(0xffffffffu,
                                                    (s & kPrefix) != 0);
        // sum back to the nearest inclusive prefix
        const int stop = prefixes ? __ffs(prefixes) - 1 : 31;
        unsigned int v = lane <= stop ? static_cast<unsigned int>(s) : 0u;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          v += __shfl_xor_sync(0xffffffffu, v, o);
        excl += v;
        if (prefixes) break;
      }
      if (lane == 0)
        store_release(&tiles[tile], tag | kPrefix | (excl + agg));
    }
    if (lane == 0) {
      s_excl = excl;
      if (tile == n_tiles - 1) {
        const long long cin = count_in ? *count_in : count_value;
        // int32 as the reference's count: wraps, never clamps
        *count_out = static_cast<int>(static_cast<uint32_t>(cin) + excl +
                                      agg);
      }
    }
  }
  if (agg == 0) return;
  __syncthreads();

  const long long cin = count_in ? __ldg(count_in) : count_value;
  const long long tile_slot = cin + s_excl;
  unsigned long long before[kPacks] = {}, warp_total[kPacks];
#pragma unroll
  for (int p = 0; p < kPacks; ++p) {
    warp_total[p] = s_warp[p][warp];
#pragma unroll
    for (int i = 0; i < kWarps; ++i)
      if (i < warp) before[p] += s_warp[p][i];
  }
  unsigned int round_base = 0;
#pragma unroll
  for (int q = 0; q < kRounds; ++q) {
    const unsigned int n_wq = field(warp_total, q);      // the warp's pairs
    if (n_wq != 0) {
      const long long wq_slot = tile_slot + round_base + field(before, q);
      unsigned int pos = field(counts, q);               // my next pair
      const uint4 v = s_words[q][tid];
      uint32_t e[4] = {v.x, v.y, v.z, v.w};
      int2* stage = s_stage[warp];
      // the row and word column of this thread's first word of the round
      // (one division: the next three step from it)
      const int g = w0 + q * kRoundWords;
      int row0 = 0, cw0 = 0;
      if (e[0] | e[1] | e[2] | e[3]) {
        row0 = g / nw;
        cw0 = g - row0 * nw;
      }
#pragma unroll 1
      for (unsigned int start = 0; start < n_wq; start += kStage) {
        const unsigned int end = start + kStage;
        int row = row0, cw = cw0;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (e[i] && pos < end) {
            const int r = row + row_offset;
            const int col = cw * 32 + col_offset;
            do {
              const int b = __ffs(e[i]) - 1;
              stage[pos - start] = make_int2(r, col + b);
              ++pos;
              e[i] &= e[i] - 1;
            } while (e[i] && pos < end);
          }
          if (++cw == nw) {
            cw = 0;
            ++row;
          }
        }
        __syncwarp();
        const unsigned int n = min(static_cast<unsigned int>(kStage),
                                   n_wq - start);
        for (unsigned int i = lane; i < n; i += 32) {
          const long long slot = wq_slot + start + i;
          if (slot >= 0 && slot < capacity) pairs[slot] = stage[i];
        }
        __syncwarp();
      }
    }
    // every warp's share of round q, summed over the block
#pragma unroll
    for (int i = 0; i < kWarps; ++i)
      round_base += static_cast<unsigned int>(
          s_warp[q / 4][i] >> (16 * (q % 4))) & 0xffffu;
  }
}

}  // namespace

extern "C" {

// Appends the set bits of the int32/uint32 (n_words / nw, nw) row-major
// mask to pairs, an int32 (capacity, 2) buffer, on `stream`, in one
// launch.  The count before the call is *count_in when count_in is not
// null (an int32 device scalar, distinct from count_out), else
// count_value; count_out is an int32 device scalar.  state is the
// look-back state of this stream: state_words 64-bit words, zero before
// its first call, ceil(n_words / 8192) + 1 of them at least, never used
// by two streams at once; epoch is this call's tag, in [1, 2^30), and
// differs from every epoch written to state since it was last zeroed.
// Launches nothing when n_words is 0 (count_out is then the caller's to
// set).  Returns a cudaError_t (0 on success).
int compact_launch(const uint32_t* mask, long long n_words, int nw,
                   int row_offset, int col_offset, long long count_value,
                   const int* count_in, int* count_out, int* pairs,
                   long long capacity, unsigned long long* state,
                   long long state_words, unsigned int epoch, void* stream) {
  if (n_words < 0 || n_words >= kMaxWords || nw <= 0 || n_words % nw != 0 ||
      capacity < 0 || !count_out || count_in == count_out || epoch == 0 ||
      epoch >= kEpochLimit ||
      (!count_in &&
       (count_value < -2147483648LL || count_value > 2147483647LL)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_words == 0) return 0;
  const int n_tiles = static_cast<int>((n_words + kTileWords - 1) / kTileWords);
  if (state_words < n_tiles + 1LL)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = (reinterpret_cast<uintptr_t>(mask) & 15u) == 0;
  compact_onepass<<<n_tiles, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      mask, static_cast<int>(n_words), nw, vec, row_offset, col_offset,
      count_value, count_in, count_out, reinterpret_cast<int2*>(pairs),
      capacity, state, epoch, n_tiles);
  return static_cast<int>(cudaGetLastError());
}

const char* fdj_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
