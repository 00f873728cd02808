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
// A pair is written only where its slot is < capacity; count_out =
// count_in + popcount(mask), in int32, never clamped, so the caller sees
// an overflow as count_out > capacity.  The order is the reference's, so
// the buffer is bit-identical to its, not merely the same set.
//
// Bound: bytes.  The mask is read (nl * nw * 4 bytes) and 8 bytes are
// written per pair; there is one popcount and a few integer ops a word.
// The reference expands every bit to int32 (several temporaries of
// 4 bytes a bit); here the mask is read twice and nothing per bit is
// stored.  Three passes, each simple:
//
//   1. popcount_blocks: each block sums the popcounts of its 4096 words
//      (16 consecutive words a thread, one 16-byte load each 4 words when
//      the mask is 16-byte aligned) -> block_sums[b];
//   2. scan_blocks: one block takes the exclusive prefix sum of the block
//      sums -> block_base[b], and writes count_in + total -> count_out;
//   3. scatter_pairs: each block reads its words again, scans its threads'
//      popcounts (warp shuffles, one shared word a warp), and each thread
//      writes its words' pairs in order from count_in + block_base[b] +
//      its prefix, one 8-byte store a pair.
//
// Pairs are rare where the join is selective (the production plane keeps
// ~2 in 10^6 pairs), so the passes are bound by the mask's reads; a dense
// band is bound by the pair writes, which are one 8-byte store each but
// not coalesced across a warp's threads.  Not done here (later work): one
// pass with a decoupled look-back scan, so the mask is read once.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWordsPerThread = 16;
constexpr int kWordsPerBlock = kThreads * kWordsPerThread;
constexpr int kScanThreads = 1024;

// The 16 words at w0 (zeros beyond n_words): four 16-byte loads when the
// mask is 16-byte aligned and all 16 are in range, else one at a time.
__device__ __forceinline__ void load_words(const uint32_t* __restrict__ mask,
                                           long long n_words, long long w0,
                                           bool vec, uint32_t (&w)[16]) {
  if (vec && w0 + kWordsPerThread <= n_words) {
    const uint4* p = reinterpret_cast<const uint4*>(mask + w0);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const uint4 v = __ldg(p + q);
      w[4 * q] = v.x;
      w[4 * q + 1] = v.y;
      w[4 * q + 2] = v.z;
      w[4 * q + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < kWordsPerThread; ++i)
      w[i] = w0 + i < n_words ? __ldg(mask + w0 + i) : 0u;
  }
}

// Exclusive prefix sum of v over the block (blockDim.x a multiple of 32, at
// most 1024); *total gets the block's sum.  warp_sums holds 32 ints.
__device__ __forceinline__ int block_exclusive_scan(int v, int* warp_sums,
                                                    int* total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int s = lane < n_warps ? warp_sums[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, s, o);
      if (lane >= o) s += y;
    }
    if (lane < n_warps) warp_sums[lane] = s;      // inclusive warp totals
  }
  __syncthreads();
  *total = warp_sums[n_warps - 1];
  return (warp ? warp_sums[warp - 1] : 0) + x - v;
}

__global__ void __launch_bounds__(kThreads)
popcount_blocks(const uint32_t* __restrict__ mask, long long n_words,
                bool vec, int* __restrict__ block_sums) {
  __shared__ int warp_sums[32];
  const long long w0 =
      ((long long)blockIdx.x * kThreads + threadIdx.x) * kWordsPerThread;
  uint32_t w[kWordsPerThread];
  load_words(mask, n_words, w0, vec, w);
  int c = 0;
#pragma unroll
  for (int i = 0; i < kWordsPerThread; ++i) c += __popc(w[i]);
  int total;
  block_exclusive_scan(c, warp_sums, &total);
  if (threadIdx.x == 0) block_sums[blockIdx.x] = total;
}

__global__ void __launch_bounds__(kScanThreads)
scan_blocks(const int* __restrict__ block_sums, int n_blocks,
            const int* __restrict__ count_in, int* __restrict__ block_base,
            int* __restrict__ count_out) {
  __shared__ int warp_sums[32];
  // each thread a run of consecutive block sums, in order
  const int per = (n_blocks + kScanThreads - 1) / kScanThreads;
  const int b0 = threadIdx.x * per;
  const int b1 = min(b0 + per, n_blocks);
  int s = 0;
  for (int b = b0; b < b1; ++b) s += block_sums[b];
  int total;
  int run = block_exclusive_scan(s, warp_sums, &total);
  for (int b = b0; b < b1; ++b) {
    block_base[b] = run;
    run += block_sums[b];
  }
  // int32 as the reference's count: wraps, never clamps
  if (threadIdx.x == 0)
    *count_out = static_cast<int>(static_cast<uint32_t>(*count_in) +
                                  static_cast<uint32_t>(total));
}

__global__ void __launch_bounds__(kThreads)
scatter_pairs(const uint32_t* __restrict__ mask, long long n_words, int nw,
              bool vec, int row_offset, int col_offset,
              const int* __restrict__ count_in,
              const int* __restrict__ block_base, int2* __restrict__ pairs,
              long long capacity) {
  __shared__ int warp_sums[32];
  const long long w0 =
      ((long long)blockIdx.x * kThreads + threadIdx.x) * kWordsPerThread;
  uint32_t w[kWordsPerThread];
  load_words(mask, n_words, w0, vec, w);
  int c = 0;
#pragma unroll
  for (int i = 0; i < kWordsPerThread; ++i) c += __popc(w[i]);
  int total;
  const int excl = block_exclusive_scan(c, warp_sums, &total);
  if (c == 0) return;
  long long slot = (long long)*count_in + block_base[blockIdx.x] + excl;
#pragma unroll 1
  for (int i = 0; i < kWordsPerThread; ++i) {
    uint32_t bits = w[i];
    if (!bits) continue;
    const long long word = w0 + i;
    const int row = static_cast<int>(word / nw);
    const int col = static_cast<int>(word - (long long)row * nw) * 32 +
                    col_offset;
    const int r = row + row_offset;
    while (bits) {
      const int b = __ffs(bits) - 1;
      if (slot >= 0 && slot < capacity) pairs[slot] = make_int2(r, col + b);
      ++slot;
      bits &= bits - 1;
    }
  }
}

}  // namespace

extern "C" {

// Appends the set bits of the int32/uint32 (n_words / nw, nw) row-major
// mask to pairs, an int32 (capacity, 2) buffer, on `stream`.  count_in and
// count_out are int32 device scalars (distinct); scratch is int32 device
// memory of 2 * ceil(n_words / 4096) elements.  Launches nothing when
// n_words is 0 (count_out is then the caller's to set).  Returns a
// cudaError_t (0 on success).
int compact_launch(const uint32_t* mask, long long n_words, int nw,
                   int row_offset, int col_offset, const int* count_in,
                   int* count_out, int* pairs, long long capacity,
                   int* scratch, void* stream) {
  if (n_words < 0 || nw <= 0 || n_words % nw != 0 || capacity < 0 ||
      count_in == count_out)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_words == 0) return 0;
  const long long blocks = (n_words + kWordsPerBlock - 1) / kWordsPerBlock;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const int n_blocks = static_cast<int>(blocks);
  const bool vec = (reinterpret_cast<uintptr_t>(mask) & 15u) == 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* block_sums = scratch;
  int* block_base = scratch + n_blocks;
  popcount_blocks<<<n_blocks, kThreads, 0, s>>>(mask, n_words, vec,
                                                block_sums);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  scan_blocks<<<1, kScanThreads, 0, s>>>(block_sums, n_blocks, count_in,
                                         block_base, count_out);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  scatter_pairs<<<n_blocks, kThreads, 0, s>>>(
      mask, n_words, nw, vec, row_offset, col_offset, count_in, block_base,
      reinterpret_cast<int2*>(pairs), capacity);
  return static_cast<int>(cudaGetLastError());
}

const char* fdj_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
