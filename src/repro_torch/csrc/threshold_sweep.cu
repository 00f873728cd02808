// Threshold sweep for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel `threshold_sweep` (src/repro/kernels/
// threshold_sweep/kernel.py, body `_sweep_kernel`).  For G candidate
// threshold rows over k labeled sample rows of C clause distances:
//
//   pos[g] = sum_i valid_i * label_i * AND_c (cd[i, c] <= theta[g, c])
//   sel[g] = sum_i valid_i *           AND_c (cd[i, c] <= theta[g, c])
//
// Pad rows are excluded only by `valid` (inf <= inf is true, so no
// sentinel distance can exclude them).  Labels and valid are 0/1 floats;
// any nonzero value counts as 1.  NaN fails `<=` on either side; -0.0 and
// +0.0 compare equal.  Counts are exact int32, independent of block order.
//
// Two routes, chosen by the caller from the thresholds alone.
//
// Ranked route (threshold_sweep_ranked_launch).  Let axis_c be the sorted
// distinct non-NaN values of theta[:, c] (-0.0 merged into +0.0), u_c
// values long.  With r_c = #(axis_c < cd[i, c]) and theta[g, c] =
// axis_c[j_c], cd[i, c] <= theta[g, c] iff r_c <= j_c.  So a sample row's
// pass/fail against every threshold row depends only on its rank vector
// r, and pos/sel are dominance counts over prod(u_c) bins:
//   kernel 1 ranks every sample row (a binary search per clause, axes in
//     shared memory), drops rows that are invalid, NaN, or above every
//     value of some axis (r_c == u_c: they pass no threshold row), and
//     histograms (label, 1) by the row-major mixed-radix bin of r into an
//     int32 (bins, 2) table: a grid-stride loop over k, 4 rows a thread
//     a step, with as many blocks as the card holds at once (up to 8 of
//     256 threads a SM) or as k needs, privatised counts merged with one
//     atomicAdd per (block, bin).  Up to 32 bins each lane
//     of a warp keeps one bin's counts in registers, fed by ballots over
//     the bins its warp's rows fell into; above 32 a block keeps one
//     shared-memory histogram of 16-bit (pos, sel) pairs packed in 32
//     bits (a block walks at most 63 * 1024 rows, so neither half
//     overflows), fed by one shared atomic per distinct bin of a warp,
//     found by __match_any_sync, so rows of one bin in a warp never
//     contend.
//     The same grid also finds each threshold row's bin, j_c = the lower
//     bound of theta[g, c] on axis_c, and leaves it in out[2 g]: a code
//     for a NaN, another for a value missing from its axis (a caller
//     error, which comes out as (-1, -1), never as a wrong count).
//   kernel 2 (one block) loads the table into shared memory, takes an
//     inclusive prefix along each clause in turn (a warp's shuffle scan
//     along contiguous lines; along strided ones, lines cut into chunks so
//     that the block stays busy however long the lines), and writes
//     out[g] = table[bin of g], or (0, 0) for a NaN.
// Work is O(k * C * log u) instead of O(G * k * C), and no k or G padding
// is needed.  The bound is bytes: 4 k (C + 2) + 4 G C + 8 G, each input
// read once and the output written once (11.2 MB on the main path, k
// 700 000 and C 2: 3.35 us at 3.35 TB/s); the rank, histogram and prefix
// operations are negligible beside it.  What it does about the direct
// route's faults on the main path: the 254 of 256 pad threshold rows the
// direct route compares against are gone (G is not padded), the grid is
// sized by k and the card, not by G (1 x 86 blocks there), and a row
// costs C short binary searches and a ballot round instead of G compares.  Bins are limited to 2^14
// (the table in one block's shared memory, 128 KB); every candidate_grid
// up to C = 6 fits.
//
// Direct route (threshold_sweep_launch), for thresholds whose bin space
// exceeds 2^14.  The Pallas kernel carries its sums across a sequential
// k grid axis by revisiting its output block.  Hopper blocks run in no
// fixed order, so nothing carries over between them: each block owns a
// strip of 256 candidate rows (one per thread, its thresholds in
// registers) and one chunk of k, stages the chunk's distances and a
// packed valid/label code per row through shared memory (every thread
// reads the same row: a broadcast), counts in registers, and adds its two
// counts per row into an int32 (G, 2) output with atomicAdd.  Integer
// atomics make the result exact and independent of block order; f32
// counts would be exact only below 2^24.  Bound: instruction throughput,
// about G * k * (C + 2) compare/AND/add operations (1.1e10 at G = 4096,
// k = 7e5, C = 2); the inputs are read once per candidate strip and are
// small beside that (k * (C + 2) * 4 bytes).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kThreads = 256;          // candidate rows per block
constexpr int kStaged = 1024;          // sample rows staged per step
constexpr int kRowsPerBlock = 8192;    // sample rows owned by one block
constexpr int kMaxClauses = 32;
constexpr int kMaxUnrolled = 8;

// CT > 0: C known at compile time, thresholds in registers.
// CT == 0: any C up to kMaxClauses, thresholds in shared memory.
template <int CT>
__global__ void __launch_bounds__(kThreads)
sweep_kernel(const float* __restrict__ cd, const float* __restrict__ labels,
             const float* __restrict__ valid, const float* __restrict__ thetas,
             int k, int g_rows, int n_c, int32_t* __restrict__ out) {
  const int nc = CT > 0 ? CT : n_c;
  extern __shared__ float smem[];
  float* cd_s = smem;                                          // kStaged * nc
  int* code_s = reinterpret_cast<int*>(smem + kStaged * nc);   // kStaged
  float* th_s = reinterpret_cast<float*>(code_s + kStaged);    // nc * kThreads

  const int tid = threadIdx.x;
  const int g = blockIdx.x * kThreads + tid;
  const bool live = g < g_rows;
  float th[CT > 0 ? CT : 1];
  if (CT > 0) {
#pragma unroll
    for (int c = 0; c < (CT > 0 ? CT : 1); ++c)
      th[c] = live ? thetas[(long long)g * nc + c] : -INFINITY;
  } else {
    for (int c = 0; c < nc; ++c)
      th_s[c * kThreads + tid] = live ? thetas[(long long)g * nc + c] : -INFINITY;
  }

  int pos = 0, sel = 0;
  const long long k0 = (long long)blockIdx.y * kRowsPerBlock;
  const long long k1 = min((long long)k, k0 + kRowsPerBlock);
  for (long long s0 = k0; s0 < k1; s0 += kStaged) {
    const int n = static_cast<int>(min((long long)kStaged, k1 - s0));
    __syncthreads();                   // the previous step's readers are done
    for (int e = tid; e < n * nc; e += kThreads) cd_s[e] = cd[s0 * nc + e];
    for (int e = tid; e < n; e += kThreads) {
      const bool v = valid[s0 + e] != 0.0f;
      const bool l = labels[s0 + e] != 0.0f;
      code_s[e] = v ? (1 | (l ? 2 : 0)) : 0;
    }
    __syncthreads();
#pragma unroll 4
    for (int i = 0; i < n; ++i) {
      bool ok = true;
      if (CT > 0) {
#pragma unroll
        for (int c = 0; c < (CT > 0 ? CT : 1); ++c)
          ok &= (cd_s[i * nc + c] <= th[c]);
      } else {
        for (int c = 0; c < nc; ++c)
          ok &= (cd_s[i * nc + c] <= th_s[c * kThreads + tid]);
      }
      const int m = ok ? code_s[i] : 0;
      sel += m & 1;
      pos += m >> 1;
    }
  }
  if (live) {
    atomicAdd(&out[2 * g], pos);
    atomicAdd(&out[2 * g + 1], sel);
  }
}

template <int CT>
cudaError_t launch(const float* cd, const float* labels, const float* valid,
                   const float* thetas, int k, int g_rows, int n_c,
                   int32_t* out, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (static_cast<size_t>(kStaged) * n_c +
                                       kStaged +
                                       (CT > 0 ? 0 : static_cast<size_t>(n_c) * kThreads));
  cudaError_t err = cudaFuncSetAttribute(
      sweep_kernel<CT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((g_rows + kThreads - 1) / kThreads,
                  (k + kRowsPerBlock - 1) / kRowsPerBlock);
  sweep_kernel<CT><<<grid, kThreads, smem, stream>>>(cd, labels, valid, thetas,
                                                     k, g_rows, n_c, out);
  return cudaGetLastError();
}

}  // namespace

namespace ranked {

constexpr int kMaxClauses = 32;
constexpr int kMaxBins = 1 << 14;
constexpr int kBallotBins = 32;        // up to this many bins: lane b owns bin b
constexpr int kThreads = 256;          // kernel 1
constexpr int kRows = 4;               // sample rows a thread loads per step
constexpr int kMaxSteps = 63;          // 63 * kThreads * kRows < 2^16 rows a block
constexpr int kAxesInShared = 8192;    // axis values staged in shared memory
constexpr int kPrefixThreads = 1024;   // kernel 2
constexpr unsigned kFull = 0xffffffffu;

// Axis c is values[off[c] .. off[c + 1]); bins = prod of the lengths.
struct Axes {
  int n_c;
  int bins;
  int off[kMaxClauses + 1];
};

// #(a[0..n) < x), a sorted ascending.
__device__ __forceinline__ int lower_bound(const float* a, int n, float x) {
  int lo = 0;
  while (n > 0) {
    const int half = n >> 1;
    if (a[lo + half] < x) {
      lo += half + 1;
      n -= half + 1;
    } else {
      n = half;
    }
  }
  return lo;
}

// The sample row's bin, or -1 if it passes no threshold row.
template <int CT>
__device__ __forceinline__ int row_bin(const float* x, const float* axv,
                                       const Axes& ax, int nc) {
  int bin = 0;
  bool keep = true;
#pragma unroll
  for (int c = 0; c < (CT > 0 ? CT : nc); ++c) {
    const int u = ax.off[c + 1] - ax.off[c];
    const int r = lower_bound(axv + ax.off[c], u, x[c]);
    keep &= (x[c] == x[c]) & (r < u);
    bin = bin * u + r;
  }
  return keep ? bin : -1;
}

constexpr int kNaN = -2;               // a threshold row holding a NaN
constexpr int kMissing = -1;           // a threshold value not on its axis

// A threshold row's bin (the lower bound of each value on its axis), or
// kNaN, or kMissing.
__device__ __forceinline__ int theta_bin(const float* th, const float* axv,
                                         const Axes& ax, int nc) {
  int bin = 0;
  bool nan = false, missing = false;
  for (int c = 0; c < nc; ++c) {
    const float t = th[c];
    const int u = ax.off[c + 1] - ax.off[c];
    const float* a = axv + ax.off[c];
    const int j = lower_bound(a, u, t);
    nan |= t != t;
    missing |= j == u || a[min(j, u - 1)] != t;
    if (!missing) bin = bin * u + j;
  }
  return nan ? kNaN : missing ? kMissing : bin;
}

// Kernel 1: rank and histogram, and each threshold row's bin code into
// out[2 g] for kernel 2.  CT > 0: C known at compile time, a thread's
// distances in registers; CT == 0: any C, read as it goes.
template <int CT, bool kBallot>
__global__ void __launch_bounds__(kThreads)
rank_histogram_kernel(const float* __restrict__ cd,
                      const float* __restrict__ labels,
                      const float* __restrict__ valid,
                      const float* __restrict__ thetas,
                      const float* __restrict__ axis_values, const Axes ax,
                      int k, int g_rows, int32_t* __restrict__ table,
                      int32_t* __restrict__ out) {
  const int nc = CT > 0 ? CT : ax.n_c;
  const int tid = threadIdx.x, lane = tid & 31;
  const int n_ax = ax.off[nc];
  extern __shared__ uint32_t hist_smem[];
  // ballot: per-bin (pos, sel) of the block's warps; else the histogram
  uint32_t* hist = hist_smem;
  const int n_hist = kBallot ? 2 * kBallotBins : ax.bins;
  float* ax_s = reinterpret_cast<float*>(hist_smem + n_hist);
  const float* axv = n_ax <= kAxesInShared ? ax_s : axis_values;
  if (n_ax <= kAxesInShared)
    for (int e = tid; e < n_ax; e += kThreads) ax_s[e] = axis_values[e];
  for (int e = tid; e < n_hist; e += kThreads) hist[e] = 0;
  __syncthreads();
  for (long long g = static_cast<long long>(blockIdx.x) * kThreads + tid;
       g < g_rows; g += static_cast<long long>(gridDim.x) * kThreads)
    out[2 * g] = theta_bin(thetas + g * nc, axv, ax, nc);

  int my_pos = 0, my_sel = 0;          // ballot: lane's bin, this warp
  const long long span = static_cast<long long>(kThreads) * kRows;
  // block-uniform trip count: every lane reaches every ballot
  for (long long base = blockIdx.x * span; base < k;
       base += static_cast<long long>(gridDim.x) * span) {
    float v[kRows], l[kRows];
    float x[kRows][CT > 0 ? CT : 1];
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      const long long i = base + j * kThreads + tid;
      const bool in = i < k;
      v[j] = in ? valid[i] : 0.0f;
      l[j] = in ? labels[i] : 0.0f;
      if constexpr (CT > 0) {
#pragma unroll
        for (int c = 0; c < CT; ++c) x[j][c] = in ? cd[i * CT + c] : 0.0f;
      }
    }
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      int b = -1;
      if (v[j] != 0.0f) {
        if constexpr (CT > 0) {
          b = row_bin<CT>(x[j], axv, ax, nc);
        } else {
          float xs[kMaxClauses];
          const long long i = base + j * kThreads + tid;
          for (int c = 0; c < nc; ++c) xs[c] = cd[i * nc + c];
          b = row_bin<0>(xs, axv, ax, nc);
        }
      }
      const unsigned lab = __ballot_sync(kFull, b >= 0 && l[j] != 0.0f);
      if constexpr (kBallot) {
        unsigned live = __ballot_sync(kFull, b >= 0);
        while (live) {                 // once per distinct bin in the warp
          const int q = __shfl_sync(kFull, b, __ffs(live) - 1);
          const unsigned m = __ballot_sync(kFull, b == q);
          if (lane == q) {
            my_sel += __popc(m);
            my_pos += __popc(m & lab);
          }
          live &= ~m;
        }
      } else {
        const unsigned peers = __match_any_sync(kFull, b);
        if (b >= 0 && lane == __ffs(peers) - 1)
          atomicAdd(&hist[b], static_cast<uint32_t>(__popc(peers)) |
                                  (static_cast<uint32_t>(__popc(peers & lab))
                                   << 16));
      }
    }
  }

  if (kBallot) {
    if (my_sel > 0) {
      atomicAdd(&hist[2 * lane], static_cast<uint32_t>(my_pos));
      atomicAdd(&hist[2 * lane + 1], static_cast<uint32_t>(my_sel));
    }
    __syncthreads();
    for (int e = tid; e < 2 * ax.bins; e += kThreads)
      if (hist[e]) atomicAdd(&table[e], static_cast<int32_t>(hist[e]));
  } else {
    __syncthreads();
    for (int e = tid; e < ax.bins; e += kThreads) {
      const uint32_t h = hist[e];
      if (h) {
        atomicAdd(&table[2 * e], static_cast<int32_t>(h >> 16));
        atomicAdd(&table[2 * e + 1], static_cast<int32_t>(h & 0xffffu));
      }
    }
  }
}

// Inclusive prefix of t (bins entries) along one clause: bins / u lines of
// u entries at stride s; line l starts at (l / s) * u * s + l % s.  Ends
// with the block in step.
//
// Contiguous lines (s == 1, the last clause) of at least 32 entries, and
// at least one a warp: a warp scans a line 32 entries at a time with
// shuffles, so its accesses are consecutive (a thread walking such a line
// alone would meet its neighbours in one bank).  Otherwise each line is cut into p chunks (a power of two, p <= u,
// lines * p <= the block) so that short lines and long ones both keep
// the block busy: a thread scans its chunk in order, neighbouring threads
// taking the same chunk of neighbouring lines (neighbouring entries when
// s >= 32); the chunk totals are scanned within their line (Hillis-Steele
// over p), and each chunk adds the total of the chunks before it.  With
// more lines than threads, p is 1 and a thread scans whole lines.
__device__ void prefix_along(int2* t, int2* tot, int bins, int u, int s) {
  const int tid = threadIdx.x, lines = bins / u;
  if (s == 1 && u >= 32 && lines >= kPrefixThreads / 32) {
    const int lane = tid & 31;
    for (int l = tid >> 5; l < lines; l += kPrefixThreads / 32) {
      int2* line = t + l * u;
      int2 carry = make_int2(0, 0);
      for (int r0 = 0; r0 < u; r0 += 32) {
        const int r = r0 + lane;
        int2 x = r < u ? line[r] : make_int2(0, 0);
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
          const int px = __shfl_up_sync(kFull, x.x, d);
          const int py = __shfl_up_sync(kFull, x.y, d);
          if (lane >= d) {
            x.x += px;
            x.y += py;
          }
        }
        x.x += carry.x;
        x.y += carry.y;
        if (r < u) line[r] = x;
        carry = make_int2(__shfl_sync(kFull, x.x, 31),
                          __shfl_sync(kFull, x.y, 31));
      }
    }
    __syncthreads();
    return;
  }
  int p = 1;
  while (2 * p * lines <= kPrefixThreads && 2 * p <= u) p *= 2;
  const int len = (u + p - 1) / p;
  // thread w scans chunk w / lines of line w % lines
  for (int w = tid; w < lines * p; w += kPrefixThreads) {
    const int l = w % lines, r0 = (w / lines) * len, r1 = min(u, r0 + len);
    int2* line = t + (l / s) * u * s + l % s;
    int2 acc = make_int2(0, 0);
    for (int r = r0; r < r1; ++r) {
      acc.x += line[r * s].x;
      acc.y += line[r * s].y;
      line[r * s] = acc;
    }
    if (p > 1) tot[w] = acc;
  }
  __syncthreads();
  if (p == 1) return;
  const bool live = tid < lines * p;
  const int q = tid / lines;
  for (int d = 1; d < p; d <<= 1) {
    int2 v = make_int2(0, 0);
    if (live && q >= d) v = tot[tid - d * lines];
    __syncthreads();
    if (live) {
      tot[tid].x += v.x;
      tot[tid].y += v.y;
    }
    __syncthreads();
  }
  if (live && q > 0) {
    const int l = tid % lines, r0 = q * len, r1 = min(u, r0 + len);
    int2* line = t + (l / s) * u * s + l % s;
    const int2 before = tot[tid - lines];
    for (int r = r0; r < r1; ++r) {
      line[r * s].x += before.x;
      line[r * s].y += before.y;
    }
  }
  __syncthreads();
}

// Kernel 2 (one block): inclusive prefix along every clause, then each
// threshold row's counts from the bin code kernel 1 left in out[2 g].
__global__ void __launch_bounds__(kPrefixThreads)
prefix_gather_kernel(const int32_t* __restrict__ table, const Axes ax,
                     int g_rows, int32_t* __restrict__ out) {
  extern __shared__ int2 table_smem[];   // (bins,) of (pos, sel)
  __shared__ int2 tot[kPrefixThreads];   // chunk totals
  int2* t_s = table_smem;
  const int tid = threadIdx.x, bins = ax.bins;
  constexpr int kBatch = 4;            // codes loaded before counts written
  int code[kBatch];
  const auto load_codes = [&](int g0) {
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int g = g0 + j * kPrefixThreads;
      code[j] = g < g_rows ? out[2 * g] : kNaN;
    }
  };
  load_codes(tid);                     // in flight while the table loads
  const int2* table2 = reinterpret_cast<const int2*>(table);
  for (int e = tid; e < bins; e += kPrefixThreads) t_s[e] = table2[e];
  __syncthreads();
  int stride = bins;                   // row-major: the last clause is fastest
  for (int c = 0; c < ax.n_c && bins > 0; ++c) {
    const int u = ax.off[c + 1] - ax.off[c];
    stride /= u;
    prefix_along(t_s, tot, bins, u, stride);
  }
  for (int g0 = tid; g0 < g_rows; g0 += kBatch * kPrefixThreads) {
    if (g0 != tid) load_codes(g0);
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int g = g0 + j * kPrefixThreads;
      if (g >= g_rows) break;
      const int2 r = code[j] >= 0 ? t_s[code[j]]
                     : code[j] == kMissing ? make_int2(-1, -1)
                                           : make_int2(0, 0);
      out[2 * g] = r.x;
      out[2 * g + 1] = r.y;
    }
  }
}

// Dynamic shared memory above the default 48 KB needs the attribute.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <int CT, bool kBallot>
cudaError_t launch_histogram(const float* cd, const float* labels,
                             const float* valid, const float* thetas,
                             const float* axis_values, const Axes& ax, int k,
                             int g_rows, int32_t* table, int32_t* out,
                             cudaStream_t stream) {
  const int n_ax = ax.off[ax.n_c];
  const size_t smem =
      sizeof(uint32_t) * (kBallot ? 2 * kBallotBins : ax.bins) +
      (n_ax <= kAxesInShared ? sizeof(float) * n_ax : 0);
  const auto kernel = rank_histogram_kernel<CT, kBallot>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, smem);
  if (err != cudaSuccess) return err;
  // as many blocks as the card holds at once, no more than the rows need,
  // but enough that no block walks more than kMaxSteps steps, and one
  // thread for each threshold row
  const long long span = static_cast<long long>(kThreads) * kRows;
  long long grid = std::min((k + span - 1) / span,
                            static_cast<long long>(per_sm) * sms);
  grid = std::max(grid, (k + span * kMaxSteps - 1) / (span * kMaxSteps));
  grid = std::max(grid, (g_rows + kThreads - 1LL) / kThreads);
  if (grid > 0x7fffffffLL) return cudaErrorInvalidValue;
  rank_histogram_kernel<CT, kBallot>
      <<<static_cast<unsigned>(grid), kThreads, smem, stream>>>(
      cd, labels, valid, thetas, axis_values, ax, k, g_rows, table, out);
  return cudaGetLastError();
}

template <bool kBallot>
cudaError_t dispatch_clauses(const float* cd, const float* labels,
                             const float* valid, const float* thetas,
                             const float* axis_values, const Axes& ax, int k,
                             int g_rows, int32_t* table, int32_t* out,
                             cudaStream_t s) {
#define FDJ_RANKED_CASE(CT)                                                   \
  return launch_histogram<CT, kBallot>(cd, labels, valid, thetas,            \
                                       axis_values, ax, k, g_rows, table,    \
                                       out, s)
  switch (ax.n_c) {
    case 1: FDJ_RANKED_CASE(1);
    case 2: FDJ_RANKED_CASE(2);
    case 3: FDJ_RANKED_CASE(3);
    case 4: FDJ_RANKED_CASE(4);
    case 5: FDJ_RANKED_CASE(5);
    case 6: FDJ_RANKED_CASE(6);
    default: FDJ_RANKED_CASE(0);
  }
#undef FDJ_RANKED_CASE
}

cudaError_t launch(const float* cd, const float* labels, const float* valid,
                   const float* thetas, const float* axis_values,
                   const Axes& ax, int k, int g_rows, int32_t* table,
                   int32_t* out, cudaStream_t stream) {
  cudaError_t err = cudaSuccess;
  if (ax.bins > 0) {
    err = cudaMemsetAsync(table, 0,
                          sizeof(int32_t) * 2 * static_cast<size_t>(ax.bins),
                          stream);
    if (err != cudaSuccess) return err;
  }
  // no bins: every row is dropped, and the lane-counter path has the
  // least shared memory
  err = ax.bins <= kBallotBins
            ? dispatch_clauses<true>(cd, labels, valid, thetas, axis_values,
                                     ax, k, g_rows, table, out, stream)
            : dispatch_clauses<false>(cd, labels, valid, thetas, axis_values,
                                      ax, k, g_rows, table, out, stream);
  if (err != cudaSuccess) return err;
  const size_t smem = sizeof(int2) * static_cast<size_t>(ax.bins);
  if ((err = allow_smem(prefix_gather_kernel, smem)) != cudaSuccess)
    return err;
  prefix_gather_kernel<<<1, kPrefixThreads, smem, stream>>>(table, ax,
                                                            g_rows, out);
  return cudaGetLastError();
}

}  // namespace ranked

extern "C" {

// cd: (k, n_c) f32 row-major; labels, valid: (k,) f32; thetas: (g_rows, n_c)
// f32; out: (g_rows, 2) int32, zeroed here on `stream` before the counts
// are added.  Returns a cudaError_t (0 on success).
int threshold_sweep_launch(const float* cd, const float* labels,
                           const float* valid, const float* thetas, int k,
                           int g_rows, int n_c, int32_t* out, void* stream) {
  if (k < 0 || g_rows < 0 || n_c < 1 || n_c > kMaxClauses)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (g_rows == 0) return 0;
  cudaError_t err = cudaMemsetAsync(out, 0, sizeof(int32_t) * 2 * g_rows, s);
  if (err != cudaSuccess || k == 0) return static_cast<int>(err);
  switch (n_c) {
    case 1: err = launch<1>(cd, labels, valid, thetas, k, g_rows, n_c, out, s); break;
    case 2: err = launch<2>(cd, labels, valid, thetas, k, g_rows, n_c, out, s); break;
    case 3: err = launch<3>(cd, labels, valid, thetas, k, g_rows, n_c, out, s); break;
    case 4: err = launch<4>(cd, labels, valid, thetas, k, g_rows, n_c, out, s); break;
    case 5: err = launch<5>(cd, labels, valid, thetas, k, g_rows, n_c, out, s); break;
    case 6: err = launch<6>(cd, labels, valid, thetas, k, g_rows, n_c, out, s); break;
    case 7: err = launch<7>(cd, labels, valid, thetas, k, g_rows, n_c, out, s); break;
    case 8: err = launch<8>(cd, labels, valid, thetas, k, g_rows, n_c, out, s); break;
    default: err = launch<0>(cd, labels, valid, thetas, k, g_rows, n_c, out, s); break;
  }
  static_assert(kMaxUnrolled == 8, "the switch above unrolls C = 1..8");
  return static_cast<int>(err);
}

// The ranked route.  cd: (k, n_c) f32 row-major; labels, valid: (k,) f32;
// thetas: (g_rows, n_c) f32; axis_values: the n_c axes back to back, f32
// on the device; axis_offsets: (n_c + 1,) int32 in HOST memory (axis c is
// axis_values[off[c] .. off[c + 1])), every theta value that is not NaN
// present in its axis; table: (bins, 2) int32 scratch, zeroed here;
// out: (g_rows, 2) int32, every row written.  Returns a cudaError_t.
int threshold_sweep_ranked_launch(const float* cd, const float* labels,
                                  const float* valid, const float* thetas,
                                  const float* axis_values,
                                  const int32_t* axis_offsets, int k,
                                  int g_rows, int n_c, int32_t* table,
                                  int32_t* out, void* stream) {
  if (k < 0 || g_rows < 0 || n_c < 1 || n_c > ranked::kMaxClauses ||
      axis_offsets[0] != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  ranked::Axes ax{};
  ax.n_c = n_c;
  ax.bins = 1;
  for (int c = 0; c <= n_c; ++c) {
    ax.off[c] = axis_offsets[c];
    if (c == 0) continue;
    const int u = axis_offsets[c] - axis_offsets[c - 1];
    if (u < 0) return static_cast<int>(cudaErrorInvalidValue);
    ax.bins = u == 0 || ax.bins == 0 ? 0 : ax.bins * u;
    if (ax.bins > ranked::kMaxBins)
      return static_cast<int>(cudaErrorInvalidValue);
  }
  if (g_rows == 0) return 0;
  return static_cast<int>(ranked::launch(cd, labels, valid, thetas,
                                         axis_values, ax, k, g_rows, table,
                                         out,
                                         static_cast<cudaStream_t>(stream)));
}

const char* fdj_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
