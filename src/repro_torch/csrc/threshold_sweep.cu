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
// exceeds 2^14, such as a candidate_grid of C >= 15 clauses (2^C rows).
// The Pallas kernel carries its sums across a sequential k grid axis by
// revisiting its output block.  Hopper blocks run in no fixed order, so
// nothing carries over between them: each block owns a strip of
// threshold rows and a range of k, and adds its two counts per row into
// the int32 (G, 2) output with atomicAdd (exact and independent of block
// order, where f32 counts would be exact only below 2^24).
//
// What bounds it: the compares.  Each (threshold row, sample row) pair
// needs C compares ANDed together and one conditional count, G * k *
// (C + 2) lane operations by the usual count (2.0e10 at G 4096, k
// 700 416, C 5).  The route's first kernel gave each thread one
// threshold row, so every compare also paid a shared-memory load of the
// sample's distance (a broadcast), and per sample a load, a select, a
// shift and two adds: about 19 instructions for the bound's 7 at C 5,
// with the load/store pipe setting the pace, and for C > 8 the
// thresholds sat in shared memory too (two shared loads a compare).  This
// kernel:
//   * gives each thread R threshold rows (R = 8 up to C 8, 4 up to C 16,
//     2 above), their C thresholds in registers for every C up to 32
//     (C 17..32 run the next multiple of 4, the extra clauses +inf
//     against distances of 0, which pass);
//   * reads a staged sample row from shared memory once for its R rows,
//     as float4 loads of a row padded to a multiple of 4 floats;
//   * chains the C compares of a pair into one predicate (FSETP.LE.AND,
//     written in PTX: ``Pair``) and adds the sample's code under it, an
//     add that ptxas issues on the FMA pipe: code = valid | (valid &
//     label) << 16, so one add counts both, the selected count in the low
//     half and the positive count in the high half of one 32-bit
//     register, emptied into 32-bit counts after every stage (a stage
//     holds fewer than 2^16 rows, so neither half overflows);
//   * stages sample rows through shared memory with cp.async, double
//     buffered, so a stage's loads run under the previous stage's
//     compares; a stage's valid and label floats become codes once, in
//     place;
//   * sizes the grid to the card: threshold strips of up to 256 threads
//     times R rows (fewer threads when G is small, so no warp compares
//     only pad rows), and as many k ranges as fill every SM with the
//     blocks the occupancy calculator allows, and no more (one wave).
// So a pair costs C compares on the ALU pipe and an add on the FMA pipe.
// The compares set the pace: compute capability 9.0 issues 64 of them a
// clock an SM (the CUDA programming guide's throughput table), half the
// FP32 lane rate the G * k * (C + 2) count is held to, so this
// formulation cannot pass G * k * C / (64 * 132 * clock): at 1.98 GHz
// 0.858 ms at the wide case's C 5, against that count's 0.600 ms.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>
#include <utility>

namespace {

constexpr int kMaxClauses = 32;
constexpr int kThreads = 256;            // the most threads a block
constexpr int kStageBytes = 24 * 1024;   // one stage of staged sample rows

// Threshold rows a thread owns at C = ct: at most about 64 registers of
// thresholds.
__host__ __device__ constexpr int rows_per_thread(int ct) {
  return ct <= 8 ? 8 : ct <= 16 ? 4 : 2;
}
// A staged sample row's stride in floats: its distances, padded to float4.
__host__ __device__ constexpr int padded(int ct) { return (ct + 3) & ~3; }
// Sample rows a stage holds (distances, valid and label), a multiple of 32.
__host__ __device__ constexpr int stage_rows(int ct) {
  return (kStageBytes / (4 * (padded(ct) + 2))) & ~31;
}
// The instantiation that runs C clauses: C itself up to 16, else the next
// multiple of 4.
constexpr int clause_slots(int c) { return c <= 16 ? c : (c + 3) & ~3; }

// One (threshold row, sample row) pair of C clauses: acc += w if x[c] <=
// t[c] for every c, as one predicate chain (setp.le, then setp.le.and)
// guarding the add, so ptxas puts the add on the FMA pipe (IMAD.IADD) and
// the compares alone on the ALU pipe.  Left to itself the compiler selects
// w or 0 into a register (one more ALU instruction a pair) and adds those
// in pairs.  Operands: %0 acc, %1 w, then x[c] and t[c] at %(2 + 2c) and
// %(3 + 2c), so a clause's text does not depend on C (2 C + 2 operands).
template <int C>
struct Pair;
#define FDJ_SETP0 "setp.le.f32 p, %2, %3;\n\t"
#define FDJ_SETP(a, b) "setp.le.and.f32 p, %" #a ", %" #b ", p;\n\t"
#define FDJ_CHAIN1 FDJ_SETP0
#define FDJ_CHAIN2 FDJ_CHAIN1 FDJ_SETP(4, 5)
#define FDJ_CHAIN3 FDJ_CHAIN2 FDJ_SETP(6, 7)
#define FDJ_CHAIN4 FDJ_CHAIN3 FDJ_SETP(8, 9)
#define FDJ_CHAIN5 FDJ_CHAIN4 FDJ_SETP(10, 11)
#define FDJ_CHAIN6 FDJ_CHAIN5 FDJ_SETP(12, 13)
#define FDJ_CHAIN7 FDJ_CHAIN6 FDJ_SETP(14, 15)
#define FDJ_CHAIN8 FDJ_CHAIN7 FDJ_SETP(16, 17)
#define FDJ_CHAIN9 FDJ_CHAIN8 FDJ_SETP(18, 19)
#define FDJ_CHAIN10 FDJ_CHAIN9 FDJ_SETP(20, 21)
#define FDJ_CHAIN11 FDJ_CHAIN10 FDJ_SETP(22, 23)
#define FDJ_CHAIN12 FDJ_CHAIN11 FDJ_SETP(24, 25)
#define FDJ_CHAIN13 FDJ_CHAIN12 FDJ_SETP(26, 27)
#define FDJ_CHAIN14 FDJ_CHAIN13 FDJ_SETP(28, 29)
#define FDJ_CHAIN15 FDJ_CHAIN14 FDJ_SETP(30, 31)
#define FDJ_CHAIN16 FDJ_CHAIN15 FDJ_SETP(32, 33)
#define FDJ_CHAIN17 FDJ_CHAIN16 FDJ_SETP(34, 35)
#define FDJ_CHAIN18 FDJ_CHAIN17 FDJ_SETP(36, 37)
#define FDJ_CHAIN19 FDJ_CHAIN18 FDJ_SETP(38, 39)
#define FDJ_CHAIN20 FDJ_CHAIN19 FDJ_SETP(40, 41)
#define FDJ_CHAIN21 FDJ_CHAIN20 FDJ_SETP(42, 43)
#define FDJ_CHAIN22 FDJ_CHAIN21 FDJ_SETP(44, 45)
#define FDJ_CHAIN23 FDJ_CHAIN22 FDJ_SETP(46, 47)
#define FDJ_CHAIN24 FDJ_CHAIN23 FDJ_SETP(48, 49)
#define FDJ_CHAIN25 FDJ_CHAIN24 FDJ_SETP(50, 51)
#define FDJ_CHAIN26 FDJ_CHAIN25 FDJ_SETP(52, 53)
#define FDJ_CHAIN27 FDJ_CHAIN26 FDJ_SETP(54, 55)
#define FDJ_CHAIN28 FDJ_CHAIN27 FDJ_SETP(56, 57)
#define FDJ_CHAIN29 FDJ_CHAIN28 FDJ_SETP(58, 59)
#define FDJ_CHAIN30 FDJ_CHAIN29 FDJ_SETP(60, 61)
#define FDJ_CHAIN31 FDJ_CHAIN30 FDJ_SETP(62, 63)
#define FDJ_CHAIN32 FDJ_CHAIN31 FDJ_SETP(64, 65)
#define FDJ_OPS1 "f"(x[0]), "f"(t[0])
#define FDJ_OPS2 FDJ_OPS1, "f"(x[1]), "f"(t[1])
#define FDJ_OPS3 FDJ_OPS2, "f"(x[2]), "f"(t[2])
#define FDJ_OPS4 FDJ_OPS3, "f"(x[3]), "f"(t[3])
#define FDJ_OPS5 FDJ_OPS4, "f"(x[4]), "f"(t[4])
#define FDJ_OPS6 FDJ_OPS5, "f"(x[5]), "f"(t[5])
#define FDJ_OPS7 FDJ_OPS6, "f"(x[6]), "f"(t[6])
#define FDJ_OPS8 FDJ_OPS7, "f"(x[7]), "f"(t[7])
#define FDJ_OPS9 FDJ_OPS8, "f"(x[8]), "f"(t[8])
#define FDJ_OPS10 FDJ_OPS9, "f"(x[9]), "f"(t[9])
#define FDJ_OPS11 FDJ_OPS10, "f"(x[10]), "f"(t[10])
#define FDJ_OPS12 FDJ_OPS11, "f"(x[11]), "f"(t[11])
#define FDJ_OPS13 FDJ_OPS12, "f"(x[12]), "f"(t[12])
#define FDJ_OPS14 FDJ_OPS13, "f"(x[13]), "f"(t[13])
#define FDJ_OPS15 FDJ_OPS14, "f"(x[14]), "f"(t[14])
#define FDJ_OPS16 FDJ_OPS15, "f"(x[15]), "f"(t[15])
#define FDJ_OPS17 FDJ_OPS16, "f"(x[16]), "f"(t[16])
#define FDJ_OPS18 FDJ_OPS17, "f"(x[17]), "f"(t[17])
#define FDJ_OPS19 FDJ_OPS18, "f"(x[18]), "f"(t[18])
#define FDJ_OPS20 FDJ_OPS19, "f"(x[19]), "f"(t[19])
#define FDJ_OPS21 FDJ_OPS20, "f"(x[20]), "f"(t[20])
#define FDJ_OPS22 FDJ_OPS21, "f"(x[21]), "f"(t[21])
#define FDJ_OPS23 FDJ_OPS22, "f"(x[22]), "f"(t[22])
#define FDJ_OPS24 FDJ_OPS23, "f"(x[23]), "f"(t[23])
#define FDJ_OPS25 FDJ_OPS24, "f"(x[24]), "f"(t[24])
#define FDJ_OPS26 FDJ_OPS25, "f"(x[25]), "f"(t[25])
#define FDJ_OPS27 FDJ_OPS26, "f"(x[26]), "f"(t[26])
#define FDJ_OPS28 FDJ_OPS27, "f"(x[27]), "f"(t[27])
#define FDJ_OPS29 FDJ_OPS28, "f"(x[28]), "f"(t[28])
#define FDJ_OPS30 FDJ_OPS29, "f"(x[29]), "f"(t[29])
#define FDJ_OPS31 FDJ_OPS30, "f"(x[30]), "f"(t[30])
#define FDJ_OPS32 FDJ_OPS31, "f"(x[31]), "f"(t[31])
#define FDJ_PAIR(C)                                                          \
  template <>                                                                \
  struct Pair<C> {                                                           \
    __device__ __forceinline__ static void add(uint32_t& acc, uint32_t w,    \
                                               const float* x,               \
                                               const float* t) {             \
      asm("{\n\t.reg .pred p;\n\t" FDJ_CHAIN##C                           \
          "@p add.u32 %0, %0, %1;\n\t}"                                    \
          : "+r"(acc)                                                        \
          : "r"(w), FDJ_OPS##C);                                             \
    }                                                                        \
  };
FDJ_PAIR(1) FDJ_PAIR(2) FDJ_PAIR(3) FDJ_PAIR(4) FDJ_PAIR(5) FDJ_PAIR(6)
FDJ_PAIR(7) FDJ_PAIR(8) FDJ_PAIR(9) FDJ_PAIR(10) FDJ_PAIR(11) FDJ_PAIR(12)
FDJ_PAIR(13) FDJ_PAIR(14) FDJ_PAIR(15) FDJ_PAIR(16) FDJ_PAIR(20)
FDJ_PAIR(24) FDJ_PAIR(28) FDJ_PAIR(32)
#undef FDJ_PAIR

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_prior() {
  asm volatile("cp.async.wait_group 1;\n" ::);   // all but the newest group
}

// CT clause slots (n_c <= CT real clauses).  Block (x, y): threshold rows
// x * blockDim.x * R + tid + r * blockDim.x (r < R), sample rows
// [y * k_per_block, (y + 1) * k_per_block).
template <int CT>
__global__ void __launch_bounds__(kThreads)
sweep_kernel(const float* __restrict__ cd, const float* __restrict__ labels,
             const float* __restrict__ valid, const float* __restrict__ thetas,
             int k, int g_rows, int n_c, int k_per_block,
             int32_t* __restrict__ out) {
  constexpr int R = rows_per_thread(CT), CP = padded(CT), S = stage_rows(CT);
  constexpr int kStage = S * (CP + 2);   // floats: distances, valid, labels
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, nt = blockDim.x;

  float th[R][CT];
  const long long g0 = static_cast<long long>(blockIdx.x) * nt * R + tid;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const long long g = g0 + static_cast<long long>(r) * nt;
#pragma unroll
    for (int c = 0; c < CT; ++c)
      th[r][c] = c >= n_c ? INFINITY
                 : g < g_rows ? thetas[g * n_c + c] : -INFINITY;
  }
  // the extra clauses' distances, never written by a stage: 0 passes +inf
  for (int e = tid; e < 2 * S * (CP - n_c); e += nt) {
    const int row = e / (CP - n_c), c = n_c + e % (CP - n_c);
    smem[(row / S) * kStage + (row % S) * CP + c] = 0.0f;
  }

  const long long k0 = static_cast<long long>(blockIdx.y) * k_per_block;
  const long long k1 = min(static_cast<long long>(k), k0 + k_per_block);
  const int n_stages = k1 > k0 ? static_cast<int>((k1 - k0 + S - 1) / S) : 0;
  const auto stage = [&](int t) {
    float* buf = smem + (t & 1) * kStage;
    const long long s0 = k0 + static_cast<long long>(t) * S;
    const int n = static_cast<int>(min(static_cast<long long>(S), k1 - s0));
    for (int i = tid; i < n; i += nt) {
      const float* row = cd + (s0 + i) * n_c;
      for (int c = 0; c < n_c; ++c) cp_async4(buf + i * CP + c, row + c);
      cp_async4(buf + S * CP + i, valid + s0 + i);
      cp_async4(buf + S * (CP + 1) + i, labels + s0 + i);
    }
  };

  int pos[R], sel[R];
#pragma unroll
  for (int r = 0; r < R; ++r) pos[r] = sel[r] = 0;
  if (n_stages > 0) stage(0);
  cp_async_commit();
  for (int t = 0; t < n_stages; ++t) {
    if (t + 1 < n_stages) stage(t + 1);
    cp_async_commit();                   // possibly empty: one group a step
    cp_async_wait_prior();               // this thread's copies of stage t
    __syncthreads();                     // everyone's
    float* buf = smem + (t & 1) * kStage;
    const int n = static_cast<int>(min(static_cast<long long>(S),
                                       k1 - k0 - static_cast<long long>(t) * S));
    uint32_t* code = reinterpret_cast<uint32_t*>(buf + S * CP);
    const float* lab = buf + S * (CP + 1);
    for (int i = tid; i < n; i += nt) {
      const float v = __uint_as_float(code[i]);
      code[i] = v != 0.0f ? (lab[i] != 0.0f ? 0x10001u : 1u) : 0u;
    }
    __syncthreads();

    uint32_t acc[R];
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r] = 0;
#pragma unroll 2
    for (int i = 0; i < n; ++i) {
      float x[CP];
#pragma unroll
      for (int q = 0; q < CP / 4; ++q) {
        const float4 v = reinterpret_cast<const float4*>(buf + i * CP)[q];
        x[4 * q] = v.x;
        x[4 * q + 1] = v.y;
        x[4 * q + 2] = v.z;
        x[4 * q + 3] = v.w;
      }
      const uint32_t w = code[i];
#pragma unroll
      for (int r = 0; r < R; ++r) Pair<CT>::add(acc[r], w, x, th[r]);
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      sel[r] += static_cast<int>(acc[r] & 0xffffu);
      pos[r] += static_cast<int>(acc[r] >> 16);
    }
    __syncthreads();                     // stage t + 2 reuses this buffer
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const long long g = g0 + static_cast<long long>(r) * nt;
    if (g < g_rows && sel[r] != 0) {
      atomicAdd(&out[2 * g], pos[r]);
      atomicAdd(&out[2 * g + 1], sel[r]);
    }
  }
}

template <int CT>
cudaError_t launch(const float* cd, const float* labels, const float* valid,
                   const float* thetas, int k, int g_rows, int n_c,
                   int32_t* out, cudaStream_t stream) {
  constexpr int R = rows_per_thread(CT), S = stage_rows(CT);
  const size_t smem = 2 * sizeof(float) * S * (padded(CT) + 2);
  const auto kernel = sweep_kernel<CT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  // threads: enough for the rows, a whole number of warps, at most kThreads
  const long long per_thread_rows = (g_rows + R - 1LL) / R;
  const int threads = static_cast<int>(
      std::min<long long>(kThreads, (per_thread_rows + 31) / 32 * 32));
  const long long strips = (g_rows + static_cast<long long>(threads) * R - 1) /
                           (static_cast<long long>(threads) * R);
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      threads, smem);
  if (err != cudaSuccess) return err;
  // k ranges: as many blocks as the card holds at once, and no more (a
  // block over would start a second wave as long as the first), each at
  // least a stage
  long long ranges = static_cast<long long>(std::max(per_sm, 1)) * sms /
                     strips;
  ranges = std::min(ranges, (k + S - 1LL) / S);
  ranges = std::max(1LL, std::min(ranges, 65535LL));
  const long long k_per_block = (k + ranges - 1) / ranges;
  ranges = (k + k_per_block - 1) / k_per_block;
  if (strips > 0x7fffffffLL) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(strips),
                  static_cast<unsigned>(ranges));
  kernel<<<grid, threads, smem, stream>>>(cd, labels, valid, thetas, k,
                                          g_rows, n_c,
                                          static_cast<int>(k_per_block), out);
  return cudaGetLastError();
}

template <int... Cs>
cudaError_t dispatch(std::integer_sequence<int, Cs...>, const float* cd,
                     const float* labels, const float* valid,
                     const float* thetas, int k, int g_rows, int n_c,
                     int32_t* out, cudaStream_t stream) {
  cudaError_t err = cudaErrorInvalidValue;
  const int slots = clause_slots(n_c);
  (void)((slots == Cs
              ? (err = launch<Cs>(cd, labels, valid, thetas, k, g_rows, n_c,
                                  out, stream),
                 true)
              : false) ||
         ...);
  return err;
}

// The instantiations: C 1..16, then 20, 24, 28, 32.
using ClauseSlots = std::integer_sequence<int, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10,
                                          11, 12, 13, 14, 15, 16, 20, 24, 28,
                                          32>;
static_assert(clause_slots(kMaxClauses) == kMaxClauses,
              "every C up to kMaxClauses has an instantiation");

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
  err = dispatch(ClauseSlots{}, cd, labels, valid, thetas, k, g_rows, n_c,
                 out, s);
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
