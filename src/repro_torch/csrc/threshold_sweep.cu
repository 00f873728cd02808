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
// any nonzero value counts as 1.
//
// Design.  The Pallas kernel carries its sums across a sequential k grid
// axis by revisiting its output block.  Hopper blocks run in no fixed
// order, so nothing carries over between them: each block owns a strip of
// 256 candidate rows (one per thread, its thresholds in registers) and one
// chunk of k, stages the chunk's distances and a packed valid/label code
// per row through shared memory (every thread reads the same row: a
// broadcast), counts in registers, and adds its two counts per row into
// an int32 (G, 2) output with atomicAdd.  Integer atomics make the result
// exact and independent of block order; f32 counts would be exact only
// below 2^24.
//
// Bound: instruction throughput, about G * k * (C + 2) compare/AND/add
// operations (1.1e10 at G = 4096, k = 7e5, C = 2); the inputs are read
// once per candidate strip and are small beside that (k * (C + 2) * 4 bytes).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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

const char* fdj_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
