// Fused CNF join over L x R for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel `cnf_join_block` (src/repro/kernels/
// fused_cnf_join/kernel.py, with `_cnf_body`, `_clause_min_dist` and
// `_pack_tile`).  For every pair (i, j) of a (tl x tr) tile:
//
//   embed member:  d = clip(0.5 - 0.5 * <emb_l[f, i], emb_r[f, j]>, 0, 1)
//   scalar member: d = clip(|scal_l[f, i] - scal_r[f, j]|, 0, 1)
//   clause c passes iff min over its members of d <= theta[c] (f32 compare)
//   the pair is a candidate iff every clause passes
//
// and the result is packed to 32-bit words along R: bit b of word w is
// column 32w + b.  With `early_reject`, clause 0 is evaluated over the whole
// tile first; a tile where it passes nowhere writes zero words and counts 1
// clause evaluated, a live tile ANDs the later clauses in and counts C.
//
// Design against the bound.  The work is compute on the FP32 pipe:
// 2 * n_l * n_r * D FLOP per embed member evaluated (the mask, n_l*n_r/8
// bytes, is negligible beside it).  Thresholds sit exactly on sample
// positives' distances, so the dot products stay in IEEE f32 FMAs on the
// CUDA cores: TF32 tensor cores keep ~3 digits and would move the
// candidate set.  One thread block owns one logical (tl x tr) tile, so the
// per-tile eval counts match the reference grid at equal tile sizes.  The
// block walks the tile in 64 x 128 register sub-tiles: each warp holds an
// 8-row x 4-column-group micro-tile, lane b owning columns b, b+32, b+64,
// b+96, so `__ballot_sync` over a row's 32 lanes *is* the output word.
// L and R embedding rows are staged through shared memory in 32-wide
// chunks of D (L transposed for float4 broadcast reads, R transposed and
// padded so lanes read consecutive banks).  The tile's mask words
// (tl * tr / 32 words, 16 KB at the 256 x 512 default) live in shared
// memory across clauses and are written out once, coalesced.
//
// Unlike the Pallas kernel, which closes over the clause structure and the
// thresholds at trace time, the clause structure (member kinds, indices,
// clause offsets) and theta are runtime kernel parameters, so one build
// serves every plan.
//
// Not done here (later work): tensor-core 3xTF32 split products, TMA
// staging rings, a persistent grid for small launches.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerWarp = 8;
constexpr int kColGroups = 4;
constexpr int kSubRows = kWarps * kRowsPerWarp;   // 64
constexpr int kSubCols = 32 * kColGroups;         // 128
constexpr int kDK = 32;                           // D chunk staged per step
constexpr int kMaxClauses = 32;
constexpr int kMaxMembers = 64;
constexpr int kVec = 0;

struct Cnf {
  int n_clauses;
  int clause_off[kMaxClauses + 1];
  int kind[kMaxMembers];
  int index[kMaxMembers];
  float theta[kMaxClauses];
};

struct Planes {
  const float* emb_l;
  const float* emb_r;
  const float* scal_l;
  const float* scal_r;
  long long emb_l_fstride;    // elements between feature planes
  long long emb_r_fstride;
  long long scal_l_fstride;
  long long scal_r_fstride;
  int d;
  int n_r;
};

__device__ __forceinline__ float clip01(float x) {
  return fminf(fmaxf(x, 0.0f), 1.0f);
}

__global__ void __launch_bounds__(kThreads, 2)
cnf_join_kernel(Planes p, Cnf cnf, int tl, int tr, int early_reject,
                int32_t* __restrict__ out, int32_t* __restrict__ evals) {
  extern __shared__ uint32_t mask_s[];                 // tl * (tr / 32)
  __shared__ __align__(16) float Ls[kDK][kSubRows + 4];
  __shared__ float Rs[kDK][kSubCols + 1];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int row0 = blockIdx.y * tl;
  const int col0 = blockIdx.x * tr;
  const int words = tr / 32;
  const int n_c = cnf.n_clauses;
  int any_pass = 0;
  int evaluated = n_c;

  for (int c = 0; c < n_c; ++c) {
    if (c == 1 && early_reject) {
      if (!__syncthreads_or(any_pass)) {
        evaluated = 1;                 // dead tile: clause-0 words are all 0
        break;
      }
    }
    const float theta = cnf.theta[c];
    for (int sr = 0; sr < tl; sr += kSubRows) {
      for (int sc = 0; sc < tr; sc += kSubCols) {
        const int rows_here = min(kSubRows, tl - sr);
        const int cols_here = min(kSubCols, tr - sc);
        float dmin[kRowsPerWarp][kColGroups];
#pragma unroll
        for (int i = 0; i < kRowsPerWarp; ++i)
#pragma unroll
          for (int q = 0; q < kColGroups; ++q) dmin[i][q] = INFINITY;

        for (int m = cnf.clause_off[c]; m < cnf.clause_off[c + 1]; ++m) {
          const int fi = cnf.index[m];
          if (cnf.kind[m] == kVec) {
            const float* A = p.emb_l + fi * p.emb_l_fstride +
                             (long long)(row0 + sr) * p.d;
            const float* B = p.emb_r + fi * p.emb_r_fstride +
                             (long long)(col0 + sc) * p.d;
            float acc[kRowsPerWarp][kColGroups];
#pragma unroll
            for (int i = 0; i < kRowsPerWarp; ++i)
#pragma unroll
              for (int q = 0; q < kColGroups; ++q) acc[i][q] = 0.0f;
            for (int d0 = 0; d0 < p.d; d0 += kDK) {
              __syncthreads();         // the previous chunk's readers are done
              for (int e = tid; e < kSubRows * kDK; e += kThreads) {
                const int r = e / kDK, dd = e % kDK;
                float v = 0.0f;
                if (r < rows_here && d0 + dd < p.d)
                  v = A[(long long)r * p.d + d0 + dd];
                Ls[dd][r] = v;
              }
              for (int e = tid; e < kSubCols * kDK; e += kThreads) {
                const int cc = e / kDK, dd = e % kDK;
                float v = 0.0f;
                if (cc < cols_here && d0 + dd < p.d)
                  v = B[(long long)cc * p.d + d0 + dd];
                Rs[dd][cc] = v;
              }
              __syncthreads();
#pragma unroll 4
              for (int dd = 0; dd < kDK; ++dd) {
                const float4 a0 =
                    *reinterpret_cast<const float4*>(&Ls[dd][warp * kRowsPerWarp]);
                const float4 a1 = *reinterpret_cast<const float4*>(
                    &Ls[dd][warp * kRowsPerWarp + 4]);
                const float a[kRowsPerWarp] = {a0.x, a0.y, a0.z, a0.w,
                                               a1.x, a1.y, a1.z, a1.w};
                float b[kColGroups];
#pragma unroll
                for (int q = 0; q < kColGroups; ++q) b[q] = Rs[dd][lane + 32 * q];
#pragma unroll
                for (int i = 0; i < kRowsPerWarp; ++i)
#pragma unroll
                  for (int q = 0; q < kColGroups; ++q)
                    acc[i][q] = fmaf(a[i], b[q], acc[i][q]);
              }
            }
#pragma unroll
            for (int i = 0; i < kRowsPerWarp; ++i)
#pragma unroll
              for (int q = 0; q < kColGroups; ++q)
                // 0.5 * dot is exact, so this rounds once, as the reference does
                dmin[i][q] = fminf(dmin[i][q], clip01(0.5f - 0.5f * acc[i][q]));
          } else {
            const float* x = p.scal_l + fi * p.scal_l_fstride + row0 + sr +
                             warp * kRowsPerWarp;
            const float* y = p.scal_r + fi * p.scal_r_fstride + col0 + sc + lane;
            float yv[kColGroups];
#pragma unroll
            for (int q = 0; q < kColGroups; ++q)
              yv[q] = (32 * q < cols_here) ? y[32 * q] : 0.0f;
#pragma unroll
            for (int i = 0; i < kRowsPerWarp; ++i) {
              const float xv =
                  (warp * kRowsPerWarp + i < rows_here) ? x[i] : 0.0f;
#pragma unroll
              for (int q = 0; q < kColGroups; ++q)
                dmin[i][q] = fminf(dmin[i][q], clip01(fabsf(xv - yv[q])));
            }
          }
        }

        // compare, pack by ballot, AND into the tile's words
        uint32_t my_word = 0;
        int my_slot = -1;
#pragma unroll
        for (int i = 0; i < kRowsPerWarp; ++i) {
          const int lr = sr + warp * kRowsPerWarp + i;        // warp-uniform
#pragma unroll
          for (int q = 0; q < kColGroups; ++q) {
            const int lc = sc + 32 * q;                       // warp-uniform
            const uint32_t w = __ballot_sync(0xffffffffu, dmin[i][q] <= theta);
            if (lr < tl && lc < tr) {
              any_pass |= (w != 0u);
              if (lane == i * kColGroups + q) {
                my_word = w;
                my_slot = lr * words + lc / 32;
              }
            }
          }
        }
        if (my_slot >= 0)
          mask_s[my_slot] = (c == 0) ? my_word : (mask_s[my_slot] & my_word);
      }
    }
  }
  __syncthreads();
  const long long out_words = p.n_r / 32;
  for (int e = tid; e < tl * words; e += kThreads) {
    const int r = e / words, w = e % words;
    out[(long long)(row0 + r) * out_words + col0 / 32 + w] =
        static_cast<int32_t>(mask_s[e]);
  }
  if (evals != nullptr && tid == 0)
    evals[blockIdx.y * gridDim.x + blockIdx.x] = evaluated;
}

}  // namespace

extern "C" {

// Launches the fused CNF join on `stream`.  emb_*: (F_v, n, d) f32 with rows
// contiguous (feature planes `*_fstride` elements apart); scal_*: (F_s, n)
// f32 likewise.  clause_off[n_clauses + 1] delimits each clause's members in
// kind[] / index[] (host arrays); theta[n_clauses] is f32.  out is the
// int32 (n_l, n_r / 32) mask; evals, if not null, the int32
// (n_l / tl, n_r / tr) grid.  Returns a cudaError_t (0 on success).
int cnf_join_launch(const float* emb_l, const float* emb_r,
                    const float* scal_l, const float* scal_r,
                    long long emb_l_fstride, long long emb_r_fstride,
                    long long scal_l_fstride, long long scal_r_fstride,
                    int n_l, int n_r, int d, int n_clauses,
                    const int* clause_off, const int* kind, const int* index,
                    const float* theta, int tl, int tr, int early_reject,
                    int32_t* out, int32_t* evals, void* stream) {
  if (n_clauses < 1 || n_clauses > kMaxClauses || tl <= 0 || tr <= 0 ||
      tr % 32 != 0 || n_l % tl != 0 || n_r % tr != 0 || d <= 0 ||
      clause_off[0] != 0 || clause_off[n_clauses] > kMaxMembers)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_l == 0 || n_r == 0) return 0;
  Cnf cnf;
  cnf.n_clauses = n_clauses;
  for (int c = 0; c <= n_clauses; ++c) cnf.clause_off[c] = clause_off[c];
  for (int m = 0; m < clause_off[n_clauses]; ++m) {
    cnf.kind[m] = kind[m];
    cnf.index[m] = index[m];
  }
  for (int c = 0; c < n_clauses; ++c) cnf.theta[c] = theta[c];
  Planes p{emb_l, emb_r, scal_l, scal_r, emb_l_fstride, emb_r_fstride,
           scal_l_fstride, scal_r_fstride, d, n_r};
  const size_t smem = static_cast<size_t>(tl) * (tr / 32) * sizeof(uint32_t);
  cudaError_t err = cudaFuncSetAttribute(
      cnf_join_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(n_r / tr, n_l / tl);
  cnf_join_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      p, cnf, tl, tr, early_reject, out, evals);
  return static_cast<int>(cudaGetLastError());
}

const char* fdj_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
