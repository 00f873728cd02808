// Fused CNF join over L x R for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel `cnf_join_block` (src/repro/kernels/
// fused_cnf_join/kernel.py, with `_cnf_body`, `_clause_min_dist` and
// `_pack_tile`).  For every pair (i, j) of the (n_l x n_r) plane:
//
//   embed member:  d = clip(0.5 - 0.5 * <emb_l[f, i], emb_r[f, j]>, 0, 1)
//   scalar member: d = clip(|scal_l[f, i] - scal_r[f, j]|, 0, 1)
//   clause c passes iff min over its members of d <= theta[c] (f32 compare)
//   the pair is a candidate iff every clause passes
//
// and the result is packed to 32-bit words along R: bit b of word w is
// column 32w + b.  With `early_reject` and >= 2 clauses, a logical
// (tl x tr) tile where clause 0 passes nowhere counts 1 clause evaluated
// and its later clauses are not evaluated; every other tile counts C.
//
// Design against the bound.  The work is the dot products: 2 * D FLOP per
// embed member and pair (the mask, n_l * n_r / 8 bytes, and the epilogue
// are small beside it).  They run on the tensor cores as 3xTF32 split
// products: each f32 operand x is split as hi = rna_tf32(x), lo =
// rna_tf32(x - hi), and mma.sync m16n8k8 accumulates Ah*Bh + Ah*Bl +
// Al*Bh in f32.  The dropped Al*Bl term and the split residue add at most
// ~3 * 2^-22 to the dot of two unit vectors, inside the band D * 2^-24
// that any f32 summation order already needs (plain TF32, ~11 bits, would
// move the candidate set: thresholds sit on sample positives' distances).
// Ceiling: 495 TFLOP/s TF32 / 3 = 165 TFLOP/s f32-equivalent.
//
// The splits are two integer ops each (add half a TF32 ulp, clear the low
// 13 bits), not cvt, which costs several.
//
// The grid is decoupled from the logical tile: each block owns a fixed
// 128 x 128 block tile (8 warps, 2 x 4, each 64 rows x 32 columns, so one
// warp-column is one output word), two blocks to an SM (128 registers a
// thread, 80 KB of shared memory each); the main path's 1024 x 3072
// launch is 192 blocks, where one block per logical tile was 24.  The
// embed members of all clauses form one stream of 32-wide D-chunks
// staged by cp.async (16 bytes a thread when rows are 16-byte
// aligned, else 4) into a 2-stage ring, so the next chunk -- of this
// member or the next -- loads under this chunk's products and each
// member's epilogue.  Inside each 8-wide k step k is permuted the same way
// for both operands so that a fragment is one 8-byte shared load.  K
// beyond D and rows beyond the plane are zero-filled.  Blocks are rastered
// in groups of 8 block-rows so that the blocks in flight share their L and
// R tiles in L2.  Per pair, a clause's bit is the OR of its members'
// compares (min d <= theta iff some d <= theta) and clauses AND together;
// each thread keeps its pairs' bits in registers, spread into four partial
// words per row at the end that a quad of lanes ORs into the output word.
//
// Early reject is one launch too: after clause 0, each warp sets an int32
// live flag per logical tile where it passes (one atomicOr per warp and
// tile), and a block goes on to the later clauses only if clause 0 passes
// somewhere in its block tile (elsewhere they cannot change the mask).
// The last block to finish turns the flags into the evals grid (C where
// live, else 1), which is the reference's count at equal (tl, tr); without
// early reject every tile counts C.  The launch function zeroes the flags
// on the stream (cudaMemsetAsync) before the kernel.
//
// The clause structure (member kinds, indices, clause offsets) and theta
// are runtime kernel parameters, so one build serves every plan.
//
// Not done here (later work): wgmma with a TMA ring and warp
// specialisation, a persistent grid.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;                     // 8 warps, 2 x 4
constexpr int kBM = 128;                          // block tile rows (L)
constexpr int kBN = 128;                          // block tile columns (R)
constexpr int kWM = kBM / 2;                      // warp tile rows
constexpr int kWN = 32;                           // warp tile columns = 1 word
constexpr int kWarpsN = kBN / kWN;                // warps along R
constexpr int kMT = kWM / 16;                     // m16 tiles per warp
constexpr int kNT = kWN / 8;                      // n8 tiles per warp
constexpr int kBitWords = (kMT * 2 + 3) / 4;      // a thread's pair bits
constexpr int kBK = 32;                           // D chunk per stage
constexpr int kStride = kBK + 8;                  // floats; conflict-free frags
constexpr int kStages = 2;
constexpr int kStageFloats = (kBM + kBN) * kStride;
constexpr int kSmemBytes = kStages * kStageFloats * 4;   // 80 KB
constexpr int kMinBlocks = 2;                     // blocks per SM
constexpr int kGroupM = 8;                        // block-rows per raster group
static_assert(2 * kWarpsN * 32 == kThreads, "warp layout");
constexpr int kMaxClauses = 32;
constexpr int kMaxMembers = 64;
constexpr int kVec = 0;

struct Cnf {
  int n_clauses;
  int clause_off[kMaxClauses + 1];
  int kind[kMaxMembers];
  int index[kMaxMembers];
  float theta[kMaxClauses];
  int vec_start[kMaxClauses + 1];   // embed members in clauses before c
  int vec_index[kMaxMembers];       // feature of the k-th embed member
  int vec_clause[kMaxMembers];      // and its clause
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
  int n_l;
  int n_r;
};

__device__ __forceinline__ float clip01(float x) {
  return fminf(fmaxf(x, 0.0f), 1.0f);
}

// round to TF32 (10 mantissa bits), to nearest, ties away from zero: what
// cvt.rna.tf32.f32 computes for finite inputs, in two integer ops on the
// full-rate pipe (cvt costs several)
__device__ __forceinline__ uint32_t rna_tf32(uint32_t bits) {
  return (bits + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = rna_tf32(__float_as_uint(x));
  lo = rna_tf32(__float_as_uint(x - __uint_as_float(hi)));   // x - hi exact
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// cp.async with zero fill: copies `src_bytes` (0 or the full size) and
// fills the rest of the destination with zeros
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(s), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Stage rows [row0, row0 + kRows) x D-chunk kc of one plane (row r at
// plane + r * d) into a (kRows x kStride) shared tile.
template <bool kVec16, int kRows>
__device__ __forceinline__ void load_tile(float* dst, const float* plane,
                                          int row0, int n_rows, int d, int kc,
                                          int tid) {
  const int k0 = kc * kBK;
  if (kVec16) {                      // d % 4 == 0, rows 16-byte aligned
#pragma unroll
    for (int i = 0; i < kRows * kBK / 4 / kThreads; ++i) {
      const int v = tid + i * kThreads;
      const int r = v / (kBK / 4), k = k0 + (v % (kBK / 4)) * 4;
      const bool ok = row0 + r < n_rows && k < d;
      const float* src = ok ? plane + (long long)(row0 + r) * d + k : plane;
      cp_async16(dst + r * kStride + (k - k0), src, ok ? 16 : 0);
    }
  } else {
#pragma unroll 4
    for (int i = 0; i < kRows * kBK / kThreads; ++i) {
      const int e = tid + i * kThreads;
      const int r = e / kBK, k = k0 + e % kBK;
      const bool ok = row0 + r < n_rows && k < d;
      const float* src = ok ? plane + (long long)(row0 + r) * d + k : plane;
      cp_async4(dst + r * kStride + (k - k0), src, ok ? 4 : 0);
    }
  }
}

// OR into `bits` (the packed layout of the kernel) the pairs where one of
// clause c's scalar members passes; row0 is this thread's first row, col0
// its first column
__device__ __forceinline__ void scalar_members(
    const Planes& p, const Cnf& cnf, int c, int row0, int col0,
    uint32_t (&bits)[kBitWords]) {
  const float theta = cnf.theta[c];
  for (int m = cnf.clause_off[c]; m < cnf.clause_off[c + 1]; ++m) {
    if (cnf.kind[m] == kVec) continue;
    const float* x = p.scal_l + cnf.index[m] * p.scal_l_fstride;
    const float* y = p.scal_r + cnf.index[m] * p.scal_r_fstride;
    float yv[kNT][2];
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int col = col0 + nt * 8 + j;
        yv[nt][j] = col < p.n_r ? y[col] : 0.0f;
      }
#pragma unroll
    for (int s = 0; s < kMT * 2; ++s) {
      const int row = row0 + (s >> 1) * 16 + (s & 1) * 8;
      const float xv = row < p.n_l ? x[row] : 0.0f;
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          if (clip01(fabsf(xv - yv[nt][j])) <= theta)
            bits[s >> 2] |= 1u << ((s & 3) * 8 + nt * 2 + j);
    }
  }
}

template <bool kVec16>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
cnf_join_kernel(Planes p, Cnf cnf, int early_reject, int tl, int tr,
                int32_t* __restrict__ out, int32_t* __restrict__ evals,
                int32_t* __restrict__ live) {
  extern __shared__ __align__(16) float ring[];
  __shared__ int last_block;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;           // mma group: row within an 8-row half
  const int tig = lane & 3;          // thread in group: column pair
  const int wr0 = (warp / kWarpsN) * kWM;
  const int wc0 = (warp % kWarpsN) * kWN;

  // grouped raster: kGroupM block-rows walk R together
  const int num_m = (p.n_l + kBM - 1) / kBM;
  const int num_n = (p.n_r + kBN - 1) / kBN;
  const int per_group = kGroupM * num_n;
  const int bid = blockIdx.x;
  const int first_m = (bid / per_group) * kGroupM;
  const int rows_in_group = min(num_m - first_m, kGroupM);
  const int bm = first_m + (bid % per_group) % rows_in_group;
  const int bn = (bid % per_group) / rows_in_group;
  const int r0 = bm * kBM;
  const int c0 = bn * kBN;

  const int n_c = cnf.n_clauses;
  const bool gate = early_reject && n_c >= 2;
  const int tiles_r = p.n_r / tr;
  const long long n_tiles = (long long)(p.n_l / tl) * tiles_r;

  if (!gate && evals != nullptr) {
    // every tile evaluates every clause: the block that holds a logical
    // tile's origin writes its count
    const int row_hi = min(r0 + kBM, p.n_l), col_hi = min(c0 + kBN, p.n_r);
    const int ti0 = (r0 + tl - 1) / tl, ti1 = (row_hi - 1) / tl;
    const int tj0 = (c0 + tr - 1) / tr, tj1 = (col_hi - 1) / tr;
    const int ni = ti1 - ti0 + 1, nj = tj1 - tj0 + 1;
    if (ni > 0 && nj > 0)
      for (int e = tid; e < ni * nj; e += kThreads)
        evals[(long long)(ti0 + e / nj) * tiles_r + tj0 + e % nj] = n_c;
  }

  // this thread's kMT * 16 pairs, one bit each: slot s = mt * 2 + h (row
  // wr0 + mt*16 + h*8 + g) is byte s & 3 of word s >> 2, and in it bit
  // nt * 2 + j is column wc0 + nt*8 + tig*2 + j
  const int col_word = c0 + wc0;               // first column of the word
  const bool col_ok = col_word < p.n_r;
  uint32_t words[kBitWords];                   // clauses so far
  uint32_t cbits[kBitWords];                   // this clause's members
  uint32_t inside[kBitWords];                  // pairs inside the plane
#pragma unroll
  for (int i = 0; i < kBitWords; ++i) {
    words[i] = 0xffffffffu;
    cbits[i] = 0u;
    inside[i] = 0u;
  }
#pragma unroll
  for (int s = 0; s < kMT * 2; ++s)
    if (col_ok && r0 + wr0 + (s >> 1) * 16 + (s & 1) * 8 + g < p.n_l)
      inside[s >> 2] |= 0xffu << ((s & 3) * 8);

  auto close_clause = [&]() {
#pragma unroll
    for (int i = 0; i < kBitWords; ++i) {
      words[i] &= cbits[i];
      cbits[i] = 0u;
    }
  };
  // Under early reject, once clause 0 is in `words`: flag the logical
  // tiles where it passes (one atomicOr per warp and tile), and go on only
  // if it passes somewhere in this block tile -- where it passes nowhere,
  // the later clauses cannot change the mask.
  auto clause0_gate = [&]() -> bool {
    uint32_t any = 0u;
#pragma unroll
    for (int i = 0; i < kBitWords; ++i) any |= words[i] & inside[i];
    const int wrow0 = r0 + wr0;
    const int wrow1 = min(wrow0 + kWM, p.n_l) - 1;
    if (col_ok && wrow0 <= wrow1) {
      for (int ti = wrow0 / tl; ti <= wrow1 / tl; ++ti) {
        int mine = 0;
#pragma unroll
        for (int s = 0; s < kMT * 2; ++s) {
          const int row = r0 + wr0 + (s >> 1) * 16 + (s & 1) * 8 + g;
          if ((((words[s >> 2] & inside[s >> 2]) >> ((s & 3) * 8)) & 0xffu) &&
              row / tl == ti)
            mine = 1;
        }
        if (__ballot_sync(0xffffffffu, mine) != 0u && lane == 0) {
          int32_t* flag = live + (long long)ti * tiles_r + col_word / tr;
          if (*reinterpret_cast<volatile int32_t*>(flag) == 0)
            atomicOr(flag, 1);
        }
      }
    }
    return __syncthreads_or(any != 0u);
  };

  bool going = true;
  const bool clause0_scalar = cnf.vec_start[1] == 0;
  if (clause0_scalar) {
    scalar_members(p, cnf, 0, r0 + wr0 + g, c0 + wc0 + tig * 2, cbits);
    close_clause();
    if (gate) going = clause0_gate();
  }

  // the embed members of all clauses, in clause order, as one stream of
  // D-chunks through the ring, so the next member's first chunks load
  // under this one's last products and its epilogue
  const int nk = (p.d + kBK - 1) / kBK;
  const int jobs = going ? cnf.vec_start[n_c] * nk : 0;
  auto load_job = [&](int j) {
    const int fi = cnf.vec_index[j / nk];
    float* st = ring + (j % kStages) * kStageFloats;
    load_tile<kVec16, kBM>(st, p.emb_l + fi * p.emb_l_fstride, r0, p.n_l,
                           p.d, j % nk, tid);
    load_tile<kVec16, kBN>(st + kBM * kStride, p.emb_r + fi * p.emb_r_fstride,
                           c0, p.n_r, p.d, j % nk, tid);
  };
  float acc[kMT][kNT][4];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.0f;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < jobs) load_job(s);
    cp_async_commit();
  }
  for (int j = 0; j < jobs; ++j) {
    cp_async_wait<kStages - 2>();     // chunk j has landed (this thread)
    __syncthreads();                  // ... for all; slot j - 1 is free
    if (j + kStages - 1 < jobs) load_job(j + kStages - 1);
    cp_async_commit();

    const float* As = ring + (j % kStages) * kStageFloats;
    const float* Bs = As + kBM * kStride;
#pragma unroll
    for (int ks = 0; ks < kBK / 8; ++ks) {
      // k is permuted inside each 8-wide step, the same way for A and B:
      // the fragment's k = tig and k = tig + 4 are the adjacent columns
      // 2*tig and 2*tig + 1, one 8-byte load
      const int kb = ks * 8 + 2 * tig;
      uint32_t bh[kNT][2], bl[kNT][2];
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        const float2 v = *reinterpret_cast<const float2*>(
            Bs + (wc0 + nt * 8 + g) * kStride + kb);
        split_tf32(v.x, bh[nt][0], bl[nt][0]);
        split_tf32(v.y, bh[nt][1], bl[nt][1]);
      }
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
        const float* ap = As + (wr0 + mt * 16 + g) * kStride + kb;
        const float2 top = *reinterpret_cast<const float2*>(ap);
        const float2 bot = *reinterpret_cast<const float2*>(ap + 8 * kStride);
        uint32_t ah[4], al[4];
        split_tf32(top.x, ah[0], al[0]);   // (row g,     k tig)
        split_tf32(bot.x, ah[1], al[1]);   // (row g + 8, k tig)
        split_tf32(top.y, ah[2], al[2]);   // (row g,     k tig + 4)
        split_tf32(bot.y, ah[3], al[3]);   // (row g + 8, k tig + 4)
        // small terms first, then the large one; each pass runs over
        // four independent accumulators
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt) mma_tf32(acc[mt][nt], al, bh[nt]);
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt) mma_tf32(acc[mt][nt], ah, bl[nt]);
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt) mma_tf32(acc[mt][nt], ah, bh[nt]);
      }
    }

    if (j % nk == nk - 1) {           // an embed member is complete
      const int vm = j / nk;
      const int c = cnf.vec_clause[vm];
      const float theta = cnf.theta[c];
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            // 0.5 * dot is exact, so this rounds once, as the reference does
            const float dist = clip01(0.5f - 0.5f * acc[mt][nt][e]);
            const int s = mt * 2 + (e >> 1);
            if (dist <= theta)
              cbits[s >> 2] |= 1u << ((s & 3) * 8 + nt * 2 + (e & 1));
            acc[mt][nt][e] = 0.0f;
          }
      if (vm + 1 == cnf.vec_start[c + 1]) {   // and with it its clause
        scalar_members(p, cnf, c, r0 + wr0 + g, c0 + wc0 + tig * 2, cbits);
        close_clause();
        if (c == 0 && gate && !clause0_gate()) {
          going = false;
          break;
        }
      }
    }
  }
  cp_async_wait<0>();                 // no copy outlives the block

  if (going)                          // clauses with no embed member
    for (int c = clause0_scalar ? 1 : 0; c < n_c; ++c)
      if (cnf.vec_start[c] == cnf.vec_start[c + 1]) {
        scalar_members(p, cnf, c, r0 + wr0 + g, c0 + wc0 + tig * 2, cbits);
        close_clause();
      }

  // a quad of lanes holds one row's word: spread each byte to its bit
  // positions nt*8 + tig*2 + j, OR the four partial words, and the lane
  // with tig == s % 4 writes slot s
  const long long out_words = p.n_r / 32;
#pragma unroll
  for (int s = 0; s < kMT * 2; ++s) {
    const uint32_t b = (words[s >> 2] >> ((s & 3) * 8)) & 0xffu;
    uint32_t w = ((b & 0x03u) | ((b & 0x0cu) << 6) | ((b & 0x30u) << 12) |
                  ((b & 0xc0u) << 18)) << (tig * 2);
    w |= __shfl_xor_sync(0xffffffffu, w, 1);
    w |= __shfl_xor_sync(0xffffffffu, w, 2);
    const int row = r0 + wr0 + (s >> 1) * 16 + (s & 1) * 8 + g;
    if ((s & 3) == tig && col_ok && row < p.n_l)
      out[(long long)row * out_words + col_word / 32] = static_cast<int32_t>(w);
  }

  if (gate && evals != nullptr) {
    // the last block to finish turns the live flags into the evals grid;
    // the counter sits after the flags
    __syncthreads();                  // this block's flags are set
    if (tid == 0) {
      __threadfence();
      last_block = atomicAdd(live + n_tiles, 1) == (int)gridDim.x - 1;
    }
    __syncthreads();
    if (last_block) {
      __threadfence();
      const volatile int32_t* flags = live;
      for (long long t = tid; t < n_tiles; t += kThreads)
        evals[t] = flags[t] ? n_c : 1;
    }
  }
}

template <bool kVec16>
cudaError_t launch(const Planes& p, const Cnf& cnf, int tl, int tr,
                   int early_reject, int32_t* out, int32_t* evals,
                   int32_t* live, cudaStream_t stream) {
  static uint64_t configured = 0;        // devices with the smem limit set
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (!((configured >> dev) & 1u)) {
    err = cudaFuncSetAttribute(cnf_join_kernel<kVec16>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmemBytes);
    if (err != cudaSuccess) return err;
    configured |= uint64_t{1} << dev;
  }
  const long long blocks = (long long)((p.n_l + kBM - 1) / kBM) *
                           ((p.n_r + kBN - 1) / kBN);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  cnf_join_kernel<kVec16><<<static_cast<int>(blocks), kThreads, kSmemBytes,
                            stream>>>(p, cnf, early_reject, tl, tr, out,
                                      evals, live);
  return cudaGetLastError();
}

bool aligned16(const void* ptr) {
  return (reinterpret_cast<uintptr_t>(ptr) & 15u) == 0;
}

}  // namespace

extern "C" {

// Launches the fused CNF join on `stream`.  emb_*: (F_v, n, d) f32 with rows
// contiguous (feature planes `*_fstride` elements apart); scal_*: (F_s, n)
// f32 likewise.  clause_off[n_clauses + 1] delimits each clause's members in
// kind[] / index[] (host arrays); theta[n_clauses] is f32.  out is the
// int32 (n_l, n_r / 32) mask; evals, if not null, the int32
// (n_l / tl, n_r / tr) grid.  live is int32 scratch of (n_l / tl) *
// (n_r / tr) + 1 elements (a flag per logical tile and a block counter,
// zeroed here on the stream), needed only with early_reject and >= 2
// clauses.
// Returns a cudaError_t (0 on success).
int cnf_join_launch(const float* emb_l, const float* emb_r,
                    const float* scal_l, const float* scal_r,
                    long long emb_l_fstride, long long emb_r_fstride,
                    long long scal_l_fstride, long long scal_r_fstride,
                    int n_l, int n_r, int d, int n_clauses,
                    const int* clause_off, const int* kind, const int* index,
                    const float* theta, int tl, int tr, int early_reject,
                    int32_t* out, int32_t* evals, int32_t* live,
                    void* stream) {
  if (n_clauses < 1 || n_clauses > kMaxClauses || tl <= 0 || tr <= 0 ||
      tr % 32 != 0 || n_l % tl != 0 || n_r % tr != 0 || d <= 0 ||
      clause_off[0] != 0 || clause_off[n_clauses] > kMaxMembers)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_l == 0 || n_r == 0) return 0;
  if (early_reject && n_clauses >= 2 && live == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  Cnf cnf;
  cnf.n_clauses = n_clauses;
  for (int c = 0; c <= n_clauses; ++c) cnf.clause_off[c] = clause_off[c];
  for (int m = 0; m < clause_off[n_clauses]; ++m) {
    cnf.kind[m] = kind[m];
    cnf.index[m] = index[m];
  }
  for (int c = 0; c < n_clauses; ++c) cnf.theta[c] = theta[c];
  int n_vec = 0;
  for (int c = 0; c < n_clauses; ++c) {
    cnf.vec_start[c] = n_vec;
    for (int m = clause_off[c]; m < clause_off[c + 1]; ++m)
      if (kind[m] == kVec) {
        cnf.vec_index[n_vec] = index[m];
        cnf.vec_clause[n_vec++] = c;
      }
  }
  cnf.vec_start[n_clauses] = n_vec;
  Planes p{emb_l, emb_r, scal_l, scal_r, emb_l_fstride, emb_r_fstride,
           scal_l_fstride, scal_r_fstride, d, n_l, n_r};
  const bool vec16 = d % 4 == 0 && emb_l_fstride % 4 == 0 &&
                     emb_r_fstride % 4 == 0 && aligned16(emb_l) &&
                     aligned16(emb_r);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (early_reject && n_clauses >= 2) {
    const size_t n_flags = (size_t)(n_l / tl) * (n_r / tr) + 1;
    const cudaError_t zero =
        cudaMemsetAsync(live, 0, n_flags * sizeof(int32_t), s);
    if (zero != cudaSuccess) return static_cast<int>(zero);
  }
  const cudaError_t err =
      vec16 ? launch<true>(p, cnf, tl, tr, early_reject, out, evals, live, s)
            : launch<false>(p, cnf, tl, tr, early_reject, out, evals, live, s);
  return static_cast<int>(err);
}

const char* fdj_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
