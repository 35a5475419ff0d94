// Quantized (int8) partial-distance accumulate + monotone prune, hand-written
// for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `int8_partial_distance_update` of
// src/repro/kernels/distance_int8.py (body `_kernel`). Corpus and query
// codes share one affine grid per dimension block, so the zero-points cancel
// and one block's quantized-L2 step is
//   out = (acc + qn2[m]) + xn2[n]                     (norms pre-scaled, f32)
//   for each tile_k-wide chunk c of the contraction:
//     out -= (2 * s2) * float(int32 dot_c(q[m], x[n]))
// in exactly that order. +inf entries of acc stay +inf; with `prune`,
// out > tau[m] becomes +inf. It also writes an int32 skip map
// [ceil(M/tile_m), ceil(N/tile_n)]: 1 where every acc entry of the logical
// tile was +inf on entry (the TPU kernel's `pl.when(any_alive)`).
//
// What bounds it on the H100: at the ring's shapes (M = queries per group
// <= 128, N = chunk = 256, Db = 128/B <= 128) one call moves about
// N*Db + M*Db + 4*(N + 2M + 2MN) bytes (313 KB at M = 128, Db = 128: 0.094 us
// at 3.35 TB/s) and does 2*M*N*Db int8 operations (8.4 MOP: 0.004 us at
// 1979 TOP/s). Neither is near a launch: the kernel is bound by its launch
// and by the latency chain of its slowest CTA: the acc loads and a barrier,
// the staged window, the store, and for a logical tile whose first sub-tile
// is dead, the scan of the tile.
//
// Design: many CTAs per logical tile (subtile.cuh): each 16 x 32 output
// sub-tile is one CTA of eight warps, so (M, N) = (128, 256) runs 64 CTAs
// and (64, 256) 32. A CTA first
// issues 16-byte cp.async copies of its q and x code rows for the first
// contraction window (up to 256 codes of one tile_k chunk, zero-padded to a
// multiple of 32: a zero code adds 0) into shared rows of pitch 272 bytes,
// then, while they fly, loads its acc entries, norms and tau and tests the
// acc entries (__syncthreads_or). A dead sub-tile writes +inf and returns.
// The CTA at sub-index (0, 0) of a logical tile also owns the tile's skip
// bit: 0 at once if its own sub-tile is alive, else it scans the whole
// tile's acc, 16 loads of 16 bytes a thread in flight at once. Warps 0-3
// each compute 16 x 8 outputs on the s8 tensor cores, mma.sync m16n8k32
// (q[m, k] and x[n, k] are both k-contiguous: the .row.col layout), their
// fragments loaded with ldmatrix (conflict-free at this pitch); warps 4-7
// only stage and scan, which halves the scan's rounds. The int32
// accumulators restart at each tile_k chunk; a chunk's dot is exact
// (|dot| <= 1024 * 127^2 < 2^24), so is its conversion to float, and the
// fold uses the _rn intrinsics so that nvcc cannot contract it into an FMA:
// the result is bit-identical to the plain version. Rows or chunks that are not 16-byte aligned (Db
// or tile_k not a multiple of 16) are staged a 32-bit word at a time
// instead. wgmma (64-row operands) buys nothing at M <= 128.

#include "subtile.cuh"

namespace {

constexpr int kBM = 16;           // sub-tile rows (queries)
constexpr int kBN = 32;           // sub-tile columns (candidates)
constexpr int kThreads = 256;     // warp w < 4 owns columns [8w, 8w + 8);
                                  // warps 4-7 only stage and scan
constexpr int kKs = 256;          // codes staged per row at once (32 | kKs)
constexpr int kLd = kKs + 16;     // padded shared row (bytes)

// Codes [k, k+4) of one row, packed little-endian into a word; bytes at or
// past `end` are 0. A word inside the row on a 4-byte boundary is one load.
__device__ __forceinline__ int load_word(const int8_t* row, int k, int end) {
  if (k + 4 <= end && ((reinterpret_cast<uintptr_t>(row + k) & 3) == 0))
    return *reinterpret_cast<const int*>(row + k);
  int w = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (k + i < end) w |= (static_cast<int>(row[k + i]) & 0xff) << (8 * i);
  return w;
}

// Copy codes [k0, k0 + w) of the sub-tile's q and x rows into shared
// memory, zero up to the next multiple of 32, and commit one cp.async group.
__device__ __forceinline__ void stage(int8_t* qs, int8_t* xs, const int8_t* __restrict__ q,
                      const int8_t* __restrict__ x, int D, const subtile::Sub& s,
                      int k0, int w, bool vec) {
  const int nrows = s.rows + s.cols;
  const int w32 = (w + 31) & ~31;
  if (vec) {
    const int per = w32 / 16, full = w / 16;
    for (int e = threadIdx.x; e < nrows * per; e += kThreads) {
      const int r = e / per, p = 16 * (e % per);
      int8_t* dst = r < s.rows ? qs + r * kLd + p : xs + (r - s.rows) * kLd + p;
      const int8_t* src = r < s.rows ? q + (size_t)(s.r0 + r) * D
                                     : x + (size_t)(s.c0 + r - s.rows) * D;
      if (p < 16 * full)
        subtile::cp_async16(dst, src + k0 + p);
      else
        *reinterpret_cast<int4*>(dst) = make_int4(0, 0, 0, 0);
    }
  } else {
    const int per = w32 / 4;
    for (int e = threadIdx.x; e < nrows * per; e += kThreads) {
      const int r = e / per, p = 4 * (e % per);
      int8_t* dst = r < s.rows ? qs + r * kLd + p : xs + (r - s.rows) * kLd + p;
      const int8_t* src = r < s.rows ? q + (size_t)(s.r0 + r) * D
                                     : x + (size_t)(s.c0 + r - s.rows) * D;
      *reinterpret_cast<int*>(dst) = load_word(src, k0 + p, k0 + w);
    }
  }
  subtile::cp_async_commit();
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const int8_t* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void ldmatrix_x2(unsigned (&r)[2], const int8_t* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(a));
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const unsigned (&a)[4],
                                       unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__global__ void __launch_bounds__(kThreads)
partial_distance_int8_kernel(const int8_t* __restrict__ x,   // [N, D] codes
                             const float* __restrict__ xn2,  // [N]
                             const int8_t* __restrict__ q,   // [M, D] codes
                             const float* __restrict__ qn2,  // [M]
                             const float* __restrict__ s2,   // [1]
                             const float* __restrict__ acc,  // [M, N]
                             const float* __restrict__ tau,  // [M]
                             float* __restrict__ out,        // [M, N]
                             int* __restrict__ skip,         // [mt, nt]
                             int M, int N, int D, int tile_m, int tile_n,
                             int tile_k, int prune) {
  __shared__ __align__(16) int8_t qs[kBM * kLd];
  __shared__ __align__(16) int8_t xs[kBN * kLd];

  const subtile::Sub s = subtile::locate<kBM, kBN>(M, N, tile_m, tile_n);
  if (s.rows <= 0 || s.cols <= 0) return;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t4 = lane % 4;
  const bool vec = D % 16 == 0 && tile_k % 16 == 0 && subtile::aligned16(x) &&
                   subtile::aligned16(q);

  // 1. the first window's copies fly while acc is tested
  stage(qs, xs, q, x, D, s, 0, subtile::imin(kKs, subtile::imin(tile_k, D)), vec);

  // this thread's outputs, in the mma accumulator layout: row g + 8i,
  // column 8 * warp + 2 * t4 + e  <->  dot[2i + e] (none for warps 4-7,
  // whose columns lie past the sub-tile). acc, norms and tau are all
  // loaded before the first barrier.
  float a[2][2], xn[2], qn[2], t[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int m = s.r0 + subtile::imin(g + 8 * i, s.rows - 1);
    const int n = s.c0 + subtile::imin(8 * warp + 2 * t4 + i, s.cols - 1);
    qn[i] = __ldg(qn2 + m);
    xn[i] = __ldg(xn2 + n);
    t[i] = __ldg(tau + m);
  }
  const float two_s2 = __fmul_rn(2.0f, __ldg(s2));
  int any = 0;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int r = g + 8 * i, c = 8 * warp + 2 * t4 + e;
      a[i][e] = (r < s.rows && c < s.cols)
                    ? __ldg(acc + (size_t)(s.r0 + r) * N + s.c0 + c) : INFINITY;
      any |= isfinite(a[i][e]);
    }
  const int alive = __syncthreads_or(any);
  if (s.si == 0 && s.sj == 0) {
    const int tile = alive || subtile::tile_alive<kThreads>(acc, N, s);
    if (tid == 0) skip[s.tile_i * subtile::cdiv(N, tile_n) + s.tile_j] = tile ? 0 : 1;
  }
  if (!alive) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int r = g + 8 * i, c = 8 * warp + 2 * t4 + e;
        if (r < s.rows && c < s.cols) out[(size_t)(s.r0 + r) * N + s.c0 + c] = INFINITY;
      }
    subtile::cp_async_wait_all();
    return;
  }

  // 2. base = (acc + qn2) + xn2
  float v[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int e = 0; e < 2; ++e)
      v[i][e] = __fadd_rn(__fadd_rn(a[i][e], qn[i]), xn[e]);

  // 3. one f32 subtract per tile_k chunk of exact int32 tensor-core dots.
  // ldmatrix row addresses: A = q rows 0-15 (x4), B = x rows 8 * warp + 0-7
  // (x2; lanes 16-31 repeat lanes 0-15's valid addresses)
  const int8_t* pa = qs + (lane % 8 + 8 * ((lane / 8) & 1)) * kLd + 16 * (lane / 16);
  const int8_t* pb = xs + (8 * warp + lane % 8) * kLd + 16 * ((lane / 8) & 1);
  for (int c0 = 0; c0 < D; c0 += tile_k) {
    const int c1 = subtile::imin(c0 + tile_k, D);
    int dot[4] = {0, 0, 0, 0};
    for (int k0 = c0; k0 < c1; k0 += kKs) {
      const int w = subtile::imin(kKs, c1 - k0);
      if (k0 > 0) {
        __syncthreads();                       // the previous window is read
        stage(qs, xs, q, x, D, s, k0, w, vec);
      }
      subtile::cp_async_wait_all();
      __syncthreads();
      const int w32 = (w + 31) & ~31;
      for (int kk = 0; warp < kBN / 8 && kk < w32; kk += 32) {
        unsigned fa[4], fb[2];
        ldmatrix_x4(fa, pa + kk);
        ldmatrix_x2(fb, pb + kk);
        mma_s8(dot, fa, fb[0], fb[1]);
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        v[i][e] = __fsub_rn(v[i][e], __fmul_rn(two_s2, __int2float_rn(dot[2 * i + e])));
  }

  // 4. epilogue: dead stays +inf, then the prune
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int r = g + 8 * i, c = 8 * warp + 2 * t4 + e;
      if (r >= s.rows || c >= s.cols) continue;
      float o = isfinite(a[i][e]) ? v[i][e] : INFINITY;
      if (prune && o > t[i]) o = INFINITY;
      out[(size_t)(s.r0 + r) * N + s.c0 + c] = o;
    }
}

}  // namespace

extern "C" long long int8_partial_distance_ctas(int M, int N, int tile_m, int tile_n) {
  return subtile::grid_ctas<kBM, kBN>(M, N, tile_m, tile_n);
}

extern "C" int int8_partial_distance_update(
    const void* x, const void* xn2, const void* q, const void* qn2,
    const void* s2, const void* acc, const void* tau, void* out, void* skip,
    int M, int N, int D, int tile_m, int tile_n, int tile_k, int prune,
    void* stream) {
  const long long ctas = int8_partial_distance_ctas(M, N, tile_m, tile_n);
  if (ctas <= 0 || ctas > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  partial_distance_int8_kernel<<<(unsigned)ctas, kThreads, 0, (cudaStream_t)stream>>>(
      (const int8_t*)x, (const float*)xn2, (const int8_t*)q,
      (const float*)qn2, (const float*)s2, (const float*)acc,
      (const float*)tau, (float*)out, (int*)skip, M, N, D, tile_m, tile_n,
      tile_k, prune);
  return (int)cudaGetLastError();
}

extern "C" const char* partial_distance_int8_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
