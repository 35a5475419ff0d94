// Sub-tile geometry, asynchronous staging and the tile-alive scan shared by
// the two partial-distance kernels (partial_distance.cu,
// partial_distance_int8.cu).
//
// The output [M, N] is cut into logical tile_m x tile_n tiles: the skip
// map's granularity, the TPU kernel's BlockSpec. Each logical tile is
// covered by sub_m x sub_n CTAs of BM x BN outputs, sub_m =
// ceil(min(tile_m, M) / BM), clipped to the tile's edge, so a sub-tile
// never straddles two logical tiles and a CTA knows its tile. The grid is
// one-dimensional, n fastest.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace subtile {

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }
__host__ __device__ inline int imin(int a, int b) { return a < b ? a : b; }

template <int BM, int BN>
__host__ __device__ inline long long grid_ctas(int M, int N, int tile_m, int tile_n) {
  return (long long)cdiv(M, tile_m) * cdiv(imin(tile_m, M), BM) *
         cdiv(N, tile_n) * cdiv(imin(tile_n, N), BN);
}

struct Sub {
  int tile_i, tile_j;   // logical tile
  int si, sj;           // sub-tile inside it
  int m0, n0, tm, tn;   // logical tile: first row/column and extent
  int r0, c0;           // sub-tile: first row/column
  int rows, cols;       // sub-tile extent; <= 0 past a ragged tile's edge
};

template <int BM, int BN>
__device__ inline Sub locate(int M, int N, int tile_m, int tile_n) {
  const int sn_per = cdiv(imin(tile_n, N), BN), nt = cdiv(N, tile_n);
  const int sm_per = cdiv(imin(tile_m, M), BM);
  int b = blockIdx.x;
  Sub s;
  s.sj = b % sn_per; b /= sn_per;
  s.tile_j = b % nt; b /= nt;
  s.si = b % sm_per;
  s.tile_i = b / sm_per;
  s.m0 = s.tile_i * tile_m;
  s.n0 = s.tile_j * tile_n;
  s.tm = imin(tile_m, M - s.m0);
  s.tn = imin(tile_n, N - s.n0);
  s.r0 = s.m0 + s.si * BM;
  s.c0 = s.n0 + s.sj * BN;
  s.rows = imin(BM, s.m0 + s.tm - s.r0);
  s.cols = imin(BN, s.n0 + s.tn - s.c0);
  return s;
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// 1 if any acc entry of the logical tile is finite, else 0. Every thread of
// the CTA must call it. Each thread issues U loads at once (16 bytes each
// where the rows allow it), clamped into the tile so that none is guarded
// and all are in flight together; the CTA stops at the first round that
// finds a finite entry.
template <int T, bool VEC>
__device__ int tile_alive_rounds(const float* __restrict__ acc, int N, const Sub& s) {
  constexpr int U = 16;
  const int per = VEC ? s.tn / 4 : s.tn;
  const int total = s.tm * per;
  for (int e0 = 0; e0 < total; e0 += T * U) {
    float4 v[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int e = imin(e0 + u * T + (int)threadIdx.x, total - 1);
      const float* row = acc + (size_t)(s.m0 + e / per) * N + s.n0;
      if (VEC) {
        v[u] = __ldg(reinterpret_cast<const float4*>(row) + e % per);
      } else {
        const float f = __ldg(row + e % per);
        v[u] = make_float4(f, f, f, f);
      }
    }
    int alive = 0;
#pragma unroll
    for (int u = 0; u < U; ++u)
      alive |= isfinite(v[u].x) | isfinite(v[u].y) | isfinite(v[u].z) | isfinite(v[u].w);
    if (__syncthreads_or(alive)) return 1;
  }
  return 0;
}

template <int T>
__device__ int tile_alive(const float* __restrict__ acc, int N, const Sub& s) {
  if (N % 4 == 0 && s.n0 % 4 == 0 && s.tn % 4 == 0 && aligned16(acc))
    return tile_alive_rounds<T, true>(acc, N, s);
  return tile_alive_rounds<T, false>(acc, N, s);
}

}  // namespace subtile
