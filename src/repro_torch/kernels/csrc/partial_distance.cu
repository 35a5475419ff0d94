// Partial-distance accumulate + monotone prune, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `partial_distance_update` of
// src/repro/kernels/distance.py (body `_kernel`). One dimension block's step,
// in the TPU kernel's order:
//   L2: out = (acc + qn2[m]) + xn2[n]; IP: out = acc
//   for each tile_k-wide chunk c of the contraction:
//     out -= scale * dot_c(q[m], x[n])          (scale 2 for L2, 1 for IP)
// +inf entries of acc stay +inf; with `prune`, out > tau[m] becomes +inf.
// It also writes an int32 skip map [ceil(M/tile_m), ceil(N/tile_n)]: 1 where
// every acc entry of the logical tile was +inf on entry (the TPU kernel's
// `pl.when(any_alive)`).
//
// What bounds it on the H100: at the ring's shapes (M = queries per group
// <= 128, N = chunk = 256, Db = 128/B <= 128) one call moves about
// 4*(M*N*2 + N*Db + M*Db) bytes (0.14 us at 3.35 TB/s) and does 2*M*N*Db
// flops (0.13 us at 67 TFLOP/s fp32). Neither bound is near a launch: the
// kernel is bound by its launch and by the latency chain of its slowest
// CTA: the acc loads and a barrier, the staged window, the FMA chain, the
// store, and for a logical tile whose first sub-tile is dead, the scan of
// the tile.
//
// Design: many CTAs per logical tile (subtile.cuh): each 16 x 32 output
// sub-tile is one CTA of 256 threads, so (M, N) = (128, 256) runs 64 CTAs
// and (64, 256) 32. A CTA first
// issues 16-byte cp.async copies of its q and x rows for the first
// contraction window (up to 128 columns of one tile_k chunk) into padded
// shared rows, then, while they fly, loads its acc entries, norms and tau
// and tests the acc entries (__syncthreads_or). A dead sub-tile writes +inf
// and returns. The CTA at sub-index (0, 0) of a logical tile also owns the
// tile's skip bit: 0 at once if its own sub-tile is alive, else it scans the
// whole tile's acc, 16 loads of 16 bytes a thread in flight at once (a
// 128 x 128 tile in one round). Each window needs one barrier. The two
// 128-thread halves of the CTA take the two halves of the window; each
// thread owns 2 x 2 outputs (rows ty, ty+8, columns tx, tx+16) and reads
// float4s of the shared rows, conflict-free (row pitch 132 floats); the
// second half hands its dots to the first through shared memory. The dot
// stays on the FMA pipes in fp32: no TF32, which would move pruning
// decisions near tau. Each chunk is folded with __fsub_rn/__fmul_rn, so nvcc
// cannot contract the fold into an FMA and change the TPU kernel's order.
// Rows or chunks that are not 16-byte aligned (Db or tile_k not a multiple
// of 4) are staged 4 bytes a copy instead, zero-padded to whole float4s.

#include "subtile.cuh"

namespace {

constexpr int kBM = 16;           // sub-tile rows (queries)
constexpr int kBN = 32;           // sub-tile columns (candidates)
constexpr int kThreads = 256;     // two halves (kh) of 128 threads
constexpr int kKs = 128;          // contraction columns staged at once
constexpr int kLd = kKs + 4;      // padded shared row (floats)

// Copy columns [k0, k0 + w) of the sub-tile's q and x rows into shared
// memory and commit them as one cp.async group; on the scalar path the
// columns up to the next multiple of 4 are zeroed.
__device__ __forceinline__ void stage(float* qs, float* xs, const float* __restrict__ q,
                      const float* __restrict__ x, int D, const subtile::Sub& s,
                      int k0, int w, bool vec) {
  const int nrows = s.rows + s.cols;
  if (vec) {
    const int per = w / 4;
    for (int e = threadIdx.x; e < nrows * per; e += kThreads) {
      const int r = e / per, p = 4 * (e % per);
      if (r < s.rows)
        subtile::cp_async16(qs + r * kLd + p, q + (size_t)(s.r0 + r) * D + k0 + p);
      else
        subtile::cp_async16(xs + (r - s.rows) * kLd + p,
                            x + (size_t)(s.c0 + r - s.rows) * D + k0 + p);
    }
  } else {
    const int w4 = (w + 3) & ~3;
    for (int e = threadIdx.x; e < nrows * w4; e += kThreads) {
      const int r = e / w4, k = e % w4;
      float* dst = r < s.rows ? qs + r * kLd + k : xs + (r - s.rows) * kLd + k;
      const float* src = r < s.rows ? q + (size_t)(s.r0 + r) * D
                                    : x + (size_t)(s.c0 + r - s.rows) * D;
      if (k < w)
        subtile::cp_async4(dst, src + k0 + k);
      else
        *dst = 0.0f;
    }
  }
  subtile::cp_async_commit();
}

__global__ void __launch_bounds__(kThreads)
partial_distance_kernel(const float* __restrict__ x,     // [N, D]
                        const float* __restrict__ xn2,   // [N]
                        const float* __restrict__ q,     // [M, D]
                        const float* __restrict__ qn2,   // [M]
                        const float* __restrict__ acc,   // [M, N]
                        const float* __restrict__ tau,   // [M]
                        float* __restrict__ out,         // [M, N]
                        int* __restrict__ skip,          // [mt, nt]
                        int M, int N, int D, int tile_m, int tile_n,
                        int tile_k, int l2, int prune) {
  __shared__ __align__(16) float qs[kBM * kLd];
  __shared__ __align__(16) float xs[kBN * kLd];
  __shared__ float4 part[kThreads / 2];           // the kh = 1 half's dots

  const subtile::Sub s = subtile::locate<kBM, kBN>(M, N, tile_m, tile_n);
  if (s.rows <= 0 || s.cols <= 0) return;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16 % 8, kh = tid / 128;
  const bool vec = D % 4 == 0 && tile_k % 4 == 0 && subtile::aligned16(x) &&
                   subtile::aligned16(q);

  // 1. the first window's copies fly while acc is tested
  stage(qs, xs, q, x, D, s, 0, subtile::imin(kKs, subtile::imin(tile_k, D)), vec);

  // this thread's outputs (rows ty, ty+8; columns tx, tx+16): acc, norms
  // and tau are all loaded before the first barrier
  float a[2][2], qn[2], xn[2], t[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int m = s.r0 + subtile::imin(ty + 8 * i, s.rows - 1);
    const int n = s.c0 + subtile::imin(tx + 16 * i, s.cols - 1);
    qn[i] = l2 ? __ldg(qn2 + m) : 0.0f;
    xn[i] = l2 ? __ldg(xn2 + n) : 0.0f;
    t[i] = __ldg(tau + m);
  }
  int any = 0;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int r = ty + 8 * i, c = tx + 16 * j;
      a[i][j] = (r < s.rows && c < s.cols)
                    ? __ldg(acc + (size_t)(s.r0 + r) * N + s.c0 + c) : INFINITY;
      any |= isfinite(a[i][j]);
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
      for (int j = 0; j < 2; ++j) {
        const int r = ty + 8 * i, c = tx + 16 * j;
        if (!kh && r < s.rows && c < s.cols)
          out[(size_t)(s.r0 + r) * N + s.c0 + c] = INFINITY;
      }
    subtile::cp_async_wait_all();
    return;
  }

  // 2. base = (acc + qn2) + xn2 (L2) or acc (IP)
  float v[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      v[i][j] = l2 ? __fadd_rn(__fadd_rn(a[i][j], qn[i]), xn[j]) : a[i][j];

  // 3. one subtract per tile_k chunk; a chunk is staged kKs columns at a
  // time. The two halves of the CTA take the two halves of each window, and
  // the kh = 1 half hands its dots over through shared memory.
  const float scale = l2 ? 2.0f : 1.0f;
  const float* qa = qs + ty * kLd;
  const float* qb = qs + (ty + 8) * kLd;
  const float* xa = xs + tx * kLd;
  const float* xb = xs + (tx + 16) * kLd;
  for (int c0 = 0; c0 < D; c0 += tile_k) {
    const int c1 = subtile::imin(c0 + tile_k, D);
    float d00 = 0.0f, d01 = 0.0f, d10 = 0.0f, d11 = 0.0f;
    for (int k0 = c0; k0 < c1; k0 += kKs) {
      const int w = subtile::imin(kKs, c1 - k0);
      if (k0 > 0) {
        __syncthreads();                       // the previous window is read
        stage(qs, xs, q, x, D, s, k0, w, vec);
      }
      subtile::cp_async_wait_all();
      __syncthreads();
      const int w4 = (w + 3) & ~3, half = (w4 / 4 + 1) / 2 * 4;
#pragma unroll 4
      for (int k = kh ? half : 0; k < (kh ? w4 : half); k += 4) {
        const float4 p0 = *reinterpret_cast<const float4*>(qa + k);
        const float4 p1 = *reinterpret_cast<const float4*>(qb + k);
        const float4 y0 = *reinterpret_cast<const float4*>(xa + k);
        const float4 y1 = *reinterpret_cast<const float4*>(xb + k);
        d00 = fmaf(p0.x, y0.x, d00); d00 = fmaf(p0.y, y0.y, d00);
        d00 = fmaf(p0.z, y0.z, d00); d00 = fmaf(p0.w, y0.w, d00);
        d01 = fmaf(p0.x, y1.x, d01); d01 = fmaf(p0.y, y1.y, d01);
        d01 = fmaf(p0.z, y1.z, d01); d01 = fmaf(p0.w, y1.w, d01);
        d10 = fmaf(p1.x, y0.x, d10); d10 = fmaf(p1.y, y0.y, d10);
        d10 = fmaf(p1.z, y0.z, d10); d10 = fmaf(p1.w, y0.w, d10);
        d11 = fmaf(p1.x, y1.x, d11); d11 = fmaf(p1.y, y1.y, d11);
        d11 = fmaf(p1.z, y1.z, d11); d11 = fmaf(p1.w, y1.w, d11);
      }
    }
    if (kh) part[tid - 128] = make_float4(d00, d01, d10, d11);
    __syncthreads();
    if (kh) continue;
    const float4 h = part[tid];
    d00 += h.x; d01 += h.y; d10 += h.z; d11 += h.w;
    v[0][0] = __fsub_rn(v[0][0], __fmul_rn(scale, d00));
    v[0][1] = __fsub_rn(v[0][1], __fmul_rn(scale, d01));
    v[1][0] = __fsub_rn(v[1][0], __fmul_rn(scale, d10));
    v[1][1] = __fsub_rn(v[1][1], __fmul_rn(scale, d11));
  }

  // 4. epilogue (the kh = 0 half): dead stays +inf, then the prune
  if (kh) return;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int r = ty + 8 * i, c = tx + 16 * j;
      if (r >= s.rows || c >= s.cols) continue;
      float o = isfinite(a[i][j]) ? v[i][j] : INFINITY;
      if (prune && o > t[i]) o = INFINITY;
      out[(size_t)(s.r0 + r) * N + s.c0 + c] = o;
    }
}

}  // namespace

extern "C" long long partial_distance_ctas(int M, int N, int tile_m, int tile_n) {
  return subtile::grid_ctas<kBM, kBN>(M, N, tile_m, tile_n);
}

extern "C" int partial_distance_update_f32(
    const void* x, const void* xn2, const void* q, const void* qn2,
    const void* acc, const void* tau, void* out, void* skip,
    int M, int N, int D, int tile_m, int tile_n, int tile_k, int l2, int prune,
    void* stream) {
  const long long ctas = partial_distance_ctas(M, N, tile_m, tile_n);
  if (ctas <= 0 || ctas > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  partial_distance_kernel<<<(unsigned)ctas, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)xn2, (const float*)q, (const float*)qn2,
      (const float*)acc, (const float*)tau, (float*)out, (int*)skip,
      M, N, D, tile_m, tile_n, tile_k, l2, prune);
  return (int)cudaGetLastError();
}

extern "C" const char* partial_distance_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
