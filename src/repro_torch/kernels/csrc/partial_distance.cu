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
//
// bf16 rows (the TPU kernel's `x.astype(f32)` before the dot): the kernel is
// a template on the row type. bf16 rows are staged with 16-byte cp.async
// copies of 8 elements into bf16 shared rows (pitch 136 elements, so the 16
// rows a half-warp reads at once fall on distinct banks in two wavefronts),
// and each thread widens 8 of them to f32 in registers (a bf16 is the top
// half of an f32: a shift, exact) per step of 8. Queries, norms, the
// accumulator, the dot and tau stay f32, and the FMA chain runs in the same
// k order as on f32 rows, so the result is the f32 kernel's on the widened
// rows. Half the row bytes cross from memory. Rows or chunks that are not 16
// bytes aligned (Db or tile_k not a multiple of 8) are copied one element at
// a time, zero-padded to whole groups of 8.

#include <type_traits>

#include "subtile.cuh"

namespace {

typedef unsigned short bf16_t;    // the raw bits of a bfloat16

constexpr int kBM = 16;           // sub-tile rows (queries)
constexpr int kBN = 32;           // sub-tile columns (candidates)
constexpr int kThreads = 256;     // two halves (kh) of 128 threads
constexpr int kKs = 128;          // contraction columns staged at once
constexpr int kLd = kKs + 4;      // padded shared row (floats)
constexpr int kLdH = kKs + 8;     // padded shared bf16 row (elements)

// the shared row pitch (elements) and the contraction step of a row type
template <typename TX> struct RowT;
template <> struct RowT<float> { static constexpr int ld = kLd, step = 4; };
template <> struct RowT<bf16_t> { static constexpr int ld = kLdH, step = 8; };

// Copy columns [k0, k0 + w) of the sub-tile's q and x rows into shared
// memory and commit them as one cp.async group; on the scalar path the
// columns up to the next multiple of the row type's step are zeroed.
template <typename TX>
__device__ __forceinline__ void stage(float* qs, TX* xs, const float* __restrict__ q,
                      const TX* __restrict__ x, int D, const subtile::Sub& s,
                      int k0, int w, bool vec) {
  constexpr int ld = RowT<TX>::ld, step = RowT<TX>::step;
  if (vec) {
    const int perq = w / 4, perx = w / (16 / (int)sizeof(TX));
    for (int e = threadIdx.x; e < s.rows * perq; e += kThreads) {
      const int r = e / perq, p = 4 * (e % perq);
      subtile::cp_async16(qs + r * kLd + p, q + (size_t)(s.r0 + r) * D + k0 + p);
    }
    constexpr int ex = 16 / (int)sizeof(TX);
    for (int e = threadIdx.x; e < s.cols * perx; e += kThreads) {
      const int r = e / perx, p = ex * (e % perx);
      subtile::cp_async16(xs + r * ld + p, x + (size_t)(s.c0 + r) * D + k0 + p);
    }
  } else {
    const int ws = (w + step - 1) / step * step;
    for (int e = threadIdx.x; e < s.rows * ws; e += kThreads) {
      const int r = e / ws, k = e % ws;
      float* dst = qs + r * kLd + k;
      if (k < w)
        subtile::cp_async4(dst, q + (size_t)(s.r0 + r) * D + k0 + k);
      else
        *dst = 0.0f;
    }
    for (int e = threadIdx.x; e < s.cols * ws; e += kThreads) {
      const int r = e / ws, k = e % ws;
      TX* dst = xs + r * ld + k;
      if constexpr (std::is_same<TX, float>::value) {
        if (k < w)
          subtile::cp_async4(dst, x + (size_t)(s.c0 + r) * D + k0 + k);
        else
          *dst = TX(0);
      } else {                    // a 2-byte element: a plain copy
        *dst = k < w ? x[(size_t)(s.c0 + r) * D + k0 + k] : TX(0);
      }
    }
  }
  subtile::cp_async_commit();
}

__device__ __forceinline__ float bf16_lo(unsigned w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(unsigned w) { return __uint_as_float(w & 0xffff0000u); }

template <typename TX>
__global__ void __launch_bounds__(kThreads)
partial_distance_kernel(const TX* __restrict__ x,        // [N, D]
                        const float* __restrict__ xn2,   // [N]
                        const float* __restrict__ q,     // [M, D]
                        const float* __restrict__ qn2,   // [M]
                        const float* __restrict__ acc,   // [M, N]
                        const float* __restrict__ tau,   // [M]
                        float* __restrict__ out,         // [M, N]
                        int* __restrict__ skip,          // [mt, nt]
                        int M, int N, int D, int tile_m, int tile_n,
                        int tile_k, int l2, int prune) {
  constexpr int ld = RowT<TX>::ld, step = RowT<TX>::step;
  __shared__ __align__(16) float qs[kBM * kLd];
  __shared__ __align__(16) TX xs[kBN * ld];
  __shared__ float4 part[kThreads / 2];           // the kh = 1 half's dots

  const subtile::Sub s = subtile::locate<kBM, kBN>(M, N, tile_m, tile_n);
  if (s.rows <= 0 || s.cols <= 0) return;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16 % 8, kh = tid / 128;
  const bool vec = D % step == 0 && tile_k % step == 0 && subtile::aligned16(x) &&
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
  const TX* xa = xs + tx * ld;
  const TX* xb = xs + (tx + 16) * ld;
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
      const int ws = (w + step - 1) / step * step;
      const int half = (ws / step + 1) / 2 * step;
      if constexpr (std::is_same<TX, float>::value) {
#pragma unroll 4
        for (int k = kh ? half : 0; k < (kh ? ws : half); k += 4) {
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
      } else {
#pragma unroll 2
        for (int k = kh ? half : 0; k < (kh ? ws : half); k += 8) {
          const uint4 u0 = *reinterpret_cast<const uint4*>(xa + k);
          const uint4 u1 = *reinterpret_cast<const uint4*>(xb + k);
          const float y0[8] = {bf16_lo(u0.x), bf16_hi(u0.x), bf16_lo(u0.y), bf16_hi(u0.y),
                               bf16_lo(u0.z), bf16_hi(u0.z), bf16_lo(u0.w), bf16_hi(u0.w)};
          const float y1[8] = {bf16_lo(u1.x), bf16_hi(u1.x), bf16_lo(u1.y), bf16_hi(u1.y),
                               bf16_lo(u1.z), bf16_hi(u1.z), bf16_lo(u1.w), bf16_hi(u1.w)};
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float4 p0 = *reinterpret_cast<const float4*>(qa + k + 4 * h);
            const float4 p1 = *reinterpret_cast<const float4*>(qb + k + 4 * h);
            const float* a = y0 + 4 * h;
            const float* b = y1 + 4 * h;
            d00 = fmaf(p0.x, a[0], d00); d00 = fmaf(p0.y, a[1], d00);
            d00 = fmaf(p0.z, a[2], d00); d00 = fmaf(p0.w, a[3], d00);
            d01 = fmaf(p0.x, b[0], d01); d01 = fmaf(p0.y, b[1], d01);
            d01 = fmaf(p0.z, b[2], d01); d01 = fmaf(p0.w, b[3], d01);
            d10 = fmaf(p1.x, a[0], d10); d10 = fmaf(p1.y, a[1], d10);
            d10 = fmaf(p1.z, a[2], d10); d10 = fmaf(p1.w, a[3], d10);
            d11 = fmaf(p1.x, b[0], d11); d11 = fmaf(p1.y, b[1], d11);
            d11 = fmaf(p1.z, b[2], d11); d11 = fmaf(p1.w, b[3], d11);
          }
        }
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

template <typename TX>
int launch(const void* x, const void* xn2, const void* q, const void* qn2,
           const void* acc, const void* tau, void* out, void* skip,
           int M, int N, int D, int tile_m, int tile_n, int tile_k, int l2, int prune,
           void* stream) {
  const long long ctas = subtile::grid_ctas<kBM, kBN>(M, N, tile_m, tile_n);
  if (ctas <= 0 || ctas > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  partial_distance_kernel<TX><<<(unsigned)ctas, kThreads, 0, (cudaStream_t)stream>>>(
      (const TX*)x, (const float*)xn2, (const float*)q, (const float*)qn2,
      (const float*)acc, (const float*)tau, (float*)out, (int*)skip,
      M, N, D, tile_m, tile_n, tile_k, l2, prune);
  return (int)cudaGetLastError();
}

extern "C" int partial_distance_update_f32(
    const void* x, const void* xn2, const void* q, const void* qn2,
    const void* acc, const void* tau, void* out, void* skip,
    int M, int N, int D, int tile_m, int tile_n, int tile_k, int l2, int prune,
    void* stream) {
  return launch<float>(x, xn2, q, qn2, acc, tau, out, skip, M, N, D, tile_m,
                       tile_n, tile_k, l2, prune, stream);
}

extern "C" int partial_distance_update_bf16(
    const void* x, const void* xn2, const void* q, const void* qn2,
    const void* acc, const void* tau, void* out, void* skip,
    int M, int N, int D, int tile_m, int tile_n, int tile_k, int l2, int prune,
    void* stream) {
  return launch<bf16_t>(x, xn2, q, qn2, acc, tau, out, skip, M, N, D, tile_m,
                        tile_n, tile_k, l2, prune, stream);
}

extern "C" const char* partial_distance_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
