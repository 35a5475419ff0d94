// Partial-distance accumulate + monotone prune, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `partial_distance_update` of
// src/repro/kernels/distance.py (body `_kernel`). One dimension block's step:
//   L2: acc' = (acc + qn2[m] + xn2[n]) - 2 * dot(q[m], x[n])
//   IP: acc' = acc - dot(q[m], x[n])
// +inf entries of acc stay +inf; with `prune`, acc' > tau[m] becomes +inf.
// It also writes an int32 skip map [ceil(M/tile_m), ceil(N/tile_n)]: 1 where
// every acc entry of the tile was +inf on entry, in which case the tile's
// product is skipped (the TPU kernel's `pl.when(any_alive)`).
//
// What bounds it on the H100: at the ring's shapes (M = queries per group
// <= 128, N = chunk = 256, Db = 128/B <= 128) one call moves about
// 4*(M*N*2 + N*Db + M*Db) bytes and does 2*M*N*Db FMA flops, well under a
// microsecond of either bound at 3.35 TB/s or 67 TFLOP/s fp32. With 2 CTAs
// per call the kernel is bound by its launch and its serial latency, not
// by bytes or flops.
//
// Design: one CTA per logical tile_m x tile_n output tile (grid
// (ceil(N/tile_n), ceil(M/tile_m))), so the skip map has the reference's
// granularity. The CTA masks the ragged edges itself; no host padding. It
// first tests the tile for any finite acc entry (__syncthreads_or) and, if
// there is none, writes +inf and its skip bit and returns. Otherwise 256
// threads (16 x 16) each own an 8 x 8 register micro-tile of a 128 x 128
// sub-block and stream the contraction through shared memory 32 columns at
// a time (stride-16 ownership: conflict-free shared reads, 64-byte row
// segments on the store). The dot is a plain fp32 FMA chain: no TF32 and no
// tensor cores, which would move pruning decisions near tau. Epilogue order
// is the TPU kernel's: (acc + qn2 + xn2) - scale * dot, then the prune.
// wgmma/TMA and several tiles per CTA are later work.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;   // 16 x 16
constexpr int kSub = 128;       // sub-block edge a CTA computes at once
constexpr int kMicro = 8;       // outputs per thread along each axis
constexpr int kKc = 32;         // contraction columns staged per step

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
                        int l2, int prune) {
  __shared__ float qs[kKc][kSub + 1];
  __shared__ float xs[kKc][kSub + 1];

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * tile_m, n0 = blockIdx.x * tile_n;
  const int m_end = min(m0 + tile_m, M), n_end = min(n0 + tile_n, N);
  const int tm = m_end - m0, tn = n_end - n0;

  // 1. any alive entry in the tile?
  int alive = 0;
  for (int e = tid; e < tm * tn && !alive; e += kThreads) {
    const int r = e / tn, c = e % tn;
    alive = isfinite(acc[(size_t)(m0 + r) * N + n0 + c]);
  }
  alive = __syncthreads_or(alive);
  if (tid == 0) skip[blockIdx.y * gridDim.x + blockIdx.x] = alive ? 0 : 1;
  if (!alive) {
    for (int e = tid; e < tm * tn; e += kThreads) {
      const int r = e / tn, c = e % tn;
      out[(size_t)(m0 + r) * N + n0 + c] = INFINITY;
    }
    return;
  }

  const float scale = l2 ? 2.0f : 1.0f;
  for (int sm = 0; sm < tm; sm += kSub) {
    for (int sn = 0; sn < tn; sn += kSub) {
      const int rows = min(kSub, tm - sm), cols = min(kSub, tn - sn);
      const float* qb = q + (size_t)(m0 + sm) * D;
      const float* xb = x + (size_t)(n0 + sn) * D;
      float dot[kMicro][kMicro];
#pragma unroll
      for (int i = 0; i < kMicro; ++i)
#pragma unroll
        for (int j = 0; j < kMicro; ++j) dot[i][j] = 0.0f;

      for (int k0 = 0; k0 < D; k0 += kKc) {
        // stage q[rows, k0:k0+kKc] and x[cols, k0:k0+kKc], transposed,
        // zero outside the tile; consecutive threads read consecutive k
        for (int e = tid; e < kSub * kKc; e += kThreads) {
          const int r = e / kKc, k = e % kKc, kk = k0 + k;
          qs[k][r] = (r < rows && kk < D) ? qb[(size_t)r * D + kk] : 0.0f;
          xs[k][r] = (r < cols && kk < D) ? xb[(size_t)r * D + kk] : 0.0f;
        }
        __syncthreads();
#pragma unroll 8
        for (int k = 0; k < kKc; ++k) {
          float a[kMicro], b[kMicro];
#pragma unroll
          for (int i = 0; i < kMicro; ++i) a[i] = qs[k][ty + 16 * i];
#pragma unroll
          for (int j = 0; j < kMicro; ++j) b[j] = xs[k][tx + 16 * j];
#pragma unroll
          for (int i = 0; i < kMicro; ++i)
#pragma unroll
            for (int j = 0; j < kMicro; ++j)
              dot[i][j] = fmaf(a[i], b[j], dot[i][j]);
        }
        __syncthreads();
      }

#pragma unroll
      for (int i = 0; i < kMicro; ++i) {
        const int r = ty + 16 * i;
        if (r >= rows) continue;
        const int m = m0 + sm + r;
        const float qn = l2 ? qn2[m] : 0.0f;
        const float t = tau[m];
#pragma unroll
        for (int j = 0; j < kMicro; ++j) {
          const int c = tx + 16 * j;
          if (c >= cols) continue;
          const int n = n0 + sn + c;
          const float a_in = acc[(size_t)m * N + n];
          float v = INFINITY;
          if (isfinite(a_in)) {
            const float base = l2 ? (a_in + qn) + xn2[n] : a_in;
            v = base - scale * dot[i][j];
            if (prune && v > t) v = INFINITY;
          }
          out[(size_t)m * N + n] = v;
        }
      }
    }
  }
}

}  // namespace

extern "C" int partial_distance_update_f32(
    const void* x, const void* xn2, const void* q, const void* qn2,
    const void* acc, const void* tau, void* out, void* skip,
    int M, int N, int D, int tile_m, int tile_n, int l2, int prune,
    void* stream) {
  const dim3 grid((N + tile_n - 1) / tile_n, (M + tile_m - 1) / tile_m);
  partial_distance_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)xn2, (const float*)q, (const float*)qn2,
      (const float*)acc, (const float*)tau, (float*)out, (int*)skip,
      M, N, D, tile_m, tile_n, l2, prune);
  return (int)cudaGetLastError();
}

extern "C" const char* partial_distance_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
