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
// [ceil(M/tile_m), ceil(N/tile_n)]: 1 where every acc entry of the tile was
// +inf on entry, in which case the tile's product is skipped (the TPU
// kernel's `pl.when(any_alive)`).
//
// What bounds it on the H100: at the ring's shapes (M = queries per group
// <= 128, N = chunk = 256, Db = 128/B <= 128) one call moves about
// N*Db + M*Db + 4*(N + 2M + 2MN) bytes (313 KB at M = 128, Db = 128: 0.094 us
// at 3.35 TB/s) and does 2*M*N*Db int8 operations (8.4 MOP: 0.004 us at
// 1979 TOP/s). With 2 CTAs per call it is bound by its launch and its serial
// latency, not by bytes or operations.
//
// Design: one CTA per logical tile_m x tile_n output tile (grid
// (ceil(N/tile_n), ceil(M/tile_m))), so the skip map has the reference's
// granularity; the CTA masks the ragged edges itself, no host padding. It
// first tests the tile for any finite acc entry (__syncthreads_or) and, if
// there is none, writes +inf and its skip bit and returns. Otherwise 256
// threads (16 x 16) each own an 8 x 8 register micro-tile of a 128 x 128
// sub-block, keep its running f32 value in registers, and stream each
// tile_k chunk through shared memory 64 codes (16 words) at a time, packed
// four to a 32-bit word and zero-padded (a zero code adds 0 to the dot).
// Each word pair is one __dp4a (4 int8 products into an int32 sum). A
// chunk's int32 dot is exact (|dot| <= 1024 * 127^2 < 2^24) and so is its
// conversion to float; the combine uses the _rn intrinsics so that nvcc
// cannot contract the multiply and the subtract into an FMA, which would
// change the last bit against the TPU kernel's (and the plain version's)
// order. s8 mma.sync/wgmma, TMA and several tiles per CTA are later work.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;   // 16 x 16
constexpr int kSub = 128;       // sub-block edge a CTA computes at once
constexpr int kMicro = 8;       // outputs per thread along each axis
constexpr int kWords = 16;      // 32-bit words (4 codes each) staged per step

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
  __shared__ int qs[kWords][kSub + 1];
  __shared__ int xs[kWords][kSub + 1];

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

  const float two_s2 = __fmul_rn(2.0f, s2[0]);
  for (int sm = 0; sm < tm; sm += kSub) {
    for (int sn = 0; sn < tn; sn += kSub) {
      const int rows = min(kSub, tm - sm), cols = min(kSub, tn - sn);
      const int8_t* qb = q + (size_t)(m0 + sm) * D;
      const int8_t* xb = x + (size_t)(n0 + sn) * D;

      // 2. base = (acc + qn2) + xn2, +inf where acc is +inf
      float val[kMicro][kMicro];
#pragma unroll
      for (int i = 0; i < kMicro; ++i) {
        const int r = ty + 16 * i;
#pragma unroll
        for (int j = 0; j < kMicro; ++j) {
          const int c = tx + 16 * j;
          float v = INFINITY;
          if (r < rows && c < cols) {
            const int m = m0 + sm + r, n = n0 + sn + c;
            const float a_in = acc[(size_t)m * N + n];
            if (isfinite(a_in)) v = __fadd_rn(__fadd_rn(a_in, qn2[m]), xn2[n]);
          }
          val[i][j] = v;
        }
      }

      // 3. one f32 subtract per tile_k chunk of the contraction
      for (int c0 = 0; c0 < D; c0 += tile_k) {
        const int c1 = min(c0 + tile_k, D);
        int dot[kMicro][kMicro];
#pragma unroll
        for (int i = 0; i < kMicro; ++i)
#pragma unroll
          for (int j = 0; j < kMicro; ++j) dot[i][j] = 0;

        for (int k0 = c0; k0 < c1; k0 += 4 * kWords) {
          // stage codes [k0, k0 + 64) of the sub-block's rows, transposed
          // (word-major), zero outside the tile and past the chunk
          for (int e = tid; e < kSub * kWords; e += kThreads) {
            const int r = e / kWords, w = e % kWords, k = k0 + 4 * w;
            qs[w][r] = r < rows ? load_word(qb + (size_t)r * D, k, c1) : 0;
            xs[w][r] = r < cols ? load_word(xb + (size_t)r * D, k, c1) : 0;
          }
          __syncthreads();
#pragma unroll 4
          for (int w = 0; w < kWords; ++w) {
            int a[kMicro], b[kMicro];
#pragma unroll
            for (int i = 0; i < kMicro; ++i) a[i] = qs[w][ty + 16 * i];
#pragma unroll
            for (int j = 0; j < kMicro; ++j) b[j] = xs[w][tx + 16 * j];
#pragma unroll
            for (int i = 0; i < kMicro; ++i)
#pragma unroll
              for (int j = 0; j < kMicro; ++j)
                dot[i][j] = __dp4a(a[i], b[j], dot[i][j]);
          }
          __syncthreads();
        }

#pragma unroll
        for (int i = 0; i < kMicro; ++i)
#pragma unroll
          for (int j = 0; j < kMicro; ++j)
            val[i][j] = __fsub_rn(val[i][j],
                                  __fmul_rn(two_s2, __int2float_rn(dot[i][j])));
      }

      // 4. epilogue: dead stays +inf, then the prune
#pragma unroll
      for (int i = 0; i < kMicro; ++i) {
        const int r = ty + 16 * i;
        if (r >= rows) continue;
        const int m = m0 + sm + r;
        const float t = tau[m];
#pragma unroll
        for (int j = 0; j < kMicro; ++j) {
          const int c = tx + 16 * j;
          if (c >= cols) continue;
          const int n = n0 + sn + c;
          float v = isfinite(acc[(size_t)m * N + n]) ? val[i][j] : INFINITY;
          if (prune && v > t) v = INFINITY;
          out[(size_t)m * N + n] = v;
        }
      }
    }
  }
}

}  // namespace

extern "C" int int8_partial_distance_update(
    const void* x, const void* xn2, const void* q, const void* qn2,
    const void* s2, const void* acc, const void* tau, void* out, void* skip,
    int M, int N, int D, int tile_m, int tile_n, int tile_k, int prune,
    void* stream) {
  const dim3 grid((N + tile_n - 1) / tile_n, (M + tile_m - 1) / tile_m);
  partial_distance_int8_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const int8_t*)x, (const float*)xn2, (const int8_t*)q,
      (const float*)qn2, (const float*)s2, (const float*)acc,
      (const float*)tau, (float*)out, (int*)skip, M, N, D, tile_m, tile_n,
      tile_k, prune);
  return (int)cudaGetLastError();
}

extern "C" const char* partial_distance_int8_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
