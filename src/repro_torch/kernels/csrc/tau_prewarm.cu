// The τ prewarm (PrewarmHeap, Alg. 1 lines 1-5) on the card, hand-written for
// Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package's prewarm (src/repro/core/pruning.py
// `prewarm_tau`) is plain numpy/jnp. It was added because the port's host
// route gathered each batch's [NQ, P*s, D] sample rows on the host and copied
// them to the card (1.97 GB a batch of 8,000 queries at D = 960), which paced
// the served path. Here the sample rows stay on the card in a resident table
// [T, D] (each list's first min(size, s) rows, packed list after list, in the
// rows' type; T = Σ min(size, s)) with offsets `offs` [nlist + 1] (list c's
// rows are table[offs[c] : offs[c + 1]]), and one launch a batch computes,
// for each query:
//   for each probed list c of the query (a probe < 0 or >= nlist skipped, a
//   probe equal to an earlier probe of the same query skipped):
//     for each row t of list c (at most s) with live[t] (no mask: all live):
//       score = Σ_d (table[t, d] - q[d])²              (f32 accumulator)
//   tau[query] = the k-th smallest score, or +inf where fewer than k rows
//                were scored.
//
// What bounds it on the H100: the bytes. From HBM it reads the table once
// (at most nlist·s·D·sizeof(row): 15.7 MB at GIST1M's shapes), the queries (NQ·D·4:
// 30.7 MB at NQ = 8,000), the probes and writes NQ floats: about 47 MB,
// 14 us at 3.35 TB/s. Each query reads its P·s sample rows again (1.97 GB at
// GIST1M's shapes), but the table fits the 50 MB L2, so those reads come
// from L2 and take a few hundred microseconds. The FLOPs (3 a row element)
// are far below either.
//
// Design: one CTA (256 threads) a query. The CTA stages its query row
// (16-byte loads) and its probe row in shared memory and fills a score slot
// [P·s] with +inf. Each warp takes a probed list (warp w: lists w, w + 8, ...)
// and finds a repeated probe itself: its lanes compare the earlier probes of
// the row and vote. For each live sample row the lanes read the row in
// 16-byte pieces (4 f32 or 8 bf16, widened exactly by a shift) against the
// staged query, accumulate (x - q)² in f32, and a warp-shuffle reduce gives
// the score to lane 0, which writes its slot and counts it. The selection is
// a bitonic sort of the slots, padded to a power of two Wp <= 4096 with +inf,
// in shared memory; thread 0 writes the k-th smallest, or +inf where fewer
// than k rows were scored. Nothing of size [NQ, P·s] or [NQ, P·s, D] exists
// outside shared memory. Rows or queries whose width is not a multiple of a
// 16-byte piece are read one element at a time. The kernel allocates
// nothing; the wrapper allocates tau.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

typedef unsigned short bf16_t;    // the raw bits of a bfloat16

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxW = 4096;       // P·s: the score slots a CTA sorts

__device__ __forceinline__ float bf16_lo(unsigned w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(unsigned w) { return __uint_as_float(w & 0xffff0000u); }

__device__ __forceinline__ float sq_diff(float x, float q, float acc) {
  const float d = x - q;
  return fmaf(d, d, acc);
}

// this lane's share of Σ (x - q)² over one row; qs is the staged query
template <typename TX>
__device__ __forceinline__ float row_part(const TX* __restrict__ x, const float* qs,
                                          int D, bool vec, int lane) {
  float acc = 0.0f;
  if constexpr (std::is_same<TX, float>::value) {
    if (vec) {
      const float4* x4 = reinterpret_cast<const float4*>(x);
      const float4* q4 = reinterpret_cast<const float4*>(qs);
#pragma unroll 4
      for (int i = lane; i < D / 4; i += 32) {
        const float4 a = __ldg(x4 + i), b = q4[i];
        acc = sq_diff(a.x, b.x, acc); acc = sq_diff(a.y, b.y, acc);
        acc = sq_diff(a.z, b.z, acc); acc = sq_diff(a.w, b.w, acc);
      }
      return acc;
    }
    for (int i = lane; i < D; i += 32) acc = sq_diff(__ldg(x + i), qs[i], acc);
  } else {
    if (vec) {
      const uint4* x8 = reinterpret_cast<const uint4*>(x);
      const float4* q4 = reinterpret_cast<const float4*>(qs);
#pragma unroll 4
      for (int i = lane; i < D / 8; i += 32) {
        const uint4 u = __ldg(x8 + i);
        const float4 b0 = q4[2 * i], b1 = q4[2 * i + 1];
        acc = sq_diff(bf16_lo(u.x), b0.x, acc); acc = sq_diff(bf16_hi(u.x), b0.y, acc);
        acc = sq_diff(bf16_lo(u.y), b0.z, acc); acc = sq_diff(bf16_hi(u.y), b0.w, acc);
        acc = sq_diff(bf16_lo(u.z), b1.x, acc); acc = sq_diff(bf16_hi(u.z), b1.y, acc);
        acc = sq_diff(bf16_lo(u.w), b1.z, acc); acc = sq_diff(bf16_hi(u.w), b1.w, acc);
      }
      return acc;
    }
    for (int i = lane; i < D; i += 32)
      acc = sq_diff(__uint_as_float((unsigned)__ldg(x + i) << 16), qs[i], acc);
  }
  return acc;
}

template <typename TX>
__global__ void __launch_bounds__(kThreads)
tau_prewarm_kernel(const TX* __restrict__ table,             // [T, D]
                   const int* __restrict__ offs,             // [nlist + 1]
                   const unsigned char* __restrict__ live,   // [T] or null
                   const float* __restrict__ q,              // [NQ, D]
                   const int* __restrict__ probes,           // [NQ, P]
                   float* __restrict__ tau,                  // [NQ]
                   int nlist, int S, int D, int P, int k, int Dq, int Wp) {
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                               // [Dq] the query, zero-padded
  float* sc = qs + Dq;                            // [Wp] score slots
  int* pr = reinterpret_cast<int*>(sc + Wp);      // [P] the probe row
  __shared__ int scored;

  const int row = blockIdx.x, tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const float* qrow = q + (size_t)row * D;
  const bool qvec = D % 4 == 0 && (reinterpret_cast<uintptr_t>(qrow) & 15) == 0;
  if (qvec) {
    for (int i = tid; i < D / 4; i += kThreads)
      reinterpret_cast<float4*>(qs)[i] = __ldg(reinterpret_cast<const float4*>(qrow) + i);
  } else {
    for (int i = tid; i < D; i += kThreads) qs[i] = __ldg(qrow + i);
  }
  for (int i = D + tid; i < Dq; i += kThreads) qs[i] = 0.0f;
  for (int j = tid; j < P; j += kThreads) pr[j] = __ldg(probes + (size_t)row * P + j);
  for (int w = tid; w < Wp; w += kThreads) sc[w] = INFINITY;
  if (tid == 0) scored = 0;
  __syncthreads();

  constexpr int piece = 16 / (int)sizeof(TX);
  const bool vec = D % piece == 0 && (reinterpret_cast<uintptr_t>(table) & 15) == 0;
  for (int j = warp; j < P; j += kWarps) {
    const int c = pr[j];
    bool dup = false;
    for (int e = lane; e < j; e += 32) dup |= pr[e] == c;
    if (c < 0 || c >= nlist || __any_sync(0xffffffffu, dup)) continue;
    const int lo = __ldg(offs + c);
    const int n = min(__ldg(offs + c + 1) - lo, S);
    for (int r = 0; r < n; ++r) {
      if (live != nullptr && !__ldg(live + lo + r)) continue;
      float acc = row_part(table + (size_t)(lo + r) * D, qs, D, vec, lane);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
      if (lane == 0) {
        sc[j * S + r] = acc;
        atomicAdd(&scored, 1);
      }
    }
  }
  __syncthreads();

  // bitonic sort of the Wp slots, ascending
  for (int size = 2; size <= Wp; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = tid; i < Wp; i += kThreads) {
        const int o = i ^ stride;
        if (o > i) {
          const float a = sc[i], b = sc[o];
          if ((a > b) == ((i & size) == 0)) {
            sc[i] = b;
            sc[o] = a;
          }
        }
      }
      __syncthreads();
    }
  }
  if (tid == 0) tau[row] = scored >= k ? sc[k - 1] : INFINITY;
}

int pow2_at_least(int w) {
  int p = 1;
  while (p < w) p <<= 1;
  return p;
}

}  // namespace

extern "C" int tau_prewarm_max_w() { return kMaxW; }

// the dynamic shared memory of a launch, in bytes
extern "C" long long tau_prewarm_smem_bytes(int D, int S, int P) {
  const int Dq = (D + 7) / 8 * 8;
  return 4LL * Dq + 4LL * pow2_at_least(P * S) + 4LL * P;
}

template <typename TX>
int launch(const void* table, const void* offs, const void* live, const void* q,
           const void* probes, void* tau, int NQ, int nlist, int S, int D, int P,
           int k, void* stream) {
  const int W = P * S;
  if (NQ <= 0 || W <= 0 || W > kMaxW || k <= 0 || D <= 0)
    return (int)cudaErrorInvalidValue;
  const int Dq = (D + 7) / 8 * 8, Wp = pow2_at_least(W);
  const long long smem = tau_prewarm_smem_bytes(D, S, P);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        tau_prewarm_kernel<TX>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  tau_prewarm_kernel<TX><<<(unsigned)NQ, kThreads, (size_t)smem, (cudaStream_t)stream>>>(
      (const TX*)table, (const int*)offs, (const unsigned char*)live, (const float*)q,
      (const int*)probes, (float*)tau, nlist, S, D, P, k, Dq, Wp);
  return (int)cudaGetLastError();
}

extern "C" int tau_prewarm_f32(const void* table, const void* offs, const void* live,
                               const void* q, const void* probes, void* tau, int NQ,
                               int nlist, int S, int D, int P, int k, void* stream) {
  return launch<float>(table, offs, live, q, probes, tau, NQ, nlist, S, D, P, k, stream);
}

extern "C" int tau_prewarm_bf16(const void* table, const void* offs, const void* live,
                                const void* q, const void* probes, void* tau, int NQ,
                                int nlist, int S, int D, int P, int k, void* stream) {
  return launch<bf16_t>(table, offs, live, q, probes, tau, NQ, nlist, S, D, P, k, stream);
}

extern "C" const char* tau_prewarm_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
