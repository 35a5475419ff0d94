// Running top-K update, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `running_topk_update` of
// src/repro/kernels/topk_update.py (body `_kernel`). Merges candidates
// scores/ids [M, C] (+inf = invalid) into the ascending running top-K
// run_s/run_i [M, K] by K rounds of min extraction. Tie rules are the TPU
// kernel's: the running head wins a tie with the best candidate
// (head_s <= cmin), and among equal candidates the lowest column wins.
// Wherever the output score is +inf the output id is -1.
//
// What bounds it on the H100: one call reads 8*M*C + 8*M*K bytes and writes
// 8*M*K (about 0.13 MB at M = 64, C = 256, K = 10): tens of nanoseconds at
// 3.35 TB/s. The K dependent warp reductions per row (5 shuffle steps each)
// and the launch itself bound it, not bytes.
//
// Design: one warp per query row. The warp stages the row's C scores in
// shared memory once; each round every lane scans its stride-32 columns for
// its lexicographic (score, column) minimum, a 5-step xor-shuffle reduction
// gives the row minimum with the lowest column, lane 0 compares it with the
// running head and writes the output slot, and a taken candidate is knocked
// out in shared memory. The id is read from global memory only for the
// winner. The ids may be broadcast over rows (row stride 0), which is how
// the ring passes one chunk's ids to every query of a group.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;

__global__ void topk_update_kernel(const float* __restrict__ scores,  // [M, C]
                                   const int* __restrict__ ids,       // [M, C] (row stride ids_ld)
                                   long long ids_ld,
                                   const float* __restrict__ run_s,   // [M, K]
                                   const int* __restrict__ run_i,     // [M, K]
                                   float* __restrict__ out_s,         // [M, K]
                                   int* __restrict__ out_i,           // [M, K]
                                   int M, int C, int K) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int row = blockIdx.x * (blockDim.x / kWarp) + warp;
  if (row >= M) return;   // whole warps exit together; no block barrier below
  float* s = smem + (size_t)warp * C;
  const float* srow = scores + (size_t)row * C;
  for (int c = lane; c < C; c += kWarp) s[c] = srow[c];
  __syncwarp();

  const float* hs = run_s + (size_t)row * K;
  const int* hi = run_i + (size_t)row * K;
  int cursor = 0;
  for (int slot = 0; slot < K; ++slot) {
    float v = INFINITY;
    int col = 0x7fffffff;
    for (int c = lane; c < C; c += kWarp) {
      const float sc = s[c];
      if (sc < v) { v = sc; col = c; }   // ascending c: first minimum kept
    }
#pragma unroll
    for (int off = kWarp / 2; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, v, off);
      const int oc = __shfl_xor_sync(0xffffffffu, col, off);
      if (ov < v || (ov == v && oc < col)) { v = ov; col = oc; }
    }
    const float head = cursor < K ? hs[cursor] : INFINITY;
    const bool take_run = head <= v;
    if (lane == 0) {
      float sel_s;
      int sel_i;
      if (take_run) {
        sel_s = head;
        sel_i = cursor < K ? hi[cursor] : -1;
      } else {
        sel_s = v;
        sel_i = ids[(size_t)row * ids_ld + col];
        s[col] = INFINITY;
      }
      out_s[(size_t)row * K + slot] = sel_s;
      out_i[(size_t)row * K + slot] = isfinite(sel_s) ? sel_i : -1;
    }
    if (take_run) ++cursor;
    __syncwarp();
  }
}

}  // namespace

extern "C" int running_topk_update_f32(
    const void* scores, const void* ids, long long ids_ld, const void* run_s,
    const void* run_i, void* out_s, void* out_i, int M, int C, int K,
    int warps_per_block, void* stream) {
  const int threads = warps_per_block * kWarp;
  const int blocks = (M + warps_per_block - 1) / warps_per_block;
  const size_t smem = (size_t)warps_per_block * C * sizeof(float);
  topk_update_kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(
      (const float*)scores, (const int*)ids, ids_ld, (const float*)run_s,
      (const int*)run_i, (float*)out_s, (int*)out_i, M, C, K);
  return (int)cudaGetLastError();
}

extern "C" const char* topk_update_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
