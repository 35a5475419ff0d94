// Running top-K update, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `running_topk_update` of
// src/repro/kernels/topk_update.py (body `_kernel`). Merges candidates
// scores/ids [M, C] (+inf = invalid) into the ascending running top-K
// run_s/run_i [M, K], K <= 256, C <= 4096. The result is the first K of the
// stable ascending sort of each row's [run, candidates]: on equal scores a
// running entry wins over a candidate (the TPU kernel's head_s <= cmin), and
// among equal candidates the lowest column wins. Wherever the output score
// is +inf the output id is -1.
//
// Two callers: the ring, once per (shard, group, chunk) with C = 256 and
// K = k or the int8 tier's k * rerank_factor; and merge_topk(fused=True),
// once per part of a served batch (sealed segments, then the delta) with
// C = K = k, starting from an all-+inf list.
//
// What bounds it on the H100: one call reads 4*M*C bytes of scores, 8*M*K
// of running list and at most 4*M*K of ids, and writes 8*M*K (about 0.15 MB
// at M = 128, C = 256, K = 40): tens of nanoseconds at 3.35 TB/s. Neither
// bytes nor operations bound it: its time is the launch, one chain of
// dependent loads, votes and stores per row, and, in the rows where
// candidates may enter the list, the merge: a shuffle and E + 1 votes per
// merged candidate, and a shared-memory round trip per group of 32.
//
// Design: one warp per row and one warp per CTA, so M CTAs per launch.
//  - The running list lives in registers: lane l holds entries l + 32 e for
//    e < E, E = 1, 2, 4 or 8, the least that covers K (a template argument
//    chosen at launch; +inf beyond K), each with a source tag, -1 - j for
//    run entry j or the candidate's column. thr = run_s[K - 1]. A candidate
//    whose score is >= thr never enters: the run wins the tie at thr. With a
//    list that is not full thr is +inf, and every finite candidate may enter.
//  - The row is read in windows of 256 columns, 8 coalesced loads a lane in
//    flight together, kept in registers. One vote per 32-column slice
//    counts the window's survivors (s < thr). A window without one is done:
//    on the serving path most rows of most launches are, so such a row
//    costs its loads, 8 votes and the write of its list. A window past C
//    (C < 256 in the merge) loads nothing for those lanes: they hold +inf.
//  - Otherwise the first 32 survivors in column order are compacted through
//    shared memory into one lane each, and merged as a group: each lane
//    counts, over the group (one shuffle per member), the members before its
//    own (a lower score, or an equal one in a lower column) and, for each of
//    its E list entries, the members strictly below it; E votes per member
//    count the list entries <= that member (the run first on ties). Those
//    give every element its position in the merged order, a permutation of
//    0 .. K + n - 1. The first K are scattered through K floats and K ints
//    of shared memory (2 KB at K = 256) back into the registers, and thr
//    tightens to the new K-th score. The window's later survivors are then
//    counted again under that thr, so a dense window (an empty list under
//    an all-finite chunk) takes a few groups, not one merge per slice.
//  - Each id is read once, at the output write: from run_i, or from the
//    candidate's column of `ids` (row stride C, or 0 when the ring passes one
//    chunk's ids to every row of a group; those reads then hit in cache).
//
// Why merging group by group, in column order, is right: the result is the
// first K by the key (score, position in [run, candidates]). Taking the
// first K is associative, topK(A + B) = topK(topK(A) + B), and after each
// merge every entry of the list sits before every later column under that
// key. So the run-first tie rule of the next merge keeps earlier columns
// ahead of later ones on equal scores, as the stable sort does, and the
// tightened thr drops only candidates that the sort would place after K.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kWindow = 8;                 // 32-column slices read together
constexpr unsigned kFull = 0xffffffffu;

// Merge a group of ng <= 32 candidates, held one a lane in column order
// (score s, column col; +inf beyond ng), into the running list (r, src: E
// entries a lane), and tighten thr. mrg_s/mrg_src: the K-entry scatter space.
template <int E>
__device__ __forceinline__ void merge_group(int ng, float s, int col, int lane,
                                            int K, float (&r)[E], int (&src)[E],
                                            float& thr, float* mrg_s,
                                            int* mrg_src) {
  int rank = 0, in_run = 0;
  int cnt[E];
#pragma unroll
  for (int e = 0; e < E; ++e) cnt[e] = 0;
#pragma unroll 4
  for (int j = 0; j < ng; ++j) {
    const float sj = __shfl_sync(kFull, s, j);
    rank += sj < s || (sj == s && j < lane);
    // list entries <= member j; +inf pads never are, sj being finite
    int le = 0;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const bool lt = sj < r[e];
      cnt[e] += lt;
      le += __popc(__ballot_sync(kFull, !lt));
    }
    if (lane == j) in_run = le;
  }
  const int pos = rank + in_run;
  __syncwarp();                 // the previous merge's reads are done
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int p = lane + e * kWarp + cnt[e];
    if (p < K) { mrg_s[p] = r[e]; mrg_src[p] = src[e]; }
  }
  if (lane < ng && pos < K) { mrg_s[pos] = s; mrg_src[pos] = col; }
  __syncwarp();
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int j = lane + e * kWarp;
    if (j < K) { r[e] = mrg_s[j]; src[e] = mrg_src[j]; }
  }
  thr = mrg_s[K - 1];
}

template <int E>
__global__ void __launch_bounds__(kWarp)
topk_update_kernel(const float* __restrict__ scores,  // [M, C]
                   const int* __restrict__ ids,       // [M, C] (row stride ids_ld)
                   long long ids_ld,
                   const float* __restrict__ run_s,   // [M, K]
                   const int* __restrict__ run_i,     // [M, K]
                   float* __restrict__ out_s,         // [M, K]
                   int* __restrict__ out_i,           // [M, K]
                   int C, int K) {
  __shared__ float grp_s[kWarp];
  __shared__ int grp_c[kWarp];
  __shared__ float mrg_s[E * kWarp];
  __shared__ int mrg_src[E * kWarp];
  const int lane = threadIdx.x;
  const unsigned below = (1u << lane) - 1u;
  const size_t row = blockIdx.x;
  const float* srow = scores + row * C;
  const float* hs = run_s + row * K;

  float r[E];
  int src[E];
  float last = INFINITY;        // this lane's entry in slot (K - 1) / 32
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int j = lane + e * kWarp;
    r[e] = j < K ? hs[j] : INFINITY;
    src[e] = -1 - j;
    if (e == (K - 1) / kWarp) last = r[e];
  }
  float thr = __shfl_sync(kFull, last, (K - 1) % kWarp);

  for (int base = 0; base < C; base += kWindow * kWarp) {
    float v[kWindow];
#pragma unroll
    for (int j = 0; j < kWindow; ++j) {
      const int c = base + j * kWarp + lane;
      v[j] = c < C ? srow[c] : INFINITY;
    }
    int done = base - 1;        // the window's columns <= done are merged
    for (;;) {
      // compact the first 32 survivors after `done`, in column order
      int n = 0;
#pragma unroll
      for (int j = 0; j < kWindow; ++j) {
        const int c = base + j * kWarp + lane;
        const bool live = v[j] < thr && c > done;
        const unsigned vote = __ballot_sync(kFull, live);
        const int at = n + __popc(vote & below);
        if (live && at < kWarp) { grp_s[at] = v[j]; grp_c[at] = c; }
        n += __popc(vote);
      }
      if (n == 0) break;
      __syncwarp();
      const int ng = n < kWarp ? n : kWarp;
      const float s = lane < ng ? grp_s[lane] : INFINITY;
      const int col = lane < ng ? grp_c[lane] : 0;
      done = grp_c[ng - 1];
      merge_group<E>(ng, s, col, lane, K, r, src, thr, mrg_s, mrg_src);
      if (n <= kWarp) break;    // every survivor of the window is merged
    }
  }

  const int* hi = run_i + row * K;
  const int* irow = ids + row * ids_ld;
  float* os = out_s + row * K;
  int* oi = out_i + row * K;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int j = lane + e * kWarp;
    if (j < K) {
      os[j] = r[e];
      oi[j] = !isfinite(r[e]) ? -1 : src[e] < 0 ? hi[-1 - src[e]] : irow[src[e]];
    }
  }
}

template <int E>
int launch(const void* scores, const void* ids, long long ids_ld,
           const void* run_s, const void* run_i, void* out_s, void* out_i,
           int M, int C, int K, cudaStream_t stream) {
  topk_update_kernel<E><<<M, kWarp, 0, stream>>>(
      (const float*)scores, (const int*)ids, ids_ld, (const float*)run_s,
      (const int*)run_i, (float*)out_s, (int*)out_i, C, K);
  return (int)cudaGetLastError();
}

}  // namespace

// Entries a lane holds for K: 1, 2, 4 or 8 (0 when K is outside 1..256).
extern "C" int topk_update_entries_per_lane(int K) {
  if (K < 1 || K > 8 * kWarp) return 0;
  return K <= kWarp ? 1 : K <= 2 * kWarp ? 2 : K <= 4 * kWarp ? 4 : 8;
}

extern "C" int running_topk_update_f32(
    const void* scores, const void* ids, long long ids_ld, const void* run_s,
    const void* run_i, void* out_s, void* out_i, int M, int C, int K,
    void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  switch (topk_update_entries_per_lane(K)) {
    case 1: return launch<1>(scores, ids, ids_ld, run_s, run_i, out_s, out_i, M, C, K, st);
    case 2: return launch<2>(scores, ids, ids_ld, run_s, run_i, out_s, out_i, M, C, K, st);
    case 4: return launch<4>(scores, ids, ids_ld, run_s, run_i, out_s, out_i, M, C, K, st);
    case 8: return launch<8>(scores, ids, ids_ld, run_s, run_i, out_s, out_i, M, C, K, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* topk_update_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
