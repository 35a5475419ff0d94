// Running top-K update, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `running_topk_update` of
// src/repro/kernels/topk_update.py (body `_kernel`). Merges candidates
// scores/ids [M, C] (+inf = invalid) into the ascending running top-K
// run_s/run_i [M, K], any C and any K. The result is the first K of the
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
// candidates may enter the list, the merge.
//
// Three routes, chosen at launch by K.
//
// Route 1, K <= 256: one warp per row and one warp per CTA, so M CTAs.
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
//
// Route 2, 256 < K <= kMaxK (the int8 tier's K' = 4 k above k = 64, a served
// k above 256): one CTA of 256 threads per row; the list no longer fits a
// warp's registers.
//  - The running list, a second list to merge into, and one window of up to
//    2048 columns of survivors live in dynamic shared memory: 16 K + 8 W
//    bytes, 212 KB at K = 12288, W = 2048. That bounds K.
//  - Each window's survivors (s < thr) are compacted with one vote and one
//    shared atomic per warp and load, in any order, then sorted block-wide
//    by (score, column) with a bitonic network padded to the next power of
//    two (columns are distinct, so the order is total).
//  - A merge path by ranks keeps the first K: run entry j lands at
//    j + #(survivors < it) and survivor i at i + #(run entries <= it), each
//    count a binary search; positions >= K are dropped. The run wins ties.
//  - A window folded earlier is part of the run for the later windows. Its
//    columns are lower, so "the run wins" is the stable sort's "the lower
//    column wins". A window without survivors costs its loads and a vote.
//
// Route 3, K > kMaxK (a served k above 12288, or the int8 tier's K' = 4 k
// above k = 3072): one CTA of 1024 threads per row; the list no longer fits
// shared memory.
//  - The running list stays in global memory. Each window of 2048 columns
//    is compacted and sorted in shared memory (16 KB) as in route 2, and
//    merged by ranks from the current list into another [M, K] list in
//    global memory: the output, or one scratch list the wrapper allocates.
//    The two take turns window by window (a window without survivors
//    leaves the list where it is), and the last list is copied into the
//    output if it ended in the scratch. Route 2's tie rule holds across
//    windows for the same reason as there.
//  - The lists carry ids, not sources: an id is read once, when its entry
//    enters a list, and -1 is written at the end wherever the score is +inf.
//  - Bytes bound it: each window with survivors reads and writes the whole
//    list (16 K bytes), where route 2 reads and writes it once.
//
// Routes 1 and 2 read each id once, at the output write: from run_i, or from
// the candidate's column of `ids` (row stride C, or 0 when the ring passes
// one chunk's ids to every row of a group; those reads then hit in cache).
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


// ------------------------------------------------------------ routes 2, 3
constexpr int kBigThreads = 256;
constexpr int kHugeThreads = 1024;
constexpr int kBigWindow = 2048;           // columns of one survivor window
constexpr int kMaxK = 12288;               // route 2: 16 K + 8 W bytes <= 227 KB

__device__ __forceinline__ bool key_gt(float sa, int ca, float sb, int cb) {
  return sa > sb || (sa == sb && ca > cb);
}

// #{i < n : a[i] < v} over the ascending a
__device__ __forceinline__ int count_lt(const float* a, int n, float v) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] < v) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// #{i < n : a[i] <= v} over the ascending a
__device__ __forceinline__ int count_le(const float* a, int n, float v) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] <= v) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// count_le over a list in global memory that this CTA writes (read from L2,
// never through the read-only path)
__device__ __forceinline__ int count_le_global(const float* a, int n, float v) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__ldcg(a + mid) <= v) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// Compact the survivors (s < thr) of columns base .. base + W - 1 into
// cs/cc, in any order, and return how many there are. *n_surv is 0 on entry.
// When n > 0 it is set back to 0 here, and the caller's next barrier (the
// sort's) orders that before the next window's atomics; when n = 0 it is
// left alone, so a thread already at the next window cannot lose a count.
// Every thread of the CTA (T of them) calls it.
template <int T>
__device__ __forceinline__ int compact_window(const float* srow, int C, int base,
                                              int W, float thr, float* cs,
                                              int* cc, int* n_surv) {
  const int tid = threadIdx.x, lane = tid % kWarp;
  for (int c0 = base; c0 < base + W; c0 += T) {
    const int c = c0 + tid;
    const float v = c < C ? srow[c] : INFINITY;
    const bool live = v < thr;
    const unsigned vote = __ballot_sync(kFull, live);
    if (vote) {
      int at = 0;
      if (lane == 0) at = atomicAdd(n_surv, __popc(vote));
      at = __shfl_sync(kFull, at, 0) + __popc(vote & ((1u << lane) - 1u));
      if (live) { cs[at] = v; cc[at] = c; }
    }
  }
  __syncthreads();
  const int n = *n_surv;
  __syncthreads();              // every thread has read n before the reset
  if (tid == 0 && n != 0) *n_surv = 0;
  return n;
}

// Sort cs/cc[0 .. n) by (score, column): a bitonic network over P = 2^p >= n
// (columns are distinct, so the order is total). cs/cc hold at least P.
template <int T>
__device__ __forceinline__ void sort_window(float* cs, int* cc, int n) {
  const int tid = threadIdx.x;
  int P = 1;
  while (P < n) P <<= 1;
  for (int j = n + tid; j < P; j += T) { cs[j] = INFINITY; cc[j] = 0x7fffffff; }
  __syncthreads();
  for (int size = 2; size <= P; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = tid; i < P / 2; i += T) {
        const int lo = 2 * i - (i & (stride - 1)), hi = lo + stride;
        const bool up = (lo & size) == 0;
        const float sa = cs[lo], sb = cs[hi];
        const int ca = cc[lo], cb = cc[hi];
        if (key_gt(sa, ca, sb, cb) == up) {
          cs[lo] = sb; cc[lo] = cb; cs[hi] = sa; cc[hi] = ca;
        }
      }
      __syncthreads();
    }
  }
}

__global__ void __launch_bounds__(kBigThreads)
topk_update_big_kernel(const float* __restrict__ scores,  // [M, C]
                       const int* __restrict__ ids,       // [M, C] (row stride ids_ld)
                       long long ids_ld,
                       const float* __restrict__ run_s,   // [M, K]
                       const int* __restrict__ run_i,     // [M, K]
                       float* __restrict__ out_s,         // [M, K]
                       int* __restrict__ out_i,           // [M, K]
                       int C, int K, int W) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* ls = reinterpret_cast<float*>(smem);        // the list [K]
  int* lc = reinterpret_cast<int*>(ls + K);          // its sources [K]
  float* ns = reinterpret_cast<float*>(lc + K);      // the next list [K]
  int* nc = reinterpret_cast<int*>(ns + K);
  float* cs = reinterpret_cast<float*>(nc + K);      // survivors [W]
  int* cc = reinterpret_cast<int*>(cs + W);
  __shared__ int n_surv;
  const int tid = threadIdx.x;
  const size_t row = blockIdx.x;
  const float* srow = scores + row * C;

  for (int j = tid; j < K; j += kBigThreads) {
    ls[j] = run_s[row * K + j];
    lc[j] = -1 - j;
  }
  if (tid == 0) n_surv = 0;
  __syncthreads();
  float thr = ls[K - 1];

  for (int base = 0; base < C; base += W) {
    // 1. compact the window's survivors (s < thr), in any order
    const int n = compact_window<kBigThreads>(srow, C, base, W, thr, cs, cc, &n_surv);
    if (n == 0) continue;
    // 2. sort them by (score, column)
    sort_window<kBigThreads>(cs, cc, n);
    // 3. merge by ranks into the next list, keeping the first K
    const int m = n < K ? n : K;
    for (int j = tid; j < K; j += kBigThreads) {
      const float r = ls[j];
      const int p = j + count_lt(cs, m, r);
      if (p < K) { ns[p] = r; nc[p] = lc[j]; }
    }
    for (int i = tid; i < m; i += kBigThreads) {
      const float v = cs[i];
      const int p = i + count_le(ls, K, v);
      if (p < K) { ns[p] = v; nc[p] = cc[i]; }
    }
    __syncthreads();
    float* ts = ls; ls = ns; ns = ts;
    int* tc = lc; lc = nc; nc = tc;
    thr = ls[K - 1];
  }

  const int* hi = run_i + row * K;
  const int* irow = ids + row * ids_ld;
  for (int j = tid; j < K; j += kBigThreads) {
    const float v = ls[j];
    const int src = lc[j];
    out_s[row * K + j] = v;
    out_i[row * K + j] = !isfinite(v) ? -1 : src < 0 ? hi[-1 - src] : irow[src];
  }
}

__global__ void __launch_bounds__(kHugeThreads)
topk_update_huge_kernel(const float* __restrict__ scores,  // [M, C]
                        const int* __restrict__ ids,       // [M, C] (row stride ids_ld)
                        long long ids_ld,
                        const float* __restrict__ run_s,   // [M, K]
                        const int* __restrict__ run_i,     // [M, K]
                        float* out_s,                      // [M, K]
                        int* out_i,                        // [M, K]
                        float* tmp_s,                      // [M, K] scratch
                        int* tmp_i,                        // [M, K] scratch
                        int C, int K) {
  __shared__ float cs[kBigWindow];          // survivors of one window
  __shared__ int cc[kBigWindow];
  __shared__ int n_surv;
  const int tid = threadIdx.x;
  const size_t row = blockIdx.x, off = row * (size_t)K;
  const float* srow = scores + row * (size_t)C;
  const int* irow = ids + row * ids_ld;
  float* const os = out_s + off;
  int* const oi = out_i + off;
  // the current list: the input, then the list the last merge wrote
  const float* cur_s = run_s + off;
  const int* cur_i = run_i + off;
  if (tid == 0) n_surv = 0;
  __syncthreads();
  float thr = cur_s[K - 1];

  for (int base = 0; base < C; base += kBigWindow) {
    const int n = compact_window<kHugeThreads>(srow, C, base, kBigWindow, thr,
                                               cs, cc, &n_surv);
    if (n == 0) continue;
    sort_window<kHugeThreads>(cs, cc, n);
    // merge by ranks into the list the current one is not (n <= W < K)
    float* ds = cur_s == os ? tmp_s + off : os;
    int* di = cur_s == os ? tmp_i + off : oi;
    for (int j = tid; j < K; j += kHugeThreads) {
      const float r = __ldcg(cur_s + j);
      const int p = j + count_lt(cs, n, r);
      if (p < K) { ds[p] = r; di[p] = __ldcg(cur_i + j); }
    }
    for (int i = tid; i < n; i += kHugeThreads) {
      const float v = cs[i];
      const int p = i + count_le_global(cur_s, K, v);
      if (p < K) { ds[p] = v; di[p] = irow[cc[i]]; }
    }
    __syncthreads();            // the new list is written and visible to the CTA
    cur_s = ds;
    cur_i = di;
    thr = __ldcg(cur_s + K - 1);
  }

  // the list into the output, id -1 wherever the score is +inf
  for (int j = tid; j < K; j += kHugeThreads) {
    const float v = __ldcg(cur_s + j);
    const int id = __ldcg(cur_i + j);
    if (cur_s != os) os[j] = v;
    oi[j] = isfinite(v) ? id : -1;
  }
}

// The window and the dynamic shared memory route 2 takes at C columns.
int big_window(int C) {
  int w = 1;
  while (w < C && w < kBigWindow) w <<= 1;
  return w < kBigThreads ? kBigThreads : w;
}

size_t big_smem_bytes(int K, int W) { return 16 * (size_t)K + 8 * (size_t)W; }

int launch_big(const void* scores, const void* ids, long long ids_ld,
               const void* run_s, const void* run_i, void* out_s, void* out_i,
               int M, int C, int K, cudaStream_t stream) {
  const int W = big_window(C);
  const size_t bytes = big_smem_bytes(K, W);
  static size_t granted = 0;               // the attribute set so far
  if (bytes > granted) {
    const cudaError_t e = cudaFuncSetAttribute(
        topk_update_big_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)big_smem_bytes(kMaxK, kBigWindow));
    if (e != cudaSuccess) return (int)e;
    granted = big_smem_bytes(kMaxK, kBigWindow);
  }
  topk_update_big_kernel<<<M, kBigThreads, bytes, stream>>>(
      (const float*)scores, (const int*)ids, ids_ld, (const float*)run_s,
      (const int*)run_i, (float*)out_s, (int*)out_i, C, K, W);
  return (int)cudaGetLastError();
}

int launch_huge(const void* scores, const void* ids, long long ids_ld,
                const void* run_s, const void* run_i, void* out_s, void* out_i,
                void* tmp_s, void* tmp_i, int M, int C, int K,
                cudaStream_t stream) {
  if (tmp_s == nullptr || tmp_i == nullptr) return (int)cudaErrorInvalidValue;
  topk_update_huge_kernel<<<M, kHugeThreads, 0, stream>>>(
      (const float*)scores, (const int*)ids, ids_ld, (const float*)run_s,
      (const int*)run_i, (float*)out_s, (int*)out_i, (float*)tmp_s,
      (int*)tmp_i, C, K);
  return (int)cudaGetLastError();
}

}  // namespace

// The route a list of K takes: 1 (K <= 256), 2 (K <= kMaxK) or 3; 0 for K < 1.
extern "C" int topk_update_route(int K) {
  if (K < 1) return 0;
  return K <= 8 * kWarp ? 1 : K <= kMaxK ? 2 : 3;
}

extern "C" int topk_update_max_k() { return kMaxK; }

// tmp_s / tmp_i: an [M, K] scratch list, read only on route 3 (may be null
// on the others).
extern "C" int running_topk_update_f32(
    const void* scores, const void* ids, long long ids_ld, const void* run_s,
    const void* run_i, void* out_s, void* out_i, void* tmp_s, void* tmp_i,
    int M, int C, int K, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (C < 1) return (int)cudaErrorInvalidValue;
  switch (topk_update_route(K)) {
    case 1: {
      const int e = K <= kWarp ? 1 : K <= 2 * kWarp ? 2 : K <= 4 * kWarp ? 4 : 8;
      switch (e) {
        case 1: return launch<1>(scores, ids, ids_ld, run_s, run_i, out_s, out_i, M, C, K, st);
        case 2: return launch<2>(scores, ids, ids_ld, run_s, run_i, out_s, out_i, M, C, K, st);
        case 4: return launch<4>(scores, ids, ids_ld, run_s, run_i, out_s, out_i, M, C, K, st);
        default: return launch<8>(scores, ids, ids_ld, run_s, run_i, out_s, out_i, M, C, K, st);
      }
    }
    case 2: return launch_big(scores, ids, ids_ld, run_s, run_i, out_s, out_i, M, C, K, st);
    case 3:
      return launch_huge(scores, ids, ids_ld, run_s, run_i, out_s, out_i, tmp_s, tmp_i,
                         M, C, K, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* topk_update_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
