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
// C = K = k, starting from an all-+inf list. The merge's candidates arrive
// ascending (each part is a top-k list).
//
// What bounds it on the H100: one call reads 4*M*C bytes of scores, 8*M*K
// of running list and at most 4*M*K of ids, and writes 8*M*K: 0.15 MB at
// M = 128, C = 256, K = 40, 0.4 MB at K = 400 and 1.3 MB at M = 8,
// K = 16384 -- 0.05 to 0.6 us at 3.35 TB/s. Neither bytes nor operations
// bound it at these sizes: its time is the launch and the chain of
// dependent loads, votes, barriers and stores of one row, so each route is
// designed to shorten that chain and to spread a row over enough threads.
//
// Three routes, chosen at launch by K (topk_update_route; the wrapper's
// route() says the same and checks it when the library loads).
//
// Route 1, K <= kWarpMaxK: one warp per row and one warp per CTA, so M CTAs.
//  - The running list lives in registers: lane l holds entries l + 32 e for
//    e < E, E = 1 or 2, the least that covers K (a template argument
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
//    of shared memory (512 bytes at K = 64) back into the registers, and thr
//    tightens to the new K-th score. The window's later survivors are then
//    counted again under that thr, so a dense window (an empty list under
//    an all-finite chunk) takes a few groups, not one merge per slice.
//  The merge above costs E votes and shuffles per member for every list
//  entry, so it grows with K: with four entries a lane (K = 65 .. 128) it
//  took 1.4-2.7 times route 2's time on a dense chunk and on the merge's
//  C = K, and 1.6 times on the served int8 k = 20 ring (K = 80). Route 2
//  costs more on a row with no survivor (a CTA and a barrier against one
//  warp), which is most rows of the ring, so the boundary sits at K = 64,
//  where the two cross on the served rings' measured mix of rows (PERF.md
//  section 6 has the timings).
//
// Routes 2 and 3 share these block-wide steps (T threads):
//  - compact_window: a window of W columns, W / T coalesced loads of
//    scores and ids a thread in flight (the id of every column is loaded
//    with its score, so no gather waits on it later), one vote per warp and
//    load, one scan of the per-warp counts by warp 0: the survivors
//    (s < thr) land in shared memory in column order with their ids, with
//    no atomic. A window without one costs a single barrier. One more
//    block-wide vote says whether their scores are already ascending; the
//    merge's always are, and such a window skips the sort.
//  - sort_survivors: each 32-survivor chunk is ranked inside one warp (a
//    shuffle per member, ties to the lower column); each group of 8 chunks
//    becomes one run at once (a survivor adds, per other chunk, a six-step
//    search written without branches, so the seven searches interleave);
//    runs of 256 are then merged pairwise. 2 + log2(n / 256) barriers,
//    against the 36-45 barrier stages of a bitonic network over 256-512.
//    At most 32 survivors take one warp and one barrier.
//  - compact_sort_256 does both for a window of exactly 256 columns (the
//    ring's chunk, one column a thread): each warp ranks its survivors
//    while they are still in registers (a shuffle per survivor when it has
//    at most 8, else 32 unrolled), writes them as a sorted run at its
//    offset, and each survivor then searches the other warps' runs: three
//    barriers in all, and a window without survivors costs one. This
//    halved route 2's time on a dense ring chunk (PERF.md §6).
//  - a merge path: the sorted survivors and the list are merged by
//    diagonals; each thread (route 2) or CTA (route 3) finds where its
//    stretch of output positions starts by a binary search over its
//    diagonal, the list first on equal scores, and writes only positions
//    below K. Every binary search selects instead of branching, so the
//    lanes of a warp, each with its own key, stay together.
//  Why merging window by window, in column order, is right: topK(A + B) =
//  topK(topK(A) + B), and after each merge every entry of the list sits
//  before every later column under the (score, position) key, so the
//  run-first tie rule keeps earlier columns ahead of later ones on equal
//  scores, as the stable sort does; the tightened thr drops only
//  candidates that the sort would place after K. The ids ride with the
//  scores and are never compared.
//
// Route 2, kWarpMaxK < K <= kMaxK: one CTA of 256 threads per row.
//  - The list's first 1024 entries are loaded with the first window (16-byte
//    accesses where K and the pointers allow). A row with no survivor in
//    any window writes them straight back, ids set to -1 at +inf, and never
//    touches shared memory: most (row, launch) pairs of the ring once the
//    list is full.
//  - A 256-column window goes through compact_sort_256, a wider one
//    through compact_window and, unless ascending, sort_survivors.
//  - At the first window with survivors the list is staged into shared
//    memory with its ids, and every such window is merged into a second
//    list there (ceil(K / 256) outputs a thread), which then becomes the
//    list. The last window, when K <= 1024, merges straight into the
//    output. Dynamic shared memory 16 K + 16 W bytes (two lists, two
//    survivor buffers for the sort): 208 KB at K = 12288 with W = 1024,
//    which bounds K; W = 256 .. 2048, as wide as C and that allow.
//
// Route 3, K > kMaxK: the list no longer fits shared memory, and the served
// batch is small (M = 8), so one CTA a row would leave most of the card
// idle. Each row is spread over many CTAs, and the list is read once and
// written once per call, not once per window:
//  - The output positions 0 .. K - 1 of each row are cut into tiles, one
//    CTA each; a tile is the least power of two from 256 to 4096 positions
//    that keeps a launch within one wave of 132 CTAs (128 CTAs at M = 8,
//    K = 16384: 4 outputs a thread). A CTA finds where its tile starts and
//    ends in (list, survivors) by a diagonal search, and places each
//    element of the two slices by a binary search in the other slice.
//  - C <= kFuseC (the ring's chunk): one launch. Each CTA compacts and
//    sorts the row's survivors itself (compact_sort_256 at C <= 256); the
//    work is repeated per tile, but it is 256 columns. It loads the list entries that can land in its
//    tile (the C before it and the tile itself) with the candidates, so
//    both diagonal searches run in shared memory.
//  - C > kFuseC (the merge at C = K): the survivors become one ascending run
//    per row first. One launch compacts windows of kW3 = 8192 columns (512
//    threads, a CTA a window) and sorts those not ascending already, into a
//    scratch the wrapper allocates; ceil(log2(windows)) launches merge the
//    runs pairwise with tiles of 256 (one pass at C = 12289), and the tiled
//    merge into the list follows: 3 launches at C = K = 12289. There the
//    diagonal searches read global memory, so every thread tests one point
//    of both diagonals per round and a vote narrows each range 256-fold
//    (two rounds at K = 16384). Columns are cut into chunks of kChunk3 so
//    the scratch stays bounded; a later chunk merges into the list the
//    earlier one wrote, through a scratch list.

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
constexpr int kWarpMaxK = 2 * kWarp;       // route 1 up to here (the measured crossover)
constexpr int kMaxK = 12288;               // route 2 up to here
constexpr int kT2 = 256;                   // route 2: threads a row
constexpr int kW2Max = 2048;               // route 2: the widest window
constexpr int kSmem2 = 16 * kMaxK + 16 * 1024;  // route 2's dynamic shared memory cap
constexpr int kT3 = 256;                   // route 3: threads of a tile's CTA
constexpr int kTile = 256;                 // route 3: the least output positions a CTA
constexpr int kMaxTile = 4096;             // route 3: the most
constexpr int kCtas3 = 132;                // route 3: CTAs a launch aims at (the SMs)
constexpr int kFuseC = 2048;               // route 3: C that one launch takes
constexpr int kT3W = 512;                  // route 3: threads of a window's CTA
constexpr int kW3 = 8192;                  // route 3: columns of one window
constexpr int kChunk3 = 1 << 18;           // route 3: columns of one chunk

// #{i < n : a[i] < v} (or <= v with kLe) over the ascending a: a binary
// search whose steps select rather than branch, so the lanes of a warp,
// each with its own v, do not diverge
template <bool kLe>
__device__ __forceinline__ int count_below(const float* a, int n, float v) {
  int base = 0;
  while (n > 0) {
    const int half = n >> 1;
    const float x = a[base + half];
    const bool go = kLe ? x <= v : x < v;
    base = go ? base + half + 1 : base;
    n = go ? n - half - 1 : half;
  }
  return base;
}

__device__ __forceinline__ int count_lt(const float* a, int n, float v) {
  return count_below<false>(a, n, v);
}

__device__ __forceinline__ int count_le(const float* a, int n, float v) {
  return count_below<true>(a, n, v);
}

// the same over at most 63 entries (le: <=), in six fixed steps that the
// compiler can interleave across several searches
__device__ __forceinline__ int count_below64(const float* a, int len, float v, bool le) {
  int p = 0;
#pragma unroll
  for (int step = 32; step > 0; step >>= 1) {
    const int at = p + step - 1;
    const float x = at < len ? a[at] : INFINITY;
    p += at < len && (le ? x <= v : x < v) ? step : 0;
  }
  return p;
}

// Compact the survivors (s < thr) of columns base .. base + W - 1 into
// cs/ci in column order, each with its id (irow[column]: the id is loaded
// with the score, so no later gather waits on it); return how many, and set
// *asc when their scores are non-decreasing (then they are sorted by
// (score, column) already). W is a multiple of T, at most EMAX * T. wsum:
// EMAX * T / 32 + 1 ints of shared memory. Every thread of the CTA calls
// it; a window without survivors costs one barrier, one with survivors
// three.
template <int T, int EMAX>
__device__ __forceinline__ int compact_window(const float* __restrict__ srow,
                                              const int* __restrict__ irow, int C,
                                              int base, int W, float thr, float* cs,
                                              int* ci, int* wsum, bool* asc) {
  constexpr int NW = T / kWarp;
  const int tid = threadIdx.x, lane = tid % kWarp, warp = tid / kWarp;
  const int E = W / T;
  float v[EMAX];
  int iv[EMAX];
#pragma unroll
  for (int e = 0; e < EMAX; ++e) {
    const int c = base + e * T + tid;
    const bool in = e < E && c < C;
    v[e] = in ? __ldg(srow + c) : INFINITY;
    iv[e] = in ? __ldg(irow + c) : 0;
  }
  unsigned vote[EMAX];
  bool any = false;
#pragma unroll
  for (int e = 0; e < EMAX; ++e) {
    vote[e] = __ballot_sync(kFull, v[e] < thr);
    if (lane == 0 && e < E) wsum[e * NW + warp] = __popc(vote[e]);
    any |= vote[e] != 0;
  }
  *asc = true;
  if (!__syncthreads_or(any)) return 0;
  if (warp == 0) {              // exclusive scan of the counts, (e, warp) order
    int carry = 0;
    for (int b = 0; b < E * NW; b += kWarp) {
      const int i = b + lane;
      const int x = i < E * NW ? wsum[i] : 0;
      int incl = x;
#pragma unroll
      for (int o = 1; o < kWarp; o <<= 1) {
        const int y = __shfl_up_sync(kFull, incl, o);
        if (lane >= o) incl += y;
      }
      if (i < E * NW) wsum[i] = carry + incl - x;
      carry += __shfl_sync(kFull, incl, kWarp - 1);
    }
    if (lane == 0) wsum[E * NW] = carry;
  }
  __syncthreads();
  const int n = wsum[E * NW];
  const unsigned below = (1u << lane) - 1u;
#pragma unroll
  for (int e = 0; e < EMAX; ++e) {
    if (e < E && (vote[e] >> lane & 1u)) {
      const int at = wsum[e * NW + warp] + __popc(vote[e] & below);
      cs[at] = v[e];
      ci[at] = iv[e];
    }
  }
  __syncthreads();
  bool ok = true;
  for (int i = tid + 1; i < n; i += T) ok &= cs[i - 1] <= cs[i];
  *asc = __syncthreads_and(ok);
  return n;
}

// Sort cs/ci[0 .. n) (column order on entry) by (score, column), with ts/ti
// as the second buffer; true when the result is in ts/ti. Ties go by
// position, which is column order, so the ids ride along uncompared. Ends
// with a barrier.
//  1. Each chunk of 32 is ranked inside one warp (a shuffle per member).
//  2. Each group of up to 8 sorted chunks (256 survivors) becomes one run
//     at once: a survivor's place is its rank in its chunk plus, for each
//     other chunk of the group, a binary search there (an earlier chunk's
//     equal scores come first, a later one's after): one barrier, where
//     pairwise merging would take three.
//  3. Runs of 256 are merged pairwise, a binary search a survivor per round.
template <int T>
__device__ __forceinline__ bool sort_survivors(float* cs, int* ci, float* ts, int* ti, int n) {
  constexpr int NW = T / kWarp, G = 8;
  const int tid = threadIdx.x, lane = tid % kWarp, warp = tid / kWarp;
  for (int q = warp; q * kWarp < n; q += NW) {
    const int i = q * kWarp + lane;
    const float s = i < n ? cs[i] : INFINITY;
    int rank = 0;
#pragma unroll
    for (int j = 0; j < kWarp; ++j) {
      const float sj = __shfl_sync(kFull, s, j);
      rank += sj < s || (sj == s && j < lane);
    }
    if (i < n) { ts[q * kWarp + rank] = s; ti[q * kWarp + rank] = ci[i]; }
  }
  __syncthreads();
  if (n <= kWarp) return true;
  for (int i = tid; i < n; i += T) {
    const int q = i / kWarp, g0 = q / G * G;
    const float s = ts[i];
    int pos = i - q * kWarp;
    // straight-line code (an empty chunk searches nothing), so the
    // compiler interleaves the seven searches
#pragma unroll
    for (int o = 0; o < G; ++o) {
      const int qo = g0 + o, b = qo * kWarp;
      const int len = qo != q && b < n ? min(kWarp, n - b) : 0;
      pos += count_below64(ts + b, len, s, qo < q);
    }
    cs[g0 * kWarp + pos] = s;
    ci[g0 * kWarp + pos] = ti[i];
  }
  __syncthreads();
  float *src_s = cs, *dst_s = ts;
  int *src_i = ci, *dst_i = ti;
  for (int L = G * kWarp; L < n; L <<= 1) {
    for (int i = tid; i < n; i += T) {
      const int run = i / L, a = i - run * L, pair = (run & ~1) * L;
      const float s = src_s[i];
      const int pos = (run & 1) == 0
          ? a + count_lt(src_s + pair + L, max(0, min(L, n - pair - L)), s)
          : a + count_le(src_s + pair, L, s);
      dst_s[pair + pos] = s;
      dst_i[pair + pos] = src_i[i];
    }
    __syncthreads();
    float* fs = src_s; src_s = dst_s; dst_s = fs;
    int* fi = src_i; src_i = dst_i; dst_i = fi;
  }
  return src_s == ts;
}

// A window of exactly T = 256 columns (the ring's chunk), compacted and
// sorted in one pass: each warp ranks its own survivors by shuffles
// while they are still in registers, writes them as a sorted run at
// its offset (the sum of the earlier warps' counts, read after the vote's
// barrier: no scan), and each survivor then adds, per other warp's run, a
// six-step search: three barriers in all, against five for compact_window
// and sort_survivors. cs/ci receive the sorted survivors, ts/ti hold the
// runs; cnt: T / 32 ints. Returns how many survive.
template <int T>
__device__ __forceinline__ int compact_sort_256(const float* __restrict__ srow,
                                                const int* __restrict__ irow, int C, int base,
                                                float thr, float* cs, int* ci, float* ts,
                                                int* ti, int* cnt) {
  static_assert(T == 8 * kWarp, "one group of eight warps' runs");
  constexpr int NW = T / kWarp;
  const int tid = threadIdx.x, lane = tid % kWarp, warp = tid / kWarp;
  const int c = base + tid;
  const float v = c < C ? __ldg(srow + c) : INFINITY;
  const int id = c < C ? __ldg(irow + c) : 0;
  const bool live = v < thr;
  const unsigned vote = __ballot_sync(kFull, live);
  // a few survivors (the vote is the same in every lane): a shuffle each,
  // so a warp without one costs nothing; more: 32 shuffles, unrolled, so
  // they overlap
  int rank = 0;
  if (__popc(vote) <= 8) {
    for (unsigned m = vote; m; m &= m - 1) {
      const int j = __ffs(m) - 1;
      const float vj = __shfl_sync(kFull, v, j);
      rank += vj < v || (vj == v && j < lane);
    }
  } else {
    const float key = live ? v : INFINITY;
#pragma unroll
    for (int j = 0; j < kWarp; ++j) {
      const float kj = __shfl_sync(kFull, key, j);
      rank += kj < key || (kj == key && j < lane);
    }
  }
  if (lane == 0) cnt[warp] = __popc(vote);
  if (!__syncthreads_or(vote != 0)) return 0;
  int off[NW];
  int n = 0;
#pragma unroll
  for (int w = 0; w < NW; ++w) { off[w] = n; n += cnt[w]; }
  if (live) { ts[off[warp] + rank] = v; ti[off[warp] + rank] = id; }
  __syncthreads();
  if (live) {
    int pos = rank;
#pragma unroll
    for (int w = 0; w < NW; ++w)
      pos += count_below64(ts + off[w], w == warp ? 0 : cnt[w], v, w < warp);
    cs[pos] = v;
    ci[pos] = id;
  }
  __syncthreads();
  return n;
}

// The split of diagonal d: how many of the first d outputs of the merge of
// the ascending A [nA] and B [nB] come from A (A first on equal scores).
// One thread, a binary search (selecting, not branching); A and B in
// shared memory.
__device__ __forceinline__ int split(int d, const float* A, int nA, const float* B, int nB) {
  int base = max(0, d - nB), n = min(d, nA) - base;
  while (n > 0) {
    const int half = n >> 1, mid = base + half;
    const bool go = A[mid] <= B[d - 1 - mid];
    base = go ? mid + 1 : base;
    n = go ? n - half - 1 : half;
  }
  return base;
}

// Route 2's merge: os/oi[0 .. K) = the first K of the merge of the list
// (as/ai, K entries) and the sorted survivors (bs/bi, nB), the list first on
// equal scores; to_out: os/oi are the output, and an id is -1 at +inf. Each
// thread writes ceil(K / T) consecutive positions from where one binary
// search over its diagonal puts it.
template <int T>
__device__ __forceinline__ void merge_block(const float* as, const int* ai, const float* bs,
                                            const int* bi, int nB, float* os, int* oi,
                                            int K, bool to_out) {
  const int P = (K + T - 1) / T;
  const int d0 = min(K, (int)threadIdx.x * P), d1 = min(K, d0 + P);
  if (d0 >= d1) return;
  int i = split(d0, as, K, bs, nB), j = d0 - i;
  for (int d = d0; d < d1; ++d) {
    float v;
    int id;
    if (j >= nB || (i < K && as[i] <= bs[j])) {
      v = as[i]; id = ai[i]; ++i;
    } else {
      v = bs[j]; id = bi[j]; ++j;
    }
    os[d] = v;
    oi[d] = to_out && !isfinite(v) ? -1 : id;
  }
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

__global__ void __launch_bounds__(kT2)
topk_update_list_kernel(const float* __restrict__ scores,  // [M, C]
                        const int* __restrict__ ids,       // [M, C] (row stride ids_ld)
                        long long ids_ld,
                        const float* __restrict__ run_s,   // [M, K]
                        const int* __restrict__ run_i,     // [M, K]
                        float* __restrict__ out_s,         // [M, K]
                        int* __restrict__ out_i,           // [M, K]
                        int C, int K, int W) {
  constexpr int T = kT2;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int wsum[(kW2Max / T) * (T / kWarp) + 1];
  float* ls = reinterpret_cast<float*>(smem);        // the list [K]
  int* li = reinterpret_cast<int*>(ls + K);          // its ids [K]
  float* ns = reinterpret_cast<float*>(li + K);      // the next list [K]
  int* ni = reinterpret_cast<int*>(ns + K);
  float* cs = reinterpret_cast<float*>(ni + K);      // survivors [W]
  int* ci = reinterpret_cast<int*>(cs + W);
  float* ts = reinterpret_cast<float*>(ci + W);      // the sort's second buffer [W]
  int* ti = reinterpret_cast<int*>(ts + W);
  const int tid = threadIdx.x;
  const size_t row = blockIdx.x;
  const float* srow = scores + row * C;
  const int* irow = ids + row * ids_ld;
  const float* rs = run_s + row * K;
  const int* ri = run_i + row * K;
  float* os = out_s + row * K;
  int* oi = out_i + row * K;
  // the list's first 4 T entries, loaded with the first window: 16-byte
  // accesses (entries 4 tid .. 4 tid + 3) where K and the pointers allow
  const bool vec = (K & 3) == 0 && aligned16(rs) && aligned16(ri) && aligned16(os) &&
                   aligned16(oi);
  float pre_s[4];
  int pre_i[4];
  if (vec) {
    const float4 s4 = 4 * tid < K ? __ldg(reinterpret_cast<const float4*>(rs) + tid)
                                  : make_float4(0.f, 0.f, 0.f, 0.f);
    const int4 i4 = 4 * tid < K ? __ldg(reinterpret_cast<const int4*>(ri) + tid)
                                : make_int4(0, 0, 0, 0);
    pre_s[0] = s4.x; pre_s[1] = s4.y; pre_s[2] = s4.z; pre_s[3] = s4.w;
    pre_i[0] = i4.x; pre_i[1] = i4.y; pre_i[2] = i4.z; pre_i[3] = i4.w;
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int j = tid + q * T;
      pre_s[q] = j < K ? __ldg(rs + j) : 0.f;
      pre_i[q] = j < K ? __ldg(ri + j) : 0;
    }
  }
  float thr = __ldg(rs + K - 1);
  bool staged = false;

  for (int base = 0; base < C; base += W) {
    bool asc = true;            // the one-pass window leaves cs/ci sorted
    const int n = W == T
        ? compact_sort_256<T>(srow, irow, C, base, thr, cs, ci, ts, ti, wsum)
        : compact_window<T, kW2Max / T>(srow, irow, C, base, W, thr, cs, ci, wsum, &asc);
    if (n == 0) continue;
    if (!staged) {              // the list into shared memory, with its ids
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int j = vec ? 4 * tid + q : tid + q * T;
        if (j < K) { ls[j] = pre_s[q]; li[j] = pre_i[q]; }
      }
      for (int j = 4 * T + tid; j < K; j += T) { ls[j] = __ldg(rs + j); li[j] = __ldg(ri + j); }
      staged = true;
    }
    const float* bs = cs;
    const int* bi = ci;
    if (!asc && sort_survivors<T>(cs, ci, ts, ti, n)) { bs = ts; bi = ti; }
    __syncthreads();            // the staged list (and the sort) are visible
    if (base + W >= C && K <= 4 * T) {  // the last window: straight into the output
      merge_block<T>(ls, li, bs, bi, min(n, K), os, oi, K, true);
      return;
    }
    merge_block<T>(ls, li, bs, bi, min(n, K), ns, ni, K, false);
    __syncthreads();
    float* fs = ls; ls = ns; ns = fs;
    int* fi = li; li = ni; ni = fi;
    thr = ls[K - 1];
  }

  if (!staged) {                // no survivor in the row: the list as it was
#pragma unroll
    for (int q = 0; q < 4; ++q) pre_i[q] = isfinite(pre_s[q]) ? pre_i[q] : -1;
    if (vec) {
      if (4 * tid < K) {
        reinterpret_cast<float4*>(os)[tid] = make_float4(pre_s[0], pre_s[1], pre_s[2], pre_s[3]);
        reinterpret_cast<int4*>(oi)[tid] = make_int4(pre_i[0], pre_i[1], pre_i[2], pre_i[3]);
      }
      for (int j = T + tid; j < K / 4; j += T) {
        const float4 s = __ldg(reinterpret_cast<const float4*>(rs) + j);
        int4 i = __ldg(reinterpret_cast<const int4*>(ri) + j);
        i.x = isfinite(s.x) ? i.x : -1;
        i.y = isfinite(s.y) ? i.y : -1;
        i.z = isfinite(s.z) ? i.z : -1;
        i.w = isfinite(s.w) ? i.w : -1;
        reinterpret_cast<float4*>(os)[j] = s;
        reinterpret_cast<int4*>(oi)[j] = i;
      }
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int j = tid + q * T;
        if (j < K) { os[j] = pre_s[q]; oi[j] = pre_i[q]; }
      }
      for (int j = 4 * T + tid; j < K; j += T) {
        const float s = __ldg(rs + j);
        os[j] = s;
        oi[j] = isfinite(s) ? __ldg(ri + j) : -1;
      }
    }
    return;
  }
  for (int j = tid; j < K; j += T) {
    const float v = ls[j];
    os[j] = v;
    oi[j] = isfinite(v) ? li[j] : -1;
  }
}

// Route 3, C <= kFuseC: CTA b writes output positions (b % tiles) * tile ..
// + tile of row b / tiles. It loads the list's entries that can land there,
// a0 = d0 - C .. d1 (only the first C entries before the tile can be
// displaced into it), with the row's candidates, so the splits of d0 and d1
// are two binary searches in shared memory; the row's survivors are
// compacted and sorted here, the same in every tile of the row.
__global__ void __launch_bounds__(kT3)
topk_update_fused_kernel(const float* __restrict__ scores,  // [M, C]
                         const int* __restrict__ ids,       // row stride ids_ld
                         long long ids_ld,
                         const float* __restrict__ run_s,   // [M, K]
                         const int* __restrict__ run_i,     // [M, K]
                         float* __restrict__ out_s,         // [M, K]
                         int* __restrict__ out_i,           // [M, K]
                         int C, int K, int W, int tile, int tiles) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int wsum[(kFuseC / kT3) * (kT3 / kWarp) + 1];
  float* cs = reinterpret_cast<float*>(smem);           // survivors [W]
  int* ci = reinterpret_cast<int*>(cs + W);
  float* ts = reinterpret_cast<float*>(ci + W);         // the sort's second buffer [W]
  int* ti = reinterpret_cast<int*>(ts + W);
  float* as = reinterpret_cast<float*>(ti + W);         // list entries a0 .. d1 - 1
  int* ai = reinterpret_cast<int*>(as + C + tile);
  const int tid = threadIdx.x;
  const size_t row = blockIdx.x / tiles;
  const int d0 = (blockIdx.x % tiles) * tile;
  const int d1 = min(K, d0 + tile);
  const int a0 = max(0, d0 - C);
  const float* rs = run_s + row * K;
  const int* ri = run_i + row * K;
  for (int x = tid; x < d1 - a0; x += kT3) { as[x] = __ldg(rs + a0 + x); ai[x] = __ldg(ri + a0 + x); }
  bool asc = true;              // the one-pass window leaves cs/ci sorted
  const int n = W == kT3
      ? compact_sort_256<kT3>(scores + row * C, ids + row * ids_ld, C, 0, __ldg(rs + K - 1),
                              cs, ci, ts, ti, wsum)
      : compact_window<kT3, kFuseC / kT3>(scores + row * C, ids + row * ids_ld, C, 0, W,
                                          __ldg(rs + K - 1), cs, ci, wsum, &asc);
  const float* bs = cs;
  const int* bi = ci;
  if (n > 0 && !asc && sort_survivors<kT3>(cs, ci, ts, ti, n)) { bs = ts; bi = ti; }
  const int nb = min(n, K);
  // shifted so that index i of the list is A[i]; the splits read only a0 .. d1 - 1
  const float* A = as - a0;
  const int i0 = split(d0, A, K, bs, nb), i1 = split(d1, A, K, bs, nb);
  const int j0 = d0 - i0, na = i1 - i0, nbt = d1 - i1 - j0;
  float* os = out_s + row * K;
  int* oi = out_i + row * K;
  // an element's place: its index in its own slice plus the other slice's
  // elements before it (the other side's earlier elements all come first)
  for (int x = tid; x < na; x += kT3) {
    const float v = A[i0 + x];
    const int p = d0 + x + count_lt(bs + j0, nbt, v);
    os[p] = v;
    oi[p] = isfinite(v) ? ai[i0 - a0 + x] : -1;
  }
  for (int x = tid; x < nbt; x += kT3) {
    const float v = bs[j0 + x];
    const int p = d0 + x + count_le(A + i0, na, v);
    os[p] = v;
    oi[p] = bi[j0 + x];
  }
}

// The splits of diagonals d0 and d1 (see split) when A and B are in global
// memory: every thread tests one point of each diagonal per round, and the
// count of points where A's entry goes first narrows each range T-fold
// (one round up to T + 1 candidates, two up to ~T^2). The result is the
// same in every thread. red: 2 * T / 32 ints.
template <int T>
__device__ __forceinline__ void coop_split(long long d0, long long d1, const float* A, int nA,
                                           const float* B, int nB, int* red, int* i0,
                                           int* i1) {
  constexpr int NW = T / kWarp;
  const int tid = threadIdx.x, lane = tid % kWarp, warp = tid / kWarp;
  const long long d[2] = {d0, d1};
  long long lo[2], hi[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    lo[h] = d[h] - nB > 0 ? d[h] - nB : 0;
    hi[h] = d[h] < nA ? d[h] : nA;
  }
  for (;;) {
    long long step[2];
    bool busy = false;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long R = hi[h] - lo[h];
      step[h] = (R + T - 1) / T;
      bool first = false;
      if (R > 0) {
        busy = true;
        const long long mid = lo[h] + (tid + 1) * step[h] - 1;
        if (mid < hi[h]) first = A[mid] <= B[d[h] - 1 - mid];
      }
      const unsigned v = __ballot_sync(kFull, first);
      if (lane == 0) red[h * NW + warp] = __popc(v);
    }
    if (!__syncthreads_or(busy)) break;
    int c[2] = {0, 0};
#pragma unroll
    for (int h = 0; h < 2; ++h)
      for (int w = 0; w < NW; ++w) c[h] += red[h * NW + w];
    __syncthreads();            // red is written again next round
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (hi[h] > lo[h]) {
        hi[h] = min(hi[h], lo[h] + (c[h] + 1) * step[h] - 1);
        lo[h] += c[h] * step[h];
      }
    }
  }
  *i0 = (int)lo[0];
  *i1 = (int)lo[1];
}

// Output positions d0 .. d1 - 1 of the merge of A and B (ascending, A first
// on equal scores; ids Ai, Bi), all in global memory, each given to
// emit(position, score, id). s*: d1 - d0 entries of shared memory each; red:
// 2 * T / 32 ints.
template <int T, class Emit>
__device__ __forceinline__ void merge_tile(long long d0, int d1, const float* A,
                                           const int* Ai, int nA, const float* B,
                                           const int* Bi, int nB, float* sa, int* sai,
                                           float* sb, int* sbi, int* red, Emit emit) {
  const int tid = threadIdx.x;
  int i0, i1;
  coop_split<T>(d0, d1, A, nA, B, nB, red, &i0, &i1);
  const int j0 = (int)(d0 - i0), na = i1 - i0, nb = d1 - i1 - j0;
  for (int x = tid; x < na; x += T) { sa[x] = A[i0 + x]; sai[x] = Ai[i0 + x]; }
  for (int x = tid; x < nb; x += T) { sb[x] = B[j0 + x]; sbi[x] = Bi[j0 + x]; }
  __syncthreads();
  for (int x = tid; x < na; x += T) emit((int)d0 + x + count_lt(sb, nb, sa[x]), sa[x], sai[x]);
  for (int x = tid; x < nb; x += T) emit((int)d0 + x + count_le(sa, na, sb[x]), sb[x], sbi[x]);
}

// Route 3, C > kFuseC, first launch: CTA b compacts window b % nwin of row
// b / nwin (kW3 columns) under thr = run_s[K - 1], sorts it unless it is
// ascending already, and writes the run (scores and ids) at its window's
// place in runs_s/runs_i (row stride runs_ld) and its length into lens.
__global__ void __launch_bounds__(kT3W)
topk_update_runs_kernel(const float* __restrict__ scores, long long s_ld,
                        const int* __restrict__ ids, long long ids_ld, int C,
                        const float* __restrict__ run_s, int K, float* __restrict__ runs_s,
                        int* __restrict__ runs_i, int* __restrict__ lens, long long runs_ld,
                        int len_ld, int nwin) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int wsum[(kW3 / kT3W) * (kT3W / kWarp) + 1];
  float* cs = reinterpret_cast<float*>(smem);
  int* ci = reinterpret_cast<int*>(cs + kW3);
  float* ts = reinterpret_cast<float*>(ci + kW3);
  int* ti = reinterpret_cast<int*>(ts + kW3);
  const size_t row = blockIdx.x / nwin;
  const int w = blockIdx.x % nwin, base = w * kW3;
  bool asc;
  const int n = compact_window<kT3W, kW3 / kT3W>(scores + row * s_ld, ids + row * ids_ld, C,
                                                 base, kW3, __ldg(run_s + row * K + K - 1),
                                                 cs, ci, wsum, &asc);
  const float* bs = cs;
  const int* bi = ci;
  if (n > 0 && !asc && sort_survivors<kT3W>(cs, ci, ts, ti, n)) { bs = ts; bi = ti; }
  float* ds = runs_s + row * runs_ld + base;
  int* di = runs_i + row * runs_ld + base;
  for (int i = threadIdx.x; i < n; i += kT3W) { ds[i] = bs[i]; di[i] = bi[i]; }
  if (threadIdx.x == 0) lens[row * len_ld + w] = n;
}

// Route 3, pass p: merges the runs 2r and 2r + 1 (each kW3 << p wide in the
// layout, lengths in len_in) into run r of dst (lengths into len_out), with
// tiles of kTile positions a CTA. The left run holds the lower columns.
__global__ void __launch_bounds__(kT3)
topk_update_pass_kernel(const float* __restrict__ src_s, const int* __restrict__ src_i,
                        float* __restrict__ dst_s, int* __restrict__ dst_i,
                        const int* __restrict__ len_in, int* __restrict__ len_out,
                        long long runs_ld, int len_ld, int nwin, int p, int tiles) {
  __shared__ float sa[kTile], sb[kTile];
  __shared__ int sai[kTile], sbi[kTile];
  __shared__ int red[2 * kT3 / kWarp];
  const size_t row = blockIdx.x / tiles;
  const long long at = (long long)(blockIdx.x % tiles) * kTile;
  const long long wp = (long long)kW3 << p;
  const int r = (int)(at / (2 * wp));
  const long long d0 = at - r * 2 * wp;
  const int n_in = (nwin + (1 << p) - 1) >> p;
  if (2 * r >= n_in) return;
  const int na = len_in[row * len_ld + 2 * r];
  const int nb = 2 * r + 1 < n_in ? len_in[row * len_ld + 2 * r + 1] : 0;
  if (d0 == 0 && threadIdx.x == 0) len_out[row * len_ld + r] = na + nb;
  if (d0 >= na + nb) return;
  const size_t off = row * runs_ld + r * 2 * wp;
  merge_tile<kT3>(d0, (int)min((long long)(na + nb), d0 + kTile), src_s + off, src_i + off, na,
                  src_s + off + wp, src_i + off + wp, nb, sa, sai, sb, sbi, red,
                  [&](int pos, float v, int id) {
                    dst_s[off + pos] = v;
                    dst_i[off + pos] = id;
                  });
}

// Route 3, C > kFuseC, last launch: the tiles (tile output positions a
// CTA) of the merge of the list and the one sorted run of survivors
// (surv_n[row * len_ld] of them, row stride surv_ld) that the passes left.
__global__ void __launch_bounds__(kT3)
topk_update_tile_kernel(const float* __restrict__ run_s,   // [M, K]
                        const int* __restrict__ run_i,     // [M, K]
                        float* __restrict__ out_s,         // [M, K]
                        int* __restrict__ out_i,           // [M, K]
                        int K, int tile, int tiles, const float* __restrict__ surv_s,
                        const int* __restrict__ surv_i, const int* __restrict__ surv_n,
                        long long surv_ld, int len_ld) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* sa = reinterpret_cast<float*>(smem);
  int* sai = reinterpret_cast<int*>(sa + tile);
  float* sb = reinterpret_cast<float*>(sai + tile);
  int* sbi = reinterpret_cast<int*>(sb + tile);
  __shared__ int red[2 * kT3 / kWarp];
  const size_t row = blockIdx.x / tiles;
  const long long d0 = (long long)(blockIdx.x % tiles) * tile;
  float* os = out_s + row * K;
  int* oi = out_i + row * K;
  merge_tile<kT3>(d0, (int)min((long long)K, d0 + tile), run_s + row * K, run_i + row * K, K,
                  surv_s + row * surv_ld, surv_i + row * surv_ld,
                  min(surv_n[row * len_ld], K), sa, sai, sb, sbi, red,
                  [&](int pos, float v, int id) {
                    os[pos] = v;
                    oi[pos] = isfinite(v) ? id : -1;
                  });
}

// ------------------------------------------------------------------ plans

int pow2_window(int C, int lo, int hi) {
  int w = lo;
  while (w < C && w < hi) w <<= 1;
  return w;
}

int route2_window(int C, int K) {
  int w = pow2_window(C, kT2, kW2Max);
  while (w > kT2 && 16LL * K + 16LL * w > kSmem2) w >>= 1;
  return w;
}

// the tile: the least power-of-two multiple of kTile (up to kMaxTile) that
// keeps the launch within kCtas3 CTAs
int route3_tile(long long M, int K) {
  int t = kTile;
  while (t < kMaxTile && M * (((long long)K + t - 1) / t) > kCtas3) t <<= 1;
  return t;
}

int route3_windows(int c) { return (c + kW3 - 1) / kW3; }

int route3_passes(int nwin) {
  int p = 0;
  while ((1 << p) < nwin) ++p;
  return p;
}

long long route3_scratch_bytes(long long M, int C, int K) {
  if (C <= kFuseC) return 0;
  const long long per_row = (long long)route3_windows(C < kChunk3 ? C : kChunk3) * kW3;
  const long long nwin = per_row / kW3;
  long long b = 2 * M * per_row * 8 + 2 * M * nwin * 4;
  if (C > kChunk3) b += 8 * M * (long long)K;
  return b;
}

int launch_route2(const void* scores, const void* ids, long long ids_ld, const void* run_s,
                  const void* run_i, void* out_s, void* out_i, int M, int C, int K,
                  cudaStream_t stream) {
  const int W = route2_window(C, K);
  const size_t bytes = 16 * (size_t)K + 16 * (size_t)W;
  if (bytes > (size_t)kSmem2) return (int)cudaErrorInvalidValue;
  static bool granted = false;
  if (!granted) {
    const cudaError_t e = cudaFuncSetAttribute(
        topk_update_list_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem2);
    if (e != cudaSuccess) return (int)e;
    granted = true;
  }
  topk_update_list_kernel<<<M, kT2, bytes, stream>>>(
      (const float*)scores, (const int*)ids, ids_ld, (const float*)run_s,
      (const int*)run_i, (float*)out_s, (int*)out_i, C, K, W);
  return (int)cudaGetLastError();
}

int launch_route3(const void* scores, const void* ids, long long ids_ld, const void* run_s,
                  const void* run_i, void* out_s, void* out_i, void* scratch,
                  long long scratch_bytes, int M, int C, int K, cudaStream_t stream) {
  const int tile = route3_tile(M, K);
  const long long tiles = ((long long)K + tile - 1) / tile;
  if (tiles * M > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int grid = (int)(tiles * M);
  static bool granted = false;
  if (!granted) {
    cudaError_t e = cudaFuncSetAttribute(
        topk_update_runs_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, 16 * kW3);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(topk_update_fused_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               16 * kFuseC + 8 * (kFuseC + kMaxTile));
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(topk_update_tile_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, 16 * kMaxTile);
    if (e != cudaSuccess) return (int)e;
    granted = true;
  }
  if (C <= kFuseC) {
    const int W = pow2_window(C, kT3, kFuseC);
    topk_update_fused_kernel<<<grid, kT3, 16 * (size_t)W + 8 * (size_t)(C + tile), stream>>>(
        (const float*)scores, (const int*)ids, ids_ld, (const float*)run_s, (const int*)run_i,
        (float*)out_s, (int*)out_i, C, K, W, tile, (int)tiles);
    return (int)cudaGetLastError();
  }
  if (scratch == nullptr || scratch_bytes < route3_scratch_bytes(M, C, K))
    return (int)cudaErrorInvalidValue;
  const int chunk = C < kChunk3 ? C : kChunk3;
  const int nwin_ld = route3_windows(chunk);
  const long long runs_ld = (long long)nwin_ld * kW3;
  const size_t run_elems = (size_t)M * runs_ld;
  float* runs_s[2];
  int* runs_i[2];
  char* p = static_cast<char*>(scratch);
  for (int b = 0; b < 2; ++b) {
    runs_s[b] = reinterpret_cast<float*>(p);
    runs_i[b] = reinterpret_cast<int*>(p + 4 * run_elems);
    p += 8 * run_elems;
  }
  int* lens[2] = {reinterpret_cast<int*>(p), reinterpret_cast<int*>(p) + (size_t)M * nwin_ld};
  p += 8 * (size_t)M * nwin_ld;
  float* tmp_s = reinterpret_cast<float*>(p);
  int* tmp_i = reinterpret_cast<int*>(p + 4 * (size_t)M * K);
  const int chunks = (C + chunk - 1) / chunk;
  const float* in_s = (const float*)run_s;
  const int* in_i = (const int*)run_i;
  for (int q = 0; q < chunks; ++q) {
    const int base = q * chunk, cq = C - base < chunk ? C - base : chunk;
    const int nwin = route3_windows(cq), passes = route3_passes(nwin);
    // the last chunk writes the output; earlier ones alternate below it
    const bool to_out = (chunks - 1 - q) % 2 == 0;
    float* ds = to_out ? (float*)out_s : tmp_s;
    int* di = to_out ? (int*)out_i : tmp_i;
    topk_update_runs_kernel<<<M * nwin, kT3W, 16 * kW3, stream>>>(
        (const float*)scores + base, C, (const int*)ids + base, ids_ld, cq, in_s, K,
        runs_s[0], runs_i[0], lens[0], runs_ld, nwin_ld, nwin);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    const int pass_tiles = (int)(runs_ld / kTile);
    for (int ps = 0; ps < passes; ++ps) {
      topk_update_pass_kernel<<<M * pass_tiles, kT3, 0, stream>>>(
          runs_s[ps % 2], runs_i[ps % 2], runs_s[1 - ps % 2], runs_i[1 - ps % 2],
          lens[ps % 2], lens[1 - ps % 2], runs_ld, nwin_ld, nwin, ps, pass_tiles);
      e = cudaGetLastError();
      if (e != cudaSuccess) return (int)e;
    }
    topk_update_tile_kernel<<<grid, kT3, 16 * (size_t)tile, stream>>>(
        in_s, in_i, ds, di, K, tile, (int)tiles, runs_s[passes % 2], runs_i[passes % 2],
        lens[passes % 2], runs_ld, nwin_ld);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    in_s = ds;
    in_i = di;
  }
  return 0;
}

}  // namespace

// The route a list of K takes: 1 (K <= kWarpMaxK), 2 (K <= kMaxK) or 3; 0
// for K < 1.
extern "C" int topk_update_route(int K) {
  if (K < 1) return 0;
  return K <= kWarpMaxK ? 1 : K <= kMaxK ? 2 : 3;
}

extern "C" int topk_update_max_k() { return kMaxK; }

// The bytes of scratch a call at (M, C, K) needs on route 3 (nonzero for
// C > kFuseC only); routes 1 and 2 need none.
extern "C" long long topk_update_scratch_bytes(int M, int C, int K) {
  return topk_update_route(K) == 3 ? route3_scratch_bytes(M, C, K) : 0;
}

// How a call at (M, C, K) is launched, as the launchers below decide it:
// out = {route, CTAs of the launch that writes the output, window (columns
// compacted together), launches, the largest dynamic shared memory of a
// launch, scratch bytes}. The wrapper's plan() says the same without the
// card; chip_smoke.py holds the two equal.
extern "C" void topk_update_plan(int M, int C, int K, long long* out) {
  const int r = topk_update_route(K);
  out[0] = r;
  out[5] = topk_update_scratch_bytes(M, C, K);
  if (r == 1) {
    out[1] = M; out[2] = kWindow * kWarp; out[3] = 1; out[4] = 0;
    return;
  }
  if (r == 2) {
    const int W = route2_window(C, K);
    out[1] = M; out[2] = W; out[3] = 1; out[4] = 16LL * K + 16LL * W;
    return;
  }
  const int tile = route3_tile(M, K);
  out[1] = (long long)M * (((long long)K + tile - 1) / tile);
  if (C <= kFuseC) {
    const int W = pow2_window(C, kT3, kFuseC);
    out[2] = W; out[3] = 1; out[4] = 16LL * W + 8LL * (C + tile);
    return;
  }
  const int chunk = C < kChunk3 ? C : kChunk3;
  long long launches = 0;
  for (long long base = 0; base < C; base += chunk) {
    const int cq = C - base < chunk ? (int)(C - base) : chunk;
    launches += 2 + route3_passes(route3_windows(cq));
  }
  out[2] = kW3; out[3] = launches; out[4] = 16LL * kW3;
}

// scratch: topk_update_scratch_bytes(M, C, K) bytes (may be null when that
// is 0).
extern "C" int running_topk_update_f32(
    const void* scores, const void* ids, long long ids_ld, const void* run_s,
    const void* run_i, void* out_s, void* out_i, void* scratch, long long scratch_bytes,
    int M, int C, int K, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (C < 1 || K < 1) return (int)cudaErrorInvalidValue;
  switch (topk_update_route(K)) {
    case 1:
      return K <= kWarp
          ? launch<1>(scores, ids, ids_ld, run_s, run_i, out_s, out_i, M, C, K, st)
          : launch<2>(scores, ids, ids_ld, run_s, run_i, out_s, out_i, M, C, K, st);
    case 2:
      return launch_route2(scores, ids, ids_ld, run_s, run_i, out_s, out_i, M, C, K, st);
    default:
      return launch_route3(scores, ids, ids_ld, run_s, run_i, out_s, out_i, scratch,
                           scratch_bytes, M, C, K, st);
  }
}

extern "C" const char* topk_update_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
