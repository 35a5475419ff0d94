"""End-to-end search paths.

Filters, on the host (numpy, as in the reference): a metadata predicate
compiles to a per-segment allowed bitmap (:func:`filter_bitmap`, cached
on the index), merges with the tombstones into one excluded mask
(:func:`filter_excluded_rows`), and prunes and widens probe selection
(:func:`filtered_assign_queries`). Every engine then masks excluded rows
as it masks dead ones. :func:`kernel_assign_queries` is the unfiltered
probe selection on the device, with the ring's distance and top-K kernels.

On the index's device, as plain PyTorch (the host rows they read are
uploaded per call):

* :func:`search_oracle`, the exact IVF oracle (single-node Faiss-like
  scan), the ground truth the ring search is held against (``flt=`` the
  filtered one);
* :func:`two_stage_search`, the int8 tier's counterpart (int8 scan,
  then an exact fp32 re-rank), the ground truth of the executor's
  ``precision="int8"``;
* :func:`delta_topk`, the brute-force scan of a data plane's delta
  buffer, on the server's device.

On the host, numpy as in the reference: :func:`harmony_search`, the
paper's Algorithm 1 as a host-scheduled, stage-synchronous engine that
models a cluster (vector-level ring of shard visits, dimension-level
pipeline with pruning and compaction between blocks).

:func:`merge_topk` folds per-segment top-k lists into one: with
``fused=True`` part by part through the running top-K kernel
(:func:`repro_torch.kernels.ops.running_topk_update`), else through the
host :class:`TopKHeap`.
"""

from __future__ import annotations

import time
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.core.index import IVFIndex, ShardedCorpus, assign_queries, dim_block_bounds
from repro_torch.core.pruning import (
    TopKHeap,
    exact_scores,
    partial_scores_block,
    prewarm_tau,
)
from repro_torch.core.types import Filter, PartitionPlan, SearchResult
from repro_torch.kernels import ops, topk_update

FILTER_CACHE_ENTRIES = 64        # allowed bitmaps kept per segment index
ORACLE_ROWS = 1 << 18            # host rows the oracle uploads at a time


# ---------------------------------------------------------------------------
# Filter compilation: predicate → packed-row bitmap → probe pushdown
# ---------------------------------------------------------------------------


def filter_bitmap(index: IVFIndex, flt: Filter) -> np.ndarray:
    """The segment's *allowed* bitmap under ``flt`` (bool [NB], packed-row
    order).

    Cached on the immutable segment index, keyed by the (hashable) filter,
    at most :data:`FILTER_CACHE_ENTRIES` entries (the cache is cleared
    when full). A corpus without metadata allows nothing: an absent
    attribute cannot satisfy a predicate, as :meth:`Filter.evaluate` has
    it for a missing column."""
    cache = index.__dict__.setdefault("_filter_bitmaps", {})
    bm = cache.get(flt)
    if bm is None:
        if len(cache) >= FILTER_CACHE_ENTRIES:
            cache.clear()
        if index.meta is None:
            bm = np.zeros(index.nb, bool)
        else:
            bm = flt.evaluate(index.meta.tags, index.meta.nums, index.nb)
        cache[flt] = bm
    return bm


def filter_excluded_rows(
    index: IVFIndex, flt: Optional[Filter],
    dead_rows: Optional[np.ndarray],
) -> Optional[np.ndarray]:
    """One *excluded* mask (bool [NB]): the filter's disallowed rows and
    the tombstones. A filter is a per-batch tombstone set, so every
    dead-row path (the oracle's mask, the host engine's remap, the
    executor's gather table) applies as it is. None when nothing is
    excluded."""
    if flt is None:
        return dead_rows if dead_rows is not None and dead_rows.any() else None
    excluded = ~filter_bitmap(index, flt)
    if dead_rows is not None:
        excluded = excluded | dead_rows
    return excluded


def filtered_assign_queries(
    index: IVFIndex,
    q: np.ndarray,
    excluded: Optional[np.ndarray],
    nprobe: Optional[int] = None,
) -> np.ndarray:
    """Probe selection with predicate pushdown: clusters whose every row
    is excluded drop out of the centroid ranking.

    Slots past the live clusters repeat the query's best live cluster (a
    duplicate probe is one probe to every consumer; a negative sentinel
    would wrap). Row masking stays the source of truth.

    Selectivity widening: when the allowed share of rows falls below
    ``cfg.filter_widen_threshold``, nprobe grows by ``threshold /
    selectivity``, at most ``filter_widen_cap`` times, at most ``nlist``.
    An explicit ``nprobe`` is the caller's and is never widened."""
    explicit = nprobe is not None
    nprobe = nprobe or index.cfg.nprobe
    if excluded is None or not excluded.any():
        return assign_queries(index, q, nprobe)
    thr = index.cfg.filter_widen_threshold
    sel = float((~excluded).mean())
    if not explicit and thr > 0.0 and 0.0 < sel < thr:
        cap = max(1.0, index.cfg.filter_widen_cap)
        nprobe = min(index.nlist, int(np.ceil(nprobe * min(cap, thr / sel))))
    live_cluster = np.bincount(index.cluster_of[~excluded],
                               minlength=index.nlist) > 0
    qn = np.sum(q * q, axis=1)[:, None]
    cn = np.sum(index.centers * index.centers, axis=1)[None, :]
    d = qn - 2.0 * (q @ index.centers.T) + cn
    d = np.where(live_cluster[None, :], d, np.inf)
    probes = np.argsort(d, axis=1)[:, :nprobe].astype(np.int32)
    picked = np.take_along_axis(d, probes.astype(np.int64), axis=1)
    bad = ~np.isfinite(picked)
    if bad.any():
        probes = np.where(bad, probes[:, :1], probes)
    return probes


def kernel_assign_queries(centers: torch.Tensor, cn2: torch.Tensor,
                          q: torch.Tensor, nprobe: int) -> torch.Tensor:
    """:func:`~repro_torch.core.index.assign_queries` with the port's own
    kernels, on the device of its tensors: one
    :func:`~repro_torch.kernels.ops.partial_distance_update` launch gives
    the [NQ, nlist] f32 L2 distances ``(‖q‖² + ‖c‖²) − 2 q·c`` (FMAs, no
    tensor cores), one :func:`~repro_torch.kernels.ops.running_topk_update`
    launch keeps the ``nprobe`` nearest, ascending. ``centers`` [nlist, D]
    and ``cn2`` [nlist] (their squared norms) stay on the device between
    calls; ``q`` [NQ, D] f32. Returns [NQ, nprobe] int32 centroid ids
    (``1 <= nprobe <= nlist``, which the caller's route choice,
    ``serve.engine.probes_on_card``, ensures); every temporary is freed
    on return.

    Distances are L2 whatever the index's metric, as in
    ``assign_queries``; the order of the f32 sums differs from numpy's,
    so a probe may differ only where two centroid distances lie within
    f32 rounding of each other."""
    nq, nlist = q.shape[0], centers.shape[0]
    topk_update.check_limits(nprobe, nlist)
    dev = q.device
    dist, _ = ops.partial_distance_update(
        centers, cn2, q, (q * q).sum(1),
        torch.zeros((nq, nlist), dtype=torch.float32, device=dev),
        torch.full((nq,), torch.inf, dtype=torch.float32, device=dev),
        prune=False, metric="l2",
    )
    cols = torch.arange(nlist, dtype=torch.int32, device=dev)
    _, probes = ops.running_topk_update(
        dist, cols.expand(nq, nlist),
        torch.full((nq, nprobe), torch.inf, dtype=torch.float32, device=dev),
        torch.full((nq, nprobe), -1, dtype=torch.int32, device=dev),
        k=nprobe,
    )
    return probes


# ---------------------------------------------------------------------------
# Oracle and the int8 tier's two-stage search (on the index's device)
# ---------------------------------------------------------------------------


def search_oracle(
    index: IVFIndex,
    q: np.ndarray,
    k: Optional[int] = None,
    nprobe: Optional[int] = None,
    chunk: int = 128,
    dead_rows: Optional[np.ndarray] = None,
    flt: Optional[Filter] = None,
) -> SearchResult:
    """Exact top-k over probed clusters (masked full scan, ``chunk``
    queries at a time) on the index's device. The host rows are uploaded
    per query chunk in blocks of ``ORACLE_ROWS`` and freed with the call:
    the oracle keeps no copy of the corpus on the card.

    ``dead_rows`` (bool [NB], packed-row tombstones) leaves rows out of
    the candidate set, and ``flt`` the rows its predicate disallows (the
    filtered ground truth; probes are chosen as without a filter). Ties
    go to the lowest packed row (a stable sort).
    """
    cfg = index.cfg
    k = k or cfg.topk
    if flt is not None:
        dead_rows = filter_excluded_rows(index, flt, dead_rows)
    q = np.asarray(q, np.float32)
    probes = assign_queries(index, q, nprobe)
    nq = q.shape[0]
    out_s = np.full((nq, k), np.inf, np.float32)
    out_i = np.full((nq, k), -1, np.int64)
    t0 = time.perf_counter()
    dev = index.device
    cluster_of = torch.as_tensor(index.cluster_of.astype(np.int64), device=dev)
    live = (None if dead_rows is None
            else ~torch.as_tensor(np.asarray(dead_rows, bool), device=dev))
    xn2 = index.xnorm2.to(dev) if cfg.metric == "l2" else None
    qt_all = torch.as_tensor(q).to(dev)
    kk = min(k, index.nb)
    for lo in range(0, nq, chunk):
        hi = min(nq, lo + chunk)
        member = np.zeros((hi - lo, index.nlist), bool)
        member[np.arange(hi - lo)[:, None], probes[lo:hi]] = True
        mask = torch.as_tensor(member, device=dev)[:, cluster_of]   # [m, NB]
        if live is not None:
            mask &= live[None, :]
        qt = qt_all[lo:hi]
        d = torch.empty((hi - lo, index.nb), dtype=torch.float32, device=dev)
        for r0 in range(0, index.nb, ORACLE_ROWS):
            r1 = min(index.nb, r0 + ORACLE_ROWS)
            xb = index.x[r0:r1].to(dev, non_blocking=True)
            if cfg.metric == "l2":
                d[:, r0:r1] = ((qt * qt).sum(1)[:, None] - 2.0 * (qt @ xb.T)
                               + xn2[None, r0:r1])
            else:
                d[:, r0:r1] = -(qt @ xb.T)
            del xb
        d = torch.where(mask, d, torch.inf)
        s, pos = torch.sort(d, dim=1, stable=True)
        s = s[:, :kk].cpu().numpy()
        pos = pos[:, :kk].cpu().numpy()
        out_s[lo:hi, :kk] = s
        out_i[lo:hi, :kk] = index.ids[pos]
        out_i[lo:hi][out_s[lo:hi] == np.inf] = -1
    dt = time.perf_counter() - t0
    return SearchResult(ids=out_i, scores=out_s, stats={"wall_s": dt})


def rerank_exact(index: IVFIndex, qt: torch.Tensor, rows: np.ndarray,
                 valid: torch.Tensor, k: int):
    """Exact fp32 L2 distances of the packed ``rows`` [m, K'] (host int64)
    to the queries ``qt`` [m, D], +inf where not ``valid``, and the ``k``
    best per query in ascending order (a stable sort, so ties keep their
    stage-1 rank). The rows and their norms are gathered on the host and
    only they are uploaded to ``qt``'s device. Returns (scores [m, k],
    positions in K' [m, k])."""
    dev = qt.device
    r = torch.as_tensor(np.asarray(rows, np.int64))
    xg = index.x[r].to(dev, non_blocking=True)               # [m, K', D]
    xn2 = index.xnorm2[r].to(dev, non_blocking=True)
    d = ((qt * qt).sum(1)[:, None]
         - 2.0 * torch.einsum("md,mkd->mk", qt, xg) + xn2)
    d = torch.where(valid, d, torch.inf)
    sc, sel = torch.sort(d, dim=1, stable=True)
    return sc[:, :k], sel[:, :k]


def two_stage_search(
    index: IVFIndex,
    q: np.ndarray,
    k: Optional[int] = None,
    nprobe: Optional[int] = None,
    probes: Optional[np.ndarray] = None,
    rerank_factor: Optional[int] = None,
    dead_rows: Optional[np.ndarray] = None,
    quant_blocks: Optional[int] = None,
    chunk: int = 128,
) -> SearchResult:
    """Two-stage quantized search on the index's device.

    Stage 1 scores the probed, live candidate set with the index's int8
    codes (:meth:`Int8Quant.device_scores`, bit-identical to the
    reference's ``Int8Quant.scores``) and keeps the best
    ``K' = k·rerank_factor`` rows per query; stage 2 gathers those rows'
    fp32 vectors and rescores them exactly, so every returned score is a
    true fp32 distance. Both selections are stable sorts (ties go to the
    lowest packed row, then the best stage-1 rank). Once K' covers the
    whole probed set the result is :func:`search_oracle`'s. L2 only.
    """
    cfg = index.cfg
    if cfg.metric != "l2":
        raise ValueError("int8 two-stage search supports metric='l2' only")
    k = k or cfg.topk
    rerank_factor = rerank_factor or cfg.rerank_factor
    quant = index.int8_quant(quant_blocks or cfg.quant_blocks)
    q = np.asarray(q, np.float32)
    if probes is None:
        probes = assign_queries(index, q, nprobe)
    nq = q.shape[0]
    kp = min(max(k, k * rerank_factor), index.nb)
    nk = min(k, kp)
    out_s = np.full((nq, k), np.inf, np.float32)
    out_i = np.full((nq, k), -1, np.int64)
    t0 = time.perf_counter()
    dev = index.device
    q_codes = quant.encode(q)
    cluster_of = torch.as_tensor(index.cluster_of.astype(np.int64), device=dev)
    live = (None if dead_rows is None
            else ~torch.as_tensor(np.asarray(dead_rows, bool), device=dev))
    qt_all = torch.as_tensor(q).to(dev)
    survivors = 0
    for lo in range(0, nq, chunk):
        hi = min(nq, lo + chunk)
        m = hi - lo
        member = np.zeros((m, index.nlist), bool)
        if probes.shape[1]:
            member[np.arange(m)[:, None], probes[lo:hi]] = True
        mask = torch.as_tensor(member, device=dev)[:, cluster_of]   # [m, NB]
        if live is not None:
            mask &= live[None, :]
        # stage 1: quantized distances over the masked candidate set
        d8 = torch.where(mask, quant.device_scores(q_codes[lo:hi], dev), torch.inf)
        s8, part = torch.sort(d8, dim=1, stable=True)
        part = part[:, :kp]                                     # packed rows
        valid = torch.isfinite(s8[:, :kp])
        survivors += int(valid.sum())
        # stage 2: exact fp32 re-rank of the survivors
        sc, sel = rerank_exact(index, qt_all[lo:hi], part.cpu().numpy(),
                               valid, nk)
        rows = torch.gather(part, 1, sel).cpu().numpy()
        out_s[lo:hi, :nk] = sc.cpu().numpy()
        out_i[lo:hi, :nk] = index.ids[rows]
        out_i[lo:hi][out_s[lo:hi] == np.inf] = -1
    dt = time.perf_counter() - t0
    return SearchResult(
        ids=out_i,
        scores=out_s,
        stats={
            "wall_s": dt,
            "precision": "int8",
            "rerank_k": kp,
            "stage1_survivors": survivors,
        },
    )


# ---------------------------------------------------------------------------
# HARMONY staged engine (host)
# ---------------------------------------------------------------------------


class SearchStats:
    """Structural + timing counters for benchmarks and the roofline model."""

    def __init__(self, d_blocks: int, v_shards: int):
        self.slice_total = np.zeros(d_blocks, np.int64)   # pairs reaching slot j
        self.slice_alive = np.zeros(d_blocks, np.int64)   # pairs computed at slot j
        self.pair_flops = 0                                # pair-level (pruned) flops
        self.row_flops = 0                                 # compacted-matmul flops
        self.dense_flops = 0                               # no-pruning flops
        self.shard_pair_flops = np.zeros(v_shards, np.int64)
        self.comm_bytes = defaultdict(int)
        self.visits = 0
        self.stages = 0
        self.wall_comp_s = 0.0
        self.wall_other_s = 0.0
        # per-(stage, machine) pair-flops — machine (v, b) of the V×B grid
        # owns dimension block b of shard v; the cluster's critical path is
        # max-over-machines per stage (dimension blocks pipeline across
        # machines in steady state, per Fig. 5)
        self.machine_flops = defaultdict(float)   # (stage, v*B+b) → flops
        self.d_blocks = d_blocks
        self.max_pair_buffer = 0         # peak acc elements in any visit

    def parallel_wall_s(self, flops_rate: float = 5e9,
                        net_bw: float = 12.5e9, latency: float = 15e-6) -> float:
        """Critical-path wall time of the modeled cluster: per stage the
        busiest machine's pair-flops / rate, plus the comm model. The
        benchmarks calibrate ``flops_rate`` from a measured single-node
        run so modes are compared on one consistent hardware model."""
        per_stage: Dict[int, float] = defaultdict(float)
        agg: Dict[int, Dict[int, float]] = defaultdict(lambda: defaultdict(float))
        for (stage, machine), fl in self.machine_flops.items():
            agg[stage][machine] += fl
        comp = sum(max(m.values()) for m in agg.values()) / flops_rate if agg else 0.0
        comm = sum(self.comm_bytes.values()) / net_bw + latency * max(self.visits, 1)
        return comp + comm

    def as_dict(self) -> Dict:
        tot = np.maximum(self.slice_total, 1)
        return {
            "slice_pruned_ratio": (1.0 - self.slice_alive / tot).tolist(),
            "pair_flops": int(self.pair_flops),
            "row_flops": int(self.row_flops),
            "dense_flops": int(self.dense_flops),
            "shard_pair_flops": self.shard_pair_flops.tolist(),
            "comm_bytes": dict(self.comm_bytes),
            "visits": self.visits,
            "stages": self.stages,
            "wall_comp_s": self.wall_comp_s,
            "wall_other_s": self.wall_other_s,
            "parallel_wall_s": self.parallel_wall_s(),
            "machine_flops": {f"{k[0]}:{k[1]}": float(v)
                              for k, v in self.machine_flops.items()},
            "max_pair_buffer": int(self.max_pair_buffer),
        }


def _visit_schedule(
    probes: np.ndarray, plan: PartitionPlan
) -> List[List[Tuple[int, np.ndarray]]]:
    """Ring visit order: query i's probed shards, starting from the shard of
    its top-1 probe and walking the ring. Returns per-stage lists of
    (shard, query_indices)."""
    nq = probes.shape[0]
    V = plan.v_shards
    shard_of = plan.cluster_to_shard[probes]               # [NQ, P]
    per_stage: List[Dict[int, List[int]]] = []
    max_stages = 0
    visit_lists: List[np.ndarray] = []
    for i in range(nq):
        shards = shard_of[i]
        start = shards[0]
        uniq = np.unique(shards)
        # ring order from start
        order = np.argsort((uniq - start) % V, kind="stable")
        visit_lists.append(uniq[order])
        max_stages = max(max_stages, len(uniq))
    schedule: List[List[Tuple[int, np.ndarray]]] = []
    for s in range(max_stages):
        by_shard: Dict[int, List[int]] = defaultdict(list)
        for i, visits in enumerate(visit_lists):
            if s < len(visits):
                by_shard[int(visits[s])].append(i)
        schedule.append(
            [(v, np.asarray(qs, np.int64)) for v, qs in sorted(by_shard.items())]
        )
    return schedule


def harmony_search(
    index: IVFIndex,
    corpus: ShardedCorpus,
    q: np.ndarray,
    k: Optional[int] = None,
    nprobe: Optional[int] = None,
    enable_pruning: Optional[bool] = None,
    pipeline: bool = True,
    collect_stats: bool = True,
    dead_rows: Optional[np.ndarray] = None,
    dead_key: Optional[tuple] = None,
    probes: Optional[np.ndarray] = None,
) -> SearchResult:
    """Distributed HARMONY search (host-scheduled reproduction engine).

    The reference's numpy engine that models a cluster, run on the host
    layout of :func:`preassign` (CPU tensors, read as numpy); only the τ
    prewarm scores its sample on the index's device. It launches no
    kernel. The server reaches it only on ``backend="host"``, which the
    caller asks for.

    ``probes`` (int [nq, nprobe']) — precomputed probe table; skips the
    internal :func:`assign_queries` so a caller that already selected
    probes (filter-aware pushdown/widening in the serving engine) scans
    exactly those clusters.

    ``dead_rows`` (bool [NB] over *packed* index rows) applies the mutable
    data plane's tombstones exactly: dead rows are excluded from the τ
    prewarm sample and masked out of every candidate batch before it can
    enter a heap, so a deleted/superseded id can neither appear in results
    nor tighten pruning below the live kth-best.

    ``dead_key`` — the data plane's ``(generation, dead_version)`` at the
    snapshot this search runs against; lets the corpus cache the
    packed→shard tombstone remap across batches (see
    :meth:`ShardedCorpus.dead_shard_mask`)."""
    cfg = index.cfg
    plan = corpus.plan
    k = k or cfg.topk
    metric = cfg.metric
    if enable_pruning is None:
        enable_pruning = cfg.enable_pruning
    nq, D = q.shape
    V, B = plan.v_shards, plan.d_blocks
    bounds = dim_block_bounds(D, B)
    stats = SearchStats(B, V)

    t_host0 = time.perf_counter()
    if probes is None:
        probes = assign_queries(index, q, nprobe)
    tau0 = (
        prewarm_tau(index, q, probes, k, cfg.prewarm_samples, metric,
                    dead_rows=dead_rows)
        if enable_pruning
        else np.full((nq,), np.inf, np.float32)
    )
    heap = TopKHeap.empty(nq, k)
    schedule = (
        _visit_schedule(probes, plan)
        if pipeline
        else [_all_visits(probes, plan)]
    )
    # remap packed-row tombstones onto the shard layout via the corpus's
    # precomputed permutation (cached across batches when dead_key is the
    # snapshot's (generation, dead_version))
    dead_sh = None
    if dead_rows is not None and dead_rows.any():
        dead_sh = corpus.dead_shard_mask(dead_rows, key=dead_key)
    stats.wall_other_s += time.perf_counter() - t_host0

    for stage in schedule:
        stats.stages += 1
        pending: List[Tuple[np.ndarray, TopKHeap]] = []
        tau_stage = np.minimum(tau0, heap.tau) if enable_pruning else tau0
        for v, qidx in stage:
            local = _process_visit(
                corpus=corpus,
                probes=probes,
                q=q,
                qidx=qidx,
                v=v,
                plan=plan,
                bounds=bounds,
                tau_in=tau_stage[qidx],
                k=k,
                metric=metric,
                enable_pruning=enable_pruning,
                stats=stats,
                stage_idx=stats.stages - 1,
                dead_sh=dead_sh,
            )
            if local is not None:
                pending.append((qidx, local))
                stats.comm_bytes["result_return"] += len(qidx) * k * 12
        # stage barrier: merges become visible to the next stage
        t0 = time.perf_counter()
        for qidx, local in pending:
            heap.merge_rows(qidx, local.scores, local.ids)
        stats.wall_other_s += time.perf_counter() - t0

    # never report an id whose score is +inf (pruned-to-nothing or dead
    # slots) — matches the oracle's -1 convention
    heap.ids[~np.isfinite(heap.scores)] = -1
    res = SearchResult(ids=heap.ids, scores=heap.scores, stats=stats.as_dict())
    return res


def _process_visit(
    corpus: ShardedCorpus,
    probes: np.ndarray,
    q: np.ndarray,
    qidx: np.ndarray,
    v: int,
    plan: PartitionPlan,
    bounds: Sequence[Tuple[int, int]],
    tau_in: np.ndarray,
    k: int,
    metric: str,
    enable_pruning: bool,
    stats: "SearchStats",
    stage_idx: int,
    dead_sh: Optional[np.ndarray] = None,
) -> Optional[TopKHeap]:
    """One (shard, query-group) visit.

    Vector-level pipeline (Alg. 1 VectorPipeline): probed clusters on this
    shard are scanned sequentially in probe-rank order; after each cluster
    batch the *local* heap refines τ, so later batches prune harder.
    Dimension-level pipeline (Alg. 1 DimensionPipeline): within a batch,
    dimension blocks are processed in the shard's rotated ring order with
    monotone partial-sum pruning and dead-row compaction between slices.
    """
    V, B = plan.v_shards, plan.d_blocks
    D = q.shape[1]
    x_shard = corpus.x_shard.numpy()        # host layout: views, no copy
    xnorm2_blk = corpus.xnorm2_blk.numpy()
    t0 = time.perf_counter()
    cl = probes[qidx]                                      # [m, P]
    on_shard = plan.cluster_to_shard[cl] == v              # [m, P]
    if not on_shard.any():
        stats.wall_other_s += time.perf_counter() - t0
        return None
    # probe-rank-ordered cluster scan: rank r = best rank among group queries
    best_rank: Dict[int, int] = {}
    m, P = cl.shape
    for r in range(P):
        for c in cl[:, r][on_shard[:, r]]:
            best_rank.setdefault(int(c), r)
    ordered = sorted(best_rank, key=lambda c: (best_rank[c], c))
    stats.visits += 1
    local = TopKHeap.empty(len(qidx), k)
    tau_local = tau_in.astype(np.float32).copy()
    qg = q[qidx]
    stats.comm_bytes["query_dispatch"] += qg.size * 4
    stats.wall_other_s += time.perf_counter() - t0

    # staggered ring: base rotation by shard and stage; on top of it, the
    # queries of a visit are split into B sub-groups whose ring starts are
    # rotated per group (Fig. 5(b): Q1 starts D1, Q2 starts D2, ...) — this
    # is what spreads the unprunable first-slot work across all machines.
    offset = (int(plan.ring_offsets[v % V]) + stage_idx) % B

    for c in ordered:
        cv, lo_r, hi_r = corpus.cluster_slices[c]
        nrows = hi_r - lo_r
        if nrows == 0:
            continue
        sub_all = np.nonzero((cl == c).any(axis=1) & on_shard.any(axis=1))[0]
        if sub_all.size == 0:
            continue
        for g in range(min(B, len(sub_all))):
            sub = sub_all[g::B]
            if sub.size == 0:
                continue
            order = np.roll(np.arange(B), -((offset + g) % B))
            t0 = time.perf_counter()
            ms = len(sub)
            acc = np.zeros((ms, nrows), np.float32)
            if dead_sh is not None:
                # tombstoned rows enter the visit already pruned: they are
                # compacted away with the other dead pairs and can never
                # reach a heap (exactly the sealed-segment delete mask)
                acc[:, dead_sh[v, lo_r:hi_r]] = np.inf
            live_rows = np.arange(lo_r, hi_r)
            tau_g = tau_local[sub]
            stats.slice_total += ms * nrows   # every pair reaches every slot
            for pos, b in enumerate(order):
                blo, bhi = bounds[b]
                alive_pair = np.isfinite(acc)
                n_alive = int(alive_pair.sum())
                stats.slice_alive[pos] += n_alive
                keep = alive_pair.any(axis=0)
                if not keep.all():
                    acc = acc[:, keep]
                    live_rows = live_rows[keep]
                    alive_pair = alive_pair[:, keep]
                if acc.shape[1] == 0:
                    break
                xr = x_shard[v, live_rows, blo:bhi]
                xn = xnorm2_blk[v, b, live_rows]
                part = partial_scores_block(xr, qg[sub][:, blo:bhi], xn, metric)
                acc = np.where(alive_pair, acc + part, np.inf)
                nflop = 2 * n_alive * (bhi - blo)
                stats.pair_flops += nflop
                stats.row_flops += 2 * acc.shape[1] * ms * (bhi - blo)
                stats.shard_pair_flops[v] += nflop
                stats.machine_flops[(stage_idx, v * B + int(b))] += nflop
                if enable_pruning and pos < B - 1:
                    acc = np.where(acc > tau_g[:, None], np.inf, acc)
                    stats.comm_bytes["partial_results"] += int(np.isfinite(acc).sum()) * 4
                stats.comm_bytes["threshold_sync"] += ms * 4
            stats.dense_flops += 2 * nrows * ms * D
            stats.wall_comp_s += time.perf_counter() - t0
            stats.max_pair_buffer = max(stats.max_pair_buffer, ms * nrows)

            t0 = time.perf_counter()
            if acc.shape[1]:
                ids = corpus.ids_shard[v, live_rows]
                local.merge_rows(sub, acc, np.broadcast_to(ids, acc.shape))
                if enable_pruning:
                    tau_local[sub] = np.minimum(tau_local[sub], local.tau[sub])
            stats.wall_other_s += time.perf_counter() - t0
    return local


def _all_visits(probes: np.ndarray, plan: PartitionPlan):
    """Non-pipelined dispatch: every (shard, probing queries) visit in one
    stage — the 'synchronous execution' ablation (Fig. 9)."""
    shard_of = plan.cluster_to_shard[probes]
    out = []
    for v in range(plan.v_shards):
        qs = np.nonzero((shard_of == v).any(axis=1))[0]
        if qs.size:
            out.append((v, qs.astype(np.int64)))
    return out


# ---------------------------------------------------------------------------
# Mutable data plane: delta scan + cross-segment merge
# ---------------------------------------------------------------------------


def delta_topk(
    delta_x: np.ndarray,
    delta_ids: np.ndarray,
    delta_live: np.ndarray,
    q: np.ndarray,
    k: int,
    metric: str = "l2",
    device: DeviceLike = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Exact brute-force top-k over the live rows of a delta buffer, scored
    on ``device`` (CUDA by default).

    The delta is small by construction (compaction seals it before it
    grows), so a dense scan is the right tool. Ties go to the lowest
    delta row (a stable sort). Returns (scores [NQ, k] ascending
    +inf-padded, ids [NQ, k] int64 -1-padded), on the host.
    """
    dev = resolve_device(device)
    nq = q.shape[0]
    out_s = np.full((nq, k), np.inf, np.float32)
    out_i = np.full((nq, k), -1, np.int64)
    live = np.nonzero(delta_live)[0]
    if live.size == 0:
        return out_s, out_i
    x = torch.as_tensor(np.ascontiguousarray(delta_x[live], np.float32)).to(dev)
    qt = torch.as_tensor(np.ascontiguousarray(q, np.float32)).to(dev)
    s, pos = torch.sort(exact_scores(x, qt, metric), dim=1, stable=True)
    kk = min(k, live.size)
    out_s[:, :kk] = s[:, :kk].cpu().numpy()
    out_i[:, :kk] = delta_ids[live][pos[:, :kk].cpu().numpy()]
    out_i[~np.isfinite(out_s)] = -1
    return out_s, out_i


def merge_topk(
    parts: Sequence[Tuple[np.ndarray, np.ndarray]],
    k: int,
    fused: bool = False,
    device: DeviceLike = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Merge per-segment (scores, ids) top-k lists into one global top-k.

    ``fused=True`` folds each part, in part order, into a running top-K
    that starts at +inf / -1, with one
    :func:`repro_torch.kernels.ops.running_topk_update` call per part on
    ``device`` (CUDA by default: the running top-K kernel, K = k, C = the
    part's width); a K or C beyond the kernel's limit raises
    ``ValueError`` before any launch. The default is the host
    ``TopKHeap`` merge. Both return (scores [NQ, k] ascending, ids
    [NQ, k] int64, -1 where +inf). On equal scores the fused merge keeps
    the earlier part, then the lower column.

    The kernel carries each candidate's column in the concatenated parts
    (int32), and the host gathers the int64 ids after the last fold, so
    ids of any size take the fused path; the kernel never compares ids,
    so the result is the one it gives on the ids themselves.
    """
    if not parts:
        raise ValueError("merge_topk needs at least one part")
    nq = parts[0][0].shape[0]
    if fused:
        for sc, _ in parts:
            topk_update.check_limits(k, sc.shape[1])
        dev = resolve_device(device)
        run_s = torch.full((nq, k), torch.inf, dtype=torch.float32, device=dev)
        run_i = torch.full((nq, k), -1, dtype=torch.int32, device=dev)
        off = 0
        for sc, _ in parts:
            w = sc.shape[1]
            cols = torch.arange(off, off + w, dtype=torch.int32, device=dev)
            run_s, run_i = ops.running_topk_update(
                torch.as_tensor(np.ascontiguousarray(sc, np.float32)).to(dev),
                cols.expand(nq, w), run_s, run_i, k=k,
            )
            off += w
        scores = run_s.cpu().numpy()
        cols = run_i.cpu().numpy().astype(np.int64)
        cat_ids = np.concatenate([np.asarray(ids, np.int64) for _, ids in parts], 1)
        out_i = np.take_along_axis(cat_ids, np.maximum(cols, 0), axis=1)
        out_i[cols < 0] = -1
    else:
        heap = TopKHeap.empty(nq, k)
        rows = np.arange(nq)
        for sc, ids in parts:
            heap.merge_rows(rows, sc, ids)
        scores, out_i = heap.scores, heap.ids
    out_i = out_i.copy()
    out_i[~np.isfinite(scores)] = -1
    return scores, out_i
