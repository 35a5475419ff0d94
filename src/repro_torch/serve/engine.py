"""Batched ANNS serving engine: ``HarmonyServer`` over the mutable
segmented data plane.

The server serves a :class:`repro_torch.core.SegmentedIndex` (sealed
segments + delta buffer + tombstones; a plain ``IVFIndex`` is wrapped as
the one-sealed-segment special case). Per segment it derives a
cost-model plan and, lazily, a device-resident
:class:`~repro_torch.serve.executor.SpmdExecutor` per precision served
(the default ``backend="spmd"``) or the host engine's ``ShardedCorpus``
(``backend="host"``, asked for by the caller).
A batch searches every sealed segment (tombstone-masked) plus a
brute-force delta scan on the server's device, and merges the
per-segment top-Ks; on the spmd backend that merge runs on the running
top-K kernel (``merge_topk(fused=True)``). Derived state is keyed by
segment id and adopted per data-plane generation: a compaction commit
bumps the generation and the server swaps to the new segment set on its
next batch (or eagerly through :meth:`HarmonyServer.adopt` after
:meth:`HarmonyServer.prepare_segments`).

Load-aware re-planning (a sliding window of recent probes) and elastic
node failure / join re-plan every segment; results do not change.

Not ported yet: filtered and hybrid search (``flt=``, ``hybrid_text=``,
which raise ``NotImplementedError``), the scheduled ``serve()`` loop,
and the host tier's ``prefetch_batch`` / ``prepare_placement``.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Optional

import numpy as np

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.config import HarmonyConfig
from repro_torch.core.index import DataSnapshot, Segment, SegmentedIndex, assign_queries, preassign
from repro_torch.core.planner import plan_search
from repro_torch.core.search import delta_topk, harmony_search, merge_topk, two_stage_search
from repro_torch.core.types import DataPlane, Filter, SearchRequest, SearchResult
from repro_torch.runtime.elastic import ClusterState
from repro_torch.serve.executor import ExecutorConfig, SpmdExecutor

NOT_PORTED_FILTERS = (
    "filtered and hybrid search (flt=, hybrid_text=, a request's filter) "
    "are not ported yet: they come with ROADMAP.md Queue 1 item 9"
)


@dataclass
class ServeStats:
    """Serving counters and timing samples.

    Unit convention (suffixes are authoritative): ``*_s`` fields are
    **seconds**, ``*_ms`` fields are **milliseconds**; unsuffixed fields
    are counts. Execution-side timings (``wall_s``, ``latencies_ms``)
    are *measured* process wall time of ``search_batch``; the
    admission-side timings (``queue_wait_ms``, ``request_latency_ms``)
    are on whichever clock drives serving — the virtual trace clock
    under ``ServingScheduler`` replays, the wall clock under the live
    ``ServingFrontend``."""

    batches: int = 0                 # search_batch calls
    queries: int = 0                 # rows across those batches
    wall_s: float = 0.0              # summed measured batch wall (seconds)
    replans: int = 0
    latencies_ms: List[float] = field(default_factory=list)  # per batch (ms)

    spmd_batches: int = 0            # batches served by the device executor

    # --- mutable-data-plane accounting
    upserts: int = 0                 # vector rows upserted
    deletes: int = 0                 # delete calls' id rows
    generation_swaps: int = 0        # data-plane generations adopted

    # --- admission-controlled scheduler accounting (the scheduler)
    offered: int = 0                 # requests submitted to admission control
    admitted: int = 0                # requests accepted into the queue
    shed: int = 0                    # requests rejected by backpressure
    full_batches: int = 0            # batches fired by the size trigger
    deadline_batches: int = 0        # batches fired by the max-wait deadline
    capacity_batches: int = 0        # fired early because the queue hit its bound
    skew_replans: int = 0            # re-plans triggered by hot-mass drift
    hedged_batches: int = 0          # batch dispatches whose hedge fired
    queue_wait_ms: List[float] = field(default_factory=list)     # per request
    request_latency_ms: List[float] = field(default_factory=list)  # arrival→done

    # --- resilience accounting (fleet circuit breaker + dispatch retries)
    replica_failures: int = 0        # replica executions that raised
    breaker_opens: int = 0           # circuit-breaker ejections
    breaker_closes: int = 0          # half-open probes that re-admitted
    health_probes: int = 0           # explicit half-open health checks run
    retried_batches: int = 0         # batch dispatch attempts after a failure
    failed_batches: int = 0          # batches that exhausted every retry
    failed_requests: int = 0         # requests inside those failed batches
    shutdown_leaks: int = 0          # frontend shutdowns leaving live threads

    # --- semantic cache + coalescing front door (the query cache):
    # cache-off (the default) leaves all six at 0. Hits and expirations
    # complete at admission, so on the scheduler
    # offered == admitted + shed + expired_requests + cache hits, and the
    # front-end additionally subtracts coalesced (followers never queue;
    # the virtual scheduler coalesces at dispatch, inside admitted).
    cache_hits_exact: int = 0        # answered verbatim from the exact tier
    cache_hits_semantic: int = 0     # answered from a cached neighbor
    cache_misses: int = 0            # lookups that fell through to execution
    cache_invalidations: int = 0     # entries dropped (epoch/TTL/explicit)
    coalesced: int = 0               # duplicates that shared an execution
    expired_requests: int = 0        # per-request deadlines enforced

    # --- tiered-corpus accounting (memory hierarchy): all 0 while every
    # segment is device-resident (the default placement)
    cold_batches: int = 0            # batches touching ≥1 host-tier segment
    bytes_streamed: int = 0          # cold candidate bytes uploaded
    prefetch_hits: int = 0           # cold uploads pre-staged by lookahead
    placement_swaps: int = 0         # tier placements adopted

    @property
    def qps(self) -> float:
        """Queries per second of *summed batch execution wall*
        (``queries / wall_s``) — engine throughput while serving, not
        end-to-end trace throughput (idle gaps between batches don't
        count; for trace-level QPS see ``ServingScheduler.served_qps`` /
        ``ServingFrontend.served_qps``)."""
        return self.queries / self.wall_s if self.wall_s else 0.0

    def latency_pct(self, p: float) -> float:
        return float(np.percentile(self.latencies_ms, p)) if self.latencies_ms else 0.0

    def queue_wait_pct(self, p: float) -> float:
        return float(np.percentile(self.queue_wait_ms, p)) if self.queue_wait_ms else 0.0

    def request_latency_pct(self, p: float) -> float:
        return (
            float(np.percentile(self.request_latency_ms, p))
            if self.request_latency_ms
            else 0.0
        )

    def _pct_or_none(self, arr: List[float], p: float) -> Optional[float]:
        # empty-array quantiles raise in numpy; a trace where nothing
        # completed (everything shed, or summarised pre-flush) reports
        # None instead of a misleading 0.0 — and never raises
        return float(np.percentile(arr, p)) if arr else None

    def summary(self) -> dict:
        """JSON-friendly digest for the serving benchmarks. Percentile
        fields are ``None`` when no request completed.

        Units: every ``p50_*``/``p99_*`` key is **milliseconds** (the
        ``_ms`` suffix is part of the key); all other keys are plain
        counts. ``p50/p99_queue_wait_ms`` measure arrival → batch
        dispatch; ``p50/p99_request_latency_ms`` measure arrival → batch
        completion (so latency ≥ queue wait for the same request). The
        full schema is documented in ``benchmarks/README.md``."""
        return {
            "batches": self.batches,
            "spmd_batches": self.spmd_batches,
            "queries": self.queries,
            "replans": self.replans,
            "upserts": self.upserts,
            "deletes": self.deletes,
            "generation_swaps": self.generation_swaps,
            "offered": self.offered,
            "admitted": self.admitted,
            "shed": self.shed,
            "full_batches": self.full_batches,
            "deadline_batches": self.deadline_batches,
            "capacity_batches": self.capacity_batches,
            "skew_replans": self.skew_replans,
            "hedged_batches": self.hedged_batches,
            "replica_failures": self.replica_failures,
            "breaker_opens": self.breaker_opens,
            "breaker_closes": self.breaker_closes,
            "health_probes": self.health_probes,
            "retried_batches": self.retried_batches,
            "failed_batches": self.failed_batches,
            "failed_requests": self.failed_requests,
            "shutdown_leaks": self.shutdown_leaks,
            "cache_hits_exact": self.cache_hits_exact,
            "cache_hits_semantic": self.cache_hits_semantic,
            "cache_misses": self.cache_misses,
            "cache_invalidations": self.cache_invalidations,
            "coalesced": self.coalesced,
            "expired_requests": self.expired_requests,
            "cold_batches": self.cold_batches,
            "bytes_streamed": self.bytes_streamed,
            "prefetch_hits": self.prefetch_hits,
            "placement_swaps": self.placement_swaps,
            "p50_queue_wait_ms": self._pct_or_none(self.queue_wait_ms, 50),
            "p99_queue_wait_ms": self._pct_or_none(self.queue_wait_ms, 99),
            "p50_request_latency_ms": self._pct_or_none(self.request_latency_ms, 50),
            "p99_request_latency_ms": self._pct_or_none(self.request_latency_ms, 99),
        }


@dataclass
class _SegmentState:
    """Per-(server, sealed segment) derived serving state."""

    segment: Segment
    decision: object                 # PlanDecision for this segment
    tier: str = "device"             # executor residency: "device" | "host"
    # built lazily: SpmdExecutor per precision served (spmd), and the
    # host engine's ShardedCorpus for decision.plan (backend="host")
    executors: Dict[str, SpmdExecutor] = field(default_factory=dict)
    corpus: object = None


class HarmonyServer(DataPlane):
    """Single-process serving engine over the HARMONY core, on ``device``
    (CUDA by default).

    Owns the shared data plane (a plain ``IVFIndex`` is wrapped as one
    sealed segment), per-segment plans, corpora and executors derived for
    its simulated cluster of ``n_nodes``, and the backend switch between
    the device-resident executor (``backend="spmd"``, the default) and
    the host engine (``backend="host"``, :func:`harmony_search`, numpy on
    the CPU; the reference's default, here only on request). The data
    plane's sealed rows must live on ``device``; the executors, the delta
    scan and the fused merge run there.

    >>> import numpy as np
    >>> from repro_torch.config import HarmonyConfig
    >>> from repro_torch.core import build_ivf
    >>> rng = np.random.default_rng(0)
    >>> x = rng.standard_normal((256, 8)).astype(np.float32)
    >>> cfg = HarmonyConfig(dim=8, nlist=4, nprobe=2, topk=3,
    ...                     kmeans_iters=2)
    >>> srv = HarmonyServer(build_ivf(x, cfg, device="cpu"), n_nodes=2,
    ...                     device="cpu")
    >>> res = srv.search_batch(x[:4], k=3)      # one batch, top-3 each
    >>> res.ids.shape, res.scores.shape
    ((4, 3), (4, 3))
    >>> bool((res.ids[:, 0] == np.arange(4)).all())   # self-NN is exact
    True
    >>> srv.upsert([999], x[:1] + 10.0)         # streaming write...
    >>> n = srv.delete([0])                     # ...and a tombstone
    >>> srv.data.delta_len, n
    (1, 1)
    >>> int(srv.search_batch(x[:1] + 10.0, k=1).ids[0, 0])  # reachable now
    999
    """

    def __init__(
        self,
        index,
        n_nodes: int,
        cfg: Optional[HarmonyConfig] = None,
        replan_every: int = 0,          # batches between plan refreshes (0=off)
        workload_window: int = 2048,
        backend: str = "spmd",          # "spmd" | "host" default for batches
        executor_cfg: Optional[ExecutorConfig] = None,
        precision: str = "fp32",        # "int8" → quantized tier + fp32 re-rank
        device: DeviceLike = None,
    ):
        if backend not in ("host", "spmd"):
            raise ValueError(f"backend={backend!r}")
        if precision not in ("fp32", "int8"):
            raise ValueError(f"precision={precision!r}")
        self.device = resolve_device(device)
        self.data: SegmentedIndex = (
            index if isinstance(index, SegmentedIndex)
            else SegmentedIndex.from_static(index)
        )
        if self.data.device != self.device:
            raise ValueError(f"the data plane lives on {self.data.device}, "
                             f"the server on {self.device}")
        self.cfg = cfg or self.data.cfg
        self.precision = precision
        if precision == "int8" and self.cfg.metric != "l2":
            raise ValueError("the int8 tier is L2-only")
        self.cluster = ClusterState.fresh(n_nodes)
        self.replan_every = replan_every
        self.backend = backend
        self._executor_cfg = executor_cfg
        self._recent_probes: Deque[np.ndarray] = deque(maxlen=workload_window)
        self.stats = ServeStats()
        # per-segment derived state, adopted per data-plane generation
        self._dp_mu = threading.Lock()
        self._seg_states: Dict[int, _SegmentState] = {}
        self._staged: Dict[int, _SegmentState] = {}
        self._generation = -1
        self._placement_version = -1
        self._plan_decision = None
        self._sync(self.data.snapshot())

    # ------------------------------------------------------------- data plane
    @property
    def index(self) -> SegmentedIndex:
        """The (shared) data plane, under the historical name."""
        return self.data

    @property
    def generation(self) -> int:
        """Data-plane generation this server has adopted."""
        return self._generation

    # upsert()/delete() come from the DataPlane mixin; the server's whole
    # contribution is where writes go and which counters they bump
    def _data_plane(self) -> SegmentedIndex:
        return self.data

    def _note_write(self, kind: str, n: int) -> None:
        if kind == "upsert":
            self.stats.upserts += n
        else:
            self.stats.deletes += n

    @staticmethod
    def _primary(segments) -> Optional[Segment]:
        return max(segments, key=lambda s: (s.nb, -s.seg_id), default=None)

    def _plan_for(self, seg: Segment, probes_sample: Optional[np.ndarray]):
        return plan_search(
            seg.index, self.cluster.n_live, self.cfg.replace(
                nlist=seg.index.nlist,
                nprobe=min(self.cfg.nprobe, seg.index.nlist),
            ),
            probes_sample=probes_sample,
        )

    def _build_state(self, seg: Segment,
                     probes_sample: Optional[np.ndarray] = None,
                     tier: str = "device") -> _SegmentState:
        decision = self._plan_for(seg, probes_sample)
        if self.precision == "int8":
            # eager: quantize off the serving path (idempotent: seal()
            # already made the codes for segments born in this plane)
            seg.index.int8_quant(self.cfg.quant_blocks)
        return _SegmentState(segment=seg, decision=decision, tier=tier)

    def _executor_for(self, st: _SegmentState,
                      precision: Optional[str] = None) -> SpmdExecutor:
        """The segment's executor of ``precision`` (default the server's),
        built on first use: a per-batch precision override gets an
        executor of its own, so it is served on the card as well."""
        prec = precision or self.precision
        ex = st.executors.get(prec)
        if ex is None:
            ecfg = self._executor_cfg or ExecutorConfig()
            if ecfg.precision != prec:
                ecfg = dataclasses.replace(ecfg, precision=prec)
                if prec == "int8":
                    ecfg = dataclasses.replace(
                        ecfg, rerank_factor=self.cfg.rerank_factor)
            if prec == "int8":
                st.segment.index.int8_quant(self.cfg.quant_blocks)
            ex = st.executors.setdefault(prec, SpmdExecutor(
                st.segment.index, ecfg, tier=st.tier, device=self.device))
        return ex

    @staticmethod
    def _corpus_for(st: _SegmentState):
        """The host engine's layout of the segment for its plan, built on
        first use (only ``backend="host"`` reads it)."""
        corpus = st.corpus
        if corpus is None:
            corpus = st.corpus = preassign(st.segment.index, st.decision.plan)
        return corpus

    def _sync(self, snap: DataSnapshot) -> bool:
        """Adopt a data-plane snapshot: build (or promote pre-staged)
        derived state for new segments, drop the state of retired ones
        (their executors, and so their step caches, go with them).

        Generations only move forward: a snapshot older than the adopted
        generation must not roll the server back (it would destroy state
        prepared for the newer one); it returns False and the caller
        re-snapshots. A stale ``placement_version`` likewise never moves
        a segment's tier."""
        with self._dp_mu:
            if snap.generation < self._generation:
                return False
            tiers = snap.tiers or {}
            fresh_placement = snap.placement_version >= self._placement_version
            for seg in snap.segments:
                want = (tiers.get(seg.seg_id, "device")
                        if fresh_placement else None)
                st = self._seg_states.get(seg.seg_id)
                if st is None:
                    st = self._staged.pop(seg.seg_id, None)
                    if st is None or (want is not None and st.tier != want):
                        st = self._build_state(seg, tier=want or "device")
                    self._seg_states[seg.seg_id] = st
                elif want is not None and st.tier != want:
                    staged = self._staged.pop(seg.seg_id, None)
                    if staged is not None and staged.tier == want:
                        self._seg_states[seg.seg_id] = staged
                    else:
                        self._seg_states[seg.seg_id] = self._build_state(
                            seg, tier=want
                        )
            keep = {s.seg_id for s in snap.segments}
            for sid in list(self._seg_states):
                if sid not in keep:
                    del self._seg_states[sid]
            self._staged = {s: st for s, st in self._staged.items() if s in keep}
            if snap.generation != self._generation:
                if self._generation >= 0:
                    self.stats.generation_swaps += 1
                self._generation = snap.generation
            if fresh_placement and snap.placement_version != self._placement_version:
                if self._placement_version >= 0:
                    self.stats.placement_swaps += 1
                self._placement_version = snap.placement_version
            primary = self._primary(snap.segments)
            if primary is not None:
                self._plan_decision = self._seg_states[primary.seg_id].decision
            return True

    def prepare_segments(self, segments) -> None:
        """Pre-build derived state for segments about to be committed (off
        the serving path, so the adoption after the commit is O(1))."""
        for seg in segments:
            with self._dp_mu:
                known = seg.seg_id in self._seg_states or seg.seg_id in self._staged
            if known:
                continue
            st = self._build_state(seg)
            if self.backend == "spmd":
                self._executor_for(st).warmup(k=self.cfg.topk)
            with self._dp_mu:
                self._staged[seg.seg_id] = st

    def adopt(self) -> None:
        """Swap to the data plane's current generation and tier placement
        now (otherwise the next batch adopts lazily)."""
        self._sync(self.data.snapshot())

    def warmup_executors(self, k: Optional[int] = None) -> None:
        """Build every sealed segment's executor and run its bucket ladder
        once (so no served batch pays a step build)."""
        snap = self.data.snapshot()
        if snap.generation != self._generation:
            self._sync(snap)
        with self._dp_mu:
            states = [self._seg_states[s.seg_id] for s in snap.segments]
        for st in states:
            self._executor_for(st).warmup(k=k)

    @property
    def executor(self) -> SpmdExecutor:
        """Device executor of the primary (largest) sealed segment."""
        with self._dp_mu:
            primary = self._primary([st.segment for st in self._seg_states.values()])
            if primary is None:
                raise RuntimeError("no sealed segments (all data in delta "
                                   "or the corpus is empty)")
            st = self._seg_states[primary.seg_id]
        return self._executor_for(st)

    # ------------------------------------------------------------- planning
    def _window_sample(self) -> Optional[np.ndarray]:
        return (
            np.concatenate(list(self._recent_probes), axis=0)
            if self._recent_probes
            else None
        )

    def refresh_plan(self):
        """Re-plan every sealed segment for the current live node set (the
        workload sample steers the primary segment's assignment; device
        executors keep their own packing and stay resident)."""
        sample = self._window_sample()
        with self._dp_mu:
            states = list(self._seg_states.values())
            primary = self._primary([st.segment for st in states])
            for st in states:
                st.decision = self._plan_for(
                    st.segment, sample if st.segment is primary else None)
                st.corpus = None                 # rebuilt for the new plan
                if st.segment is primary:
                    self._plan_decision = st.decision
        self.stats.replans += 1

    @property
    def plan(self):
        return self._plan_decision.plan

    @property
    def corpus(self):
        """Host-engine corpus of the primary sealed segment."""
        with self._dp_mu:
            primary = self._primary([st.segment for st in self._seg_states.values()])
            if primary is None:
                raise RuntimeError("no sealed segments (all data in delta "
                                   "or the corpus is empty)")
            st = self._seg_states[primary.seg_id]
        return self._corpus_for(st)

    # -------------------------------------------------------------- elastic
    def fail_node(self, node: int):
        self.cluster.fail(node)
        if self.cluster.n_live == 0:
            raise RuntimeError("no live nodes")
        self.refresh_plan()

    def join_node(self):
        self.cluster.join()
        self.refresh_plan()

    # -------------------------------------------------------------- serving
    def search_batch(
        self,
        queries,
        k: Optional[int] = None,
        backend: Optional[str] = None,
        flt: Optional[Filter] = None,
        hybrid_text: Optional[str] = None,
        precision: Optional[str] = None,
    ) -> SearchResult:
        """One batch through the engine; records workload + stats.

        ``queries`` is a [NQ, D] array or a :class:`SearchRequest` (whose
        vector/k/precision fields fill the matching parameters). Searches
        every sealed segment of the current data-plane snapshot
        (tombstone-masked; ``backend="host"`` through the host engine,
        ``backend="spmd"`` through the device-resident executor), scans
        the delta buffer by brute force, and merges the per-part top-Ks,
        on the spmd backend with one running top-K kernel launch per part.
        The snapshot is taken once per batch: a concurrent
        upsert/delete/compaction never tears an in-flight batch.

        On the spmd backend every segment, whatever its ids, goes through
        its executor, and ``precision`` (overriding the server's tier per
        batch) through the segment's executor of that precision. ``flt``
        and ``hybrid_text`` are not ported yet and raise
        ``NotImplementedError``."""
        if isinstance(queries, SearchRequest):
            req = queries
            queries = np.atleast_2d(np.asarray(req.vector, np.float32))
            k = k if k is not None else req.k
            flt = flt if flt is not None else req.filter
            hybrid_text = (hybrid_text if hybrid_text is not None
                           else req.hybrid_text)
            precision = precision if precision is not None else req.precision
        if flt is not None or hybrid_text is not None:
            raise NotImplementedError(NOT_PORTED_FILTERS)
        backend = backend or self.backend
        if backend not in ("host", "spmd"):
            raise ValueError(f"backend={backend!r}")
        k = k or self.cfg.topk
        prec = precision or self.precision
        if prec not in ("fp32", "int8"):
            raise ValueError(f"precision={prec!r}")
        if prec == "int8" and self.cfg.metric != "l2":
            raise ValueError("the int8 tier is L2-only")
        t0 = time.perf_counter()
        queries = np.asarray(queries, np.float32)
        while True:
            snap = self.data.snapshot()
            if (snap.generation != self._generation
                    or snap.placement_version != self._placement_version):
                self._sync(snap)
            with self._dp_mu:
                if all(s.seg_id in self._seg_states for s in snap.segments):
                    states = [self._seg_states[s.seg_id] for s in snap.segments]
                    break
            # lost a race with a concurrent adopt(): this snapshot's
            # segments were retired while it was read; generations only
            # move forward, so a fresh snapshot converges
        primary = self._primary(snap.segments)
        seg_results = []
        for st in states:
            seg = st.segment
            dead = snap.dead_rows[seg.seg_id]
            dead_arg = dead if dead.any() else None
            probes = assign_queries(seg.index, queries)
            # the placement policy's cluster-hotness EWMA sees every
            # segment's probe selection
            self.data.note_probes(seg.seg_id, probes)
            if seg is primary:
                self._recent_probes.append(probes)
            if backend == "spmd":
                res = self._executor_for(st, prec).search_batch(
                    queries, k=k, probes=probes, dead_rows=dead_arg
                )
            elif prec == "int8":
                res = two_stage_search(
                    seg.index, queries, k=k, probes=probes,
                    rerank_factor=self.cfg.rerank_factor,
                    dead_rows=dead_arg,
                    quant_blocks=self.cfg.quant_blocks,
                )
            else:
                res = harmony_search(
                    seg.index, self._corpus_for(st), queries, k=k,
                    probes=probes, dead_rows=dead_arg,
                    dead_key=(snap.generation, snap.dead_version),
                )
            seg_results.append(res)
        parts = [(r.scores, r.ids) for r in seg_results]
        delta_live = snap.delta_live
        if snap.delta_ids.size:
            parts.append(delta_topk(
                snap.delta_x, snap.delta_ids, delta_live,
                queries, k, self.cfg.metric, device=self.device,
            ))
        if len(parts) == 1 and seg_results:
            # one sealed segment, empty delta: the static special case
            # returns the engine's result (rich stats) unmerged
            res = seg_results[0]
            res.ids[~np.isfinite(res.scores)] = -1
        else:
            nq = queries.shape[0]
            if not parts:
                scores = np.full((nq, k), np.inf, np.float32)
                ids = np.full((nq, k), -1, np.int64)
            else:
                scores, ids = merge_topk(parts, k, fused=(backend == "spmd"),
                                         device=self.device)
            res = SearchResult(ids=ids, scores=scores, stats={
                "backend": backend,
                "segments": len(seg_results),
                "delta_candidates": int(delta_live.sum()),
                "generation": snap.generation,
            })
        res.stats["cold_segments"] = sum(
            int(r.stats.get("cold", 0)) for r in seg_results)
        res.stats["bytes_streamed"] = sum(
            int(r.stats.get("bytes_streamed", 0)) for r in seg_results)
        res.stats["prefetch_hits"] = sum(
            int(r.stats.get("prefetch_hits", 0)) for r in seg_results)
        dt = time.perf_counter() - t0
        res.stats["wall_s"] = dt
        if backend == "spmd":
            self.stats.spmd_batches += 1
        self.stats.batches += 1
        self.stats.queries += queries.shape[0]
        self.stats.wall_s += dt
        self.stats.latencies_ms.append(dt * 1e3)
        if self.replan_every and self.stats.batches % self.replan_every == 0:
            self.refresh_plan()
        return res
