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

On the spmd backend, an unfiltered batch's probes are chosen on the
segment executor's card when it has one (:func:`probes_on_card`,
:meth:`~repro_torch.serve.executor.SpmdExecutor.select_probes`): the
port's distance and top-K kernels score the centroids, and only the
[NQ, nprobe] table comes back to the host.

A metadata filter (``flt=`` or a request's ``filter``) is a per-batch
tombstone set: each segment's excluded rows steer probe selection
(:func:`~repro_torch.core.search.filtered_assign_queries`, widened at low
selectivity) and are dropped from the executor's gather table, so the
kernels see only allowed live rows. ``hybrid_text=`` adds the BM25 tier
and fuses it with the vector top-k by reciprocal-rank fusion.

A segment set to ``"host"`` (``SegmentedIndex.set_tiers``) is served by a
host-tier executor that streams each batch's probed rows to the card;
:meth:`HarmonyServer.prepare_placement` builds it off the serving path,
and :meth:`HarmonyServer.prefetch_batch` stages the next batch's upload.

Load-aware re-planning (a sliding window of recent probes) and elastic
node failure / join re-plan every segment; results do not change.

:meth:`HarmonyServer.serve` drives a stream of query batches through
the admission-controlled :class:`repro_torch.serve.scheduler.ServingScheduler`,
with :meth:`HarmonyServer.search_batch` as its execution primitive.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import tracing
from repro_torch._device import DeviceLike, resolve_device
from repro_torch.config import HarmonyConfig
from repro_torch.core.fusion import BM25Index, reciprocal_rank_fusion, segment_bm25
from repro_torch.core.index import (
    DataSnapshot,
    Segment,
    SegmentedIndex,
    assign_queries,
    meta_rows_to_store,
    preassign,
)
from repro_torch.core.planner import plan_search
from repro_torch.core.search import (
    delta_topk,
    filter_excluded_rows,
    filtered_assign_queries,
    harmony_search,
    merge_topk,
    two_stage_search,
)
from repro_torch.core.types import DataPlane, Filter, SearchRequest, SearchResult
from repro_torch.runtime.elastic import ClusterState
from repro_torch.serve.executor import ExecutorConfig, SpmdExecutor
from repro_torch.serve.scheduler import SchedulerConfig, ServingScheduler


LATENCY_SAMPLES = 1 << 20


def probes_on_card(device: torch.device, filtered: bool, nprobe: int,
                   nlist: int) -> bool:
    """Whether an spmd batch's probe selection runs on its executor's card
    (:meth:`SpmdExecutor.select_probes`) rather than in numpy
    (``assign_queries``): on a CUDA device, without a filter (whose
    pushdown and widening stay on the host), for ``1 <= nprobe <= nlist``."""
    return device.type == "cuda" and not filtered and 1 <= nprobe <= nlist


class LatencySamples(deque):
    """The newest :data:`LATENCY_SAMPLES` timings of a live counter, so a
    long-running front end stops growing. Equal to a list or deque that
    holds the same values in the same order."""

    def __init__(self, iterable=(), maxlen: int = LATENCY_SAMPLES):
        super().__init__(iterable, maxlen)

    def __eq__(self, other):
        if isinstance(other, (list, deque)):
            return list(self) == list(other)
        return NotImplemented

    def __ne__(self, other):
        eq = self.__eq__(other)
        return eq if eq is NotImplemented else not eq


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
    # per request (arrival→dispatch, arrival→done), the newest LATENCY_SAMPLES
    queue_wait_ms: LatencySamples = field(default_factory=LatencySamples)
    request_latency_ms: LatencySamples = field(default_factory=LatencySamples)

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

    def prepare_placement(self, tiers: Dict[int, str]) -> None:
        """Pre-build the state of the segments whose tier is about to
        change (the prepare leg of a placement swap: this, then
        ``data.set_tiers(tiers)``, then :meth:`adopt`), off the serving
        path, so the adoption is O(1)."""
        snap = self.data.snapshot()
        seg_by_id = {s.seg_id: s for s in snap.segments}
        for sid, want in tiers.items():
            seg = seg_by_id.get(sid)
            if seg is None:
                continue
            with self._dp_mu:
                st = self._seg_states.get(sid)
                staged = self._staged.get(sid)
                ready = ((st is not None and st.tier == want)
                         or (staged is not None and staged.tier == want))
            if ready:
                continue
            new = self._build_state(seg, tier=want)
            if self.backend == "spmd":
                self._executor_for(new).warmup(k=self.cfg.topk)
            with self._dp_mu:
                self._staged[sid] = new

    def prefetch_batch(self, queries) -> None:
        """Stage every host-tier segment's candidate upload for the next
        batch while the current one computes. Advisory: a wrong or missing
        prefetch is a miss, never a wrong answer. No-op on the host backend
        or an all-device placement."""
        if self.backend != "spmd":
            return
        queries = np.atleast_2d(np.asarray(queries, np.float32))
        snap = self.data.snapshot()
        if (snap.generation != self._generation
                or snap.placement_version != self._placement_version):
            self._sync(snap)
        with self._dp_mu:
            states = [self._seg_states.get(s.seg_id) for s in snap.segments]
        for st in states:
            if st is None or st.tier != "host":
                continue
            probes = assign_queries(st.segment.index, queries)
            dead = snap.dead_rows[st.segment.seg_id]
            self._executor_for(st).prefetch(
                probes=probes, dead_rows=dead if dead.any() else None)

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
    @staticmethod
    def _delta_allowed(snap: DataSnapshot, flt: Filter) -> np.ndarray:
        """Allowed mask [delta rows] of the snapshot's delta buffer under
        ``flt`` (its per-row metadata dicts, made columnar here: the
        buffer is small by construction)."""
        n = snap.delta_ids.size
        store = meta_rows_to_store(list(snap.delta_meta))
        if store is None:
            return np.zeros(n, bool)
        return flt.evaluate(store.tags, store.nums, n)

    @staticmethod
    def _lexical_topk(snap: DataSnapshot, states, text: str, k: int,
                      flt: Optional[Filter], delta_live: np.ndarray) -> np.ndarray:
        """The global BM25 top-k external ids for ``text``, the lexical
        tier of a hybrid batch (one ``hybrid_text`` for the whole batch).
        Each sealed segment's posting index scores under the excluded mask
        the vector tier used; the live delta rows are scored as they are;
        the candidates merge by score, ties to the lower id."""
        cands = []                          # (score, ext_id)
        for st in states:
            seg = st.segment
            bm = segment_bm25(seg.index)
            if bm is None:
                continue
            excluded = filter_excluded_rows(seg.index, flt, snap.dead_rows[seg.seg_id])
            sc, rows = bm.topk(text, k, excluded=excluded)
            cands += [(float(s), int(e)) for s, e in zip(sc, seg.index.ids[rows])]
        if snap.delta_ids.size:
            texts = [(m or {}).get("text") for m in snap.delta_meta]
            if any(texts):
                sc, rows = BM25Index(texts).topk(text, k, excluded=~delta_live)
                cands += [(float(s), int(snap.delta_ids[r])) for s, r in zip(sc, rows)]
        cands.sort(key=lambda c: (-c[0], c[1]))
        return np.array([e for _, e in cands[:k]], np.int64)

    @tracing.traced("engine.search_batch")
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
        vector/k/filter/hybrid_text/precision fields fill the matching
        parameters). Searches
        every sealed segment of the current data-plane snapshot
        (tombstone-masked; ``backend="host"`` through the host engine,
        ``backend="spmd"`` through the device-resident executor), scans
        the delta buffer by brute force, and merges the per-part top-Ks,
        on the spmd backend with one running top-K kernel launch per part.
        The snapshot is taken once per batch: a concurrent
        upsert/delete/compaction never tears an in-flight batch.

        On the spmd backend every segment, whatever its ids, goes through
        its executor, and ``precision`` (overriding the server's tier per
        batch) through the segment's executor of that precision.

        ``flt`` merges the predicate's disallowed rows with each segment's
        tombstones: probe selection skips clusters with no allowed live
        row and widens at low selectivity
        (:func:`~repro_torch.core.search.filtered_assign_queries`), and
        the executor drops those rows from its gather table, so the step
        and its bucket keys are the unfiltered ones. ``hybrid_text`` adds
        the BM25 tier, fused with the vector top-k by reciprocal-rank
        fusion (the scores are then the negated fused score, and
        ``stats["fused"]`` is True)."""
        if isinstance(queries, SearchRequest):
            req = queries
            queries = np.atleast_2d(np.asarray(req.vector, np.float32))
            k = k if k is not None else req.k
            flt = flt if flt is not None else req.filter
            hybrid_text = (hybrid_text if hybrid_text is not None
                           else req.hybrid_text)
            precision = precision if precision is not None else req.precision
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
        tracing.count(segments=len(states))
        seg_results = []
        for st in states:
            seg = st.segment
            dead_arg = filter_excluded_rows(seg.index, flt, snap.dead_rows[seg.seg_id])
            ex = self._executor_for(st, prec) if backend == "spmd" else None
            on_card = ex is not None and probes_on_card(
                ex.device, flt is not None, seg.index.cfg.nprobe, seg.index.nlist)
            with tracing.span("engine.assign_queries") as sp:
                if on_card:
                    probes = ex.select_probes(queries)
                elif flt is None:
                    probes = assign_queries(seg.index, queries)
                else:
                    # predicate pushdown: clusters with no allowed live row
                    # drop out of probe selection
                    probes = filtered_assign_queries(seg.index, queries, dead_arg)
                sp.count(on_card=queries.shape[0] if on_card else 0)
            # the placement policy's cluster-hotness EWMA sees every
            # segment's probe selection
            self.data.note_probes(seg.seg_id, probes)
            if seg is primary:
                self._recent_probes.append(probes)
            if ex is not None:
                res = ex.search_batch(queries, k=k, probes=probes, dead_rows=dead_arg)
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
                    # the dead-mask cache keys on (generation, dead_version)
                    # only; a filter changes the mask under the same key
                    dead_key=None if flt is not None
                    else (snap.generation, snap.dead_version),
                )
            seg_results.append(res)
        parts = [(r.scores, r.ids) for r in seg_results]
        delta_live = snap.delta_live
        if flt is not None and snap.delta_ids.size:
            delta_live = delta_live & self._delta_allowed(snap, flt)
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
        if hybrid_text is not None:
            lex = self._lexical_topk(snap, states, hybrid_text, k, flt, delta_live)
            ranked = [res.ids]
            if lex.size:
                ranked.append(np.broadcast_to(lex, (queries.shape[0], lex.size)))
            f_scores, f_ids = reciprocal_rank_fusion(ranked, k)
            res = SearchResult(ids=f_ids, scores=f_scores,
                               stats={**res.stats, "fused": True})
        cold_n = sum(int(r.stats.get("cold", 0)) for r in seg_results)
        res.stats["cold_segments"] = cold_n
        res.stats["bytes_streamed"] = sum(
            int(r.stats.get("bytes_streamed", 0)) for r in seg_results)
        res.stats["prefetch_hits"] = sum(
            int(r.stats.get("prefetch_hits", 0)) for r in seg_results)
        if cold_n:
            self.stats.cold_batches += 1
            self.stats.bytes_streamed += res.stats["bytes_streamed"]
            self.stats.prefetch_hits += res.stats["prefetch_hits"]
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

    def serve(self, request_stream, k: Optional[int] = None, sched=None,
              arrivals=None) -> List[SearchResult]:
        """Admission-controlled scheduled serving of an iterable of query
        batches. Incoming batches are flattened into per-query requests and
        pushed through :class:`repro_torch.serve.scheduler.ServingScheduler`,
        which re-forms batches adaptively (size/deadline triggers) and
        keeps :meth:`search_batch` as the inner execution primitive (the
        server's backend, or ``sched.backend`` when set). Returns one
        ``SearchResult`` per input batch, aligned with the stream; a
        request shed by a bounded queue keeps ids -1 and scores +inf.

        ``arrivals`` optionally supplies per-batch arrival timestamps for
        replayed traces (aligned with ``request_stream``; each entry is a
        scalar for the whole batch or a per-row sequence, non-decreasing
        across the stream). Without it every request arrives at t=0 and
        queue-wait/deadline statistics degenerate.

        Stream entries may also be :class:`SearchRequest` objects (vector
        [D] or [NQ, D]); their filter/hybrid/precision/k ride along with
        every row of that entry."""
        sched_cfg = sched or SchedulerConfig()   # unbounded queue by default
        k = k or self.cfg.topk
        scheduler = ServingScheduler(self, sched_cfg, k=k)
        owners: Dict[int, tuple] = {}            # req_id → (batch_idx, row)
        shapes: List[Tuple[int, int]] = []       # (rows, k) per input batch
        arr_iter = iter(arrivals) if arrivals is not None else None
        for bi, qb in enumerate(request_stream):
            breq = qb if isinstance(qb, SearchRequest) else None
            qb = np.atleast_2d(
                np.asarray(breq.vector if breq is not None else qb)
            )
            k_b = (breq.k or k) if breq is not None else k
            shapes.append((qb.shape[0], k_b))
            if arr_iter is None:
                t_b = 0.0
            else:
                try:
                    t_b = next(arr_iter)
                except StopIteration:
                    raise ValueError(
                        f"arrivals exhausted at batch {bi}: it must yield "
                        "one timestamp (or per-row sequence) per "
                        "request_stream batch"
                    ) from None
            for r in range(qb.shape[0]):
                t_r = float(t_b) if np.ndim(t_b) == 0 else float(t_b[r])
                row_req = (
                    SearchRequest(vector=qb[r], k=breq.k, filter=breq.filter,
                                  hybrid_text=breq.hybrid_text,
                                  precision=breq.precision,
                                  deadline=breq.deadline)
                    if breq is not None else qb[r]
                )
                rid = scheduler.submit(row_req, arrival_s=t_r, _warn=False)
                if rid >= 0:
                    owners[rid] = (bi, r)
        done = scheduler.flush()

        out = [
            SearchResult(
                ids=np.full((n, k_b), -1, np.int64),
                scores=np.full((n, k_b), np.inf, np.float32),
                stats={"scheduled": True, "wall_s": 0.0, "queue_wait_ms": []},
            )
            for n, k_b in shapes
        ]
        for rr in done:
            bi, r = owners.get(rr.req_id, (None, None))
            if bi is None:
                continue
            out[bi].ids[r] = rr.ids
            out[bi].scores[r] = rr.scores
            st = out[bi].stats
            # per-input-batch wall = first arrival → last completion of its
            # requests on the scheduler's virtual clock
            st["wall_s"] = max(st["wall_s"], rr.done_s - rr.arrival_s)
            st["queue_wait_ms"].append(rr.queue_wait_s * 1e3)
        return out
