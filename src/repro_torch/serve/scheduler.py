"""Asynchronous admission-controlled serving scheduler (the BatANN-style
dispatch layer on top of the HARMONY core).

The paper's throughput claims are won in this layer: requests arrive as
single queries with timestamps; the scheduler

* **admits** them into a bounded queue (backpressure: arrivals beyond the
  bound are shed and counted, never silently dropped);
* **forms batches adaptively** — a batch fires when either the size
  threshold (``max_batch``, default the engine's ``query_block``) is
  reached or the oldest queued request has waited ``max_wait_s`` (the
  deadline trigger that caps tail latency under slow arrivals);
* **routes skew-aware** — the hot-cluster concentration of the live
  arrival window (:func:`repro_torch.core.router.workload_concentration` over
  :func:`estimate_cluster_hits`) is compared against the concentration the
  current plan was built for; drift past ``replan_drift`` triggers a
  cost-model re-plan (Fig. 7's skew adaptation, now online);
* **hedges stragglers** — batch dispatch optionally goes through
  :class:`repro_torch.runtime.straggler.HedgingExecutor`, whose simulated
  effective latency is charged to the scheduler's virtual clock.

Batch formation is decoupled from execution: ``_dispatch`` hands every
formed batch to a pluggable :class:`DispatchTarget` —
:class:`SingleServerTarget` (one ``HarmonyServer``, built automatically
when the scheduler is handed a server) or
:class:`repro_torch.serve.fleet.ReplicaFleet` (N replicas behind the same
admission queue, load-aware routing + cross-replica hedging).

Time model: the clock is factored behind :class:`repro_torch.serve.clock.Clock`.
``ServingScheduler`` itself always runs the **virtual-clock replay**
(:class:`~repro_torch.serve.clock.VirtualClock` driven by request arrival
timestamps) — the standard single-process simulation methodology and the
deterministic test oracle (``tests/goldens/serving_virtual_clock.json``
pins its counters bit for bit, for the port as for the reference). Batch
service time is the measured ``search_batch`` wall by default, or an
injected ``service_time_fn`` (tests use this to force deterministic
backlog). The *same*
queue/deadline/shed logic runs against the wall clock in
:class:`repro_torch.serve.frontend.ServingFrontend`, which dispatches formed
batches to a thread pool so fleet replicas overlap in real time.
"""

from __future__ import annotations

import math
import threading
import time
import warnings
from collections import deque
from dataclasses import dataclass
from typing import Callable, Deque, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch._device import is_device_fault
from repro_torch.core.router import (
    DEFAULT_HOT_FRACTION,
    estimate_cluster_hits,
    workload_concentration,
)
from repro_torch.core.types import DataPlane, Filter, SearchRequest
from repro_torch.runtime.straggler import HedgingExecutor
from repro_torch.serve.cache import CacheConfig, build_query_cache, vec_bytes
from repro_torch.serve.clock import Clock, VirtualClock


def options_kwargs(options) -> dict:
    """Expand a request-options tuple (``SearchRequest.options_key()``:
    filter, hybrid_text, precision) into ``search_batch`` keywords. None
    (the no-options fast path) expands to nothing."""
    if options is None:
        return {}
    flt, hybrid_text, precision = options
    return {"flt": flt, "hybrid_text": hybrid_text, "precision": precision}


@dataclass(frozen=True)
class SchedulerConfig:
    """Knobs of the admission-controlled batch former.

    Shared by the virtual-clock :class:`ServingScheduler` and the
    real-clock :class:`repro_torch.serve.frontend.ServingFrontend` — the same
    config replayed virtually is the test oracle for a live run.

    All durations are **seconds**.

    >>> cfg = SchedulerConfig(max_batch=16, max_wait_s=2e-3,
    ...                       queue_capacity=64)
    >>> cfg.max_batch, cfg.queue_capacity
    (16, 64)
    """

    max_batch: int = 0              # size trigger; 0 → server cfg.query_block
    max_wait_s: float = 2e-3        # deadline trigger for the oldest request
    queue_capacity: int = 0         # backpressure bound; 0 → unbounded
    replan_drift: float = 0.0       # hot-mass drift threshold; 0 → off
    hot_fraction: float = DEFAULT_HOT_FRACTION
    skew_window: int = 1024         # probe rows of the live arrival window
    min_batches_between_replans: int = 4
    hedge_deadline_s: float = 0.0   # straggler hedging; 0 → off
    backend: str = ""               # batch execution backend: "" → server
                                    # default; "host" | "spmd" to force
    # graceful degradation (searches are idempotent reads, so re-issuing
    # a failed batch is always safe): a batch whose dispatch raises is
    # retried up to max_retries times with linear backoff, as long as the
    # oldest request's age stays inside request_deadline_s (0 → no
    # deadline budget). With max_retries=0 (default) failures propagate
    # exactly as before; with retries enabled, an exhausted batch
    # *degrades* instead of raising — placeholder results (ids -1,
    # +inf scores) and failed_batches/failed_requests counters. A device
    # fault (a CUDA error) always propagates.
    max_retries: int = 0
    retry_backoff_s: float = 1e-3
    request_deadline_s: float = 0.0
    # semantic cache + request coalescing in front of admission
    # (repro_torch.serve.cache). None or CacheConfig(enabled=False) — the
    # default — keeps every admission path byte-identical to a cache-less
    # build (the virtual-clock goldens pin this).
    cache: Optional[CacheConfig] = None


@dataclass
class Request:
    """One admitted query with its arrival timestamp (seconds) and the
    per-request knobs carried in from its :class:`SearchRequest` (all
    None for pre-request-API submissions — the zero-overhead default)."""

    req_id: int
    query: np.ndarray               # [D]
    arrival_s: float
    k: Optional[int] = None
    filter: Optional[Filter] = None
    hybrid_text: Optional[str] = None
    precision: Optional[str] = None
    deadline: Optional[float] = None    # absolute; enforced at dispatch

    def options_key(self):
        """Grouping key for batch execution (see
        :meth:`repro_torch.core.types.SearchRequest.options_key`), with the
        per-request ``k`` folded in. ``None`` for a knob-free request —
        the batch path that stays byte-identical to the pre-filter API."""
        if (self.k is None and self.filter is None
                and self.hybrid_text is None and self.precision is None):
            return None
        return (self.k, self.filter, self.hybrid_text, self.precision)


@dataclass
class RequestResult:
    """Per-request outcome: top-K ids/scores plus the three timeline
    points (all seconds on the scheduler's clock): ``arrival_s`` →
    ``dispatch_s`` (batch formed and handed to the target) → ``done_s``
    (batch completed)."""

    req_id: int
    ids: np.ndarray                 # [K]
    scores: np.ndarray              # [K]
    arrival_s: float
    dispatch_s: float
    done_s: float
    batch_id: int

    @property
    def queue_wait_s(self) -> float:
        return self.dispatch_s - self.arrival_s

    @property
    def latency_s(self) -> float:
        return self.done_s - self.arrival_s


class DispatchTarget(DataPlane):
    """Execution side of the scheduler: where formed batches go.

    The scheduler owns admission, batch formation, and the clock;
    a target owns *running* the batch (which engine, which replica, which
    hedge policy) and reports the completion time back. Implementations:
    :class:`SingleServerTarget` here and
    :class:`repro_torch.serve.fleet.ReplicaFleet`.

    The write surface (``upsert``/``delete``) is the shared
    :class:`repro_torch.core.types.DataPlane` mixin — implementations point
    ``_data_plane()`` at the next layer down.

    The target also exposes the thin server-shaped surface the
    scheduler's skew adaptation needs (``stats`` for accounting,
    ``window_probes``/``nlist``/``refresh_plan``/``replans`` for the
    hot-mass drift trigger, ``default_max_batch``/``default_k`` for
    config defaults).
    """

    stats = None                    # ServeStats: admission/queue accounting
    device = None                   # the card batches run on (None: none)

    def configure(self, cfg: SchedulerConfig, k: int) -> None:
        """Bind the scheduler's config (backend override, hedge deadline)
        and pre-warm the executors' bucket steps so no in-trace dispatch
        charges a step build to the virtual clock."""

    def next_free_s(self) -> float:
        """Earliest virtual time the target can start another batch."""
        raise NotImplementedError

    def execute(
        self, queries: np.ndarray, k: int, dispatch_s: float, batch_id: int,
        options=None,
    ):
        """Run one formed batch; returns ``(result, done_s)`` where
        ``done_s`` is the completion time on the virtual clock.
        ``options`` is a request-options tuple (filter, hybrid_text,
        precision) shared by the whole batch, or None (see
        :func:`options_kwargs`) — the scheduler only passes it when a
        batch actually carries options, so positional implementations
        predating the request API keep working."""
        raise NotImplementedError

    def execute_wall(
        self, queries: np.ndarray, k: int, batch_id: int, clock: Clock,
        options=None,
    ):
        """Real-clock batch execution for the live front-end: run the
        batch NOW and return ``(result, done_s)`` with ``done_s`` read
        from ``clock`` at completion.

        Default: delegate to :meth:`execute` with the current wall time
        as the dispatch stamp and re-stamp completion from the clock —
        correct for stub/virtual targets whose ``execute`` is synchronous;
        real targets override for thread-safe accounting and wall-enforced
        service models."""
        if options is None:
            res, _ = self.execute(queries, k, clock.now(), batch_id)
        else:
            res, _ = self.execute(queries, k, clock.now(), batch_id, options)
        return res, clock.now()

    def prefetch(self, queries: np.ndarray) -> None:
        """Advisory lookahead: the scheduler peeks the requests that will
        form the *next* batch and offers their vectors before running the
        current one, so a target serving host-tier segments can overlap
        their candidate upload with the in-flight batch's compute
        (:meth:`repro_torch.serve.engine.HarmonyServer.prefetch_batch`). A
        wrong or ignored prefetch costs nothing but the hint. Default:
        no-op."""

    # --- skew-adaptation surface -----------------------------------------
    def window_probes(self) -> Iterable[np.ndarray]:
        """Probe arrays of recently executed batches, newest first."""
        raise NotImplementedError

    def refresh_plan(self) -> None:
        raise NotImplementedError

    @property
    def replans(self) -> int:
        raise NotImplementedError

    @property
    def nlist(self) -> int:
        raise NotImplementedError

    @property
    def default_max_batch(self) -> int:
        raise NotImplementedError

    @property
    def default_k(self) -> int:
        raise NotImplementedError

    @property
    def parallelism(self) -> int:
        """Batches the target can genuinely overlap on a real clock (the
        live front-end's default in-flight bound). 1 for a single
        server; the fleet reports its live replica count."""
        return 1


class SingleServerTarget(DispatchTarget):
    """One ``HarmonyServer`` behind the queue — the pre-fleet behaviour.

    Hedging here is *intra*-server: one worker slot per cluster node, the
    primary rotates over live nodes, and a hedge re-runs the batch on the
    next live node (every node executes the same search primitive, so the
    hedge target's answer is the primary's answer — HARMONY's replica
    layout recomputes visits). The hedge latency model is simulated, so
    it is charged to the virtual clock only; on the real clock
    (``execute_wall``) batches simply run back-to-back and cross-replica
    hedging belongs to the fleet.
    """

    def __init__(
        self,
        server,
        service_time_fn: Optional[Callable[[int], float]] = None,
        latency_fn: Optional[Callable[[int, object], float]] = None,
    ):
        self.server = server
        self.service_time_fn = service_time_fn
        self.latency_fn = latency_fn
        self.stats = server.stats
        self.device = getattr(server, "device", None)
        self.busy_until = 0.0
        self._backend = ""
        self._hedge: Optional[HedgingExecutor] = None
        self._wall_mu = threading.Lock()    # serializes wall execution

    def configure(self, cfg: SchedulerConfig, k: int) -> None:
        self._backend = cfg.backend
        if (cfg.backend or getattr(self.server, "backend", "host")) == "spmd":
            # pre-build the executors' bucket ladders (one per sealed
            # segment) so no in-trace dispatch charges a step build to
            # the virtual clock (which would distort queue-wait/shed
            # statistics by seconds)
            self.server.warmup_executors(k=k)
        if cfg.hedge_deadline_s > 0:
            self._hedge = HedgingExecutor(
                workers=[self._exec_task] * self.server.cluster.n_nodes,
                deadline_s=cfg.hedge_deadline_s,
                latency_fn=self.latency_fn or (lambda w, t: 0.0),
                device=self.device,
            )

    def next_free_s(self) -> float:
        return self.busy_until

    def prefetch(self, queries: np.ndarray) -> None:
        pf = getattr(self.server, "prefetch_batch", None)
        if pf is not None:
            pf(queries)

    def _exec_task(self, task):
        queries, k = task[:2]
        options = task[2] if len(task) > 2 else None
        return self.server.search_batch(
            queries, k, backend=self._backend or None,
            **options_kwargs(options),
        )

    def execute(self, queries, k, dispatch_s, batch_id, options=None):
        stats = self.server.stats
        t0 = time.perf_counter()
        sim_lat = 0.0
        if self._hedge is not None:
            # elastic scale-up (join_node) grows the cluster after init;
            # keep one worker slot per node so live indices stay valid
            while len(self._hedge.workers) < self.server.cluster.n_nodes:
                self._hedge.workers.append(self._exec_task)
            live = self.server.cluster.live_ids()
            primary = int(live[batch_id % len(live)])
            replica = (
                int(live[(batch_id + 1) % len(live)]) if len(live) > 1 else None
            )
            hedged_before = self._hedge.stats.hedged
            task = (queries, k) if options is None else (queries, k, options)
            res, _, sim_lat = self._hedge.run_timed(task, primary, replica)
            if self._hedge.stats.hedged > hedged_before:
                stats.hedged_batches += 1
        else:
            res = self.server.search_batch(
                queries, k, backend=self._backend or None,
                **options_kwargs(options),
            )
        wall = time.perf_counter() - t0
        service_s = (
            self.service_time_fn(queries.shape[0])
            if self.service_time_fn
            else wall
        ) + sim_lat
        self.busy_until = dispatch_s + service_s
        return res, self.busy_until

    def execute_wall(self, queries, k, batch_id, clock: Clock, options=None):
        """Wall-clock execution: one batch at a time on the server (the
        lock keeps ``ServeStats`` counters exact when the front-end is
        configured with in-flight > 1). With an injected
        ``service_time_fn`` the wall is padded by sleeping the shortfall —
        the real-clock analogue of the virtual service model (models a
        remote replica whose service time exceeds local compute)."""
        with self._wall_mu:
            t0 = clock.now()
            res = self.server.search_batch(
                queries, k, backend=self._backend or None,
                **options_kwargs(options),
            )
            if self.service_time_fn is not None:
                clock.sleep(
                    self.service_time_fn(queries.shape[0])
                    - (clock.now() - t0)
                )
            done_s = clock.now()
            self.busy_until = done_s
        return res, done_s

    # --- mutable-data-plane surface (DataPlane mixin): writes forward to
    # the server, whose own _note_write does the counting
    def _data_plane(self):
        return self.server

    # --- skew-adaptation surface -----------------------------------------
    def window_probes(self):
        # snapshot (newest first): with in-flight > 1 on the wall clock a
        # concurrent search_batch may append while the skew check iterates
        return list(self.server._recent_probes)[::-1]

    def refresh_plan(self):
        self.server.refresh_plan()

    @property
    def replans(self) -> int:
        return self.server.stats.replans

    @property
    def nlist(self) -> int:
        return self.server.index.nlist

    @property
    def default_max_batch(self) -> int:
        return self.server.cfg.query_block

    @property
    def default_k(self) -> int:
        return self.server.cfg.topk


class SkewMonitor:
    """Hot-mass drift detector behind the scheduler's skew adaptation.

    Tracks the workload concentration the current plan was built for and
    asks the target to re-plan when the live window drifts past
    ``cfg.replan_drift``. Factored out of ``ServingScheduler`` so the
    real-clock front-end reuses the identical trigger logic (pure code
    motion — the virtual-clock goldens pin its behaviour).
    """

    def __init__(self, cfg: SchedulerConfig, target: DispatchTarget):
        self.cfg = cfg
        self.target = target
        self.batches_since_replan = 0
        # skew baseline: hot-mass of the workload the current plan was
        # built for (set lazily; re-synced after ANY re-plan, including
        # fail_node / replan_every ones done behind the scheduler's back)
        self._plan_hot: Optional[float] = None
        self._seen_replans = target.replans

    def _window_hot_mass(self) -> Optional[float]:
        # walk the probe history from the newest batch back, taking only
        # enough arrays to cover the window (not the whole history)
        take, rows = [], 0
        for p in self.target.window_probes():
            take.append(p)
            rows += p.shape[0]
            if rows >= self.cfg.skew_window:
                break
        if not take:
            return None
        window = np.concatenate(take[::-1], axis=0)[-self.cfg.skew_window:]
        hits = estimate_cluster_hits(window, self.target.nlist)
        return workload_concentration(hits, self.cfg.hot_fraction)

    def after_batch(self) -> bool:
        """Account one dispatched batch; re-plan (and return True) if the
        live window's hot-mass drifted past the threshold."""
        self.batches_since_replan += 1
        if self.cfg.replan_drift <= 0:
            return False
        if self.target.replans != self._seen_replans:
            # the plan was rebuilt elsewhere (fail_node, replan_every):
            # re-baseline on the window that plan saw
            self._seen_replans = self.target.replans
            self._plan_hot = self._window_hot_mass()
            self.batches_since_replan = 0
            return False
        if self._plan_hot is None:
            # the initial plan was built from a uniform workload prior
            self._plan_hot = workload_concentration(
                np.ones(self.target.nlist), self.cfg.hot_fraction
            )
        if self.batches_since_replan < self.cfg.min_batches_between_replans:
            return False
        hot = self._window_hot_mass()
        if hot is None:
            return False
        if abs(hot - self._plan_hot) > self.cfg.replan_drift:
            self.target.refresh_plan()
            self.target.stats.skew_replans += 1
            self._plan_hot = hot
            self._seen_replans = self.target.replans
            self.batches_since_replan = 0
            return True
        return False


def next_fire(
    queue: "Deque[Request]",
    cfg: SchedulerConfig,
    max_batch: int,
    target_free_s: float,
) -> Tuple[float, str]:
    """Batch-forming policy: the earliest time the queued requests can
    dispatch, and why (``"full"`` size trigger, ``"deadline"`` oldest-wait
    trigger, or ``"capacity"`` bounded-queue early fire). Shared verbatim
    by the virtual-clock scheduler and the real-clock front-end."""
    if len(queue) >= max_batch:
        ready = queue[max_batch - 1].arrival_s
        trigger = "full"
    else:
        ready = queue[0].arrival_s + cfg.max_wait_s
        trigger = "deadline"
        if (cfg.queue_capacity
                and len(queue) >= cfg.queue_capacity
                and queue[-1].arrival_s < ready):
            # queue at its bound with the size trigger unreachable:
            # fire as soon as the target frees up instead of shedding
            # behind an idle server until the deadline
            ready = queue[-1].arrival_s
            trigger = "capacity"
    return max(ready, target_free_s), trigger


class ServingScheduler:
    """Admission-controlled adaptive batcher over a dispatch target
    (virtual-clock replay — the deterministic harness; for live traffic
    use :class:`repro_torch.serve.frontend.ServingFrontend`).

    The first argument is either a ``HarmonyServer`` (wrapped in a
    :class:`SingleServerTarget`) or any :class:`DispatchTarget` — in
    particular a :class:`repro_torch.serve.fleet.ReplicaFleet`.

    Usage: either drive it incrementally (``submit`` per arrival, then
    ``flush``) or replay a whole trace with :meth:`run_trace`. Arrival
    timestamps must be non-decreasing. ``on_batch(batch_idx, scheduler)``
    is invoked after every dispatched batch — tests use it to kill nodes
    or replicas mid-stream (the elastic invariant extends to scheduled
    serving).

    >>> import numpy as np
    >>> from repro_torch.config import HarmonyConfig
    >>> from repro_torch.core import build_ivf
    >>> from repro_torch.serve import HarmonyServer
    >>> rng = np.random.default_rng(0)
    >>> x = rng.standard_normal((256, 8)).astype(np.float32)
    >>> cfg = HarmonyConfig(dim=8, nlist=4, nprobe=2, topk=3,
    ...                     kmeans_iters=2)
    >>> srv = HarmonyServer(build_ivf(x, cfg, device="cpu"), n_nodes=2,
    ...                     device="cpu")
    >>> sched = ServingScheduler(srv, SchedulerConfig(max_batch=8), k=3)
    >>> trace = [(i * 1e-4, x[i]) for i in range(16)]   # replayed arrivals
    >>> results = sched.run_trace(trace)
    >>> len(results), results[0].ids.shape
    (16, (3,))
    >>> srv.stats.full_batches        # 16 requests → two size-8 batches
    2
    """

    def __init__(
        self,
        server,
        cfg: Optional[SchedulerConfig] = None,
        k: Optional[int] = None,
        service_time_fn: Optional[Callable[[int], float]] = None,
        latency_fn: Optional[Callable[[int, object], float]] = None,
        on_batch: Optional[Callable[[int, "ServingScheduler"], None]] = None,
        clock: Optional[VirtualClock] = None,
    ):
        self.cfg = cfg or SchedulerConfig()
        if isinstance(server, DispatchTarget):
            if service_time_fn is not None or latency_fn is not None:
                raise ValueError(
                    "service_time_fn/latency_fn belong to the target when "
                    "a DispatchTarget is passed (construct it with them)"
                )
            self.target = server
        else:
            self.target = SingleServerTarget(
                server, service_time_fn=service_time_fn, latency_fn=latency_fn
            )
        # back-compat alias: the single server, or the target itself
        self.server = getattr(self.target, "server", self.target)
        self.stats = self.target.stats
        self.clock = clock or VirtualClock()
        self.k = k or self.target.default_k
        self.max_batch = self.cfg.max_batch or self.target.default_max_batch
        assert self.max_batch >= 1
        self.on_batch = on_batch
        self.queue: Deque[Request] = deque()
        self.done: List[RequestResult] = []
        self.busy_until = 0.0           # last completion seen (makespan end)
        self.first_arrival_s: Optional[float] = None
        self._next_id = 0
        self._batch_id = 0
        self.target.configure(self.cfg, self.k)
        self._skew = SkewMonitor(self.cfg, self.target)
        # semantic cache + in-batch coalescing (inert when cfg.cache is
        # None/disabled — the goldens pin byte-identity of that default)
        self.cache = build_query_cache(self.cfg, self.target, self.stats)
        self._coalesce = self.cache is not None and self.cfg.cache.coalesce

    @property
    def _hedge(self) -> Optional[HedgingExecutor]:
        # back-compat: tests/examples inspect sched._hedge.stats
        return getattr(self.target, "_hedge", None)

    # ---------------------------------------------------------------- admit
    def submit(self, query, arrival_s: Optional[float] = None,
               _warn: bool = True) -> int:
        """Offer one request at virtual time ``arrival_s`` (default: the
        clock's current time). Returns its req_id, or -1 if shed by
        backpressure. Fires any batches due before ``arrival_s`` first.

        ``query`` is a :class:`repro_torch.core.SearchRequest` (the canonical
        shape — its filter/hybrid/precision/k ride with the request) or a
        bare [D] array, which is auto-wrapped with a
        ``DeprecationWarning`` (``_warn=False`` silences the shim for
        internal wrappers that already own the old surface).

        req_ids are consumed by shed requests too, so a served request's
        req_id is always its submission (trace) position — results map
        back to the trace even after shedding."""
        if isinstance(query, SearchRequest):
            req_k, req_flt = query.k, query.filter
            req_text, req_prec = query.hybrid_text, query.precision
            req_dl = query.deadline
            query = query.vector
        else:
            if _warn:
                warnings.warn(
                    "submitting a bare ndarray is deprecated; pass a "
                    "repro_torch.core.SearchRequest",
                    DeprecationWarning, stacklevel=2,
                )
            req_k = req_flt = req_text = req_prec = req_dl = None
        if arrival_s is None:
            arrival_s = self.clock.now()
        self.advance(arrival_s)
        stats = self.stats
        stats.offered += 1
        rid = self._next_id
        self._next_id += 1
        if self.first_arrival_s is None:
            self.first_arrival_s = arrival_s
        query = np.asarray(query)
        # per-request deadline already blown at submission: answer with
        # the sentinel degradation path, never queue dead work —
        # checked before the cache so even a cached answer is refused
        if req_dl is not None and arrival_s > req_dl:
            stats.expired_requests += 1
            self.busy_until = max(self.busy_until, arrival_s)
            self._sentinel(rid, req_k or self.k, arrival_s, arrival_s,
                           arrival_s, batch_id=-1)
            return rid
        if self.cache is not None:
            k_r = req_k or self.k
            hit = self.cache.lookup(
                query, k_r, (req_flt, req_text, req_prec), arrival_s
            )
            if hit is not None:
                # served at arrival: no queueing, no shedding, no batch
                self.busy_until = max(self.busy_until, arrival_s)
                stats.queue_wait_ms.append(0.0)
                stats.request_latency_ms.append(0.0)
                self.done.append(RequestResult(
                    req_id=rid, ids=hit.ids, scores=hit.scores,
                    arrival_s=arrival_s, dispatch_s=arrival_s,
                    done_s=arrival_s, batch_id=-1,
                ))
                return rid
        if self.cfg.queue_capacity and len(self.queue) >= self.cfg.queue_capacity:
            stats.shed += 1
            return -1
        self.queue.append(Request(
            rid, query, arrival_s,
            k=req_k, filter=req_flt, hybrid_text=req_text, precision=req_prec,
            deadline=req_dl,
        ))
        stats.admitted += 1
        return rid

    def _sentinel(self, rid: int, k: int, arrival_s: float, dispatch_s: float,
                  done_s: float, batch_id: int) -> None:
        """Append a degraded (ids -1, +inf scores) result for a request
        answered without execution — the sentinel shape."""
        self.done.append(RequestResult(
            req_id=rid,
            ids=np.full(k, -1, np.int64),
            scores=np.full(k, np.inf, np.float32),
            arrival_s=arrival_s, dispatch_s=dispatch_s, done_s=done_s,
            batch_id=batch_id,
        ))

    # ------------------------------------------------------------ batch form
    def _next_fire(self) -> Tuple[float, str]:
        """(virtual time at which the next batch can dispatch, trigger)."""
        return next_fire(
            self.queue, self.cfg, self.max_batch, self.target.next_free_s()
        )

    def advance(self, now: float):
        """Move the virtual clock to ``now``, firing every batch whose
        dispatch time is ≤ ``now``."""
        self.clock.advance_to(now)
        while self.queue:
            dispatch_s, trigger = self._next_fire()
            if dispatch_s > now:
                break
            self._dispatch(dispatch_s, trigger)

    def flush(self) -> List[RequestResult]:
        """Drain the queue (deadlines fire naturally on the virtual clock)
        and return all results in request order."""
        self.advance(math.inf)
        return sorted(self.done, key=lambda r: r.req_id)

    # -------------------------------------------------------------- dispatch
    def _dispatch(self, dispatch_s: float, trigger: str):
        batch = [self.queue.popleft()
                 for _ in range(min(len(self.queue), self.max_batch))]
        stats = self.stats
        # per-request deadline enforcement at dispatch: a request whose
        # absolute deadline passed while it queued is answered with the
        # sentinel degradation path, never executed
        expired = [req for req in batch
                   if req.deadline is not None and dispatch_s > req.deadline]
        if expired:
            stats.expired_requests += len(expired)
            for req in expired:
                self._sentinel(req.req_id, req.k or self.k, req.arrival_s,
                               dispatch_s, dispatch_s, self._batch_id)
            gone = {req.req_id for req in expired}
            batch = [req for req in batch if req.req_id not in gone]
            if not batch:
                # nothing left to execute: mirror the failed-batch path —
                # the batch id is consumed, no trigger/skew accounting
                self._batch_id += 1
                if self.on_batch is not None:
                    self.on_batch(self._batch_id - 1, self)
                return
        # partition the formed batch by request options: each group shares
        # one (k, filter, hybrid_text, precision) execution context. A
        # knob-free batch is exactly one group with key None and one
        # positional target.execute call — byte-identical to the
        # pre-request-API scheduler (the virtual-clock goldens pin this).
        groups: Dict[Optional[tuple], List[int]] = {}
        for row, req in enumerate(batch):
            groups.setdefault(req.options_key(), []).append(row)
        # in-batch coalescing: duplicate vectors inside one options group
        # execute once; the answer fans out to every duplicate row. The
        # virtual-clock twin of the front-end's in-flight coalescing —
        # deterministic, so replay harnesses exercise it.
        plans: Dict[Optional[tuple], Tuple[List[int], List[int]]] = {}
        for key, rows in groups.items():
            if self._coalesce:
                seen: Dict[bytes, int] = {}
                exec_rows: List[int] = []
                assign: List[int] = []
                for r in rows:
                    b = vec_bytes(batch[r].query)
                    j = seen.get(b)
                    if j is None:
                        j = len(exec_rows)
                        seen[b] = j
                        exec_rows.append(r)
                    else:
                        stats.coalesced += 1
                    assign.append(j)
                plans[key] = (exec_rows, assign)
            else:
                plans[key] = (rows, list(range(len(rows))))

        # lookahead prefetch: the requests still queued behind this batch
        # are (up to deadline expiry) exactly the next formed batch — hand
        # their knob-free vectors to the target *before* executing, so a
        # host-tier candidate upload can overlap this batch's compute.
        # Coalescing is mirrored so the predicted query block matches the
        # one the next dispatch will actually stack. Purely advisory.
        if self.queue:
            pf_seen: set = set()
            pf_qs = []
            for req in list(self.queue)[: self.max_batch]:
                if req.options_key() is not None:
                    continue
                b = vec_bytes(req.query)
                if self._coalesce and b in pf_seen:
                    continue
                pf_seen.add(b)
                pf_qs.append(req.query)
            if pf_qs:
                pf = getattr(self.target, "prefetch", None)
                if pf is not None:
                    pf(np.stack(pf_qs))

        def _run(eff_dispatch_s):
            row_ids = [None] * len(batch)
            row_scores = [None] * len(batch)
            g_done_max = eff_dispatch_s
            for key, rows in groups.items():
                exec_rows, assign = plans[key]
                queries = np.stack([batch[r].query for r in exec_rows])
                if key is None:
                    res, g_done = self.target.execute(
                        queries, self.k, eff_dispatch_s, self._batch_id
                    )
                else:
                    res, g_done = self.target.execute(
                        queries, key[0] or self.k, eff_dispatch_s,
                        self._batch_id, key[1:],
                    )
                g_done_max = max(g_done_max, g_done)
                for i, r in zip(assign, rows):
                    row_ids[r] = res.ids[i]
                    row_scores[r] = res.scores[i]
            return row_ids, row_scores, g_done_max

        # epoch read before execution: entries inserted from this batch
        # are stamped pre-execute, so a write landing mid-batch makes
        # them count as already-stale (conservative)
        pre_epoch = self.cache.epoch() if self.cache is not None else None
        # bounded retry of the (idempotent) batch: each re-issue charges
        # its backoff to the virtual clock via a later dispatch stamp
        eff_dispatch_s = dispatch_s
        err: Optional[BaseException] = None
        row_ids = row_scores = done_s = None
        for attempt in range(self.cfg.max_retries + 1):
            try:
                row_ids, row_scores, done_s = _run(eff_dispatch_s)
                err = None
                break
            except Exception as e:  # noqa: BLE001 - bounded retry below
                if is_device_fault(e):
                    raise       # a faulted card is not retried or degraded
                err = e
                if attempt >= self.cfg.max_retries:
                    break
                backoff = self.cfg.retry_backoff_s * (attempt + 1)
                if (self.cfg.request_deadline_s > 0
                        and (eff_dispatch_s + backoff - batch[0].arrival_s)
                        > self.cfg.request_deadline_s):
                    break       # deadline budget spent: fail now, not later
                stats.retried_batches += 1
                eff_dispatch_s += backoff
        if err is not None:
            if self.cfg.max_retries == 0:
                raise err       # resilience off: the failure propagates
            # degrade: answer the batch with sentinel results so the
            # trace keeps replaying (availability over completeness)
            stats.failed_batches += 1
            stats.failed_requests += len(batch)
            for req in batch:
                k_r = req.k or self.k
                self.done.append(RequestResult(
                    req_id=req.req_id,
                    ids=np.full(k_r, -1, np.int64),
                    scores=np.full(k_r, np.inf, np.float32),
                    arrival_s=req.arrival_s,
                    dispatch_s=dispatch_s,
                    done_s=eff_dispatch_s,
                    batch_id=self._batch_id,
                ))
            self._batch_id += 1
            if self.on_batch is not None:
                self.on_batch(self._batch_id - 1, self)
            return
        self.busy_until = max(self.busy_until, done_s)
        if self.cache is not None:
            for key, rows in groups.items():
                k_g = (key[0] or self.k) if key is not None else self.k
                options = key[1:] if key is not None else (None, None, None)
                for r in plans[key][0]:     # unique executed rows only
                    self.cache.insert(
                        batch[r].query, k_g, options,
                        row_ids[r], row_scores[r], done_s, epoch=pre_epoch,
                    )

        if trigger == "full":
            stats.full_batches += 1
        elif trigger == "capacity":
            stats.capacity_batches += 1
        else:
            stats.deadline_batches += 1
        for row, req in enumerate(batch):
            stats.queue_wait_ms.append((dispatch_s - req.arrival_s) * 1e3)
            stats.request_latency_ms.append((done_s - req.arrival_s) * 1e3)
            self.done.append(
                RequestResult(
                    req_id=req.req_id,
                    ids=row_ids[row],
                    scores=row_scores[row],
                    arrival_s=req.arrival_s,
                    dispatch_s=dispatch_s,
                    done_s=done_s,
                    batch_id=self._batch_id,
                )
            )
        self._batch_id += 1
        self._skew.after_batch()
        if self.on_batch is not None:
            self.on_batch(self._batch_id - 1, self)

    # ---------------------------------------------------------------- replay
    def run_trace(
        self, trace: Sequence[Tuple[float, np.ndarray]]
    ) -> List[RequestResult]:
        """Replay a whole (arrival_s, query)-trace and drain. Trace
        queries are :class:`repro_torch.core.SearchRequest` objects or bare [D]
        arrays (deprecated — auto-wrapped, see :meth:`submit`). Returns
        served results ordered by req_id; shed requests have no result
        (compare ``stats.shed``)."""
        for arrival_s, q in trace:
            self.submit(q, arrival_s)
        return self.flush()

    # ------------------------------------------------------------- reporting
    @property
    def makespan_s(self) -> float:
        """First arrival → last completion on the virtual clock."""
        if self.first_arrival_s is None:
            return 0.0
        return max(self.busy_until - self.first_arrival_s, 0.0)

    @property
    def served_qps(self) -> float:
        """Served requests per second of makespan (virtual wall)."""
        return len(self.done) / self.makespan_s if self.makespan_s > 0 else 0.0
