"""Multi-replica serving fleet: load-aware routing over several
``HarmonyServer`` replicas behind one admission queue.

This is the scale-*out* rung of the serving stack: the admission queue
forms batches, the executor serves them on the card — the fleet stands N
full server replicas (spmd or host backend, heterogeneous capacities
allowed) behind that same queue and *routes* each formed batch,
BatANN-style, instead of pinning everything to one server. Every replica
serves the one shared data plane on the fleet's ``device``; on one card
the replicas share it, each with executors of its own.

Routing is load-estimate driven. Each replica carries

* **backlog** — outstanding work in queue-seconds (``busy_until`` minus
  the dispatch time on the virtual clock);
* **service estimate** — an EWMA of observed per-query service time,
  seeded from the §4.2.1 cost model of the replica's own plan (so a
  replica is routable before its first batch, and a slow/spmd/low-capacity
  replica is predicted slow from its plan cost, not discovered slow);
* **capacity weight** — relative speed of heterogeneous replicas.

Policies: ``"p2c"`` (power-of-two-choices: sample two live replicas,
dispatch to the less loaded — the classic lowest-variance scalable
policy), ``"least_loaded"`` (global argmin), ``"round_robin"`` (the
baseline the load-balance Gini is benchmarked against).

Cross-replica hedging: with a hedge deadline set, dispatch goes through
:meth:`repro_torch.runtime.straggler.HedgingExecutor.run_ranked` over the
fleet's load ranking — a hedge re-runs the batch on the
*second-least-loaded replica*, not just another node of the same server.
Every replica serves the full corpus, so the hedge answer equals the
primary answer (result parity is tested).

Elasticity rides the existing :class:`repro_torch.runtime.elastic.ClusterState`
machinery at replica granularity: ``fail_replica`` removes a replica from
routing (in-flight virtual work still completes — no admitted request is
lost), ``join_replica`` stands up a new server mid-trace.

Per-replica plans stay independent: each server keeps its own workload
window and re-plans from *its* observed probes (skew re-planning can
diverge per replica, the SPFresh-style accuracy-preserving property —
results are plan-invariant by the exactness guarantee).

Clocks: behind :class:`repro_torch.serve.scheduler.ServingScheduler` the fleet
runs the deterministic virtual-clock replay (``execute``); behind
:class:`repro_torch.serve.frontend.ServingFrontend` it executes for real
(``execute_wall``) — replicas genuinely overlap on a thread pool, with
per-replica locks serializing same-replica batches and all load/EWMA
accounting made atomic (``_record_service``).
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Deque, List, Optional, Sequence, Union

import numpy as np

from repro_torch._device import DeviceLike, is_device_fault, resolve_device
from repro_torch.core.index import SegmentedIndex
from repro_torch.runtime.elastic import ClusterState
from repro_torch.runtime.faults import fault_point
from repro_torch.runtime.straggler import HedgingExecutor
from repro_torch.serve.clock import Clock
from repro_torch.serve.engine import HarmonyServer, ServeStats
from repro_torch.serve.scheduler import DispatchTarget, SchedulerConfig, options_kwargs


def gini(x: Sequence[float]) -> float:
    """Gini coefficient of a non-negative load vector (0 = perfectly
    balanced, →1 = all load on one replica)."""
    x = np.sort(np.asarray(x, np.float64))
    n = x.size
    if n == 0 or x.sum() <= 0:
        return 0.0
    cum = np.cumsum(x)
    return float((n + 1 - 2 * (cum / cum[-1]).sum()) / n)


@dataclass(frozen=True)
class ReplicaSpec:
    """How to stand up one replica. ``backend`` defaults to ``"spmd"``, as
    ``HarmonyServer``'s does in the port (the reference's is ``"host"``)."""

    backend: str = "spmd"           # "spmd" | "host"
    capacity: float = 1.0           # relative speed weight (2.0 = 2× faster)
    n_nodes: int = 4                # nodes inside the replica's own cluster
    replan_every: int = 0
    executor_cfg: Optional[object] = None   # ExecutorConfig for spmd


@dataclass
class Replica:
    """One server plus its fleet-side routing state.

    Times are **seconds** on whichever clock drives the fleet (virtual
    replay or the live front-end's wall clock); ``service_ms`` is
    **milliseconds** per served batch. ``lock`` serializes wall-clock
    execution on this replica — two batches routed to the same replica
    queue behind it while other replicas run concurrently."""

    server: HarmonyServer
    spec: ReplicaSpec
    busy_until: float = 0.0         # time (s) its dispatch queue drains
    busy_s: float = 0.0             # total service seconds
    batches: int = 0
    queries: int = 0
    failures: int = 0               # batches this replica raised on
    consec_failures: int = 0        # current run of failures (resets on success)
    # circuit breaker: None = closed (routable); a time = open until then
    # (ejected from routing), after which the replica is *half-open* — the
    # next health probe or trial batch decides close vs re-open
    open_until: Optional[float] = None
    ewma_per_q_s: Optional[float] = None
    service_ms: List[float] = field(default_factory=list)
    lock: threading.Lock = field(default_factory=threading.Lock, repr=False)
    # wall-clock mode only: predicted service-seconds of batches dispatched
    # to this replica but not yet completed. On the virtual clock execution
    # is inline, so busy_until always carries the backlog and this stays 0;
    # on the real clock busy_until is stale while a batch runs, and without
    # this term the router would pile every batch onto the same "idle"
    # replica (they'd serialize on its lock).
    inflight_s: float = 0.0

    def predict_service_s(
        self, n_queries: int, fleet_per_q_s: Optional[float] = None
    ) -> float:
        """Expected service seconds for a batch of ``n_queries``.

        Uses the replica's own EWMA blended 50/50 with the fleet-wide
        capacity-normalized EWMA (``fleet_per_q_s``, already divided by
        this replica's capacity by the caller). The blend matters: a
        replica's own EWMA only updates when it serves, so one noisy-slow
        observation would otherwise self-reinforce into starvation —
        anchoring on the fleet mean (heterogeneity carried by the known
        capacity weight) keeps every replica routable. Before any
        observation, falls back to the cost model of this replica's own
        plan (comp+comm per query, scaled by capacity)."""
        if self.ewma_per_q_s is not None:
            own = self.ewma_per_q_s
            if fleet_per_q_s is not None:
                return 0.5 * (own + fleet_per_q_s) * n_queries
            return own * n_queries
        if fleet_per_q_s is not None:
            return fleet_per_q_s * n_queries
        # cost-model seed: the plan's comp+comm is costed for a uniform
        # one-query-per-cluster prior; a real query touches nprobe of
        # nlist clusters, so scale by the probe fraction
        cost = self.server._plan_decision.cost
        frac = self.server.cfg.nprobe / max(self.server.index.nlist, 1)
        per_q = (cost["comp_s"] + cost["comm_s"]) * frac
        return per_q * n_queries / max(self.spec.capacity, 1e-9)


class ReplicaFleet(DispatchTarget):
    """N ``HarmonyServer`` replicas behind one admission queue.

    Drop-in :class:`DispatchTarget`: hand it to ``ServingScheduler`` in
    place of a server and every formed batch is routed by load estimate.

    ``service_time_fn(replica_idx, n_queries) -> seconds`` replaces the
    measured wall on the virtual clock (tests inject deterministic and
    heterogeneous service models); the default charges the measured
    ``search_batch`` wall divided by the replica's capacity weight.
    ``latency_fn(replica_idx, task)`` overrides the hedge's effective-
    latency model (default: the fleet's own load estimate). ``device``
    (CUDA by default) is the card every replica serves on; the data
    plane must live there.

    >>> import numpy as np
    >>> from repro_torch.config import HarmonyConfig
    >>> from repro_torch.core import build_ivf
    >>> from repro_torch.serve import SchedulerConfig, ServingScheduler
    >>> rng = np.random.default_rng(0)
    >>> x = rng.standard_normal((256, 8)).astype(np.float32)
    >>> cfg = HarmonyConfig(dim=8, nlist=4, nprobe=2, topk=3,
    ...                     kmeans_iters=2)
    >>> fleet = ReplicaFleet(build_ivf(x, cfg, device="cpu"), replicas=2,
    ...                      cfg=cfg, service_time_fn=lambda r, n: n * 1e-3,
    ...                      seed=0, device="cpu")
    >>> sched = ServingScheduler(fleet, SchedulerConfig(max_batch=8), k=3)
    >>> results = sched.run_trace([(i * 1e-5, x[i]) for i in range(32)])
    >>> len(results), sum(r.batches for r in fleet.replicas)
    (32, 4)
    >>> sum(1 for r in fleet.replicas if r.batches > 0) > 1  # spread out
    True
    """

    def __init__(
        self,
        index,
        replicas: Union[int, Sequence[ReplicaSpec]] = 2,
        cfg=None,
        routing: str = "p2c",
        ewma_alpha: float = 0.25,
        service_time_fn: Optional[Callable[[int, int], float]] = None,
        latency_fn: Optional[Callable[[int, object], float]] = None,
        workload_window: int = 2048,
        seed: int = 0,
        breaker_threshold: int = 3,
        breaker_cooldown_s: float = 1.0,
        device: DeviceLike = None,
    ):
        if routing not in ("p2c", "least_loaded", "round_robin"):
            raise ValueError(f"routing={routing!r}")
        if isinstance(replicas, int):
            replicas = [ReplicaSpec() for _ in range(replicas)]
        if not replicas:
            raise ValueError("a fleet needs at least one replica")
        # one shared mutable data plane for the whole fleet: every replica
        # (including ones that join mid-trace) serves the same
        # SegmentedIndex object, so upserts/deletes/compaction commits are
        # visible fleet-wide and a joiner adopts the *current* segment
        # generation, never the boot-time index
        self.device = resolve_device(device)
        self.index = (
            index if isinstance(index, SegmentedIndex)
            else SegmentedIndex.from_static(index)
        )
        self.cfg = cfg or self.index.cfg
        self.routing = routing
        self.ewma_alpha = ewma_alpha
        self.service_time_fn = service_time_fn
        self.latency_fn = latency_fn
        # consecutive failures that trip a replica's circuit breaker
        # (0 disables breakers entirely) and how long it then sits out
        # of routing before a half-open health probe may readmit it
        self.breaker_threshold = breaker_threshold
        self.breaker_cooldown_s = breaker_cooldown_s
        self._breaker_active = 0        # replicas with open_until set
        self.replicas: List[Replica] = [
            Replica(self._make_server(spec), spec) for spec in replicas
        ]
        self.cluster = ClusterState.fresh(len(self.replicas))
        self.stats = ServeStats()       # fleet-level admission accounting
        self._recent_probes: Deque[np.ndarray] = deque(maxlen=workload_window)
        self._rng = np.random.default_rng(seed)
        self._rr = 0
        self._backend = ""
        self._k = self.cfg.topk
        self._hedge: Optional[HedgingExecutor] = None
        self._last_done_s = 0.0
        self._last_start_s = 0.0
        # fleet-wide EWMA of capacity-normalized per-query service time
        # (the anchor every replica's load estimate blends against)
        self._fleet_ewma_norm_per_q: Optional[float] = None
        # guards routing state (busy_until, EWMAs, rng, probes window) so
        # the real-clock front-end can dispatch to replicas from a thread
        # pool; uncontended (hence free) on the single-threaded virtual path
        self._mu = threading.Lock()

    def _make_server(self, spec: ReplicaSpec) -> HarmonyServer:
        return HarmonyServer(
            self.index,
            n_nodes=spec.n_nodes,
            cfg=self.cfg,
            replan_every=spec.replan_every,
            backend=spec.backend,
            executor_cfg=spec.executor_cfg,
            device=self.device,
        )

    # ------------------------------------------------------ DispatchTarget
    def configure(self, cfg: SchedulerConfig, k: int) -> None:
        self._backend = cfg.backend
        self._k = k
        for rep in self.replicas:
            self._warmup_replica(rep)
        if cfg.hedge_deadline_s > 0:
            self._hedge = HedgingExecutor(
                workers=[self._make_worker(i) for i in range(len(self.replicas))],
                deadline_s=cfg.hedge_deadline_s,
                latency_fn=self.latency_fn or self._estimate_latency,
                device=self.device,
            )

    def _warmup_replica(self, rep: Replica) -> None:
        if (self._backend or rep.server.backend) == "spmd":
            rep.server.warmup_executors(k=self._k)

    # ------------------------------------------------- mutable data plane
    @property
    def data(self):
        """The fleet-shared :class:`repro_torch.core.SegmentedIndex`."""
        return self.index

    # upsert()/delete() come from the DataPlane mixin: one write to the
    # shared data plane — every replica's next batch sees it
    def _data_plane(self):
        return self.index

    def _note_write(self, kind: str, n: int) -> None:
        with self._mu:
            if kind == "upsert":
                self.stats.upserts += n
            else:
                self.stats.deletes += n

    def live_servers(self):
        """Servers of the live replicas (the compactor's swap targets)."""
        return [self.replicas[int(i)].server for i in self.cluster.live_ids()]

    def next_free_s(self) -> float:
        live = self.cluster.live_ids()
        if live.size == 0:
            raise RuntimeError("no live replicas")
        frees = [self.replicas[int(i)].busy_until for i in live
                 if self.replicas[int(i)].open_until is None]
        if not frees:       # every breaker open: fail open, don't stall
            frees = [self.replicas[int(i)].busy_until for i in live]
        return min(frees)

    def execute(self, queries, k, dispatch_s, batch_id, options=None):
        if self._breaker_active:
            self.health_check(dispatch_s)
        ranked = self._rank_replicas(queries.shape[0], dispatch_s, batch_id)
        last_err = None
        for attempt, r_idx in enumerate(ranked):
            try:
                if attempt == 0 and self._hedge is not None:
                    hedged_before = self._hedge.stats.hedged
                    res, served_by, _ = self._hedge.run_ranked(
                        (queries, k, dispatch_s, options), ranked
                    )
                    if self._hedge.stats.hedged > hedged_before:
                        self.stats.hedged_batches += 1
                        if served_by != ranked[0]:
                            # the hedge target only received the batch when
                            # the deadline expired — its execution cannot
                            # have started before dispatch+deadline; charge
                            # the hedge wait to the virtual clock (the
                            # fleet's latency_fn is the hedge *decision*
                            # model, so unlike the single-server target it
                            # is never added to service time — real time
                            # lives in busy_until/service accounting)
                            shift = (dispatch_s + self._hedge.deadline_s
                                     - self._last_start_s)
                            if shift > 0:
                                self.replicas[served_by].busy_until += shift
                                self._last_done_s += shift
                else:
                    res = self._run_on(r_idx, queries, k, dispatch_s, options)
                return res, self._last_done_s
            except Exception as e:  # noqa: BLE001 - retried on next replica
                if is_device_fault(e):
                    raise       # every replica shares the faulted card
                last_err = e
                if attempt + 1 < len(ranked):
                    self.stats.retried_batches += 1
        raise last_err

    def execute_wall(self, queries, k, batch_id, clock: Clock, options=None):
        """Real-clock dispatch for the live front-end: route by the same
        load estimates (``clock.now()`` as "now"), then actually run the
        batch on the chosen replica — concurrently with batches other
        worker threads are running on *other* replicas. With a hedge
        deadline configured, dispatch goes through
        :meth:`repro_torch.runtime.straggler.HedgingExecutor.run_ranked_wall`:
        the primary really runs, and if it misses the deadline the batch
        is re-issued to the least-loaded other replica, first result
        wins. A replica that *raises* (crash-injected or real) records a
        failure against its breaker and the batch is retried down the
        ranked order — replicas serve the full corpus, so a retried
        answer is the primary answer."""
        if self._breaker_active:
            self.health_check(clock.now())
        n = queries.shape[0]
        with self._mu:
            ranked = self._rank_replicas(n, clock.now(), batch_id)
        last_err = None
        for attempt, r_idx in enumerate(ranked):
            rep = self.replicas[r_idx]
            with self._mu:
                # reserve the predicted service so concurrent dispatches
                # see this replica as loaded while the batch is in flight
                reserve_s = self._predict_service_s(rep, n)
                rep.inflight_s += reserve_s
            try:
                if attempt == 0 and self._hedge is not None and len(ranked) > 1:
                    (res, done_s), served_by, hedge_fired = (
                        self._hedge.run_ranked_wall(
                            (queries, k, clock, options), ranked
                        )
                    )
                    if hedge_fired:
                        with self._mu:
                            self.stats.hedged_batches += 1
                else:
                    res, done_s = self._run_on_wall(
                        r_idx, queries, k, clock, options
                    )
                return res, done_s
            except Exception as e:  # noqa: BLE001 - retried on next replica
                if is_device_fault(e):
                    raise       # every replica shares the faulted card
                last_err = e
                if attempt + 1 < len(ranked):
                    with self._mu:
                        self.stats.retried_batches += 1
            finally:
                with self._mu:
                    rep.inflight_s = max(rep.inflight_s - reserve_s, 0.0)
        raise last_err

    # ------------------------------------------------------------- routing
    def _predict_service_s(self, rep: Replica, n_queries: int) -> float:
        """Predicted service seconds for a batch on ``rep``: the replica's
        own EWMA blended with the capacity-normalized fleet EWMA (cost-
        model seeded before any observation). Single source for both the
        routing estimate and the wall-mode in-flight reservation."""
        fleet_per_q = (
            self._fleet_ewma_norm_per_q / max(rep.spec.capacity, 1e-9)
            if self._fleet_ewma_norm_per_q is not None
            else None
        )
        return rep.predict_service_s(n_queries, fleet_per_q)

    def load_estimate(self, r_idx: int, now: float, n_queries: int) -> float:
        """Queue-seconds this batch would wait-plus-run on replica
        ``r_idx``: outstanding backlog (completed-work horizon plus
        in-flight reservations) + predicted service time."""
        rep = self.replicas[r_idx]
        return (
            max(rep.busy_until - now, 0.0)
            + rep.inflight_s
            + self._predict_service_s(rep, n_queries)
        )

    def _estimate_latency(self, r_idx: int, task) -> float:
        queries, _, dispatch_s = task[:3]
        return self.load_estimate(r_idx, dispatch_s, queries.shape[0])

    def _rank_replicas(self, n: int, now: float, batch_id: int) -> List[int]:
        """Dispatch order: [primary, hedge target, ...rest]. The primary
        follows the routing policy; the hedge target is always the least-
        loaded *other* live replica (so a hedge lands on the second-least-
        loaded replica when the primary is the least-loaded)."""
        live = [int(i) for i in self.cluster.live_ids()]
        if not live:
            raise RuntimeError("no live replicas")
        if len(live) == 1:
            return live
        # circuit breakers: open replicas sit out routing until their
        # cooldown elapses. Fail open — when every live breaker is open,
        # availability beats breaker purity and the full live set routes
        # again. With no breaker active (the fault-free path) this block
        # is skipped entirely, so routing and its rng stream are
        # bit-identical to the breaker-less fleet.
        if self._breaker_active:
            avail = [r for r in live if self._routable(self.replicas[r], now)]
            if not avail:
                avail = live
        else:
            avail = live
        loads = {r: self.load_estimate(r, now, n) for r in live}
        if len(avail) == 1:
            primary = avail[0]
        elif self.routing == "round_robin":
            primary = avail[self._rr % len(avail)]
            self._rr += 1
        elif self.routing == "p2c":
            # capacity-weighted power-of-two-choices: heterogeneous fleets
            # sample fast replicas proportionally more often (plain p2c
            # wastes every slow-slow sample), then the load estimate picks
            # between the two
            caps = np.array([self.replicas[r].spec.capacity for r in avail])
            a, b = self._rng.choice(
                len(avail), size=2, replace=False, p=caps / caps.sum()
            )
            primary = min(avail[int(a)], avail[int(b)], key=lambda r: loads[r])
        else:                                   # least_loaded
            primary = min(avail, key=lambda r: loads[r])
        # retry/hedge order: remaining routable replicas by load, then —
        # last resort only — open-breaker replicas by load
        routable = set(avail)
        rest = sorted((r for r in live if r != primary),
                      key=lambda r: (r not in routable, loads[r]))
        return [primary] + rest

    @staticmethod
    def _routable(rep: Replica, now: float) -> bool:
        """Closed breaker, or half-open (cooldown elapsed — the replica
        may take a trial batch)."""
        return rep.open_until is None or now >= rep.open_until

    # ----------------------------------------------------------- execution
    def _make_worker(self, r_idx: int):
        def run(task):
            # task is (queries, k, dispatch_s[, options]) on the virtual
            # clock, or (queries, k, clock[, options]) from the real-clock
            # front-end
            queries, k, when = task[:3]
            options = task[3] if len(task) > 3 else None
            if isinstance(when, Clock):
                return self._run_on_wall(r_idx, queries, k, when, options)
            return self._run_on(r_idx, queries, k, when, options)
        return run

    def _run_on(self, r_idx: int, queries, k, dispatch_s: float,
                options=None):
        rep = self.replicas[r_idx]
        start_s = max(dispatch_s, rep.busy_until)
        self._last_start_s = start_s
        t0 = time.perf_counter()
        try:
            # named fault site: an installed FaultPlan can crash this
            # replica mid-batch (raise) or stretch its service time
            # (delay, returned in seconds and charged below)
            extra_s = fault_point("replica.execute", replica=r_idx)
            res = rep.server.search_batch(
                queries, k, backend=self._backend or None,
                **options_kwargs(options),
            )
        except Exception:
            self._record_failure(r_idx, dispatch_s)
            raise
        wall = time.perf_counter() - t0
        n = queries.shape[0]
        service_s = (
            self.service_time_fn(r_idx, n)
            if self.service_time_fn
            else wall / max(rep.spec.capacity, 1e-9)
        ) + extra_s
        self._note_success(r_idx)
        self._record_service(rep, n, service_s, done_s=start_s + service_s)
        return res

    def _run_on_wall(self, r_idx: int, queries, k, clock: Clock,
                     options=None):
        """Wall-clock execution on one replica: ``rep.lock`` serializes
        batches routed to the *same* replica (they queue, as a real
        replica's dispatch queue would) while other replicas run
        concurrently on the front-end's thread pool. With an injected
        ``service_time_fn`` the wall is padded by sleeping the shortfall —
        the real-clock analogue of the virtual service model (models a
        remote replica whose service time exceeds local compute).

        Hedge losers run to completion here and are *deliberately*
        recorded: a discarded hedge execution still consumed the
        replica's time for real, so counting it keeps busy-seconds,
        EWMAs, and load estimates honest (it is the ``wasted`` in
        ``HedgeStats.wasted``). Per-replica ``queries`` sums can
        therefore exceed served requests in wall mode — by exactly the
        hedged-and-lost batches."""
        rep = self.replicas[r_idx]
        with rep.lock:
            t0 = clock.now()
            try:
                extra_s = fault_point("replica.execute", replica=r_idx)
                res = rep.server.search_batch(
                    queries, k, backend=self._backend or None,
                    **options_kwargs(options),
                )
            except Exception:
                self._record_failure(r_idx, clock.now())
                raise
            n = queries.shape[0]
            if self.service_time_fn is not None:
                clock.sleep(
                    self.service_time_fn(r_idx, n) + extra_s
                    - (clock.now() - t0)
                )
            elif extra_s > 0.0:
                clock.sleep(extra_s)        # injected straggler latency
            done_s = clock.now()
        self._note_success(r_idx)
        self._record_service(rep, n, done_s - t0, done_s)
        return res, done_s

    # --------------------------------------------------- circuit breakers
    def _record_failure(self, r_idx: int, now: float) -> None:
        rep = self.replicas[r_idx]
        with self._mu:
            rep.failures += 1
            rep.consec_failures += 1
            self.stats.replica_failures += 1
            if rep.open_until is not None:
                # half-open trial failed: restart the cooldown
                rep.open_until = now + self.breaker_cooldown_s
            elif (self.breaker_threshold > 0
                  and rep.consec_failures >= self.breaker_threshold):
                rep.open_until = now + self.breaker_cooldown_s
                self._breaker_active += 1
                self.stats.breaker_opens += 1

    def _note_success(self, r_idx: int) -> None:
        rep = self.replicas[r_idx]
        if rep.consec_failures == 0 and rep.open_until is None:
            return          # hot path: nothing to reset, no lock taken
        closed = False
        with self._mu:
            rep.consec_failures = 0
            if rep.open_until is not None:
                rep.open_until = None
                self._breaker_active -= 1
                self.stats.breaker_closes += 1
                closed = True
        if closed:
            # the replica sat out routing while its breaker cooled; adopt()
            # (outside _mu — it takes the server's own locks) catches it up
            # on any data-plane generation it missed. No-op when current.
            rep.server.adopt()

    def health_check(self, now: Optional[float] = None):
        """Probe every live *half-open* replica (cooldown elapsed) with a
        one-query search. A clean probe closes the breaker and
        ``adopt()``\\ s the replica back onto the current data-plane
        generation; a failing probe restarts the cooldown. Runs
        automatically at dispatch whenever any breaker is active (cheap
        guard: skipped entirely when none is), or call it from an
        operator loop. Returns ``[(replica_idx, ok), ...]`` for the
        replicas probed."""
        checked = []
        for r_idx in range(len(self.replicas)):
            rep = self.replicas[r_idx]
            with self._mu:
                half_open = (
                    bool(self.cluster.live[r_idx])
                    and rep.open_until is not None
                    and (now is None or now >= rep.open_until)
                )
            if not half_open:
                continue
            ok = True
            try:
                fault_point("replica.execute", replica=r_idx, probe=True)
                rep.server.search_batch(
                    np.zeros((1, self.cfg.dim), np.float32), 1,
                    backend=self._backend or None,
                )
            except Exception as e:  # noqa: BLE001 - probe outcome is the point
                if is_device_fault(e):
                    raise
                ok = False
            with self._mu:
                self.stats.health_probes += 1
                if ok:
                    rep.consec_failures = 0
                    if rep.open_until is not None:
                        rep.open_until = None
                        self._breaker_active -= 1
                        self.stats.breaker_closes += 1
                else:
                    rep.failures += 1
                    rep.consec_failures += 1
                    self.stats.replica_failures += 1
                    if now is not None:
                        rep.open_until = now + self.breaker_cooldown_s
            if ok:
                rep.server.adopt()
            checked.append((r_idx, ok))
        return checked

    def _record_service(self, rep: Replica, n: int, service_s: float,
                        done_s: float):
        """Atomically account one served batch: busy bookkeeping, the
        per-replica and fleet-wide EWMAs, and the probe-window mirror.
        Shared by the virtual and wall paths; ``_mu`` keeps concurrent
        wall-mode dispatches exact (EWMA read-modify-writes and counter
        increments would otherwise race)."""
        with self._mu:
            rep.busy_until = done_s
            rep.busy_s += service_s
            rep.batches += 1
            rep.queries += n
            rep.service_ms.append(service_s * 1e3)
            obs_per_q = service_s / max(n, 1)
            rep.ewma_per_q_s = (
                obs_per_q
                if rep.ewma_per_q_s is None
                else self.ewma_alpha * obs_per_q
                + (1.0 - self.ewma_alpha) * rep.ewma_per_q_s
            )
            norm_per_q = obs_per_q * rep.spec.capacity
            self._fleet_ewma_norm_per_q = (
                norm_per_q
                if self._fleet_ewma_norm_per_q is None
                else self.ewma_alpha * norm_per_q
                + (1.0 - self.ewma_alpha) * self._fleet_ewma_norm_per_q
            )
            # the replica's server just recorded this batch's probes;
            # mirror them into the fleet-level window (newest last) for
            # the scheduler's hot-mass drift trigger
            if rep.server._recent_probes:
                self._recent_probes.append(rep.server._recent_probes[-1])
            self._last_done_s = done_s

    # ------------------------------------------------------------ elastic
    def fail_replica(self, r_idx: int) -> None:
        """Remove a replica from routing. Virtual work already dispatched
        to it completes (the batch result was computed at dispatch); no
        admitted request is lost — the shared queue re-routes everything
        else to the survivors."""
        with self._mu:
            self.cluster.fail(r_idx)
            if self.cluster.n_live == 0:
                raise RuntimeError("no live replicas")

    def join_replica(self, spec: Optional[ReplicaSpec] = None) -> int:
        """Stand up one more replica mid-trace; returns its index.

        The server is built and warmed *before* the replica becomes
        routable, and the routing state (replica list, hedge worker slot,
        live set) is updated atomically under the fleet lock — a
        concurrent wall-clock dispatch never sees a live replica without
        its hedge worker. The new server is constructed over the fleet's
        *shared* data plane, so a joiner adopts the current segment
        generation (upserts/deletes/compactions that happened mid-trace
        included), never the boot-time index."""
        spec = spec or ReplicaSpec()
        rep = Replica(self._make_server(spec), spec)
        self._warmup_replica(rep)
        with self._mu:
            self.replicas.append(rep)
            if self._hedge is not None:
                self._hedge.workers.append(
                    self._make_worker(len(self.replicas) - 1)
                )
            self.cluster.join()
            return len(self.replicas) - 1

    # ------------------------------------------- skew-adaptation surface
    def window_probes(self):
        # snapshot under the lock: wall-mode workers append to the deque
        # concurrently, and iterating a mutating deque raises
        with self._mu:
            return list(self._recent_probes)[::-1]       # newest first

    def refresh_plan(self) -> None:
        """Re-plan every live replica from its *own* workload window —
        per-replica plans diverge under skew, results stay exact."""
        for i in self.cluster.live_ids():
            self.replicas[int(i)].server.refresh_plan()

    @property
    def replans(self) -> int:
        return sum(r.server.stats.replans for r in self.replicas)

    @property
    def nlist(self) -> int:
        return self.index.nlist

    @property
    def default_max_batch(self) -> int:
        return self.cfg.query_block

    @property
    def default_k(self) -> int:
        return self.cfg.topk

    @property
    def parallelism(self) -> int:
        """Live replica count — the front-end's default in-flight bound
        (one wall-clock batch per live replica can genuinely overlap)."""
        return max(int(self.cluster.n_live), 1)

    # ---------------------------------------------------------- reporting
    @property
    def load_balance_gini(self) -> float:
        """Gini of per-replica virtual busy-seconds (work, not counts —
        a capacity-blind router looks balanced in counts while its slow
        replicas drown in seconds)."""
        return gini([r.busy_s for r in self.replicas])

    def summary(self) -> dict:
        """Fleet-level digest: per-replica QPS/latency/shed (each
        replica's own ServeStats threaded up), the load-balance Gini, and
        the cross-replica hedge win rate, alongside the fleet's admission
        accounting (see :meth:`repro_torch.serve.engine.ServeStats.summary` for
        those keys).

        Units — seconds vs milliseconds are explicit in key names:

        * ``replicas[i].busy_s`` — total service time in **seconds** (on
          the driving clock: virtual in replay, wall under the live
          front-end);
        * ``replicas[i].virtual_qps`` — ``queries / busy_s``: the
          replica's throughput while busy (queries per second), not
          wall-clock QPS — idle gaps between batches don't count;
        * ``replicas[i].p50_service_ms`` / ``p99_service_ms`` —
          per-*batch* service-time percentiles in **milliseconds**
          (``None`` until the replica has served a batch);
        * ``load_balance_gini`` — dimensionless in [0, 1) over
          per-replica busy-seconds (0 = perfectly balanced);
        * ``hedge.win_rate`` — fraction of fired hedges the hedge target
          won, in [0, 1].
        """
        per_replica = []
        for i, rep in enumerate(self.replicas):
            sm = np.asarray(rep.service_ms, np.float64)
            per_replica.append({
                "replica": i,
                "backend": rep.server.backend,
                "capacity": rep.spec.capacity,
                "live": bool(self.cluster.live[i]),
                "failures": rep.failures,
                "breaker_open": rep.open_until is not None,
                "batches": rep.batches,
                "queries": rep.queries,
                "busy_s": rep.busy_s,
                "virtual_qps": rep.queries / rep.busy_s if rep.busy_s else 0.0,
                "p50_service_ms": float(np.percentile(sm, 50)) if sm.size else None,
                "p99_service_ms": float(np.percentile(sm, 99)) if sm.size else None,
                "server": rep.server.stats.summary(),
            })
        hs = self._hedge.stats if self._hedge is not None else None
        return {
            "routing": self.routing,
            "n_replicas": len(self.replicas),
            "n_live": self.cluster.n_live,
            "load_balance_gini": self.load_balance_gini,
            "hedge": {
                "dispatched": hs.dispatched if hs else 0,
                "hedged": hs.hedged if hs else 0,
                "wasted": hs.wasted if hs else 0,
                "hedge_wins": hs.hedge_wins if hs else 0,
                "win_rate": hs.win_rate if hs else 0.0,
            },
            "replicas": per_replica,
            **self.stats.summary(),
            # fleet aggregates (the admission-level ServeStats never sees
            # execution, which happens inside each replica's server)
            "batches": sum(r.batches for r in self.replicas),
            "queries": sum(r.queries for r in self.replicas),
            "replans": self.replans,
            "spmd_batches": sum(
                r.server.stats.spmd_batches for r in self.replicas
            ),
        }
