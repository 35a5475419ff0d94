"""Real-clock asynchronous serving front-end — live traffic through the
same admission queue, adaptive batch former, and deadline/shed accounting
that the virtual-clock scheduler replays deterministically.

This is the real-clock front-end: BatANN-style, an asynchronous front
door that overlaps replica execution for real instead of only on the
simulated clock. The split of responsibilities:

* :class:`ServingFrontend` (here) — owns the wall clock
  (:class:`repro_torch.serve.clock.MonotonicClock`), a bounded admission queue,
  the batch-forming triggers (the *same* ``next_fire`` policy the
  scheduler uses: size / deadline / capacity), a dispatcher thread that
  fires due batches, and a thread pool that executes up to
  ``max_inflight`` batches concurrently;
* the :class:`repro_torch.serve.scheduler.DispatchTarget` — owns running one
  batch (``execute_wall``): a :class:`~repro_torch.serve.scheduler.SingleServerTarget`
  serializes on its server; a :class:`repro_torch.serve.fleet.ReplicaFleet`
  routes by live load estimates and runs the batch on the chosen replica
  concurrently with other in-flight batches (per-replica locks, atomic
  EWMA accounting, optional wall-clock straggler hedging).

Requests are submitted live — :meth:`ServingFrontend.submit` returns a
``concurrent.futures.Future`` resolving to a
:class:`~repro_torch.serve.scheduler.RequestResult`; :meth:`~ServingFrontend.asubmit`
is the asyncio twin. Backpressure sheds by failing the future with
:class:`ShedError` (and counting it), never by blocking the submitter.

The dispatcher and pool threads make the target's card current before
they run anything. A device fault (a CUDA error,
:func:`repro_torch._device.is_device_fault`) is never retried or served
past: it fails its batch's futures and every queued request, and the
front-end stops taking submissions.

The virtual-clock replay (:class:`~repro_torch.serve.scheduler.ServingScheduler`)
remains the test oracle for the shared queue/deadline/shed logic —
``tests/test_virtual_clock_goldens.py`` pins it bit-for-bit.

>>> import numpy as np
>>> from repro_torch.config import HarmonyConfig
>>> from repro_torch.core import build_ivf
>>> from repro_torch.serve import HarmonyServer, SchedulerConfig, ServingFrontend
>>> rng = np.random.default_rng(0)
>>> x = rng.standard_normal((256, 8)).astype(np.float32)
>>> cfg = HarmonyConfig(dim=8, nlist=4, nprobe=2, topk=3, kmeans_iters=2)
>>> srv = HarmonyServer(build_ivf(x, cfg, device="cpu"), n_nodes=2,
...                     device="cpu")
>>> with ServingFrontend(srv, SchedulerConfig(max_batch=4, max_wait_s=1e-3),
...                      k=3) as fe:
...     futs = fe.submit_many(x[:8])            # live submission
...     ids = [f.result(timeout=30).ids for f in futs]
>>> len(ids), ids[0].shape
(8, (3,))
>>> fe.stats.admitted, fe.stats.shed
(8, 0)
"""

from __future__ import annotations

import asyncio
import threading
from collections import deque
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Deque, List, Optional, Tuple

import numpy as np

import time
import warnings

from repro_torch import tracing
from repro_torch._device import bind_device, is_device_fault
from repro_torch.core.types import DataPlane, SearchRequest
from repro_torch.serve.cache import QueryCache, build_query_cache
from repro_torch.serve.clock import Clock, MonotonicClock
from repro_torch.serve.scheduler import (
    DispatchTarget,
    Request,
    RequestResult,
    SchedulerConfig,
    SingleServerTarget,
    SkewMonitor,
    next_fire,
)


class ShedError(RuntimeError):
    """A request was rejected by admission control (bounded queue full).

    Delivered through the submitted future — ``future.result()`` (or
    ``await asubmit(...)``) raises it; the request was counted in
    ``stats.shed`` and never queued."""


class ServingFrontend(DataPlane):
    """Live (wall-clock) admission-controlled serving front-end.

    Parameters mirror :class:`~repro_torch.serve.scheduler.ServingScheduler`:
    pass a ``HarmonyServer`` (wrapped in a ``SingleServerTarget``) or any
    ``DispatchTarget`` — in particular a
    :class:`repro_torch.serve.fleet.ReplicaFleet`, whose replicas then execute
    concurrently on the front-end's thread pool.

    ``max_inflight`` bounds concurrently executing batches (default: the
    target's ``parallelism`` — 1 for a single server, the live replica
    count for a fleet). ``service_time_fn(n_queries) -> seconds`` (single
    server only) pads each batch's wall to a service model by sleeping —
    used by benchmarks/tests to model remote-replica service time on one
    box; fleets take the per-replica model in their own constructor.

    Lifecycle: the dispatcher thread starts immediately; use as a context
    manager or call :meth:`shutdown`. :meth:`drain` blocks until queue and
    in-flight batches are empty (firing still-queued batches immediately
    rather than waiting out their deadlines).

    All timestamps are seconds on ``clock`` (default
    :class:`~repro_torch.serve.clock.MonotonicClock`, epoch ≈ construction
    time); ``stats`` durations are milliseconds (see
    :meth:`repro_torch.serve.engine.ServeStats.summary`).
    """

    def __init__(
        self,
        server,
        cfg: Optional[SchedulerConfig] = None,
        k: Optional[int] = None,
        max_inflight: Optional[int] = None,
        service_time_fn=None,
        clock: Optional[Clock] = None,
        on_batch=None,
    ):
        self.cfg = cfg or SchedulerConfig()
        if isinstance(server, DispatchTarget):
            if service_time_fn is not None:
                raise ValueError(
                    "service_time_fn belongs to the target when a "
                    "DispatchTarget is passed (construct it with one)"
                )
            self.target = server
        else:
            self.target = SingleServerTarget(
                server, service_time_fn=service_time_fn
            )
        self.server = getattr(self.target, "server", self.target)
        self.stats = self.target.stats
        self.clock: Clock = clock or MonotonicClock()
        self.k = k or self.target.default_k
        self.max_batch = self.cfg.max_batch or self.target.default_max_batch
        assert self.max_batch >= 1
        self.max_inflight = int(max_inflight or self.target.parallelism)
        assert self.max_inflight >= 1
        self.on_batch = on_batch
        self.target.configure(self.cfg, self.k)
        self._skew = SkewMonitor(self.cfg, self.target)
        self._skew_mu = threading.Lock()

        # semantic cache + in-flight coalescing (repro_torch.serve.cache):
        # inert when cfg.cache is None/disabled. Followers of an in-flight
        # leader never enter the queue — they attach to its execution and
        # resolve when it completes.
        self.cache = build_query_cache(self.cfg, self.target, self.stats)
        self._coalesce = self.cache is not None and self.cfg.cache.coalesce
        self._leaders: dict = {}                   # cache key -> leader rid
        self._followers: dict = {}                 # leader rid -> [(Request, Future)]
        self._rid_key: dict = {}                   # leader rid -> cache key

        self._mu = threading.Condition()
        self.queue: Deque[Request] = deque()       # same shape the shared
        self._futures: dict = {}                   # next_fire policy reads
        self._inflight = 0
        self._closing = False
        self._draining = 0
        self._next_id = 0
        self._batch_id = 0
        self._served = 0
        self.first_arrival_s: Optional[float] = None
        self.last_done_s = 0.0
        self.device = self.target.device
        self.fault: Optional[BaseException] = None    # the device fault, if any
        self._pool = ThreadPoolExecutor(
            max_workers=self.max_inflight, thread_name_prefix="harmony-serve",
            initializer=bind_device, initargs=(self.device,),
        )
        self._dispatcher = threading.Thread(
            target=self._dispatch_loop, name="harmony-dispatch", daemon=True
        )
        self._dispatcher.start()

    # ---------------------------------------------------------------- admit
    def submit(self, query) -> "Future[RequestResult]":
        """Offer one request at the current wall time. ``query`` is a
        :class:`repro_torch.core.SearchRequest` (the canonical shape — its
        filter/hybrid/precision/k ride with the request) or a bare [D]
        array, auto-wrapped with a ``DeprecationWarning``. Returns a
        future that resolves to its :class:`RequestResult` — or raises
        :class:`ShedError` from the future if backpressure shed it.
        Raises ``RuntimeError`` immediately if the front-end is shut
        down (or stopped by a device fault, its cause)."""
        if not isinstance(query, SearchRequest):
            warnings.warn(
                "submitting a bare ndarray is deprecated; pass a "
                "repro_torch.core.SearchRequest",
                DeprecationWarning, stacklevel=2,
            )
            query = SearchRequest(vector=np.asarray(query))
        fut: "Future[RequestResult]" = Future()
        shed_exc = None
        ready: Optional[RequestResult] = None
        with self._mu:
            if self._closing:
                raise RuntimeError("ServingFrontend is shut down") from self.fault
            arrival_s = self.clock.now()
            self.stats.offered += 1
            rid = self._next_id
            self._next_id += 1
            if self.first_arrival_s is None:
                self.first_arrival_s = arrival_s
            vec = np.asarray(query.vector)
            k_r = query.k or self.k
            options = (query.filter, query.hybrid_text, query.precision)
            key = (QueryCache.request_key(vec, k_r, options)
                   if self.cache is not None else None)
            hit = None
            leader = (self._leaders.get(key)
                      if self._coalesce and key is not None else None)
            if query.deadline is not None and arrival_s > query.deadline:
                # deadline already blown: sentinel degradation, never
                # queued — checked before the cache so even
                # a cached answer is refused
                self.stats.expired_requests += 1
                ready = RequestResult(
                    req_id=rid,
                    ids=np.full(k_r, -1, np.int64),
                    scores=np.full(k_r, np.inf, np.float32),
                    arrival_s=arrival_s, dispatch_s=arrival_s,
                    done_s=arrival_s, batch_id=-1,
                )
            elif (self.cache is not None and (hit := self.cache.lookup(
                    vec, k_r, options, arrival_s)) is not None):
                self._served += 1
                self.last_done_s = max(self.last_done_s, arrival_s)
                self.stats.queue_wait_ms.append(0.0)
                self.stats.request_latency_ms.append(0.0)
                ready = RequestResult(
                    req_id=rid, ids=hit.ids, scores=hit.scores,
                    arrival_s=arrival_s, dispatch_s=arrival_s,
                    done_s=arrival_s, batch_id=-1,
                )
            elif leader is not None:
                # coalesce: attach to the in-flight/queued duplicate's
                # execution instead of enqueueing again
                self.stats.coalesced += 1
                self._followers.setdefault(leader, []).append((Request(
                    rid, vec, arrival_s,
                    k=query.k, filter=query.filter,
                    hybrid_text=query.hybrid_text, precision=query.precision,
                    deadline=query.deadline,
                ), fut))
            elif (self.cfg.queue_capacity
                    and len(self.queue) >= self.cfg.queue_capacity):
                self.stats.shed += 1
                shed_exc = ShedError(
                    f"request {rid} shed: queue at capacity "
                    f"{self.cfg.queue_capacity}"
                )
            else:
                self.queue.append(Request(
                    rid, vec, arrival_s,
                    k=query.k, filter=query.filter,
                    hybrid_text=query.hybrid_text, precision=query.precision,
                    deadline=query.deadline,
                ))
                self._futures[rid] = fut
                self.stats.admitted += 1
                if self._coalesce and key is not None:
                    self._leaders[key] = rid
                    self._rid_key[rid] = key
                self._mu.notify_all()
        if shed_exc is not None:
            fut.set_exception(shed_exc)
        elif ready is not None:
            fut.set_result(ready)
        return fut

    def submit_many(self, queries) -> List["Future[RequestResult]"]:
        """Submit a sequence of single-query requests (arrays or
        :class:`SearchRequest`); one future each (shed requests come back
        as already-failed futures)."""
        return [self.submit(q) for q in queries]

    async def asubmit(self, query) -> RequestResult:
        """asyncio twin of :meth:`submit`: ``await`` the result directly
        (raises :class:`ShedError` if admission shed the request)."""
        return await asyncio.wrap_future(self.submit(query))

    # ----------------------------------------------------------- mutation
    # upsert()/delete() come from the DataPlane mixin and forward to the
    # dispatch target. Thread-safe against in-flight batches — a
    # dispatched batch keeps its snapshot; the write is visible to every
    # batch dispatched after the call returns.
    def _data_plane(self):
        return self.target

    # ----------------------------------------------------------- dispatcher
    def _due(self, now: float) -> Tuple[float, str]:
        """When may the queued requests dispatch, and why — the
        scheduler's shared :func:`~repro_torch.serve.scheduler.next_fire`
        policy verbatim. The virtual scheduler gates on
        ``target.next_free_s()``; here the in-flight bound plays that
        role (checked by the caller), so the free-time argument is 0.
        While draining/closing, still-queued requests fire immediately
        instead of waiting out their deadline (trigger classification
        unchanged)."""
        fire_s, trigger = next_fire(self.queue, self.cfg, self.max_batch, 0.0)
        if self._closing or self._draining:
            return now, trigger
        return fire_s, trigger

    def _dispatch_loop(self) -> None:
        bind_device(self.device)
        while True:
            with self._mu:
                while not self.queue and not self._closing:
                    self._mu.wait()
                if not self.queue:          # closing and drained
                    break
                now = self.clock.now()
                fire_s, trigger = self._due(now)
                if fire_s > now:
                    self._mu.wait(timeout=min(fire_s - now, 0.05))
                    continue
                if self._inflight >= self.max_inflight:
                    self._mu.wait(timeout=0.05)
                    continue
                batch = [
                    self.queue.popleft()
                    for _ in range(min(len(self.queue), self.max_batch))
                ]
                futs = [self._futures.pop(r.req_id) for r in batch]
                self._inflight += 1
                bid = self._batch_id
                self._batch_id += 1
                dispatch_s = now
            try:
                self._pool.submit(
                    self._run_batch, batch, futs, dispatch_s, trigger, bid
                )
            except RuntimeError:            # pool torn down mid-close
                with self._mu:
                    self._inflight -= 1
                    fols = self._detach_followers(batch)
                    self._mu.notify_all()
                for fut in futs:
                    fut.cancel()
                for fl in fols:
                    for _, f in fl:
                        f.cancel()

    def _detach_followers(self, batch) -> List[list]:
        """Pop each batch request's coalesced followers and release its
        leader registration (call under ``self._mu``). Returns one
        ``[(Request, Future), ...]`` list per batch row. After this, new
        duplicates start a fresh leader — no follower can attach to an
        already-completed execution."""
        fols = []
        for req in batch:
            key = self._rid_key.pop(req.req_id, None)
            if key is not None and self._leaders.get(key) == req.req_id:
                del self._leaders[key]
            fols.append(self._followers.pop(req.req_id, []))
        return fols

    def _sentinel(self, rid: int, k: int, arrival_s: float, stamp_s: float,
                  bid: int) -> RequestResult:
        return RequestResult(
            req_id=rid,
            ids=np.full(k, -1, np.int64),
            scores=np.full(k, np.inf, np.float32),
            arrival_s=arrival_s, dispatch_s=stamp_s, done_s=stamp_s,
            batch_id=bid,
        )

    def _run_batch(self, batch, futs, dispatch_s: float, trigger: str,
                   bid: int):
        with tracing.span("frontend.batch", bid=bid, queries=len(batch),
                          trigger=trigger):
            self._serve_batch(batch, futs, dispatch_s, trigger, bid)
        if self.on_batch is not None:
            try:
                self.on_batch(bid, self)
            except Exception as e:
                warnings.warn(f"on_batch callback failed on batch {bid}: {e!r}")

    def _serve_batch(self, batch, futs, dispatch_s: float, trigger: str,
                     bid: int):
        """Run one batch and resolve its futures (and its coalesced
        followers'), failed or not."""
        # per-request deadline enforcement at dispatch: a request whose
        # absolute deadline passed while it queued degrades to the
        # sentinel shape, never executes. Its coalesced followers
        # (who wanted the same answer) degrade with it.
        expired, exp_futs = [], []
        live, live_futs = [], []
        for req, fut in zip(batch, futs):
            if req.deadline is not None and dispatch_s > req.deadline:
                expired.append(req)
                exp_futs.append(fut)
            else:
                live.append(req)
                live_futs.append(fut)
        if expired:
            with self._mu:
                exp_fols = (self._detach_followers(expired)
                            if self._coalesce else [[] for _ in expired])
                self.stats.expired_requests += (
                    len(expired) + sum(len(f) for f in exp_fols)
                )
            for req, fut, fols in zip(expired, exp_futs, exp_fols):
                fut.set_result(self._sentinel(
                    req.req_id, req.k or self.k, req.arrival_s, dispatch_s,
                    bid,
                ))
                for freq, ffut in fols:
                    ffut.set_result(self._sentinel(
                        freq.req_id, freq.k or self.k, freq.arrival_s,
                        dispatch_s, bid,
                    ))
        batch, futs = live, live_futs
        if not batch:
            with self._mu:
                self._inflight -= 1
                self._mu.notify_all()
            return
        # epoch read before execution: cache entries from this batch are
        # stamped pre-execute, so a concurrent write that lands mid-batch
        # makes them count as already-stale (conservative)
        pre_epoch = self.cache.epoch() if self.cache is not None else None
        row_ids = row_scores = None
        err = None
        try:
            oldest_s = min(req.arrival_s for req in batch)

            def _run_all():
                ids_out = [None] * len(batch)
                scores_out = [None] * len(batch)
                d_max = self.clock.now()
                # partition by request options (filter/hybrid/precision/k):
                # each group shares one execution context; the knob-free
                # batch is one group and one positional execute_wall call —
                # the pre-request-API behaviour
                with tracing.span("frontend.stack"):
                    groups = {}
                    for row, req in enumerate(batch):
                        groups.setdefault(req.options_key(), []).append(row)
                    stacked = [(key, rows, np.stack([batch[r].query for r in rows]))
                               for key, rows in groups.items()]
                for key, rows, queries in stacked:
                    if key is None:
                        res, g_done = self.target.execute_wall(
                            queries, self.k, bid, self.clock
                        )
                    else:
                        res, g_done = self.target.execute_wall(
                            queries, key[0] or self.k, bid, self.clock,
                            key[1:],
                        )
                    d_max = max(d_max, g_done)
                    for i, r in enumerate(rows):
                        ids_out[r] = res.ids[i]
                        scores_out[r] = res.scores[i]
                return ids_out, scores_out, d_max

            # searches are idempotent reads: a batch whose dispatch raises
            # (replica crash past the fleet's own failover, torn target) is
            # re-issued with linear backoff while the oldest request's age
            # stays inside the per-request deadline budget
            for attempt in range(self.cfg.max_retries + 1):
                try:
                    row_ids, row_scores, done_s = _run_all()
                    err = None
                    break
                except Exception as e:      # noqa: BLE001 - bounded retry
                    if is_device_fault(e):
                        raise   # not retried: relayed below, then stop
                    err = e
                    if attempt >= self.cfg.max_retries:
                        break
                    backoff = self.cfg.retry_backoff_s * (attempt + 1)
                    if (self.cfg.request_deadline_s > 0
                            and (self.clock.now() - oldest_s) + backoff
                            > self.cfg.request_deadline_s):
                        break   # budget spent: fail now, not later
                    with self._mu:
                        self.stats.retried_batches += 1
                    self.clock.sleep(backoff)
        except BaseException as e:          # noqa: BLE001 - relayed to futures
            err = e
        if err is not None:
            done_s = self.clock.now()
        if err is None and self.cache is not None:
            # store served answers before followers detach, so the next
            # duplicate (no longer coalescible) exact-hits instead
            for row, req in enumerate(batch):
                self.cache.insert(
                    req.query, req.k or self.k,
                    (req.filter, req.hybrid_text, req.precision),
                    row_ids[row], row_scores[row], done_s, epoch=pre_epoch,
                )
        with self._mu:
            self._inflight -= 1
            # followers resolve with their leader (success or error) —
            # detaching under the same lock submit() attaches with means
            # no follower can be orphaned
            fols = (self._detach_followers(batch)
                    if self._coalesce else [[] for _ in batch])
            n_fols = sum(len(f) for f in fols)
            if err is not None:
                # the batch is answered (with an error), the front-end
                # keeps serving — degradation, not collapse
                self.stats.failed_batches += 1
                self.stats.failed_requests += len(batch) + n_fols
            if err is None:
                if trigger == "full":
                    self.stats.full_batches += 1
                elif trigger == "capacity":
                    self.stats.capacity_batches += 1
                else:
                    self.stats.deadline_batches += 1
                for row, req in enumerate(batch):
                    self.stats.queue_wait_ms.append(
                        (dispatch_s - req.arrival_s) * 1e3
                    )
                    self.stats.request_latency_ms.append(
                        (done_s - req.arrival_s) * 1e3
                    )
                    for freq, _ffut in fols[row]:
                        # a follower may have attached after dispatch —
                        # it never queued, so its wait clamps at 0
                        self.stats.queue_wait_ms.append(
                            max(dispatch_s - freq.arrival_s, 0.0) * 1e3
                        )
                        self.stats.request_latency_ms.append(
                            max(done_s - freq.arrival_s, 0.0) * 1e3
                        )
                self._served += len(batch) + n_fols
                self.last_done_s = max(self.last_done_s, done_s)
            self._mu.notify_all()
        # complete futures outside the lock: done-callbacks run inline
        if err is not None:
            with tracing.span("frontend.fanout"):
                for fut in futs:
                    fut.set_exception(err)
                for fl in fols:
                    for _, ffut in fl:
                        ffut.set_exception(err)
            if is_device_fault(err):
                self._stop_on_fault(err)
            return
        with tracing.span("frontend.fanout"):
            for row, (req, fut) in enumerate(zip(batch, futs)):
                fut.set_result(
                    RequestResult(
                        req_id=req.req_id,
                        ids=row_ids[row],
                        scores=row_scores[row],
                        arrival_s=req.arrival_s,
                        dispatch_s=dispatch_s,
                        done_s=done_s,
                        batch_id=bid,
                    )
                )
                for freq, ffut in fols[row]:
                    ffut.set_result(
                        RequestResult(
                            req_id=freq.req_id,
                            ids=row_ids[row],
                            scores=row_scores[row],
                            arrival_s=freq.arrival_s,
                            dispatch_s=dispatch_s,
                            done_s=done_s,
                            batch_id=bid,
                        )
                    )
        try:
            with self._skew_mu:         # serialized hot-mass check
                self._skew.after_batch()
        except Exception as e:          # results already delivered —
            warnings.warn(              # surface, don't lose, the error
                f"skew-replan check failed on batch {bid}: {e!r}"
            )

    def _stop_on_fault(self, err: BaseException) -> None:
        """A device fault stops the front-end: it refuses new submissions
        and fails every queued request (and its followers) with the
        fault; nothing more is run on the card."""
        with self._mu:
            if self.fault is None:
                self.fault = err
            self._closing = True
            dropped = []
            for r in self.queue:
                dropped.append(self._futures.pop(r.req_id, None))
                for fl in self._detach_followers([r]):
                    dropped.extend(f for _, f in fl)
            self.queue.clear()
            self._mu.notify_all()
        for fut in dropped:
            if fut is not None:
                fut.set_exception(err)

    # ------------------------------------------------------------ lifecycle
    def drain(self, timeout: Optional[float] = None) -> bool:
        """Block until the queue is empty and no batch is in flight,
        firing still-queued batches immediately. Returns False if
        ``timeout`` (seconds) expired first. The timeout is measured on
        real time (``time.monotonic``), not ``self.clock`` — waiting is
        real even if a non-wall clock was injected."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._mu:
            self._draining += 1
            self._mu.notify_all()
            try:
                while self.queue or self._inflight:
                    wait_s = 0.05
                    if deadline is not None:
                        remaining = deadline - time.monotonic()
                        if remaining <= 0:
                            return False
                        wait_s = min(wait_s, remaining)
                    self._mu.wait(timeout=wait_s)
                return True
            finally:
                self._draining -= 1
                self._mu.notify_all()

    def shutdown(self, wait: bool = True,
                 timeout: Optional[float] = None) -> bool:
        """Graceful stop: refuse new submissions, then (``wait=True``)
        drain queued and in-flight work before tearing the pool down.
        With ``wait=False``, queued requests are cancelled and in-flight
        batches finish in the background. If ``timeout`` expires while
        draining, remaining in-flight batches are likewise left to finish
        in the background rather than blocking past the timeout.
        Idempotent.

        Returns ``True`` once everything is down (work resolved, the
        dispatcher thread joined) — the same contract as
        :meth:`repro_torch.serve.compactor.Compactor.stop`. ``False`` means
        something was left running in the background: an unexpired drain
        timeout, or a dispatcher thread that outlived its join (also
        recorded in ``stats.shutdown_leaks``)."""
        drained = True
        with self._mu:
            already = self._closing
            self._closing = True
            if not wait:
                dropped = []
                for r in self.queue:
                    dropped.append(self._futures.pop(r.req_id, None))
                    # queued leaders take their coalesced followers down
                    # with them (in-flight leaders still resolve theirs)
                    for fl in self._detach_followers([r]):
                        dropped.extend(f for _, f in fl)
                self.queue.clear()
            self._mu.notify_all()
        if not wait:
            for fut in dropped:
                if fut is not None:
                    fut.cancel()
        elif not already:
            drained = self.drain(timeout)
        self._dispatcher.join(timeout=5.0)
        leaked = self._dispatcher.is_alive()
        if leaked:
            with self._mu:
                self.stats.shutdown_leaks += 1
        self._pool.shutdown(wait=wait and drained)
        return drained and not leaked

    def __enter__(self) -> "ServingFrontend":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.shutdown(wait=exc_type is None)

    # ------------------------------------------------------------ reporting
    @property
    def makespan_s(self) -> float:
        """First arrival → last completion, in wall seconds."""
        if self.first_arrival_s is None:
            return 0.0
        return max(self.last_done_s - self.first_arrival_s, 0.0)

    @property
    def served_qps(self) -> float:
        """Served requests per wall second of makespan."""
        return self._served / self.makespan_s if self.makespan_s > 0 else 0.0

    def summary(self) -> dict:
        """Admission/latency digest (`ServeStats.summary` keys — ms/counts)
        plus the front-end's wall-clock view: ``served`` requests,
        ``makespan_s`` (seconds), ``served_qps`` (requests per wall
        second), and the in-flight bound."""
        return {
            **self.stats.summary(),
            "served": self._served,
            "makespan_s": self.makespan_s,
            "served_qps": self.served_qps,
            "max_inflight": self.max_inflight,
        }
