"""Straggler mitigation: hedged dispatch with deadline + replica re-issue.

The serving engine dispatches per-shard work through this executor. If a
shard's result misses its deadline, the work is re-issued to the replica
holder (in HARMONY's layout, the dimension-block peers of a vector shard
hold disjoint *columns* of the same rows, so the hedge target is the
next live shard that can recompute the visit after a cheap re-route).

Two execution modes share the same policy and counters:

* **simulated** (:meth:`HedgingExecutor.run_timed` /
  :meth:`~HedgingExecutor.run_ranked`) — latency comes from
  ``latency_fn`` and the hedge *decision* is evaluated analytically; the
  serving scheduler charges the effective latency to its virtual clock.
  This is the deterministic replay path every test pins down.
* **wall-clock** (:meth:`HedgingExecutor.run_wall` /
  :meth:`~HedgingExecutor.run_ranked_wall`) — the primary really runs on
  a worker thread; if no result lands within ``deadline_s`` the task is
  re-issued to the replica worker and the first finisher wins. This is
  what the real-clock front-end (:class:`repro_torch.serve.frontend.ServingFrontend`)
  drives across fleet replicas.

Counters are updated under a lock, so concurrent wall-mode dispatches
from a thread pool keep :class:`HedgeStats` exact. A wall-mode thread
makes ``device`` (the served plane's card) current before it calls a
worker, and a device fault (:func:`repro_torch._device.is_device_fault`)
re-raises as soon as it arrives: it is never waited past for the other
worker's result.
"""

from __future__ import annotations

import queue as queue_mod
import threading
from dataclasses import dataclass
from typing import Any, Callable, List, Optional, Tuple

import torch

from repro_torch._device import bind_device, is_device_fault


@dataclass
class HedgeStats:
    dispatched: int = 0
    hedged: int = 0
    wasted: int = 0                    # hedges whose primary also finished
    hedge_wins: int = 0                # hedges where the replica served first

    @property
    def win_rate(self) -> float:
        """Fraction of fired hedges that actually beat the primary."""
        return self.hedge_wins / self.hedged if self.hedged else 0.0


class HedgingExecutor:
    """Deadline-hedged execution over a set of worker callables.

    Workers are ``fn(task) -> result``; ``latency_fn(worker, task)``
    simulates per-worker service time in the simulated mode (tests inject
    stragglers there). ``deadline_s`` is seconds. ``device`` is the card
    the workers serve from; the wall-clock mode's threads make it current
    (None: they leave the current device alone).
    """

    def __init__(
        self,
        workers: List[Callable[[Any], Any]],
        deadline_s: float,
        latency_fn: Optional[Callable[[int, Any], float]] = None,
        device: Optional[torch.device] = None,
    ):
        self.workers = workers
        self.deadline_s = deadline_s
        self.device = device
        self.latency_fn = latency_fn or (lambda w, t: 0.0)
        self.stats = HedgeStats()
        self._mu = threading.Lock()     # guards stats under wall-mode threads

    def run(self, task: Any, primary: int, replica: Optional[int] = None) -> Tuple[Any, int]:
        """Returns (result, worker_that_served). Simulated time: if the
        primary's latency exceeds the deadline, the hedge fires and the
        faster of the two serves the request."""
        result, served_by, _ = self.run_timed(task, primary, replica)
        return result, served_by

    def run_timed(
        self, task: Any, primary: int, replica: Optional[int] = None
    ) -> Tuple[Any, int, float]:
        """Hedged dispatch that also reports the effective (simulated)
        latency the request experienced: the primary's latency when it
        beats the deadline, otherwise the faster of primary-finish vs
        deadline + replica-finish. The serving scheduler charges this
        latency to its virtual clock when dispatching batches."""
        with self._mu:
            self.stats.dispatched += 1
        lat_p = self.latency_fn(primary, task)
        if lat_p <= self.deadline_s or replica is None:
            return self.workers[primary](task), primary, lat_p
        # hedge fires at the deadline
        with self._mu:
            self.stats.hedged += 1
        lat_r = self.deadline_s + self.latency_fn(replica, task)
        if lat_p <= lat_r:
            with self._mu:
                self.stats.wasted += 1
            return self.workers[primary](task), primary, lat_p
        with self._mu:
            self.stats.hedge_wins += 1
        return self.workers[replica](task), replica, lat_r

    def run_ranked(
        self, task: Any, ranked: List[int]
    ) -> Tuple[Any, int, float]:
        """Hedged dispatch over a load-ranked worker list: ``ranked[0]``
        is the router's dispatch choice, ``ranked[1:]`` the remaining
        workers ordered by load estimate. A hedge, if it fires, re-runs
        the task on ``ranked[1]`` — the least-loaded *other* replica
        (i.e. the second-least-loaded overall when the primary was the
        least-loaded) — the cross-replica policy of the serving fleet,
        rather than a node ring position."""
        if not ranked:
            raise ValueError("run_ranked needs at least one worker index")
        replica = ranked[1] if len(ranked) > 1 else None
        return self.run_timed(task, ranked[0], replica)

    # ------------------------------------------------------- wall-clock mode
    def run_wall(
        self, task: Any, primary: int, replica: Optional[int] = None
    ) -> Tuple[Any, int, bool]:
        """Real-clock hedged dispatch: run the primary on a thread; if it
        produces nothing within ``deadline_s``, re-issue the task to the
        replica and return the first finisher's result.

        Returns ``(result, worker_that_served, hedge_fired)`` —
        ``hedge_fired`` reports whether *this* dispatch hedged (callers
        must not diff the shared counters, which concurrent dispatches
        also move). Loser results are discarded (counted ``wasted`` when
        the primary wins a fired hedge, ``hedge_wins`` when the replica
        does — the same counter semantics as the simulated mode). Worker
        exceptions re-raise in the caller unless the other worker already
        produced a result; a device fault re-raises as soon as it
        arrives."""
        with self._mu:
            self.stats.dispatched += 1
        results: "queue_mod.Queue[Tuple[int, Any, Optional[BaseException]]]" = (
            queue_mod.Queue()
        )

        def _run(w: int) -> None:
            try:
                bind_device(self.device)
                results.put((w, self.workers[w](task), None))
            except BaseException as e:      # noqa: BLE001 - relayed below
                results.put((w, None, e))

        threading.Thread(target=_run, args=(primary,), daemon=True).start()
        try:
            w, res, err = results.get(timeout=self.deadline_s)
            if err is not None:
                raise err
            return res, w, False
        except queue_mod.Empty:
            pass
        if replica is None:                 # nothing to hedge to: wait it out
            w, res, err = results.get()
            if err is not None:
                raise err
            return res, w, False
        with self._mu:
            self.stats.hedged += 1
        threading.Thread(target=_run, args=(replica,), daemon=True).start()
        first_err: Optional[BaseException] = None
        for _ in range(2):                  # first clean result wins
            w, res, err = results.get()
            if err is not None and is_device_fault(err):
                raise err
            if err is None:
                with self._mu:
                    if w == primary:
                        self.stats.wasted += 1
                    else:
                        self.stats.hedge_wins += 1
                return res, w, True
            first_err = first_err or err
        raise first_err                     # both workers failed

    def run_ranked_wall(
        self, task: Any, ranked: List[int]
    ) -> Tuple[Any, int, bool]:
        """Wall-clock twin of :meth:`run_ranked`: primary = ``ranked[0]``,
        hedge target = ``ranked[1]`` (the least-loaded other replica)."""
        if not ranked:
            raise ValueError("run_ranked_wall needs at least one worker index")
        replica = ranked[1] if len(ranked) > 1 else None
        return self.run_wall(task, ranked[0], replica)
