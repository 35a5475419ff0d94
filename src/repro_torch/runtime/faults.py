"""Deterministic fault injection for the serving plane.

Chaos testing is only useful when a failure is *replayable*: a bug found
by a randomly-timed kill is a bug you can't regress-test. This module
makes every failure a named, counted event on the code path that would
really fail, so a chaos scenario is an ordinary deterministic test:

* production code declares **fault sites** by calling
  :func:`fault_point` at the instants where a real process could die or
  stall: each compactor phase boundary (``"compactor.begin"`` /
  ``".seal"`` / ``".prepare"`` / ``".commit"``), the checkpoint
  write/publish windows (``"checkpoint.write"`` /
  ``"checkpoint.publish"``), the tier swap (``"placement.prepare"`` /
  ``".swap"``) and the WAL record write (``"wal.append"``); the
  reference's replica batch execution (``"replica.execute"``) comes with
  the fleet. With no plan installed the call is a cheap no-op (one
  global read), so the serving fast path is unchanged;
* a test installs a
  :class:`FaultPlan` — a list of :class:`FaultSpec` triggers — via
  :func:`fault_scope`. Each spec fires on the Nth *matching* hit of its
  site, optionally filtered by context (``where={"replica": 0}``) and
  thinned by a seeded probability, so the same plan over the same trace
  fires at exactly the same instants on every run (virtual clock
  included — nothing here reads wall time);
* a firing spec either raises :class:`InjectedFault` (``kind="raise"``
  for an in-process failure whose cleanup handlers run, ``kind="crash"``
  for a simulated process death at a phase boundary — sites place crash
  points *outside* their cleanup handlers so the aftermath is exactly a
  kill's, ``kind="torn"`` for a write interrupted mid-record) or returns
  extra latency seconds (``kind="delay"`` — injected straggler time the
  caller charges to its service model).

Every firing is recorded in ``plan.log`` (site, hit number, context),
which doubles as the determinism witness: two runs of the same seeded
plan over the same trace produce identical logs.

>>> plan = FaultPlan(FaultSpec("replica.execute", at=2, where={"replica": 1}))
>>> with fault_scope(plan):
...     fault_point("replica.execute", replica=0)   # no match: replica 0
...     fault_point("replica.execute", replica=1)   # hit 1: armed at 2
...     try:
...         fault_point("replica.execute", replica=1)
...     except InjectedFault as e:
...         print("fired:", e.site)
0.0
0.0
fired: replica.execute
>>> plan.fired
1
"""

from __future__ import annotations

import threading
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np


class InjectedFault(RuntimeError):
    """A failure raised by an installed :class:`FaultPlan`.

    ``kind`` tells the instrumented site how to die: ``"raise"`` is an
    ordinary in-process error (cleanup runs), ``"crash"`` simulates a
    process kill at a phase boundary (sites re-raise it past their
    cleanup), ``"torn"`` asks a writer to persist a partial record
    before raising (a mid-``write(2)`` power cut)."""

    def __init__(self, site: str, kind: str = "raise", hit: int = 0):
        super().__init__(f"injected fault at {site!r} (kind={kind}, hit={hit})")
        self.site = site
        self.kind = kind
        self.hit = hit


@dataclass
class FaultSpec:
    """One trigger: fire ``count`` times starting at the ``at``-th
    matching hit of ``site`` (hits are 1-based and counted per spec).

    ``where`` filters by the context keywords the site reports (subset
    match: every listed key must be present and equal). ``p`` < 1 thins
    matching hits through the plan's seeded rng — still deterministic
    for a fixed seed. ``kind="delay"`` makes :func:`fault_point` return
    ``delay_s`` instead of raising (injected straggler latency)."""

    site: str
    at: int = 1
    count: int = 1
    kind: str = "raise"             # "raise" | "crash" | "delay" | "torn"
    delay_s: float = 0.0
    where: Optional[Dict[str, object]] = None
    p: float = 1.0

    def __post_init__(self):
        if self.kind not in ("raise", "crash", "delay", "torn"):
            raise ValueError(f"unknown fault kind {self.kind!r}")
        if self.at < 1 or self.count < 1:
            raise ValueError("at and count are 1-based and positive")


@dataclass
class FaultPlan:
    """A seeded, replayable schedule of :class:`FaultSpec` triggers.

    Thread-safe: hit counters and the firing log are guarded so faults
    can fire from the front-end's pool threads and the background
    compactor as deterministically as from a single-threaded replay
    (per-spec counting depends only on the sequence of matching hits
    each spec observes, not on cross-site interleaving)."""

    specs: Tuple[FaultSpec, ...] = ()
    seed: int = 0
    log: List[dict] = field(default_factory=list)

    def __init__(self, *specs: FaultSpec, seed: int = 0):
        self.specs = tuple(specs)
        self.seed = seed
        self.log = []
        self._hits = [0] * len(self.specs)
        self._rng = np.random.default_rng(seed)
        self._mu = threading.Lock()

    @property
    def fired(self) -> int:
        """How many faults have fired so far."""
        with self._mu:
            return len(self.log)

    def _matches(self, spec: FaultSpec, site: str, ctx: dict) -> bool:
        if spec.site != site:
            return False
        if spec.where:
            return all(k in ctx and ctx[k] == v for k, v in spec.where.items())
        return True

    def hit(self, site: str, **ctx) -> Optional[Tuple[FaultSpec, int]]:
        """Count one hit of ``site``; return the armed ``(spec, hit#)``
        if a spec fires, else None. First matching spec wins."""
        with self._mu:
            for i, spec in enumerate(self.specs):
                if not self._matches(spec, site, ctx):
                    continue
                self._hits[i] += 1
                h = self._hits[i]
                if not (spec.at <= h < spec.at + spec.count):
                    continue
                if spec.p < 1.0 and self._rng.random() >= spec.p:
                    continue
                self.log.append(
                    {"site": site, "kind": spec.kind, "hit": h, **ctx}
                )
                return spec, h
        return None


# One plan active at a time, process-wide: chaos scenarios run serially
# (a test installs a plan around one trace), while the *firing* threads —
# pool workers, the compactor loop — may be many.
_ACTIVE: Optional[FaultPlan] = None


def install_fault_plan(plan: Optional[FaultPlan]) -> None:
    """Install ``plan`` process-wide (None clears). Prefer the
    :func:`fault_scope` context manager, which restores on exit."""
    global _ACTIVE
    _ACTIVE = plan


def active_fault_plan() -> Optional[FaultPlan]:
    return _ACTIVE


@contextmanager
def fault_scope(*specs_or_plan, seed: int = 0) -> Iterator[FaultPlan]:
    """Install a fault plan for the duration of the block.

    Accepts either a ready :class:`FaultPlan` or :class:`FaultSpec`\\ s
    to build one from. Yields the plan (inspect ``plan.log`` after)."""
    if len(specs_or_plan) == 1 and isinstance(specs_or_plan[0], FaultPlan):
        plan = specs_or_plan[0]
    else:
        plan = FaultPlan(*specs_or_plan, seed=seed)
    prev = _ACTIVE
    install_fault_plan(plan)
    try:
        yield plan
    finally:
        install_fault_plan(prev)


def fault_point(site: str, **ctx) -> float:
    """Declare a fault site. Returns injected extra latency in seconds
    (0.0 normally); raises :class:`InjectedFault` when an installed plan
    fires a ``raise``/``crash``/``torn`` spec here. No-op (and free)
    when no plan is installed."""
    plan = _ACTIVE
    if plan is None:
        return 0.0
    armed = plan.hit(site, **ctx)
    if armed is None:
        return 0.0
    spec, h = armed
    if spec.kind == "delay":
        return spec.delay_s
    raise InjectedFault(site, spec.kind, h)
