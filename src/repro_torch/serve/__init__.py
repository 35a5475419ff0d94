"""Serving layer: scheduler-backed batched ANNS over the HARMONY core.

Every scheduled batch executes through ``HarmonyServer.search_batch``,
which dispatches to one of two engines: ``backend="spmd"`` (the
default), the device-resident executor
(:class:`repro_torch.serve.executor.SpmdExecutor`) running the ring on
the card's kernels, or ``backend="host"``, the staged numpy engine
(:func:`repro_torch.core.search.harmony_search`), on request. Select per
server, per call (``search_batch(q, backend=...)``) or per scheduler
(``SchedulerConfig(backend=...)``); both return the same top-K up to
floating-point tie order.

The scheduler's batch former hands formed batches to a
:class:`repro_torch.serve.scheduler.DispatchTarget`:
:class:`~repro_torch.serve.scheduler.SingleServerTarget` (one server) or
:class:`repro_torch.serve.fleet.ReplicaFleet` (N replicas over one shared
data plane, load-estimate routing, power-of-two-choices sampling,
cross-replica hedging, circuit breakers, fail/join elasticity).

The queue/deadline/shed logic is clock-agnostic
(:class:`repro_torch.serve.clock.Clock`):
:class:`~repro_torch.serve.scheduler.ServingScheduler` with a
:class:`~repro_torch.serve.clock.VirtualClock` replays a trace
deterministically (the goldens in ``tests/goldens`` pin it), and
:class:`~repro_torch.serve.frontend.ServingFrontend` with a
:class:`~repro_torch.serve.clock.MonotonicClock` serves live traffic
(futures, asyncio, a dispatcher thread and a pool that overlaps replica
execution). A :class:`~repro_torch.serve.cache.QueryCache` can answer
repeats at admission.

Servers serve a shared :class:`repro_torch.core.SegmentedIndex`; writes
go in at every level, :class:`repro_torch.serve.compactor.Compactor`
seals and merges in the background, and the placement policy
(:mod:`repro_torch.serve.placement`) moves segments between the card and
the host tier.
"""

from repro_torch.core.types import (
    And,
    DataPlane,
    Filter,
    NumRange,
    Or,
    SearchRequest,
    SearchResult,
    TagIn,
)
from repro_torch.serve.cache import CacheConfig, CacheHit, QueryCache
from repro_torch.serve.clock import Clock, MonotonicClock, VirtualClock
from repro_torch.serve.compactor import CompactionConfig, Compactor
from repro_torch.serve.engine import HarmonyServer, ServeStats
from repro_torch.serve.executor import ExecutorConfig, SpmdExecutor
from repro_torch.serve.fleet import Replica, ReplicaFleet, ReplicaSpec, gini
from repro_torch.serve.frontend import ServingFrontend, ShedError
from repro_torch.serve.placement import (
    PlacementConfig,
    apply_placement,
    device_bytes_by_segment,
    plan_placement,
)
from repro_torch.serve.scheduler import (
    DispatchTarget,
    Request,
    RequestResult,
    SchedulerConfig,
    ServingScheduler,
    SingleServerTarget,
    SkewMonitor,
)

__all__ = [
    "HarmonyServer",
    "ServeStats",
    "SearchRequest",
    "SearchResult",
    "Filter",
    "TagIn",
    "NumRange",
    "And",
    "Or",
    "DataPlane",
    "CacheConfig",
    "CacheHit",
    "QueryCache",
    "Compactor",
    "CompactionConfig",
    "PlacementConfig",
    "plan_placement",
    "apply_placement",
    "device_bytes_by_segment",
    "ExecutorConfig",
    "SpmdExecutor",
    "Clock",
    "VirtualClock",
    "MonotonicClock",
    "DispatchTarget",
    "SingleServerTarget",
    "SkewMonitor",
    "Replica",
    "ReplicaFleet",
    "ReplicaSpec",
    "gini",
    "Request",
    "RequestResult",
    "SchedulerConfig",
    "ServingScheduler",
    "ServingFrontend",
    "ShedError",
]
