"""Two-tier semantic query cache + coalescing support for the serving
front door (the ROADMAP's "survive million-user traffic" item).

Real query streams are heavily repetitive, but the admission queue
executes every duplicate as if it were fresh work. :class:`QueryCache`
sits *in front of admission* (``ServingScheduler.submit`` /
``ServingFrontend.submit``) and answers repeats from already-paid-for
work:

* **exact tier** — a TTL'd map keyed by the canonical request identity
  (query-vector bytes + k + filter + hybrid text + precision). A hit
  replays a previously served answer verbatim, so it is bit-identical to
  re-executing the request against the same data-plane state.
* **semantic tier** — answers a query from a previously served
  *neighbor* within ``semantic_threshold``. Finding that neighbor is
  itself a tiny exact ANN search, so it reuses the repo's own scan
  machinery: the cached query vectors of one (k, options) group form a
  small brute-force index scanned with
  :func:`repro_torch.core.search.delta_topk` (the delta-buffer primitive)
  on the served plane's device.
  Thresholds are in **score space** — squared L2 for the ``"l2"``
  metric — and the boundary is inclusive (a query at exactly the
  threshold hits). The semantic tier is L2-only.

Staleness is bounded by a cheap *epoch*, read from the root data plane
on every lookup/insert: ``(generation, op_count)`` of the underlying
:class:`repro_torch.core.SegmentedIndex`. The rules (enforced in
:meth:`QueryCache.lookup`):

* a **generation swap** (compaction commit — the adoption path,
  ``HarmonyServer.adopt`` / the fleet's shared plane) invalidates
  unconditionally: no hit is ever served across it;
* an **upsert/delete** (``op_count`` moved) invalidates once the entry
  is older than ``staleness_s`` — the configured staleness budget; with
  the default budget of 0 every write invalidates immediately;
* entries expire after ``exact_ttl_s`` regardless of writes.

So a cache entry can never outlive the snapshot it was computed from by
more than the staleness budget. Entries are stamped with the epoch read
*before* their batch executed (conservative: a write that lands
mid-execution makes the entry count as already-stale).

In-flight request **coalescing** (``CacheConfig.coalesce``) is the third
leg: concurrent duplicate submissions share one execution instead of
enqueueing N times — in :class:`~repro_torch.serve.frontend.ServingFrontend`
duplicates attach to the in-flight leader's future; in
:class:`~repro_torch.serve.scheduler.ServingScheduler` duplicate rows of a
formed batch execute once and fan out (deterministic on the virtual
clock, so replay harnesses exercise it).

Default-off: ``SchedulerConfig(cache=None)`` (or
``CacheConfig(enabled=False)``) leaves every admission code path
byte-identical to the cache-less scheduler — the virtual-clock goldens
pin this.

>>> import numpy as np
>>> epoch = [0, 0]                       # (generation, op_count) stand-in
>>> c = QueryCache(CacheConfig(enabled=True, exact_ttl_s=10.0,
...                            semantic_threshold=4.0),
...                epoch_fn=lambda: tuple(epoch), device="cpu")
>>> q = np.zeros(4, np.float32)
>>> c.insert(q, 3, (None, None, None),
...          np.array([5, 7, -1]), np.array([0.1, 0.2, np.inf]), now_s=0.0)
>>> c.lookup(q, 3, (None, None, None), now_s=1.0).tier
'exact'
>>> near = q.copy(); near[0] = 2.0       # sq-L2 distance exactly 4.0
>>> c.lookup(near, 3, (None, None, None), now_s=1.0).tier   # inclusive
'semantic'
>>> epoch[0] += 1                        # generation swap
>>> c.lookup(q, 3, (None, None, None), now_s=1.0) is None
True
>>> (c.stats.cache_hits_exact, c.stats.cache_hits_semantic,
...  c.stats.cache_misses, c.stats.cache_invalidations)
(1, 1, 1, 1)
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch._device import DeviceLike
from repro_torch.core.search import delta_topk


@dataclass(frozen=True)
class CacheConfig:
    """Knobs of the admission-side query cache (frozen so it can ride
    inside the frozen ``SchedulerConfig``). All durations are seconds.

    ``enabled=False`` (the default) keeps the whole front door inert —
    scheduler and front-end behave byte-identically to a cache-less
    build. ``semantic_threshold`` is in score space (squared L2),
    inclusive at the boundary; 0 disables the semantic tier (exact tier
    only). ``staleness_s`` is the budget an entry may be served across
    upserts/deletes (generation swaps always invalidate). ``max_entries``
    bounds the cache with deterministic LRU eviction. ``coalesce``
    additionally merges concurrent duplicate submissions into one
    execution."""

    enabled: bool = False
    exact_ttl_s: float = 60.0
    semantic_threshold: float = 0.0
    staleness_s: float = 0.0
    max_entries: int = 4096
    coalesce: bool = True


@dataclass
class CacheHit:
    """A served-from-cache answer: the stored top-K plus which tier
    produced it (``"exact"`` | ``"semantic"``)."""

    ids: np.ndarray                 # [K] int64, -1 padded
    scores: np.ndarray              # [K] float32, +inf padded
    tier: str


@dataclass
class _Entry:
    key: tuple                      # exact-tier key (vec bytes, k, options)
    group_key: tuple                # semantic-tier group (k, options)
    row: int                        # row in the group's vector buffer
    ids: np.ndarray
    scores: np.ndarray
    generation: int                 # epoch at (pre-execution of) insert
    op_count: int
    time_s: float


class _Group:
    """Vector buffer of one (k, options) semantic group — a tiny
    append-only brute-force index with a live mask (dead rows are
    evicted/invalidated entries), scanned by ``delta_topk``."""

    __slots__ = ("x", "live", "keys", "n")

    def __init__(self, dim: int):
        self.x = np.zeros((8, dim), np.float32)
        self.live = np.zeros(8, bool)
        self.keys: List[Optional[tuple]] = [None] * 8
        self.n = 0

    def append(self, vec: np.ndarray, key: tuple) -> int:
        if self.n == self.x.shape[0]:
            grow = self.x.shape[0]
            self.x = np.concatenate(
                [self.x, np.zeros((grow, self.x.shape[1]), np.float32)]
            )
            self.live = np.concatenate([self.live, np.zeros(grow, bool)])
            self.keys.extend([None] * grow)
        row = self.n
        self.x[row] = vec
        self.live[row] = True
        self.keys[row] = key
        self.n += 1
        return row

    def kill(self, row: int) -> None:
        self.live[row] = False
        self.keys[row] = None


def vec_bytes(vector: np.ndarray) -> bytes:
    """Canonical byte identity of a query vector (float32, contiguous) —
    the exact tier's vector component and the coalescing dedup key."""
    return np.ascontiguousarray(np.asarray(vector, np.float32)).tobytes()


class QueryCache:
    """The two-tier cache. Thread-safe (one lock around both tiers) —
    the wall-clock front-end looks up from submitter threads and inserts
    from pool workers; the virtual-clock scheduler is single-threaded and
    fully deterministic.

    ``epoch_fn`` returns the live ``(generation, op_count)`` of the data
    plane being served (see :func:`build_query_cache`); ``stats`` is the
    shared :class:`repro_torch.serve.engine.ServeStats` whose
    ``cache_hits_exact`` / ``cache_hits_semantic`` / ``cache_misses`` /
    ``cache_invalidations`` counters this cache bumps. ``device`` is where
    the semantic tier's scan runs (CUDA by default; the served plane's
    device under :func:`build_query_cache`).
    """

    def __init__(
        self,
        cfg: CacheConfig,
        epoch_fn: Optional[Callable[[], Tuple[int, int]]] = None,
        stats=None,
        metric: str = "l2",
        device: DeviceLike = None,
    ):
        if cfg.semantic_threshold > 0 and metric != "l2":
            raise ValueError(
                "the semantic tier's distance threshold is squared-L2 "
                "score space; metric %r is not supported" % metric
            )
        self.cfg = cfg
        self.metric = metric
        self.device = device
        self.epoch_fn = epoch_fn or (lambda: (0, 0))
        if stats is None:
            from repro_torch.serve.engine import ServeStats

            stats = ServeStats()
        self.stats = stats
        self._mu = threading.Lock()
        self._entries: "OrderedDict[tuple, _Entry]" = OrderedDict()
        self._groups: Dict[tuple, _Group] = {}

    def __len__(self) -> int:
        return len(self._entries)

    @staticmethod
    def request_key(vector, k: int, options: tuple) -> tuple:
        """Exact-tier identity of a request: vector bytes + k +
        (filter, hybrid_text, precision). Filters are frozen/hashable by
        construction, so the tuple is a dict key."""
        return (vec_bytes(vector), int(k), options)

    def epoch(self) -> Tuple[int, int]:
        return tuple(self.epoch_fn())

    # ------------------------------------------------------------ validity
    def _valid(self, e: _Entry, epoch: Tuple[int, int], now_s: float) -> bool:
        gen, ops = epoch
        if e.generation != gen:
            return False                    # never across a generation swap
        if now_s - e.time_s > self.cfg.exact_ttl_s:
            return False                    # TTL bound
        if e.op_count != ops and now_s - e.time_s > self.cfg.staleness_s:
            return False                    # writes landed, budget spent
        return True

    def _drop(self, e: _Entry) -> None:
        self._entries.pop(e.key, None)
        g = self._groups.get(e.group_key)
        if g is not None and e.row < g.n and g.keys[e.row] == e.key:
            g.kill(e.row)
        self.stats.cache_invalidations += 1

    # -------------------------------------------------------------- lookup
    def lookup(self, vector, k: int, options: tuple,
               now_s: float) -> Optional[CacheHit]:
        """Try both tiers for (vector, k, options) at time ``now_s``.
        Invalid entries encountered along the way are dropped (counted in
        ``cache_invalidations``); a miss is counted in ``cache_misses``."""
        v = np.ascontiguousarray(np.asarray(vector, np.float32))
        key = (v.tobytes(), int(k), options)
        with self._mu:
            epoch = self.epoch()
            e = self._entries.get(key)
            if e is not None:
                if self._valid(e, epoch, now_s):
                    self._entries.move_to_end(key)      # LRU refresh
                    self.stats.cache_hits_exact += 1
                    return CacheHit(e.ids.copy(), e.scores.copy(), "exact")
                self._drop(e)
            thr = self.cfg.semantic_threshold
            if thr > 0:
                g = self._groups.get((int(k), options))
                # nearest cached query via the delta-buffer scan primitive;
                # re-scan after dropping a stale best candidate
                while g is not None and g.n and g.live[:g.n].any():
                    sc, rows = delta_topk(
                        g.x[:g.n], np.arange(g.n), g.live[:g.n],
                        v[None, :], 1, self.metric, device=self.device,
                    )
                    row = int(rows[0, 0])
                    if row < 0 or float(sc[0, 0]) > thr:
                        break
                    e = self._entries.get(g.keys[row])
                    if e is None:           # defensive: orphaned row
                        g.kill(row)
                        continue
                    if self._valid(e, epoch, now_s):
                        self.stats.cache_hits_semantic += 1
                        return CacheHit(
                            e.ids.copy(), e.scores.copy(), "semantic"
                        )
                    self._drop(e)
            self.stats.cache_misses += 1
            return None

    # -------------------------------------------------------------- insert
    def insert(self, vector, k: int, options: tuple, ids, scores,
               now_s: float, epoch: Optional[Tuple[int, int]] = None) -> None:
        """Store one served answer. ``epoch`` should be the epoch read
        *before* the answer's batch executed (conservative staleness
        stamping); None reads the live epoch."""
        v = np.ascontiguousarray(np.asarray(vector, np.float32))
        key = (v.tobytes(), int(k), options)
        with self._mu:
            gen, ops = self.epoch() if epoch is None else epoch
            old = self._entries.pop(key, None)
            if old is not None:             # refresh, not an invalidation
                g = self._groups.get(old.group_key)
                if (g is not None and old.row < g.n
                        and g.keys[old.row] == old.key):
                    g.kill(old.row)
            while len(self._entries) >= max(1, self.cfg.max_entries):
                _, victim = self._entries.popitem(last=False)   # LRU evict
                g = self._groups.get(victim.group_key)
                if (g is not None and victim.row < g.n
                        and g.keys[victim.row] == victim.key):
                    g.kill(victim.row)
            gkey = (int(k), options)
            g = self._groups.get(gkey)
            if g is None:
                g = self._groups[gkey] = _Group(v.shape[0])
            self._maybe_compact(g)
            row = g.append(v, key)
            self._entries[key] = _Entry(
                key=key, group_key=gkey, row=row,
                ids=np.array(ids, np.int64, copy=True).reshape(-1),
                scores=np.array(scores, np.float32, copy=True).reshape(-1),
                generation=int(gen), op_count=int(ops),
                time_s=float(now_s),
            )

    def _maybe_compact(self, g: _Group) -> None:
        """Rebuild a group's buffer when dead rows dominate (evictions /
        invalidations leave holes; the scan cost tracks ``n``, so shrink
        it back to the live set). Entry rows are remapped in place."""
        if g.n < 64 or int(g.live[:g.n].sum()) * 2 > g.n:
            return
        live_rows = np.nonzero(g.live[:g.n])[0]
        for new_row, old_row in enumerate(live_rows):
            e = self._entries.get(g.keys[old_row])
            if e is not None:
                e.row = new_row
        g.x[:live_rows.size] = g.x[live_rows]
        g.keys[:live_rows.size] = [g.keys[r] for r in live_rows]
        g.live[:live_rows.size] = True
        g.live[live_rows.size:] = False
        g.keys[live_rows.size:] = [None] * (len(g.keys) - live_rows.size)
        g.n = int(live_rows.size)

    # ---------------------------------------------------------- bulk hooks
    def invalidate_all(self) -> int:
        """Drop every entry (counted in ``cache_invalidations``); returns
        how many were dropped. The epoch rules make this unnecessary for
        correctness — it is an explicit hook for tests and operators."""
        with self._mu:
            n = len(self._entries)
            self._entries.clear()
            self._groups.clear()
            self.stats.cache_invalidations += n
            return n


def build_query_cache(sched_cfg, target, stats) -> Optional[QueryCache]:
    """Construct the cache a scheduler/front-end config asks for (or None
    when ``cfg.cache`` is absent/disabled — the inert default). The epoch
    source is the *root* data plane under ``target``
    (:meth:`repro_torch.core.types.DataPlane._root_data_plane` — ultimately the
    shared :class:`repro_torch.core.SegmentedIndex`, so fleet-wide writes and
    compaction commits are seen no matter which surface made them), and
    so is the semantic scan's device; stub targets without a data plane
    get a constant epoch and the default device."""
    ccfg: Optional[CacheConfig] = getattr(sched_cfg, "cache", None)
    if ccfg is None or not ccfg.enabled:
        return None
    try:
        root = target._root_data_plane()
    except NotImplementedError:
        root = None
    metric = getattr(getattr(root, "cfg", None), "metric", "l2")
    if root is None or not hasattr(root, "generation"):
        epoch_fn = lambda: (0, 0)               # noqa: E731 - constant epoch
    else:
        epoch_fn = lambda: (root.generation, root.op_count)  # noqa: E731
    return QueryCache(ccfg, epoch_fn=epoch_fn, stats=stats, metric=metric,
                      device=getattr(root, "device", None))
