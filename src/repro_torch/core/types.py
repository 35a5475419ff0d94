"""Core datatypes: partition plans, filters, requests, results.

This module is the serving surface's vocabulary: a query is a
:class:`SearchRequest` (vector + per-request knobs), an answer is a
:class:`SearchResult`, a predicate is a :class:`Filter` expression tree,
and every layer that accepts writes implements :class:`DataPlane`. Pure
Python and numpy, as in the reference.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import numpy as np


@dataclass(frozen=True)
class PartitionPlan:
    """A HARMONY partition plan π on a ``v_shards × d_blocks`` grid.

    ``cluster_to_shard[c]`` maps IVF cluster c to a vector shard;
    ``ring_offsets[v]`` staggers the dimension-ring start of shard v.
    """

    v_shards: int
    d_blocks: int
    cluster_to_shard: np.ndarray            # [nlist] int32
    ring_offsets: Optional[np.ndarray] = None   # [v_shards] int32, default zeros
    mode: str = "harmony"                   # harmony | vector | dimension

    def __post_init__(self):
        if self.cluster_to_shard.ndim != 1:
            raise ValueError("cluster_to_shard must be 1-D")
        if self.ring_offsets is None:
            object.__setattr__(
                self, "ring_offsets", np.zeros((self.v_shards,), np.int32)
            )

    @property
    def n_nodes(self) -> int:
        return self.v_shards * self.d_blocks


# --------------------------------------------------------------- filters
class Filter:
    """Predicate over per-row metadata, pushed down into the index scan.

    A filter is a small expression tree over tag columns (int64) and
    numeric columns (float32): :class:`TagIn`, :class:`NumRange`, composed
    with :class:`And` / :class:`Or` (or the ``&`` / ``|`` operators).
    Evaluation is vectorized — :meth:`evaluate` maps a segment's columnar
    metadata to a boolean *allowed* mask over its rows, which the engine
    complements and merges into the tombstone (``dead_rows``) masking path.

    Every concrete filter is a frozen, hashable dataclass, so a filter
    value doubles as a cache key for its compiled per-segment bitmaps.

    >>> import numpy as np
    >>> f = TagIn("color", (1, 3)) & NumRange("price", 10.0, 20.0)
    >>> tags = {"color": np.array([1, 2, 3, 3])}
    >>> nums = {"price": np.array([15.0, 15.0, 5.0, 12.0], np.float32)}
    >>> f.evaluate(tags, nums, 4).tolist()
    [True, False, False, True]
    >>> (TagIn("color", (2,)) | NumRange("price", hi=6.0)).evaluate(
    ...     tags, nums, 4).tolist()
    [False, True, True, False]
    """

    def evaluate(
        self,
        tags: Dict[str, np.ndarray],
        nums: Dict[str, np.ndarray],
        n: int,
    ) -> np.ndarray:
        """Boolean allowed-mask [n] over rows with the given columns.

        A referenced column that a segment doesn't carry matches no row
        (absent metadata can't satisfy a predicate on it)."""
        raise NotImplementedError

    def __and__(self, other: "Filter") -> "And":
        return And((self, other))

    def __or__(self, other: "Filter") -> "Or":
        return Or((self, other))


@dataclass(frozen=True)
class TagIn(Filter):
    """``column ∈ values`` over an int tag column."""

    column: str
    values: Tuple[int, ...]

    def __post_init__(self):
        object.__setattr__(
            self, "values", tuple(sorted(int(v) for v in self.values))
        )

    def evaluate(self, tags, nums, n):
        col = tags.get(self.column)
        if col is None:
            return np.zeros(n, bool)
        return np.isin(col[:n], np.asarray(self.values, np.int64))


@dataclass(frozen=True)
class NumRange(Filter):
    """``lo ≤ column ≤ hi`` over a float numeric column (bounds
    inclusive; omit one for a half-open range)."""

    column: str
    lo: float = -np.inf
    hi: float = np.inf

    def __post_init__(self):
        object.__setattr__(self, "lo", float(self.lo))
        object.__setattr__(self, "hi", float(self.hi))

    def evaluate(self, tags, nums, n):
        col = nums.get(self.column)
        if col is None:
            return np.zeros(n, bool)
        col = col[:n]
        return (col >= self.lo) & (col <= self.hi)


@dataclass(frozen=True)
class And(Filter):
    """Conjunction of clauses."""

    clauses: Tuple[Filter, ...]

    def __post_init__(self):
        object.__setattr__(self, "clauses", tuple(self.clauses))

    def evaluate(self, tags, nums, n):
        out = np.ones(n, bool)
        for c in self.clauses:
            out &= c.evaluate(tags, nums, n)
        return out


@dataclass(frozen=True)
class Or(Filter):
    """Disjunction of clauses."""

    clauses: Tuple[Filter, ...]

    def __post_init__(self):
        object.__setattr__(self, "clauses", tuple(self.clauses))

    def evaluate(self, tags, nums, n):
        out = np.zeros(n, bool)
        for c in self.clauses:
            out |= c.evaluate(tags, nums, n)
        return out


# ------------------------------------------------------- request / result
@dataclass
class SearchRequest:
    """One search: the vector plus every per-request knob.

    This is the canonical request shape across the whole serving surface
    (``ServingFrontend.submit`` / ``ServingScheduler.submit`` /
    ``HarmonyServer.search_batch``); bare ``np.ndarray`` queries are
    still accepted everywhere and auto-wrapped (with a
    ``DeprecationWarning``) for pre-request-API call sites.

    * ``vector`` — [D] (or [NQ, D] for batch entry points) float32.
    * ``k`` — top-k override (None → the serving default).
    * ``filter`` — a :class:`Filter` metadata predicate, or None.
    * ``hybrid_text`` — lexical query text; when set, BM25 scores are
      fused with the vector top-k by reciprocal-rank fusion
      (filtered and hybrid search come with a later slice of the port).
    * ``precision`` — "fp32" | "int8" override, or None for the server's
      configured tier.
    * ``deadline`` — absolute clock time after which the caller no longer
      wants an answer. Enforced per request by the scheduler and
      front-end: a request whose deadline passed before dispatch is shed
      with the sentinel degradation path (ids -1, +inf scores, counted in
      ``stats.expired_requests``) instead of executed; cache hits honor
      it trivially (they complete at arrival).
    """

    vector: np.ndarray
    k: Optional[int] = None
    filter: Optional[Filter] = None
    hybrid_text: Optional[str] = None
    precision: Optional[str] = None
    deadline: Optional[float] = None

    def options_key(self):
        """Hashable grouping key: requests with equal keys may be batched
        and executed together (the batch shares one filter/hybrid/precision
        context)."""
        return (self.filter, self.hybrid_text, self.precision)


@dataclass
class SearchResult:
    ids: np.ndarray                         # [NQ, K] int64 (original vector ids, -1 pad)
    scores: np.ndarray                      # [NQ, K] float32 (ascending; sq-L2 or -IP)
    stats: dict = field(default_factory=dict)


# ------------------------------------------------------------- data plane
class DataPlane:
    """The one write surface every serving layer exposes.

    ``upsert(ids, vecs, meta=None)`` / ``delete(ids)`` used to be
    copy-pasted forwarders on the engine, scheduler target, fleet, and
    frontend, each with its own drifting docstring. They are now all this
    mixin: a subclass implements ``_data_plane()`` (returning the next
    layer down — ultimately a :class:`repro_torch.core.SegmentedIndex`) and
    optionally ``_note_write(kind, n)`` for its own accounting.

    Semantics (identical at every layer): ``upsert`` inserts or replaces
    whole rows by external id — ``meta`` is an optional dict of metadata
    columns (int columns become tags, float columns numerics, a ``"text"``
    entry of strings feeds the lexical scorer); ``delete`` tombstones ids
    and returns how many were actually live. Writes are immediately
    visible to subsequent searches.

    >>> import numpy as np
    >>> from repro_torch.config import HarmonyConfig
    >>> from repro_torch.core import SegmentedIndex
    >>> class Plane(DataPlane):
    ...     def __init__(self, data):
    ...         self.data, self.writes = data, 0
    ...     def _data_plane(self):
    ...         return self.data
    ...     def _note_write(self, kind, n):
    ...         self.writes += n
    >>> p = Plane(SegmentedIndex(HarmonyConfig(dim=4, nlist=2), (), device="cpu"))
    >>> p.upsert([7, 8], np.ones((2, 4), np.float32), meta={"tag": [1, 2]})
    >>> p.delete([7, 99])
    1
    >>> p.writes
    4
    """

    def _data_plane(self):
        """The layer writes forward to (override)."""
        raise NotImplementedError

    def _root_data_plane(self):
        """Follow ``_data_plane()`` to the bottom of the stack — ultimately
        the shared :class:`repro_torch.core.SegmentedIndex`. The serving-side
        query cache reads its ``(generation, op_count)`` epoch here, so
        writes and compaction commits invalidate cached answers no matter
        which layer performed them (frontend, scheduler target, fleet, or
        the plane directly)."""
        obj = self
        for _ in range(8):                  # defensive depth bound
            if not isinstance(obj, DataPlane):
                break
            obj = obj._data_plane()
        return obj

    def _note_write(self, kind: str, n: int) -> None:
        """Accounting hook: ``kind`` is "upsert" | "delete", ``n`` the
        number of id rows the caller passed (the historical counter
        semantics — ``delete`` still *returns* the actually-live count).
        Default: no-op."""

    def upsert(self, ids, vecs, meta=None) -> None:
        n = len(np.asarray(ids, np.int64).reshape(-1))
        self._data_plane().upsert(ids, vecs, meta)
        self._note_write("upsert", n)

    def delete(self, ids) -> int:
        n = len(np.asarray(ids, np.int64).reshape(-1))
        removed = self._data_plane().delete(ids)
        self._note_write("delete", n)
        return removed
