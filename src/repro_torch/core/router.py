"""Load-aware routing: cluster → vector-shard assignment (§4.2.2), the
staggered dimension-ring start offsets, and the workload statistics the
planner reads. Host-side numpy, as in the reference."""

from __future__ import annotations

from typing import Optional

import numpy as np


def round_robin_assignment(nlist: int, v_shards: int) -> np.ndarray:
    """The naive baseline: cluster id mod V."""
    return (np.arange(nlist) % v_shards).astype(np.int32)


def load_aware_assignment(
    cluster_sizes: np.ndarray,
    cluster_hits: Optional[np.ndarray],
    v_shards: int,
) -> np.ndarray:
    """Greedy LPT on expected load = size × hits (hits default 1)."""
    nlist = len(cluster_sizes)
    hits = np.ones(nlist) if cluster_hits is None else np.asarray(cluster_hits, float)
    load = cluster_sizes.astype(float) * np.maximum(hits, 1e-9)
    order = np.argsort(-load, kind="stable")
    shard_load = np.zeros(v_shards)
    out = np.zeros(nlist, np.int32)
    for c in order:
        v = int(np.argmin(shard_load))
        out[c] = v
        shard_load[v] += load[c]
    return out


def ring_offsets(v_shards: int, d_blocks: int, stagger: bool = True) -> np.ndarray:
    """Start offsets per shard for the dimension ring. Staggered offsets
    spread the expensive slot-0 work across dimension blocks."""
    if not stagger or d_blocks <= 1:
        return np.zeros(v_shards, np.int32)
    return (np.arange(v_shards) % d_blocks).astype(np.int32)


def estimate_cluster_hits(probes: np.ndarray, nlist: int) -> np.ndarray:
    """Per-cluster query hit counts from a probe sample [NQ, P]."""
    probes = probes.reshape(-1)
    return np.bincount(probes[probes >= 0], minlength=nlist).astype(np.float64)


DEFAULT_HOT_FRACTION = 0.1


def workload_concentration(
    hits: np.ndarray, hot_fraction: float = DEFAULT_HOT_FRACTION
) -> float:
    """Share of probe mass on the hottest ``ceil(hot_fraction · nlist)``
    clusters: 1.0 when all traffic is on the hot set, ``hot_fraction``
    when it is uniform."""
    hits = np.asarray(hits, np.float64)
    total = float(hits.sum())
    if total <= 0 or hits.size == 0:
        return 0.0
    n_hot = max(1, int(np.ceil(hot_fraction * hits.size)))
    return float(np.sort(hits)[::-1][:n_hot].sum() / total)
