"""Load-aware routing: cluster → vector-shard assignment (§4.2.2) and the
staggered dimension-ring start offsets. Host-side numpy, as in the
reference."""

from __future__ import annotations

from typing import Optional

import numpy as np


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
