"""Core datatypes: the partition plan and the search result.

``Filter``, ``SearchRequest`` and ``DataPlane`` come with the served
entry point in a later slice.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

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


@dataclass
class SearchResult:
    ids: np.ndarray                         # [NQ, K] int64 (original vector ids, -1 pad)
    scores: np.ndarray                      # [NQ, K] float32 (ascending; sq-L2 or -IP)
    stats: dict = field(default_factory=dict)
