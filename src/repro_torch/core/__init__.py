"""HARMONY core, slice 1: index build and layout, probe selection, τ
prewarm, the exact oracle and the ring pipeline on a virtual mesh."""

from repro_torch.core.index import (
    IVFIndex,
    ShardedCorpus,
    assign_queries,
    build_ivf,
    dim_block_bounds,
    ivf_from_arrays,
    preassign,
)
from repro_torch.core.pruning import exact_scores, prewarm_tau
from repro_torch.core.search import search_oracle
from repro_torch.core.types import PartitionPlan, SearchResult

__all__ = [
    "IVFIndex", "ShardedCorpus", "build_ivf", "ivf_from_arrays", "preassign",
    "assign_queries", "dim_block_bounds", "PartitionPlan", "SearchResult",
    "exact_scores", "prewarm_tau", "search_oracle",
]
