"""HARMONY core: index build and layout, the int8 tier's codes, probe
selection, τ prewarm, the exact oracle, the two-stage int8 search and the
ring pipeline on a virtual mesh."""

from repro_torch.core.index import (
    Int8Quant,
    IVFIndex,
    ShardedCorpus,
    assign_queries,
    build_ivf,
    dim_block_bounds,
    ivf_from_arrays,
    preassign,
    quantize_vectors,
)
from repro_torch.core.pruning import exact_scores, prewarm_tau
from repro_torch.core.search import search_oracle, two_stage_search
from repro_torch.core.types import PartitionPlan, SearchResult

__all__ = [
    "IVFIndex", "ShardedCorpus", "build_ivf", "ivf_from_arrays", "preassign",
    "assign_queries", "dim_block_bounds", "PartitionPlan", "SearchResult",
    "Int8Quant", "quantize_vectors",
    "exact_scores", "prewarm_tau", "search_oracle", "two_stage_search",
]
