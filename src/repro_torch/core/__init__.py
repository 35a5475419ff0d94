"""HARMONY core: index build and layout, the int8 tier's codes, per-row
metadata and the mutable segmented data plane, probe selection, the
planner and its cost model, τ prewarm, the exact oracle, the two-stage
int8 search, the host engine, the cross-segment merges and the ring
pipeline on a virtual mesh."""

from repro_torch.core.cost_model import HardwareModel, WorkloadStats, plan_cost
from repro_torch.core.index import (
    TAG_MISSING,
    CompactionPlan,
    DataSnapshot,
    Int8Quant,
    IVFIndex,
    MetadataStore,
    Segment,
    SegmentedIndex,
    ShardedCorpus,
    assign_queries,
    build_ivf,
    dim_block_bounds,
    ivf_from_arrays,
    preassign,
    quantize_vectors,
)
from repro_torch.core.planner import PlanDecision, factorizations, plan_search
from repro_torch.core.pruning import (
    TopKHeap,
    exact_scores,
    partial_scores_block,
    prewarm_tau,
)
from repro_torch.core.search import (
    delta_topk,
    harmony_search,
    merge_topk,
    search_oracle,
    two_stage_search,
)
from repro_torch.core.types import (
    And,
    DataPlane,
    Filter,
    NumRange,
    Or,
    PartitionPlan,
    SearchRequest,
    SearchResult,
    TagIn,
)

__all__ = [
    "IVFIndex", "ShardedCorpus", "build_ivf", "ivf_from_arrays", "preassign",
    "assign_queries", "dim_block_bounds", "PartitionPlan", "SearchResult",
    "SearchRequest", "Filter", "TagIn", "NumRange", "And", "Or", "DataPlane",
    "MetadataStore", "TAG_MISSING",
    "Segment", "SegmentedIndex", "DataSnapshot", "CompactionPlan",
    "Int8Quant", "quantize_vectors",
    "plan_search", "factorizations", "PlanDecision", "HardwareModel",
    "WorkloadStats", "plan_cost", "harmony_search",
    "search_oracle", "delta_topk", "merge_topk", "two_stage_search",
    "TopKHeap", "exact_scores", "prewarm_tau", "partial_scores_block",
]
