"""HARMONY core: index build and layout, the int8 tier's codes, per-row
metadata and the mutable segmented data plane, probe selection, filters,
the planner and its cost model, τ prewarm, the exact oracle, the
two-stage int8 search, the host engine, the cross-segment merges, BM25
and rank fusion, and the ring pipeline on a virtual mesh. The cost
model's hardware is the card's: ``H100_SXM`` takes the place of the
reference's pod model, and ``calibrate_hardware`` fits one to measured
rates."""

from repro_torch.core.cost_model import (
    H100_SXM,
    HardwareModel,
    WorkloadStats,
    calibrate_hardware,
    plan_cost,
)
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
    segment_device_bytes,
)
from repro_torch.core.planner import PlanDecision, factorizations, plan_search
from repro_torch.core.pruning import (
    TopKHeap,
    exact_scores,
    partial_scores_block,
    prewarm_tau,
)
from repro_torch.core.fusion import (
    BM25Index,
    reciprocal_rank_fusion,
    segment_bm25,
    tokenize,
)
from repro_torch.core.search import (
    delta_topk,
    filter_bitmap,
    filter_excluded_rows,
    filtered_assign_queries,
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
    "Int8Quant", "quantize_vectors", "segment_device_bytes",
    "plan_search", "factorizations", "PlanDecision", "HardwareModel",
    "H100_SXM", "calibrate_hardware", "WorkloadStats", "plan_cost", "harmony_search",
    "search_oracle", "delta_topk", "merge_topk", "two_stage_search",
    "filter_bitmap", "filter_excluded_rows", "filtered_assign_queries",
    "BM25Index", "tokenize", "segment_bm25", "reciprocal_rank_fusion",
    "TopKHeap", "exact_scores", "prewarm_tau", "partial_scores_block",
]
