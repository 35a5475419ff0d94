from repro_torch.data.vectors import (
    VectorDataset,
    brute_force_topk,
    make_dataset,
    make_queries,
    recall_at_k,
)
from repro_torch.data.tokens import TokenPipeline

__all__ = [
    "VectorDataset",
    "make_dataset",
    "make_queries",
    "brute_force_topk",
    "recall_at_k",
    "TokenPipeline",
]
