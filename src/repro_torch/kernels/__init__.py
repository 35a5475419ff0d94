"""Hand-written Hopper kernels (``csrc/*.cu``), their wrappers, their plain
PyTorch versions (``ref``) and the dispatch between them (``ops``), whose
entry points the package exports as the reference's does."""

from repro_torch.kernels.ops import masked_topk, partial_distance_update, running_topk_update

__all__ = ["partial_distance_update", "masked_topk", "running_topk_update"]
