"""Hand-written Hopper kernels (``csrc/*.cu``), their wrappers, their plain
PyTorch versions (``ref``) and the dispatch between them (``ops``)."""
