"""The benchmark of ``repro_torch``, the PyTorch and CUDA port: batched
ANN search through its serving front end on one H100. ``run.py`` runs one
cell of ``BENCHMARK.json`` once and prints one JSON line."""
