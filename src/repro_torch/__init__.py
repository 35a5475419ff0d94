"""repro_torch: HARMONY's device search path in PyTorch with CUDA kernels
written by hand for Hopper (sm_90a).

A port of the JAX package ``repro``, module by module, with the same
layout and public names. It imports neither JAX nor ``repro``.

The served entry point is ``repro_torch.serve.HarmonyServer.search_batch``
over a mutable ``repro_torch.core.SegmentedIndex``: per sealed segment
the device executor (``SpmdExecutor.search_batch`` → probe selection →
τ prewarm → host-side probed-row gather → (qb, cap) bucket ladder →
``gather_local_candidates`` → ``ring_chunk_search`` on a virtual V×B
mesh) or the host engine, a brute-force scan of the delta buffer, and a
merge of the per-part top-ks. The hot operations are the CUDA kernels
in ``repro_torch/kernels/csrc/``: the fp32 and int8 partial distances
and the running top-K, which also folds the parts together.

Every entry point that allocates on a device takes ``device=None``,
which means CUDA; without CUDA it raises. Tests pass ``device="cpu"``,
where each kernel wrapper is replaced by its plain PyTorch version.
"""

__version__ = "0.1.0"
