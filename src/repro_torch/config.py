"""Configuration of the HARMONY ANNS engine (``HarmonyConfig``).

A field-for-field copy of ``repro.config.HarmonyConfig``. The LM
architecture configs of the reference come with a later slice.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class HarmonyConfig:
    """Config for the HARMONY distributed ANNS engine."""

    dim: int = 128                  # vector dimensionality D
    nlist: int = 64                 # number of IVF clusters
    nprobe: int = 8                 # probed clusters per query
    topk: int = 10                  # K of top-K search
    metric: str = "l2"              # "l2" | "ip" (inner product / cosine on normalized)

    # Partition plan search space: factorizations (B_vec, B_dim) of n_devices.
    max_dim_blocks: int = 8         # upper bound on B_dim the planner may pick
    alpha: float = 1.0              # imbalance weight α in C(π,Q)

    # Pipeline / pruning switches (Mode in the paper's CLI):
    #   "harmony" (hybrid adaptive), "vector", "dimension"
    mode: str = "harmony"
    enable_pruning: bool = True
    prewarm_samples: int = 4        # vectors per probed cluster used to seed τ
    query_block: int = 32           # vector-level pipeline batch size

    # Kernel tiling
    tile_n: int = 128               # candidate tile
    tile_q: int = 128               # query tile
    tile_d: int = 128               # dimension-block inner tile

    # Two-stage int8 search tier (precision="int8"):
    quant_blocks: int = 4           # dimension blocks per int8 scale/zero grid
    rerank_factor: int = 4          # stage-1 keeps k·rerank_factor candidates

    # Selectivity-aware probe widening for filtered search.
    filter_widen_threshold: float = 0.2
    filter_widen_cap: float = 4.0

    # k-means training
    kmeans_iters: int = 12
    kmeans_seed: int = 0

    def replace(self, **kw) -> "HarmonyConfig":
        return dataclasses.replace(self, **kw)
