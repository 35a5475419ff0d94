"""Fine-grained query planner (§4.2): pick the partition plan π.

Enumerates factorizations (V, B) of the node count, builds a load-aware
cluster assignment for each, scores them with the §4.2.1 cost model, and
returns the argmin. ``mode`` pins the plan to the paper's baselines:

* ``vector``    → (V=N, B=1)   (Harmony-vector)
* ``dimension`` → (V=1, B=N)   (Harmony-dimension)
* ``harmony``   → cost-model argmin over all factorizations (hybrid)

Host numpy over the index's bookkeeping, as in the reference.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from repro_torch.config import HarmonyConfig
from repro_torch.core.cost_model import HardwareModel, WorkloadStats, plan_cost
from repro_torch.core.index import IVFIndex
from repro_torch.core.router import (
    estimate_cluster_hits,
    load_aware_assignment,
    ring_offsets,
    round_robin_assignment,
    workload_concentration,
)
from repro_torch.core.types import PartitionPlan


def factorizations(n_nodes: int, max_dim_blocks: int) -> List[Tuple[int, int]]:
    """All (V, B) with V·B = n_nodes, B ≤ max_dim_blocks."""
    out = []
    for b in range(1, min(n_nodes, max_dim_blocks) + 1):
        if n_nodes % b == 0:
            out.append((n_nodes // b, b))
    return out


@dataclass
class PlanDecision:
    plan: PartitionPlan
    cost: dict
    candidates: List[Tuple[Tuple[int, int], float]]  # ((V,B), cost) ranking
    # diagnostic: hot-cluster concentration (at the router's
    # DEFAULT_HOT_FRACTION) of the workload sample this plan was built
    # for; uniform ⇒ ≈ DEFAULT_HOT_FRACTION. The serving scheduler keeps
    # its own drift baseline (its hot_fraction may differ) — this field is
    # for logging/benchmark introspection.
    hot_mass: float = 0.0


def make_workload_stats(
    index: IVFIndex,
    probes_sample: Optional[np.ndarray],
    k: int,
    survival: Optional[np.ndarray] = None,
) -> WorkloadStats:
    nlist = index.nlist
    hits = (
        estimate_cluster_hits(probes_sample, nlist)
        if probes_sample is not None
        else np.full(nlist, 1.0)
    )
    nq = int(probes_sample.shape[0]) if probes_sample is not None else 1
    return WorkloadStats(
        cluster_sizes=index.sizes.astype(np.float64),
        cluster_hits=hits,
        dim=index.dim,
        nq=nq,
        topk=k,
        survival=survival,
    )


def plan_search(
    index: IVFIndex,
    n_nodes: int,
    cfg: Optional[HarmonyConfig] = None,
    probes_sample: Optional[np.ndarray] = None,
    hw: HardwareModel = HardwareModel(),
    mode: Optional[str] = None,
    balanced: bool = True,
    stagger: bool = True,
    survival: Optional[np.ndarray] = None,
) -> PlanDecision:
    """Cost-model-driven plan selection."""
    cfg = cfg or index.cfg
    mode = mode or cfg.mode
    w = make_workload_stats(index, probes_sample, cfg.topk, survival)

    if mode == "vector":
        cands = [(n_nodes, 1)]
    elif mode == "dimension":
        cands = [(1, n_nodes)]
    elif mode == "harmony":
        cands = factorizations(n_nodes, cfg.max_dim_blocks)
    else:
        raise ValueError(f"unknown mode {mode!r}")

    scored = []
    best = None
    for V, B in cands:
        assign = (
            load_aware_assignment(w.cluster_sizes, w.cluster_hits, V)
            if balanced
            else round_robin_assignment(index.nlist, V)
        )
        plan = PartitionPlan(
            v_shards=V,
            d_blocks=B,
            cluster_to_shard=assign,
            ring_offsets=ring_offsets(V, B, stagger),
            mode=mode,
        )
        c = plan_cost(plan, w, hw, alpha=cfg.alpha, enable_pruning=cfg.enable_pruning)
        scored.append(((V, B), c["cost"]))
        if best is None or c["cost"] < best[1]["cost"]:
            best = (plan, c)

    assert best is not None
    return PlanDecision(
        plan=best[0],
        cost=best[1],
        candidates=scored,
        hot_mass=workload_concentration(w.cluster_hits),
    )
