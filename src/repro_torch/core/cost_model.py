"""§4.2.1 cost model: C(π, Q) = Σ_q C_q(π) + α · I(π).

Costs are wall-time estimates (seconds) from a small hardware model, so
plans are ranked the same way the paper's master node ranks them. The
estimator consumes only lightweight workload statistics available at query
setup time (cluster sizes, per-cluster query hit counts, expected pruning
survival), exactly as §4.2.1 prescribes. Host numpy, as in the reference.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from repro_torch.core.types import PartitionPlan


@dataclass(frozen=True)
class HardwareModel:
    """Per-node rates. Defaults ≈ the paper's testbed (dual-socket Xeon,
    100 Gb/s links), the reference's defaults. The port's model of the
    card it runs on is :data:`H100_SXM` (in place of the reference's pod
    model), or :func:`calibrate_hardware` from measured rates."""

    flops_rate: float = 2.0e11        # effective f32 FLOP/s per node
    net_bw: float = 12.5e9            # bytes/s per link (100 Gb/s)
    net_latency: float = 15e-6        # per-message latency (s)


# One H100 SXM5 a node, from NVIDIA's H100 data sheet: 67 TFLOP/s fp32
# outside the tensor cores (the ring's distance work is f32 with TF32
# off), NVLink 4 at 900 GB/s both directions (450 GB/s a direction), and
# about 2 µs a message (an NVLink put between two cards; a stated
# figure, not the data sheet's).
H100_SXM = HardwareModel(flops_rate=67e12, net_bw=450e9, net_latency=2e-6)


def calibrate_hardware(*, distance_flops: float, distance_s: float,
                       host_s_per_launch: float, copy_bytes: float,
                       copy_s: float) -> HardwareModel:
    """The model of the virtual mesh on one card, from measured inputs:
    the distance kernel's effective FLOP/s at the ring's shape
    (``distance_flops`` in ``distance_s`` a call), the host's cost per
    launch as the per-message latency (a ring hand-off on one card is a
    launch, not a message), and a device-to-device copy's bandwidth
    (``copy_bytes`` in ``copy_s``) as the link's."""
    for name, v in (("distance_s", distance_s), ("copy_s", copy_s),
                    ("host_s_per_launch", host_s_per_launch)):
        if not v > 0:
            raise ValueError(f"{name}={v!r}: a measured time above 0")
    return HardwareModel(flops_rate=distance_flops / distance_s,
                         net_bw=copy_bytes / copy_s, net_latency=host_s_per_launch)



@dataclass
class WorkloadStats:
    """Lightweight statistics the planner needs.

    cluster_sizes[c]   — rows in IVF cluster c.
    cluster_hits[c]    — how many queries in the (sampled) workload probe c.
    dim                — vector dimensionality.
    nq                 — queries in the sample.
    topk               — K.
    survival           — expected fraction of pairs still alive entering
                         dimension slot j (slot 0 → 1.0); calibrated from
                         observed slice pruning ratios or a default decay.
    """

    cluster_sizes: np.ndarray
    cluster_hits: np.ndarray
    dim: int
    nq: int
    topk: int
    survival: Optional[np.ndarray] = None

    def survival_at(self, d_blocks: int, enable_pruning: bool) -> np.ndarray:
        if not enable_pruning:
            return np.ones(d_blocks)
        if self.survival is not None and len(self.survival) >= d_blocks:
            return np.asarray(self.survival[:d_blocks], np.float64)
        # Default decay matching the paper's Table 3 averages
        # (≈ 1.0, 0.66, 0.34, 0.08 at B=4): survival_j ≈ γ^(j·4/B), γ≈0.51
        j = np.arange(d_blocks) * (4.0 / d_blocks)
        return np.clip(0.51 ** j, 0.05, 1.0)


def per_node_loads(
    plan: PartitionPlan, w: WorkloadStats, enable_pruning: bool = True
) -> np.ndarray:
    """Load(n, π): compute-seconds per node of the V×B grid. Node (v, b)
    computes dimension block b of every probed pair on shard v, discounted
    by expected pruning survival at its (average) pipeline slot."""
    V, B = plan.v_shards, plan.d_blocks
    pairs = w.cluster_sizes * w.cluster_hits      # candidate pairs per cluster
    shard_pairs = np.zeros(V)
    np.add.at(shard_pairs, plan.cluster_to_shard, pairs)
    surv = w.survival_at(B, enable_pruning)
    # staggered ring ⇒ every machine column sees every slot equally often
    mean_surv = float(surv.mean())
    per_block_flops = 2.0 * shard_pairs * (w.dim / B) * mean_surv
    return np.repeat(per_block_flops[:, None], B, axis=1).reshape(-1)


def imbalance(plan: PartitionPlan, w: WorkloadStats, hw: HardwareModel) -> float:
    """I(π): std-dev of per-node load, in seconds."""
    loads = per_node_loads(plan, w) / hw.flops_rate
    return float(np.std(loads))


def plan_cost(
    plan: PartitionPlan,
    w: WorkloadStats,
    hw: HardwareModel = HardwareModel(),
    alpha: float = 1.0,
    enable_pruning: bool = True,
    query_block: int = 32,
) -> dict:
    """Full C(π, Q) with the comp/comm decomposition of §4.2.1.

    Returns a dict with comp/comm/imbalance terms (seconds) and "cost".
    """
    V, B = plan.v_shards, plan.d_blocks
    surv = w.survival_at(B, enable_pruning)
    mean_surv = float(surv.mean())

    pairs_per_cluster = w.cluster_sizes * w.cluster_hits
    total_pairs = float(pairs_per_cluster.sum())

    # --- computation: total pair flops, pruned, spread over the grid's
    # critical path (max-loaded node dominates wall time).
    loads = per_node_loads(plan, w, enable_pruning) / hw.flops_rate
    comp = float(loads.max()) if loads.size else 0.0

    # --- communication:
    # query dispatch: each query ships D floats total regardless of B
    # (paper §4.2.2: total bytes invariant); messages are batched per
    # (query block × machine), not per query.
    n_nodes = max(V * B, 1)
    n_blocks = max(1, -(-w.nq // query_block))
    dispatch_bytes = w.nq * w.dim * 4.0
    dispatch_msgs = n_blocks * n_nodes
    # partial-result hand-off: alive pairs forwarded between B-1 slots
    handoff_pairs = total_pairs * float(surv[1:].sum()) if B > 1 else 0.0
    handoff_bytes = handoff_pairs * 4.0
    # results + per-block threshold sync
    result_bytes = w.nq * w.topk * 12.0 + n_blocks * n_nodes * 4.0 * w.nq / n_blocks
    comm_bytes = dispatch_bytes + handoff_bytes + result_bytes
    # every node has its own link; bytes spread across the cluster's NICs
    comm = comm_bytes / (hw.net_bw * n_nodes) + dispatch_msgs * hw.net_latency

    imb = float(np.std(loads))
    cost = comp + comm + alpha * imb
    return {
        "cost": cost,
        "comp_s": comp,
        "comm_s": comm,
        "imbalance_s": imb,
        "comm_bytes": comm_bytes,
        "mean_survival": mean_surv,
    }
