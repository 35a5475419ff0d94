"""Elastic scaling + fault handling for the ANNS serving path.

The design invariant (DESIGN.md §5): the partition plan is a *pure
function* of (index cluster table, live node set, workload sample) — any
survivor can recompute it after a failure, re-preassign the corpus, and
resume with identical results. ``replan_on_failure`` implements exactly
that; tests assert search results are unchanged (minus capacity) after
killing nodes.

Straggler hedging is ``repro_torch.runtime.straggler``, fault injection
``repro_torch.runtime.faults``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from repro_torch.config import HarmonyConfig
from repro_torch.core.index import IVFIndex, ShardedCorpus, preassign
from repro_torch.core.planner import PlanDecision, plan_search


@dataclass
class ClusterState:
    """Mutable view of the serving cluster."""

    n_nodes: int
    live: np.ndarray                    # bool [n_nodes]

    @classmethod
    def fresh(cls, n_nodes: int) -> "ClusterState":
        return cls(n_nodes=n_nodes, live=np.ones(n_nodes, bool))

    def fail(self, node: int):
        self.live[node] = False

    def join(self, node: Optional[int] = None):
        if node is None:
            self.live = np.append(self.live, True)
            self.n_nodes += 1
        else:
            self.live[node] = True

    @property
    def n_live(self) -> int:
        return int(self.live.sum())

    def live_ids(self) -> np.ndarray:
        """Indices of live nodes (replica routing iterates these)."""
        return np.nonzero(self.live)[0]


def replan_on_failure(
    index: IVFIndex,
    state: ClusterState,
    cfg: Optional[HarmonyConfig] = None,
    probes_sample: Optional[np.ndarray] = None,
) -> tuple[PlanDecision, ShardedCorpus]:
    """Recompute the plan for the surviving node set and re-preassign.

    Deterministic given (index, live set, probes sample): any node can run
    it and arrive at the same layout — no coordinator election needed.
    """
    n = state.n_live
    if n == 0:
        raise RuntimeError("no live nodes")
    decision = plan_search(index, n, cfg or index.cfg, probes_sample=probes_sample)
    corpus = preassign(index, decision.plan)
    return decision, corpus
