"""Runtime: the serving cluster's live node set and the survivor
re-plan, deterministic fault injection, and straggler hedging."""

from repro_torch.runtime.elastic import ClusterState, replan_on_failure
from repro_torch.runtime.faults import (
    FaultPlan,
    FaultSpec,
    InjectedFault,
    active_fault_plan,
    fault_point,
    fault_scope,
    install_fault_plan,
)
from repro_torch.runtime.straggler import HedgeStats, HedgingExecutor

__all__ = [
    "ClusterState",
    "replan_on_failure",
    "HedgingExecutor",
    "HedgeStats",
    "FaultPlan",
    "FaultSpec",
    "InjectedFault",
    "active_fault_plan",
    "fault_point",
    "fault_scope",
    "install_fault_plan",
]
