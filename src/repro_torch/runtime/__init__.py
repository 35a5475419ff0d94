"""Runtime: the serving cluster's live node set and the survivor
re-plan, and deterministic fault injection. Straggler hedging comes with
a later slice."""

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

__all__ = [
    "ClusterState",
    "replan_on_failure",
    "FaultPlan",
    "FaultSpec",
    "InjectedFault",
    "active_fault_plan",
    "fault_point",
    "fault_scope",
    "install_fault_plan",
]
