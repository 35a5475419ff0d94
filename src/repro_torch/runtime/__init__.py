"""Runtime: the serving cluster's live node set and the survivor
re-plan. Straggler hedging and fault injection come with later slices."""

from repro_torch.runtime.elastic import ClusterState, replan_on_failure

__all__ = ["ClusterState", "replan_on_failure"]
