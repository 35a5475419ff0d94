"""Serving: the engine (``HarmonyServer`` over the mutable segmented
data plane), the device-resident batched executor it drives, the
background compactor and the tier placement policy. The scheduler,
fleet, cache and front-end come with a later slice."""

from repro_torch.serve.compactor import CompactionConfig, Compactor
from repro_torch.serve.engine import HarmonyServer, ServeStats
from repro_torch.serve.executor import ExecutorConfig, SpmdExecutor
from repro_torch.serve.placement import (
    PlacementConfig,
    apply_placement,
    device_bytes_by_segment,
    plan_placement,
)

__all__ = [
    "HarmonyServer",
    "ServeStats",
    "ExecutorConfig",
    "SpmdExecutor",
    "Compactor",
    "CompactionConfig",
    "PlacementConfig",
    "plan_placement",
    "apply_placement",
    "device_bytes_by_segment",
]
