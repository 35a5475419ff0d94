"""Serving: the engine (``HarmonyServer`` over the mutable segmented
data plane) and the device-resident batched executor it drives. The
scheduler, fleet, cache and front-end come with later slices."""

from repro_torch.serve.engine import HarmonyServer, ServeStats
from repro_torch.serve.executor import ExecutorConfig, SpmdExecutor

__all__ = ["HarmonyServer", "ServeStats", "ExecutorConfig", "SpmdExecutor"]
