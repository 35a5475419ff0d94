"""Serving: the device-resident batched executor. The scheduler, engine,
fleet and front-end come with later slices."""

from repro_torch.serve.executor import ExecutorConfig, SpmdExecutor

__all__ = ["ExecutorConfig", "SpmdExecutor"]
