"""LM substrate: layers and assembly for the arch pool, the serving path of
every family (transformer units with dense or MoE blocks, xLSTM, Zamba2;
training comes with a later slice)."""

from repro_torch.models import moe, recurrent
from repro_torch.models.lm import (
    RunCtx,
    cache_from_reference,
    decode_step,
    forward,
    init_cache,
    init_params,
    params_from_reference,
    prefill,
    unit_layout,
)
from repro_torch.virtual_mesh import VirtualMesh

__all__ = [
    "RunCtx", "VirtualMesh", "cache_from_reference", "decode_step", "forward", "init_cache",
    "init_params", "moe", "params_from_reference", "prefill", "recurrent", "unit_layout",
]
