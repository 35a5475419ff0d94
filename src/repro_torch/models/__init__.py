"""LM substrate: layers and assembly for the arch pool (the transformer-unit
families, MoE blocks included; recurrent mixers and training come with
later slices)."""

from repro_torch.models import moe
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
from repro_torch.models.moe import VirtualMesh

__all__ = [
    "RunCtx", "VirtualMesh", "cache_from_reference", "decode_step", "forward", "init_cache",
    "init_params", "moe", "params_from_reference", "prefill", "unit_layout",
]
