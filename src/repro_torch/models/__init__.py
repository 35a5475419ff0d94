"""LM substrate: layers and assembly for the arch pool (the transformer-unit
families; experts, recurrent mixers and training come with later slices)."""

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

__all__ = [
    "RunCtx", "cache_from_reference", "decode_step", "forward", "init_cache",
    "init_params", "params_from_reference", "prefill", "unit_layout",
]
