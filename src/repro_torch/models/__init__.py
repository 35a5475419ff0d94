"""LM substrate: layers and assembly for the arch pool, the serving and
training paths of every family (transformer units with dense or MoE
blocks, xLSTM, Zamba2); ``loss_fn`` is what ``repro_torch.train``
differentiates."""

from repro_torch.models import moe, recurrent
from repro_torch.models.lm import (
    RunCtx,
    cache_from_reference,
    decode_step,
    forward,
    init_cache,
    init_params,
    loss_fn,
    params_from_reference,
    prefill,
    tree_from_reference,
    unit_layout,
)
from repro_torch.virtual_mesh import VirtualMesh

__all__ = [
    "RunCtx", "VirtualMesh", "cache_from_reference", "decode_step", "forward", "init_cache",
    "init_params", "loss_fn", "moe", "params_from_reference", "prefill", "recurrent",
    "tree_from_reference", "unit_layout",
]
