"""The one mesh the port takes: a ``jax.sharding.Mesh`` of ``data`` ×
``model`` (axes ``data``, ``model``) folded onto one card.

The ring search (``core.pipeline.make_spmd_search``) runs its V × B grid
over ``VirtualMesh(data=V, model=B)``; the MoE layer's expert parallelism
(``models.moe.moe_ffn_ep``) runs over ``VirtualMesh(data=ep)`` and refuses
a ``model`` axis. Either way the ranks are loops or a leading tensor
dimension on the one device, never devices.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional


@dataclasses.dataclass(frozen=True)
class VirtualMesh:
    """``data`` × ``model`` ranks on one card.

    ``drop_log``, when a list, receives from every ``moe_ffn_ep`` call one
    int tensor [B, S] on the card: each token's slots dropped past a
    capacity (no host sync)."""

    data: int = 1
    drop_log: Optional[list] = dataclasses.field(default=None, compare=False, repr=False)
    model: int = 1

    def __post_init__(self):
        for axis in ("data", "model"):
            n = getattr(self, axis)
            if not (isinstance(n, int) and n >= 1):
                raise ValueError(f"VirtualMesh({axis}={n!r}): a positive rank count")

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": self.data, "model": self.model}
