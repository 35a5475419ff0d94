"""The one mesh the port takes: a ``jax.sharding.Mesh`` of (``pod`` ×)
``data`` × ``model`` folded onto one card.

The ring search (``core.pipeline.make_spmd_search``) runs its P × V × B
grid over ``VirtualMesh(data=V, model=B, pod=P)``; the MoE layer's expert
parallelism (``models.moe.moe_ffn_ep``) runs over ``VirtualMesh(data=ep)``
and refuses a ``model`` or ``pod`` axis. Either way the ranks are loops or
a leading tensor dimension on the one device, never devices. The
production meshes of the dry run (``launch.mesh``) are ``VirtualMesh``
shapes too, described and never run.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional


@dataclasses.dataclass(frozen=True)
class VirtualMesh:
    """``pod`` × ``data`` × ``model`` ranks on one card.

    ``drop_log``, when a list, receives from every ``moe_ffn_ep`` call one
    int tensor [B, S] on the card: each token's slots dropped past a
    capacity (no host sync)."""

    data: int = 1
    drop_log: Optional[list] = dataclasses.field(default=None, compare=False, repr=False)
    model: int = 1
    pod: int = 1

    def __post_init__(self):
        for axis in ("data", "model", "pod"):
            n = getattr(self, axis)
            if not (isinstance(n, int) and n >= 1):
                raise ValueError(f"VirtualMesh({axis}={n!r}): a positive rank count")

    @property
    def shape(self) -> Dict[str, int]:
        """Axis sizes in the order of ``jax.make_mesh``'s axes: ``pod``
        first, and only when it is above 1."""
        lead = {"pod": self.pod} if self.pod > 1 else {}
        return {**lead, "data": self.data, "model": self.model}
