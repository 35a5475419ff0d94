"""Mesh shapes for the dry run and the tests.

The port runs on one card, so a mesh here is a ``VirtualMesh``: axis
names and sizes. The production meshes are shape descriptions that the
dry run lays the reference's sharding rules over (``sharding.rules``);
nothing is ever run on them.
"""

from __future__ import annotations

from repro_torch.virtual_mesh import VirtualMesh


def make_production_mesh(*, multi_pod: bool = False) -> VirtualMesh:
    """16 × 16 devices a pod (``data`` × ``model``); two pods for the
    multi-pod dry run."""
    return VirtualMesh(data=16, model=16, pod=2 if multi_pod else 1)


def make_local_mesh(data: int = 1, model: int = 1, pod: int = 0) -> VirtualMesh:
    """A small mesh for tests and examples, its ranks on the one card;
    ``pod=0`` (or 1) leaves the pod axis out."""
    return VirtualMesh(data=data, model=model, pod=max(pod, 1))
