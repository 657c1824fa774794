"""Production mesh shapes of the port, as virtual meshes.

Counterpart of ``repro.launch.mesh``: the single-pod (data=16, model=16)
mesh of 256 chips and the multi-pod (pod=2, data=16, model=16) mesh of
512, and any named shape.  They are ``core.comm.VirtualMesh`` objects:
shapes for the sharding rules, the input specs and the roofline; nothing
is placed on a device.
"""
from __future__ import annotations

from repro_torch.core.comm import VirtualMesh


def make_production_mesh(*, multi_pod: bool = False) -> VirtualMesh:
    """(data=16, model=16), or (pod=2, data=16, model=16) with
    ``multi_pod``; the "pod" axis carries data parallelism."""
    if multi_pod:
        return make_mesh((2, 16, 16), ("pod", "data", "model"))
    return make_mesh((16, 16), ("data", "model"))


def make_mesh(shape, axes) -> VirtualMesh:
    return VirtualMesh(tuple(shape), tuple(axes))
