"""Process-wide mesh context of the port.

Counterpart of ``repro.runtime.meshctx``: model code does not take a mesh
argument; the one path that schedules its own collectives (the expert-TP
MoE path, ``models.moe.moe_ffn_local``) asks for the mesh a launcher set
here — a ``core.comm.VirtualMesh`` — and runs the call's default path when
none is set.
"""
from __future__ import annotations

_MESH = None


def set_mesh(mesh) -> None:
    global _MESH
    _MESH = mesh


def get_mesh():
    return _MESH
