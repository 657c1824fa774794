"""Process-wide mesh context of the port.

Counterpart of ``repro.runtime.meshctx``: model code does not take a mesh
argument.  Two meshes can be set here, each ``None`` until a launcher sets
it:

  * ``set_mesh``: a ``core.comm.VirtualMesh``, which the one path that
    schedules its own collectives on virtual ranks (the expert-TP MoE path,
    ``models.moe.moe_ffn_local``) asks for;
  * ``set_device_mesh``: a ``torch.distributed`` ``DeviceMesh`` with named
    axes ("data", "model", or "pod", "data", "model"), under which every
    family runs as one sharded (GSPMD-style) step on DTensors
    (``runtime.sharding``); the expert-TP path (``moe_dispatch="local"``)
    is not sharded there and raises.  With none set, the model takes its
    single-device path; the check is the one ``get_device_mesh()`` call.
"""
from __future__ import annotations

_MESH = None
_DEVICE_MESH = None


def set_mesh(mesh) -> None:
    global _MESH
    _MESH = mesh


def get_mesh():
    return _MESH


def set_device_mesh(device_mesh) -> None:
    global _DEVICE_MESH
    _DEVICE_MESH = device_mesh


def get_device_mesh():
    return _DEVICE_MESH
