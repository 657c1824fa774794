"""Sharding rules of the port for a (data, model[, pod]) mesh.

Counterpart of ``repro.runtime.sharding``, rule for rule: Megatron-
consistent layouts (column-parallel Q/K/V and GLU-up projections,
row-parallel output and down projections, vocab-parallel embedding and
head), MoE expert stacks on the expert axis, falling back to their f
axis when the experts do not divide the model axis, RWKV/SSM channel
projections on the same column/row pattern; ``moe_fsdp`` adds the
``data`` axis on the expert stacks' h axis where it divides by 16.  KV
caches shard their heads over ``model`` when they divide, else the
cache length (sequence-parallel decode: an MQA model such as
paligemma-3b on a 16-wide axis), else nothing.

A spec is ``P``, a tuple of one entry per tensor dimension: None, an
axis name, or a tuple of axis names, so it compares entry for entry with
JAX's ``PartitionSpec``.  ``shardings_from_specs`` turns specs into
DTensor placements on a ``torch.distributed`` ``DeviceMesh`` (the
counterpart of ``NamedSharding``); nothing on the serving path calls it.
A mesh here is anything with a ``shape`` dict of axis sizes
(``core.comm.VirtualMesh``, ``launch.mesh``).
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

from repro_torch.config.base import ModelConfig


class P(tuple):
    """A partition spec: one entry per dimension (None, an axis name or a
    tuple of axis names; a tuple of one name is that name, as in JAX)."""

    def __new__(cls, *entries):
        return super().__new__(cls, (
            e[0] if isinstance(e, tuple) and len(e) == 1 else e
            for e in entries))

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


# leaf name -> which dim gets the "model" axis (negative = from the end)
_COL = {"wq", "wk", "wv", "w1", "w3", "sw1", "sw3", "in_proj", "wr", "wg",
        "cwk", "cwr", "w_dt", "lm_head"}          # shard last dim
_ROW = {"wo", "w2", "sw2", "cwv", "ssm_out"}      # shard second-to-last dim
_HEAD = {"u"}                                     # shard head dim (1)
_DI = {"w_B", "w_C", "A_log", "b_dt", "D"}        # shard d_inner dim (1)
_VOCAB0 = {"embed"}                               # shard dim 0 (vocab)
_REPLICATED = {"router", "w0", "wa", "wb"}        # small / f32-sensitive


def _candidate_dims(name: str, ndim: int):
    """Preferred model-axis dims of a leaf class, in fallback order:
    expert stacks prefer the expert dim and fall back to d_ff."""
    if name in _VOCAB0:
        return [0, 1]
    if name in {"we1", "we3"}:
        return [1, 3]            # experts, then d_ff (column)
    if name == "we2":
        return [1, 2]            # experts, then d_ff (row)
    if name in _COL:
        return [ndim - 1]
    if name in _ROW:
        return [ndim - 2]
    if name in (_HEAD | _DI):
        return [1]
    return []


def _spec_for_leaf(name: str, shape, model_axis: str,
                   axis_size: Optional[int]) -> P:
    ndim = len(shape)
    none = [None] * ndim
    if name in _REPLICATED or ndim <= 1:
        return P(*none)
    for dim in _candidate_dims(name, ndim):
        if axis_size is None or shape[dim] % axis_size == 0:
            spec = list(none)
            spec[dim] = model_axis
            return P(*spec)
    return P(*none)


def param_specs(cfg: ModelConfig, params_shape, model_axis: str = "model",
                axis_size: Optional[int] = None):
    """A spec tree matching a parameter tree (tensors, meta tensors or
    anything with ``shape``).  ``axis_size``, the mesh's model-axis size,
    enables the divisibility fallbacks."""

    def walk(tree, name=""):
        if isinstance(tree, dict):
            return {k: walk(v, k) for k, v in tree.items()}
        shape = tuple(tree.shape)
        spec = _spec_for_leaf(name, shape, model_axis, axis_size)
        if cfg.moe_fsdp and name in ("we1", "we2", "we3"):
            data_dim = {"we1": 2, "we3": 2, "we2": 3}[name]
            if spec[data_dim] is None and shape[data_dim] % 16 == 0:
                parts = list(spec)
                parts[data_dim] = "data"
                spec = P(*parts)
        return spec

    return walk(params_shape)


def batch_axes(mesh) -> Tuple[str, ...]:
    """Axes that carry data parallelism ("pod" first in multi-pod
    meshes)."""
    return tuple(a for a in ("pod", "data") if a in mesh.shape)


def _batch_dim(mesh, global_batch: int):
    """The batch dim's entry: the data axes when the batch divides over
    them, else None (replicated)."""
    axes = batch_axes(mesh)
    dp = math.prod(mesh.shape[a] for a in axes)
    return axes if (global_batch % dp == 0 and global_batch >= dp) else None


def data_spec(mesh, global_batch: int, extra_dims: int = 1) -> P:
    """Spec of [B, ...] host data; replicated when the batch does not
    divide."""
    return P(_batch_dim(mesh, global_batch), *([None] * extra_dims))


def cache_specs(cfg: ModelConfig, mesh, global_batch: int,
                model_axis: str = "model"):
    """A function from a cache tree (``Model.init_cache``: [L, B, W, Hkv,
    D] k/v, the ssm and hybrid states) to its spec tree."""
    m = mesh.shape[model_axis]
    bdim = _batch_dim(mesh, global_batch)

    def kv_spec(width: int):
        if cfg.num_kv_heads % m == 0:
            return P(None, bdim, None, model_axis, None)
        if width % m == 0:
            return P(None, bdim, model_axis, None, None)   # seq-parallel
        return P(None, bdim, None, None, None)

    def walk(name, leaf):
        if name in ("k", "v"):
            return kv_spec(leaf.shape[2])
        if name == "state":        # rwkv [L, B, H, hs, hs]
            ax = model_axis if leaf.shape[2] % m == 0 else None
            return P(None, bdim, ax, None, None)
        if name == "ssm_state":    # hymba [L, B, di, N]
            ax = model_axis if leaf.shape[2] % m == 0 else None
            return P(None, bdim, ax, None)
        if name in ("tm_prev", "cm_prev"):
            return P(None, bdim, None)
        return P(*([None] * len(leaf.shape)))

    def tree(t):
        return {k: walk(k, v) for k, v in t.items()}

    return tree


def logits_spec(mesh, global_batch: int, model_axis: str = "model",
                seq_dim: bool = False) -> P:
    lead = data_spec(mesh, global_batch, 0)[0]
    if seq_dim:
        return P(lead, None, model_axis)
    return P(lead, model_axis)


def placements(device_mesh, spec: P) -> tuple:
    """DTensor placements of one spec on ``device_mesh`` (a
    ``DeviceMesh`` with ``mesh_dim_names``): per mesh dim, ``Shard(d)``
    for the tensor dim d its axis name is in, else ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard

    out = []
    for axis in device_mesh.mesh_dim_names:
        dims = [d for d, entry in enumerate(spec)
                if entry == axis or (isinstance(entry, tuple)
                                     and axis in entry)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


def shardings_from_specs(device_mesh, specs):
    """The placements of every spec of a tree (``placements``)."""
    if isinstance(specs, dict):
        return {k: shardings_from_specs(device_mesh, v)
                for k, v in specs.items()}
    return placements(device_mesh, specs)
