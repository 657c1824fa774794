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
counterpart of ``NamedSharding``).  A mesh here is anything with a
``shape`` dict of axis sizes (``core.comm.VirtualMesh``,
``launch.mesh``).

The second half runs a step sharded on a DeviceMesh (set in
``runtime.meshctx``): ``distribute`` places a tree by its specs,
``local_site`` runs one site of the model on the local shards, and the
collective helpers (below) give it Megatron's collectives.  Without a
DeviceMesh none of it runs.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

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


# ---------------------------------------------------------------------------
# sharded execution on a DeviceMesh (GSPMD-style)
# ---------------------------------------------------------------------------
#
# The step runs on DTensors placed by the specs above.  Each site of the
# model that multiplies by a sharded weight, or runs a kernel, runs under
# ``local_site`` (``local_map``) on the local shards, and issues its own
# collectives there through the helpers below, Megatron's f and g: a
# column-parallel input is ``copy_to_model`` (identity forward, one
# all-reduce of its gradient), a row-parallel output leaves the site as a
# ``Partial`` sum over "model", and the residual add that closes it
# (``layers.add_norm``, the redistribution point) all-reduces it with
# ``reduce_model``.  A helper over a group of one device is the identity:
# it issues nothing, as XLA drops such collectives.

_BATCH = ("pod", "data")


def device_mesh():
    """The DeviceMesh the step runs on (``meshctx``), or None."""
    from repro_torch.runtime import meshctx
    return meshctx.get_device_mesh()


def fake_device_mesh(mesh):
    """A ``DeviceMesh`` with the axes and sizes of ``mesh`` (anything with
    a ``shape`` dict, such as ``launch.mesh``'s meshes) over the "fake"
    process group: rank 0 of a world of the mesh's size, whose collectives
    move nothing.  A dry run places meta tensors on it.  An initialised
    fake group of another size is torn down first; any other group is
    left alone and raises."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    # registers the "fake" backend and its store
    from torch.testing._internal.distributed.fake_pg import FakeStore

    shape, axes = tuple(mesh.shape.values()), tuple(mesh.shape)
    world = math.prod(shape)
    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError("a non-fake process group is initialised")
        if dist.get_world_size() != world:
            dist.destroy_process_group()
    if not dist.is_initialized():
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=world)
    return init_device_mesh("cpu", shape, mesh_dim_names=axes)


def _placements_of(dmesh, spec, ndim):
    if spec is None:
        spec = P(*([None] * ndim))
    return placements(dmesh, spec)


def distribute(tree, specs, dmesh):
    """DTensors of a tree of tensors on ``dmesh``, each placed by its spec
    (None: replicated).  A real tensor keeps this rank's block of itself
    (every rank holds the same full tensor; nothing is sent).  A meta
    tensor becomes a meta DTensor of its global shape over a local meta
    shard (``DTensor.from_local``): nothing is allocated."""
    from torch.distributed.tensor import DTensor, distribute_tensor
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset

    if isinstance(tree, dict):
        return {k: distribute(v, None if specs is None else specs[k], dmesh)
                for k, v in tree.items()}
    if tree is None or not isinstance(tree, torch.Tensor):
        return tree
    pl = _placements_of(dmesh, specs, tree.dim())
    if tree.device.type == "meta":
        local, _ = compute_local_shape_and_global_offset(tree.shape, dmesh,
                                                         pl)
        return DTensor.from_local(
            torch.empty(local, dtype=tree.dtype, device="meta"), dmesh, pl,
            run_check=False, shape=tree.shape, stride=tree.stride())
    return distribute_tensor(tree, dmesh, pl, src_data_rank=None)


def is_dtensor(t) -> bool:
    if device_mesh() is None:
        return False
    from torch.distributed.tensor import DTensor
    return isinstance(t, DTensor)


def place(t, spec):
    """``t`` (a plain tensor made inside the step, the same on every rank)
    as a DTensor of the current mesh placed by ``spec``."""
    return distribute(t, spec, device_mesh())


def batch_entry(dmesh, global_batch: int):
    """The batch dim's spec entry on ``dmesh`` (``_batch_dim``)."""
    return _batch_dim(mesh_shape(dmesh), global_batch)


def mesh_shape(dmesh):
    """A DeviceMesh as the spec rules read a mesh (a ``shape`` dict)."""
    return _Shape(dmesh)


class _Shape:

    def __init__(self, dmesh):
        self.shape = dict(zip(dmesh.mesh_dim_names, dmesh.shape))


def axis_size(axis: str) -> int:
    dmesh = device_mesh()
    if axis not in dmesh.mesh_dim_names:
        return 1
    return dmesh.size(dmesh.mesh_dim_names.index(axis))


def model_rank() -> int:
    return device_mesh().get_local_rank("model")


def _group(axis: str):
    dmesh = device_mesh()
    return dmesh.get_group(axis)


def _batch_group():
    """The group over the batch axes of more than one device, flattened
    when there are two (pod and data), or None."""
    dmesh = device_mesh()
    axes = tuple(a for a in _BATCH if a in dmesh.mesh_dim_names
                 and axis_size(a) > 1)
    if not axes:
        return None
    if len(axes) == 1:
        return dmesh.get_group(axes[0])
    return dmesh[axes]._flatten().get_group()


def _all_reduce(x, op: str, group):
    import torch.distributed._functional_collectives as funcol
    return funcol.wait_tensor(funcol.all_reduce(x.contiguous(), op, group))


def _all_gather(x, dim: int, group):
    import torch.distributed._functional_collectives as funcol
    gather = getattr(funcol, "all_gather_single", None) \
        or funcol.all_gather_tensor
    return funcol.wait_tensor(gather(x.contiguous(), dim % x.dim(), group))


def _reduce_scatter(x, dim: int, group):
    import torch.distributed._functional_collectives as funcol
    scatter = getattr(funcol, "reduce_scatter_single", None) \
        or funcol.reduce_scatter_tensor
    return funcol.wait_tensor(scatter(x.contiguous(), "sum", dim % x.dim(),
                                      group))


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, "sum", _group("model"))


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, "sum", group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim):
        ctx.dim = dim
        return _all_gather(x, dim, _group("model"))

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, ctx.dim, _group("model")), None


class _ReduceGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, "sum", ctx.group), None


def copy_to_model(x):
    """Megatron's f, on a local shard: x, whose gradient is all-reduced
    over "model" (the input of one column-parallel product)."""
    if axis_size("model") == 1:
        return x
    return _CopyToModel.apply(x)


def reduce_model(x):
    """Megatron's g: the sum of x over "model" (one all-reduce); the
    gradient passes through."""
    if axis_size("model") == 1:
        return x
    return _Reduce.apply(x, _group("model"))


def reduce_batch(x):
    """The sum of x over the batch axes (one all-reduce, none where they
    hold one device); the gradient passes through."""
    group = _batch_group()
    return x if group is None else _Reduce.apply(x, group)


def reduce_batch_grad(w):
    """w, whose gradient is summed over the batch axes here (one
    all-reduce of this use's contribution; none where they hold one
    device).  A weight read at two sites (the tied embedding: the lookup
    and the head) is reduced once per site, as XLA does."""
    group = _batch_group()
    return w if group is None else _ReduceGrad.apply(w, group)


def max_model(x):
    """The max of x over "model" (one all-reduce), no gradient."""
    if axis_size("model") == 1:
        return x
    return _all_reduce(x.detach(), "max", _group("model"))


def gather_model(x, dim: int):
    """x's blocks over "model" concatenated along ``dim`` (one all-gather;
    the gradient is reduce-scattered back)."""
    if axis_size("model") == 1:
        return x
    return _GatherModel.apply(x, dim)


def gather_model_values(x, dim: int):
    """``gather_model`` without a gradient (integer tensors)."""
    if axis_size("model") == 1:
        return x
    return _all_gather(x, dim, _group("model"))


def with_model(pl, placement):
    """Placements ``pl`` with the "model" axis's entry replaced."""
    names = device_mesh().mesh_dim_names
    return tuple(placement if a == "model" else p for a, p in zip(names, pl))


def partial_model(pl):
    from torch.distributed.tensor import Partial
    return with_model(pl, Partial())


def replicate_model(pl):
    from torch.distributed.tensor import Replicate
    return with_model(pl, Replicate())


def model_sharded(w) -> bool:
    """Whether DTensor w is split over "model"."""
    from torch.distributed.tensor import Shard
    names = w.device_mesh.mesh_dim_names
    return isinstance(w.placements[names.index("model")], Shard)


def is_partial_model(x) -> bool:
    from torch.distributed.tensor import Partial
    names = device_mesh().mesh_dim_names
    return isinstance(x.placements[names.index("model")], Partial)


def batch_sharded(*args) -> bool:
    """Whether an activation among ``args`` is sharded over a batch axis of
    more than one device (so each such rank's weight gradients are
    partial sums)."""
    from torch.distributed.tensor import DTensor, Shard
    names = device_mesh().mesh_dim_names
    for a in args:
        if isinstance(a, DTensor):
            for axis, p in zip(names, a.placements):
                if axis in _BATCH and isinstance(p, Shard) \
                        and axis_size(axis) > 1:
                    return True
    return False


def local_site(fn, out_placements, *args, weights=()):
    """``fn(*local shards of args)`` under ``local_map``: DTensor arguments
    keep their placements, the outputs take ``out_placements``.  The
    gradient of an argument whose index is in ``weights`` is a partial sum
    over the batch axes when the activations are sharded over them (each
    data shard's contribution; ``reduce_grads`` sums them); any other
    argument's gradient takes its own placements, replicated where the
    argument is a partial sum (each rank's gradient is the whole one)."""
    from torch.distributed.tensor import (DTensor, Partial, Placement,
                                          Replicate)
    from torch.distributed.tensor.experimental import local_map

    dmesh = device_mesh()
    names = dmesh.mesh_dim_names
    partial = batch_sharded(*args)
    in_pl, grad_pl = [], []
    for i, a in enumerate(args):
        pl = a.placements if isinstance(a, DTensor) else None
        in_pl.append(pl)
        if pl is not None and partial and i in weights:
            pl = tuple(Partial() if axis in _BATCH and axis_size(axis) > 1
                       else p for axis, p in zip(names, pl))
        elif pl is not None:
            pl = tuple(Replicate() if isinstance(p, Partial) else p
                       for p in pl)
        grad_pl.append(pl)
    if all(isinstance(p, Placement) for p in out_placements):
        out_pl = list(out_placements)          # one output
    else:
        out_pl = tuple(list(p) for p in out_placements)
    return local_map(fn, out_pl, tuple(in_pl), tuple(grad_pl),
                     dmesh)(*args)


def reduce_grads(grads, params):
    """The step's gradients summed over the batch axes (one all-reduce of
    each leaf's local block, none where a leaf's gradient is not a partial
    sum or the axes hold one device), placed as their parameters."""
    from torch.distributed.tensor import DTensor, Partial

    if isinstance(grads, dict):
        return {k: reduce_grads(g, params[k]) for k, g in grads.items()}
    g = grads
    if not any(isinstance(p, Partial) for p in g.placements):
        return g.redistribute(placements=params.placements)
    local = g.to_local()
    group = _batch_group()
    if group is not None:
        local = _all_reduce(local, "sum", group)
    return DTensor.from_local(local, params.device_mesh, params.placements,
                              run_check=False, shape=params.shape,
                              stride=params.stride())


def reduce_branch(y):
    """y, a partial sum over "model" (a row-parallel output), all-reduced
    over it (one all-reduce); y itself when it is not partial."""
    if not is_partial_model(y):
        return y
    return local_site(reduce_model, replicate_model(y.placements), y)


def stack(tensors):
    """``torch.stack`` of same-placed DTensors on a new leading dim, on the
    local shards (the layers' caches of a sharded prefill)."""
    from torch.distributed.tensor import Shard
    pl = tuple(Shard(p.dim + 1) if isinstance(p, Shard) else p
               for p in tensors[0].placements)
    return local_site(lambda *ts: torch.stack(ts), pl, *tensors)
