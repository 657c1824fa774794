"""FLOPs and HBM bytes of one step, from a walk of its ATen ops on meta
tensors.

Counterpart of ``repro.core.hlo_cost``, which reads both roofline
numerators off compiled HLO.  Here the step runs on ``meta`` tensors —
shapes and types, no data, nothing allocated, so a full-width model costs
no device memory — through the model's plain path, under a
``TorchDispatchMode`` that sees every ATen op the step issues:

  * FLOPs: a dot (``mm``, ``addmm``, ``bmm``, ``baddbmm``; ``matmul`` and
    ``einsum`` reach the dispatcher as these) counts 2·|result|·K, K the
    contracted length.  Elementwise work is ignored, as in ``hlo_cost``.
  * Two byte counts:

    - ``bytes``, the eager-traffic estimate, ``hlo_cost``'s rule op by
      op: an op that materializes counts |result| + Σ|tensor operands|;
      a fill (``zeros``, ``fill_``, ``zero_``, ``arange``, ...) its
      result; views and ``empty`` nothing; a gather (``index``,
      ``index_select``, ``gather``, ``embedding``) 2·|result|, the rows
      it reads and writes; an update (``index_put``, ``index_copy``,
      ``scatter``, a ``copy_`` into a view) 2·|update|, the region it
      touches.  It follows the implementation: an eager chain of
      elementwise ops counts every temporary.
    - ``min_bytes``, the compulsory traffic, a lower bound that does not:
      every tensor that exists before the step is read once, in the
      extent the step touches, every such tensor the step writes is
      written once, and every tensor the step makes and returns is
      written once.  Tensors the step makes and drops (activations,
      scores, gradients, the eager chains' temporaries) cost nothing:
      a fused implementation could keep them on chip.  A gather from such
      a tensor reads |result| of it (distinct rows: a meta tensor has no
      indices); a strided region counts its bytes once, capped at its
      storage.

Each site where the card runs a hand-written kernel is charged as that
one fused op: B1 (``rmsnorm``), ``add_rms_norm``, B2
(``flash_attention``: a full-sequence or context-parallel pass, and a
paged prefill chunk after its ``paged_gather``), B3
(``decode_attention``, the ring-cache decode branch, and its split pass
alone on a sequence-parallel cache), B4
(``paged_decode_attention``, the paged branch at one token), B5–B9 and
``dequantize_add_rms_norm`` (the quantized all-reduce's passes, named as
``kernels._build`` counts them) and B10 (``wkv6``).  The walk finds the
sites without running a kernel: it stands in for the plain functions the
plain path calls in the branches where the kernel path calls the kernels
(``_Walk._patches``), runs each on meta with its bytes muted and its dots
counted, and charges the site the tensors the kernel reads and writes —
never the plain version's intermediates, such as a prefill's [B, Hkv, G,
S, T] scores.  Where autograd records a site, its backward recomputes the
plain version and differentiates it (``kernels.grad.through_plain``), as
on the card, and those ops count in full.  A decode-attention site reads
the cache's valid rows: ``kv_rows`` of them a sequence when the caller
gives it (a meta tensor carries no positions), else the whole ring or
every page of the block table.  The dots of an attention site are the
plain version's, every (query, key) pair of the ring or the sequence, as
JAX's plain path computes them; the kernels skip the tiles their mask
hides.  B10's plain version loops over the sequence one token at a time:
on meta tensors its site runs the first token alone and counts its work,
and its backward's, S times (the loop's trip count, as ``hlo_cost``
expands a while loop; ``_Walk._loop``), so a 32k-token pass costs no 32k
Python iterations a layer; each step's eager bytes are then the first
step's.  hymba's selective scan is no kernel site: it runs token by
token here, as on the card.

A sharded step (DTensors on a ``DeviceMesh``, ``runtime.sharding``) is
walked per chip: a DTensor op is left to DTensor's dispatch (the walk
returns ``NotImplemented``), so the walk sees the local ops one rank
issues — rank 0's on the "fake" process group of a dry run — and counts
them as it counts a single device's.  The collectives
(``_c10d_functional`` ops) move no HBM bytes here: ``core.step_comm``
reads them.

``count(fn, *args)`` returns a ``Cost``: flops, both byte counts, a
per-op breakdown of the eager estimate, and ``peak_bytes``, the most
bytes of storages the step made that were alive at once (the eager
counterpart of XLA's ``temp_size_in_bytes``: every tensor an op makes
lives until the last Python reference to it, or to a view of it, goes;
the cycle collector is off during the walk, so the count is repeatable).
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
import gc
import math
import weakref
from types import SimpleNamespace
from typing import Dict

import torch
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten, tree_map

aten = torch.ops.aten

_DOTS = {aten.mm.default, aten.addmm.default, aten.bmm.default,
         aten.baddbmm.default, aten.matmul.default, aten.dot.default,
         aten.mv.default}
_GATHERS = {aten.index.Tensor, aten.index_select.default,
            aten.gather.default, aten.embedding.default}
# ops whose traffic is the update region; the value is the update's
# position among the operands
_UPDATES = {aten.index_put.default: 2, aten.index_put_.default: 2,
            aten.index_copy.default: 3, aten.index_copy_.default: 3,
            aten.scatter.src: 3, aten.scatter_.src: 3,
            aten.scatter_add.default: 3, aten.scatter_add_.default: 3,
            aten.index_add.default: 3, aten.index_add_.default: 3}
# ops that only write their result
_FILLS = {"zeros", "zeros_like", "new_zeros", "ones", "ones_like", "full",
          "full_like", "new_full", "arange", "zero_", "fill_"}
_FREE = {"view", "_unsafe_view", "reshape", "expand", "permute",
         "transpose", "t", "unsqueeze", "squeeze", "slice", "select",
         "alias", "as_strided", "detach", "unbind", "split",
         "split_with_sizes", "chunk", "diagonal", "unfold", "empty",
         "empty_like", "empty_strided", "new_empty", "new_empty_strided",
         "scalar_tensor", "_local_scalar_dense", "sym_size", "sym_stride",
         "sym_numel", "is_same_size", "resize_", "set_"}


@functools.lru_cache(maxsize=None)
def _dtensor():
    from torch.distributed.tensor import DTensor
    return DTensor


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _tensors(tree):
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _key(t) -> int:
    return StorageWeakRef(t.untyped_storage()).cdata


# the most intervals ``_extent`` lists before it gives up
_MAX_SPANS = 4096


def _extent(t):
    """t's bytes in its storage as [start, end) intervals: one for a
    dense layout (any dim order), one a row for a slice of rows; None
    where that takes more than ``_MAX_SPANS`` intervals."""
    es = t.element_size()
    dims = sorted(((st, n) for n, st in zip(t.shape, t.stride())
                   if n > 1 and st), reverse=True)
    if t.numel() == 0:
        return []
    block = 1
    while dims and dims[-1][0] == block:
        block *= dims.pop()[1]
    starts = [t.storage_offset()]
    for st, n in dims:
        if len(starts) * n > _MAX_SPANS:
            return None
        starts = [s + i * st for s in starts for i in range(n)]
    return [(s * es, (s + block) * es) for s in starts]


class _Traffic:
    """The compulsory traffic: which storages the step made, and the
    regions it reads and writes of the others."""

    def __init__(self):
        self.made = set()
        self.live = self.peak = 0
        self._holders = {}        # made storage -> tensors holding it
        # key -> [storage bytes, intervals, bytes outside any interval]
        self._touched = {"read": {}, "write": {}}

    def external(self, t) -> bool:
        return _key(t) not in self.made

    def touch(self, kind: str, t, nbytes: int = None) -> None:
        """``kind`` ("read" / "write") of t, in its extent or, given
        ``nbytes``, that many bytes of its storage; nothing for a tensor
        the step made."""
        if not self.external(t):
            return
        row = self._touched[kind].setdefault(
            _key(t), [t.untyped_storage().nbytes(), [], 0])
        spans = None if nbytes is not None else _extent(t)
        if spans is None:
            row[2] += _nbytes(t) if nbytes is None else nbytes
        else:
            row[1].extend(spans)

    def make(self, outs, args) -> None:
        """Record the storages an op made: its outputs that share none of
        its inputs' (a view or an in-place result shares its input's);
        every output of a made storage holds it alive (``peak``)."""
        seen = {_key(t) for t in args}
        for t in outs:
            k = _key(t)
            if k not in seen and k not in self._holders:
                # born here (a key alive in ``_holders`` is a live storage;
                # a dead one's address may come back for a new storage)
                self.made.add(k)
                self._holders[k] = 0
                self.live += t.untyped_storage().nbytes()
                self.peak = max(self.peak, self.live)
            if k in self._holders:
                self._holders[k] += 1
                weakref.finalize(t, self._drop, k,
                                 t.untyped_storage().nbytes())

    def _drop(self, k, nbytes) -> None:
        self._holders[k] -= 1
        if self._holders[k] == 0:
            del self._holders[k]
            self.live -= nbytes

    def total(self, result) -> int:
        """The compulsory bytes, ``result`` being what the step
        returned."""
        out = sum(_nbytes(t) for t in {id(t): t for t in _tensors(result)}
                  .values() if not self.external(t))
        for rows in self._touched.values():
            for size, spans, loose in rows.values():
                covered, end = 0, -1
                for a, b in sorted(spans):
                    if b > end:
                        covered += b - max(a, end)
                        end = b
                out += min(size, covered + loose)
        return out


@dataclasses.dataclass
class Cost:
    """One step's numerators: ``flops``, the eager-traffic estimate
    ``bytes``, the compulsory traffic ``min_bytes``, and per op (ATen
    name, or the kernel site's name) [calls, flops, bytes]."""

    flops: float = 0.0
    bytes: float = 0.0
    min_bytes: float = 0.0
    peak_bytes: float = 0.0
    ops: Dict[str, list] = dataclasses.field(
        default_factory=lambda: collections.defaultdict(lambda: [0, 0.0,
                                                                 0.0]))

    def add(self, name: str, flops: float, nbytes: float) -> None:
        self.flops += flops
        self.bytes += nbytes
        row = self.ops[name]
        row[0] += 1
        row[1] += flops
        row[2] += nbytes

    def top(self, n: int = 8):
        """The ``n`` ops with the most bytes."""
        return sorted(self.ops.items(), key=lambda kv: -kv[1][2])[:n]


def _dot_flops(func, args, out) -> float:
    a = args[1] if func in (aten.addmm.default, aten.baddbmm.default) \
        else args[0]
    return 2.0 * out.numel() * a.shape[-1]


def _written(func, args, kwargs):
    """The tensor arguments ``func`` writes in place."""
    out = []
    for i, a in enumerate(func._schema.arguments):
        if a.alias_info is None or not a.alias_info.is_write:
            continue
        v = args[i] if i < len(args) else kwargs.get(a.name)
        out.extend(_tensors(v))
    return out


class _Walk(TorchDispatchMode):
    """The walk of one step; ``kv_rows`` is the valid cache rows a
    sequence of a decode step reads (its position + 1, at most the ring
    or the block table's pages)."""

    def __init__(self, kv_rows: int = None):
        super().__init__()
        self.cost = Cost()
        self.traffic = _Traffic()
        self.kv_rows = kv_rows
        self.fused = 0            # > 0 inside a kernel site

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, _dtensor()) for t in types):
            return NotImplemented         # walk the local ops it issues
        out = func(*args, **kwargs)
        name = func.overloadpacket.__name__
        flops = _dot_flops(func, args, out) if func in _DOTS else 0.0
        operands = _tensors((args, kwargs))
        if self.fused:
            self.traffic.make(_tensors(out), operands)
            self.cost.flops += flops      # the site's row takes them
            return out
        free = (name in _FREE or name.endswith("_view") or func.is_view
                or func.namespace == "_c10d_functional")
        if free:
            nbytes = 0
        elif name in _FILLS:
            nbytes = sum(_nbytes(t) for t in _tensors(out))
        elif func in _GATHERS:
            nbytes = 2 * _nbytes(out)
        elif func in _UPDATES:
            nbytes = 2 * _nbytes(args[_UPDATES[func]])
        elif name == "copy_":          # into a view: the region it writes
            nbytes = _nbytes(args[0]) + _nbytes(args[1])
        else:
            nbytes = sum(_nbytes(t) for t in _tensors(out)) + sum(
                _nbytes(t) for t in operands)
        if not free:
            self._compulsory(func, name, args, kwargs, operands, out)
        self.traffic.make(_tensors(out), operands)
        self.cost.add(name, flops, nbytes)
        return out

    def _compulsory(self, func, name, args, kwargs, operands, out):
        """An op's reads and writes of the tensors the step did not make:
        a gather reads |result| of its source, an update or fill writes
        only, any other in-place op reads and writes its target."""
        tr = self.traffic
        written = {id(t) for t in _written(func, args, kwargs)}
        for t in operands:
            if id(t) in written:
                if func in _UPDATES:
                    tr.touch("write", t, _nbytes(args[_UPDATES[func]]))
                    continue
                if name not in _FILLS and name != "copy_":
                    tr.touch("read", t)
                tr.touch("write", t)
            elif func in _GATHERS and t is args[0]:
                tr.touch("read", t, _nbytes(out))
            else:
                tr.touch("read", t)

    # -- kernel sites --------------------------------------------------------
    @contextlib.contextmanager
    def _fusing(self):
        self.fused += 1
        try:
            yield
        finally:
            self.fused -= 1

    def _site(self, plain, charge):
        """A stand-in for ``plain`` at a kernel site: runs it with its
        bytes muted and charges the rows ``charge(args, out)`` gives,
        [(name, bytes read and written)], the dots counted inside on the
        first; under autograd the backward is the plain version's
        gradient.  Inside another site it is the plain version."""
        from repro_torch.kernels import grad

        def kernel(*args):
            if self.fused:
                return plain(*args)
            before = self.cost.flops
            with self._fusing():
                out = plain(*args)
                rows = charge(args, out)
            inside, self.cost.flops = self.cost.flops - before, before
            for name, nbytes in rows:
                self.cost.add(name, inside, nbytes)
                inside = 0.0
            return out

        def site(*args):
            if grad.wanted(*args):
                return grad.through_plain(kernel, plain, *args)
            return kernel(*args)
        return site

    @contextlib.contextmanager
    def _scaled(self, n: int):
        """Counts the FLOPs and eager bytes of the ops inside n times (one
        step of a loop of n identical steps: its trip count, as
        ``hlo_cost`` expands a while loop)."""
        flops, nbytes = self.cost.flops, self.cost.bytes
        rows = {k: list(v) for k, v in self.cost.ops.items()}
        yield
        self.cost.flops = flops + n * (self.cost.flops - flops)
        self.cost.bytes = nbytes + n * (self.cost.bytes - nbytes)
        for k, row in self.cost.ops.items():
            was = rows.get(k, [0, 0.0, 0.0])
            self.cost.ops[k] = [w + n * (x - w) for w, x in zip(was, row)]

    def _loop(self, plain, steps: int):
        """``plain`` for a kernel site whose plain version loops over the
        sequence (B10's per-token WKV recurrence; its first ``steps``
        arguments are [B, S, ...]).  On meta tensors longer than one step
        the plain version runs on the first step alone, its work (and its
        backward's, where autograd records) counted S times: the loop's
        trip count, without S Python iterations a layer (the kernel runs
        the sequence in one launch).  The full-length outputs and
        gradients are the plain version's own meta path's
        (``rwkv6_scan.ref``), made at their shapes."""
        walk = self

        def first(args):
            return [a[:, :1] if i < steps else a for i, a in enumerate(args)]

        class Loop(torch.autograd.Function):
            @staticmethod
            def forward(ctx, *args):
                ctx.save_for_backward(*args)
                with walk._scaled(args[0].shape[1]):
                    plain(*first(args))
                return plain(*args)

            @staticmethod
            def backward(ctx, *grads):
                args = [a.detach().requires_grad_(a.is_floating_point())
                        for a in ctx.saved_tensors]
                one = first(args)
                with walk._scaled(args[0].shape[1]), torch.enable_grad():
                    outs = plain(*one)
                    torch.autograd.grad(
                        outs, [a for a in one if a.requires_grad],
                        [grads[0][:, :1], grads[1]], allow_unused=True)
                return tuple(torch.empty(a.shape, dtype=a.dtype,
                                         device="meta") for a in args)

        def loop(*args):
            if args[0].device.type != "meta" or args[0].shape[1] == 1:
                return plain(*args)
            return Loop.apply(*args)
        return loop

    def _io(self, name):
        """A site that reads its tensor arguments and writes its outputs,
        each once."""
        def charge(args, out):
            for t in _tensors(args):
                self.traffic.touch("read", t)
            return [(name, sum(_nbytes(t) for t in _tensors((args, out))))]
        return charge

    def _kv_read(self, k, rows: int) -> int:
        """K's and V's bytes at ``rows`` rows of one sequence."""
        return 2 * rows * math.prod(k.shape[2:]) * k.element_size()

    def _ring_attention(self, args, out):
        """B3: q and the output (B3's split pass alone on a
        sequence-parallel cache shard: its f32 partials), and each
        sequence's valid ring rows."""
        q, k, v = args[:3]
        rows = k.shape[1] if self.kv_rows is None \
            else min(self.kv_rows, k.shape[1])
        for t in (q, k[:, :rows], v[:, :rows]):
            self.traffic.touch("read", t)
        return [("decode_attention", _nbytes(q) + sum(
            _nbytes(t) for t in _tensors(out))
            + k.shape[0] * self._kv_read(k, rows))]

    def _paged_attention(self, args, out):
        """B4 at one token: q, the output, the block table and each
        sequence's valid rows of its pages; a longer chunk is the pages'
        gather and then B2 over the gathered K/V."""
        q, k, v, table = args[:4]
        B, S = q.shape[:2]
        span = table.shape[-1] * k.shape[1]
        rows = span if self.kv_rows is None else min(self.kv_rows, span)
        kv = B * self._kv_read(k, rows)
        for t in (q, table):
            self.traffic.touch("read", t)
        for t in (k, v):
            self.traffic.touch("read", t, kv // 2)
        if S == 1:
            return [("paged_decode_attention", _nbytes(q) + _nbytes(out)
                     + _nbytes(table) + kv)]
        gathered = B * self._kv_read(k, span)
        return [("flash_attention", _nbytes(q) + _nbytes(out) + gathered),
                ("paged_gather", 2 * gathered + _nbytes(table))]

    def _full_attention(self, args, out):
        """B2: q, k, v and the output."""
        for t in args[:3]:
            self.traffic.touch("read", t)
        return [("flash_attention",
                 sum(_nbytes(t) for t in (*args[:3], out)))]

    def _patches(self):
        from repro_torch.core import parallel_exec
        from repro_torch.models import blocks, layers, ssm

        plain_ops = parallel_exec._PLAIN_OPS
        quant = SimpleNamespace(**{
            field: self._site(getattr(plain_ops, field), self._io(name))
            for field, name in (
                ("amax", "chunk_amax"), ("quantize_shared", "chunk_quantize"),
                ("dequantize", "chunk_dequantize"),
                ("dequantize_add_norm", "dequantize_add_rms_norm"),
                ("quantize_pack_shared", "chunk_quantize_pack"),
                ("reduce_requant", "nibble_reduce_requant"),
                ("unpack_dequantize", "nibble_unpack_dequantize"))})
        return (
            (layers, "rms_norm_ref", self._site(
                layers.rms_norm_ref, self._io("rmsnorm"))),
            (layers, "add_rms_norm_ref", self._site(
                layers.add_rms_norm_ref, self._io("add_rms_norm"))),
            (blocks, "ring_attention_plain", self._site(
                blocks.ring_attention_plain, self._ring_attention)),
            (blocks, "ring_partials_plain", self._site(
                blocks.ring_partials_plain, self._ring_attention)),
            (blocks, "paged_attention_plain", self._site(
                blocks.paged_attention_plain, self._paged_attention)),
            (blocks, "gqa_attention", self._site(
                blocks.gqa_attention, self._full_attention)),
            (ssm, "wkv6_ref", self._site(self._loop(ssm.wkv6_ref, 4),
                                         self._io("wkv6"))),
            (parallel_exec, "_PLAIN_OPS", quant),
        )


def count(fn, *args, kv_rows: int = None, **kwargs) -> Cost:
    """``fn(*args, **kwargs)`` walked (its arguments on ``meta``): its
    ``Cost``."""
    walk = _Walk(kv_rows)
    with contextlib.ExitStack() as stack:
        # the peak must not depend on when the cycle collector runs
        if gc.isenabled():
            gc.disable()
            stack.callback(gc.enable)
        for lib, attr, site in walk._patches():
            stack.callback(setattr, lib, attr, getattr(lib, attr))
            setattr(lib, attr, site)
        with walk:
            result = fn(*args, **kwargs)
    # a sharded step returns DTensors: its rank writes their local blocks
    result = tree_map(lambda t: t._local_tensor
                      if isinstance(t, _dtensor()) else t, result)
    walk.cost.min_bytes = float(walk.traffic.total(result))
    walk.cost.peak_bytes = float(walk.traffic.peak)
    return walk.cost
