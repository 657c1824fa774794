"""AdamW with f32 moments and the cosine learning-rate schedule.

Counterpart of ``repro.optim.adamw``: the same defaults and the same f32
arithmetic — a global-norm clip over every gradient leaf, the moments in
f32, bias correction from the f32 step, decoupled weight decay on every
leaf (norms and embeddings included), the update in f32 cast back to the
parameter's type.

The JAX optimizer is functional and its train step donates the old
parameters and state.  Here ``update`` writes the new values into the
parameter and moment tensors it is given (the values of the functional
update) and returns the same trees: on one card a llama32-3b step then
holds one copy of the parameters (7.2 GB in bf16) and of the moments
(28.9 GB), not two.  It works through large leaves a block of rows at a
time, so its f32 temporaries stay small.

On a sharded step (DTensor parameters and gradients on a DeviceMesh,
``runtime.sharding``) the moments take the parameters' placements;
``update`` first sums each gradient over the batch axes
(``sharding.reduce_grads``, one all-reduce a leaf), then takes the global
norm as JAX's compiled step does, each leaf split over "model"
contributing its local sum of squares through one scalar all-reduce (and
one more over the batch axes for a leaf split over them, ``moe_fsdp``'s
expert stacks), and updates every rank's local blocks in place.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch

from repro_torch.checkpoint.store import flatten
from repro_torch.runtime import sharding as sh

PIECE = 1 << 25          # elements a block of rows of a large leaf holds


def cosine_schedule(base_lr: float, warmup: int, total: int) -> Callable:
    """lr(step): linear warmup to ``base_lr`` over ``warmup`` steps, then a
    cosine to 0 at ``total``; f32, on the step's device."""
    def lr(step):
        step = torch.as_tensor(step).to(torch.float32)
        warm = base_lr * step / max(warmup, 1)
        prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0, 1)
        cos = 0.5 * base_lr * (1 + torch.cos(math.pi * prog))
        return torch.where(step < warmup, warm, cos)
    return lr


def _pieces(*tensors):
    """Blocks of rows of same-shaped tensors (the tensors themselves when
    they hold at most PIECE elements)."""
    t = tensors[0]
    if t.dim() < 2 or t.numel() <= PIECE:
        return [tensors]
    rows = max(1, PIECE // (t.numel() // t.shape[0]))
    return list(zip(*(x.split(rows) for x in tensors)))


def _local_sq(g):
    """The sum of squares of DTensor g: its local blocks' sum, all-reduced
    over "model" (one scalar) where g is split over it, and over the batch
    axes (one more) where g is split over them (``moe_fsdp``)."""
    sq = 0
    for (piece,) in _pieces(g.to_local()):
        sq = sq + torch.sum(torch.square(piece.float()))
    sq = sh.reduce_split_batch(sq, g)
    return sh.reduce_model(sq) if sh.model_sharded(g) else sq


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: Callable = cosine_schedule(3e-4, 100, 10_000)
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0

    def init(self, params):
        """{"m", "v": f32 zeros shaped as ``params``, "step": int32 0}."""
        def zeros(tree):
            if isinstance(tree, dict):
                return {k: zeros(v) for k, v in tree.items()}
            if sh.is_dtensor(tree):
                return torch.zeros_like(tree, dtype=torch.float32)
            return torch.zeros(tree.shape, dtype=torch.float32,
                               device=tree.device)
        leaf = next(iter(flatten(params).values()))
        return {"m": zeros(params), "v": zeros(params),
                "step": torch.zeros((), dtype=torch.int32,
                                    device=leaf.device)}

    @torch.no_grad()
    def update(self, grads, state, params):
        """One step: writes the new parameters into ``params`` and the new
        moments into ``state``'s; returns (params, state with the new step,
        {"grad_norm": the norm before the clip, "lr"})."""
        p_flat = flatten(params)
        m_flat, v_flat = flatten(state["m"]), flatten(state["v"])
        sharded = sh.is_dtensor(next(iter(p_flat.values())))
        if sharded:
            grads = sh.reduce_grads(grads, params)
        g_flat = flatten(grads)
        step = state["step"] + 1
        gnorm = 0
        for g in g_flat.values():
            if sharded:
                gnorm = gnorm + _local_sq(g)
                continue
            for (piece,) in _pieces(g):
                gnorm = gnorm + torch.sum(torch.square(piece.float()))
        gnorm = torch.sqrt(gnorm)
        if sharded:
            g_flat, p_flat, m_flat, v_flat = (
                {k: t.to_local() for k, t in f.items()}
                for f in (g_flat, p_flat, m_flat, v_flat))
        scale = torch.clamp(self.grad_clip / (gnorm + 1e-9), max=1.0)
        sf = step.to(torch.float32)
        b1 = torch.tensor(self.b1, dtype=torch.float32, device=sf.device)
        b2 = torch.tensor(self.b2, dtype=torch.float32, device=sf.device)
        bc1 = 1 - b1 ** sf
        bc2 = 1 - b2 ** sf
        lr = self.lr(step)
        for key, p in p_flat.items():
            for g, m, v, q in _pieces(g_flat[key], m_flat[key], v_flat[key],
                                      p):
                # JAX's expressions, each product and sum rounded once to
                # f32 as there, written into the moments and temporaries
                g = g.to(torch.float32, copy=True).mul_(scale)
                m.mul_(self.b1).add_(g * (1 - self.b1))
                v.mul_(self.b2).add_((g * (1 - self.b2)).mul_(g))
                u = torch.div(m, bc1)
                den = torch.div(v, bc2).sqrt_().add_(self.eps)
                u.div_(den).add_(q.to(torch.float32, copy=True).mul_(
                    self.weight_decay))
                q.copy_(q.to(torch.float32, copy=True).sub_(u.mul_(lr)))
        return params, {"m": state["m"], "v": state["v"], "step": step}, {
            "grad_norm": gnorm, "lr": lr}
