"""Gradients through the hand-written kernels: the plain version's.

The JAX package has no backward kernel (no ``custom_vjp`` around its
Pallas calls: it trains through ``jax.grad`` of the plain path), so the
backward of each kernel of the port is the gradient of its plain version.
``through_plain(kernel, plain, *args)`` launches ``kernel(*args)`` inside a
``torch.autograd.Function`` whose backward recomputes ``plain(*args)`` on
detached copies of the saved inputs and returns ``torch.autograd.grad`` of
it against the incoming gradients.  The backward launches no kernel;
integer and non-tensor arguments get no gradient.

The dispatchers take this route only where autograd records
(``wanted``): grad enabled and a tensor argument that requires grad.
Serving runs under ``torch.inference_mode()``, so it keeps calling the
kernels directly, with their launches and outputs unchanged.
"""
from __future__ import annotations

import torch


def wanted(*args) -> bool:
    """Whether autograd records a call on ``args``."""
    return torch.is_grad_enabled() and any(
        isinstance(a, torch.Tensor) and a.requires_grad for a in args)


class _ThroughPlain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, kernel, plain, *args):
        ctx.plain = plain
        ctx.tensor_at = [i for i, a in enumerate(args)
                         if isinstance(a, torch.Tensor)]
        ctx.args = [None if i in ctx.tensor_at else a
                    for i, a in enumerate(args)]
        ctx.save_for_backward(*(args[i] for i in ctx.tensor_at))
        return kernel(*args)

    @staticmethod
    def backward(ctx, *grads):
        args = list(ctx.args)
        needs = ctx.needs_input_grad[2:]
        for i, t in zip(ctx.tensor_at, ctx.saved_tensors):
            args[i] = t.detach().requires_grad_(needs[i])
        wrt = [i for i in ctx.tensor_at if needs[i]]
        with torch.enable_grad():
            outs = ctx.plain(*args)
            outs = outs if isinstance(outs, tuple) else (outs,)
            pairs = [(o, g) for o, g in zip(outs, grads)
                     if g is not None and o.requires_grad]
            got = torch.autograd.grad([o for o, _ in pairs],
                                      [args[i] for i in wrt],
                                      [g for _, g in pairs],
                                      allow_unused=True,
                                      materialize_grads=True)
        out = [None] * len(args)
        for i, g in zip(wrt, got):
            out[i] = g
        return (None, None, *out)


def through_plain(kernel, plain, *args):
    """``kernel(*args)``, differentiable by the gradient of ``plain(*args)``
    (same arguments, same outputs)."""
    return _ThroughPlain.apply(kernel, plain, *args)
