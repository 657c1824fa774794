"""Training: the losses and the train and eval steps of every family.

Counterpart of ``repro.runtime.train``.  Loss variants:
  * ``dense``: next-token CE over the full logits;
  * ``fused``: the CE from the final hidden states with a vocab-chunked
    logsumexp, never materialising the [B, S, V] logits at once (a Python
    loop over vocab chunks; the same function).

The encoder (hubert) trains frame classification on ``targets`` (no
shift); the vlm (paligemma) takes the CE of its text suffix only; the MoE
router's aux loss is added for every family (0 where there is none).

The forward pass runs the model's kernel path (``Model(plain=False)``):
B1, ``add_rms_norm``, B2 and, for the ssm family, B10 on the card, each
differentiable by its plain version's gradient (``kernels.grad``).  The
step takes ``torch.autograd.grad`` over the parameter leaves (JAX's
``jax.value_and_grad``) and hands the gradients to ``AdamW.update``, which
writes the new values into the parameters in place (JAX donated them).
The step's three parts run inside ``record_function`` ranges,
"train.fwd", "train.bwd" and "train.opt", where a profile reads them.
"""
from __future__ import annotations

from typing import Callable

import torch
from torch.autograd.profiler import record_function

from repro_torch.checkpoint.store import flatten, unflatten
from repro_torch.models.transformer import Model, resolve_device
from repro_torch.optim.adamw import AdamW
from repro_torch.runtime import sharding as sh


def _ce(logits, targets, vocab: int):
    """Mean cross-entropy in f32.  logits [..., V]; targets [...] int."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets.long()[..., None])[..., 0]
    return torch.mean(logz - gold)


def _ce_sharded(logits, targets):
    """``_ce`` of vocab-sharded logits (a sharded step): on each rank's
    vocab columns, one all-reduce over "model" each for the max (MAX), the
    sum of exponentials and the target's logit (SUM), then the sum over
    the batch axes (one scalar all-reduce) over the token count.  DTensor's
    own log-softmax would all-gather the logits."""
    r = sh.model_rank()
    n_tokens = targets.numel()

    def local(lg, t):
        lf = lg.float()
        n = lf.shape[-1]
        mx = sh.max_model(lf.amax(dim=-1))
        z = sh.reduce_model(torch.exp(lf - mx[..., None]).sum(dim=-1))
        ids = t.long() - r * n
        ok = (ids >= 0) & (ids < n)
        gold = torch.gather(lf, -1, torch.where(ok, ids, 0)[..., None])
        gold = sh.reduce_model(torch.where(ok, gold[..., 0], 0.0))
        return sh.reduce_batch(torch.sum(mx + torch.log(z) - gold)) \
            / n_tokens

    from torch.distributed.tensor import Replicate
    return sh.local_site(local, [Replicate()] * logits.device_mesh.ndim,
                         logits, targets)


def ce_from_hidden_chunked(x, head, targets, chunk: int = 16384,
                           vocab: int = None):
    """The CE of ``_ce`` from final hidden states x [..., h] and head
    [h, V]: a logsumexp carried over vocab chunks (peak ~[..., chunk], not
    [..., V]).  ``vocab`` masks the padded head columns; targets [...]
    int."""
    xf = x.float()
    V = head.shape[-1] if vocab is None else vocab
    chunk = min(chunk, V)
    n_chunks = (V + chunk - 1) // chunk
    pad = n_chunks * chunk - head.shape[-1]
    head_p = torch.nn.functional.pad(head, (0, pad)) if pad > 0 else head
    run_max = torch.full(xf.shape[:-1], -torch.inf, device=x.device)
    run_sum = torch.zeros(xf.shape[:-1], device=x.device)
    for i in range(n_chunks):
        lg = xf @ head_p[:, i * chunk:(i + 1) * chunk].float()  # [..., chunk]
        col = i * chunk + torch.arange(chunk, device=x.device)
        lg = torch.where(col < V, lg, -torch.inf)
        m = torch.maximum(run_max, lg.amax(-1))
        run_sum = (run_sum * torch.exp(run_max - m)
                   + torch.exp(lg - m[..., None]).sum(-1))
        run_max = m
    logz = run_max + torch.log(run_sum)
    gold_w = head[:, targets.long()]                          # [h, ...]
    gold_w = torch.movedim(gold_w, 0, -1).float()             # [..., h]
    gold = torch.sum(xf * gold_w, dim=-1)
    return torch.mean(logz - gold)


def make_loss_fn(model: Model, loss_impl: str = "dense") -> Callable:
    """loss_fn(params, batch) -> (loss, {"ce", "aux"}); ``batch`` holds
    "tokens" [B, S] (and the vlm's "prefix_emb" [B, P, h]), or the
    encoder's "features" [B, S, h] and "targets" [B, S]."""
    cfg = model.cfg
    if loss_impl not in ("dense", "fused"):
        raise ValueError(f"loss_impl {loss_impl!r} not in ('dense', 'fused')")

    def ce(logits, targets):
        if sh.is_dtensor(logits):
            return _ce_sharded(logits, targets)
        return _ce(logits, targets, cfg.vocab_size)

    def loss_fn(params, batch):
        if cfg.family == "encoder":
            logits, aux = model.forward(params, features=batch["features"])
            loss = ce(logits, batch["targets"])
            return loss + aux, {"ce": loss, "aux": aux}
        prefix = batch.get("prefix_emb")
        tokens = batch["tokens"]
        if loss_impl == "fused":
            if sh.device_mesh() is not None:
                raise NotImplementedError("the fused loss is not sharded")
            hidden, aux = model.forward(params, tokens, prefix_emb=prefix,
                                        return_hidden=True)
            if prefix is not None:
                hidden = hidden[:, prefix.shape[1]:]
            loss = ce_from_hidden_chunked(hidden[:, :-1],
                                          model.head_matrix(params),
                                          tokens[:, 1:],
                                          vocab=cfg.vocab_size)
        else:
            logits, aux = model.forward(params, tokens, prefix_emb=prefix)
            if prefix is not None:
                logits = logits[:, prefix.shape[1]:]
            loss = ce(logits[:, :-1], tokens[:, 1:])
        return loss + aux, {"ce": loss, "aux": aux}

    return loss_fn


def _to_device(batch, device):
    """The batch's arrays (numpy or torch) as tensors on ``device``; under
    a DeviceMesh, DTensors split over the batch axes (the arrays are the
    global batch; ``data.pipeline.SyntheticTokens.global_array`` makes
    only a rank's rows)."""
    dmesh = sh.device_mesh()
    out = {}
    for k, v in batch.items():
        if dmesh is not None and sh.is_dtensor(v):
            out[k] = v
            continue
        v = torch.as_tensor(v).to(device)
        if dmesh is not None:
            v = sh.place(v, sh.data_spec(sh.mesh_shape(dmesh), v.shape[0],
                                         v.dim() - 1))
        out[k] = v
    return out


def loss_and_grads(loss_fn, params, batch):
    """(loss, metrics, grads): ``loss_fn(params, batch)`` and its gradient
    with respect to every parameter leaf (zeros for a leaf it does not
    read), in the layout of ``params``.  ``params`` themselves are not
    marked: the loss reads aliases of them that require grad."""
    flat = flatten(params)
    live = {k: p.detach().requires_grad_() for k, p in flat.items()}
    with torch.enable_grad():
        with record_function("train.fwd"):
            loss, metrics = loss_fn(unflatten(live), batch)
        with record_function("train.bwd"):
            grads = torch.autograd.grad(loss, list(live.values()),
                                        allow_unused=True,
                                        materialize_grads=True)
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, \
        unflatten(dict(zip(live, grads)))


def make_train_step(model: Model, optimizer: AdamW,
                    loss_impl: str = "dense", device=None) -> Callable:
    """train_step(params, opt_state, batch) -> (params, opt_state,
    metrics) with metrics {"loss", "ce", "aux", "grad_norm", "lr"}; the
    parameters and moments are updated in place.  The step runs on
    ``device`` (the card unless the caller asks for another; it raises
    when there is none) and moves the batch there."""
    device = resolve_device(device)
    loss_fn = make_loss_fn(model, loss_impl)

    def train_step(params, opt_state, batch):
        loss, metrics, grads = loss_and_grads(
            loss_fn, params, _to_device(batch, device))
        with record_function("train.opt"):
            params, opt_state, om = optimizer.update(grads, opt_state,
                                                     params)
        return params, opt_state, {"loss": loss, **metrics, **om}

    return train_step


def make_eval_step(model: Model, device=None) -> Callable:
    """eval_step(params, batch) -> {"loss", "ce", "aux"}, the dense loss
    with no gradient, on ``device`` as ``make_train_step``."""
    device = resolve_device(device)
    loss_fn = make_loss_fn(model)

    def eval_step(params, batch):
        with torch.no_grad():
            loss, metrics = loss_fn(params, _to_device(batch, device))
        return {"loss": loss, **metrics}

    return eval_step
