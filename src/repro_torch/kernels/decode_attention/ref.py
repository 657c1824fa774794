"""Plain PyTorch single-token decode attention against a contiguous cache
or against KV pages: the references B3 and B4 are held to.  Beside them,
plain models of B4's two passes (``split_partials``, ``combine_partials``)
that the CPU tests hold to the JAX package."""
from __future__ import annotations

import math

import torch

from repro_torch.kernels.flash_attention.ref import NEG_INF, flash_attention_ref


def decode_attention_ref(q, k, v, lengths):
    """q [B,Hq,D]; k, v [B,W,Hkv,D]; lengths [B] int: sequence b attends to
    cache rows [0, lengths[b]).  The one-query case of the prefill
    reference, with the query placed at position lengths[b] - 1."""
    return flash_attention_ref(q[:, None], k, v, lengths - 1, lengths)[:, 0]


def paged_decode_attention_ref(q, k_pages, v_pages, block_tables, lengths):
    """q [B,Hq,D]; k_pages, v_pages [P,ps,Hkv,D]; block_tables [B,n] int
    (physical page of logical page j); lengths [B] int.  Gathers the
    logical view the tables name, then attends to its first lengths[b]
    rows."""
    B, n = block_tables.shape
    ps, Hkv, D = k_pages.shape[1:]
    bt = block_tables.long()
    k = k_pages[bt].reshape(B, n * ps, Hkv, D)
    v = v_pages[bt].reshape(B, n * ps, Hkv, D)
    return decode_attention_ref(q, k, v, lengths.clamp_max(n * ps))


def split_partials(q, k_pages, v_pages, block_tables, lengths,
                   pages_per_split):
    """B4's split pass in plain PyTorch.  Split s covers the table's pages
    [s * pages_per_split, (s + 1) * pages_per_split); a row at or past
    lengths[b], or on a table entry outside [0, P), is masked.  Returns the
    f32 partials of every (sequence, query head, split): the max m and the
    sum l [B,Hq,n_splits] and the unnormalised accumulator acc
    [B,Hq,n_splits,D].  A split past the live pages is NaN: the kernel
    writes nothing there, and ``combine_partials`` never reads it."""
    B, Hq, D = q.shape
    P, ps, Hkv = k_pages.shape[:3]
    n = block_tables.shape[1]
    G, rows, dev = Hq // Hkv, pages_per_split * ps, q.device
    ns = -(-n // pages_per_split)
    bt = block_tables.long()
    page_ok = (bt >= 0) & (bt < P)
    safe = torch.where(page_ok, bt, 0)
    pad = ns * rows - n * ps
    k = _pad_rows(k_pages[safe].reshape(B, n * ps, Hkv, D).float(), pad)
    v = _pad_rows(v_pages[safe].reshape(B, n * ps, Hkv, D).float(), pad)
    lens = lengths.long().clamp(0, n * ps)
    idx = torch.arange(ns * rows, device=dev)
    mask = (idx[None] < lens[:, None]) & torch.cat(
        [page_ok.repeat_interleave(ps, dim=1),
         torch.zeros(B, pad, dtype=torch.bool, device=dev)], dim=1)  # [B,T]
    logits = torch.einsum("bkgd,btkd->bkgt", q.float().reshape(B, Hkv, G, D),
                          k) * (1.0 / math.sqrt(D))
    mask = mask.reshape(B, 1, 1, ns, rows)
    logits = torch.where(mask, logits.reshape(B, Hkv, G, ns, rows), NEG_INF)
    m = logits.amax(dim=-1)
    p = torch.where(mask, torch.exp(logits - m[..., None]), 0.0)
    acc = torch.einsum("bkgsr,bsrkd->bkgsd", p,
                       v.reshape(B, ns, rows, Hkv, D))
    live = torch.arange(ns, device=dev)[None] < -(-lens // rows)[:, None]
    live = live[:, None, None]
    m = torch.where(live, m, float("nan"))
    l = torch.where(live, p.sum(dim=-1), float("nan"))
    acc = torch.where(live[..., None], acc, float("nan"))
    return (m.reshape(B, Hq, ns), l.reshape(B, Hq, ns),
            acc.reshape(B, Hq, ns, D))


def _pad_rows(x, rows):
    """x [B,T,...] with ``rows`` zero rows appended along T."""
    return torch.cat([x, x.new_zeros((x.shape[0], rows) + x.shape[2:])], 1)


def combine_partials(m, l, acc, lengths, span, split_rows, dtype):
    """B4's combine pass in plain PyTorch: for sequence b only the first
    ceil(min(lengths[b], span) / split_rows) splits are live; M = max m over
    them, out = sum acc e^(m - M) / max(sum l e^(m - M), 1e-30), cast to
    ``dtype``.  m, l [B,Hq,n_splits]; acc [B,Hq,n_splits,D] (f32)."""
    ns = m.shape[-1]
    lens = lengths.long().clamp(0, span)
    live = torch.arange(ns, device=m.device)[None] < \
        (-(-lens // split_rows))[:, None]
    live = live[:, None]                                        # [B,1,ns]
    mk = torch.where(live, m, NEG_INF)
    M = mk.amax(dim=-1, keepdim=True)
    f = torch.where(live, torch.exp(mk - M), 0.0)
    L = (torch.where(live, l, 0.0) * f).sum(dim=-1)
    A = (torch.where(live[..., None], acc, 0.0) * f[..., None]).sum(dim=-2)
    return (A / L.clamp_min(1e-30)[..., None]).to(dtype)
