"""Plain PyTorch single-token decode attention against a contiguous cache
or against KV pages: the references B3 and B4 are held to.  Beside them,
plain models of the two passes both kernels run (``split_partials``,
``combine_partials``) that the CPU tests hold to the JAX package."""
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


def split_partials(q, k, v, lengths, split_rows, block_tables=None):
    """The split pass of B3 and B4 in plain PyTorch.  Without
    ``block_tables`` k, v are contiguous caches [B,W,Hkv,D] and split s
    covers rows [s * split_rows, (s + 1) * split_rows) (B3); with them k, v
    are page pools [P,ps,Hkv,D], split_rows a whole number of pages, and
    split s covers the table's pages [s * pps, (s + 1) * pps), pps =
    split_rows / ps (B4).  A row at or past lengths[b], or on a table entry
    outside [0, P), is masked.  Returns the f32 partials of every
    (sequence, query head, split): the max m and the sum l [B,Hq,n_splits]
    and the unnormalised accumulator acc [B,Hq,n_splits,D].  A split past
    the length is NaN: the kernel writes nothing there, and
    ``combine_partials`` never reads it."""
    B, Hq, D = q.shape
    Hkv, dev = k.shape[2], q.device
    G, rows = Hq // Hkv, split_rows
    if block_tables is None:
        T = k.shape[1]
        row_ok = torch.ones(B, T, dtype=torch.bool, device=dev)
    else:
        P, ps = k.shape[:2]
        n = block_tables.shape[1]
        T = n * ps
        bt = block_tables.long()
        page_ok = (bt >= 0) & (bt < P)
        safe = torch.where(page_ok, bt, 0)
        k, v = (x[safe].reshape(B, T, Hkv, D) for x in (k, v))
        row_ok = page_ok.repeat_interleave(ps, dim=1)
    ns = -(-T // rows)
    pad = ns * rows - T
    k, v = (_pad_rows(x.float(), pad) for x in (k, v))
    lens = lengths.long().clamp(0, T)
    idx = torch.arange(ns * rows, device=dev)
    mask = (idx[None] < lens[:, None]) & _pad_rows(row_ok, pad)   # [B,T]
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
    """The combine pass of B3 and B4 in plain PyTorch: for sequence b only the first
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
