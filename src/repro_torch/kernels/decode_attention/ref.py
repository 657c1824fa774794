"""Plain PyTorch single-token decode attention against a contiguous cache
or against KV pages: the references B3 and B4 are held to."""
from __future__ import annotations

from repro_torch.kernels.flash_attention.ref import flash_attention_ref


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
