"""Dispatch for decode attention: kernels B3 (contiguous cache) and B4
(KV pages) on CUDA tensors, the plain versions on CPU tensors."""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.decode_attention.ref import (
    decode_attention_ref, paged_decode_attention_ref, split_partials)

HEAD_DIMS = (32, 64, 128, 256)
MAX_GROUPS = 8          # query heads per KV head the kernel holds
SPLIT_KEYS = 128        # keys one split covers: B3 exactly, B4 about


def split_geometry(page_size: int, n_pages: int):
    """(pages per split, splits) of B4's split pass over a block table of
    ``n_pages`` entries: each split covers whole pages, about SPLIT_KEYS
    keys, and the count follows from the table's width alone (no length
    is read on the host)."""
    pps = max(1, SPLIT_KEYS // page_size)
    return pps, -(-n_pages // pps)


def decode_attention(q, k, v, lengths):
    if q.device.type == "cpu":
        return decode_attention_ref(q, k, v, lengths)
    return decode_attention_cuda(q, k, v, lengths)


def decode_attention_partials(q, k, v, lengths):
    """B3's split pass alone: the f32 partials (m, l [B,Hq,n_splits], acc
    [B,Hq,n_splits,D]) of each SPLIT_KEYS-row split of k, v over their
    first lengths[b] rows, as ``split_partials``; a split past the length
    holds nothing defined.  The caller combines them (a sequence-parallel
    cache, across the ranks that hold its rows)."""
    if q.device.type == "cpu":
        return split_partials(q, k, v, lengths, SPLIT_KEYS)
    return decode_attention_partials_cuda(q, k, v, lengths)


def paged_decode_attention(q, k_pages, v_pages, block_tables, lengths):
    if q.device.type == "cpu":
        return paged_decode_attention_ref(q, k_pages, v_pages, block_tables,
                                          lengths)
    return paged_decode_attention_cuda(q, k_pages, v_pages, block_tables,
                                       lengths)


def _check_cache(name, t, what, dev, dt, shape):
    if t.device != dev or t.dtype != dt or tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: {what} is {t.dtype} {tuple(t.shape)} on "
                         f"{t.device}, expected {dt} {tuple(shape)} on {dev}")
    if t.stride(-1) != 1:
        raise ValueError(f"{name}: {what} needs a unit last-dim stride")


def _check_q(name, q, Hkv):
    if q.device.type != "cuda":
        raise ValueError(f"{name}: q on {q.device}, expected a CUDA device")
    B, Hq, D = q.shape
    if D not in HEAD_DIMS or Hq % Hkv or not 1 <= Hq // Hkv <= MAX_GROUPS:
        raise ValueError(f"{name}: head_dim {D} not in {HEAD_DIMS}, or "
                         f"{Hq} query heads over {Hkv} KV heads")
    _build.require(name, "q", q, q.device, q.dtype)
    return B, Hq, D


def decode_attention_cuda(q, k, v, lengths):
    """Launch B3, the split pass then the combine pass (one count).  q
    [B,Hq,D] contiguous; k, v [B,W,Hkv,D] read in place through their
    strides (unit last-dim stride, K and V alike; the base on a 16-byte
    boundary and the other strides multiples of 16 bytes, since the kernel
    loads 16 bytes a lane); lengths [B] int32."""
    out = torch.empty_like(q)
    _launch_b3("decode_attention_cuda", q, k, v, lengths, out)
    return out


def decode_attention_partials_cuda(q, k, v, lengths):
    """Launch B3's split pass alone (one count; the inputs as
    ``decode_attention_cuda``'s) -> its f32 partials (m, l, acc)."""
    return _launch_b3("decode_attention_partials_cuda", q, k, v, lengths,
                      None)


def _launch_b3(name, q, k, v, lengths, out):
    """B3's launch: the split pass into f32 partials it allocates, then,
    where ``out`` is given, the combine pass into it.  Returns the
    partials."""
    W, Hkv = k.shape[1], k.shape[2]
    B, Hq, D = _check_q(name, q, Hkv)
    dev, dt = q.device, q.dtype
    _check_cache(name, k, "k", dev, dt, (B, W, Hkv, D))
    _check_cache(name, v, "v", dev, dt, (B, W, Hkv, D))
    if k.stride() != v.stride():
        raise ValueError(f"{name}: k and v strides differ")
    _check_16_bytes(name, "k", k)
    _check_16_bytes(name, "v", v)
    _build.require(name, "lengths", lengths, dev, torch.int32, (B,))
    code = _build.dtype_code(dt)
    n_splits = -(-W // SPLIT_KEYS)
    part_m, part_l, part_acc = _partials(B, Hq, n_splits, D, dev)
    sb, sw, sh, _ = k.stride()
    with torch.cuda.device(dev):
        rc = _build.lib().repro_decode_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if out is None else out.data_ptr(), lengths.data_ptr(),
            part_m.data_ptr(), part_l.data_ptr(), part_acc.data_ptr(), B, W,
            n_splits, Hkv, Hq // Hkv, D, sb, sw, sh, 1.0 / math.sqrt(D),
            code, _build.stream_ptr(dev))
    _build.check(rc, name)
    _build.count("decode_attention")
    return part_m, part_l, part_acc


def _check_16_bytes(name, what, t):
    """The kernels load 16 bytes a lane: the base on a 16-byte boundary and
    every stride but the last a multiple of 16 bytes."""
    esz = t.element_size()
    if t.data_ptr() % 16 or any(st * esz % 16 for st in t.stride()[:3]):
        raise ValueError(
            f"{name}: {what} must start on a 16-byte boundary with strides "
            f"in multiples of 16 bytes, got address {t.data_ptr()} and "
            f"strides {t.stride()[:3]}")


def _partials(B, Hq, n_splits, D, dev):
    """The split pass's f32 partials: m, l [B,Hq,n_splits], acc
    [B,Hq,n_splits,D]."""
    part_m = torch.empty((B, Hq, n_splits), dtype=torch.float32, device=dev)
    return (part_m, torch.empty_like(part_m),
            torch.empty((B, Hq, n_splits, D), dtype=torch.float32,
                        device=dev))


def paged_decode_attention_cuda(q, k_pages, v_pages, block_tables, lengths):
    """Launch B4, the split pass then the combine pass (one count).  q
    [B,Hq,D] contiguous; k_pages, v_pages [P,ps,Hkv,D] read in place
    through their strides (unit last-dim stride, K and V alike; the base on
    a 16-byte boundary and the page, row and head strides multiples of 16
    bytes, since the kernel loads 16 bytes a lane); block_tables [B,n] and
    lengths [B] int32."""
    name = "paged_decode_attention_cuda"
    P, ps, Hkv = k_pages.shape[:3]
    B, Hq, D = _check_q(name, q, Hkv)
    dev, dt = q.device, q.dtype
    _check_cache(name, k_pages, "k_pages", dev, dt, (P, ps, Hkv, D))
    _check_cache(name, v_pages, "v_pages", dev, dt, (P, ps, Hkv, D))
    if k_pages.stride() != v_pages.stride():
        raise ValueError(f"{name}: k_pages and v_pages strides differ")
    _check_16_bytes(name, "k_pages", k_pages)
    _check_16_bytes(name, "v_pages", v_pages)
    n = block_tables.shape[1] if block_tables.dim() == 2 else -1
    _build.require(name, "block_tables", block_tables, dev, torch.int32,
                   (B, n))
    _build.require(name, "lengths", lengths, dev, torch.int32, (B,))
    code = _build.dtype_code(dt)
    out = torch.empty_like(q)
    pps, n_splits = split_geometry(ps, n)
    part_m, part_l, part_acc = _partials(B, Hq, n_splits, D, dev)
    sp, sr, sh, _ = k_pages.stride()
    with torch.cuda.device(dev):
        rc = _build.lib().repro_paged_decode_attention(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            out.data_ptr(), block_tables.data_ptr(), lengths.data_ptr(),
            part_m.data_ptr(), part_l.data_ptr(), part_acc.data_ptr(),
            B, P, ps, n, pps, n_splits, Hkv, Hq // Hkv, D, sp, sr, sh,
            1.0 / math.sqrt(D), code, _build.stream_ptr(dev))
    _build.check(rc, name)
    _build.count("paged_decode_attention")
    return out
