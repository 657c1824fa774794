"""Checkpoints of the port's parameter and optimizer trees, in the JAX
package's format.

Counterpart of ``repro.checkpoint.store``: the leaves go into one
``arrays.npz`` under their "/"-joined key paths (sorted), beside a
``manifest.json`` with each leaf's shape and dtype name and the step.  A
leaf may be a torch tensor on any device, a numpy array or a scalar.

numpy has no bfloat16 of its own (JAX's arrays use ``ml_dtypes``', which
this package does not import), so a bfloat16 leaf is written as its 2-byte
bit patterns with the header ``<V2`` that JAX's writer gives it: each
``.npy`` member is byte for byte the one JAX writes.  Reading either back,
numpy sees 2-byte void (``|V2``) and only the manifest says "bfloat16" —
JAX's ``load_checkpoint`` returns such leaves as they are (ROADMAP C14).
``load_checkpoint`` here reinterprets every leaf by the manifest's dtype
when it is given a device: the bits of a "bfloat16" leaf become a
``torch.bfloat16`` tensor.
"""
from __future__ import annotations

import json
import os
import struct
import zipfile
from typing import Any, Dict, Tuple

import numpy as np
import torch

_SEP = "/"
_BF16_DESCR = "<V2"      # the header JAX's writer gives a bfloat16 leaf


def flatten(tree, prefix=()) -> Dict[str, Any]:
    """{"a/b": leaf} of a tree of dicts, keys sorted at every level (the
    JAX store's ``_flatten``, and ``jax.tree.leaves``' order)."""
    out = {}
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.update(flatten(tree[k], prefix + (str(k),)))
    else:
        out[_SEP.join(prefix)] = tree
    return out


def unflatten(flat: Dict[str, Any]):
    """The inverse of :func:`flatten` (the JAX store's ``_unflatten``)."""
    tree: Dict[str, Any] = {}
    for key, val in flat.items():
        parts = key.split(_SEP)
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val
    return tree


def _host(leaf) -> Tuple[np.ndarray, str]:
    """(numpy array to write, manifest dtype name) of one leaf; a bfloat16
    leaf becomes its int16 bits."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy(), "bfloat16"
        return t.numpy(), str(t.numpy().dtype)
    a = np.asarray(leaf)
    if a.dtype.name == "bfloat16":       # an ml_dtypes array from a caller
        return np.asarray(a, order="C").view(np.int16), "bfloat16"
    return a, str(a.dtype)


def save_checkpoint(path: str, tree, step: int = 0) -> None:
    """Write ``tree`` (its leaves on any device) and ``step`` to
    ``path/arrays.npz`` and ``path/manifest.json``."""
    os.makedirs(path, exist_ok=True)
    leaves = {}
    # np.savez's layout (stored members "<key>.npy"), written member by
    # member so a bfloat16 leaf can carry JAX's header
    with zipfile.ZipFile(os.path.join(path, "arrays.npz"), mode="w",
                         compression=zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for key, leaf in flatten(tree).items():
            a, name = _host(leaf)
            leaves[key] = {"shape": list(a.shape), "dtype": name}
            with zf.open(key + ".npy", "w", force_zip64=True) as f:
                if name == "bfloat16":
                    np.lib.format.write_array_header_1_0(f, {
                        "descr": _BF16_DESCR, "fortran_order": False,
                        "shape": a.shape})
                    f.write(memoryview(a).cast("B"))
                else:
                    np.lib.format.write_array(f, a, allow_pickle=False)
    with open(os.path.join(path, "manifest.json"), "w") as f:
        json.dump({"step": step, "leaves": leaves}, f, indent=1)


def _to_torch(a: np.ndarray, dtype: str, device) -> torch.Tensor:
    if dtype == "bfloat16":
        if a.dtype.itemsize != 2:
            raise ValueError(f"a bfloat16 leaf stored as {a.dtype}")
        return torch.from_numpy(a.view(np.int16)).view(
            torch.bfloat16).to(device)
    if str(a.dtype) != dtype:
        raise ValueError(f"leaf stored as {a.dtype}, manifest says {dtype}")
    return torch.from_numpy(a).to(device)


def _read_npz(path: str) -> Dict[str, np.ndarray]:
    """The arrays of an npz whose members are stored uncompressed (np.savez
    and :func:`save_checkpoint` write them so), each mapped copy-on-write
    from the file at its data (np.load reads a member through zipfile a
    256 KB chunk at a time, ~2 s a GB)."""
    out = {}
    with zipfile.ZipFile(path) as zf, open(path, "rb") as f:
        for info in zf.infolist():
            if info.compress_type != zipfile.ZIP_STORED:
                raise ValueError(f"{path}: member {info.filename} is "
                                 "compressed; checkpoints store them")
            f.seek(info.header_offset + 26)      # the local header's lengths
            name_len, extra_len = struct.unpack("<HH", f.read(4))
            f.seek(name_len + extra_len, os.SEEK_CUR)
            version = np.lib.format.read_magic(f)
            read_header = (np.lib.format.read_array_header_1_0
                           if version == (1, 0)
                           else np.lib.format.read_array_header_2_0)
            shape, fortran, dtype = read_header(f)
            order = "F" if fortran else "C"
            size = int(np.prod(shape)) * dtype.itemsize
            if shape == () or size == 0:
                a = np.frombuffer(f.read(size), dtype=dtype).copy()
                a = a.reshape(shape, order=order)
            else:
                a = np.memmap(path, dtype=dtype, mode="c", offset=f.tell(),
                              shape=shape, order=order)
            out[info.filename[:-len(".npy")]] = a
    return out


def load_checkpoint(path: str, device=None) -> Tuple[Any, int]:
    """(tree, step) from ``path``.  Without ``device`` the leaves are the
    numpy arrays as stored (as JAX's loader returns them: a bfloat16 leaf
    is 2-byte void); with one, torch tensors on it of the manifest's
    dtypes."""
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    flat = _read_npz(os.path.join(path, "arrays.npz"))
    for k, meta in manifest["leaves"].items():
        if list(flat[k].shape) != meta["shape"]:
            raise ValueError(f"shape mismatch at {k}")
        if device is not None:
            flat[k] = _to_torch(flat[k], meta["dtype"], device)
    return unflatten(flat), manifest["step"]
