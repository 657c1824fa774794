"""Synthetic token pipeline: seeded, reproducible, shardable by rows.

Counterpart of ``repro.data.pipeline`` (numpy in both, so the two give the
same tokens bit for bit).  A counter-based generator (splitmix64 over
(seed, step, index)) makes token streams with no host-side RNG state, so
each data-parallel host can make exactly its rows of the global batch.
Documents are packed: fixed-length sequences with a BOS every ``doc_len``
tokens.  ``global_array`` places a step's batch on a ``DeviceMesh`` as a
DTensor, each rank filling its own block (JAX's ``global_array`` on a
``NamedSharding``, which JAX's package never calls).
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Optional

import numpy as np


def _splitmix64(x: np.ndarray) -> np.ndarray:
    x = (x + np.uint64(0x9E3779B97F4A7C15)) & np.uint64(0xFFFFFFFFFFFFFFFF)
    z = x
    z = ((z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)) \
        & np.uint64(0xFFFFFFFFFFFFFFFF)
    z = ((z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)) \
        & np.uint64(0xFFFFFFFFFFFFFFFF)
    return z ^ (z >> np.uint64(31))


@dataclasses.dataclass
class SyntheticTokens:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    bos_id: int = 1
    doc_len: int = 512

    def batch_at(self, step: int, lo: int = 0,
                 hi: Optional[int] = None) -> np.ndarray:
        """Rows [lo, hi) of the global batch for ``step`` (int32
        [hi - lo, seq_len]): any host can ask for exactly its rows."""
        hi = self.global_batch if hi is None else hi
        rows = np.arange(lo, hi, dtype=np.uint64)[:, None]
        cols = np.arange(self.seq_len, dtype=np.uint64)[None, :]
        key = (np.uint64(self.seed) * np.uint64(0x100000001B3)
               + np.uint64(step) * np.uint64(0x1000193))
        raw = _splitmix64(key + rows * np.uint64(self.seq_len * 131) + cols)
        toks = (raw % np.uint64(max(self.vocab_size - 2, 1))).astype(
            np.int32) + 2
        toks[:, ::self.doc_len] = self.bos_id       # packed document resets
        return toks

    def global_array(self, step: int, device_mesh, spec):
        """``step``'s batch as a DTensor on ``device_mesh`` placed by
        ``spec`` (``runtime.sharding.P``, e.g. ``data_spec``): this rank's
        block is filled from ``batch_at`` over its own rows and columns
        (``DTensor.from_local``); no rank makes the whole batch."""
        import torch
        from torch.distributed.tensor import DTensor
        from torch.distributed.tensor._utils import \
            compute_local_shape_and_global_offset

        from repro_torch.runtime.sharding import placements

        pl = placements(device_mesh, spec)
        shape = (self.global_batch, self.seq_len)
        local, offset = compute_local_shape_and_global_offset(
            shape, device_mesh, pl)
        lo, c0 = offset
        block = self.batch_at(step, lo, lo + local[0])[:, c0:c0 + local[1]]
        block = torch.from_numpy(np.ascontiguousarray(block)).to(
            device_mesh.device_type)
        return DTensor.from_local(block, device_mesh, pl, run_check=False,
                                  shape=shape, stride=(self.seq_len, 1))

    def __iter__(self) -> Iterator[np.ndarray]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1
