"""Synthetic token pipeline: seeded, reproducible, shardable by rows.

Counterpart of ``repro.data.pipeline`` (numpy in both, so the two give the
same tokens bit for bit).  A counter-based generator (splitmix64 over
(seed, step, index)) makes token streams with no host-side RNG state, so
each data-parallel host can make exactly its rows of the global batch.
Documents are packed: fixed-length sequences with a BOS every ``doc_len``
tokens.  JAX's ``global_array`` (a batch placed on a device mesh) has no
counterpart yet: it waits for sharded execution (ROADMAP A13 part 2).
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

    def __iter__(self) -> Iterator[np.ndarray]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1
