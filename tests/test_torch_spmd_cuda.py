"""The sharded step's kernel path across four cards, against the
unsharded kernel path.

Reduced granite-8b with 2 KV heads (f32) on a (data, model) = (1, 4)
mesh of four NCCL ranks, a card each: 2 KV heads do not divide 4, so the
prefill all-gathers K and V and runs B2 on each rank's query heads, and
each decode step runs on a sequence-parallel cache of 32 rows, 8 a rank:
B3's split pass alone on the rank's rows, then one MAX and one SUM
all-reduce of its partials.  A prefill and 8 decode steps: logits within
1e-4 (relative past 1) and greedy tokens equal to the unsharded kernel
path's on the same card; B2 launched once a layer, B3's split pass once a
layer and step.  Needs four CUDA cards (marker ``gpu``; skipped with
fewer).  Imports neither JAX nor the JAX package:

    python -m pytest -q -p no:cacheprovider --noconftest \
        tests/test_torch_spmd_cuda.py
"""
import json
import socket

import pytest

torch = pytest.importorskip("torch")

import torch_spmd_ranks  # noqa: E402  (tests/: the ranks' program)

NEW = 8


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.mark.gpu
def test_sequence_parallel_decode_kernels_on_four_cards(tmp_path):
    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA cards")
    import torch.multiprocessing as mp
    out = str(tmp_path / "row.json")
    mp.spawn(torch_spmd_ranks.kernel_rank,
             args=(4, _free_port(), NEW, out), nprocs=4)
    with open(out) as f:
        row = json.load(f)
    print(row)
    L = row["layers"]
    assert row["layout"] == "seq"
    assert row["logit_err"] <= 1e-4 * max(1.0, row["logit_scale"])
    assert row["tokens_equal"]
    assert row["launches"]["flash_attention"] == L
    assert row["launches"]["decode_attention"] == L * NEW
