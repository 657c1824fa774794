"""The sharded step's kernel path across four cards, against the
unsharded kernel path.

One spawn of four NCCL ranks, a card each, on a (data, model) = (1, 4)
mesh (``torch_spmd_ranks.kernel_rank``), a prefill of 2 × 16 tokens and 8
decode steps per case, each reduced and in f32:

  * granite-8b with 2 KV heads: 2 KV heads do not divide 4, so the
    prefill all-gathers K and V and runs B2 on each rank's query heads,
    and each decode step runs on a sequence-parallel cache of 32 rows, 8
    a rank: B3's split pass alone on the rank's rows, then one MAX and one
    SUM all-reduce of its partials.  Logits within 1e-4 (relative past 1)
    of the unsharded kernel path's on the same card; B2 launched once a
    layer, B3's split pass once a layer and step.
  * rwkv6-7b (4 heads, one a rank): B10 on the rank's head, once a layer
    and pass; the channel mix's reduce-scatter and all-gather.
  * hymba-1.5b at head dim 64 (the reduced 66 is no head dim of the
    attention kernels): 4 attention and 4 KV heads, one a rank, B2 once a
    layer, B3 once a layer and step on the rank's KV head; the mamba
    branch on the rank's 16 of its 64 channels, xz all-gathered.
  * deepseek-moe-16b on the local dispatch (``moe_dispatch="local"``):
    its 4 experts, stored one a rank, redistributed to their f blocks by
    three all-to-alls a layer over NCCL; at dp = 1 the local capacity is
    the global one, so the values are the unsharded path's.  The
    launches are the dense formula (B1 once a pass, 2L add_rms_norm, B2
    once a layer, B3 once a layer and step).

Greedy tokens equal to the unsharded kernel path's; the families' logits
within 1e-5 (relative past 1).  Needs four CUDA cards (marker ``gpu``;
skipped with fewer).  Imports neither JAX nor the JAX package:

    python -m pytest -q -p no:cacheprovider --noconftest \
        tests/test_torch_spmd_cuda.py
"""
import json
import socket

import pytest

torch = pytest.importorskip("torch")

import torch_spmd_ranks  # noqa: E402  (tests/: the ranks' program)

NEW = 8
CASES = [("granite-8b", 2), ("rwkv6-7b", None), ("hymba-1.5b", "d64"),
         ("deepseek-moe-16b", "local")]


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def kernel_rows(tmp_path_factory):
    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA cards")
    import torch.multiprocessing as mp
    out = str(tmp_path_factory.mktemp("spmd_cuda") / "rows.json")
    mp.spawn(torch_spmd_ranks.kernel_rank,
             args=(4, _free_port(), CASES, NEW, out), nprocs=4)
    with open(out) as f:
        return {r["case"]: r for r in json.load(f)}


def _row(rows, arch, kv):
    row = rows[torch_spmd_ranks.case_name(arch, kv, (1, 4))]
    print(row)
    assert row["tokens_equal"]
    return row


@pytest.mark.gpu
def test_sequence_parallel_decode_kernels_on_four_cards(kernel_rows):
    row = _row(kernel_rows, "granite-8b", 2)
    L = row["layers"]
    assert row["layout"] == "seq"
    assert row["logit_err"] <= 1e-4 * max(1.0, row["logit_scale"])
    assert row["launches"]["flash_attention"] == L
    assert row["launches"]["decode_attention"] == L * NEW


@pytest.mark.gpu
@pytest.mark.parametrize("arch,kv", CASES[1:3], ids=[a for a, _ in CASES[1:3]])
def test_family_kernels_on_four_cards(kernel_rows, arch, kv):
    row = _row(kernel_rows, arch, kv)
    L = row["layers"]
    assert row["logit_err"] <= 1e-5 * max(1.0, row["logit_scale"])
    if arch == "rwkv6-7b":
        assert row["launches"]["wkv6"] == L * (NEW + 1)
    else:
        assert row["layout"] == "heads"
        assert row["launches"]["flash_attention"] == L
        assert row["launches"]["decode_attention"] == L * NEW
        assert row["launches"]["rmsnorm"] == (NEW + 1) * (1 + 2 * L)


@pytest.mark.gpu
def test_local_moe_dispatch_on_four_cards(kernel_rows):
    row = _row(kernel_rows, "deepseek-moe-16b", "local")
    L, passes = row["layers"], NEW + 1
    assert row["layout"] == "heads"
    assert row["logit_err"] <= 1e-5 * max(1.0, row["logit_scale"])
    launches = row["launches"]
    assert launches["flash_attention"] == L
    assert launches["decode_attention"] == L * NEW
    assert launches["rmsnorm"] == passes
    assert launches["add_rms_norm"] == 2 * L * passes
    # the reshard: three all-to-alls a layer and pass over the 4 cards
    assert row["collectives"]["alltoall"] == [3 * L * passes, [4]]
