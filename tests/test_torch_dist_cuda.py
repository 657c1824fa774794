"""The explicit TP, PP and TP x PP engines and context parallelism on four
cards, one rank a card over NCCL, against the same engines on virtual
ranks on card 0.

One spawn of four NCCL ranks (``torch_dist_ranks.card_rank``) at the full
width of llama32-3b in bf16 on seed-0 weights, at (t, c, p) = (4, 1, 1),
(2, 1, 2), (1, 1, 4), (1, 4, 1), (2, 2, 1) and (1, 2, 2):

  * a 333-token prefill (at c > 1 a CP prefill, padded to a multiple of
    c, each rank running its own shard; paged, its cache seeded into the
    pages) and 128 teacher-forced decode steps, contiguous and paged, on
    the last stage held to the virtual engine's logits by phase 5's
    measure (top-1 match at least ``chip_smoke.LOGIT_MATCH_FLOOR``, max
    drift at most ``LOGIT_DRIFT_CEILING``; NCCL's bf16 sums of four
    terms run in another order than the virtual group's rank order),
    every logit finite, and whether they are bitwise recorded;
  * at t = 4, the int8 decode's 128 steps from the virtual engine's
    prefill (each rank's cache its piece of it): its collectives are
    exact (the embedding's sum of one non-zero term, the int8 two-step,
    the gathers), so the logits equal the virtual int8 engine's bit for
    bit;
  * at t = 4, the int8 run that serving makes, from the ranks' own
    prefill, held to the virtual unquantized engine by the limits phase
    5 sets for int8 against unquantized at full width
    (``chip_smoke.FULL_WIDTH_QUANT_LIMITS``);
  * each rank's kernel launches equal ``chip_smoke.rank_launches`` for its
    stage (at c > 1 with its CP pass);
  * the int8, fp8 and int4 all-reduces at [4, 3072] bf16 bit for bit the
    virtual group's on the same card;
  * f32 at L = 4: greedy tokens identical to the virtual engine's;
  * serve_demo's ``run`` on ranks (tp t = 4, pp p = 4, tp c = 4): every
    rank admitted the same requests, and the streams equal its
    one-process run.

Each layout's prefill and decode step are timed on every rank and, on
card 0, on the virtual engine, and at (4, 1, 1), (1, 4, 1), (2, 2, 1)
and (1, 2, 2) a 2048-token prefill (``torch_dist_ranks.long_prefill``;
printed; ``-s`` shows them).  Needs four
CUDA cards (marker ``gpu``; skipped with fewer).  Imports neither JAX nor
the JAX package:

    python -m pytest -q -p no:cacheprovider --noconftest \\
        tests/test_torch_dist_cuda.py
"""
import json
import pathlib
import socket
import sys

import pytest

torch = pytest.importorskip("torch")

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
import chip_smoke  # noqa: E402  (the repo root: the launch formula)
import torch_dist_ranks as tdr  # noqa: E402  (tests/: the ranks' program)

LAYOUT_KEYS = ["{}-{}-{}".format(*lay) for lay in tdr.LAYOUTS]


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def card_rows(tmp_path_factory):
    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA cards")
    import torch.multiprocessing as mp

    from repro_torch.kernels import _build
    _build.build()                  # once, before the ranks load it
    out = str(tmp_path_factory.mktemp("dist_cuda") / "rows.json")
    mp.spawn(tdr.card_rank, args=(4, _free_port(), out), nprocs=4)
    with open(out) as f:
        rows = json.load(f)
    print(json.dumps(rows))
    return rows


@pytest.mark.gpu
@pytest.mark.parametrize("layout", LAYOUT_KEYS)
def test_forced_logits_match_the_virtual_engine(card_rows, layout):
    t, c, p = map(int, layout.split("-"))
    held = 0
    for r in card_rows:
        row = r["layouts"][layout]
        for mode, run in row["runs"].items():
            if row["stage"] != p - 1:
                assert "match" not in run, (r["rank"], mode)
                continue
            held += 1
            assert run["finite"], (r["rank"], mode)
            if mode == "int8":
                assert run["bitwise"], (r["rank"], run)
            floor, ceiling = (chip_smoke.LOGIT_MATCH_FLOOR,
                              chip_smoke.LOGIT_DRIFT_CEILING)
            if mode == "int8_own":
                lim = chip_smoke.FULL_WIDTH_QUANT_LIMITS["int8"]
                floor, ceiling = lim["floor"], lim["ceiling"]
            assert run["match"] >= floor, (r["rank"], mode, run["match"])
            assert run["drift"] <= ceiling, (r["rank"], mode, run["drift"])
    assert held == t * c * (4 if (t, c, p) == (4, 1, 1) else 2)


@pytest.mark.gpu
@pytest.mark.parametrize("layout", LAYOUT_KEYS)
def test_each_rank_launches_its_formula(card_rows, layout):
    for r in card_rows:
        for mode, run in r["layouts"][layout]["runs"].items():
            assert run["launches"] == run["want_launches"], (r["rank"], mode)
            assert run["launches"]["decode_attention"
                                   if mode != "paged" else
                                   "paged_decode_attention"] > 0


@pytest.mark.gpu
@pytest.mark.parametrize("quant", ["int8", "fp8", "int4"])
def test_quantized_allreduce_bitwise_on_four_cards(card_rows, quant):
    assert all(r["quant"][quant] for r in card_rows)


@pytest.mark.gpu
@pytest.mark.parametrize("layout", LAYOUT_KEYS)
def test_f32_greedy_tokens_equal_the_virtual_engine(card_rows, layout):
    assert all(r["f32_tokens"][layout] for r in card_rows)


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["{}-{}-{}".format(*lay)
                                    for lay in tdr.LONG_LAYOUTS])
def test_long_prefill_timed_on_every_rank(card_rows, layout):
    for r in card_rows:
        long = r["layouts"][layout]["long"]
        assert long["tokens"] == tdr.CARD["long"]
        assert long["wall_ms"] > 0 and long["busy_ms"] > 0, r["rank"]
    assert card_rows[0]["layouts"][layout]["virtual_long"]["busy_ms"] > 0


@pytest.mark.gpu
@pytest.mark.parametrize("backend", [name for name, _, _ in tdr.SERVE_DEMO])
def test_serve_demo_on_ranks_streams_its_one_process_run(card_rows,
                                                         backend):
    for r in card_rows:
        got = r["serve_demo"][backend]
        assert got["streams_equal"] and got["requests"] == 8, r["rank"]
