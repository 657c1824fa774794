"""The paper's tables and figures on the port (``repro_torch.paper``)
against the JAX package's scripts (``benchmarks/``).

Every row of Tables III–VI, Figs 6–10 and the planner equals the JAX
script's row by name and ``derived`` (only the time may differ).  Fig. 4
runs the port's TP engine at full size on meta tensors: each of its three
rows reads EXACT, its all-reduce count is ``tp_comm_ops``' and its bytes
that closed form's at b = 2.  The dry-run readers give JAX's rows on one
archive of the port's records (written by ``launch.dryrun.run_one``),
skipping every record that is not ``ok``; and ``paper.run`` prints one
CSV with no failed module.
"""
import importlib
import json
import pathlib
import sys

import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as jax_config  # noqa: E402
from repro.core import commodel as jax_cm  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.paper import (fig4_validation, perf_variants,  # noqa: E402
                               roofline_table, run)

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:            # the JAX scripts' package
    sys.path.insert(0, str(ROOT))

ANALYTIC = ["table3_tp", "table4_models", "table5_pp", "table6_hybrid",
            "fig6_volume", "fig7_scaling", "fig8_9_10_slo", "planner_bench"]


def _named(rows):
    return [(name, derived) for name, _, derived in rows]


@pytest.mark.parametrize("module", ANALYTIC)
def test_analytic_rows_equal_jax(module):
    want = importlib.import_module(f"benchmarks.{module}").rows()
    got = importlib.import_module(f"repro_torch.paper.{module}").rows()
    assert want and _named(got) == _named(want)
    assert all(us >= 0 for _, us, _ in got)


@pytest.fixture(scope="module")
def fig4():
    return {arch: fig4_validation.measure(arch)
            for arch in fig4_validation.MODELS}


@pytest.mark.parametrize("arch", fig4_validation.MODELS)
def test_fig4_full_size_reads_exact(fig4, arch, monkeypatch):
    """The meta-tensor TP prefill at t = 4, S = 128: 2L + 1 all-reduces
    of b = 2 bytes per element (the bf16 wire) and one all-gather."""
    rec = fig4[arch]
    cfg = jax_config(arch)
    pred = [o for o in jax_cm.tp_comm_ops(cfg, 128, 1, 4,
                                          gather_mode="allgather", batch=1)
            if o.collective == "allreduce"]
    assert rec["measured_ar"] == sum(o.count for o in pred) \
        == 2 * cfg.num_layers + 1
    assert rec["measured_ar_bytes"] == \
        sum(o.count * o.elements * 2 for o in pred)
    assert rec["measured_ag"] == 1
    monkeypatch.setattr(fig4_validation, "measure", fig4.get)
    row = dict((n, d) for n, _, d in fig4_validation.rows())[
        f"fig4/{arch}/tp4_fullsize"]
    assert row.endswith("match=EXACT")
    assert f"ar_bytes={rec['measured_ar_bytes']}" in row


@pytest.fixture(scope="module")
def record():
    """One ``ok`` record of the port's dry run (phi3-mini-3.8b
    decode_32k on the 16 x 16 pod, on meta tensors)."""
    return dryrun.run_one("phi3-mini-3.8b", "decode_32k", False)


def _archive(tmp_path, record):
    """An archive of ok, skip, not_ported, error and variant records."""
    def put(name, rec):
        (tmp_path / f"{name}.json").write_text(json.dumps(rec))

    assert record["status"] == "ok" and record["collectives_match"]
    put("phi3-mini-3.8b__decode_32k__pod16x16", record)
    put("hubert-xlarge__decode_32k__pod16x16",
        dryrun.run_one("hubert-xlarge", "decode_32k", False))   # skip
    faster = json.loads(json.dumps(record))
    faster["roofline"]["memory_s"] /= 2
    faster.update(arch="granite-8b", shape="prefill_32k",
                  variant="chunked_attn",
                  mesh="pod16x16__chunked_attn")
    put("granite-8b__prefill_32k__pod16x16", dict(
        record, arch="granite-8b", shape="prefill_32k"))
    put("granite-8b__prefill_32k__pod16x16__chunked_attn", faster)
    for variant in ("moe_local", "moe_local_fsdp"):
        put(f"mixtral-8x22b__prefill_32k__pod16x16__{variant}", {
            "arch": "mixtral-8x22b", "shape": "prefill_32k",
            "mesh": f"pod16x16__{variant}", "variant": variant,
            "status": "not_ported",
            "skip_reason": "moe_dispatch='local' runs on a VirtualMesh"})
    put("rwkv6-7b__train_4k__pod16x16", {
        "arch": "rwkv6-7b", "shape": "train_4k", "mesh": "pod16x16",
        "status": "error", "error": "Traceback ..."})
    return tmp_path


def test_dryrun_readers_give_jax_rows_on_the_ports_archive(
        tmp_path, record, monkeypatch):
    from benchmarks import perf_variants as jax_perf
    from benchmarks import roofline_table as jax_roofline
    archive = str(_archive(tmp_path, record))
    for mod in (roofline_table, perf_variants, jax_roofline, jax_perf):
        monkeypatch.setattr(mod, "RESULTS", archive)

    got = roofline_table.rows()
    assert _named(got) == _named(jax_roofline.rows())
    assert [n for n, _ in _named(got)] == [
        "roofline/granite-8b/prefill_32k/pod16x16",
        "roofline/phi3-mini-3.8b/decode_32k/pod16x16"]
    rf = record["roofline"]
    assert f"dominant={rf['dominant']}" in got[1][2]

    got = perf_variants.rows()
    assert _named(got) == _named(jax_perf.rows())
    assert [n for n, _ in _named(got)] == [
        "perf/granite-8b/prefill_32k/baseline",
        "perf/granite-8b/prefill_32k/chunked_attn"]
    assert "bound_speedup=" in got[1][2]


def test_dryrun_readers_without_an_archive(tmp_path, monkeypatch, capsys):
    missing = str(tmp_path / "absent")
    for mod in (roofline_table, perf_variants):
        monkeypatch.setattr(mod, "RESULTS", missing)
    assert roofline_table.rows() == []
    rows = perf_variants.rows()
    assert len(rows) == 1 and rows[0][2].startswith("no_dryrun_archive")
    roofline_table.main()
    assert "no dry-run records yet" in capsys.readouterr().out


def test_run_prints_one_csv_with_no_failed_module(fig4, tmp_path,
                                                  monkeypatch, capsys):
    monkeypatch.setattr(fig4_validation, "measure", fig4.get)
    for mod in (roofline_table, perf_variants):
        monkeypatch.setattr(mod, "RESULTS", str(tmp_path))
    run.main()
    out, err = capsys.readouterr()
    lines = out.splitlines()
    assert lines[0] == "name,us_per_call,derived"
    assert "FAILED" not in err
    names = [line.split(",", 2)[0] for line in lines[1:]]
    assert len(names) == len(set(names))
    want = sum(len(importlib.import_module(m).rows())
               for m in run.MODULES)
    assert len(names) == want
    assert sum(n.startswith("fig4/") for n in names) == 3
    assert all(line.endswith("match=EXACT") for line in lines
               if line.startswith("fig4/"))
