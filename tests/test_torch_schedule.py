"""The port's instruction queues, ``PPBackend`` and the A10 analytics
against the JAX package and the closed forms.

Reduced llama32-3b in float32 (2 layers; num_kv_heads = 2 where t = 2),
weights from the JAX package's ``Model.init`` through numpy:

* one admission wave at depth d: the executed instruction log and the
  queue's ticks, busy and idle equal ``commodel.pp_schedule_stats``, and
  every round's transfers equal the decode send rows at the group batch
  (``pp_schedule_ops`` composes the totals);
* streams at depth d equal depth 1 and the single-device backend,
  contiguous and paged, and at p = 4; ``ServingReport.occupancy()``
  equals the closed form;
* ``FusedQueue`` on the gspmd and tp backends; ``make_backend`` rejects a
  bad ``inflight`` and c > 1 (ROADMAP A7);
* ``PPBackend`` streams through ``Scheduler`` equal JAX's ``PPBackend``
  streams (contiguous and paged, t = 1 and 2), with the same step
  records;
* ``core/slo.py`` and ``core/planner.py`` give the reference's outputs on
  a grid of layouts.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.core import planner as jax_planner  # noqa: E402
from repro.core import slo as jax_slo  # noqa: E402
from repro.models.transformer import get_model as jax_model  # noqa: E402
from repro.runtime import backends as jax_backends  # noqa: E402
from repro.runtime import request as jax_request  # noqa: E402
from repro.runtime import scheduler as jax_scheduler  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config as port_config  # noqa: E402
from repro_torch.core import commodel as cm  # noqa: E402
from repro_torch.core import planner, slo  # noqa: E402
from repro_torch.models.transformer import get_model as port_model  # noqa: E402
from repro_torch.runtime import request as port_request  # noqa: E402
from repro_torch.runtime.backends import make_backend  # noqa: E402
from repro_torch.runtime.request import Request  # noqa: E402
from repro_torch.runtime.schedule import (BoundaryRecv, BoundarySend,  # noqa: E402
                                          DynamicPPQueue, FusedQueue,
                                          PrefillChunk, SampleToken,
                                          StageForward, make_queue)
from repro_torch.runtime.scheduler import Scheduler, VirtualClock  # noqa: E402

needs_mesh = pytest.mark.skipif(len(jax.devices()) < 4,
                                reason="needs 4 host-platform devices")
MAX_LEN = 64
GROUP = 2          # slots per microbatch group
NEW_TOKENS = 5     # per request: NEW_TOKENS - 1 decode rounds


def _weights(kv=4):
    jcfg = dataclasses.replace(jax_config("llama32-3b").reduced(),
                               num_kv_heads=kv)
    tcfg = dataclasses.replace(port_config("llama32-3b").reduced(),
                               num_kv_heads=kv)
    jparams = jax_model(jcfg).init(jax.random.PRNGKey(0))
    tparams = bridge.params_from_jax(jax.tree.map(np.asarray, jparams),
                                     tcfg, device="cpu")
    return jcfg, jparams, tcfg, tparams


@pytest.fixture(scope="module")
def setup():
    _, _, tcfg, tparams = _weights()
    return tcfg, tparams


def _requests(cfg, n):
    rng = np.random.default_rng(7)
    return [Request(rid=i, prompt=rng.integers(2, cfg.vocab_size, 8).astype(
        np.int32), max_new_tokens=NEW_TOKENS) for i in range(n)]


def _pp(cfg, params, p, d, **kw):
    return make_backend("pp", cfg, params, num_slots=GROUP * d,
                        max_len=MAX_LEN, t=1, p=p, inflight=d, device="cpu",
                        **kw)


def _serve(backend, requests):
    return Scheduler(backend, clock=VirtualClock()).run(requests)


# ---------------------------------------------------------------------------
# the executed program against pp_schedule_stats
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("d", [1, 2])
def test_executed_instructions_match_closed_form(setup, d):
    cfg, params = setup
    p, rounds = 2, NEW_TOKENS - 1
    sched = Scheduler(_pp(cfg, params, p, d), clock=VirtualClock())
    sched.run(_requests(cfg, GROUP * d))
    q = sched._queue
    assert isinstance(q, DynamicPPQueue)
    st = cm.pp_schedule_stats(p, d, rounds)
    assert q.ticks == st.ticks
    assert tuple(q.busy) == st.stage_forwards
    assert q.idle == [st.ticks - b for b in st.stage_forwards]
    for s in range(p):
        assert sum(1 for i in q.log if isinstance(i, StageForward)
                   and i.stage == s) == st.stage_forwards[s]
    n_send = sum(1 for i in q.log if isinstance(i, BoundarySend))
    n_recv = sum(1 for i in q.log if isinstance(i, BoundaryRecv))
    assert n_send == n_recv == st.boundary_sends // 2
    assert sum(1 for i in q.log if isinstance(i, SampleToken)) == st.samples
    assert sum(1 for i in q.log if isinstance(i, PrefillChunk)) == GROUP * d


@pytest.mark.parametrize("d", [1, 2])
def test_round_transfers_match_closed_form(setup, d):
    cfg, params = setup
    p, rounds = 2, NEW_TOKENS - 1
    backend = _pp(cfg, params, p, d)
    rep = _serve(backend, _requests(cfg, GROUP * d))
    send = [o for o in backend.decode_comm_ops(batch=GROUP)
            if o.collective == "send"]
    want_count = sum(o.count for o in send)
    want_bytes = sum(o.total_msg_bytes for o in send)
    dec = [r for r in rep.steps if r.phase == "decode"]
    assert len(dec) == d * rounds
    for r in dec:
        assert r.measured_transfers == {"count": want_count,
                                        "bytes": want_bytes}
    ops = cm.pp_schedule_ops(cfg, d, rounds, p, t=1, b=4, group=GROUP)
    s_ops = [o for o in ops if o.collective == "send"]
    assert sum(o.count for o in s_ops) == len(dec) * want_count
    assert sum(o.total_msg_bytes for o in s_ops) == len(dec) * want_bytes


def test_occupancy_report_matches_closed_form(setup):
    cfg, params = setup
    p, rounds, waves = 2, NEW_TOKENS - 1, 2
    occ = {d: _serve(_pp(cfg, params, p, d),
                     _requests(cfg, GROUP * p)).occupancy() for d in (1, 2)}
    st1 = cm.pp_schedule_stats(p, 1, rounds)
    st2 = cm.pp_schedule_stats(p, 2, rounds)
    assert occ[1]["ticks"] == waves * st1.ticks
    assert occ[2]["ticks"] == st2.ticks
    assert occ[1]["decode_tokens"] == occ[2]["decode_tokens"] \
        == GROUP * p * rounds
    assert occ[1]["stage_busy_fraction"] == [st1.busy_fraction] * p
    assert occ[2]["stage_busy_fraction"] == [st2.busy_fraction] * p
    ratio = occ[2]["tokens_per_tick"] / occ[1]["tokens_per_tick"]
    assert ratio == pytest.approx(waves * st1.ticks / st2.ticks)


# ---------------------------------------------------------------------------
# streams: depth d == depth 1 == the single-device backend
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
def test_depth_identity(setup, paged):
    cfg, params = setup
    kw = dict(paged=True, page_size=8, num_pages=64) if paged else {}
    got = {d: _serve(_pp(cfg, params, 2, d, **kw),
                     _requests(cfg, 4)).tokens_by_rid() for d in (1, 2)}
    one = make_backend("gspmd", cfg, params, num_slots=2, max_len=MAX_LEN,
                       device="cpu", **kw)
    assert got[1] == got[2] == _serve(one, _requests(cfg, 4)).tokens_by_rid()


def test_depth_identity_pp4(setup):
    cfg, _ = setup
    p, rounds = 4, NEW_TOKENS - 1
    cfg4 = dataclasses.replace(cfg, num_layers=4)
    params4 = port_model(cfg4).init(seed=0, device="cpu")
    got, ticks = {}, {}
    for d in (1, 4):
        rep = _serve(_pp(cfg4, params4, p, d), _requests(cfg4, GROUP * p))
        got[d] = rep.tokens_by_rid()
        ticks[d] = rep.occupancy()["ticks"]
    assert got[1] == got[4]
    assert ticks[1] == p * cm.pp_schedule_stats(p, 1, rounds).ticks
    assert ticks[4] == cm.pp_schedule_stats(p, 4, rounds).ticks


# ---------------------------------------------------------------------------
# the fused queue and the factory
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind,t", [("gspmd", 1), ("tp", 2)])
def test_fused_queue_on_fused_backends(setup, kind, t):
    cfg, params = setup
    backend = make_backend(kind, cfg, params, num_slots=2, max_len=MAX_LEN,
                           t=t, device="cpu")
    q = make_queue(backend)
    assert isinstance(q, FusedQueue)
    assert (q.p, q.depth, q.group_size, q.in_flight) == (1, 1, 2, 0)
    assert q.busy_groups() == set() and q.pending_groups() == set()
    q.begin_round(0, np.zeros(2, np.int32), np.zeros(2, np.int32))
    assert q.pending_groups() == {0} and q.in_flight == 1
    with pytest.raises(RuntimeError):
        q.begin_round(0, np.zeros(2, np.int32), np.zeros(2, np.int32))
    q.abort_all()
    assert q.in_flight == 0 and q.pump() == []
    q.note_prefill(1)
    assert q.log == [PrefillChunk(mb=1)]
    rep = _serve(backend, _requests(cfg, 2))
    for r in rep.steps:
        assert r.stage_busy == [1] and r.stage_idle == [0]
    assert rep.occupancy()["ticks"] == NEW_TOKENS - 1


def test_step_records_carry_wall_and_stage_fields(setup):
    cfg, params = setup
    backend = _pp(cfg, params, 2, 2, paged=True, page_size=8, num_pages=64)
    rep = Scheduler(backend, clock=VirtualClock(),
                    chunk_size=4).run(_requests(cfg, 4))
    dec = [r for r in rep.steps if r.phase == "decode"]
    pre = [r for r in rep.steps if r.phase == "prefill"]
    assert dec and pre
    for r in dec:
        assert r.wall_s > 0.0 and sum(r.stage_busy) > 0
        assert len(r.stage_busy) == len(r.stage_idle) == 2
    for r in pre:
        assert r.wall_s > 0.0 and r.stage_busy is None
        assert r.measured_transfers["count"] == 2      # (p-1)·2 per chunk


def test_make_backend_rejects_bad_inflight_and_cp(setup):
    cfg, params = setup
    with pytest.raises(ValueError, match="inflight"):
        make_backend("gspmd", cfg, params, num_slots=2, inflight=2,
                     device="cpu")
    with pytest.raises(ValueError, match="divide"):
        make_backend("pp", cfg, params, num_slots=3, p=2, inflight=2,
                     device="cpu")
    with pytest.raises(ValueError, match="divide"):
        make_backend("pp", cfg, params, num_slots=2, p=2, inflight=0,
                     device="cpu")
    with pytest.raises(ValueError, match="p >= 2"):
        make_backend("pp", cfg, params, num_slots=2, p=1, device="cpu")
    with pytest.raises(ValueError, match="explicit engines"):
        make_backend("gspmd", cfg, params, num_slots=2, c=2, device="cpu")
    with pytest.raises(ValueError, match="alternative"):
        Scheduler(make_backend("pp", cfg, params, num_slots=2, p=2, c=2,
                               paged=True, device="cpu"), chunk_size=4)
    with pytest.raises(ValueError, match="num_heads"):
        make_backend("pp", cfg, params, num_slots=2, t=3, p=2, c=2,
                     device="cpu")
    with pytest.raises(ValueError, match="t >= 2 or c >= 2"):
        make_backend("tp", cfg, params, num_slots=2, t=1, c=1, device="cpu")
    with pytest.raises(ValueError, match="contiguous decode"):
        make_backend("pp", cfg, params, num_slots=2, p=2, paged=True,
                     quant_collectives="int8", device="cpu")


# ---------------------------------------------------------------------------
# PPBackend through Scheduler against JAX's PPBackend
# ---------------------------------------------------------------------------


def _trace(module, cfg):
    rng = np.random.default_rng(0)
    spec = [(7, 6, 0.0), (12, 4, 0.0), (5, 9, 0.5), (9, 3, 0.5), (11, 5, 2.0)]
    return [module.Request(rid=i, prompt=rng.integers(2, cfg.vocab_size, s),
                           max_new_tokens=n, arrival=a)
            for i, (s, n, a) in enumerate(spec)]


@needs_mesh
@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
@pytest.mark.parametrize("t", [1, 2])
def test_pp_backend_serves_like_jax(t, paged):
    jcfg, jparams, tcfg, tparams = _weights(kv=2)
    kw = dict(paged=True, page_size=4) if paged else {}
    jb = jax_backends.make_backend("pp", jcfg, jparams, num_slots=4,
                                   max_len=32, t=t, p=2, inflight=2, **kw)
    want = jax_scheduler.Scheduler(
        jb, clock=jax_scheduler.VirtualClock()).run(_trace(jax_request, jcfg))
    backend = make_backend("pp", tcfg, tparams, num_slots=4, max_len=32,
                           t=t, p=2, inflight=2, device="cpu", **kw)
    got = Scheduler(backend, clock=VirtualClock()).run(
        _trace(port_request, tcfg))
    assert got.tokens_by_rid() == want.tokens_by_rid()

    def rows(rep):
        return [(r.phase, r.n_active, r.collective_counts,
                 r.measured_transfers, r.stage_busy, r.stage_idle)
                for r in rep.steps]
    assert rows(got) == rows(want)
    assert got.occupancy() == want.occupancy()


def test_quantized_pp_backend_serves_every_request():
    """int8 at (t, p) = (2, 2): every request finishes, and every step's
    stage logs are the quantized hybrid rows."""
    _, _, cfg, params = _weights(kv=2)
    backend = make_backend("pp", cfg, params, num_slots=2, max_len=32, t=2,
                           p=2, quant_collectives="int8", device="cpu")
    report = Scheduler(backend, clock=VirtualClock()).run(
        _trace(port_request, cfg))
    assert [m.num_generated for m in report.metrics] == [6, 4, 9, 3, 5]
    n_dec = sum(1 for r in report.steps if r.phase == "decode")
    for s, m in enumerate(backend.engine.stages):
        kinds = {}
        for rec in m.group.log:
            if rec.phase == "decode":
                kinds[rec.kind] = kinds.get(rec.kind, 0) + 1
        want = cm.hybrid_stage_collectives(cfg, 2, 2, s, quant="int8")
        assert kinds == {k: n * n_dec for k, n in want.items()}


# ---------------------------------------------------------------------------
# A10: the SLO model and the planner
# ---------------------------------------------------------------------------

A10_ARCHS = ["llama32-3b", "llama2-13b", "mixtral-8x22b"]


def _asdict(x):
    return dataclasses.asdict(x)


@pytest.mark.parametrize("arch", A10_ARCHS)
def test_predict_slo_matches_reference(arch):
    jcfg, tcfg = jax_config(arch), port_config(arch)
    for t, c, p in [(1, 1, 1), (2, 1, 1), (4, 1, 1), (8, 1, 1), (1, 1, 4),
                    (2, 1, 4), (4, 1, 2), (1, 2, 2), (2, 2, 2)]:
        for kw in ({}, dict(inflight=4), dict(quant="int8"),
                   dict(batch=4, hit_rate=0.5, hit_len=64)):
            if kw.get("quant") and t == 1:
                continue
            got = slo.predict_slo(tcfg, 512, 128, t=t, p=p, c=c, **kw)
            want = jax_slo.predict_slo(jcfg, 512, 128, t=t, p=p, c=c, **kw)
            assert _asdict(got) == _asdict(want), (t, c, p, kw)
    got = slo.predict_goodput(tcfg, 64, 64, num_slots=8,
                              capacity_tokens=2048, t=1, p=4, inflight=4)
    want = jax_slo.predict_goodput(jcfg, 64, 64, num_slots=8,
                                   capacity_tokens=2048, t=1, p=4,
                                   inflight=4)
    assert _asdict(got) == _asdict(want)


@pytest.mark.parametrize("arch", A10_ARCHS)
def test_plan_matches_reference(arch):
    jcfg, tcfg = jax_config(arch), port_config(arch)
    for world in (4, 8):
        assert planner.feasible_layouts(tcfg, world) == \
            jax_planner.feasible_layouts(jcfg, world)
        for obj in ("e2e", "ttft", "tpot"):
            for kw in ({}, dict(inflight=4)):
                got = planner.plan(tcfg, world, 256, 64, objective=obj, **kw)
                want = jax_planner.plan(jcfg, world, 256, 64, objective=obj,
                                        **kw)
                assert [_asdict(c) for c in got] == \
                    [_asdict(c) for c in want], (world, obj, kw)


def test_plan_disagg_matches_reference():
    for arch in ("llama32-3b", "llama2-13b"):
        jcfg, tcfg = jax_config(arch), port_config(arch)
        mix = [("chat", 128, 256, 2.0), ("summ", 2048, 64, 0.5)]
        for obj in ("e2e", "tpot"):
            got = planner.plan_disagg(
                tcfg, 8, [planner.TrafficClass(*c) for c in mix],
                objective=obj)
            want = jax_planner.plan_disagg(
                jcfg, 8, [jax_planner.TrafficClass(*c) for c in mix],
                objective=obj)
            assert [_asdict(c) for c in got] == [_asdict(c) for c in want]


def test_predict_slo_occupancy_term():
    cfg = port_config("llama32-3b").reduced(num_layers=2)
    base = slo.predict_slo(cfg, 8, 4, t=1, p=4)
    deep = slo.predict_slo(cfg, 8, 4, t=1, p=4, inflight=4)
    assert base.occupancy == 0.25 and deep.occupancy == 1.0
    assert deep.breakdown["tpot_effective"] == deep.tpot / 4
    assert deep.e2e < base.e2e
    for c in planner.plan(cfg, 4, 64, 16, objective="tpot"):
        assert c.occupancy == (1.0 if c.pipeline_parallel == 1
                               else 1 / c.pipeline_parallel)
