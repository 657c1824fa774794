"""The port's disaggregated prefill/decode pools (``DisaggScheduler``, the
KV-page handoff) against the JAX package.

Reduced llama32-3b in float32 (2 layers, max_len 64, page 4), weights from
the JAX package's ``Model.init`` through numpy.  A decode pool (paged,
prefix-cached) and a prefill pool share one ``KVPool`` under disjoint
owner ranges; prompts of 8+ tokens prefill on the prefill pool and ship
their full blocks to the decode pool.

* ``export_page`` / ``import_page`` round trip bitwise with bytes equal to
  ``kv_page_bytes``, on gspmd, tp t = 2 and pp (1, 2) — JAX's tp2 import
  fails under JAX 0.9 (a ``ShardingTypeError`` in its ``_write_page``), the
  port's does not — and the exported rows equal JAX's f32 export;
* streams equal JAX's gspmd-gspmd streams (JAX's own test holds those to
  solo runs), the port's solo runs and the port's colocated runs, with the
  port's pools on gspmd and on tp t = 2;
* the handoff records (pages, bytes, predicted bytes, first tokens) and
  phase "handoff" step records equal JAX's;
* a preemption across the pool boundary recomputes warm, and the deadline
  shed, faults on both sides, cancellation and the constructor guards
  behave as in JAX; the shared pool drains to zero leaked pages.
"""
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.models.transformer import get_model as jax_model  # noqa: E402
from repro.runtime import backends as jax_backends  # noqa: E402
from repro.runtime import faults as jax_faults  # noqa: E402
from repro.runtime import request as jax_request  # noqa: E402
from repro.runtime import scheduler as jax_scheduler  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config as port_config  # noqa: E402
from repro_torch.core import commodel as cm  # noqa: E402
from repro_torch.runtime import backends as port_backends  # noqa: E402
from repro_torch.runtime import faults as port_faults  # noqa: E402
from repro_torch.runtime import request as port_request  # noqa: E402
from repro_torch.runtime import scheduler as port_scheduler  # noqa: E402
from repro_torch.runtime.engine import InferenceEngine  # noqa: E402

needs_mesh = pytest.mark.skipif(len(jax.devices()) < 4,
                                reason="needs 4 host-platform devices")
MAX_LEN = 64
PAGE = 4
ROUTE = 2 * PAGE          # DisaggScheduler's default routing threshold
# (prompt_len, max_new): rids 1, 3 and 5 route to the prefill pool
LENS = [(7, 8), (13, 6), (5, 8), (11, 6), (6, 7), (17, 5)]
B = 4                     # f32 bytes per element
POOLS = [pytest.param("gspmd", {}, id="gspmd"),
         pytest.param("tp", dict(t=2), marks=needs_mesh, id="tp2")]


@pytest.fixture(scope="module")
def sides():
    jcfg = jax_config("llama32-3b").reduced(num_layers=2)
    tcfg = port_config("llama32-3b").reduced(num_layers=2)
    jparams = jax_model(jcfg).init(jax.random.PRNGKey(0))
    tparams = bridge.params_from_jax(jax.tree.map(np.asarray, jparams),
                                     tcfg, device="cpu")

    def side(cfg, params, backends, scheduler, request, faults, kw):
        return types.SimpleNamespace(
            cfg=cfg, params=params, make_backend=backends.make_backend,
            Scheduler=scheduler.Scheduler, Disagg=scheduler.DisaggScheduler,
            Clock=scheduler.VirtualClock, Request=request.Request,
            Fault=faults.Fault, Injector=faults.FaultInjector, kw=kw,
            cache={})
    return (side(jcfg, jparams, jax_backends, jax_scheduler, jax_request,
                 jax_faults, {}),
            side(tcfg, tparams, port_backends, port_scheduler, port_request,
                 port_faults, dict(device="cpu")))


def _requests(S, n=len(LENS)):
    rng = np.random.default_rng(0)
    return [S.Request(rid=i, prompt=rng.integers(2, S.cfg.vocab_size,
                                                 s).astype(np.int32),
                      max_new_tokens=m) for i, (s, m) in enumerate(LENS[:n])]


@pytest.fixture(scope="module")
def solo(sides):
    port = sides[1]
    eng = InferenceEngine(port.cfg, port.params, max_len=MAX_LEN,
                          decode_chunk=1, device="cpu")
    return {r.rid: eng.generate(torch.from_numpy(r.prompt)[None],
                                max_new_tokens=r.max_new_tokens)[0].tolist()
            for r in _requests(port)}


def _pools(S, kind="gspmd", dec_slots=3, **kw):
    """A decode pool and a prefill pool sharing its KVPool, one pair per
    package and layout, reused across tests (each test drains it): the
    JAX side compiles each shape once."""
    key = (kind, dec_slots, tuple(sorted(kw.items())))
    if key not in S.cache:
        S.cache[key] = _new_pools(S, kind, dec_slots, **kw)
    return S.cache[key]


def _new_pools(S, kind, dec_slots, **kw):
    num_pages = 1 + (dec_slots + 1) * (-(-MAX_LEN // PAGE))
    dec = S.make_backend(kind, S.cfg, S.params, num_slots=dec_slots,
                         max_len=MAX_LEN, paged=True, page_size=PAGE,
                         num_pages=num_pages, prefix_cache=True, **kw,
                         **S.kw)
    pre = S.make_backend(kind, S.cfg, S.params, num_slots=1, max_len=MAX_LEN,
                         paged=True, page_size=PAGE, pool=dec.pool,
                         owner_base=dec_slots, **kw, **S.kw)
    return pre, dec


def _plan(S, plan):
    return S.Injector.scripted({(site, i): S.Fault(site, kind)
                                for (site, i), kind in plan.items()})


def _summary(report):
    metrics = [(m.rid, [int(x) for x in m.tokens], m.finish_reason,
                m.preemptions, m.retries, m.cached_prefix_len, m.admitted,
                m.first_token, m.finished) for m in report.metrics]
    steps = [(r.phase, r.rid, r.n_active, r.prefix_len, r.cached_prefix_len,
              r.collective_counts, r.predicted_wire_bytes,
              dict(r.measured_transfers)) for r in report.steps]
    return metrics, steps


def _handoffs(report):
    return [(h.rid, h.pages, h.bytes, h.predicted_bytes, h.queue_s,
             h.prefill_s, h.submitted, h.first_token)
            for h in report.handoffs]


def _drained(dec):
    assert all(o < 0 for o in dec.pool.owners())
    dec.prefix_index.clear()
    assert dec.pool.free_pages == dec.pool.num_pages - 1


# ---------------------------------------------------------------------------
# the page handoff
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind,kw", [
    pytest.param("gspmd", {}, id="gspmd"),
    pytest.param("tp", dict(t=2), marks=needs_mesh, id="tp2"),
    pytest.param("pp", dict(t=1, p=2), marks=needs_mesh, id="pp12")])
def test_export_import_round_trip(sides, kind, kw):
    """A page prefilled on the prefill pool lands bitwise on the decode
    pool (every rank and stage), ``import_page`` counts exactly
    ``kv_page_bytes``, and the exported rows equal JAX's export of the
    same page (and land from JAX's numpy arrays too)."""
    exports = []
    for S in sides:
        pre, dec = _pools(S, kind, **kw)
        prompt = _requests(S)[5].prompt               # 17 = 4 full pages + 1
        pre.begin_prefill(0, len(prompt), 1)
        pre.prefill_whole(0, prompt)
        pages = [int(p) for p in pre.pool.block_table(pre._owner(0))]
        n_full = cm.kv_handoff_pages(len(prompt), PAGE)
        assert n_full == len(pages) - 1 == 4
        exports.append([pre.export_page(pg) for pg in pages[:n_full]])
        if S is sides[1]:
            port_pre, port_dec, port_pages = pre, dec, pages[:n_full]
        else:
            pre.free_slots([0])
    want = cm.kv_page_bytes(sides[1].cfg, PAGE, b=B)
    for pg, data, ref in zip(port_pages, exports[1], exports[0]):
        assert set(data) == {"k", "v"}
        assert tuple(data["k"].shape) == (2, PAGE, 4, sides[1].cfg.head_dim)
        assert port_dec.import_page(pg, data) == want
        back = port_dec.export_page(pg)
        for key in ("k", "v"):
            assert data[key].device.type == "cpu"
            assert torch.equal(back[key], data[key])
            np.testing.assert_allclose(data[key].numpy(), ref[key],
                                       atol=1e-5, rtol=1e-5)
        # JAX's host rows (numpy f32) land as they are
        assert port_dec.import_page(pg, ref) == want
        np.testing.assert_array_equal(port_dec.export_page(pg)["k"].numpy(),
                                      ref["k"])
    port_pre.free_slots([0])


# ---------------------------------------------------------------------------
# disaggregated serving
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_disagg(sides):
    """JAX's gspmd-gspmd disaggregated run and its colocated run."""
    S = sides[0]
    pre, dec = _pools(S)
    rep = S.Disagg(pre, dec, clock=S.Clock(), chunk_size=8).run(_requests(S))
    _drained(dec)
    return rep


@pytest.mark.parametrize("kind,kw", POOLS)
def test_disagg_streams_like_reference(sides, solo, jax_disagg, kind, kw):
    """Disaggregated == JAX's gspmd-gspmd == solo == colocated; each
    handoff's measured bytes are its predicted bytes, pages x
    kv_page_bytes; handed-off requests hit the index."""
    S = sides[1]
    colo = S.make_backend(kind, S.cfg, S.params, num_slots=3,
                          max_len=MAX_LEN, paged=True, page_size=PAGE,
                          prefix_cache=True, **kw, **S.kw)
    rep_colo = S.Scheduler(colo, clock=S.Clock(), chunk_size=8).run(
        _requests(S))
    pre, dec = _pools(S, kind, **kw)
    rep = S.Disagg(pre, dec, clock=S.Clock(), chunk_size=8).run(_requests(S))
    _drained(dec)

    assert rep.tokens_by_rid() == jax_disagg.tokens_by_rid() == solo == \
        rep_colo.tokens_by_rid()
    assert all(m.finish_reason == "length" for m in rep.metrics)
    assert _handoffs(rep) == _handoffs(jax_disagg)
    long_rids = {i for i, (s, _) in enumerate(LENS) if s >= ROUTE}
    assert {h.rid for h in rep.handoffs} == long_rids
    for h in rep.handoffs:
        n = cm.kv_handoff_pages(LENS[h.rid][0], PAGE)
        assert h.pages == n
        assert h.bytes == h.predicted_bytes == \
            n * cm.kv_page_bytes(S.cfg, PAGE, b=B)
    got, want = _summary(rep.decode), _summary(jax_disagg.decode)
    handoff = [s for s in got[1] if s[0] == "handoff"]
    assert handoff == [s for s in want[1] if s[0] == "handoff"]
    assert [m[5] for m in got[0]] == [m[5] for m in want[0]]
    for m in rep.metrics:
        if m.rid in long_rids:
            assert m.prompt_len - m.cached_prefix_len <= PAGE
    if kind == "gspmd":
        assert got == want
    summary = rep.summary()["disagg"]
    assert summary["handoff_bytes"] == summary["predicted_handoff_bytes"]


def test_disagg_preemption_recomputes_warm_like_reference(sides, solo):
    """An injected pool exhaustion preempts a handed-off request in the
    decode pool; its re-admission hits on the pages the prefill pool
    wrote and shipped; as in JAX."""
    reps = []
    for S in sides:
        pre, dec = _pools(S)
        rep = S.Disagg(pre, dec, clock=S.Clock(),
                       faults=_plan(S, {("pool", 6): "oom"})).run(
            _requests(S))
        _drained(dec)
        reps.append(rep)
    assert _summary(reps[1].decode) == _summary(reps[0].decode)
    assert _handoffs(reps[1]) == _handoffs(reps[0])
    rep = reps[1]
    assert rep.tokens_by_rid() == solo and rep.decode.preemptions == 1
    recs = [s for s in rep.decode.steps if s.phase == "recompute"]
    assert len(recs) == 1 and 0 < recs[0].cached_prefix_len < \
        recs[0].prefix_len
    assert LENS[recs[0].rid][0] >= ROUTE


def test_warm_recompute_single_pool_like_reference(sides, solo):
    reps = []
    for S in sides:
        backend = S.make_backend("gspmd", S.cfg, S.params, num_slots=3,
                                 max_len=MAX_LEN, paged=True, page_size=PAGE,
                                 prefix_cache=True, **S.kw)
        reps.append(S.Scheduler(backend, clock=S.Clock(),
                                faults=_plan(S, {("pool", 3): "oom"})).run(
            _requests(S)))
    assert _summary(reps[1]) == _summary(reps[0])
    assert reps[1].tokens_by_rid() == solo and reps[1].preemptions == 1
    warm = [r for r in reps[1].steps
            if r.phase == "recompute" and r.cached_prefix_len]
    assert warm and all(r.cached_prefix_len < r.prefix_len for r in warm)


def test_disagg_deadline_and_cancel_like_reference(sides, solo):
    """A TTFT deadline sheds a request out of the prefill pool's queue,
    and a cancel removes another one from it."""
    reps = []
    for S in sides:
        reqs = _requests(S)
        reqs[1].ttft_deadline = 0.5
        pre, dec = _pools(S)
        clock = S.Clock()
        sched = S.Disagg(pre, dec, clock=clock)
        sched.submit(reqs)
        assert sched.cancel(5) and not sched.cancel(42)
        clock.advance(1.0)
        rep = sched.run()
        _drained(dec)
        reps.append(rep)
    assert _summary(reps[1].decode) == _summary(reps[0].decode)
    by = {m.rid: m for m in reps[1].metrics}
    assert by[1].finish_reason == "deadline" and not by[1].tokens
    assert by[5].finish_reason == "cancelled" and not by[5].tokens
    for rid in (0, 2, 3, 4):
        assert by[rid].finish_reason == "length" and \
            by[rid].tokens == solo[rid]
    assert {h.rid for h in reps[1].handoffs} == {3}


@pytest.mark.parametrize("plan", [
    {("prefill", 0): "transient"},
    {("handoff", 1): "transient", ("handoff", 2): "transient"},
    {("handoff", 1): "permanent"},
    {("prefill", 1): "permanent", ("decode", 3): "transient"},
], ids=["prefill-transient", "handoff-transient", "handoff-permanent",
        "both-sides"])
def test_disagg_faults_like_reference(sides, solo, plan):
    """Faults on both sides of the pool boundary: transient ones retry
    (retries folded into the request's row), a permanent one errors only
    its request; survivors keep their solo streams; as in JAX."""
    reps = []
    for S in sides:
        pre, dec = _pools(S)
        rep = S.Disagg(pre, dec, clock=S.Clock(),
                       faults=_plan(S, plan)).run(_requests(S))
        _drained(dec)
        reps.append(rep)
    assert _summary(reps[1].decode) == _summary(reps[0].decode)
    assert _handoffs(reps[1]) == _handoffs(reps[0])
    for m in reps[1].metrics:
        if m.finish_reason == "length":
            assert m.tokens == solo[m.rid]
        else:
            assert m.finish_reason == "error" and not m.tokens
    if "permanent" not in plan.values():
        assert sum(m.retries for m in reps[1].metrics) >= 1


def test_disagg_constructor_guards_like_reference(sides):
    for S in sides:
        mk = lambda **kw: S.make_backend(  # noqa: E731
            "gspmd", S.cfg, S.params, max_len=MAX_LEN, page_size=PAGE,
            **kw, **S.kw)
        dec = mk(num_slots=2, paged=True, prefix_cache=True)
        lone = mk(num_slots=1, paged=True)
        with pytest.raises(ValueError, match="share ONE KVPool"):
            S.Disagg(lone, dec)
        overlap = mk(num_slots=1, paged=True, pool=dec.pool, owner_base=0)
        with pytest.raises(ValueError, match="disjoint owner ranges"):
            S.Disagg(overlap, dec)
        pre = mk(num_slots=1, paged=True, pool=dec.pool, owner_base=2)
        nocache = mk(num_slots=2, paged=True)
        with pytest.raises(ValueError, match="prefix index"):
            S.Disagg(pre, nocache)
        with pytest.raises(ValueError, match="route_prompt_len"):
            S.Disagg(pre, dec, route_prompt_len=PAGE - 1)
        with pytest.raises(ValueError, match="paged=True"):
            S.Disagg(mk(num_slots=1), dec)
        sched = S.Disagg(pre, dec)
        with pytest.raises(ValueError, match="max_len"):
            sched.submit(S.Request(rid=0, prompt=np.arange(2, 62),
                                   max_new_tokens=20))
        with pytest.raises(ValueError, match="duplicate"):
            sched.submit(S.Request(rid=0, prompt=np.arange(2, 12),
                                   max_new_tokens=2))
