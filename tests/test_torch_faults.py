"""The port's failure semantics (optimistic admission, preemption by
recompute, faults, deadlines, cancellation) against the JAX package.

Reduced llama32-3b in float32 (2 layers, max_len 64, page 4), weights from
the JAX package's ``Model.init`` through numpy.  Every scenario runs the
same trace, on a virtual clock, through JAX's ``Scheduler`` and the
port's, on the paged gspmd, tp t = 2 and pp (1, 2) backends (one backend
per package and layout, reused across scenarios, so each drains to zero
leaked pages between them).  Held equal: every request's tokens, finish
reason, preemptions, retries and virtual-clock stamps, and every
``StepRecord``'s phase, rid, prefix lengths, predicted collectives and
measured transfers; the recompute records also against
``commodel.preemption_recompute_ops``.  Survivors of every fault schedule
equal the fault-free streams.
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
SLOTS, PAGES = 3, 10       # 9 usable pages: the trace's worst case is 17
LAYOUTS = [
    pytest.param("gspmd", 1, 1, id="t1p1"),
    pytest.param("tp", 2, 1, marks=needs_mesh, id="t2p1"),
    pytest.param("pp", 1, 2, marks=needs_mesh, id="t1p2"),
]
LENS = [(7, 10), (11, 8), (5, 12), (9, 6)]


@pytest.fixture(scope="module")
def sides():
    """(JAX, port): each package's serving API, weights and a cache of
    backends by layout."""
    jcfg = jax_config("llama32-3b").reduced(num_layers=2)
    tcfg = port_config("llama32-3b").reduced(num_layers=2)
    jparams = jax_model(jcfg).init(jax.random.PRNGKey(0))
    tparams = bridge.params_from_jax(jax.tree.map(np.asarray, jparams),
                                     tcfg, device="cpu")

    def side(cfg, params, backends, scheduler, request, faults, kw):
        return types.SimpleNamespace(
            cfg=cfg, params=params, make_backend=backends.make_backend,
            Scheduler=scheduler.Scheduler, Clock=scheduler.VirtualClock,
            Request=request.Request, Fault=faults.Fault,
            Injector=faults.FaultInjector, kw=kw, cache={})
    return (side(jcfg, jparams, jax_backends, jax_scheduler, jax_request,
                 jax_faults, {}),
            side(tcfg, tparams, port_backends, port_scheduler, port_request,
                 port_faults, dict(device="cpu")))


@pytest.fixture(scope="module")
def solo(sides):
    """Each request of the trace served alone on the port's engine."""
    port = sides[1]
    eng = InferenceEngine(port.cfg, port.params, max_len=MAX_LEN,
                          decode_chunk=1, device="cpu")
    return {r.rid: eng.generate(torch.from_numpy(r.prompt)[None],
                                max_new_tokens=r.max_new_tokens)[0].tolist()
            for r in _requests(port)}


def _backend(S, kind, t, p):
    key = (kind, t, p)
    if key not in S.cache:
        kw = dict(t=t) if kind == "tp" else dict(t=t, p=p) \
            if kind == "pp" else {}
        S.cache[key] = S.make_backend(kind, S.cfg, S.params, num_slots=SLOTS,
                                      max_len=MAX_LEN, paged=True,
                                      page_size=PAGE, num_pages=PAGES,
                                      **kw, **S.kw)
    return S.cache[key]


def _requests(S, lens=LENS):
    rng = np.random.default_rng(0)
    return [S.Request(rid=i, prompt=rng.integers(2, S.cfg.vocab_size,
                                                 s).astype(np.int32),
                      max_new_tokens=n) for i, (s, n) in enumerate(lens)]


def _summary(report):
    metrics = [(m.rid, [int(x) for x in m.tokens], m.finish_reason,
                m.preemptions, m.retries, m.cached_prefix_len, m.admitted,
                m.first_token, m.finished) for m in report.metrics]
    steps = [(r.phase, r.rid, r.n_active, r.prefix_len, r.cached_prefix_len,
              r.collective_counts, r.predicted_wire_bytes,
              dict(r.measured_transfers)) for r in report.steps]
    return metrics, steps


def _drained(backend):
    pool = backend.pool
    assert pool.stats().used_tokens == 0
    assert pool.free_pages == pool.num_pages - 1
    assert not pool.owners()


def _both(sides, run):
    """Run ``run(S)`` on each package; return the port's (report, backend)
    after holding its summary to JAX's."""
    out = [run(S) for S in sides]
    assert _summary(out[1][0]) == _summary(out[0][0])
    for _, backend in out:
        _drained(backend)
    return out[1]


def _plan(S, plan):
    return S.Injector.scripted({(site, i): S.Fault(site, kind, **kw)
                                for (site, i), (kind, kw) in plan.items()})


# ---------------------------------------------------------------------------
# the injector
# ---------------------------------------------------------------------------


def _draws(make, sites, n):
    inj = make()
    got = [(site, inj.draw(site)) for _ in range(n) for site in sites]
    return [(s, None if f is None else (f.site, f.kind, f.delay_s))
            for s, f in got], [(s, i, f.kind, f.delay_s)
                               for s, i, f in inj.injected]


@pytest.mark.parametrize("seed", [0, 7, 2**31 - 1])
def test_injector_schedules_equal_reference(seed):
    sites = port_faults.SITES
    assert sites == jax_faults.SITES
    rates = {"decode": 0.3, "prefill": 0.2, "pool": 0.25,
             "pp_transfer": 0.4, "handoff": 0.35}
    for kw in (dict(), dict(transient_frac=0.5, delay_frac=0.3,
                            delay_s=0.2, max_faults=None)):
        want = _draws(lambda: jax_faults.FaultInjector(seed, rates, **kw),
                      sites, 60)
        got = _draws(lambda: port_faults.FaultInjector(seed, rates, **kw),
                     sites, 60)
        assert got == want and want[1]
    # a site's schedule does not move when another site draws more
    a = port_faults.FaultInjector(seed, {"decode": 0.4}, max_faults=None)
    b = port_faults.FaultInjector(seed, {"decode": 0.4}, max_faults=None)
    for _ in range(100):
        b.draw("prefill")
    assert [a.draw("decode") for _ in range(30)] == \
        [b.draw("decode") for _ in range(30)]


def test_scripted_injector_and_validation_equal_reference():
    plan = {("decode", 3): ("transient", {}), ("pool", 0): ("oom", {}),
            ("pp_transfer", 2): ("delay", dict(delay_s=0.25)),
            ("handoff", 1): ("permanent", {})}
    runs = []
    for mod in (jax_faults, port_faults):
        inj = mod.FaultInjector.scripted({
            k: mod.Fault(k[0], kind, **kw) for k, (kind, kw) in plan.items()})
        runs.append(_draws(lambda: inj, mod.SITES, 6))
    assert runs[0] == runs[1]
    bad = [lambda m: m.Fault("nowhere", "transient"),
           lambda m: m.Fault("pool", "transient"),
           lambda m: m.Fault("decode", "delay"),
           lambda m: m.FaultInjector(rates={"bogus": 0.1}),
           lambda m: m.FaultInjector.scripted(
               {("decode", 0): m.Fault("prefill", "transient")}),
           lambda m: m.FaultInjector().draw("nowhere")]
    for make in bad:
        for mod in (jax_faults, port_faults):
            with pytest.raises(ValueError):
                make(mod)


# ---------------------------------------------------------------------------
# optimistic admission and preemption by recompute
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind,t,p", LAYOUTS)
def test_optimistic_preemption_matches_reference(sides, solo, kind, t, p):
    """An oversubscribed pool under optimistic admission preempts; every
    stream equals the solo run and JAX's, and each recompute record
    carries ``preemption_recompute_ops`` (and on pp the predicted hops)."""
    def run(S):
        backend = _backend(S, kind, t, p)
        return S.Scheduler(backend, clock=S.Clock(),
                           admission="optimistic").run(_requests(S)), backend
    report, backend = _both(sides, run)
    assert report.preemptions > 0
    assert report.tokens_by_rid() == solo
    recs = [r for r in report.steps if r.phase == "recompute"]
    assert len(recs) == report.preemptions
    cfg = sides[1].cfg
    for rec in recs:
        ops = cm.preemption_recompute_ops(cfg, rec.prefix_len, t, p, b=4,
                                          gather_mode="allgather")
        assert rec.collective_counts == port_scheduler._count(ops)
        if p > 1:
            send = [o for o in ops if o.collective == "send"][0]
            assert rec.measured_transfers == {
                "count": send.count, "bytes": send.total_msg_bytes}


@needs_mesh
def test_cp_recompute_rows_like_reference(sides, solo):
    """On a context-parallel backend (t = 1, c = 2) a recompute is a CP
    pass of the prefix: its rows carry the ring rows of
    ``preemption_recompute_ops(c=2)``; streams and records equal JAX's
    (the port's own phase "prefill" records of whole CP prefills left
    aside: the reference keeps none)."""
    out = []
    for S in sides:
        backend = S.make_backend("tp", S.cfg, S.params, num_slots=SLOTS,
                                 max_len=MAX_LEN, paged=True, page_size=PAGE,
                                 num_pages=PAGES, t=1, c=2, **S.kw)
        report = S.Scheduler(backend, clock=S.Clock(),
                             admission="optimistic").run(_requests(S))
        _drained(backend)
        metrics, steps = _summary(report)
        out.append((metrics, [r for r in steps if r[0] != "prefill"],
                    report))
    assert out[1][:2] == out[0][:2]
    report = out[1][2]
    assert report.preemptions > 0 and report.tokens_by_rid() == solo
    cfg = sides[1].cfg
    recs = [r for r in report.steps if r.phase == "recompute"]
    assert len(recs) == report.preemptions
    for rec in recs:
        ops = cm.preemption_recompute_ops(cfg, rec.prefix_len, 1, 1, c=2,
                                          b=4, gather_mode="allgather")
        # the ring: 2L(c - 1) collective-permutes, one CP all-reduce
        assert rec.collective_counts == port_scheduler._count(ops) == \
            {"collectivepermute": 2 * cfg.num_layers, "allreduce": 1}
    assert len([r for r in report.steps if r.phase == "prefill"]) == \
        len(LENS)


def test_preemption_under_chunked_prefill_matches_reference(sides, solo):
    """Recompute prefixes re-prefill in chunks, each logged as a
    "recompute" record; the stream stays the solo run's."""
    def run(S):
        backend = _backend(S, "gspmd", 1, 1)
        return S.Scheduler(backend, clock=S.Clock(), chunk_size=4,
                           admission="optimistic").run(_requests(S)), backend
    report, _ = _both(sides, run)
    assert report.preemptions > 0 and report.tokens_by_rid() == solo
    groups = {}
    for r in report.steps:
        if r.phase == "recompute":
            groups[(r.rid, r.prefix_len)] = \
                groups.get((r.rid, r.prefix_len), 0) + 1
    assert groups and all(n % -(-plen // 4) == 0
                          for (_, plen), n in groups.items())


# ---------------------------------------------------------------------------
# scripted faults
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind,t,p", LAYOUTS)
def test_transient_faults_retry_like_reference(sides, solo, kind, t, p):
    """Transient decode and prefill faults, an injected pool exhaustion,
    and on pp a delayed and a failed boundary hop: retried with backoff on
    the virtual clock, one preemption, streams the fault-free ones."""
    plan = {("decode", 2): ("transient", {}), ("decode", 5): ("transient", {}),
            ("prefill", 1): ("transient", {}), ("pool", 3): ("oom", {}),
            ("pp_transfer", 1): ("delay", dict(delay_s=0.25)),
            ("pp_transfer", 4): ("transient", {})}

    def run(S):
        backend = _backend(S, kind, t, p)
        return S.Scheduler(backend, clock=S.Clock(), faults=_plan(S, plan),
                           retry_backoff=0.1).run(_requests(S)), backend
    report, _ = _both(sides, run)
    assert report.tokens_by_rid() == solo
    assert report.preemptions == 1
    assert report.retries >= 3 + (p > 1)
    # three 0.1 s backoffs, and on pp the 0.25 s hop delay
    assert max(m.finished for m in report.metrics) >= \
        0.3 - 1e-9 + 0.25 * (p > 1)


@pytest.mark.parametrize("kind,t,p", LAYOUTS)
@pytest.mark.parametrize("case", ["prefill-permanent", "decode-permanent",
                                  "decode-exhausted", "prefill-exhausted"])
def test_permanent_and_exhausted_faults_like_reference(sides, solo, kind, t,
                                                       p, case):
    """A permanent prefill fault errors one request; a permanent decode
    fault, or retries past ``retry_limit``, errors the active set; the
    others finish with their fault-free streams; nothing leaks."""
    site, how = case.split("-")
    if how == "permanent":
        plan = {(site, 1): ("permanent", {})}
    else:
        plan = {(site, i): ("transient", {}) for i in range(1, 12)}

    def run(S):
        backend = _backend(S, kind, t, p)
        return S.Scheduler(backend, clock=S.Clock(), faults=_plan(S, plan),
                           retry_limit=2).run(_requests(S)), backend
    report, _ = _both(sides, run)
    dead = [m for m in report.metrics if m.finish_reason == "error"]
    assert dead
    for m in report.metrics:
        if m.finish_reason == "length":
            assert m.tokens == solo[m.rid]
        else:
            assert m.tokens == solo[m.rid][:m.num_generated]
    if how == "exhausted" and site == "decode":
        assert all(m.retries == 2 for m in dead)


# ---------------------------------------------------------------------------
# deadlines and cancellation
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind,t,p", LAYOUTS)
def test_deadlines_shed_like_reference(sides, solo, kind, t, p):
    """A TTFT deadline sheds a queued request with no tokens; a total
    deadline sheds an active one keeping its exact partial stream."""
    def run(S):
        reqs = _requests(S)
        reqs[0].deadline = 0.5               # active when it expires
        reqs[3].ttft_deadline = 0.5          # queued when it expires
        backend = _backend(S, kind, t, p)
        clock = S.Clock()
        sched = S.Scheduler(backend, clock=clock)
        sched.submit(reqs)
        for _ in range(3):
            sched.step()
        clock.advance(1.0)
        return sched.run(), backend
    report, _ = _both(sides, run)
    by = {m.rid: m for m in report.metrics}
    assert by[3].finish_reason == "deadline" and by[3].num_generated == 0
    assert by[0].finish_reason == "deadline"
    assert 0 < by[0].num_generated < 10
    assert by[0].tokens == solo[0][:by[0].num_generated]
    for rid in (1, 2):
        assert by[rid].finish_reason == "length" and by[rid].tokens == \
            solo[rid]


@pytest.mark.parametrize("kind,t,p", LAYOUTS)
def test_cancel_at_every_stage_like_reference(sides, solo, kind, t, p):
    """``cancel`` of a queued, a mid-prefill (chunked) and a decoding
    request, an unknown rid and a finished one."""
    calls = []

    def run(S):
        backend = _backend(S, kind, t, p)
        sched = S.Scheduler(backend, clock=S.Clock(), chunk_size=4)
        sched.submit(_requests(S, LENS + [(6, 3)]))
        sched.step()                 # rid 0 prefilling, 1-4 queued
        got = [sched.cancel(4)]      # queued
        for _ in range(2):
            sched.step()
        got.append(sched.cancel(1))  # mid-prefill
        for _ in range(4):
            sched.step()
        got += [sched.cancel(0), sched.cancel(42)]   # decoding, unknown
        report = sched.run()
        got.append(sched.cancel(0))  # finished
        calls.append(got)
        return report, backend
    report, _ = _both(sides, run)
    assert calls[0] == calls[1] == [True, True, True, False, False]
    by = {m.rid: m for m in report.metrics}
    assert by[4].finish_reason == by[1].finish_reason == "cancelled"
    assert by[4].num_generated == by[1].num_generated == 0
    assert by[0].finish_reason == "cancelled"
    assert by[0].tokens == solo[0][:by[0].num_generated]
    assert by[2].tokens == solo[2] and by[3].tokens == solo[3]


def test_guards_raise_like_reference(sides):
    for S in sides:
        contiguous = S.make_backend("gspmd", S.cfg, S.params, num_slots=1,
                                    max_len=MAX_LEN, **S.kw)
        with pytest.raises(ValueError, match="paged"):
            S.Scheduler(contiguous, clock=S.Clock(), admission="optimistic")
        with pytest.raises(ValueError, match="admission"):
            S.Scheduler(contiguous, clock=S.Clock(), admission="yolo")
        with pytest.raises(ValueError, match="retry_limit"):
            S.Scheduler(contiguous, clock=S.Clock(), retry_limit=-1)


# ---------------------------------------------------------------------------
# a seeded chaos run
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [3, 11, 2024])
def test_seeded_chaos_like_reference(sides, solo, seed):
    """A seeded fault schedule over every decode-side site under
    optimistic admission: both packages absorb the same faults, the
    survivors equal the fault-free streams, and nothing leaks."""
    injectors = []

    def run(S):
        inj = S.Injector(seed=seed, rates={"decode": 0.05, "prefill": 0.05,
                                           "pool": 0.10},
                         transient_frac=0.7, max_faults=16)
        injectors.append(inj)
        backend = _backend(S, "gspmd", 1, 1)
        return S.Scheduler(backend, clock=S.Clock(), admission="optimistic",
                           faults=inj, retry_backoff=1e-4).run(
            _requests(S)), backend
    report, _ = _both(sides, run)
    assert [(s, i, f.kind) for s, i, f in injectors[0].injected] == \
        [(s, i, f.kind) for s, i, f in injectors[1].injected]
    for m in report.metrics:
        if m.finish_reason in ("length", "eos"):
            assert m.tokens == solo[m.rid]
        else:
            assert m.finish_reason == "error"


def test_serving_report_summary_matches_reference(sides):
    """``summary()`` carries preemptions, retries and shed counts."""
    def run(S):
        backend = _backend(S, "gspmd", 1, 1)
        plan = {("decode", 2): ("transient", {}), ("pool", 3): ("oom", {})}
        return S.Scheduler(backend, clock=S.Clock(),
                           faults=_plan(S, plan)).run(_requests(S)), backend
    reports = [run(S)[0] for S in sides]
    a, b = (r.summary() for r in reports)
    assert a == b and b["preemptions"] == 1 and b["retries"] >= 1
