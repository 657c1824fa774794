"""The PyTorch port's serving layer against the JAX package.

A ragged trace (mixed prompt lengths, decode budgets and arrivals, on a
virtual clock) goes through the JAX ``Scheduler`` and through the port's,
over equal weights (reduced llama32-3b, float32, carried across through
numpy): the token streams and every ``StepRecord``'s phase, active count
and predicted collective counts must be identical — contiguous slots,
KV pages, and KV pages with chunked prefill.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.core import commodel as jax_cm  # noqa: E402
from repro.models.transformer import get_model as jax_model  # noqa: E402
from repro.runtime import backends as jax_backends  # noqa: E402
from repro.runtime import request as jax_request  # noqa: E402
from repro.runtime import scheduler as jax_scheduler  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config as port_config  # noqa: E402
from repro_torch.core import commodel as port_cm  # noqa: E402
from repro_torch.runtime import request as port_request  # noqa: E402
from repro_torch.runtime import scheduler as port_scheduler  # noqa: E402
from repro_torch.runtime.backends import make_backend  # noqa: E402
from repro_torch.runtime.kvpool import KVPool  # noqa: E402

MAX_LEN = 48
MODES = {"contiguous": (dict(), None),
         "paged": (dict(paged=True, page_size=4), None),
         "paged-chunked": (dict(paged=True, page_size=4), 5)}


@pytest.fixture(scope="module")
def weights():
    jcfg = dataclasses.replace(jax_config("llama32-3b").reduced(),
                               num_kv_heads=2)
    tcfg = dataclasses.replace(port_config("llama32-3b").reduced(),
                               num_kv_heads=2)
    jparams = jax_model(jcfg).init(jax.random.PRNGKey(0))
    tparams = bridge.params_from_jax(jax.tree.map(np.asarray, jparams),
                                     tcfg, device="cpu")
    return jcfg, jparams, tcfg, tparams


def _trace(module, cfg):
    """Ragged: 5 requests on 2 slots, staggered arrivals (queueing,
    mid-decode admission, eviction, an emulated early EOS)."""
    rng = np.random.default_rng(0)
    spec = [(7, 6, 0.0, None), (12, 4, 0.0, None), (5, 9, 0.5, 3),
            (9, 3, 0.5, None), (11, 5, 2.0, None)]
    return [module.Request(rid=i, prompt=rng.integers(2, cfg.vocab_size, s),
                           max_new_tokens=n, arrival=a, eos_pos=eos)
            for i, (s, n, a, eos) in enumerate(spec)]


def _summary(report):
    steps = [(r.phase, r.n_active, r.collective_counts, r.rid,
              r.predicted_wire_bytes) for r in report.steps]
    return report.tokens_by_rid(), steps, \
        [m.finish_reason for m in report.metrics]


@pytest.mark.parametrize("mode", list(MODES))
def test_ragged_trace_equals_jax_scheduler(weights, mode):
    jcfg, jparams, tcfg, tparams = weights
    kw, chunk = MODES[mode]
    jb = jax_backends.make_backend("gspmd", jcfg, jparams, num_slots=2,
                                   max_len=MAX_LEN, **kw)
    want = jax_scheduler.Scheduler(
        jb, clock=jax_scheduler.VirtualClock(), chunk_size=chunk).run(
        _trace(jax_request, jcfg))
    tb = make_backend("gspmd", tcfg, tparams, num_slots=2, max_len=MAX_LEN,
                      device="cpu", **kw)
    got = port_scheduler.Scheduler(
        tb, clock=port_scheduler.VirtualClock(), chunk_size=chunk).run(
        _trace(port_request, tcfg))
    assert _summary(got) == _summary(want)
    assert got.total_tokens == want.total_tokens
    if chunk:
        assert any(r.phase == "prefill" for r in got.steps)


def test_paged_serving_equals_contiguous_and_frees_pages(weights):
    _, _, tcfg, tparams = weights
    reports = []
    for kw in (dict(), dict(paged=True, page_size=4)):
        backend = make_backend("gspmd", tcfg, tparams, num_slots=2,
                               max_len=MAX_LEN, device="cpu", **kw)
        reports.append(port_scheduler.Scheduler(
            backend, clock=port_scheduler.VirtualClock()).run(
            _trace(port_request, tcfg)))
    assert reports[0].tokens_by_rid() == reports[1].tokens_by_rid()
    assert backend.pool.free_pages == backend.pool.num_pages - 1


@pytest.mark.parametrize("arch", ["llama32-3b", "granite-8b", "llama2-13b"])
@pytest.mark.parametrize("t,p", [(1, 1), (2, 1), (1, 2), (4, 2)])
def test_commodel_copy_agrees(arch, t, p):
    jcfg, tcfg = jax_config(arch), port_config(arch)
    for s_p, s_d in ((128, 32), (1, 2)):
        a = jax_cm.comm_ops_for(jcfg, s_p, s_d, t, p)
        b = port_cm.comm_ops_for(tcfg, s_p, s_d, t, p)
        assert [dataclasses.asdict(o) for o in a] == \
            [dataclasses.asdict(o) for o in b]
    a = jax_cm.chunked_prefill_ops(jcfg, 300, 64, t, p)
    b = port_cm.chunked_prefill_ops(tcfg, 300, 64, t, p)
    assert [dataclasses.asdict(o) for o in a] == \
        [dataclasses.asdict(o) for o in b]


def test_poisson_trace_copy_agrees():
    kw = dict(prompt_lens=(64, 512), decode_lens=(16, 64), seed=0,
              quantum=32)
    a = jax_request.make_poisson_trace(8, 0, 128256, **kw)
    b = port_request.make_poisson_trace(8, 0, 128256, **kw)
    assert [(r.rid, r.max_new_tokens, r.arrival, r.prompt.tolist())
            for r in a] == [(r.rid, r.max_new_tokens, r.arrival,
                             r.prompt.tolist()) for r in b]


def test_step_counts_batch_invariant(weights):
    jcfg, jparams, tcfg, tparams = weights
    backend = make_backend("gspmd", tcfg, tparams, num_slots=3,
                           max_len=MAX_LEN, device="cpu")
    port_scheduler.assert_counts_batch_invariant(backend)
    jb = jax_backends.make_backend("gspmd", jcfg, jparams, num_slots=3,
                                   max_len=MAX_LEN)
    assert port_scheduler.step_collective_counts(backend) == \
        jax_scheduler.step_collective_counts(jb)


def test_pool_exhaustion_queues_instead_of_failing(weights):
    """A pool smaller than the trace's demand: conservative admission keeps
    requests queued until pages free up, and every one finishes."""
    _, _, tcfg, tparams = weights
    backend = make_backend("gspmd", tcfg, tparams, num_slots=2,
                           max_len=MAX_LEN, paged=True, page_size=4,
                           num_pages=6, device="cpu")
    reqs = _trace(port_request, tcfg)[:3]
    report = port_scheduler.Scheduler(
        backend, clock=port_scheduler.VirtualClock(), chunk_size=4).run(reqs)
    assert [m.num_generated for m in report.metrics] == [6, 4, 3]
    with pytest.raises(ValueError, match="pool capacity"):
        port_scheduler.Scheduler(backend).submit(port_request.Request(
            rid=9, prompt=np.arange(2, 40), max_new_tokens=2))


@pytest.mark.parametrize("make", [
    lambda b: port_scheduler.Scheduler(
        make_backend("gspmd", *b, num_slots=2, device="cpu", paged=True),
        admission="optimistic"),
    lambda b: port_scheduler.Scheduler(
        make_backend("gspmd", *b, num_slots=2, device="cpu"), faults=object()),
    lambda b: port_scheduler.DisaggScheduler(None, None),
], ids=["optimistic", "faults", "disagg"])
def test_later_items_raise_with_their_roadmap_item(weights, make):
    _, _, tcfg, tparams = weights
    with pytest.raises(NotImplementedError, match=r"A\d"):
        make((tcfg, tparams))


@pytest.mark.parametrize("make,match", [
    (lambda b: make_backend("tp", *b, num_slots=2, t=2, c=2, paged=True,
                            device="cpu"), None),
    (lambda b: port_scheduler.Scheduler(
        make_backend("tp", *b, num_slots=2, t=2, c=2, paged=True,
                     device="cpu"), chunk_size=4), "alternative"),
    (lambda b: make_backend("pp", *b, num_slots=2, p=2, c=2, device="cpu"),
     None),
    (lambda b: make_backend("pp", *b, num_slots=2, t=3, p=2, c=2,
                            device="cpu"), "num_heads"),
], ids=["tp", "tp-chunked", "pp", "pp-t3"])
def test_context_parallel_backends_and_what_they_refuse(weights, make,
                                                       match):
    """c > 1 backends construct; chunked prefill on them and TP degrees
    that do not divide the heads are refused."""
    _, _, tcfg, tparams = weights
    if match is None:
        assert make((tcfg, tparams)).c == 2
        return
    with pytest.raises(ValueError, match=match):
        make((tcfg, tparams))


def test_kvpool_copy_behaves_like_the_reference():
    from repro.runtime.kvpool import KVPool as JaxPool
    ops = [("allocate", 0, 9), ("allocate", 1, 4), ("extend", 0, 13),
           ("free", 1), ("allocate", 2, 17), ("extend", 2, 20)]
    pools = [KVPool(12, 4), JaxPool(12, 4)]
    for op in ops:
        for pool in pools:
            getattr(pool, op[0])(*op[1:])
        tables = [{o: pool.block_table(o) for o in pool.owners()}
                  for pool in pools]
        assert tables[0] == tables[1]
        assert pools[0].free_pages == pools[1].free_pages
