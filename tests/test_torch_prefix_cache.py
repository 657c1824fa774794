"""The port's prefix cache (``runtime/prefix_index.py`` and the cache-aware
backends and scheduler) against the JAX package.

Reduced llama32-3b in float32 (2 layers, max_len 64, page 4), weights from
the JAX package's ``Model.init`` through numpy.  A template of 16 tokens
(4 full pages) is written and indexed by a warm request; hit requests then
adopt its pages and prefill only their suffixes — among them the template
itself, whose hit is capped one position short: its last page is copied
on write and its suffix is ONE token, which takes the paged decode branch
(B4 on the card) instead of B2.  Held to JAX's on gspmd, tp t = 2, pp
(1, 2) and pp (2, 2): the index and pool state after the same operations,
token streams (also to the cold streams and solo runs), cached prefix
lengths, step records, a warm suffix chunk's logits (within 1e-4), the
guards; the privatised page is bitwise its source; every run drains to
zero leaked pages.
"""
import dataclasses
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.models.transformer import get_model as jax_model  # noqa: E402
from repro.runtime import backends as jax_backends  # noqa: E402
from repro.runtime import kvpool as jax_kvpool  # noqa: E402
from repro.runtime import prefix_index as jax_index  # noqa: E402
from repro.runtime import request as jax_request  # noqa: E402
from repro.runtime import scheduler as jax_scheduler  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config as port_config  # noqa: E402
from repro_torch.models import blocks  # noqa: E402
from repro_torch.runtime import backends as port_backends  # noqa: E402
from repro_torch.runtime import kvpool as port_kvpool  # noqa: E402
from repro_torch.runtime import prefix_index as port_index  # noqa: E402
from repro_torch.runtime import request as port_request  # noqa: E402
from repro_torch.runtime import scheduler as port_scheduler  # noqa: E402
from repro_torch.runtime.engine import InferenceEngine  # noqa: E402

needs_mesh = pytest.mark.skipif(len(jax.devices()) < 4,
                                reason="needs 4 host-platform devices")
MAX_LEN = 64
PAGE = 4
TEMPLATE = 16           # 4 full pages
SUF = 5                 # suffix of the first hit request
LAYOUTS = [
    pytest.param("gspmd", 1, 1, id="t1p1"),
    pytest.param("tp", 2, 1, marks=needs_mesh, id="t2p1"),
    pytest.param("pp", 1, 2, marks=needs_mesh, id="t1p2"),
    pytest.param("pp", 2, 2, marks=needs_mesh, id="t2p2"),
]


@pytest.fixture(scope="module")
def sides():
    jcfg = jax_config("llama32-3b").reduced(num_layers=2)
    tcfg = port_config("llama32-3b").reduced(num_layers=2)
    jparams = jax_model(jcfg).init(jax.random.PRNGKey(0))
    tparams = bridge.params_from_jax(jax.tree.map(np.asarray, jparams),
                                     tcfg, device="cpu")

    def side(cfg, params, backends, scheduler, request, kw):
        return types.SimpleNamespace(
            cfg=cfg, params=params, make_backend=backends.make_backend,
            Scheduler=scheduler.Scheduler, Clock=scheduler.VirtualClock,
            Request=request.Request, kw=kw, cache={})
    return (side(jcfg, jparams, jax_backends, jax_scheduler, jax_request, {}),
            side(tcfg, tparams, port_backends, port_scheduler, port_request,
                 dict(device="cpu")))


def _layout(kind, t, p):
    return dict(t=t) if kind == "tp" else dict(t=t, p=p) \
        if kind == "pp" else {}


def _backend(S, kind, t, p, **kw):
    """One backend per package, layout and options, reused across tests
    (each test drains it): the JAX side compiles each shape once."""
    key = (kind, t, p, tuple(sorted(kw.items())))
    if key not in S.cache:
        S.cache[key] = S.make_backend(kind, S.cfg, S.params, num_slots=4,
                                      max_len=MAX_LEN, paged=True,
                                      page_size=PAGE, **_layout(kind, t, p),
                                      **kw, **S.kw)
    return S.cache[key]


def _template(S, n=TEMPLATE, seed=7):
    return np.random.default_rng(seed).integers(
        2, S.cfg.vocab_size, n).astype(np.int32)


def _warm(S):
    suf = np.random.default_rng(8).integers(2, S.cfg.vocab_size,
                                            SUF).astype(np.int32)
    return [S.Request(rid=0, prompt=np.concatenate([_template(S), suf]),
                      max_new_tokens=4)]


def _hits(S):
    """The template with two suffixes (5 and 3 tokens), and the template
    alone: fully covered, hit capped at 15, a one-token suffix."""
    t = _template(S)
    rng = np.random.default_rng(9)
    reqs = []
    for i, (s, n) in enumerate([(SUF, 6), (3, 4)]):
        suf = rng.integers(2, S.cfg.vocab_size, s).astype(np.int32)
        suf[0] = 2 + i
        reqs.append(S.Request(rid=i + 1, prompt=np.concatenate([t, suf]),
                              max_new_tokens=n))
    reqs.append(S.Request(rid=9, prompt=t.copy(), max_new_tokens=4))
    return reqs


@pytest.fixture(scope="module")
def solo(sides):
    port = sides[1]
    eng = InferenceEngine(port.cfg, port.params, max_len=MAX_LEN,
                          decode_chunk=1, device="cpu")
    return {r.rid: eng.generate(torch.from_numpy(r.prompt)[None],
                                max_new_tokens=r.max_new_tokens)[0].tolist()
            for r in _warm(port) + _hits(port)}


def _summary(report):
    metrics = [(m.rid, [int(x) for x in m.tokens], m.finish_reason,
                m.cached_prefix_len, m.preemptions, m.first_token,
                m.finished) for m in report.metrics]
    steps = [(r.phase, r.rid, r.n_active, r.prefix_len, r.cached_prefix_len,
              r.collective_counts, r.predicted_wire_bytes,
              dict(r.measured_transfers)) for r in report.steps]
    return metrics, steps


def _drain(backend):
    backend.prefix_index.clear()
    pool = backend.pool
    assert pool.stats().used_tokens == 0
    assert pool.free_pages == pool.num_pages - 1
    assert not pool.owners()


# ---------------------------------------------------------------------------
# index and pool state, no model
# ---------------------------------------------------------------------------


def _state(pool, index):
    return ({o: list(pool.block_table(o)) for o in sorted(pool.owners())},
            pool.free_pages, dataclasses.asdict(pool.stats()),
            index.stats(), len(index))


def test_index_and_pool_state_equal_reference():
    """The same inserts, lookups (hits, caps, misses, forks), frees,
    adoptions with copy-on-write, evictions, ``evict_for`` and ``clear``
    leave both packages' pool and index in the same state."""
    runs = []
    for kvpool, index in ((jax_kvpool, jax_index),
                          (port_kvpool, port_index)):
        pool = kvpool.KVPool(num_pages=12, page_size=4)
        idx = index.PrefixIndex(pool)
        a = np.arange(100, 112, dtype=np.int32)        # 3 full blocks
        b = np.arange(40, 49, dtype=np.int32)          # 2 blocks + 1
        log = []
        log.append(idx.insert(a, pool.allocate(0, 12)))
        log.append(idx.insert(a, pool.block_table(0)))     # idempotent
        log.append(idx.insert(b, pool.allocate(1, 9)))
        pool.free(0)
        fork = a.copy()
        fork[9] = 999
        for q in (np.concatenate([a, [7]]), a, fork, b[:8], np.arange(9)):
            hit = idx.lookup(q)
            log.append((hit.length, list(hit.pages)))
        hit = idx.lookup(a)                                # capped at 11
        pool.adopt(2, hit.pages, hit.length)
        pool.extend(2, 13)                                 # COW + 1 page
        log.append([(e.src, e.dst) for e in pool.take_cow_events()])
        log.append(_state(pool, idx))
        log.append(idx.evict_one())
        log.append(idx.reclaimable_pages())
        log.append(idx.evict_for(10))
        log.append(_state(pool, idx))
        for o in (1, 2):
            pool.free(o)
        log.append(idx.clear())
        log.append(idx.evict_one())
        log.append(_state(pool, idx))
        small = index.PrefixIndex(kvpool.KVPool(16, 4), max_entries=2)
        small.insert(np.arange(12, dtype=np.int32),
                     small.pool.allocate(0, 12))
        log.append((len(small), small.evictions))
        with pytest.raises(ValueError):
            index.PrefixIndex(pool, max_entries=0)
        runs.append(log)
    assert runs[0] == runs[1]
    lookups = runs[1][3:8]
    assert [n for n, _ in lookups] == [12, 11, 8, 7, 0]
    owners, free = runs[1][-2][:2]
    assert owners == {} and free == 11


def test_admission_counts_reclaimable_and_evicts_like_reference(sides):
    """A pool full of cold cache is not a full pool: ``can_admit`` counts
    the reclaimable pages and the claim guard evicts LRU entries."""
    logs = []
    for S in sides:
        be = S.make_backend("gspmd", S.cfg, S.params, num_slots=2,
                            max_len=MAX_LEN, paged=True, page_size=PAGE,
                            num_pages=7, prefix_cache=True, **S.kw)
        S.Scheduler(be, clock=S.Clock()).run(_warm(S))   # 21 tokens, 6 pages
        log = [len(be.prefix_index), be.pool.free_pages,
               be.prefix_index.reclaimable_pages(), be.can_admit(21, 1),
               be.can_admit(21, 8), be.can_admit(21, 8, optimistic=True),
               be.can_admit(25, 1)]
        be.begin_prefill(0, 21, 1)
        log += [len(be.prefix_index), be.prefix_index.evictions]
        be.free_slots([0])
        _drain(be)
        logs.append(log)
    assert logs[0] == logs[1]
    assert logs[1][:3] == [5, 1, 5] and logs[1][-1] > 0   # 5 full blocks


# ---------------------------------------------------------------------------
# warm serving
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind,t,p,chunk", [
    *[pytest.param(*v.values, None, marks=v.marks, id=f"{v.id}-whole")
      for v in LAYOUTS],
    *[pytest.param(*v.values, 4, marks=v.marks, id=f"{v.id}-chunk4")
      for v in (LAYOUTS[0], LAYOUTS[2])]])
def test_cache_hit_streams_like_reference(sides, solo, kind, t, p, chunk):
    """Warm, then hits: streams, cached prefix lengths and step records
    equal JAX's; warm streams equal the cold ones and the solo runs."""
    out = []
    for S in sides:
        backend = _backend(S, kind, t, p, prefix_cache=True)
        sched = S.Scheduler(backend, clock=S.Clock(), chunk_size=chunk)
        warm = sched.run(_warm(S))
        report = sched.run(_hits(S))
        cows = backend.pool.stats().cow_copies
        _drain(backend)
        out.append((_summary(warm), _summary(report), cows, report))
    assert out[0][:3] == out[1][:3]
    report = out[1][3]
    hits = {m.rid: m.cached_prefix_len for m in report.metrics}
    assert hits == {1: TEMPLATE, 2: TEMPLATE, 9: TEMPLATE - 1}
    assert out[1][2] >= 1
    got = report.tokens_by_rid()
    assert got == {r: solo[r] for r in got}
    port = sides[1]
    cold = port.Scheduler(_backend(port, kind, t, p), clock=port.Clock(),
                          chunk_size=chunk).run(_hits(port))
    assert cold.tokens_by_rid() == got
    if chunk:
        recs = [r for r in report.steps if r.phase == "prefill"]
        assert len([r for r in recs if r.rid == 1]) == -(-SUF // chunk)
        assert [r.cached_prefix_len for r in recs if r.rid == 9] == \
            [TEMPLATE - 1]


def _hit_backends(sides, kind, t, p, prompt_of):
    """Each package's backend after the warm run, with slot 0 admitted
    through the index for ``prompt_of(S)``: (backend, prompt, hit)."""
    out = []
    for S in sides:
        backend = _backend(S, kind, t, p, prefix_cache=True)
        S.Scheduler(backend, clock=S.Clock()).run(_warm(S))
        prompt = prompt_of(S)
        hit = backend.begin_prefill_cached(0, prompt, 4)
        out.append((backend, prompt, hit))
    return out


def _call(backend, tokens, start):
    bt = backend.block_tables[0:1]
    tokens = np.asarray(tokens, np.int32)[None, :]
    pos = np.asarray([start], np.int32)
    if isinstance(backend, port_backends._BackendBase):
        return backend._paged_call(tokens, pos, bt)
    return backend._paged_call(tokens, pos, bt, phase="prefill")


@pytest.mark.parametrize("kind,t,p", LAYOUTS[:3])
@pytest.mark.parametrize("which", ["suffix5", "one-token"])
def test_warm_suffix_logits_like_reference(sides, kind, t, p, which):
    """A warm suffix pass over adopted pages at query offset = hit: its
    logits within 1e-4 of JAX's, and its token the cold pass's."""
    prompt_of = (lambda S: _hits(S)[0].prompt) if which == "suffix5" \
        else (lambda S: _template(S))
    logits = []
    for backend, prompt, hit in _hit_backends(sides, kind, t, p, prompt_of):
        assert hit == (TEMPLATE if which == "suffix5" else TEMPLATE - 1)
        logits.append(np.asarray(_call(backend, prompt[hit:], hit)))
        backend.free_slots([0])
        _drain(backend)
    np.testing.assert_allclose(logits[1], logits[0], atol=1e-4, rtol=1e-4)
    port = sides[1]
    cold = _backend(port, kind, t, p)
    prompt = prompt_of(port)
    cold.begin_prefill(0, len(prompt), 1)
    assert cold.prefill_whole(0, prompt) == int(np.argmax(logits[1][0]))


@pytest.mark.parametrize("kind,t,p", LAYOUTS)
def test_copy_on_write_page_is_bitwise_its_source(sides, kind, t, p):
    """The fully covered template shares its last page partly: admission
    privatises it, and before the suffix pass writes it the copy is
    bitwise the source on every rank and stage."""
    for S in sides[1:]:
        backend = _backend(S, kind, t, p, prefix_cache=True)
        S.Scheduler(backend, clock=S.Clock()).run(_warm(S))
        shared = backend.prefix_index.lookup(_template(S)).pages
        before = backend.pool.stats().cow_copies
        hit = backend.begin_prefill_cached(0, _template(S), 4)
        table = list(backend.pool.block_table(backend._owner(0)))
        assert hit == TEMPLATE - 1
        assert backend.pool.stats().cow_copies == before + 1
        assert table[:-1] == shared[:-1] and table[-1] != shared[-1]
        src, dst = (backend.export_page(pg) for pg in (shared[-1], table[-1]))
        for key in ("k", "v"):
            assert src[key].abs().sum() > 0
            assert torch.equal(src[key], dst[key])
        backend.free_slots([0])
        _drain(backend)


@pytest.mark.parametrize("kind,t,p", LAYOUTS[:3])
def test_one_token_suffix_takes_the_decode_branch(sides, kind, t, p,
                                                  monkeypatch):
    """The one-token suffix runs the paged decode attention (B4 on the
    card) once per layer and rank and no prefill attention; a 5-token
    suffix runs the prefill attention (B2) instead."""
    calls = {"flash": 0, "paged": 0}

    def counted(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped
    monkeypatch.setattr(blocks, "flash_attention",
                        counted("flash", blocks.flash_attention))
    monkeypatch.setattr(blocks, "paged_decode_attention",
                        counted("paged", blocks.paged_decode_attention))
    port = sides[1]
    L = port.cfg.num_layers
    for prompt, want in ((_template(port), {"flash": 0, "paged": L * t}),
                         (_hits(port)[0].prompt,
                          {"flash": L * t, "paged": 0})):
        backend = _backend(port, kind, t, p, prefix_cache=True)
        port.Scheduler(backend, clock=port.Clock()).run(_warm(port))
        hit = backend.begin_prefill_cached(0, prompt, 4)
        calls.update(flash=0, paged=0)
        backend.prefill_whole(0, prompt, start=hit)
        assert calls == want
        backend.free_slots([0])
        _drain(backend)


def test_preempted_cache_hits_like_reference(sides):
    """Optimistic admission on an oversubscribed pool with the cache live:
    hits and preemptions both happen, as in JAX, and streams stay the
    solo runs'."""
    out = []
    for S in sides:
        tmpl = _template(S, n=8, seed=11)
        rng = np.random.default_rng(12)
        reqs = []
        for i, (s, n) in enumerate([(3, 8), (5, 6), (2, 10), (4, 7)]):
            suf = rng.integers(2, S.cfg.vocab_size, s).astype(np.int32)
            suf[0] = 2 + i
            reqs.append(S.Request(rid=i, prompt=np.concatenate([tmpl, suf]),
                                  max_new_tokens=n))
        backend = S.make_backend("gspmd", S.cfg, S.params, num_slots=3,
                                 max_len=MAX_LEN, paged=True, page_size=PAGE,
                                 num_pages=10, prefix_cache=True, **S.kw)
        sched = S.Scheduler(backend, clock=S.Clock(), admission="optimistic")
        sched.run([S.Request(rid=99, prompt=np.concatenate([tmpl, tmpl[:1]]),
                             max_new_tokens=2)])
        report = sched.run(reqs)
        _drain(backend)
        out.append((_summary(report), report, reqs))
    assert out[0][0] == out[1][0]
    report, reqs = out[1][1:]
    assert report.preemptions > 0
    assert any(m.cached_prefix_len for m in report.metrics)
    port = sides[1]
    eng = InferenceEngine(port.cfg, port.params, max_len=MAX_LEN,
                          decode_chunk=1, device="cpu")
    for r in reqs:
        assert report.tokens_by_rid()[r.rid] == eng.generate(
            torch.from_numpy(r.prompt)[None],
            max_new_tokens=r.max_new_tokens)[0].tolist()


GUARDS = [
    (dict(prefix_cache=True), "paged"),
    (dict(paged=True, page_size=PAGE, c=2, t=1, prefix_cache=True),
     "c=1|context"),
    (dict(pool="shared"), "paged=True"),
    (dict(paged=True, page_size=PAGE, owner_base=-1), "owner_base"),
    (dict(paged=True, page_size=8, pool="shared"), "page_size"),
]


@pytest.mark.parametrize("kw,match", GUARDS,
                         ids=["unpaged", "cp", "pool-unpaged", "owner",
                              "page-size"])
def test_guards_raise_like_reference(sides, kw, match):
    for S in sides:
        kw = dict(kw)
        if kw.get("pool") == "shared":
            kw["pool"] = _backend(S, "gspmd", 1, 1).pool
        kind = "tp" if kw.get("c", 1) > 1 else "gspmd"
        with pytest.raises(ValueError, match=match):
            S.make_backend(kind, S.cfg, S.params, num_slots=2,
                           max_len=MAX_LEN, **kw, **S.kw)
