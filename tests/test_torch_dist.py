"""The explicit TP, PP and TP x PP engines and context parallelism on real
ranks: one process a rank over gloo, against the same engines on virtual
ranks and against the JAX package's engines.

Reduced llama32-3b in f32 (d 256, 4 heads, 4 KV heads, vocab 512) on 4
layers, JAX's weights through ``repro_torch.bridge``.  One spawn of 4 gloo
processes (``torch_dist_ranks.gloo_rank``, no JAX; one torch thread a
rank) runs, at (t, c, p) = (4, 1, 1), (2, 1, 2), (1, 1, 4), (1, 4, 1),
(2, 2, 1) and (1, 2, 2), a prefill with caches (at c > 1 a CP prefill of
a 7-token prompt padded to a multiple of c, each rank running its own
shard), 8 greedy tokens, a paged chunk and one paged decode step on
``core.comm.dist_groups``; the parent computes the virtual engine's and
JAX's passes on its host devices meanwhile.

* Logits within 1e-5 of the virtual engine's and of JAX's
  (``repro.core.parallel_exec``'s TP engine, ``cp_prefill`` on
  ``make_tp_cp_mesh`` or ``PipelineEngine``; the paged passes of a
  pipeline against the virtual engine's only, which ``test_torch_pp.py``
  holds to JAX's); greedy tokens identical on every rank, every CP
  replica's included.
* Each rank's comm log equals the virtual engine's for its stage, record
  for record, and its counts ``commodel.comm_ops_for`` (TP; at c > 1 its
  ring rows ``cp_comm_ops``) or ``hybrid_stage_collectives(c=c)``, the
  decode rows those of c = 1; the transfers the stages' first ranks sent
  equal the virtual engine's and Eq. 2 (``pp_comm_ops`` /
  ``hybrid_comm_ops``), at c > 1 at one worker's [B, S/c, h/t].
* At t = 4, ``quantized_psum`` int8, fp8 and int4 (f32 and bf16) on the
  ``DistGroup`` bit for bit the ``VirtualGroup``'s, with the same log;
  the ring step (``collective_permute``) likewise.
* ``TPBackend`` (t = 4 paged; (t, c) = (2, 2) paged) and ``PPBackend``
  (p = 4 inflight 2; (c, p) = (2, 2) contiguous and paged, the paged one
  seeding each CP prefill into its own stage's pages only) serve 4
  requests under per-rank virtual clocks skewed by r·50 ms: every rank
  admits the same requests at rank 0's times, and the streams equal the
  virtual backend's.  Then with rank r's clock r·50 ms behind rank 0's on one
  shared true time (``torch_dist_ranks.LaggingClock``): a rank that
  idled on its own clock would hold every rank past rank 0's deadline,
  so the times equal the virtual run's only if rank 0 alone waits.
* The guards: a world that is not t·p, a world that is not t·c·p, gloo
  on the card, a backend's (t, p) not its place's, a page export across
  ranks.
"""
import dataclasses
import functools
import pickle
import socket

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import torch_dist_ranks as tdr  # noqa: E402  (tests/: the ranks' program)
from repro.configs import get_config as jax_config  # noqa: E402
from repro.core import parallel_exec as jpx  # noqa: E402
from repro.models.transformer import get_model as jax_model  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.core import comm  # noqa: E402
from repro_torch.core import commodel as cm  # noqa: E402
from repro_torch.runtime.scheduler import VirtualClock  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-5)
LAYOUTS = [pytest.param(lay, id="tp{}cp{}pp{}".format(*lay))
           for lay in tdr.LAYOUTS]
PP_LAYOUTS = [lay for lay in LAYOUTS if lay.values[0][2] > 1]


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _jax_run(jcfg, jparams, t, p, c=1):
    """JAX's engine of the layout through ``engine_run``'s passes."""
    toks, chunk, step = (jnp.asarray(a) for a in tdr.inputs(jcfg))
    n = tdr.prompt_len(c)
    padded = jnp.pad(toks[:, :n], ((0, 0), (0, -n % c)))
    zeros = jnp.zeros(tdr.B, jnp.int32)
    bt = jnp.asarray(tdr.BT)
    if p == 1:
        if c == 1:
            mesh = jpx.make_tp_mesh(t)
            lg, cache = jpx.tp_prefill(jcfg, mesh, cache_w=tdr.W)(jparams,
                                                                  toks)
        else:
            mesh = jpx.make_tp_cp_mesh(t, c)
            lg, cache = jpx.cp_prefill(jcfg, mesh, cache_w=tdr.W)(
                jparams, padded, jnp.int32(n - 1))
        tok = jnp.argmax(lg, -1).astype(jnp.int32)
        gen, _ = jpx.tp_generate(jcfg, mesh, tdr.N)(jparams, cache, tok,
                                                   jnp.int32(n))
        shape = (jcfg.num_layers, tdr.PAGES, tdr.PS, jcfg.num_kv_heads,
                 jcfg.head_dim)
        pools = {k: jnp.zeros(shape, jnp.float32) for k in ("k", "v")}
        paged = jpx.tp_paged_step(jcfg, mesh)
        lg1, pools = paged(jparams, pools, chunk, zeros, bt)
        lg2, pools = paged(jparams, pools, step, zeros + tdr.S, bt)
    else:
        eng = jpx.PipelineEngine(jcfg, t=t, p=p, c=c)
        staged = eng.prepare(jparams)
        lg, caches = eng.prefill_with_cache(
            staged, padded, cache_w=tdr.W,
            **({} if c == 1 else {"last": n - 1}))
        tok = jnp.argmax(lg, -1).astype(jnp.int32)
        gen, _ = eng.generate(staged, caches, tok, n, tdr.N)
        lg1 = lg2 = None        # test_torch_pp.py holds them to JAX's
    return {"prefill": np.asarray(lg),
            "paged": [None if x is None else np.asarray(x)
                      for x in (lg1, lg2)],
            "tokens": np.concatenate([np.asarray(tok)[:, None],
                                      np.asarray(gen)], 1)}


@functools.lru_cache(maxsize=None)
def _weights():
    jcfg = jax_config("llama32-3b").reduced(num_layers=4)
    jparams = jax_model(jcfg).init(jax.random.PRNGKey(0))
    return jcfg, jparams, jax.tree.map(np.asarray, jparams)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(references, the 4 ranks' results): one spawn of the gloo ranks,
    the parent's virtual and JAX runs made while they work."""
    if len(jax.devices()) < 4:
        pytest.skip("needs 4 host-platform devices")
    import torch.multiprocessing as mp
    jcfg, jparams, params_np = _weights()
    out = tmp_path_factory.mktemp("dist")
    ctx = mp.start_processes(tdr.gloo_rank, args=(tdr.WORLD, _free_port(),
                                                  params_np, str(out)),
                             nprocs=tdr.WORLD, join=False,
                             start_method="spawn")
    try:
        cfg = tdr.reduced_config()
        params = bridge.params_from_jax(params_np, cfg, device="cpu")
        refs = {"cfg": cfg, "virtual": {}, "jax": {}, "serve": {}}
        for t, c, p in tdr.LAYOUTS:
            refs["virtual"][(t, c, p)] = tdr.engine_run(cfg, params, t, p,
                                                        c=c)
            refs["jax"][(t, c, p)] = _jax_run(jcfg, jparams, t, p, c)
        for serve, kind, kw in tdr.SERVE:
            refs["serve"][serve] = tdr.serve_run(cfg, params, kind, kw,
                                                 VirtualClock())
    finally:
        while not ctx.join():
            pass
    ranks = []
    for r in range(tdr.WORLD):
        with open(out / f"rank{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    return refs, ranks


def _stage(rank, layout):
    """The pipeline stage of ``rank``: stages hold t·c ranks each."""
    t, c, _ = layout
    return rank // (t * c)


def _close(got, want):
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_prefill_logits_match_virtual_and_jax(runs, layout):
    refs, ranks = runs
    p = layout[2]
    holders = [r for r in range(tdr.WORLD) if _stage(r, layout) == p - 1]
    for r, got in enumerate(ranks):
        got = got["layouts"][layout]["prefill"]
        assert (got is not None) == (r in holders), r
        if got is not None:
            _close(got, refs["virtual"][layout]["prefill"])
            _close(got, refs["jax"][layout]["prefill"])


@pytest.mark.parametrize("layout", LAYOUTS)
def test_greedy_tokens_match_virtual_and_jax(runs, layout):
    refs, ranks = runs
    want = refs["virtual"][layout]["tokens"]
    assert want.shape == (tdr.B, tdr.N + 1)
    np.testing.assert_array_equal(want, refs["jax"][layout]["tokens"])
    for got in ranks:
        np.testing.assert_array_equal(got["layouts"][layout]["tokens"], want)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_paged_step_matches_virtual_and_jax(runs, layout):
    refs, ranks = runs
    p = layout[2]
    for r, got in enumerate(ranks):
        for i, lg in enumerate(got["layouts"][layout]["paged"]):
            if _stage(r, layout) != p - 1:
                assert lg is None
                continue
            _close(lg, refs["virtual"][layout]["paged"][i])
            if p == 1:
                _close(lg, refs["jax"][layout]["paged"][i])


def _recs(tuples):
    return [comm.CommRecord(*x) for x in tuples]


@pytest.mark.parametrize("layout", LAYOUTS)
def test_comm_logs_match_virtual_and_closed_form(runs, layout):
    """Each rank's log is its stage's virtual log, record for record; the
    prefill and one decode step's counts are the closed form's (at c > 1
    the prefill's ring rows ``cp_comm_ops``, the decode rows c = 1's)."""
    refs, ranks = runs
    cfg = refs["cfg"]
    t, c, p = layout
    n = tdr.prompt_len(c)
    virtual = refs["virtual"][layout]
    for r, got in enumerate(ranks):
        s = _stage(r, layout)
        run = got["layouts"][layout]
        mine = [i for i, log in enumerate(run["logs"]) if log is not None]
        assert mine == ([s] if p > 1 else [0])
        log, marks = run["logs"][mine[0]], run["marks"][mine[0]]
        assert log == virtual["logs"][mine[0]], r
        assert marks == virtual["marks"][mine[0]]
        pre, gen = marks
        step = (gen - pre) // tdr.N
        assert step * tdr.N == gen - pre
        one = _recs(log[:pre + step])
        if c > 1:
            # the stage's ring: its layers' share of cp_comm_ops's rows
            ring = [o for o in comm.summarize(one, "prefill")
                    if o.collective == "collectivepermute"]
            row = cm.cp_comm_ops(cfg, n, c, t=t, b=4, batch=tdr.B)[0]
            L_s = cm.stage_layer_partition(cfg.num_layers, p)[s]
            assert comm.fold(ring) == comm.fold([dataclasses.replace(
                row, count=row.count * L_s // cfg.num_layers)]), r
        if p == 1:
            want = cm.comm_ops_for(cfg, n, 2, t, c=c, batch=tdr.B, b=4,
                                   gather_mode="allgather")
            assert comm.fold(comm.summarize(one)) == comm.fold(want)
            # decode runs replicated over cp: c = 1's rows
            c1 = cm.comm_ops_for(cfg, n, 2, t, batch=tdr.B, b=4,
                                 gather_mode="allgather")
            assert comm.fold(comm.summarize(one, "decode")) == comm.fold(
                [o for o in c1 if o.phase == "decode"])
            continue
        for phase in ("prefill", "decode"):
            assert comm.counts_by_collective(comm.summarize(one, phase)) \
                == cm.hybrid_stage_collectives(cfg, t, p, s, c=c,
                                               phase=phase)
        assert comm.counts_by_collective(comm.summarize(one, "decode")) \
            == cm.hybrid_stage_collectives(cfg, t, p, s, phase="decode")


@pytest.mark.parametrize("layout", PP_LAYOUTS)
def test_transfers_equal_virtual_and_eq2(runs, layout):
    """The hops each stage's ranks sent add up, over the stages' first
    ranks, to the virtual engine's transfers and to Eq. 2's send rows (at
    c > 1 a prefill's at one worker's [B, S/c, h/t]); every TP and CP
    rank of a stage sends the same records."""
    refs, ranks = runs
    cfg = refs["cfg"]
    t, c, p = layout
    n = tdr.prompt_len(c)
    virtual = refs["virtual"][layout]
    sent = []
    for r, got in enumerate(ranks):
        run = got["layouts"][layout]
        if _stage(r, layout) == p - 1:
            assert run["transfers"] == []
        assert run["transfers"] == \
            ranks[r - r % (t * c)]["layouts"][layout]["transfers"]
        if r % (t * c) == 0:
            sent.append(run)
        if _stage(r, layout) < p - 1:
            assert {x[2] for x in run["transfers"][:run["sent"]]
                    if x[0] == "prefill"} == \
                {(tdr.B, cm.cp_shard_len(n, c), cfg.d_model // t)}, r
    assert sorted(x for run in sent for x in run["transfers"]) == \
        sorted(virtual["transfers"])
    if t == 1:
        ops = cm.pp_comm_ops(cfg, cm.cp_shard_len(n, c), tdr.N + 1, p, b=4,
                             batch=tdr.B)
    else:
        ops = cm.hybrid_comm_ops(cfg, cm.cp_shard_len(n, c), tdr.N + 1, t,
                                 p, b=4, batch=tdr.B,
                                 gather_mode="allgather")
    for phase in ("prefill", "decode"):
        want = [o for o in ops if o.collective == "send" and o.phase == phase]
        got = [x for run in sent for x in run["transfers"][:run["sent"]]
               if x[0] == phase]
        assert len(want) == 1
        assert (sum(x[1] for x in got), sum(x[3] for x in got)) == \
            (want[0].count, want[0].total_msg_bytes)


@pytest.mark.parametrize("dtype", ["torch.float32", "torch.bfloat16"])
@pytest.mark.parametrize("quant", ["int8", "fp8", "int4"])
def test_quantized_psum_is_bitwise_the_virtual_group(runs, quant, dtype):
    _, ranks = runs
    for r, got in enumerate(ranks):
        assert got["quant"][(quant, dtype)] == (True, True), r


@pytest.mark.parametrize("kind", [name for name, _, _ in tdr.SERVE])
def test_backends_serve_on_rank0s_clock(runs, kind):
    """Under clocks skewed by r·50 ms every rank admits, prefills and
    finishes the same requests at rank 0's times, which are the virtual
    run's, and the streams are the virtual backend's."""
    refs, ranks = runs
    want = refs["serve"][kind]
    assert len(want) == 4
    for r, got in enumerate(ranks):
        assert got["serve"][kind] == want, r


@pytest.mark.parametrize("kind", [name for name, _, _ in tdr.SERVE])
def test_backends_keep_rank0s_times_when_a_clock_lags(runs, kind):
    """Under clocks r·50 ms behind rank 0's every rank admits, makes its
    first token and finishes each request at the virtual run's times."""
    refs, ranks = runs
    want = refs["serve"][kind]
    for r, got in enumerate(ranks):
        assert got["serve_behind"][kind] == want, r


def test_collective_permute_is_the_virtual_ring(runs):
    """The ring step at t = 4 (``batch_isend_irecv``) into a given buffer:
    each rank holds the virtual group's rank's tensor, with its log."""
    _, ranks = runs
    for r, got in enumerate(ranks):
        assert got["permute"] == (True, True, True), r


def test_guards_raise(runs):
    _, ranks = runs
    for got in ranks:
        assert got["guards"] == dict.fromkeys(got["guards"], True)
        assert len(got["guards"]) == 5


def test_reduced_config_is_the_stated_one():
    cfg = tdr.reduced_config()
    jcfg = _weights()[0]
    assert (cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.vocab_size,
            cfg.num_layers, cfg.dtype) == (256, 4, 4, 512, 4, "float32")
    assert dataclasses.asdict(jcfg)["d_model"] == cfg.d_model
