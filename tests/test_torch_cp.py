"""The port's context parallelism (CP) against the JAX package's.

Reduced llama32-3b in float32 over 2 layers with num_kv_heads = 2 (a t = 2
rank holds one KV head and two query heads), under the conftest's 8-device
host mesh, at the layouts of JAX's ``tests/test_cp.py``: (t, c, p) =
(1, 2, 1), (2, 2, 1) and (1, 2, 2).  Weights come from the JAX package's
``Model.init`` through numpy; tokens are made with numpy from a seed.

* ``layers.ring_kv_assemble`` on c virtual workers: every worker's copy is
  bitwise the blocks concatenated in order and JAX's ring under
  ``shard_map``; one collective-permute record per round.
* The CP branch of ``blocks.attention_apply`` against JAX's
  (``cp_axis``), with and without a window; B2's plain version and the
  port's plain mask at shard offsets against JAX's ``gqa_attention`` on
  ``make_mask(q_offset=)``.
* ``TPModel.cp_prefill`` and ``PipelineEngine``'s CP prefill against JAX's
  ``cp_prefill`` / CP ``PipelineEngine`` at odd prompt lengths (padded):
  logits and every rank's and stage's caches within 1e-4.
* Scheduler streams over the ragged trace, contiguous and paged, identical
  to JAX's c > 1 backends, the port's c = 1 backends and solo serving; the
  comm log equal to ``prefill_comm_ops`` (``cp_comm_ops`` for the CP
  group) with decode rows those of c = 1; the PP stage logs and the
  [S/c, h/t] transfers.
* The head's added row, then B1, bitwise the c = 1 ``add_rms_norm``.
* Guards: gspmd rejects c > 1, chunked prefill rejects a c > 1 backend,
  the padded prompt respects max_len, a sliding-window prompt past max_len
  serves as at c = 1.
"""
import collections
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.experimental.shard_map import shard_map  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.core import parallel_exec as jpx  # noqa: E402
from repro.models import blocks as jblocks  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models.transformer import get_model as jax_model  # noqa: E402
from repro.runtime import backends as jax_backends  # noqa: E402
from repro.runtime import request as jax_request  # noqa: E402
from repro.runtime import scheduler as jax_scheduler  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config as port_config  # noqa: E402
from repro_torch.core import comm  # noqa: E402
from repro_torch.core import commodel as cm  # noqa: E402
from repro_torch.core.parallel_exec import (PipelineEngine, TPModel,  # noqa: E402
                                            shard_params)
from repro_torch.kernels.flash_attention.ref import flash_attention_ref  # noqa: E402
from repro_torch.models import blocks, layers  # noqa: E402
from repro_torch.runtime import request as port_request  # noqa: E402
from repro_torch.runtime import scheduler as port_scheduler  # noqa: E402
from repro_torch.runtime.backends import make_backend  # noqa: E402
from repro_torch.runtime.engine import InferenceEngine  # noqa: E402

needs_mesh = pytest.mark.skipif(len(jax.devices()) < 4,
                                reason="needs 4 host-platform devices")
TOL = dict(atol=1e-4, rtol=1e-4)
MAX_LEN, PAGE, W = 64, 8, 24
# (kind, layout, the c = 1 backend the layout is held to)
LAYOUTS = [pytest.param("tp", dict(t=1, c=2), ("gspmd", {}), id="t1c2"),
           pytest.param("tp", dict(t=2, c=2), ("tp", dict(t=2)), id="t2c2"),
           pytest.param("pp", dict(t=1, c=2, p=2), ("pp", dict(t=1, p=2)),
                        id="t1c2p2"),
           pytest.param("pp", dict(t=2, c=2, p=2), ("pp", dict(t=2, p=2)),
                        id="t2c2p2")]


@functools.lru_cache(maxsize=None)
def _weights(window=None):
    """(jax cfg, jax params, port cfg, port params)."""
    jcfg = dataclasses.replace(jax_config("llama32-3b").reduced(num_layers=2),
                               num_kv_heads=2, sliding_window=window)
    tcfg = dataclasses.replace(port_config("llama32-3b").reduced(num_layers=2),
                               num_kv_heads=2, sliding_window=window)
    jparams = jax_model(jcfg).init(jax.random.PRNGKey(0))
    tparams = bridge.params_from_jax(jax.tree.map(np.asarray, jparams),
                                     tcfg, device="cpu")
    return jcfg, jparams, tcfg, tparams


def _rng(seed):
    return np.random.default_rng(seed)


def _tokens(cfg, shape, seed=0):
    return _rng(seed).integers(2, cfg.vocab_size, shape).astype(np.int32)


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


def _cat(cache, key):
    """Per-rank caches side by side on the KV-head axis: the global cache."""
    return torch.cat([c[key] for c in cache], dim=-2)


def _pad(toks, c):
    return np.pad(toks, ((0, 0), (0, -toks.shape[1] % c)))


# ---------------------------------------------------------------------------
# the ring
# ---------------------------------------------------------------------------


@needs_mesh
@pytest.mark.parametrize("c", [2, 4])
def test_ring_kv_assemble_is_bitwise_and_matches_jax(c):
    k = _rng(c).standard_normal((2, 4 * c, 3, 8)).astype(np.float32)
    blocks_in = list(torch.from_numpy(k).chunk(c, dim=1))
    group = comm.VirtualGroup(c)
    full = layers.ring_kv_assemble(blocks_in, group)
    assert len(full) == c
    for f in full:
        assert torch.equal(f, torch.from_numpy(k))
    # each worker's copy is its own buffer, written by copies
    assert len({f.data_ptr() for f in full}) == c
    ring = jax.jit(shard_map(lambda b: jlayers.ring_kv_assemble(b, "cp", c),
                             mesh=jpx.make_tp_cp_mesh(1, c),
                             in_specs=P(None, "cp"), out_specs=P(None, None),
                             check_rep=False))
    np.testing.assert_array_equal(full[0].numpy(),
                                  np.asarray(ring(jnp.asarray(k))))
    # c - 1 rounds, each one worker's [B, S/c, H*D] block on c workers
    assert [(r.kind, r.shape, r.t) for r in group.log] == \
        [("collectivepermute", (2, 4, 24), c)] * (c - 1)


def _jax_cp_attention(jcfg, pl, xn, c, window):
    """JAX's CP attention_apply under shard_map: (out, cache)."""
    def fn(pl, xn):
        s = xn.shape[1]
        off = jax.lax.axis_index("cp") * s
        positions = jnp.broadcast_to(off + jnp.arange(s), (xn.shape[0], s))
        mask = jlayers.make_mask(s, c * s, q_offset=off, window=window)
        return jblocks.attention_apply(jcfg, pl, xn, positions, mask,
                                       build_cache_w=W, cp_axis="cp",
                                       cp_size=c)
    mapped = shard_map(fn, mesh=jpx.make_tp_cp_mesh(1, c),
                       in_specs=(jax.tree.map(lambda _: P(), pl),
                                 P(None, "cp")),
                       out_specs=(P(None, "cp"), {"k": P(), "v": P()}),
                       check_rep=False)
    return jax.jit(mapped)(pl, xn)


@needs_mesh
@pytest.mark.parametrize("window", [None, 16], ids=["causal", "window16"])
def test_cp_attention_apply_matches_jax(window):
    jcfg, jparams, tcfg, tparams = _weights(window)
    c, B, S = 2, 2, 40
    xn = (0.5 * _rng(1).standard_normal((B, S, tcfg.d_model))).astype(
        np.float32)
    jpl = {k: v[0] for k, v in jparams["blocks"].items()}
    want, want_cache = _jax_cp_attention(jcfg, jpl, jnp.asarray(xn), c,
                                         window)
    pl = {k: v[0] for k, v in tparams["blocks"].items()}
    s = S // c
    xs = list(torch.from_numpy(xn).chunk(c, dim=1))
    pos = [torch.arange(r * s, (r + 1) * s).expand(B, s) for r in range(c)]
    group = comm.VirtualGroup(c)
    outs, cache = blocks.attention_apply(tcfg, pl, xs, pos, plain=True,
                                         build_cache_w=W, cp_group=group)
    _close(torch.cat(outs, dim=1), want)
    for key in ("k", "v"):
        _close(cache[key], want_cache[key])
    # the dispatcher's CPU path (B2's plain version) gives the same rows
    outs_b2, _ = blocks.attention_apply(tcfg, pl, xs, pos, cp_group=group)
    _close(torch.cat(outs_b2, dim=1), want)
    assert comm.counts_by_collective(group.summary()) == \
        {"collectivepermute": 2 * 2 * (c - 1)}


@pytest.mark.parametrize("window", [None, 16], ids=["causal", "window16"])
def test_plain_attention_at_shard_offsets_matches_jax(window):
    """B2's plain version and the port's plain mask at every shard offset
    of c = 4 against JAX's gqa_attention on make_mask(q_offset=) (JAX's
    Pallas flash takes offset 0 only, so its jnp path is the reference)."""
    c, B, S, Hq, Hkv, D = 4, 2, 48, 6, 2, 16
    rng = _rng(2)
    q = rng.standard_normal((B, S, Hq, D)).astype(np.float32)
    k = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    s = S // c
    tk, tv = torch.from_numpy(k), torch.from_numpy(v)
    for r in range(c):
        qs = q[:, r * s:(r + 1) * s]
        jmask = jlayers.make_mask(s, S, q_offset=r * s, window=window)
        want = np.asarray(jlayers.gqa_attention(
            jnp.asarray(qs), jnp.asarray(k), jnp.asarray(v), jmask))
        tmask = layers.make_mask(s, S, q_offset=r * s, window=window)
        np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))
        tq = torch.from_numpy(qs)
        _close(layers.gqa_attention(tq, tk, tv, tmask), want)
        off = torch.full((B,), r * s, dtype=torch.int32)
        kl = torch.full((B,), S, dtype=torch.int32)
        _close(flash_attention_ref(tq, tk, tv, off, kl, window), want)


# ---------------------------------------------------------------------------
# the engines
# ---------------------------------------------------------------------------


@needs_mesh
@pytest.mark.parametrize("S", [7, 11])
@pytest.mark.parametrize("t", [1, 2])
def test_cp_prefill_matches_jax(t, S):
    jcfg, jparams, tcfg, tparams = _weights()
    c, B = 2, 2
    toks = _pad(_tokens(tcfg, (B, S), seed=S), c)
    fn = jpx.cp_prefill(jcfg, jpx.make_tp_cp_mesh(t, c), cache_w=W)
    jl, jcache = fn(jparams, jnp.asarray(toks), jnp.int32(S - 1))
    model = TPModel(tcfg, t, c=c)
    tl, tcache = model.cp_prefill(shard_params(tcfg, tparams, t),
                                  torch.from_numpy(toks), S - 1, W)
    _close(tl, jl)
    for key in ("k", "v"):
        _close(_cat(tcache, key), jcache[key])


@needs_mesh
@pytest.mark.parametrize("t,S", [(1, 7), (1, 11), (2, 11)],
                         ids=["7", "11", "t2-11"])
def test_cp_pipeline_prefill_matches_jax(t, S):
    jcfg, jparams, tcfg, tparams = _weights()
    c, p, B = 2, 2, 2
    toks = _pad(_tokens(tcfg, (B, S), seed=S), c)
    jeng = jpx.PipelineEngine(jcfg, t=t, p=p, c=c)
    jl, jcaches = jeng.prefill_with_cache(jeng.prepare(jparams),
                                          jnp.asarray(toks), cache_w=W,
                                          last=S - 1)
    eng = PipelineEngine(tcfg, t=t, p=p, c=c, device="cpu")
    tl, tcaches = eng.prefill_with_cache(eng.prepare(tparams),
                                         torch.from_numpy(toks), W, S - 1)
    _close(tl, jl)
    for mine, theirs in zip(tcaches, jcaches):
        for key in ("k", "v"):
            _close(_cat(mine, key), theirs[key])
    # two tensors of one worker's [B, S/c, h/t] per boundary
    S_pad = toks.shape[1]
    assert eng.transfer_summary("prefill") == {
        "count": 2, "bytes": 2 * B * (S_pad // c) * tcfg.d_model // t * 4}


def test_cp_head_row_then_b1_is_bitwise_the_c1_add_norm():
    """The shard that owns position ``last`` adds its carried pair on that
    row, the CP all-reduce hands it on, and B1 normalises it: bitwise the
    c = 1 head, which adds and normalises the same row in one
    ``add_rms_norm``."""
    _, _, tcfg, _ = _weights()
    c, B, S = 2, 2, 10
    rng = _rng(5)
    x = torch.from_numpy(rng.standard_normal((B, S, tcfg.d_model)).astype(
        np.float32))
    h = torch.from_numpy(rng.standard_normal((B, S, tcfg.d_model)).astype(
        np.float32))
    w = torch.from_numpy(0.1 * rng.standard_normal(tcfg.d_model).astype(
        np.float32))
    model = TPModel(tcfg, 1, c=c)
    shards = list(zip(h.chunk(c, dim=1), x.chunk(c, dim=1)))
    for last in (S - 1, 3):
        none, row = model._cp_last_hidden(shards, last)
        assert none is None
        _, n = layers.add_norm(row[:, -1], None, w, tcfg.norm_eps)
        _, want = layers.add_norm(x[:, last], h[:, last], w, tcfg.norm_eps)
        assert torch.equal(n, want)
    assert [r.kind for r in model.group.log] == ["allreduce"] * 2


# ---------------------------------------------------------------------------
# serving through Scheduler
# ---------------------------------------------------------------------------


def _ragged(module, cfg):
    rng = _rng(0)
    lens = [(7, 6), (11, 4), (5, 8), (9, 3)]   # odd lengths force padding
    return [module.Request(rid=i, prompt=rng.integers(
                2, cfg.vocab_size, s).astype(np.int32), max_new_tokens=n)
            for i, (s, n) in enumerate(lens)]


def _sum_folds(ops_lists):
    total = collections.Counter()
    for ops in ops_lists:
        total.update(comm.fold(ops))
    return dict(total)


@functools.lru_cache(maxsize=None)
def _solo():
    """Each request of the trace served alone on the port's engine."""
    _, _, tcfg, tparams = _weights()
    eng = InferenceEngine(tcfg, tparams, max_len=MAX_LEN, decode_chunk=1,
                          device="cpu")
    return {r.rid: eng.generate(torch.from_numpy(r.prompt)[None],
                                max_new_tokens=r.max_new_tokens)[0].tolist()
            for r in _ragged(port_request, tcfg)}


@needs_mesh
@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
@pytest.mark.parametrize("kind,kw,c1", LAYOUTS)
def test_cp_scheduler_streams_and_comm_log(kind, kw, c1, paged):
    jcfg, jparams, tcfg, tparams = _weights()
    pkw = dict(paged=True, page_size=PAGE) if paged else {}
    jb = jax_backends.make_backend(kind, jcfg, jparams, num_slots=2,
                                   max_len=MAX_LEN, **pkw, **kw)
    want = jax_scheduler.Scheduler(
        jb, clock=jax_scheduler.VirtualClock()).run(
        _ragged(jax_request, jcfg)).tokens_by_rid()
    base_kind, base_kw = c1
    base = make_backend(base_kind, tcfg, tparams, num_slots=2,
                        max_len=MAX_LEN, device="cpu", **pkw, **base_kw)
    c1 = port_scheduler.Scheduler(
        base, clock=port_scheduler.VirtualClock()).run(
        _ragged(port_request, tcfg)).tokens_by_rid()
    backend = make_backend(kind, tcfg, tparams, num_slots=2, max_len=MAX_LEN,
                           device="cpu", **pkw, **kw)
    trace = _ragged(port_request, tcfg)
    report = port_scheduler.Scheduler(
        backend, clock=port_scheduler.VirtualClock()).run(trace)
    got = report.tokens_by_rid()
    assert got == want == c1 == _solo()
    if paged:
        assert backend.pool.free_pages == backend.pool.num_pages - 1

    # communication: one prefill record per request with its CP rows; the
    # decode rows are c = 1's
    pre = [r for r in report.steps if r.phase == "prefill"]
    dec = [r for r in report.steps if r.phase == "decode"]
    assert [r.rid for r in pre] == [r.rid for r in trace]
    for rec, req in zip(pre, trace):
        ops = backend.prefill_comm_ops(req.prompt_len)
        assert rec.collective_counts == comm.counts_by_collective(ops)
        assert ops[-2:] == cm.cp_comm_ops(tcfg, req.prompt_len, 2,
                                          t=kw["t"], b=4)
    assert backend.decode_comm_ops(batch=2) == base.decode_comm_ops(batch=2)
    if kind == "tp":
        log = backend.model.group
        assert comm.fold(log.summary("prefill")) == _sum_folds(
            backend.prefill_comm_ops(r.prompt_len) for r in trace)
        assert comm.fold(log.summary("decode")) == _sum_folds(
            [backend.decode_comm_ops(batch=2)] * len(dec))
        return
    eng = backend.engine
    for s, stage in enumerate(eng.stages):
        for phase, n in (("prefill", len(trace)), ("decode", len(dec))):
            want_s = {k: v * n for k, v in cm.hybrid_stage_collectives(
                tcfg, kw["t"], 2, s, c=2, phase=phase).items()}
            assert comm.counts_by_collective(stage.group.summary(phase)) == \
                want_s
    send = [[o for o in backend.prefill_comm_ops(r.prompt_len)
             if o.collective == "send"][0] for r in trace]
    assert eng.transfer_summary("prefill") == {
        "count": sum(o.count for o in send),
        "bytes": sum(o.total_msg_bytes for o in send)}
    assert [r.measured_transfers["count"] for r in pre] == [2] * len(trace)


def test_cp_composes_with_quantized_decode():
    """int8 collectives change only the decode step, which is c = 1's: a
    (2, 2) int8 backend serves the trace, its prefill records carry the
    full-width TP rows and the ring, its decode rows are the quantized
    ones of the c = 1 int8 backend."""
    _, _, tcfg, tparams = _weights()
    trace = _ragged(port_request, tcfg)
    backends = [make_backend("tp", tcfg, tparams, num_slots=2,
                             max_len=MAX_LEN, t=2, c=c,
                             quant_collectives="int8", device="cpu")
                for c in (2, 1)]
    report = port_scheduler.Scheduler(
        backends[0], clock=port_scheduler.VirtualClock()).run(trace)
    assert [m.num_generated for m in report.metrics] == [6, 4, 8, 3]
    assert backends[0].decode_comm_ops(batch=2) == \
        backends[1].decode_comm_ops(batch=2)
    kinds = {r.kind for r in backends[0].model.group.log
             if r.phase == "prefill"}
    assert kinds == {"allreduce", "allgather", "collectivepermute"}
    assert "reducescatter" in {r.kind for r in backends[0].model.group.log}


# ---------------------------------------------------------------------------
# guards
# ---------------------------------------------------------------------------


def test_cp_guards():
    _, _, tcfg, tparams = _weights()
    with pytest.raises(ValueError, match="explicit engines"):
        make_backend("gspmd", tcfg, tparams, num_slots=2, c=2, device="cpu")
    with pytest.raises(ValueError, match="t >= 2 or c >= 2"):
        make_backend("tp", tcfg, tparams, num_slots=2, t=1, c=1,
                     device="cpu")
    backend = make_backend("tp", tcfg, tparams, num_slots=2, max_len=MAX_LEN,
                           t=1, c=2, paged=True, page_size=PAGE,
                           device="cpu")
    with pytest.raises(ValueError, match="alternative"):
        port_scheduler.Scheduler(backend, chunk_size=4)
    with pytest.raises(RuntimeError, match="alternative"):
        backend.prefill_chunk(0, np.arange(2, 6), 0)
    with pytest.raises(ValueError, match="multiple of c"):
        TPModel(tcfg, 1, c=2).cp_prefill(
            shard_params(tcfg, tparams, 1), torch.ones(1, 7, dtype=torch.long))


def test_cp_padded_prompt_respects_max_len():
    _, _, tcfg, tparams = _weights()
    backend = make_backend("tp", tcfg, tparams, num_slots=1, max_len=8, t=1,
                           c=2, device="cpu")
    sched = port_scheduler.Scheduler(backend,
                                     clock=port_scheduler.VirtualClock())
    # 7 tokens pad to 8; with 2 new tokens the cache needs max(7 + 1, 8)
    sched.run([port_request.Request(rid=0, prompt=np.arange(2, 9),
                                    max_new_tokens=2)])
    with pytest.raises(ValueError, match="cache positions"):
        sched.submit(port_request.Request(rid=1, prompt=np.arange(2, 10),
                                          max_new_tokens=2))
    with pytest.raises(ValueError, match="exceeds max_len"):
        backend._pad_prompt(np.arange(2, 11))


def test_cp_sliding_window_serves_past_max_len():
    """A sliding-window model serves prompts beyond max_len (its ring cache
    keeps the last W positions): the padding guard waives it as admission
    does, and the stream equals c = 1's."""
    _, _, tcfg, tparams = _weights(16)
    req = port_request.Request(
        rid=0, prompt=_tokens(tcfg, (41,), seed=3), max_new_tokens=3)
    streams = []
    for kw in (dict(t=2), dict(t=1, c=2)):
        backend = make_backend("tp", tcfg, tparams, num_slots=1, max_len=32,
                               device="cpu", **kw)
        streams.append(port_scheduler.Scheduler(
            backend, clock=port_scheduler.VirtualClock()).run(
            [dataclasses.replace(req)]).tokens_by_rid()[0])
    assert streams[0] == streams[1]
    assert len(streams[0]) == 3
