"""The port's pipeline and hybrid engine on virtual stages against the JAX
package's ``PipelineEngine``.

Reduced llama32-3b in float32 (num_kv_heads = 2, so a t = 2 rank holds one
KV head and two query heads) under the conftest's 8-device host mesh, at
(t, p) = (1, 2), (1, 4), (2, 2) over 4 layers and (2, 2) over 5 layers
(an uneven split: 3 + 2).  Weights come from the JAX package's
``Model.init`` through numpy; tokens are made with numpy from a seed.

* ``stage_layer_range`` equals JAX's.
* ``forward``, ``prefill_with_cache``, ``decode_once`` and ``paged_pass``
  (a chunk, then decode steps) equal JAX's: logits and every stage's
  caches within 1e-4 absolute and relative; ``generate``'s greedy tokens
  identical.
* The port's PP passes are bitwise its own single-stage paths: ``Model``
  at t = 1, ``TPModel`` at t = 2.
* ``transfer_summary`` equals the send rows of ``pp_comm_ops`` /
  ``hybrid_comm_ops`` (b = 4), and each stage's comm log per pass equals
  ``hybrid_stage_collectives`` (prefill, decode, paged, quantized decode).
* Quantized (int8, fp8, int4) contiguous decode at (2, 2) against JAX's
  quantized PP, teacher-forced: top-1 match >= 0.90, drift <= 0.25.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.core import parallel_exec as jpx  # noqa: E402
from repro.models.transformer import get_model as jax_model  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config as port_config  # noqa: E402
from repro_torch.core import comm  # noqa: E402
from repro_torch.core import commodel as cm  # noqa: E402
from repro_torch.core.parallel_exec import (PipelineEngine, TPModel,  # noqa: E402
                                            shard_params, stage_layer_range)
from repro_torch.models.transformer import get_model as port_model  # noqa: E402

needs_mesh = pytest.mark.skipif(len(jax.devices()) < 4,
                                reason="needs 4 host-platform devices")
TOL = dict(atol=1e-4, rtol=1e-4)
B, S, W, N = 2, 8, 24, 5
PS, PAGES = 4, 9
BT = np.array([[3, 1, 7, 5], [2, 8, 4, 6]], np.int32)
LAYOUTS = [pytest.param((1, 2, 4), id="pp2"), pytest.param((1, 4, 4), id="pp4"),
           pytest.param((2, 2, 4), id="tp2pp2"),
           pytest.param((2, 2, 5), id="tp2pp2-L5")]


@functools.lru_cache(maxsize=None)
def _weights(L):
    """(jax cfg, jax params, port cfg, port params) with L layers."""
    jcfg = dataclasses.replace(jax_config("llama32-3b").reduced(num_layers=L),
                               num_kv_heads=2)
    tcfg = dataclasses.replace(port_config("llama32-3b").reduced(num_layers=L),
                               num_kv_heads=2)
    jparams = jax_model(jcfg).init(jax.random.PRNGKey(0))
    tparams = bridge.params_from_jax(jax.tree.map(np.asarray, jparams),
                                     tcfg, device="cpu")
    return jcfg, jparams, tcfg, tparams


def _tokens(cfg, shape, seed=0):
    return np.random.default_rng(seed).integers(
        2, cfg.vocab_size, shape).astype(np.int32)


def _inputs(cfg):
    toks = _tokens(cfg, (B, S))
    paged = _tokens(cfg, (B, S + 3), seed=1)
    chunks = [paged[:, :S]] + [paged[:, S + i:S + i + 1] for i in range(3)]
    return toks, chunks


@functools.lru_cache(maxsize=None)
def _jax_run(t, p, L):
    """JAX PipelineEngine on the shared inputs: every pass's logits and
    every stage's caches, as numpy."""
    jcfg, jparams, _, _ = _weights(L)
    toks, chunks = _inputs(jcfg)
    eng = jpx.PipelineEngine(jcfg, t=t, p=p)
    staged = eng.prepare(jparams)
    out = {"forward": np.asarray(eng.forward(staged, jnp.asarray(toks)))}
    lg, caches = eng.prefill_with_cache(staged, jnp.asarray(toks), cache_w=W)
    out["prefill"] = np.asarray(lg)
    out["prefill_caches"] = jax.tree.map(np.asarray, caches)
    tok = np.argmax(out["prefill"], -1).astype(np.int32)
    pos = np.array([S, S - 3], np.int32)
    lg, c2 = eng.decode_once(staged, jax.tree.map(jnp.copy, caches),
                             jnp.asarray(tok), jnp.asarray(pos))
    out["decode"] = np.asarray(lg)
    out["decode_caches"] = jax.tree.map(np.asarray, c2)
    gen, _ = eng.generate(staged, caches, jnp.asarray(tok), S, N)
    out["generate"] = np.asarray(gen)
    shapes = [(hi - lo, PAGES, PS, jcfg.num_kv_heads, jcfg.head_dim)
              for lo, hi in (jpx.stage_layer_range(jcfg, p, s)
                             for s in range(p))]
    pools = [{k: jnp.zeros(sh, jnp.float32) for k in ("k", "v")}
             for sh in shapes]
    ppos = np.zeros(B, np.int32)
    out["paged"] = []
    for chunk in chunks:
        phase = "prefill" if chunk.shape[1] > 1 else "decode"
        lg, pools = eng.paged_pass(staged, pools, jnp.asarray(chunk),
                                   jnp.asarray(ppos), jnp.asarray(BT), phase)
        out["paged"].append(np.asarray(lg))
        ppos = ppos + chunk.shape[1]
    out["paged_caches"] = jax.tree.map(np.asarray, pools)
    return out


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


def _global(stage_cache, key):
    """A stage's per-rank caches side by side on the KV-head axis."""
    return torch.cat([c[key] for c in stage_cache], dim=3)


def _close_caches(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for key in ("k", "v"):
            _close(_global(g, key), w[key])


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_clone(v) for v in tree]
    return tree.clone()


def _engine(t, p, L, **kw):
    _, _, tcfg, tparams = _weights(L)
    eng = PipelineEngine(tcfg, t=t, p=p, device="cpu", **kw)
    return tcfg, eng, eng.prepare(tparams)


def _port_paged(eng, staged, chunks):
    pools = eng.init_paged_cache(PAGES, PS)
    pos = np.zeros(B, np.int32)
    logits = []
    for chunk in chunks:
        phase = "prefill" if chunk.shape[1] > 1 else "decode"
        lg, pools = eng.paged_pass(staged, pools, torch.from_numpy(chunk),
                                   torch.from_numpy(pos),
                                   torch.from_numpy(BT), phase)
        logits.append(lg)
        pos = pos + chunk.shape[1]
    return logits, pools


# ---------------------------------------------------------------------------
# the layer split
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("L", [2, 5, 28])
@pytest.mark.parametrize("p", [2, 4, 8])
def test_stage_layer_range_matches_jax(L, p):
    jcfg = jax_config("llama32-3b").reduced(num_layers=L)
    tcfg = port_config("llama32-3b").reduced(num_layers=L)
    ranges = [stage_layer_range(tcfg, p, s) for s in range(p)]
    assert ranges == [jpx.stage_layer_range(jcfg, p, s) for s in range(p)]
    assert ranges[0][0] == 0 and ranges[-1][1] == L
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))


# ---------------------------------------------------------------------------
# the engine against JAX's
# ---------------------------------------------------------------------------


@needs_mesh
@pytest.mark.parametrize("layout", LAYOUTS)
def test_passes_match_jax(layout):
    t, p, L = layout
    want = _jax_run(t, p, L)
    tcfg, eng, staged = _engine(t, p, L)
    toks, chunks = _inputs(tcfg)
    _close(eng.forward(staged, torch.from_numpy(toks)), want["forward"])
    lg, caches = eng.prefill_with_cache(staged, torch.from_numpy(toks), W)
    _close(lg, want["prefill"])
    _close_caches(caches, want["prefill_caches"])
    tok = torch.from_numpy(np.argmax(want["prefill"], -1).astype(np.int32))
    pos = torch.tensor([S, S - 3], dtype=torch.int32)
    lg, c2 = eng.decode_once(staged, _clone(caches), tok, pos)
    _close(lg, want["decode"])
    _close_caches(c2, want["decode_caches"])
    gen, _ = eng.generate(staged, caches, tok, S, N)
    np.testing.assert_array_equal(gen.numpy(), want["generate"])
    logits, pools = _port_paged(eng, staged, chunks)
    for got, w in zip(logits, want["paged"]):
        _close(got, w)
    _close_caches(pools, want["paged_caches"])


@pytest.mark.parametrize("layout", LAYOUTS)
def test_pp_is_bitwise_the_single_stage_path(layout):
    """Same kernels, shapes and order per layer: the PP passes' logits and
    tokens are bit for bit ``Model``'s (t = 1) or ``TPModel``'s (t = 2)."""
    t, p, L = layout
    tcfg, eng, staged = _engine(t, p, L)
    _, _, _, tparams = _weights(L)
    toks, chunks = _inputs(tcfg)
    toks = torch.from_numpy(toks)
    if t == 1:
        ref, params = port_model(tcfg), tparams
    else:
        ref, params = TPModel(tcfg, t), shard_params(tcfg, tparams, t)
    want, want_cache, _ = ref.prefill(params, toks, W)
    got, caches = eng.prefill_with_cache(staged, toks, W)
    assert torch.equal(got, want)
    assert torch.equal(eng.forward(staged, toks), want)
    tok = want.argmax(-1).to(torch.int32)
    pos = torch.tensor([S, S - 3], dtype=torch.int32)
    got, _ = eng.decode_once(staged, _clone(caches), tok, pos)
    want_step, _ = ref.decode_step(params, _clone(want_cache), tok, pos)
    assert torch.equal(got, want_step)
    got, _ = eng.generate(staged, caches, tok, S, N)
    want_gen, _ = ref.decode_steps(params, want_cache, tok, S, N)
    assert torch.equal(got, want_gen)
    logits, _ = _port_paged(eng, staged, chunks)
    pools = ref.init_paged_cache(PAGES, PS, device="cpu")
    pos = np.zeros(B, np.int32)
    for chunk, got in zip(chunks, logits):
        want, pools = ref.paged_step(params, pools, torch.from_numpy(chunk),
                                     torch.from_numpy(pos),
                                     torch.from_numpy(BT))
        assert torch.equal(got, want)
        pos = pos + chunk.shape[1]


# ---------------------------------------------------------------------------
# communication against the closed forms
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("layout", LAYOUTS)
def test_transfers_match_comm_model(layout):
    """(p-1)·2 prefill transfers of [B, S, h/t] and (p-1)·2·(s_d-1) decode
    transfers of [B, 1, h/t], bytes at b = 4 (f32)."""
    t, p, L = layout
    tcfg, eng, staged = _engine(t, p, L)
    toks = torch.from_numpy(_inputs(tcfg)[0])
    logits, caches = eng.prefill_with_cache(staged, toks, W)
    eng.generate(staged, caches, logits.argmax(-1).to(torch.int32), S, N)
    s_d = N + 1                     # the prefill emits decoded token 1
    if t == 1:
        ops = cm.pp_comm_ops(tcfg, S, s_d, p, b=4, batch=B)
    else:
        ops = cm.hybrid_comm_ops(tcfg, S, s_d, t, p, b=4, batch=B,
                                 gather_mode="allgather")
    for phase in ("prefill", "decode"):
        want = [o for o in ops
                if o.collective == "send" and o.phase == phase]
        assert len(want) == 1
        got = eng.transfer_summary(phase)
        assert got == {"count": want[0].count,
                       "bytes": want[0].total_msg_bytes}
    rec = eng.transfers[-1]
    assert rec.shape == (B, 1, tcfg.d_model // t) and rec.dtype_bytes == 4


PASSES = [pytest.param(kind, quant, id=f"{quant or ''}{kind}")
          for kind, quant in (("prefill", None), ("decode", None),
                              ("paged-chunk", None), ("paged-decode", None),
                              ("decode", "int8"), ("decode", "int4"))]


@pytest.mark.parametrize("kind,quant", PASSES)
@pytest.mark.parametrize("layout", LAYOUTS)
def test_stage_comm_logs_match_hybrid_stage_collectives(layout, kind, quant):
    """Each stage's log over one pass: 2·L_s all-reduces (+1 embedding on
    stage 0), 2 boundary all-gathers on a receiving stage, the logits
    all-gather on the last; the quantized decode step's two-step halves;
    nothing at t = 1."""
    t, p, L = layout
    tcfg, eng, staged = _engine(t, p, L, quant_collectives=quant)
    toks, chunks = _inputs(tcfg)
    logits, caches = eng.prefill_with_cache(staged, torch.from_numpy(toks), W)
    tok = logits.argmax(-1).to(torch.int32)
    pools = eng.init_paged_cache(PAGES, PS)
    if kind == "paged-decode":
        eng.paged_pass(staged, pools, torch.from_numpy(chunks[0]),
                       torch.zeros(B, dtype=torch.int32),
                       torch.from_numpy(BT), "prefill")
    for m in eng.stages:
        m.group.log.clear()
    if kind == "prefill":
        eng.forward(staged, torch.from_numpy(toks))
        phase = "prefill"
    elif kind == "decode":
        eng.decode_once(staged, caches, tok, S)
        phase = "decode"
    else:
        chunk = chunks[0] if kind == "paged-chunk" else chunks[1]
        phase = "prefill" if kind == "paged-chunk" else "decode"
        pos = torch.full((B,), 0 if kind == "paged-chunk" else S,
                         dtype=torch.int32)
        eng.paged_pass(staged, pools, torch.from_numpy(chunk), pos,
                       torch.from_numpy(BT), phase)
    for s, m in enumerate(eng.stages):
        assert {r.phase for r in m.group.log} <= {phase}
        got = comm.counts_by_collective(m.group.summary(phase))
        assert got == cm.hybrid_stage_collectives(tcfg, t, p, s, phase=phase,
                                                  quant=quant), s


# ---------------------------------------------------------------------------
# quantized decode against JAX's quantized PP
# ---------------------------------------------------------------------------


def _teacher_forced(step_fn, cache, toks, start):
    rows = []
    for i in range(toks.shape[1]):
        logits, cache = step_fn(cache, toks[:, i], start + i)
        rows.append(np.asarray(logits, np.float32))
    return np.stack(rows)


@needs_mesh
@pytest.mark.parametrize("quant", ["int8", "fp8", "int4"])
def test_quantized_pp_decode_matches_jax(quant):
    t, p, L = 2, 2, 4
    jcfg, jparams, tcfg, _ = _weights(L)
    toks = _tokens(tcfg, (B, S))
    forced = _tokens(tcfg, (B, 12), seed=2)
    jeng = jpx.PipelineEngine(jcfg, t=t, p=p, quant_collectives=quant)
    jstaged = jeng.prepare(jparams)
    _, jcaches = jeng.prefill_with_cache(jstaged, jnp.asarray(toks),
                                         cache_w=W)
    want = _teacher_forced(
        lambda c, tok, i: jeng.decode_once(jstaged, c, jnp.asarray(tok),
                                           jnp.int32(i)),
        jcaches, forced, S)
    _, eng, staged = _engine(t, p, L, quant_collectives=quant)
    _, caches = eng.prefill_with_cache(staged, torch.from_numpy(toks), W)
    got = _teacher_forced(
        lambda c, tok, i: eng.decode_once(staged, c, torch.from_numpy(tok),
                                          i),
        caches, forced, S)
    match = float((got.argmax(-1) == want.argmax(-1)).mean())
    drift = float(np.abs(got - want).max())
    assert match >= 0.90, (match, drift)
    assert drift <= 0.25, (match, drift)


# ---------------------------------------------------------------------------
# what the engine refuses
# ---------------------------------------------------------------------------


def test_pipeline_engine_refuses_what_it_does_not_cover():
    cfg = port_config("llama32-3b").reduced()
    with pytest.raises(ValueError, match="c must be"):
        PipelineEngine(cfg, t=1, p=2, c=0, device="cpu")
    cp = PipelineEngine(cfg, t=1, p=2, c=2, device="cpu")
    with pytest.raises(ValueError, match="multiple of c"):
        cp.forward(cp.prepare(port_model(cfg).init(seed=0, device="cpu")),
                   torch.ones(1, 7, dtype=torch.int32))
    with pytest.raises(ValueError, match="tie_embeddings"):
        PipelineEngine(port_config("gemma-7b").reduced(), t=1, p=2,
                       device="cpu")
    with pytest.raises(ValueError, match="p must be"):
        PipelineEngine(cfg, t=1, p=3, device="cpu")
    with pytest.raises(ValueError, match="num_heads"):
        PipelineEngine(cfg, t=3, p=2, device="cpu")
    with pytest.raises(ValueError, match="unknown quant"):
        PipelineEngine(cfg, t=2, p=2, quant_collectives="int2", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            PipelineEngine(cfg, t=1, p=2)
    eng = PipelineEngine(cfg, t=1, p=2, device="cpu")
    with pytest.raises(ValueError, match="parameters on"):
        eng.prepare({"blocks": {"wq": torch.zeros(1, device="meta")}})
