"""The residual add fused into the norm after it, against the JAX package.

On the card ``add_rms_norm`` (B1 with the add before it) and
``dequantize_add_rms_norm`` (B9, the add and B1, on the int8/fp8 wire)
each run one kernel; the model trunks carry the residual stream beside
each block's output, as (h, x), so every residual add runs inside the norm
site after it.  Here, on the CPU:

* ``add_rms_norm_ref``: s is bitwise JAX's x + y, and n agrees with
  ``rms_norm_pallas(s, interpret=True)``;
* ``dequantize_add_rms_norm_ref`` (int8, fp8): s is bitwise JAX's
  ``chunk_dequantize_pallas(interpret=True)`` -> + x, and n agrees with
  ``rms_norm_pallas`` of it;
* the carried trunk equals the unfused chain (add, then norm) bit for bit:
  ``Model`` dense (prefill, decode, a paged chunk and a paged decode step)
  and ssm in f32 and bf16, and ``TPModel`` at t = 2 and 4 (prefill, then a
  decode step unquantized and int8/fp8/int4), whose comm log still equals
  ``commodel.comm_ops_for``.

Tolerances for n: f32 2e-5 absolute and relative (the B1 tolerance of
``test_torch_kernels.py``: the frameworks sum the squares in another
order); bf16 1e-2, one rounding of the output on each side (2^-8
relative).  Inputs are made with numpy from a seed; h is 256 or 3072 over
odd row counts.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.quant_collective.quant_kernel import \
    chunk_dequantize_pallas  # noqa: E402
from repro.kernels.rmsnorm.rmsnorm_kernel import rms_norm_pallas  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import comm  # noqa: E402
from repro_torch.core import parallel_exec as px  # noqa: E402
from repro_torch.core.commodel import comm_ops_for  # noqa: E402
from repro_torch.kernels.quant_collective import ops as qops  # noqa: E402
from repro_torch.kernels.quant_collective import ref as qref  # noqa: E402
from repro_torch.kernels.rmsnorm import ref as rref  # noqa: E402
from repro_torch.models import blocks, layers, ssm  # noqa: E402
from repro_torch.models.transformer import Model  # noqa: E402

DTYPES = [pytest.param((jnp.float32, torch.float32, 2e-5), id="f32"),
          pytest.param((jnp.bfloat16, torch.bfloat16, 1e-2), id="bf16")]
SHAPES = [pytest.param((3, 256), id="3x256"),
          pytest.param((5, 3072), id="5x3072"),
          pytest.param((3, 1, 256), id="3x1x256")]


def _bits(a):
    """Raw bytes of a numpy array or a torch tensor, for bitwise checks."""
    if isinstance(a, torch.Tensor):
        a = a.contiguous()
        if a.dtype == torch.bfloat16:
            a = a.view(torch.int16)
        return a.view(torch.uint8).numpy() if a.element_size() == 1 \
            else a.numpy().view(np.uint8)
    return np.ascontiguousarray(a).view(np.uint8)


def _pair(a, jdt, tdt):
    """The same values (the same bits in bf16) in JAX and in torch."""
    aj = jnp.asarray(a).astype(jdt)
    at = torch.from_numpy(np.asarray(a)).to(tdt)
    assert np.array_equal(_bits(np.asarray(aj)), _bits(at))
    return aj, at


def _f32(a):
    return np.asarray(a.float() if isinstance(a, torch.Tensor)
                      else jnp.asarray(a, jnp.float32))


# ---------------------------------------------------------------------------
# the plain versions against JAX
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtypes", DTYPES)
@pytest.mark.parametrize("shape", SHAPES)
def test_add_rms_norm_plain_matches_jax(shape, dtypes):
    jdt, tdt, tol = dtypes
    rng = np.random.default_rng(sum(shape))
    (xj, xt), (yj, yt) = (_pair(rng.standard_normal(shape), jdt, tdt)
                          for _ in range(2))
    wj, wt = _pair(0.1 * rng.standard_normal(shape[-1:]), jdt, tdt)
    s, n = rref.add_rms_norm_ref(xt, yt, wt)
    sj = xj + yj
    np.testing.assert_array_equal(_bits(s), _bits(np.asarray(sj)))
    want = rms_norm_pallas(sj, wj, interpret=True)
    np.testing.assert_allclose(_f32(n), _f32(want), atol=tol, rtol=tol)


def _wire(rng, shape, chunk, quant):
    """A gathered payload on the grid of ``quant`` (int8 |q| <= 127, fp8
    values from e4m3's range) and positive f32 scales [..., K]."""
    k = -(-shape[-1] // chunk)
    scales = (np.abs(rng.standard_normal((*shape[:-1], k))) / 40.0
              + 1e-3).astype(np.float32)
    if quant == "int8":
        q = rng.integers(-127, 128, shape).astype(np.int8)
        return jnp.asarray(q), torch.from_numpy(q), scales
    qj = jnp.asarray(100.0 * rng.standard_normal(shape),
                     jnp.float32).astype(jnp.float8_e4m3fn)
    qt = torch.from_numpy(np.array(qj.astype(jnp.float32))).to(
        torch.float8_e4m3fn)
    assert np.array_equal(_bits(np.asarray(qj)), _bits(qt))
    return qj, qt, scales


@pytest.mark.parametrize("quant", ["int8", "fp8"])
@pytest.mark.parametrize("dtypes", DTYPES)
@pytest.mark.parametrize("shape,chunk", [
    pytest.param((3, 256), 128, id="3x256-c128"),
    pytest.param((5, 3072), 128, id="5x3072-c128"),
    pytest.param((3, 1, 200), 25, id="3x1x200-c25")])
def test_dequantize_add_rms_norm_plain_matches_jax(shape, chunk, dtypes,
                                                   quant):
    jdt, tdt, tol = dtypes
    rng = np.random.default_rng(shape[-1] + chunk)
    qj, qt, scales = _wire(rng, shape, chunk, quant)
    xj, xt = _pair(rng.standard_normal(shape), jdt, tdt)
    wj, wt = _pair(0.1 * rng.standard_normal(shape[-1:]), jdt, tdt)
    s, n = qref.dequantize_add_rms_norm_ref(qt, torch.from_numpy(scales),
                                            chunk, xt, wt)
    sj = xj + chunk_dequantize_pallas(qj, jnp.asarray(scales), chunk=chunk,
                                      out_dtype=jdt, interpret=True)
    np.testing.assert_array_equal(_bits(s), _bits(np.asarray(sj)))
    want = rms_norm_pallas(sj, wj, interpret=True)
    np.testing.assert_allclose(_f32(n), _f32(want), atol=tol, rtol=tol)


@pytest.mark.parametrize("quant", ["int8", "fp8"])
def test_gathered_sum_add_norm_equals_the_unfused_chain(quant):
    """quantized_psum's gathered form, dequantized inside the norm, equals
    quantized_psum (B9) -> + x -> rms_norm, bit for bit, with the same comm
    log; the dispatcher on CPU tensors is the plain version."""
    rng = np.random.default_rng(3)
    t, h = 4, 256
    xs = [torch.from_numpy(rng.standard_normal((3, 1, h))).to(torch.bfloat16)
          for _ in range(t)]
    x = torch.from_numpy(rng.standard_normal((3, 1, h))).to(torch.bfloat16)
    w = torch.from_numpy(0.1 * rng.standard_normal(h)).to(torch.bfloat16)
    fused_group, chain_group = comm.VirtualGroup(t), comm.VirtualGroup(t)
    gathered = px.quantized_psum_gathered(xs, fused_group, quant, 64)
    assert isinstance(gathered, px.GatheredSum)
    s, n = gathered.add_norm(x, w, 1e-5)
    want_s = x + px.quantized_psum(xs, chain_group, quant, 64)
    assert torch.equal(s.view(torch.int16), want_s.view(torch.int16))
    want_n = rref.rms_norm_ref(want_s, w)
    assert torch.equal(n.view(torch.int16), want_n.view(torch.int16))
    got = qops.dequantize_add_rms_norm(gathered.q, gathered.scales, 64, x, w)
    assert torch.equal(got[1].view(torch.int16), want_n.view(torch.int16))
    assert comm.fold(fused_group.summary()) == comm.fold(chain_group.summary())


# ---------------------------------------------------------------------------
# the carried trunk against the unfused chain, bit for bit
# ---------------------------------------------------------------------------


def _same(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(got, want), float((got.float() - want.float()).abs()
                                         .max())


def _unfused_dense_block(cfg, p, x, positions, **kw):
    """The dense layer as the JAX package writes it: norm, attention, add,
    norm, MLP, add (the kernels' CPU dispatch for the attention)."""
    xn = rref.rms_norm_ref(x, p["ln1"], cfg.norm_eps)
    attn, cache = blocks.attention_apply(cfg, p, xn, positions, **kw)
    x = x + attn @ p["wo"]
    xn2 = rref.rms_norm_ref(x, p["ln2"], cfg.norm_eps)
    return x + layers.mlp_apply(p, xn2, cfg.activation), cache


def _unfused_head(model, params, x):
    """The final norm and head on the whole residual stream's last row."""
    cfg = model.cfg
    xn = rref.rms_norm_ref(x[:, -1:].contiguous(), params["final_norm"],
                           cfg.norm_eps)
    logits = xn @ params["lm_head"]
    if cfg.padded_vocab != cfg.vocab_size:
        col = torch.arange(cfg.padded_vocab)
        logits = torch.where(col < cfg.vocab_size, logits,
                             torch.finfo(logits.dtype).min)
    return logits[:, 0]


def _unfused(model, params, tokens, positions, block, **kw):
    x = model._embed(params, tokens)
    caches = []
    for l in range(model.cfg.num_layers):
        layer_kw = {k: (v(l) if callable(v) else v) for k, v in kw.items()}
        x, c = block(model.cfg, model._layer(params, l), x, positions,
                     **layer_kw)
        caches.append(c)
    return _unfused_head(model, params, x), caches


def _cfg(arch, dtype):
    return dataclasses.replace(get_config(arch).reduced(), dtype=dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dense_trunk_equals_unfused_chain(dtype):
    cfg = _cfg("llama32-3b", dtype)
    model = Model(cfg)
    params = model.init(seed=0, device="cpu")
    rng = np.random.default_rng(1)
    B, S, W = 3, 9, 16
    tokens = torch.from_numpy(rng.integers(2, cfg.vocab_size, (B, S)))
    positions = torch.arange(S).expand(B, S)
    # prefill: logits and the built ring caches
    logits, cache, _ = model.prefill(params, tokens, W)
    want, built = _unfused(model, params, tokens, positions,
                           _unfused_dense_block, build_cache_w=W)
    _same(logits, want)
    for l, c in enumerate(built):
        _same(cache["k"][l], c["k"])
        _same(cache["v"][l], c["v"])
    # a decode step against copies of that cache
    ref_cache = {k: v.clone() for k, v in cache.items()}
    tok = logits.argmax(-1).to(torch.int32)
    logits, cache = model.decode_step(params, cache, tok, S)
    step_pos = layers.decode_positions(torch.as_tensor(S), B)
    want, _ = _unfused(model, params, tok[:, None], step_pos,
                       _unfused_dense_block, pos=torch.as_tensor(S),
                       cache=lambda l: {k: v[l] for k, v in ref_cache.items()})
    _same(logits, want)
    _same(cache["k"], ref_cache["k"])
    # a paged chunk, then a paged decode step
    ps = 4
    pages = model.init_paged_cache(1 + B * 4, ps, device="cpu")
    ref_pages = {k: v.clone() for k, v in pages.items()}
    table = torch.arange(1, 1 + B * 4, dtype=torch.int32).reshape(B, 4)
    pos = torch.zeros(B, dtype=torch.int32)
    for toks, p in ((tokens, pos), (tok[:, None], pos + S)):
        logits, pages = model.paged_step(params, pages, toks, p, table)
        n = toks.shape[1]
        want, _ = _unfused(
            model, params, toks, p[:, None].long() + torch.arange(n),
            _unfused_dense_block, pos=p, block_table=table,
            cache=lambda l: {k: v[l] for k, v in ref_pages.items()})
        _same(logits, want)
        _same(pages["k"], ref_pages["k"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssm_trunk_equals_unfused_chain(dtype):
    """RWKV-6: the carried trunk against ``ssm_block_apply`` called without
    ``carry`` (each layer closing its own adds), prefill then decode."""
    cfg = _cfg("rwkv6-7b", dtype)
    model = Model(cfg)
    params = model.init(seed=0, device="cpu")
    rng = np.random.default_rng(2)
    B, S = 3, 7
    tokens = torch.from_numpy(rng.integers(2, cfg.vocab_size, (B, S)))
    positions = torch.arange(S).expand(B, S)
    logits, cache, _ = model.prefill(params, tokens, 16)
    want, built = _unfused(model, params, tokens, positions,
                           ssm.ssm_block_apply, build_cache_w=16)
    _same(logits, want)
    for l, c in enumerate(built):
        for key in ("state", "tm_prev", "cm_prev"):
            _same(cache[key][l], c[key])
    ref_cache = {k: v.clone() for k, v in cache.items()}
    tok = logits.argmax(-1).to(torch.int32)
    logits, cache = model.decode_step(params, cache, tok, S)
    want, _ = _unfused(model, params, tok[:, None], positions[:, :1],
                       ssm.ssm_block_apply,
                       cache=lambda l: {k: v[l] for k, v in ref_cache.items()})
    _same(logits, want)
    for key in ("state", "tm_prev", "cm_prev"):
        _same(cache[key], ref_cache[key])


def _unfused_tp_pass(model, params, tokens, positions, quant, caches,
                     cache_w=None, pos=None, phase="decode"):
    """The TP pass as the JAX engine writes it, on its own VirtualGroup:
    each all-reduce (``quantized_psum``, B9 at its end) added to the
    residual stream, then the next norm.  Returns (logits, group)."""
    cfg, t = model.cfg, model.t
    group = comm.VirtualGroup(t)
    eps = cfg.norm_eps
    with group.phase(phase):
        x = px._vocab_parallel_embed([p["embed"] for p in params], tokens,
                                     group)
        for l in range(cfg.num_layers):
            pls = [px._layer_slice(p["blocks"], l) for p in params]
            xn = rref.rms_norm_ref(x, pls[0]["ln1"], eps)
            attns = []
            for r, p in enumerate(pls):
                cache = None if caches is None else \
                    {k: caches[r][k][l] for k in ("k", "v")}
                a, built = blocks.attention_apply(
                    cfg, p, xn, positions, cache=cache, pos=pos,
                    build_cache_w=cache_w, plain=model.plain,
                    num_heads=model.heads_t, num_kv_heads=model.kv_t)
                attns.append(a)
            x = x + px.quantized_psum([a @ p["wo"] for a, p in
                                       zip(attns, pls)], group, quant,
                                      model.quant_chunk, model.plain)
            xn2 = rref.rms_norm_ref(x, pls[0]["ln2"], eps)
            x = x + px.quantized_psum(
                [layers.mlp_apply(p, xn2, cfg.activation) for p in pls],
                group, quant, model.quant_chunk, model.plain)
        xn = rref.rms_norm_ref(x[:, -1].contiguous(),
                               params[0]["final_norm"], eps)
        logits = group.all_gather([xn @ p["lm_head"] for p in params])
    return px._mask_pad_vocab(logits, cfg.vocab_size), group


@pytest.mark.parametrize("quant", [None, "int8", "fp8", "int4"])
@pytest.mark.parametrize("t", [2, 4])
def test_tp_trunk_equals_unfused_chain(t, quant):
    cfg = _cfg("llama32-3b", "bfloat16")
    if t == 2:
        cfg = dataclasses.replace(cfg, num_kv_heads=2)
    model = px.TPModel(cfg, t, quant=quant)
    params = model.init(seed=0, device="cpu")
    rng = np.random.default_rng(t)
    B, S, W = 3, 8, 16
    tokens = torch.from_numpy(rng.integers(2, cfg.vocab_size, (B, S)))
    logits, cache = model.tp_prefill(params, tokens, W)
    want, pre_group = _unfused_tp_pass(model, params, tokens,
                                       torch.arange(S).expand(B, S), None,
                                       None, cache_w=W, phase="prefill")
    _same(logits, want)
    ref_cache = [{k: v.clone() for k, v in c.items()} for c in cache]
    tok = logits.argmax(-1).to(torch.int32)
    logits, cache = model.tp_decode_step(params, cache, tok, S)
    pos = torch.as_tensor(S)
    want, step_group = _unfused_tp_pass(
        model, params, tok[:, None], layers.decode_positions(pos, B), quant,
        ref_cache, pos=pos)
    _same(logits, want)
    for c, r in zip(cache, ref_cache):
        _same(c["k"], r["k"])
    log = model.group.summary()
    assert comm.fold(log) == comm.fold(pre_group.summary() +
                                       step_group.summary())
    assert comm.fold(log) == comm.fold(comm_ops_for(
        cfg, S, 2, t, batch=B, b=2, gather_mode="allgather", quant=quant))
