"""The port's analytic tooling (sharding rules, input specs, the op-walk
cost counter, the roofline, ``make_serve_step``, the serve launcher)
against the JAX package, leaf by leaf.

  * ``runtime/sharding.py``: ``param_specs`` for every arch (axis size 16
    and None, and with ``moe_fsdp``), ``cache_specs`` on a 16x16 mesh
    (paligemma-3b's sequence-parallel fallback included), ``data_spec``
    and ``logits_spec`` on (data, model) and (pod, data, model), equal to
    JAX's entry for entry; ``shardings_from_specs`` as DTensor placements
    on a ``DeviceMesh`` of a fake process group;
  * ``launch/specs.py``: ``skip_reason`` on every arch x shape, and the
    meta stand-ins' shapes and types against JAX's ``eval_shape``;
  * ``core/roofline.py``: ``model_flops`` for every arch x shape, and
    ``analyze`` fed JAX's ``hlo_cost`` numerators and ``hlo_comm``
    collectives equal to JAX's ``roofline.analyze`` term for term;
  * ``core/op_cost.py``: the FLOPs of reduced forward passes and decode
    steps within 1% of ``hlo_cost.analyze_flops_bytes`` of JAX's compiled
    counterpart (bytes are printed, not held: XLA fuses and slices where
    the walk counts eager ops), both byte counts in closed form (the
    eager estimate and the compulsory traffic, of small functions, a
    decode step and a train step), every kernel site charged as one fused
    op (B1, ``add_rms_norm``, B2, B3, B4 and the paged chunk, the
    quantized all-reduce's passes);
  * ``make_serve_step`` and ``launch.serve.main`` against JAX's.

Everything runs on the CPU at reduced width, or on meta tensors at full
width (no allocation).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.config.base import INPUT_SHAPES as JAX_SHAPES  # noqa: E402
from repro.config.base import TPU_V5E as JAX_V5E  # noqa: E402
from repro.configs import ARCH_IDS  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.core import hlo_comm, hlo_cost  # noqa: E402
from repro.core import roofline as jax_roofline  # noqa: E402
from repro.launch import serve as jax_serve  # noqa: E402
from repro.launch import specs as jax_specs  # noqa: E402
from repro.models import moe as jax_moe  # noqa: E402
from repro.models.transformer import get_model as jax_model  # noqa: E402
from repro.runtime import engine as jax_engine  # noqa: E402
from repro.runtime import sharding as jax_sh  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.config.base import H100_NODE, INPUT_SHAPES, TPU_V5E  # noqa: E402
from repro_torch.configs import get_config as port_config  # noqa: E402
from repro_torch.core import op_cost, roofline  # noqa: E402
from repro_torch.core.comm import VirtualMesh  # noqa: E402
from repro_torch.launch import mesh as port_mesh  # noqa: E402
from repro_torch.launch import serve as port_serve  # noqa: E402
from repro_torch.launch import specs  # noqa: E402
from repro_torch.models import moe as port_moe  # noqa: E402
from repro_torch.models.transformer import get_model as port_model  # noqa: E402
from repro_torch.runtime import sharding as sh  # noqa: E402
from repro_torch.runtime.engine import InferenceEngine, make_serve_step  # noqa: E402

ASSIGNED = [a for a in ARCH_IDS if not a.startswith("llama")]
DECODERS = [a for a in ARCH_IDS if jax_config(a).is_decoder]


class _StandIn:
    """A mesh as JAX's sharding rules read it: only ``shape``."""

    def __init__(self, mesh):
        self.shape = dict(mesh.shape)


def _jax_shapes(cfg):
    return jax.eval_shape(lambda: jax_model(cfg).init(jax.random.PRNGKey(0)))


def _same_tree(port, ref, same, path=""):
    """Walk two trees of one layout, ``same(port_leaf, ref_leaf, path)``."""
    if isinstance(ref, dict):
        assert set(port) == set(ref), (path, set(port) ^ set(ref))
        for k in ref:
            _same_tree(port[k], ref[k], same, f"{path}/{k}")
        return
    same(port, ref, path)


def _same_spec(port, ref, path):
    assert isinstance(port, sh.P), path
    assert tuple(port) == tuple(ref), (path, port, ref)


# ---------------------------------------------------------------------------
# sharding rules
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fsdp", [False, True], ids=["", "fsdp"])
@pytest.mark.parametrize("axis_size", [16, None], ids=["16", "none"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_match_jax(arch, axis_size, fsdp):
    jcfg, tcfg = (dataclasses.replace(c, moe_fsdp=fsdp)
                  for c in (jax_config(arch), port_config(arch)))
    want = jax_sh.param_specs(jcfg, _jax_shapes(jcfg), axis_size=axis_size)
    params, _ = specs.param_sds(tcfg)
    _same_tree(sh.param_specs(tcfg, params, axis_size=axis_size), want,
               _same_spec)


@pytest.mark.parametrize("arch", DECODERS)
def test_cache_specs_match_jax(arch):
    """[L, B, W, Hkv, D] caches (and the ssm/hybrid states) on a 16x16
    mesh at decode_32k's batch: heads over ``model`` where they divide,
    else the cache length (paligemma-3b's one KV head)."""
    jcfg, tcfg = jax_config(arch), port_config(arch)
    mesh = port_mesh.make_production_mesh()
    B, S = 128, 32768
    jc = jax.eval_shape(lambda: jax_model(jcfg).init_cache(B, S))
    want = jax_sh.cache_specs(jcfg, _StandIn(mesh), B)(jc)
    tc = port_model(tcfg).init_cache(B, S, device="meta")
    got = sh.cache_specs(tcfg, mesh, B)(tc)
    _same_tree(got, want, _same_spec)
    if arch == "paligemma-3b":
        assert tuple(got["k"]) == (None, "data", "model", None, None)


@pytest.mark.parametrize("multi_pod", [False, True], ids=["pod", "2pods"])
def test_data_and_logits_specs_match_jax(multi_pod):
    mesh = port_mesh.make_production_mesh(multi_pod=multi_pod)
    assert mesh.shape == ({"pod": 2, "data": 16, "model": 16} if multi_pod
                          else {"data": 16, "model": 16})
    assert sh.batch_axes(mesh) == jax_sh.batch_axes(_StandIn(mesh))
    for B in (1, 8, 16, 32, 48, 128, 256, 512):
        for extra in (0, 1, 2):
            assert tuple(sh.data_spec(mesh, B, extra)) == tuple(
                jax_sh.data_spec(_StandIn(mesh), B, extra)), (B, extra)
        for seq in (False, True):
            assert tuple(sh.logits_spec(mesh, B, seq_dim=seq)) == tuple(
                jax_sh.logits_spec(_StandIn(mesh), B, seq_dim=seq)), (B, seq)


@pytest.fixture
def device_mesh():
    """A (data=2, model=4) ``DeviceMesh`` over a fake process group of 8
    ranks (no communication), torn down after the test."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
    try:
        yield init_device_mesh("cpu", (2, 4), mesh_dim_names=("data",
                                                              "model"))
    finally:
        dist.destroy_process_group()


def test_shardings_from_specs_are_dtensor_placements(device_mesh):
    """Each spec becomes one placement per mesh dim: ``Shard(d)`` where
    the tensor dim d carries the axis, else ``Replicate()``; a tensor
    distributed with them holds the block the spec names."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    cfg = dataclasses.replace(port_config("deepseek-moe-16b").reduced(),
                              moe_fsdp=True)
    params, _ = specs.param_sds(cfg)
    spec_tree = sh.param_specs(cfg, params, axis_size=4)
    placed = sh.shardings_from_specs(device_mesh, spec_tree)
    assert placed["blocks"]["wq"] == (Replicate(), Shard(2))
    assert placed["blocks"]["router"] == (Replicate(), Replicate())
    assert placed["embed"] == (Replicate(), Shard(0))
    assert placed["blocks"]["we2"] == (Shard(3), Shard(1))   # fsdp: h
    assert sh.placements(device_mesh, sh.P(("data", "model"), None)) == (
        Shard(0), Shard(0))
    w = torch.zeros(8, 12)
    local = distribute_tensor(w, device_mesh,
                              sh.placements(device_mesh, sh.P(None, "model")))
    assert tuple(local.to_local().shape) == (8, 3)


# ---------------------------------------------------------------------------
# input specs
# ---------------------------------------------------------------------------


def test_skip_matrix_matches_jax():
    """Every arch x shape skips as JAX's does: over the assigned archs 32
    live and 8 skipped (tests/test_sharding_specs.py)."""
    live = skipped = 0
    for a in ARCH_IDS:
        for name, shape in INPUT_SHAPES.items():
            got = specs.skip_reason(port_config(a), shape)
            assert got == jax_specs.skip_reason(jax_config(a),
                                                JAX_SHAPES[name]), (a, name)
            if a in ASSIGNED:
                live, skipped = live + (got is None), skipped + bool(got)
    assert (live, skipped) == (32, 8)


def _same_shape(port, ref, path):
    assert port.device.type == "meta", path
    assert tuple(port.shape) == tuple(ref.shape), path
    assert str(port.dtype).removeprefix("torch.") == str(ref.dtype), path


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_meta_stand_ins_match_jax_eval_shape(arch):
    """``param_sds``, ``batch_specs`` and ``decode_specs`` at full width
    for every live shape: shapes and types equal JAX's ``eval_shape``
    stand-ins, specs equal JAX's on the production mesh, nothing
    allocated (meta)."""
    jcfg, tcfg = jax_config(arch), port_config(arch)
    mesh = port_mesh.make_production_mesh()
    jparams, jspecs = jax_specs.param_sds(jcfg)
    params, pspecs = specs.param_sds(tcfg, mesh)
    _same_tree(params, jparams, _same_shape)
    _same_tree(pspecs, jax_sh.param_specs(jcfg, jparams, axis_size=16),
               _same_spec)
    for name, shape in INPUT_SHAPES.items():
        jshape = JAX_SHAPES[name]
        if specs.skip_reason(tcfg, shape):
            continue
        if shape.mode == "decode":
            (tok, pos, cache), (ts, ps, cs) = specs.decode_specs(
                tcfg, shape, mesh)
            jtok, jpos, jcache = jax_specs.decode_specs(jcfg, jshape, None)
            _same_tree({"tok": tok, "pos": pos, **cache},
                       {"tok": jtok, "pos": jpos, **jcache}, _same_shape)
            assert tuple(ts) == tuple(jax_sh.data_spec(
                _StandIn(mesh), shape.global_batch, 0)) and ps == ()
            _same_tree(cs, jax_sh.cache_specs(
                jcfg, _StandIn(mesh), shape.global_batch)(jcache), _same_spec)
            assert specs.decode_specs(tcfg, shape)[1] is None
        else:
            batch, bspecs = specs.batch_specs(tcfg, shape, mesh)
            jbatch, jbspecs = jax_specs.batch_specs(jcfg, jshape)
            _same_tree(batch, jbatch, _same_shape)
            for k, v in bspecs.items():
                assert tuple(v) == tuple(jax_sh.data_spec(
                    _StandIn(mesh), shape.global_batch,
                    len(batch[k].shape) - 1)), k


# ---------------------------------------------------------------------------
# roofline
# ---------------------------------------------------------------------------


def test_model_flops_match_jax():
    for a in ARCH_IDS:
        for name, shape in INPUT_SHAPES.items():
            assert roofline.model_flops(port_config(a), shape) == \
                jax_roofline.model_flops(jax_config(a), JAX_SHAPES[name])


@pytest.mark.parametrize("dp", [1, 2])
def test_analyze_matches_jax_term_for_term(dp):
    """A compiled program with collectives (JAX's expert-TP MoE layer on
    a (dp, 2) mesh): the port's ``analyze`` fed JAX's ``hlo_cost``
    numerators and ``hlo_comm`` collectives gives JAX's report, term for
    term, on the same hardware; the port's own comm log of the same
    layer gives the same collective term; the default is H100_NODE."""
    arch, shape_name = "deepseek-moe-16b", "prefill_32k"
    jcfg = jax_config(arch).reduced()
    tcfg = port_config(arch).reduced()
    params = jax_model(jcfg).init(jax.random.PRNGKey(0))
    layer = {k: v[0] for k, v in params["blocks"].items()}
    x = jnp.asarray(np.random.default_rng(0).standard_normal(
        (4, 16, jcfg.d_model)).astype(np.float32))
    jmesh = jax.make_mesh((dp, 2), ("data", "model"))
    compiled = jax.jit(lambda p, x: jax_moe.moe_ffn_local(
        jcfg, p, x, jmesh)).lower(layer, x).compile()
    text = compiled.as_text()
    want = jax_roofline.analyze(jcfg, JAX_SHAPES[shape_name], "dp", 4,
                                compiled.cost_analysis(), text, hw=JAX_V5E)
    flops, hbm = hlo_cost.analyze_flops_bytes(text)
    colls = hlo_comm.summarize(hlo_comm.parse_hlo_collectives(text))
    shape = INPUT_SHAPES[shape_name]
    got = roofline.analyze(tcfg, shape, "dp", 4, flops, hbm, colls,
                           hw=TPU_V5E)
    fields = ("flops_per_chip", "hbm_bytes_per_chip", "coll_bytes_per_chip",
              "compute_s", "memory_s", "collective_s", "model_flops_total",
              "useful_ratio")
    for f in fields:
        assert getattr(got, f) == pytest.approx(getattr(want, f), rel=1e-12), f
    assert got.dominant == want.dominant
    assert got.step_time_lower_bound == pytest.approx(
        want.step_time_lower_bound, rel=1e-12)
    assert got.row() == want.row()
    assert got.collectives == want.collectives

    mesh = VirtualMesh((dp, 2), ("data", "model"))
    tl = {k: torch.from_numpy(np.array(v)) for k, v in layer.items()}
    port_moe.moe_ffn_local(tcfg, tl, torch.from_numpy(np.array(x)), mesh)
    logged = roofline.analyze(tcfg, shape, "dp", 4, flops, hbm,
                              mesh.summary(), hw=TPU_V5E)
    # JAX's HLO also carries the aux all-reduce over a data group of one
    # device at dp = 1 (4 bytes, no wire bytes); the port logs no group of
    # one, so the wire term is the same
    assert logged.collective_s == pytest.approx(want.collective_s)
    default = roofline.analyze(tcfg, shape, "dp", 4, flops, hbm)
    assert default.memory_s == hbm / H100_NODE.hbm_bw
    assert default.collective_s == 0.0


# ---------------------------------------------------------------------------
# the op walk
# ---------------------------------------------------------------------------


def _walk_and_hlo(arch, kind):
    """(port Cost, JAX (flops, bytes)) of a reduced forward over [2, 48]
    tokens, or one decode step at 2 slots on a full 64-row cache (its
    last position: the kernel reads every row, as JAX's plain path
    does)."""
    jcfg, tcfg = jax_config(arch).reduced(), port_config(arch).reduced()
    jm, tm = jax_model(jcfg), port_model(tcfg, plain=True)
    jparams = _jax_shapes(jcfg)
    params, _ = specs.param_sds(tcfg)
    W = 64
    meta = dict(dtype=torch.int32, device="meta")
    if kind == "forward":
        text = jax.jit(jm.forward).lower(
            jparams, jax.ShapeDtypeStruct((2, 48), jnp.int32)).compile()
        with torch.no_grad():
            cost = op_cost.count(tm.forward, params, torch.empty(2, 48,
                                                                 **meta))
    else:
        cache = jax.eval_shape(lambda: jm.init_cache(2, W))
        text = jax.jit(jm.decode_step).lower(
            jparams, cache, jax.ShapeDtypeStruct((2,), jnp.int32),
            jax.ShapeDtypeStruct((), jnp.int32)).compile()
        with torch.no_grad():
            cost = op_cost.count(
                tm.decode_step, params, tm.init_cache(2, W, device="meta"),
                torch.empty(2, **meta), W - 1, kv_rows=W)
    return cost, hlo_cost.analyze_flops_bytes(text.as_text())


@pytest.mark.parametrize("kind", ["forward", "decode"])
@pytest.mark.parametrize("arch", ["llama32-3b", "deepseek-moe-16b",
                                  "rwkv6-7b", "hymba-1.5b"])
def test_op_cost_flops_match_hlo_cost(arch, kind):
    """The walk's FLOPs within 1% of JAX's compiled counterpart's (the
    dense, moe and ssm families agree exactly; hymba's ~0.1% gap are
    small dots XLA writes differently).  Bytes are printed."""
    cost, (flops, hbm) = _walk_and_hlo(arch, kind)
    print(f"{arch} {kind}: flops port {cost.flops:.6g} jax {flops:.6g}; "
          f"bytes port {cost.bytes:.6g} jax {hbm:.6g}")
    assert cost.flops == pytest.approx(flops, rel=0.01)


def test_op_cost_charges_kernel_sites_as_fused_ops(monkeypatch):
    """At full width on meta: a 333-token llama32-3b prefill charges B2
    its q, k, v and output only (no score or softmax op appears), the
    norms once a site, and a decode step reads ``kv_rows`` rows of the
    ring; no kernel wrapper is reached, and the kernel path itself
    refuses meta tensors."""
    from repro_torch.models import blocks, layers

    def refuse(*a, **k):
        raise AssertionError("the walk reached a kernel wrapper")
    for lib, name in ((layers, "rms_norm"), (layers, "add_rms_norm"),
                      (blocks, "flash_attention"),
                      (blocks, "decode_attention")):
        monkeypatch.setattr(lib, name, refuse)
    cfg = port_config("llama32-3b")
    L, S = cfg.num_layers, 333
    params, _ = specs.param_sds(cfg)
    model = port_model(cfg, plain=True)
    with torch.no_grad():
        cost = op_cost.count(model.prefill, params,
                             torch.empty(1, S, dtype=torch.int32,
                                         device="meta"), 1024)
    calls, flops, nbytes = cost.ops["flash_attention"]
    D, Hq, Hkv = cfg.head_dim, cfg.num_heads, cfg.num_kv_heads
    assert calls == L
    assert nbytes == L * 2 * S * D * (2 * Hq + 2 * Hkv)
    assert flops == L * 4 * Hq * S * S * D
    assert "_softmax" not in cost.ops and "bmm" not in cost.ops
    # layer 0's ln1 a B1, every other norm site an add_rms_norm (the
    # final norm closes the last layer's residual add): the launch formula
    assert cost.ops["rmsnorm"][0] == 1
    assert cost.ops["add_rms_norm"][0] == 2 * L
    cache = model.init_cache(4, 1024, device="meta")
    with torch.no_grad():
        dec = op_cost.count(model.decode_step, params, cache,
                            torch.empty(4, dtype=torch.int32, device="meta"),
                            130, kv_rows=131)
    calls, _, nbytes = dec.ops["decode_attention"]
    assert calls == L
    assert nbytes == L * 2 * 4 * D * (2 * Hq + 2 * 131 * Hkv)
    monkeypatch.undo()
    with pytest.raises(Exception, match="meta"):
        port_model(cfg).prefill(params, torch.empty(1, S, dtype=torch.int32,
                                                    device="meta"), 1024)


_META = dict(device="meta")


def _nb(t):
    return t.numel() * t.element_size()


def _leaves(tree):
    return [t for t in torch.utils._pytree.tree_flatten(tree)[0]
            if isinstance(t, torch.Tensor)]


# (function, its arguments on meta, the compulsory bytes, the eager bytes)
_TRAFFIC_CASES = {
    # a dot: both operands read, the result written
    "mm": (lambda a, b: a @ b,
           lambda: (torch.empty(8, 16, **_META), torch.empty(16, 4, **_META)),
           (8 * 16 + 16 * 4 + 8 * 4) * 4, (8 * 16 + 16 * 4 + 8 * 4) * 4),
    # in place: the target read and written once, the other operand read
    "add_": (lambda x, y: x.add_(y),
             lambda: (torch.empty(10, 10, **_META),
                      torch.empty(10, 10, **_META)), 3 * 400, 3 * 400),
    # an eager chain: its temporaries are free, the scalar result written
    "chain": (lambda x: ((x * 2) + 1).sum(),
              lambda: (torch.empty(10, 10, **_META),), 400 + 4,
              2 * 400 + 2 * 400 + 400 + 4),
    # a gather reads the rows it takes and the indices
    "gather": (lambda t, i: t[i] * 1,
               lambda: (torch.empty(100, 8, **_META),
                        torch.empty(3, dtype=torch.long, **_META)),
               3 * 32 + 24 + 3 * 32, 2 * 3 * 32 + 3 * 32 * 2),
    # a fill writes its result, nothing else
    "zeros": (lambda: torch.zeros(10, 10, **_META), lambda: (), 400, 400),
    "zero_": (lambda x: x.zero_(), lambda: (torch.empty(10, 10, **_META),),
              400, 400),
    # a column slice reads its own rows' bytes once
    "slice": (lambda x: x[:, :3].sum(),
              lambda: (torch.empty(10, 10, **_META),), 10 * 3 * 4 + 4,
              10 * 3 * 4 + 4),
}


@pytest.mark.parametrize("case", sorted(_TRAFFIC_CASES))
def test_op_cost_traffic_closed_forms(case):
    """Both byte counts of small functions in closed form: the eager
    estimate counts every op's operands and result (a fill its result),
    the compulsory traffic each pre-existing tensor once in the extent
    touched and each returned tensor the step made."""
    fn, args, compulsory, eager = _TRAFFIC_CASES[case]
    cost = op_cost.count(fn, *args())
    assert (cost.min_bytes, cost.bytes) == (compulsory, eager)


def test_op_cost_compulsory_traffic_of_a_decode_step():
    """A reduced llama32-3b decode step: every weight read once (the
    embedding's B rows only), the tokens, each sequence's ``kv_rows``
    valid K/V rows read and one row written a layer, the logits written;
    nothing of the activations."""
    cfg = port_config("llama32-3b").reduced()
    params, _ = specs.param_sds(cfg)
    model = port_model(cfg, plain=True)
    B, W, pos = 2, 64, 10
    cache = model.init_cache(B, W, device="meta")
    tok = torch.empty(B, dtype=torch.int32, **_META)
    with torch.no_grad():
        cost = op_cost.count(model.decode_step, params, cache, tok, pos,
                             kv_rows=pos + 1)
    L, Hkv, D = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim
    es = cache["k"].element_size()
    embed = params["embed"]
    weights = sum(_nb(t) for t in _leaves(params)) - _nb(embed) \
        + B * embed.shape[1] * embed.element_size()
    kv = 2 * L * B * (pos + 1 + 1) * Hkv * D * es
    logits = B * cfg.vocab_size * 4
    assert cost.min_bytes == weights + _nb(tok) + kv + logits
    assert cost.min_bytes < cost.bytes


def test_op_cost_compulsory_traffic_of_a_train_step():
    """A reduced llama32-3b train step: the weights and both AdamW
    moments read and written once each, the gradients free (made and
    dropped inside the step); the eager estimate counts the optimizer's
    chain op by op, several times that."""
    from repro_torch.optim.adamw import AdamW
    from repro_torch.runtime import train
    cfg = port_config("llama32-3b").reduced()
    params, _ = specs.param_sds(cfg)
    opt = AdamW()
    state = opt.init(params)
    batch = {"tokens": torch.empty(2, 16, dtype=torch.int32, **_META)}
    step = train.make_train_step(port_model(cfg, plain=True), opt,
                                 device="meta")
    cost = op_cost.count(step, params, state, batch)
    floor = 2 * sum(_nb(t) for t in _leaves((params, state)))
    assert floor <= cost.min_bytes <= floor + 4096
    assert cost.bytes > 5 * cost.min_bytes


def test_op_cost_charges_paged_and_quantized_sites(monkeypatch):
    """The paged branch is B4 at one token (its block table and each
    sequence's valid page rows, no gather) and ``paged_gather`` then B2 on
    a longer chunk; the quantized all-reduce's passes are one row each,
    as ``kernels._build`` counts the kernels.  No kernel wrapper is
    reached."""
    from repro_torch.core import parallel_exec
    from repro_torch.core.parallel_exec import TPModel, shard_params
    from repro_torch.models import blocks

    def refuse(*a, **k):
        raise AssertionError("the walk reached a kernel wrapper")
    for name in ("flash_attention", "decode_attention",
                 "paged_decode_attention"):
        monkeypatch.setattr(blocks, name, refuse)
    monkeypatch.setattr(parallel_exec, "_KERNEL_OPS", None)
    cfg = port_config("llama32-3b").reduced()
    L, Hq, Hkv, D = (cfg.num_layers, cfg.num_heads, cfg.num_kv_heads,
                     cfg.head_dim)
    params, _ = specs.param_sds(cfg)
    model = port_model(cfg, plain=True)
    B, P, ps, blocks_per_seq, pos = 2, 9, 16, 4, 20
    cache = model.init_paged_cache(P, ps, device="meta")
    table = torch.empty(B, blocks_per_seq, dtype=torch.int32, **_META)
    es = cache["k"].element_size()
    with torch.no_grad():
        dec = op_cost.count(model.paged_step, params, cache,
                            torch.empty(B, 1, dtype=torch.int32, **_META),
                            torch.empty(B, dtype=torch.int32, **_META),
                            table, kv_rows=pos + 1)
        chunk = op_cost.count(model.paged_step, params, cache,
                              torch.empty(B, 8, dtype=torch.int32, **_META),
                              torch.empty(B, dtype=torch.int32, **_META),
                              table)
    calls, _, nbytes = dec.ops["paged_decode_attention"]
    assert calls == L
    assert nbytes == L * (2 * B * Hq * D * es + _nb(table)
                          + 2 * B * (pos + 1) * Hkv * D * es)
    assert "paged_gather" not in dec.ops and "decode_attention" not in \
        dec.ops and "flash_attention" not in dec.ops
    gathered = 2 * B * blocks_per_seq * ps * Hkv * D * es
    assert chunk.ops["paged_gather"][0] == L
    assert chunk.ops["paged_gather"][2] == L * (2 * gathered + _nb(table))
    assert chunk.ops["flash_attention"][0] == L
    assert chunk.ops["flash_attention"][2] == L * (
        2 * B * 8 * Hq * D * es + gathered)
    t = 2
    rparams = shard_params(cfg, params, t)
    tok = torch.empty(B, dtype=torch.int32, **_META)
    for quant, sites in (("int8", ("chunk_amax", "chunk_quantize",
                                   "dequantize_add_rms_norm")),
                         ("int4", ("chunk_amax", "chunk_quantize_pack",
                                   "nibble_reduce_requant",
                                   "nibble_unpack_dequantize"))):
        tp = TPModel(cfg, t, quant=quant, plain=True)
        with torch.no_grad():
            cost = op_cost.count(tp.tp_decode_step, rparams,
                                 tp.init_cache(B, 64, device="meta"), tok,
                                 10, kv_rows=11)
        for name in sites:
            assert name in cost.ops, (quant, name)
        assert "abs" not in cost.ops and "round" not in cost.ops, quant


# ---------------------------------------------------------------------------
# make_serve_step and the serve launcher
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["llama32-3b", "deepseek-moe-16b",
                                  "rwkv6-7b"])
def test_serve_step_tokens_equal_jax(arch):
    """Six ``make_serve_step`` steps after a 10-token prefill, on bridged
    weights: every step's tokens equal JAX's."""
    jcfg, tcfg = jax_config(arch).reduced(), port_config(arch).reduced()
    jparams = jax_model(jcfg).init(jax.random.PRNGKey(0))
    params = bridge.params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                                    device="cpu")
    toks = np.random.default_rng(3).integers(
        2, jcfg.vocab_size, (2, 10)).astype(np.int32)
    jm, tm = jax_model(jcfg), port_model(tcfg)
    logits, jcache, _ = jax.jit(jm.prefill, static_argnames=("max_len",))(
        jparams, jnp.asarray(toks), max_len=32)
    jtok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
    jstep = jax.jit(jax_engine.make_serve_step(jm))
    logits, cache, pos = tm.prefill(params, torch.from_numpy(toks), 32)
    tok = torch.argmax(logits, dim=-1).to(torch.int32)
    step = make_serve_step(tm)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
    for i in range(6):
        jtok, jcache = jstep(jparams, jcache, jtok, jnp.int32(10 + i))
        tok, cache = step(params, cache, tok, pos + i)
        assert tok.dtype == torch.int32
        np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))


@pytest.mark.parametrize("arch", ["granite-8b", "paligemma-3b",
                                  "hubert-xlarge"])
def test_serve_launcher_draws_jax_inputs(arch, monkeypatch, capsys):
    """``launch.serve.main`` on a reduced config on the CPU: its prompts
    (the vlm's prefix embeddings, the encoder's frames) are the arrays
    JAX's launcher draws from the same seed, and its tokens are the
    port's engine's on ``Model.init(seed)``'s weights."""
    argv = ["--arch", arch, "--reduced", "--batch", "3", "--prompt-len",
            "12", "--new-tokens", "5", "--seed", "7"]
    seen = {}

    def generate(self, tokens, max_new_tokens=32, prefix_emb=None):
        seen.update(tokens=np.asarray(tokens), prefix=prefix_emb)
        return jnp.zeros((tokens.shape[0], max_new_tokens), jnp.int32)

    def encode(self, features):
        seen.update(features=np.asarray(features))
        return jnp.zeros((1,))
    monkeypatch.setattr(jax_engine.InferenceEngine, "generate", generate)
    monkeypatch.setattr(jax_engine.InferenceEngine, "encode", encode)
    jax_serve.main(argv)
    inputs, out = port_serve.main(argv + ["--device", "cpu"])
    cfg = port_config(arch).reduced()
    params = port_model(cfg).init(seed=7, device="cpu")
    engine = InferenceEngine(cfg, params, max_len=12 + 5 +
                             cfg.num_prefix_tokens + 8, device="cpu")
    printed = capsys.readouterr().out
    if cfg.family == "encoder":
        np.testing.assert_array_equal(inputs.numpy(), seen["features"])
        torch.testing.assert_close(out, engine.encode(inputs))
        assert "encoded (3, 12, " in printed
        return
    np.testing.assert_array_equal(inputs.numpy(), seen["tokens"])
    kw = {}
    if cfg.family == "vlm":
        rng = np.random.default_rng(7)
        rng.integers(2, cfg.vocab_size, (3, 12))
        prefix = torch.from_numpy(rng.standard_normal(
            (3, cfg.num_prefix_tokens, cfg.d_model))).float() * 0.02
        np.testing.assert_array_equal(prefix.numpy(),
                                      np.asarray(seen["prefix"]))
        kw["prefix_emb"] = prefix
    want = engine.generate(inputs, max_new_tokens=5, **kw)
    assert torch.equal(out, want)
    assert f"first sequence: {want[0].tolist()}" in printed


def test_serve_step_shape_on_meta():
    """``make_serve_step`` walks at full width on meta: the decode_32k
    stand-ins of llama32-3b (no allocation), its FLOPs 2·N·B plus the
    attention dots over the 32768-row cache."""
    cfg = port_config("llama32-3b")
    shape = INPUT_SHAPES["decode_32k"]
    params, _ = specs.param_sds(cfg)
    (tok, pos, cache), _ = specs.decode_specs(cfg, shape)
    step = make_serve_step(port_model(cfg, plain=True))
    with torch.no_grad():
        cost = op_cost.count(step, params, cache, tok, 1)
    B, S = shape.global_batch, shape.seq_len
    attn = 4 * B * cfg.num_heads * S * cfg.head_dim * cfg.num_layers
    dots = 2 * B * (sum(v.numel() for v in params["blocks"].values()
                        if v.dim() == 3) + params["lm_head"].numel())
    assert cost.flops == dots + attn
