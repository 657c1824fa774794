"""The PyTorch port's model and engine against the JAX package.

Weights come from the JAX package's ``Model.init`` and cross over through
numpy (``repro_torch.bridge``); tokens are made with numpy from a seed.
Reduced llama32-3b in float32, and its num_kv_heads=2 variant (the reduced
config has one query head per KV head, so it would not exercise GQA).
Logit tolerance: 1e-4 absolute and relative — the two frameworks sum the
same f32 products in another order (observed differences ~3e-6).  Greedy
tokens must be identical.
"""
import ast
import dataclasses
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.models.transformer import get_model as jax_model  # noqa: E402
from repro.runtime.engine import InferenceEngine as JaxEngine  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import ARCH_IDS  # noqa: E402
from repro_torch.configs import get_config as port_config  # noqa: E402
from repro_torch.models.transformer import get_model as port_model  # noqa: E402
from repro_torch.runtime.engine import InferenceEngine  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
TOL = dict(atol=1e-4, rtol=1e-4)
MAX_LEN = 48


def _configs(kv):
    jcfg = jax_config("llama32-3b").reduced()
    tcfg = port_config("llama32-3b").reduced()
    if kv is not None:
        jcfg = dataclasses.replace(jcfg, num_kv_heads=kv)
        tcfg = dataclasses.replace(tcfg, num_kv_heads=kv)
    return jcfg, tcfg


@pytest.fixture(scope="module", params=[None, 2], ids=["kv4", "kv2"])
def pair(request):
    """(jax cfg, jax params, port cfg, port params) with equal weights."""
    jcfg, tcfg = _configs(request.param)
    jparams = jax_model(jcfg).init(jax.random.PRNGKey(0))
    np_params = jax.tree.map(np.asarray, jparams)
    return jcfg, jparams, tcfg, bridge.params_from_jax(np_params, tcfg,
                                                        device="cpu")


def _prompts(cfg, b, s, seed=0):
    return np.random.default_rng(seed).integers(
        2, cfg.vocab_size, (b, s)).astype(np.int32)


def _close(port, ref):
    np.testing.assert_allclose(port.float().numpy(), np.asarray(ref), **TOL)


# ---------------------------------------------------------------------------
# configs and weights
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_configs_equal_field_by_field(arch):
    for j, t in ((jax_config(arch), port_config(arch)),
                 (jax_config(arch).reduced(), port_config(arch).reduced())):
        assert dataclasses.asdict(j) == dataclasses.asdict(t)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bridge_round_trip_is_bitwise(dtype):
    jcfg, tcfg = _configs(2)
    jcfg = dataclasses.replace(jcfg, dtype=dtype)
    tcfg = dataclasses.replace(tcfg, dtype=dtype)
    np_params = jax.tree.map(np.asarray,
                             jax_model(jcfg).init(jax.random.PRNGKey(3)))
    back = bridge.params_to_numpy(
        bridge.params_from_jax(np_params, tcfg, device="cpu"))
    flat_a = jax.tree_util.tree_leaves_with_path(np_params)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, a in flat_a:
        b = flat_b[path]
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes(), path


def test_bridge_rejects_wrong_shapes():
    jcfg, tcfg = _configs(None)
    np_params = jax.tree.map(np.asarray,
                             jax_model(jcfg).init(jax.random.PRNGKey(0)))
    np_params["blocks"]["wq"] = np_params["blocks"]["wq"][:, :, :-1]
    with pytest.raises(ValueError, match="wq"):
        bridge.params_from_jax(np_params, tcfg, device="cpu")


def test_port_init_follows_the_jax_rule():
    """Seeded init on the device: the JAX package's shapes, zero norms,
    fan-in scaling, and zeroed pad-vocab rows/columns."""
    cfg = dataclasses.replace(port_config("llama32-3b").reduced(),
                              vocab_size=500)
    params = port_model(cfg).init(seed=0, device="cpu")
    shapes = bridge.expected_shapes(cfg)
    assert params["blocks"].keys() == shapes["blocks"].keys()
    for key, shape in shapes["blocks"].items():
        assert tuple(params["blocks"][key].shape) == shape
    assert params["embed"][500:].abs().sum() == 0
    assert params["lm_head"][:, 500:].abs().sum() == 0
    assert params["blocks"]["ln1"].abs().sum() == 0
    std = float(params["blocks"]["wq"].std())
    assert abs(std * np.sqrt(cfg.d_model) - 1.0) < 0.05
    again = port_model(cfg).init(seed=0, device="cpu")
    assert torch.equal(params["blocks"]["w2"], again["blocks"]["w2"])


# ---------------------------------------------------------------------------
# logits against the JAX model
# ---------------------------------------------------------------------------


def test_prefill_and_decode_logits_match(pair):
    jcfg, jp, tcfg, tp = pair
    jm, tm = jax_model(jcfg), port_model(tcfg)
    toks = _prompts(jcfg, 2, 11)
    jl, jc, _ = jm.prefill(jp, jnp.asarray(toks), max_len=MAX_LEN)
    tl, tc, _ = tm.prefill(tp, torch.from_numpy(toks), MAX_LEN)
    _close(tl, jl)
    _close(tc["k"], jc["k"])
    _close(tc["v"], jc["v"])
    tok = np.argmax(np.asarray(jl), -1).astype(np.int32)
    # scalar pos (fixed batch), then [B] pos (continuous batching)
    jl, jc = jm.decode_step(jp, jc, jnp.asarray(tok), jnp.int32(11))
    tl, tc = tm.decode_step(tp, tc, torch.from_numpy(tok), 11)
    _close(tl, jl)
    tok = np.argmax(np.asarray(jl), -1).astype(np.int32)
    pos = np.array([12, 12], np.int32)
    jl, jc = jm.decode_step(jp, jc, jnp.asarray(tok), jnp.asarray(pos))
    tl, tc = tm.decode_step(tp, tc, torch.from_numpy(tok),
                            torch.from_numpy(pos))
    _close(tl, jl)
    _close(tc["k"], jc["k"])


def test_plain_path_matches_kernel_path(pair):
    """The model's two attention paths (kernel wrappers vs materialised
    masks) agree — on the CPU the wrappers run the plain versions."""
    _, _, tcfg, tp = pair
    toks = torch.from_numpy(_prompts(tcfg, 2, 9, seed=4))
    a = port_model(tcfg).prefill(tp, toks, MAX_LEN)
    b = port_model(tcfg, plain=True).prefill(tp, toks, MAX_LEN)
    torch.testing.assert_close(a[0], b[0], **TOL)
    torch.testing.assert_close(a[1]["v"], b[1]["v"], **TOL)


def test_paged_step_chunk_and_decode_match(pair):
    """Paged chunks at per-sequence offsets, then a paged decode step, ==
    the JAX Model.paged_step on the same pages."""
    jcfg, jp, tcfg, tp = pair
    jm, tm = jax_model(jcfg), port_model(tcfg)
    ps, n = 4, 6
    P = 1 + 2 * n
    jcache = jm.init_paged_cache(P, ps)
    tcache = tm.init_paged_cache(P, ps, device="cpu")
    bt = np.array([[5, 2, 9, 1, 0, 0], [3, 12, 7, 4, 0, 0]], np.int32)
    toks = _prompts(jcfg, 2, 13, seed=1)
    for start, end in ((0, 7), (7, 13)):
        pos = np.array([start, start], np.int32)
        chunk = toks[:, start:end]
        jl, jcache = jm.paged_step(jp, jcache, jnp.asarray(chunk),
                                   jnp.asarray(pos), jnp.asarray(bt))
        tl, tcache = tm.paged_step(tp, tcache, torch.from_numpy(chunk),
                                   torch.from_numpy(pos),
                                   torch.from_numpy(bt))
        _close(tl, jl)
    tok = np.argmax(np.asarray(jl), -1).astype(np.int32)[:, None]
    pos = np.array([13, 13], np.int32)
    jl, jcache = jm.paged_step(jp, jcache, jnp.asarray(tok),
                               jnp.asarray(pos), jnp.asarray(bt))
    tl, tcache = tm.paged_step(tp, tcache, torch.from_numpy(tok),
                               torch.from_numpy(pos), torch.from_numpy(bt))
    _close(tl, jl)
    _close(tcache["k"], jcache["k"])


@pytest.mark.parametrize("chunk", [1, 8])
def test_engine_tokens_equal_jax_engine(pair, chunk):
    jcfg, jp, tcfg, tp = pair
    toks = _prompts(jcfg, 2, 10, seed=2)
    want = np.asarray(JaxEngine(jcfg, jp, max_len=MAX_LEN, decode_chunk=chunk)
                      .generate(jnp.asarray(toks), max_new_tokens=13))
    got = InferenceEngine(tcfg, tp, max_len=MAX_LEN, decode_chunk=chunk,
                          device="cpu").generate(toks, max_new_tokens=13)
    np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# the port stands alone
# ---------------------------------------------------------------------------


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_neither_jax_nor_repro():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 15
    bad = [(f.relative_to(ROOT).as_posix(), mod) for f in files
           for mod in _imports(f)
           if mod.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, bad


def test_entry_points_need_a_card_unless_asked_for_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    from repro_torch.runtime.backends import make_backend
    cfg = port_config("llama32-3b").reduced()
    params = port_model(cfg).init(seed=0, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        InferenceEngine(cfg, params)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_backend("gspmd", cfg, params, num_slots=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_model(cfg).init(seed=0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bridge.params_from_jax(bridge.params_to_numpy(params), cfg)


def test_other_families_name_their_roadmap_item():
    with pytest.raises(NotImplementedError, match="A11"):
        port_model(port_config("rwkv6-7b").reduced())
