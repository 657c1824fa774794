"""The port's training path against the JAX package's.

Reduced f32 configs (2 layers, narrow widths) with JAX's weights carried
across through numpy (``repro_torch.bridge``) and inputs made by numpy
from a seed: the losses (``_ce``, ``ce_from_hidden_chunked`` with uneven
chunks and a padded vocab), ``make_loss_fn``'s loss and every gradient
leaf for each family, the fused loss against the dense one, remat against
none, ``cosine_schedule`` and ``AdamW.update`` over three updates, five
train steps end to end, ``SyntheticTokens``, checkpoints written by either
side and read by the other, and the card guard of the entry points.  On
the CPU the kernel wrappers run their plain versions, so these gradients
are the plain path's; the kernels' backward (the plain versions' gradient)
is held to plain autograd on the card (``tests/test_torch_cuda.py``).

Tolerances: losses and the CE 1e-5, relative past 1 (the frameworks sum
the same f32 terms in another order); gradient leaves 1e-5 absolute + 1e-4 relative
(observed ≤ ~1e-6); the optimizer 1e-6 relative after three updates (the
same f32 formula), with an absolute floor of a few f32 ulps of each
leaf's scale (XLA may contract b1·m + (1 − b1)·g to one FMA: m differed
by 3.7e-9 at a scale of 0.03 where it cancelled to 7e-4); five train steps 1e-4 on the losses and the final
parameters (the gradients' f32 noise passes through the update's
m / sqrt(v)); remat and the port's own fused loss recompute the same
operations, 1e-6.  Tokens, data batches and checkpoint bytes are exact.
"""
import dataclasses
import json
import zipfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import store as jax_store  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.data.pipeline import SyntheticTokens as JaxTokens  # noqa: E402
from repro.models.transformer import get_model as jax_model  # noqa: E402
from repro.optim import adamw as jax_adamw  # noqa: E402
from repro.runtime import train as jax_train  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.checkpoint import store  # noqa: E402
from repro_torch.configs import get_config as port_config  # noqa: E402
from repro_torch.data.pipeline import SyntheticTokens  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.launch import train_100m  # noqa: E402
from repro_torch.models.transformer import get_model as port_model  # noqa: E402
from repro_torch.optim.adamw import AdamW, cosine_schedule  # noqa: E402
from repro_torch.runtime import train  # noqa: E402

GRAD_TOL = dict(atol=1e-5, rtol=1e-4)
B = 2
# (arch, sequence length, config changes): gemma with a vocab of 500 pads
# its tied head to 512 columns; hymba's window is cut to 16 so that the
# 24-token sequence passes it
ARCHS = [("internlm2-1.8b", 24, {}),
         ("gemma-7b", 24, {"vocab_size": 500}),
         ("deepseek-moe-16b", 24, {}),
         ("rwkv6-7b", 24, {}),
         ("hymba-1.5b", 24, {"sliding_window": 16}),
         ("hubert-xlarge", 24, {}),
         ("paligemma-3b", 24, {})]


def _configs(arch, **changes):
    jcfg, tcfg = jax_config(arch).reduced(), port_config(arch).reduced()
    return (dataclasses.replace(jcfg, **changes),
            dataclasses.replace(tcfg, **changes))


# XLA's backend passes cost more here than the tiny programs run: compile
# the JAX side without them (keeps the file under a minute; its init may
# then draw other last bits, and both sides take the arrays it draws)
_FAST_COMPILE = {"xla_backend_optimization_level": 0,
                 "xla_llvm_disable_expensive_passes": True}


def _jit(fn, *args):
    """fn jitted for ``args``' shapes, compiled with _FAST_COMPILE."""
    return jax.jit(fn).lower(*args).compile(_FAST_COMPILE)


_JAX_PARAMS = {}


def _pair(arch, **changes):
    """(jax cfg, jax params, port cfg, port params) with equal weights; the
    JAX init runs once per config, the port's copy is new each call (the
    train step updates it in place)."""
    jcfg, tcfg = _configs(arch, **changes)
    if jcfg not in _JAX_PARAMS:
        key = jax.random.PRNGKey(0)
        _JAX_PARAMS[jcfg] = _jit(jax_model(jcfg).init, key)(key)
    jp = _JAX_PARAMS[jcfg]
    return jcfg, jp, tcfg, bridge.params_from_jax(
        jax.tree.map(np.asarray, jp), tcfg, device="cpu")


def _batch(cfg, S, seed):
    """numpy batch of the family: tokens (and the vlm's image prefix), or
    the encoder's frames and targets."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(2, cfg.vocab_size, (B, S)).astype(np.int32)
    if cfg.family == "encoder":
        return {"features": rng.standard_normal(
                    (B, S, cfg.d_model)).astype(np.float32),
                "targets": tokens % cfg.vocab_size}
    batch = {"tokens": tokens}
    if cfg.family == "vlm":
        batch["prefix_emb"] = (rng.standard_normal(
            (B, cfg.num_prefix_tokens, cfg.d_model)) * 0.02).astype(
                np.float32)
    return batch


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _near(got, want, tol):
    """|got - want| <= tol, relative to |want| past 1 (gemma's scaled,
    tied embedding gives a loss of ~250 at random init)."""
    got, want = float(got), float(want)
    return abs(got - want) <= tol * max(1.0, abs(want))


def _assert_tree_close(port, ref, **tol):
    want = jax_store._flatten(jax.tree.map(np.asarray, ref))
    got = store.flatten(port)
    assert set(got) == set(want)
    for key, w in want.items():
        np.testing.assert_allclose(got[key].detach().float().numpy(),
                                   np.asarray(w, np.float32), err_msg=key,
                                   **tol)


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("chunk,vocab", [(13, None), (16, 70), (77, 70),
                                         (5, 77)])
def test_ce_matches_jax(chunk, vocab):
    """Dense CE, and the chunked CE with uneven chunks and padded head
    columns masked, within 1e-5 of JAX's."""
    rng = np.random.default_rng(chunk)
    x = rng.standard_normal((2, 9, 32)).astype(np.float32)
    head = rng.standard_normal((32, 77)).astype(np.float32)
    tgt = rng.integers(0, vocab or 77, (2, 9)).astype(np.int32)
    V = vocab or 77
    want_dense = jax_train._ce(jnp.asarray(x @ head[:, :V]),
                               jnp.asarray(tgt), V)
    got_dense = train._ce(torch.from_numpy(x @ head[:, :V]),
                          torch.from_numpy(tgt), V)
    want = jax_train.ce_from_hidden_chunked(
        jnp.asarray(x), jnp.asarray(head), jnp.asarray(tgt), chunk=chunk,
        vocab=vocab)
    got = train.ce_from_hidden_chunked(
        torch.from_numpy(x), torch.from_numpy(head), torch.from_numpy(tgt),
        chunk=chunk, vocab=vocab)
    assert abs(float(got_dense) - float(want_dense)) < 1e-5
    assert abs(float(got) - float(want)) < 1e-5
    assert abs(float(got) - float(got_dense)) < 1e-5


@pytest.mark.parametrize("arch,S,changes", ARCHS,
                         ids=[a for a, _, _ in ARCHS])
def test_loss_and_grads_match_jax(arch, S, changes):
    """make_loss_fn's loss, ce, aux and every gradient leaf against JAX's
    jax.value_and_grad, dense loss; the port's fused loss equal to its
    dense one (the encoder has no fused variant)."""
    jcfg, jp, tcfg, tp = _pair(arch, **changes)
    batch = _batch(tcfg, S, seed=len(arch))
    jfn = jax_train.make_loss_fn(jax_model(jcfg))
    jbatch = _jax(batch)
    (jloss, jm), jgrads = _jit(jax.value_and_grad(jfn, has_aux=True), jp,
                               jbatch)(jp, jbatch)
    loss, metrics, grads = train.loss_and_grads(
        train.make_loss_fn(port_model(tcfg)), tp, _torch(batch))
    assert _near(loss, jloss, 1e-5)
    for k in ("ce", "aux"):
        assert _near(metrics[k], jm[k], 1e-5), k
    if tcfg.family == "moe":
        assert float(metrics["aux"]) > 0
    _assert_tree_close(grads, jgrads, **GRAD_TOL)
    if tcfg.family == "encoder":
        return
    fused, _ = train.make_loss_fn(port_model(tcfg), "fused")(tp,
                                                              _torch(batch))
    assert _near(fused, loss, 1e-6)


@pytest.mark.parametrize("remat", ["full", "dots"])
def test_remat_grads_equal_no_remat(remat):
    """remat "full" and "dots" recompute the layers in the backward: the
    loss, the moe family's aux loss and the gradients equal those without
    remat, the config's remat being the default (the dense family's remat
    runs in test_kernel_route_under_autograd_matches_plain)."""
    arch = "deepseek-moe-16b"
    _, _, tcfg, tp = _pair(arch)
    batch = _torch(_batch(tcfg, 24, seed=5))
    base = train.loss_and_grads(train.make_loss_fn(port_model(tcfg)), tp,
                                batch)
    model = port_model(dataclasses.replace(tcfg, remat=remat))
    got = train.loss_and_grads(train.make_loss_fn(model), tp, batch)
    assert abs(float(got[0]) - float(base[0])) < 1e-6
    assert abs(float(got[1]["aux"]) - float(base[1]["aux"])) < 1e-6
    for key, g in store.flatten(got[2]).items():
        torch.testing.assert_close(g, store.flatten(base[2])[key],
                                   atol=1e-6, rtol=1e-6, msg=key)


def test_remat_rejects_an_unknown_policy():
    _, _, tcfg, tp = _pair("internlm2-1.8b")
    with pytest.raises(ValueError, match="remat"):
        port_model(tcfg).forward(tp, torch.zeros((1, 4), dtype=torch.int32),
                                 remat="some")


def test_forward_hidden_and_head_matrix():
    """return_hidden gives the final norm of every position, whose product
    with head_matrix is forward's logits (tied and untied)."""
    for arch in ("internlm2-1.8b", "gemma-7b"):
        _, _, tcfg, tp = _pair(arch)
        model = port_model(tcfg)
        tokens = torch.from_numpy(_batch(tcfg, 12, seed=1)["tokens"])
        logits, _ = model.forward(tp, tokens)
        hidden, _ = model.forward(tp, tokens, return_hidden=True)
        assert hidden.shape == (B, 12, tcfg.d_model)
        torch.testing.assert_close(hidden @ model.head_matrix(tp), logits,
                                   atol=1e-6, rtol=1e-6)


# ---------------------------------------------------------------------------
# the optimizer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("step", [0, 1, 2, 5, 10, 55, 99, 100, 130])
def test_cosine_schedule_matches_jax(step):
    want = jax_adamw.cosine_schedule(1e-3, 10, 100)(step)
    got = cosine_schedule(1e-3, 10, 100)(step)
    assert got.dtype == torch.float32
    assert abs(float(got) - float(want)) <= 1e-6 * abs(float(want)) + 1e-12


@pytest.mark.parametrize("clip", [1.0, 1e3])
def test_adamw_matches_jax_over_three_updates(clip):
    """Three updates of an f32 and a bf16 leaf with gradients large enough
    to clip (clip 1) or not (clip 1000): the parameters (the bf16 one cast
    back), the moments, the step, grad_norm and lr equal JAX's."""
    rng = np.random.default_rng(7)
    p_np = {"w": rng.standard_normal((5, 7)).astype(np.float32),
            "n": {"b": rng.standard_normal((7,)).astype(np.float32)}}
    jparams = {"w": jnp.asarray(p_np["w"]),
               "n": {"b": jnp.asarray(p_np["n"]["b"], jnp.bfloat16)}}
    tparams = {"w": torch.from_numpy(p_np["w"].copy()),
               "n": {"b": torch.from_numpy(p_np["n"]["b"]).to(
                   torch.bfloat16)}}
    kw = dict(lr=cosine_schedule(1e-2, 2, 10), grad_clip=clip)
    jopt = jax_adamw.AdamW(**{**kw, "lr": jax_adamw.cosine_schedule(
        1e-2, 2, 10)})
    topt = AdamW(**kw)
    jstate, tstate = jopt.init(jparams), topt.init(tparams)
    for i in range(3):
        g = {"w": rng.standard_normal((5, 7)).astype(np.float32) * 3,
             "n": {"b": rng.standard_normal((7,)).astype(np.float32)}}
        jg = {"w": jnp.asarray(g["w"]),
              "n": {"b": jnp.asarray(g["n"]["b"], jnp.bfloat16)}}
        tg = {"w": torch.from_numpy(g["w"]),
              "n": {"b": torch.from_numpy(g["n"]["b"]).to(torch.bfloat16)}}
        jparams, jstate, jm = jopt.update(jg, jstate, jparams)
        tparams, tstate, tm = topt.update(tg, tstate, tparams)
        assert int(tstate["step"]) == int(jstate["step"]) == i + 1
        for k in ("grad_norm", "lr"):
            assert abs(float(tm[k]) - float(jm[k])) <= \
                1e-6 * abs(float(jm[k])), k
        assert tparams["n"]["b"].dtype == torch.bfloat16
        np.testing.assert_array_equal(
            tparams["n"]["b"].float().numpy(),
            np.asarray(jparams["n"]["b"], np.float32))
        _assert_tree_close(tparams["w"], jparams["w"], atol=1e-7, rtol=1e-6)
        _assert_tree_close(tstate["m"], jstate["m"], atol=1e-8, rtol=1e-6)
        _assert_tree_close(tstate["v"], jstate["v"], atol=1e-9, rtol=1e-6)
    if clip == 1.0:
        assert float(tm["grad_norm"]) > clip


def test_five_train_steps_match_jax():
    """N-step parity: five make_train_step steps from bridged params on
    SyntheticTokens batches, the losses within 1e-4 at each step and the
    final parameters within 1e-4."""
    jcfg, jp, tcfg, tp = _pair("internlm2-1.8b")
    kw = dict(b2=0.99)
    jopt = jax_adamw.AdamW(lr=jax_adamw.cosine_schedule(1e-3, 2, 5), **kw)
    topt = AdamW(lr=cosine_schedule(1e-3, 2, 5), **kw)
    jstate, tstate = jopt.init(jp), topt.init(tp)
    data = SyntheticTokens(tcfg.vocab_size, 33, 4, seed=3)
    jstep = _jit(jax_train.make_train_step(jax_model(jcfg), jopt), jp,
                 jstate, {"tokens": jnp.asarray(data.batch_at(0))})
    tstep = train.make_train_step(port_model(tcfg), topt, device="cpu")
    for i, tokens in zip(range(5), data):
        jp, jstate, jm = jstep(jp, jstate, {"tokens": jnp.asarray(tokens)})
        tp, tstate, tm = tstep(tp, tstate, {"tokens": tokens})
        assert abs(float(tm["loss"]) - float(jm["loss"])) < 1e-4, i
        assert abs(float(tm["grad_norm"]) - float(jm["grad_norm"])) < 1e-4
    _assert_tree_close(tp, jp, atol=1e-4, rtol=1e-4)
    eval_loss = train.make_eval_step(port_model(tcfg), device="cpu")(
        tp, {"tokens": data.batch_at(9)})["loss"]
    want = jax_train.make_eval_step(jax_model(jcfg))(
        jp, {"tokens": jnp.asarray(data.batch_at(9))})["loss"]
    assert abs(float(eval_loss) - float(want)) < 1e-4


# ---------------------------------------------------------------------------
# data and checkpoints
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed,step,lo,hi", [(0, 0, 0, None), (3, 5, 2, 5),
                                             (7, 123, 1, 8), (2**31, 9, 0, 1)])
def test_synthetic_tokens_bitwise_jax(seed, step, lo, hi):
    args = (50_000, 1100, 8)
    got = SyntheticTokens(*args, seed=seed).batch_at(step, lo, hi)
    want = JaxTokens(*args, seed=seed).batch_at(step, lo, hi)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    port_iter, jax_iter = iter(SyntheticTokens(*args, seed=seed)), \
        iter(JaxTokens(*args, seed=seed))
    for _ in range(2):
        np.testing.assert_array_equal(next(port_iter), next(jax_iter))


def _jax_tree():
    rng = np.random.default_rng(11)
    return {"params": {"w": jnp.asarray(rng.standard_normal((3, 5)),
                                        jnp.bfloat16),
                       "b": jnp.asarray(rng.standard_normal(5), jnp.float32),
                       "s": jnp.asarray(2.5, jnp.bfloat16)},
            "opt": {"m": jnp.asarray(rng.standard_normal((3, 5)),
                                     jnp.float32),
                    "step": jnp.asarray(4, jnp.int32)}}


def _members(path):
    with zipfile.ZipFile(path / "arrays.npz") as z:
        return {n: z.read(n) for n in z.namelist()}


def test_checkpoint_from_jax_loads_bitwise(tmp_path):
    """A JAX-written checkpoint (f32, int32 and bf16 leaves) loads into the
    port as torch tensors bitwise; without a device the leaves are numpy
    as JAX's loader gives them (bf16 as 2-byte void)."""
    tree = _jax_tree()
    jax_store.save_checkpoint(str(tmp_path / "j"), tree, step=7)
    loaded, step = store.load_checkpoint(str(tmp_path / "j"), device="cpu")
    assert step == 7
    want = jax_store._flatten(tree)
    for key, t in store.flatten(loaded).items():
        w = np.asarray(want[key])
        assert t.dtype == {"bfloat16": torch.bfloat16,
                           "float32": torch.float32,
                           "int32": torch.int32}[str(w.dtype)], key
        np.testing.assert_array_equal(t.float().numpy(), w.astype(np.float32))
    raw, _ = store.load_checkpoint(str(tmp_path / "j"))
    assert raw["params"]["w"].dtype == np.dtype("V2")


def test_port_checkpoint_reads_in_jax_as_its_own(tmp_path):
    """A port checkpoint of the same tree: every .npy member and the
    manifest byte for byte JAX's; JAX's loader reads it with the same
    values and the same |V2 bf16 leaves (C14) as a JAX-written one; the
    port reads it back bitwise, bf16 included."""
    tree = _jax_tree()
    jax_store.save_checkpoint(str(tmp_path / "j"), tree, step=3)
    ttree = {group: {k: torch.from_numpy(np.array(v, np.float32)).to(
                 {"bfloat16": torch.bfloat16, "float32": torch.float32,
                  "int32": torch.int32}[str(v.dtype)])
                 for k, v in leaves.items()}
             for group, leaves in tree.items()}
    store.save_checkpoint(str(tmp_path / "p"), ttree, step=3)
    assert _members(tmp_path / "p") == _members(tmp_path / "j")
    assert json.loads((tmp_path / "p" / "manifest.json").read_text()) == \
        json.loads((tmp_path / "j" / "manifest.json").read_text())
    from_port, step = jax_store.load_checkpoint(str(tmp_path / "p"))
    from_jax, _ = jax_store.load_checkpoint(str(tmp_path / "j"))
    assert step == 3
    for key, a in jax_store._flatten(from_port).items():
        b = jax_store._flatten(from_jax)[key]
        assert a.dtype == b.dtype, key
        assert a.tobytes() == b.tobytes(), key
    assert from_port["params"]["w"].dtype == np.dtype("V2")
    back, _ = store.load_checkpoint(str(tmp_path / "p"), device="cpu")
    for key, t in store.flatten(back).items():
        assert torch.equal(t, store.flatten(ttree)[key]), key


def test_checkpoint_rejects_a_wrong_shape(tmp_path):
    store.save_checkpoint(str(tmp_path), {"a": torch.zeros(2, 3)}, step=1)
    manifest = json.loads((tmp_path / "manifest.json").read_text())
    manifest["leaves"]["a"]["shape"] = [3, 2]
    (tmp_path / "manifest.json").write_text(json.dumps(manifest))
    with pytest.raises(ValueError, match="shape mismatch"):
        store.load_checkpoint(str(tmp_path))


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------


def test_entry_points_need_the_card_unless_cpu(monkeypatch, capsys):
    """Without a card the launchers and the steps raise unless the caller
    asks for the CPU; on the CPU the launcher trains a reduced config and
    its loss stays finite."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = port_config("internlm2-1.8b").reduced()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.make_train_step(port_model(cfg), AdamW())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.make_eval_step(port_model(cfg))
    for main, argv in ((launch_train.main, ["--arch", "internlm2-1.8b",
                                            "--reduced"]),
                       (train_100m.main, [])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(argv + ["--steps", "1"])
    history = launch_train.main(["--arch", "paligemma-3b", "--reduced",
                                 "--device", "cpu", "--steps", "2",
                                 "--batch", "2", "--seq", "16",
                                 "--loss-impl", "fused"])
    assert len(history) == 2
    assert all(np.isfinite(m["loss"]) for m in history)
    assert "2 steps in" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# the kernels' autograd route, rehearsed on the CPU
# ---------------------------------------------------------------------------


def _route(name, plain, counts):
    """A dispatcher that takes kernels.grad's route on the CPU, with the
    plain version standing in for the kernel (counted per call)."""
    from repro_torch.kernels import grad

    def kernel(*args):
        counts[name] = counts.get(name, 0) + 1
        return plain(*args)

    def dispatch(*args):
        if grad.wanted(*args):
            return grad.through_plain(kernel, plain, *args)
        return kernel(*args)
    return dispatch


def test_through_plain_gradient_is_plain_autograd():
    """grad.through_plain's gradients equal autograd of the plain version
    (RMSNorm, the fused add, B2's plain version in the prefix mask with a
    window, both WKV6 plain forms; integer arguments get none), and
    wanted() is False under no_grad and for inputs that need none."""
    from repro_torch.kernels import grad
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.kernels.rmsnorm.ref import add_rms_norm_ref, rms_norm_ref
    from repro_torch.kernels.rwkv6_scan.ref import wkv6_chunk_ref, wkv6_ref
    g = torch.Generator().manual_seed(0)

    def rnd(*shape, scale=1.0):
        return (scale * torch.randn(shape, generator=g)).requires_grad_()
    off, kl = torch.tensor([0, 3], dtype=torch.int32), \
        torch.tensor([20, 17], dtype=torch.int32)
    cases = [
        (rms_norm_ref, (rnd(5, 16), rnd(16), 1e-5)),
        (add_rms_norm_ref, (rnd(5, 16), rnd(5, 16), rnd(16), 1e-6)),
        (lambda q, k, v, o, n: flash_attention_ref(
            q, k, v, o, n, 6, mode="prefix", prefix_len=4),
         (rnd(2, 20, 4, 8), rnd(2, 20, 2, 8), rnd(2, 20, 2, 8), off, kl)),
    ]
    w = (0.8 + 0.19 * torch.rand((1, 19, 2, 16), generator=g)
         ).requires_grad_()
    for plain in (wkv6_ref, wkv6_chunk_ref):
        cases.append((plain, (rnd(1, 19, 2, 16, scale=0.5),
                              rnd(1, 19, 2, 16, scale=0.5),
                              rnd(1, 19, 2, 16, scale=0.5), w,
                              rnd(2, 16, scale=0.3),
                              rnd(1, 2, 16, 16, scale=0.1))))
    for plain, args in cases:
        tensors = [a for a in args if isinstance(a, torch.Tensor)
                   and a.requires_grad]
        outs = grad.through_plain(plain, plain, *args)
        want = plain(*args)
        outs, want = [o if isinstance(o, tuple) else (o,)
                      for o in (outs, want)]
        ups = [torch.randn(o.shape, generator=g) for o in want]
        got = torch.autograd.grad(outs, tensors, ups)
        ref = torch.autograd.grad(want, tensors, ups)
        for a, b in zip(got, ref):
            torch.testing.assert_close(a, b, atol=0, rtol=0)
    x = rnd(2, 4)
    assert grad.wanted(x, 1.0) and not grad.wanted(x.detach(), 1.0)
    with torch.no_grad():
        assert not grad.wanted(x)


@pytest.mark.parametrize("arch,remat", [
    ("internlm2-1.8b", "none"), ("internlm2-1.8b", "full"),
    ("internlm2-1.8b", "dots"), ("rwkv6-7b", "none"), ("hymba-1.5b", "none")])
def test_kernel_route_under_autograd_matches_plain(monkeypatch, arch, remat):
    """The model's training pass with every kernel site on kernels.grad's
    route (the plain versions standing in for the kernels): the loss and
    every gradient equal the plain path's without remat, and the sites run
    the card's launch formula — 1 B1 (hymba 1 + 2L), 2L add_rms_norm, L B2
    or B10 per pass, the in-layer ones again under remat."""
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.kernels.rmsnorm.ref import add_rms_norm_ref, rms_norm_ref
    from repro_torch.kernels.rwkv6_scan.ref import wkv6_chunk_ref
    from repro_torch.models import blocks, layers, ssm

    _, _, tcfg, tp = _pair(arch)
    batch = _torch(_batch(tcfg, 20, seed=2))
    base = train.loss_and_grads(train.make_loss_fn(port_model(tcfg)), tp,
                                batch)
    counts = {}
    monkeypatch.setattr(layers, "rms_norm",
                        _route("rmsnorm", rms_norm_ref, counts))
    monkeypatch.setattr(layers, "add_rms_norm",
                        _route("add_rms_norm", add_rms_norm_ref, counts))
    flash = _route("flash_attention", flash_attention_ref, counts)
    monkeypatch.setattr(blocks, "flash_attention",
                        lambda q, k, v, o, n, window=None, mode="causal",
                        prefix_len=0: flash(q, k, v, o, n, window, None,
                                            mode, prefix_len))
    wkv = _route("wkv6", wkv6_chunk_ref, counts)
    monkeypatch.setattr(ssm, "wkv6",
                        lambda r, k, v, w, u, s, state_out=None:
                        wkv(r, k, v, w, u, s))
    model = port_model(dataclasses.replace(tcfg, remat=remat))
    got = train.loss_and_grads(train.make_loss_fn(model), tp, batch)
    assert _near(got[0], base[0], 1e-6)
    want = store.flatten(base[2])
    for key, grad_ in store.flatten(got[2]).items():
        torch.testing.assert_close(grad_, want[key], atol=1e-6, rtol=1e-5,
                                   msg=key)
    L, again = tcfg.num_layers, remat != "none"
    branch = 2 * L if tcfg.family == "hybrid" else 0
    layer = "wkv6" if tcfg.family == "ssm" else "flash_attention"
    assert counts == {"rmsnorm": (1 + branch) * (1 + again),
                      "add_rms_norm": 2 * L + again * (2 * L - 1),
                      layer: L * (1 + again)}
