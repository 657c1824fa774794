"""The port's examples (``repro_torch.examples``) against the JAX package's.

Each example's ``main`` runs at the JAX example's defaults on the CPU
(``--device cpu``) and holds its own invariants; without ``--device`` and
without a card each raises.  comm_study's analytic output equals the JAX
example's stdout line for line, and its ``--measure`` transfers equal
``pp_comm_ops``.  quickstart's ``run`` on the JAX package's own weights,
carried across by ``repro_torch.bridge``, gives JAX's forward logits, its
train step's loss and gradient norm within 1e-4, and the greedy tokens
of JAX's ``InferenceEngine.generate`` on the updated weights.  The other
five examples are held to the JAX package's on the same weights in
``tests/test_torch_examples_<name>.py``.
"""
import io
import pathlib
import sys
from contextlib import redirect_stdout

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.core import commodel as jax_cm  # noqa: E402
from repro.models.transformer import get_model as jax_model  # noqa: E402
from repro.optim.adamw import AdamW as JaxAdamW  # noqa: E402
from repro.runtime.engine import InferenceEngine as JaxEngine  # noqa: E402
from repro.runtime.train import make_train_step as jax_train_step  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config as port_config  # noqa: E402
from repro_torch.examples import (chaos_demo, comm_study,  # noqa: E402
                                  disagg_demo, prefix_demo, quant_demo,
                                  quickstart, serve_demo)

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:            # the JAX examples' package
    sys.path.insert(0, str(ROOT))

# XLA's backend passes cost more here than the tiny programs run: compile
# the JAX side without them (as tests/test_torch_train.py does)
_FAST_COMPILE = {"xla_backend_optimization_level": 0,
                 "xla_llvm_disable_expensive_passes": True}


def _jit(fn, *args):
    """fn jitted for ``args``' shapes, compiled with _FAST_COMPILE."""
    return jax.jit(fn).lower(*args).compile(_FAST_COMPILE)


EXAMPLES = {"quickstart": quickstart, "serve_demo": serve_demo,
            "comm_study": comm_study, "quant_demo": quant_demo,
            "prefix_demo": prefix_demo, "disagg_demo": disagg_demo,
            "chaos_demo": chaos_demo}


def _stdout(fn, *args):
    buf = io.StringIO()
    with redirect_stdout(buf):
        out = fn(*args)
    return out, buf.getvalue()


@pytest.mark.parametrize("name", list(EXAMPLES))
def test_example_runs_on_the_cpu_with_its_invariants(name):
    """Each example at the JAX example's defaults on the CPU: ``main``
    returns (its ``check`` raises on a broken invariant) and prints the
    JAX example's closing line where it has one."""
    out, text = _stdout(EXAMPLES[name].main, ["--device", "cpu"])
    assert text
    if name in ("quant_demo", "prefix_demo", "disagg_demo", "chaos_demo"):
        assert text.rstrip().splitlines()[-1].lstrip().startswith("OK:")
    if name == "serve_demo":
        assert len(out["report"].metrics) == 8
    if name == "chaos_demo":
        assert out["report"].preemptions >= 1     # the pool is oversubscribed


@pytest.mark.parametrize("name", list(EXAMPLES))
def test_example_raises_without_a_card(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        EXAMPLES[name].main([])


def test_comm_study_prints_the_jax_example_line_for_line(monkeypatch):
    from examples import comm_study as jax_comm_study
    monkeypatch.setattr(sys, "argv", ["comm_study.py"])
    _, want = _stdout(jax_comm_study.main)
    _, got = _stdout(comm_study.main, ["--device", "cpu"])
    assert got.splitlines() == want.splitlines()


def test_comm_study_measure_equals_pp_comm_ops():
    """--measure: the PipelineEngine's logged transfers equal the send
    rows of JAX's ``pp_comm_ops`` at the f32 run's b = 4, and the printed
    rows read OK."""
    out, text = _stdout(comm_study.main, ["--measure", "--device", "cpu"])
    cfg = jax_config("llama31-8b").reduced(num_layers=4)
    assert out["b"] == 4
    ops = jax_cm.pp_comm_ops(cfg, 8, 6, 2, b=4, batch=1)
    for phase in ("prefill", "decode"):
        want = [o for o in ops
                if o.collective == "send" and o.phase == phase][0]
        assert out["rows"][phase]["measured"] == \
            (want.count, want.total_msg_bytes)
    assert text.count("[OK]") == 2 and "MISMATCH" not in text


def test_quickstart_matches_jax_on_its_weights():
    """quickstart.run on JAX's reduced granite-8b weights (bridged): the
    forward logits and the train step's loss and gradient norm within
    1e-4, and the greedy tokens of JAX's engine on JAX's updated
    weights."""
    jcfg = jax_config("granite-8b").reduced()
    tcfg = port_config("granite-8b").reduced()
    model = jax_model(jcfg)
    key = jax.random.PRNGKey(0)
    jparams = _jit(model.init, key)(key)
    tparams = bridge.params_from_jax(jax.tree.map(np.asarray, jparams),
                                     tcfg, device="cpu")
    tokens = quickstart.draw_tokens(tcfg)
    out = quickstart.run(tcfg, tparams, torch.device("cpu"), tokens=tokens)
    quickstart.check(tcfg, out)

    jtok = jnp.asarray(tokens)
    logits, _ = _jit(model.forward, jparams, jtok)(jparams, jtok)
    np.testing.assert_allclose(out["logits"].numpy(), np.asarray(logits),
                               atol=1e-4, rtol=0)
    opt = JaxAdamW()
    args = (jparams, opt.init(jparams), {"tokens": jtok})
    new, _, metrics = _jit(jax_train_step(model, opt), *args)(*args)
    assert abs(out["loss"] - float(metrics["loss"])) <= 1e-4
    assert abs(out["grad_norm"] - float(metrics["grad_norm"])) <= 1e-4
    want = JaxEngine(jcfg, new, max_len=64).generate(
        jtok[:, :quickstart.PROMPT], max_new_tokens=8)
    assert out["generated"].tolist() == np.asarray(want).tolist()
