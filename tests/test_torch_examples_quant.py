"""quant_demo of the port held to the JAX package's example on the same
weights (helpers in ``tests/torch_examples_jax.py``): both decodes'
logits and tokens, the top-1 match and the drift, each decode's logged
collectives, and the printed wire and closing lines.
"""
import collections
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import torch_examples_jax as ex  # noqa: E402  (tests/: the shared runs)

from repro_torch.configs import get_config as port_config  # noqa: E402
from repro_torch.examples import quant_demo  # noqa: E402


# the defaults, and t = 4, where the quantized run's choices differ from
# the unquantized ones (top-1 match 0.9531), so that its teacher forcing
# shows in the logits
@pytest.mark.parametrize("tp", [2, 4])
def test_quant_demo_matches_jax_on_its_weights(monkeypatch, tp):
    """quant_demo: JAX's decode steps recorded; the port's ``run`` on the
    same weights and prompts gives the unquantized run's logits within
    1e-4 and the quantized run's within 0.05, the same tokens, the same
    top-1 match and the same max drift within 1e-4, each decode's logged
    collectives the closed form's, and ``main`` prints JAX's wire and
    closing lines."""
    jmod = importlib.import_module("examples.quant_demo")
    steps = collections.defaultdict(list)
    tp_decode_step = jmod.px.tp_decode_step

    def recorded_step(*args, **kwargs):
        step = tp_decode_step(*args, **kwargs)
        calls = steps[kwargs.get("quant_collectives")]

        def run(*a):
            logits, cache = step(*a)
            calls.append(np.asarray(logits))
            return logits, cache
        return run

    monkeypatch.setattr(jmod.px, "tp_decode_step", recorded_step)
    argv = () if tp == 2 else ("--tp", str(tp))
    jrun = ex.jax_example("quant_demo", monkeypatch, argv=argv)
    want = jrun["text"].splitlines()

    tokens, batch = 16, 4
    ref = np.stack(steps[None][:tokens])
    got = np.stack(steps["int8"][:tokens])
    match = float(np.mean(got.argmax(-1) == ref.argmax(-1)))
    drift = float(np.max(np.abs(got - ref)))
    assert want[2].split() == ["token_match_rate", f"{match:.4f}",
                               "max_logit_drift", f"{drift:.4f}"]

    tcfg = port_config("llama32-3b").reduced(num_layers=2)
    prompts = np.asarray(jax.random.randint(
        jax.random.PRNGKey(1), (batch, quant_demo.PREFILL), 2,
        tcfg.vocab_size))
    out = quant_demo.run(tcfg, ex.bridged(jrun)(tcfg, "cpu"),
                         torch.device("cpu"), tp=tp, prompts=prompts)
    quant_demo.check_wire(out, 0.6)
    np.testing.assert_allclose(out["ref"][0].numpy(), ref, atol=1e-4,
                               rtol=0)
    np.testing.assert_array_equal(out["ref"][1].numpy(), ref.argmax(-1))
    # a payload value that rounds the other way on one side moves a
    # step's logits by a fraction of an int8 step (at t = 2, 4 of the 64
    # rows, by up to 0.018; the others within 3e-6)
    np.testing.assert_allclose(out["got"][0].numpy(), got, atol=0.05,
                               rtol=0)
    np.testing.assert_array_equal(out["got"][1].numpy(), got.argmax(-1))
    assert out["match"] == match
    assert abs(out["drift"] - drift) <= 1e-4

    _, text = ex.port_main("quant_demo", monkeypatch, jrun, argv)
    lines = text.splitlines()
    assert lines[:2] == want[:2]             # config, predicted wire
    assert lines[4:] == want[4:]             # the closing OK line
