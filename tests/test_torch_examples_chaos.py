"""chaos_demo of the port held to the JAX package's example on the same
weights (helpers in ``tests/torch_examples_jax.py``), on the virtual
clock: the faulted and the fault-free runs' streams, preemptions and
retries, and the stdout line for line (the injected fault schedule, the
pool's size and each request's row included).
"""
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_examples_jax as ex  # noqa: E402  (tests/: the shared runs)


def test_chaos_demo_matches_jax_on_its_weights(monkeypatch):
    """chaos_demo on the virtual clock: the fault injector's settings and
    the faults it injected, the same preemptions, retries, finish reasons
    and streams as JAX's, in both the faulted and the fault-free run, and
    JAX's stdout line for line."""
    np.random.seed(0)                        # as the JAX example's __main__
    jmod = importlib.import_module("examples.chaos_demo")
    injectors = []

    class Recorded(jmod.FaultInjector):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            injectors.append(self)

    monkeypatch.setattr(jmod, "FaultInjector", Recorded)
    jrun = ex.jax_example("chaos_demo", monkeypatch, record=("Scheduler",))
    (_, ref), (_, report) = jrun["runs"]["Scheduler"]
    out, text = ex.port_main("chaos_demo", monkeypatch, jrun)

    def settings(inj):
        return (inj.seed, inj.rates, inj.transient_frac, inj.delay_frac,
                inj.delay_s, inj.max_faults)
    [inj] = injectors
    assert settings(out["injector"]) == settings(inj)
    def injected(inj):
        return [(site, i, f.kind, f.delay_s) for site, i, f in inj.injected]
    assert injected(out["injector"]) == injected(inj)
    assert ex.served(out["ref"]) == ex.served(ref)
    assert ex.served(out["report"]) == ex.served(report)
    assert [(m.rid, m.preemptions, m.retries)
            for m in out["report"].metrics] == \
        [(m.rid, m.preemptions, m.retries) for m in report.metrics]
    assert report.summary()["preemptions"] >= 1   # the pool is oversubscribed
    assert text.splitlines() == jrun["text"].splitlines()
