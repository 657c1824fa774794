"""serve_demo of the port held to the JAX package's example on the same
weights (helpers in ``tests/torch_examples_jax.py``): the trace, each
request's tokens and finish reason, and every printed line without a
wall-clock time.
"""
import pytest

torch = pytest.importorskip("torch")

import torch_examples_jax as ex  # noqa: E402  (tests/: the shared runs)


def test_serve_demo_matches_jax_on_its_weights(monkeypatch):
    """serve_demo: the same trace, every request served to the same
    tokens and finish reason as JAX's, and JAX's header, per-step
    collectives and ``predict_slo`` lines."""
    jrun = ex.jax_example("serve_demo", monkeypatch, record=("Scheduler",))
    (_, _), (trace, report) = jrun["runs"]["Scheduler"]
    out, text = ex.port_main("serve_demo", monkeypatch, jrun)

    def requests(reqs):
        return [(r.rid, r.max_new_tokens, r.arrival) for r in reqs]
    assert requests(out["trace"]) == requests(trace)
    assert ex.prompts(out["trace"]) == ex.prompts(trace)
    assert ex.served(out["report"]) == ex.served(report)
    timed = ("req ", "throughput ")
    assert ex.lines(text, timed) == ex.lines(jrun["text"], timed)
