"""prefix_demo of the port held to the JAX package's example on the same
weights (helpers in ``tests/torch_examples_jax.py``): both passes' hits
and streams, the hit pass's chunk count, and every printed line but the
TTFT one.
"""
import pytest

torch = pytest.importorskip("torch")

import torch_examples_jax as ex  # noqa: E402  (tests/: the shared runs)


def test_prefix_demo_matches_jax_on_its_weights(monkeypatch):
    """prefix_demo: both passes' hits and streams as JAX's, and every
    printed line but the TTFT one JAX's (hit rate, cold and hit chunk
    counts, the skipped collectives, the drain)."""
    jrun = ex.jax_example("prefix_demo", monkeypatch, record=("Scheduler",))
    (_, cold), (reqs, report) = jrun["runs"]["Scheduler"]
    out, text = ex.port_main("prefix_demo", monkeypatch, jrun)

    assert ex.prompts(out["reqs"]) == ex.prompts(reqs)
    for got, want in ((out["cold"], cold), (out["report"], report)):
        assert ex.served(got) == ex.served(want)
        assert {m.rid: m.cached_prefix_len for m in got.metrics} == \
            {m.rid: m.cached_prefix_len for m in want.metrics}
    assert out["hit_chunks"] == sum(s.phase == "prefill"
                                    for s in report.steps)
    assert ex.lines(text, ("TTFT ",)) == ex.lines(jrun["text"], ("TTFT ",))
