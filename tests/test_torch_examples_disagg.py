"""disagg_demo of the port held to the JAX package's example on the same
weights (helpers in ``tests/torch_examples_jax.py``): the colocated and
the disaggregated streams, each handoff's rid, pages, bytes and
prediction, and every printed line without a wall-clock time.
"""
import re

import pytest

torch = pytest.importorskip("torch")

import torch_examples_jax as ex  # noqa: E402  (tests/: the shared runs)


def test_disagg_demo_matches_jax_on_its_weights(monkeypatch):
    """disagg_demo: the colocated and the disaggregated streams as JAX's,
    each handoff's rid, pages, bytes and prediction, and every printed
    line JAX's but the chat TPOT and the handoffs' prefill times."""
    jrun = ex.jax_example("disagg_demo", monkeypatch,
                          record=("Scheduler", "DisaggScheduler"))
    [(_, colo)] = jrun["runs"]["Scheduler"]
    [(reqs, report)] = jrun["runs"]["DisaggScheduler"]
    out, text = ex.port_main("disagg_demo", monkeypatch, jrun)

    assert ex.prompts(out["reqs"]) == ex.prompts(reqs)
    assert ex.served(out["colo"]) == ex.served(colo)
    assert ex.served(out["report"]) == ex.served(report)

    def handoffs(rep):
        return [(h.rid, h.pages, h.bytes, int(h.predicted_bytes))
                for h in rep.handoffs]
    assert handoffs(out["report"]) == handoffs(report)
    assert len(handoffs(report)) == 2        # the two long requests

    def untimed(t):
        return [re.sub(r"\(prefill [0-9.]+ ms\)", "", ln)
                for ln in ex.lines(t, ("chat TPOT",))]
    assert untimed(text) == untimed(jrun["text"])
