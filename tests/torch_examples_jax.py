"""Helpers of the tests that hold the port's examples to the JAX
package's examples on the same weights (``tests/test_torch_examples_*``).

``jax_example`` runs the JAX example's ``main`` (at its defaults) and
records its weights (``Model.init`` of PRNGKey(0)), its stdout and the
runs it makes; ``port_main`` runs the port's example's ``main(["--device",
"cpu"])`` with the port's ``get_model`` answering those weights, carried
across by ``repro_torch.bridge``.  A printed line that holds a wall-clock
time is left out of a comparison (``lines``).
"""
import collections
import importlib
import io
import pathlib
import sys
from contextlib import redirect_stdout

import jax
import numpy as np

from repro_torch import bridge
from repro_torch.examples import (chaos_demo, disagg_demo, prefix_demo,
                                  quant_demo, serve_demo)

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:            # the JAX examples' package
    sys.path.insert(0, str(ROOT))

PORT = {"quant_demo": quant_demo, "serve_demo": serve_demo,
        "prefix_demo": prefix_demo, "disagg_demo": disagg_demo,
        "chaos_demo": chaos_demo}


def stdout(fn, *args):
    buf = io.StringIO()
    with redirect_stdout(buf):
        out = fn(*args)
    return out, buf.getvalue()


def _recording(cls, runs):
    """``cls`` whose ``run`` appends (its requests, its report) to
    ``runs``."""
    class Recording(cls):
        def run(self, reqs, *args, **kwargs):
            reqs = list(reqs)
            report = super().run(reqs, *args, **kwargs)
            runs.append((reqs, report))
            return report
    return Recording


def jax_example(name, monkeypatch, record=(), argv=()):
    """The JAX example's ``main`` on ``argv`` (its defaults when empty):
    its stdout, its config and weights, and the runs of each class named
    in ``record``."""
    mod = importlib.import_module(f"examples.{name}")
    box = {"runs": collections.defaultdict(list)}
    get_model = mod.get_model

    class Recorded:
        def __init__(self, cfg):
            self.model = get_model(cfg)
            box["cfg"] = cfg

        def init(self, key):
            box["params"] = self.model.init(key)
            return box["params"]

    monkeypatch.setattr(mod, "get_model", Recorded)
    for cls in record:
        monkeypatch.setattr(mod, cls, _recording(getattr(mod, cls),
                                                 box["runs"][cls]))
    monkeypatch.setattr(sys, "argv", [f"{name}.py", *argv])
    _, box["text"] = stdout(mod.main)
    return box


def bridged(jax_run):
    """The port's parameters from the JAX example's weights."""
    np_params = jax.tree.map(np.asarray, jax_run["params"])
    return lambda cfg, device: bridge.params_from_jax(np_params, cfg,
                                                      device=device)


def port_main(name, monkeypatch, jax_run, argv=()):
    """The port example's ``main([*argv, "--device", "cpu"])`` on the JAX
    example's weights: its result and its stdout."""
    params = bridged(jax_run)

    class Bridged:
        def __init__(self, cfg):
            assert cfg.name == jax_run["cfg"].name
            assert cfg.num_layers == jax_run["cfg"].num_layers
            self.cfg = cfg

        def init(self, seed, device):
            assert seed == 0                 # JAX's PRNGKey(0)
            return params(self.cfg, device)

    monkeypatch.setattr(PORT[name], "get_model", Bridged)
    return stdout(PORT[name].main, [*argv, "--device", "cpu"])


def lines(text, skip=()):
    """``text``'s lines, those starting (after their indent) with a prefix
    in ``skip`` left out."""
    return [ln for ln in text.splitlines()
            if not ln.lstrip().startswith(tuple(skip))]


def served(report):
    """Each request's (finish reason, tokens) by rid."""
    return {m.rid: (m.finish_reason, list(m.tokens)) for m in report.metrics}


def prompts(reqs):
    return [np.asarray(r.prompt).tolist() for r in reqs]
