"""Quickstart: build a reduced architecture, run a forward pass, one train
step, and a short greedy generation — the port's public API in one file.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--arch granite-8b]
    PYTHONPATH=src python -m repro_torch.examples.quickstart --device cpu

Counterpart of ``examples/quickstart.py`` with the same flags plus
``--device`` (default the card; it raises when there is none).  The
weights are drawn from seed 0 by the port's ``Model.init`` and the
tokens from seed 1 by numpy (other draws than JAX's).  On the card the
forward pass launches B1, ``add_rms_norm`` and B2, the train step the
same kernels with their plain versions' backward (``kernels/grad.py``)
and the generation B2 and B3.
"""
import argparse

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.models.transformer import get_model, resolve_device
from repro_torch.optim.adamw import AdamW
from repro_torch.runtime.engine import InferenceEngine
from repro_torch.runtime.train import make_train_step

PROMPT = 16                 # generation prompt: the first 16 tokens
NEW_TOKENS = 8
MAX_LEN = 64


def draw_tokens(cfg) -> np.ndarray:
    """The example's [2, 32] int32 tokens in [2, vocab), from seed 1."""
    return np.random.default_rng(1).integers(
        2, cfg.vocab_size, (2, 32)).astype(np.int32)


def run(cfg, params, device, tokens=None) -> dict:
    """A forward pass, one AdamW step (``params`` updated in place) and a
    greedy generation of 8 tokens from the first 16 with the updated
    weights.  Returns the logits, the train step's metrics as floats and
    the generated tokens."""
    model = get_model(cfg)
    if tokens is None:
        tokens = draw_tokens(cfg)
    tokens = torch.as_tensor(tokens, dtype=torch.int32, device=device)

    with torch.inference_mode():
        logits, aux = model.forward(params, tokens)

    opt = AdamW()
    step = make_train_step(model, opt, device=device)
    params, _, metrics = step(params, opt.init(params), {"tokens": tokens})

    engine = InferenceEngine(cfg, params, max_len=MAX_LEN, device=device)
    out = engine.generate(tokens[:, :PROMPT], max_new_tokens=NEW_TOKENS)
    return {"logits": logits, "aux": float(aux),
            "loss": float(metrics["loss"]),
            "grad_norm": float(metrics["grad_norm"]), "generated": out}


def check(cfg, out: dict) -> None:
    """The example's invariants: the logits [B, S, v] and the step's loss
    and gradient norm finite, and [B, 8] tokens inside the vocabulary."""
    logits, gen = out["logits"], out["generated"]
    batch = logits.shape[0]
    if logits.dim() != 3 or not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"forward: logits {tuple(logits.shape)} "
                             "not finite or misshapen")
    if not (np.isfinite(out["loss"]) and np.isfinite(out["grad_norm"])):
        raise AssertionError(f"train step: loss {out['loss']} grad_norm "
                             f"{out['grad_norm']}")
    if tuple(gen.shape) != (batch, NEW_TOKENS) or \
            int(gen.min()) < 0 or int(gen.max()) >= cfg.vocab_size:
        raise AssertionError(f"generate: tokens {gen.tolist()}")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-8b")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch).reduced()          # 2 layers, CPU-sized
    params = get_model(cfg).init(seed=0, device=device)
    print(f"arch={cfg.name} family={cfg.family} d_model={cfg.d_model}")

    out = run(cfg, params, device)
    print(f"forward: logits {tuple(out['logits'].shape)}, "
          f"aux={out['aux']:.4f}")
    print(f"train step: loss={out['loss']:.4f} "
          f"grad_norm={out['grad_norm']:.3f}")
    gen = out["generated"]
    print(f"generated: {tuple(gen.shape)} -> {gen[0].tolist()}")
    check(cfg, out)
    return out


if __name__ == "__main__":
    main()
