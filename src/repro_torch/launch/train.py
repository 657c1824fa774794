"""Training launcher of the port.

On the card (llama32-3b at full width fits one H100 80GB):
  PYTHONPATH=src python -m repro_torch.launch.train --arch llama32-3b \
      --steps 8 --batch 2 --seq 512

On the CPU, a reduced config (the plain versions of the kernels):
  PYTHONPATH=src python -m repro_torch.launch.train --arch internlm2-1.8b \
      --reduced --device cpu --steps 5

Counterpart of ``repro.launch.train`` with the same flags, plus
``--device`` (default the card; it raises when there is none).  ``--mesh``
is parsed and not read, as in JAX's launcher (ROADMAP C17): the launcher
trains on one device.  A sharded train step runs under a ``DeviceMesh``
set in ``runtime.meshctx`` (``launch/dryrun.py`` drives one), its batch
from ``data.pipeline.SyntheticTokens.global_array``.  The weights are drawn from ``--seed`` by the
port's ``Model.init`` (other draws than JAX's); the tokens, and the vlm's
image-prefix embeddings and the encoder's frames and targets, are the
arrays JAX's launcher makes from the same seed.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch


def make_batch(cfg, tokens, rng, batch: int, seq: int, dtype):
    """One step's batch as JAX's launcher draws it (numpy, then the model's
    type)."""
    out = {"tokens": torch.from_numpy(tokens)}
    if cfg.family == "vlm":
        out["prefix_emb"] = torch.from_numpy(rng.standard_normal(
            (batch, cfg.num_prefix_tokens, cfg.d_model))).to(dtype) * 0.02
    if cfg.family == "encoder":
        out = {"features": torch.from_numpy(rng.standard_normal(
                   (batch, seq, cfg.d_model))).to(dtype),
               "targets": torch.from_numpy(tokens[:, :seq] % cfg.vocab_size)}
    return out


def main(argv=None):
    """Train; returns the per-step metrics as floats."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--mesh", default=None,
                    help="data,model dims e.g. 16,16 (default: single device)")
    ap.add_argument("--loss-impl", default="dense", choices=["dense", "fused"])
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card ('cpu' runs the plain "
                         "versions of the kernels)")
    args = ap.parse_args(argv)

    from repro_torch.checkpoint import save_checkpoint
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticTokens
    from repro_torch.models.layers import torch_dtype
    from repro_torch.models.transformer import get_model, resolve_device
    from repro_torch.optim.adamw import AdamW, cosine_schedule
    from repro_torch.runtime.train import make_train_step

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = get_model(cfg)
    params = model.init(seed=args.seed, device=dev)
    n_params = sum(p.numel() for p in params["blocks"].values()) + sum(
        p.numel() for k, p in params.items() if k != "blocks")
    print(f"arch={cfg.name} params={n_params/1e6:.2f}M family={cfg.family} "
          f"device={dev}")

    optimizer = AdamW(lr=cosine_schedule(args.lr, 10, args.steps))
    opt_state = optimizer.init(params)
    step_fn = make_train_step(model, optimizer, args.loss_impl, device=dev)

    data = SyntheticTokens(cfg.vocab_size, args.seq + 1, args.batch,
                           seed=args.seed)
    rng = np.random.default_rng(args.seed)
    history = []
    t0 = time.time()
    for step, tokens in enumerate(data):
        if step >= args.steps:
            break
        batch = make_batch(cfg, tokens, rng, args.batch, args.seq,
                       torch_dtype(cfg.dtype))
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        history.append({k: float(v) for k, v in metrics.items()})
        if step % max(args.steps // 10, 1) == 0 or step == args.steps - 1:
            m = history[-1]
            print(f"step {step:5d}  loss {m['loss']:8.4f}  "
                  f"gnorm {m['grad_norm']:8.3f}  lr {m['lr']:.2e}")
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.time() - t0
    print(f"{args.steps} steps in {dt:.1f}s "
          f"({args.steps * args.batch * args.seq / dt:.0f} tok/s)")
    if args.checkpoint:
        save_checkpoint(args.checkpoint, {"params": params}, args.steps)
        print(f"saved checkpoint to {args.checkpoint}")
    return history


if __name__ == "__main__":
    main()
