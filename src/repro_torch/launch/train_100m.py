"""Train a ~100M-parameter model for a few hundred steps on the synthetic
pipeline: the end-to-end training launcher at example scale.

    PYTHONPATH=src python -m repro_torch.launch.train_100m --steps 200
    PYTHONPATH=src python -m repro_torch.launch.train_100m --device cpu \
        --steps 5 --batch 2 --seq 64

Counterpart of ``examples/train_100m.py`` (the same config and loop), plus
``--device`` (default the card; it raises when there is none).  The
weights are drawn by the port's ``Model.init`` from seed 0.
"""
import argparse
import dataclasses
import time


def config():
    """~100M parameters: a 12-layer, d = 512 llama-family model with an 8k
    vocab, f32 (internlm2-1.8b's shape, cut down)."""
    from repro_torch.configs import get_config
    return dataclasses.replace(
        get_config("internlm2-1.8b"), name="repro-100m", num_layers=12,
        d_model=512, num_heads=8, num_kv_heads=4, head_dim=64, d_ff=2048,
        vocab_size=8192, dtype="float32")


def main(argv=None):
    """Train; returns (first loss, last loss)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card")
    args = ap.parse_args(argv)

    import torch

    from repro_torch.checkpoint import save_checkpoint
    from repro_torch.data.pipeline import SyntheticTokens
    from repro_torch.models.transformer import get_model, resolve_device
    from repro_torch.optim.adamw import AdamW, cosine_schedule
    from repro_torch.runtime.train import make_train_step

    dev = resolve_device(args.device)
    cfg = config()
    model = get_model(cfg)
    params = model.init(seed=0, device=dev)
    n = sum(p.numel() for p in params["blocks"].values()) + sum(
        p.numel() for k, p in params.items() if k != "blocks")
    print(f"{cfg.name}: {n/1e6:.1f}M params, {args.steps} steps on {dev}")

    opt = AdamW(lr=cosine_schedule(3e-4, 20, args.steps))
    opt_state = opt.init(params)
    step_fn = make_train_step(model, opt, device=dev)
    data = SyntheticTokens(cfg.vocab_size, args.seq + 1, args.batch, seed=0)

    t0, first_loss = time.time(), None
    for step, tokens in enumerate(data):
        if step >= args.steps:
            break
        params, opt_state, m = step_fn(params, opt_state,
                                       {"tokens": torch.from_numpy(tokens)})
        if first_loss is None:
            first_loss = float(m["loss"])
        if step % 20 == 0 or step == args.steps - 1:
            print(f"step {step:4d}  loss {float(m['loss']):7.4f}  "
                  f"lr {float(m['lr']):.2e}")
    last_loss = float(m["loss"])
    dt = time.time() - t0
    print(f"done: loss {first_loss:.3f} -> {last_loss:.3f} "
          f"({args.steps*args.batch*args.seq/dt:.0f} tok/s)")
    if args.checkpoint:
        save_checkpoint(args.checkpoint, {"params": params}, args.steps)
    return first_loss, last_loss


if __name__ == "__main__":
    main()
