"""Serving launcher of the port: batched greedy generation with a KV cache.

On the card:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama32-3b \
      --batch 4 --prompt-len 32 --new-tokens 16

On the CPU, a reduced config (the plain versions of the kernels):
  PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-8b \
      --reduced --device cpu --batch 4 --prompt-len 32 --new-tokens 16

Counterpart of ``repro.launch.serve`` with the same flags plus
``--device`` (default the card; it raises when there is none).  The
weights are drawn from ``--seed`` by the port's ``Model.init`` (other
draws than JAX's); the prompts, the encoder's frames and the vlm's
image-prefix embeddings are the arrays JAX's launcher draws from the same
seed.  An encoder-only arch encodes its frames.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch


def main(argv=None):
    """Run the launcher; returns (its inputs, its output): the prompts
    and the generated tokens [B, new], or the frames and the logits."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    from repro_torch.configs import get_config
    from repro_torch.models.layers import torch_dtype
    from repro_torch.models.transformer import get_model, resolve_device
    from repro_torch.runtime.engine import InferenceEngine

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    dtype = torch_dtype(cfg.dtype)
    params = get_model(cfg).init(seed=args.seed, device=device)
    max_len = args.prompt_len + args.new_tokens + cfg.num_prefix_tokens + 8
    engine = InferenceEngine(cfg, params, max_len=max_len, device=device)

    rng = np.random.default_rng(args.seed)
    if cfg.family == "encoder":
        feats = torch.from_numpy(rng.standard_normal(
            (args.batch, args.prompt_len, cfg.d_model))).to(dtype)
        t0 = time.time()
        logits = engine.encode(feats)
        print(f"encoded {tuple(feats.shape)} -> {tuple(logits.shape)} "
              f"in {time.time()-t0:.2f}s")
        return feats, logits

    prompts = torch.from_numpy(rng.integers(
        2, cfg.vocab_size, (args.batch, args.prompt_len))).to(torch.int32)
    kw = {}
    if cfg.family == "vlm":
        kw["prefix_emb"] = torch.from_numpy(rng.standard_normal(
            (args.batch, cfg.num_prefix_tokens, cfg.d_model))).to(
            dtype) * 0.02
    t0 = time.time()
    out = engine.generate(prompts, max_new_tokens=args.new_tokens, **kw)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.time() - t0
    print(f"generated {tuple(out.shape)} in {dt:.2f}s "
          f"({args.batch * args.new_tokens / dt:.1f} tok/s)")
    print("first sequence:", out[0].tolist())
    return prompts, out


if __name__ == "__main__":
    main()
