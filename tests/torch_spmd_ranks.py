"""The program of the gloo ranks of ``test_torch_spmd.py``'s values test.

A module of its own, without JAX, so that each spawned rank imports only
the port.  ``values_rank`` runs every case sharded on a ``DeviceMesh`` of
the ranks and unsharded, and rank 0 writes the comparisons as JSON.
"""
import dataclasses
import json

import numpy as np
import torch


def _port_cfg(arch, kv):
    from repro_torch.configs import get_config
    cfg = get_config(arch).reduced()
    return cfg if kv is None else dataclasses.replace(cfg, num_kv_heads=kv)


def values_rank(rank, world, port, runs, refs, new_tokens, out_path):
    """One gloo rank.  ``runs``: (arch, KV heads or None, mesh shape,
    checks); ``refs``: per run (numpy JAX params, inputs, JAX's logits,
    JAX's greedy tokens, JAX's train step or None: its loss, grad_norm,
    gradients and updated parameters, numpy)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch import bridge
    from repro_torch.checkpoint.store import flatten
    from repro_torch.launch import specs
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.transformer import get_model, greedy_tokens
    from repro_torch.optim.adamw import AdamW
    from repro_torch.runtime import meshctx
    from repro_torch.runtime import sharding as sh
    from repro_torch.runtime.engine import make_serve_step
    from repro_torch.runtime.train import make_train_step

    @dataclasses.dataclass(frozen=True)
    class KeepGrads(AdamW):
        """AdamW that keeps the gradients the train step hands it (the
        step's own, before their reduction over the batch axes)."""
        kept: list = dataclasses.field(default_factory=list)

        def update(self, grads, state, params):
            self.kept.append(grads)
            return super().update(grads, state, params)

    torch.set_num_threads(1)      # four ranks share the host's cores
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    results = []
    try:
        for (arch, kv, mesh_shape, checks), ref in zip(runs, refs):
            np_params, inp, jax_logits, jax_tokens, jax_train = ref
            tcfg = _port_cfg(arch, kv)
            model = get_model(tcfg, plain=True)

            def fresh():
                return bridge.params_from_jax(np_params, tcfg, device="cpu")
            vm = make_mesh(mesh_shape, ("data", "model"))
            dmesh = init_device_mesh("cpu", mesh_shape,
                                     mesh_dim_names=("data", "model"))
            _, pspecs = specs.param_sds(tcfg, vm)
            t = {k: torch.from_numpy(v) for k, v in inp.items()}
            row = {"case": f"{arch}-kv{kv}-{tuple(mesh_shape)}"}

            def forward(p):
                with torch.no_grad():
                    if tcfg.family == "encoder":
                        return model.forward(p, features=t["features"])[0]
                    return model.forward(p, t["tokens"],
                                         prefix_emb=t.get("prefix_emb"))[0]

            def generate(p):
                with torch.no_grad():
                    lg, cache, pos = model.prefill(
                        p, t["tokens"], 32, prefix_emb=t.get("prefix_emb"))
                    tok = greedy_tokens(lg)
                    toks = [tok]
                    step = make_serve_step(model)
                    for i in range(new_tokens):
                        tok, cache = step(p, cache, tok, pos + i)
                        toks.append(tok)
                return toks

            batch = dict(t)
            if tcfg.family == "encoder":
                batch["targets"] = batch["targets"].long()

            def train(p):
                opt = KeepGrads()
                p, _, met = make_train_step(model, opt, device="cpu")(
                    p, opt.init(p), batch)
                return p, met, opt.kept[0]

            plain = fresh()
            ref_logits = forward(plain)
            ref_tokens = generate(plain) if "decode" in checks else None
            ref_train = train(fresh()) if "train" in checks else None
            meshctx.set_device_mesh(dmesh)
            try:
                placed = sh.distribute(fresh(), pspecs, dmesh)
                logits = forward(placed).full_tensor()
                row["logit_err_plain"] = float(
                    (logits - ref_logits).abs().max())
                row["logit_err_jax"] = float(
                    (logits - torch.from_numpy(jax_logits)).abs().max())
                row["logit_scale"] = float(ref_logits.abs().max())
                if "decode" in checks:
                    toks = torch.stack([x.full_tensor()
                                        for x in generate(placed)], 1)
                    row["tokens_equal_plain"] = bool(torch.equal(
                        toks, torch.stack(ref_tokens, 1)))
                    row["tokens_equal_jax"] = bool(np.array_equal(
                        toks.numpy(), jax_tokens))
                if "train" in checks:
                    p2, met, grads = train(
                        sh.distribute(fresh(), pspecs, dmesh))
                    row.update(_train_row(
                        flatten(fresh()), flatten(p2), met, flatten(grads),
                        ref_train, jax_train, tcfg))
            finally:
                meshctx.set_device_mesh(None)
            results.append(row)
    finally:
        dist.destroy_process_group()
    if rank == 0:
        with open(out_path, "w") as f:
            json.dump(results, f)


def _train_row(p0, p2, met, grads, ref_train, jax_train, tcfg):
    """The sharded train step against JAX's on the same inputs and the
    port's unsharded step: the loss and grad_norm; every gradient leaf's
    excess over 1e-5 + 1e-4·|g_jax| (at most 0 where it holds); and each
    leaf's update p2 - p0 against the references', as the norm of the
    difference over the norm of the reference update (an update that
    moved nothing is 1, one the wrong way 2).  Adam's first update is
    about lr·sign(g), but where |g| is near its eps (1e-8) an entry
    swings with the gradients' f32 noise; the norm weighs those few
    entries by their count."""
    from repro_torch import bridge
    from repro_torch.checkpoint.store import flatten

    def full(t):
        return t.full_tensor() if hasattr(t, "full_tensor") else t

    p_plain, met_plain, _ = ref_train
    p_plain = flatten(p_plain)
    p_jax = flatten(bridge.params_from_jax(jax_train["params"], tcfg,
                                           device="cpu"))
    g_jax = flatten(bridge.params_from_jax(jax_train["grads"], tcfg,
                                           device="cpu"))
    row = {"loss": float(full(met["loss"])),
           "loss_plain": float(met_plain["loss"]),
           "loss_jax": jax_train["loss"],
           "grad_norm": float(full(met["grad_norm"])),
           "grad_norm_jax": jax_train["grad_norm"],
           "grad_excess": -1.0, "update_err_jax": 0.0,
           "update_err_plain": 0.0}
    for k, gj in g_jax.items():
        g = full(grads[k])
        row["grad_excess"] = max(row["grad_excess"], float(
            ((g - gj).abs() - (1e-5 + 1e-4 * gj.abs())).max()))
        step = full(p2[k]) - p0[k]
        for ref, name in ((p_jax[k], "jax"), (p_plain[k], "plain")):
            want = ref - p0[k]
            row[f"update_err_{name}"] = max(
                row[f"update_err_{name}"],
                float((step - want).norm() / want.norm().clamp_min(1e-30)))
    return row


def kernel_rank(rank, world, port, new_tokens, out_path):
    """One NCCL rank on card ``rank``: reduced granite-8b with 2 KV heads
    (f32) on a (1, world) mesh, so a prefill gathers K and V and a decode
    step runs on a sequence-parallel cache (B3's split pass on the rank's
    rows, then the MAX and SUM all-reduces), through the kernels, against
    the unsharded kernel path on the same card.  Rank 0 writes the
    comparison and the sharded run's launch counts as JSON."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.kernels import _build
    from repro_torch.launch import specs
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.blocks import kv_layout
    from repro_torch.models.transformer import get_model, greedy_tokens
    from repro_torch.runtime import meshctx
    from repro_torch.runtime import sharding as sh

    dev = torch.device("cuda", rank)
    torch.cuda.set_device(dev)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    try:
        cfg = _port_cfg("granite-8b", 2)
        model = get_model(cfg)
        params = model.init(seed=0, device=dev)
        tokens = torch.randint(0, cfg.vocab_size, (2, 16),
                               generator=torch.Generator().manual_seed(1)
                               ).to(dev)
        width = 32

        def generate(p):
            logits, toks = [], []
            with torch.no_grad():
                lg, cache, pos = model.prefill(p, tokens, width)
                for i in range(new_tokens + 1):
                    logits.append(lg.full_tensor() if sh.is_dtensor(lg)
                                  else lg)
                    toks.append(greedy_tokens(lg))
                    if i < new_tokens:
                        lg, cache = model.decode_step(p, cache, toks[-1],
                                                      pos + i)
            return logits, [t.full_tensor() if sh.is_dtensor(t) else t
                            for t in toks]

        want_logits, want_toks = generate(params)
        dmesh = init_device_mesh("cuda", (1, world),
                                 mesh_dim_names=("data", "model"))
        _, pspecs = specs.param_sds(cfg, make_mesh((1, world),
                                                   ("data", "model")))
        placed = sh.distribute(params, pspecs, dmesh)
        meshctx.set_device_mesh(dmesh)
        _build.reset_launches()
        try:
            logits, toks = generate(placed)
            torch.cuda.synchronize()
        finally:
            meshctx.set_device_mesh(None)
        row = {"layout": kv_layout(cfg, world, width),
               "launches": dict(_build.LAUNCHES),
               "layers": cfg.num_layers,
               "logit_err": max(float((a - b).abs().max())
                                for a, b in zip(logits, want_logits)),
               "logit_scale": max(float(b.abs().max())
                                  for b in want_logits),
               "tokens_equal": all(torch.equal(a, b)
                                   for a, b in zip(toks, want_toks))}
    finally:
        dist.destroy_process_group()
    if rank == 0:
        with open(out_path, "w") as f:
            json.dump(row, f)
