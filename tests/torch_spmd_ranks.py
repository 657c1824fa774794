"""The program of the gloo ranks of ``test_torch_spmd.py``'s values test.

A module of its own, without JAX, so that each spawned rank imports only
the port.  ``values_rank`` runs every case sharded on a ``DeviceMesh`` of
the ranks and unsharded, and rank 0 writes the comparisons as JSON.
"""
import dataclasses
import json

import numpy as np
import torch


# named replacements of a reduced config (the JAX package's and the
# port's configs take the same fields)
VARIANTS = {
    # capacity 1.0: the reduced 4.0 never drops a pair (cap = T·K at E = 4,
    # K = 2); this one drops pairs, across data shards too
    "cap1": {"moe": {"capacity_factor": 1.0}},
    # 6 experts, which do not divide a model axis of 4: the stacks split
    # on f, as mixtral-8x22b's 8 on 16
    "e6": {"moe": {"num_experts": 6}},
    "chunked": {"ssm": {"scan_impl": "chunked"}},
    # 2 KV heads (n_attn 2 of hymba's 4) and a window of 12 under a
    # 16-token prompt plus 8 decode steps: on a model axis of 4 the prefill
    # gathers K/V over partial heads and decodes on a wrapped "seq" ring
    "kv2w12": {"num_kv_heads": 2, "sliding_window": 12},
    # a head dim the attention kernels take (the reduced 66 is none)
    "d64": {"head_dim": 64},
    # the local dispatch (JAX's shard_map path): each data shard routes its
    # own tokens against its own capacity, the experts split on f
    "local": {"moe_dispatch": "local"},
    "cap1_local": {"moe": {"capacity_factor": 1.0}, "moe_dispatch": "local"},
    "local_fsdp": {"moe_dispatch": "local", "moe_fsdp": True},
    "e6_local": {"moe": {"num_experts": 6}, "moe_dispatch": "local"},
    # run at the batch BATCH gives it
    "local_fsdp_b1": {"moe_dispatch": "local", "moe_fsdp": True},
}
# a variant's batch where it is not the tests' own: one row, which a data
# axis of 2 does not split (every data shard computes the whole batch, and
# moe_fsdp's gathered stacks keep their own block of the whole gradient)
BATCH = {"local_fsdp_b1": 1}


def replaced(cfg, kv):
    """``cfg`` with ``kv`` KV heads (an int), or the named ``VARIANTS``
    entry's fields (a str), or as it is (None)."""
    if kv is None:
        return cfg
    if isinstance(kv, int):
        return dataclasses.replace(cfg, num_kv_heads=kv)
    fields = {}
    for name, value in VARIANTS[kv].items():
        if isinstance(value, dict):
            value = dataclasses.replace(getattr(cfg, name), **value)
        fields[name] = value
    return dataclasses.replace(cfg, **fields)


def case_name(arch, kv, mesh_shape):
    return f"{arch}-kv{kv}-{tuple(mesh_shape)}"


def _port_cfg(arch, kv):
    from repro_torch.configs import get_config
    return replaced(get_config(arch).reduced(), kv)


class DropLog:
    """The dropped (token, choice) pairs, [T, K] bool, of every
    ``moe.dispatch_plan`` call while active."""

    def __enter__(self):
        from repro_torch.models import moe
        self.lib, self.orig, self.calls = moe, moe.dispatch_plan, []

        def logged(*args):
            out = self.orig(*args)
            self.calls.append(~out[3])
            return out
        moe.dispatch_plan = logged
        return self

    def __exit__(self, *exc):
        self.lib.dispatch_plan = self.orig


def _same_drops(got, ref, shard: int) -> bool:
    """Whether a rank's dispatches (``got``, one a layer and pass, on its
    data shard ``shard``) dropped the pairs the reference's did: the
    reference dispatches every data shard of a split batch in turn."""
    if not got or len(ref) % len(got):
        return False
    per = len(ref) // len(got)
    return all(torch.equal(g, ref[n * per + (shard if per > 1 else 0)])
               for n, g in enumerate(got))


def values_rank(rank, world, port, runs, refs, new_tokens, out_path):
    """One gloo rank.  ``runs``: (arch, KV heads or None, mesh shape,
    checks); ``refs``: per run (numpy JAX params, inputs, JAX's logits,
    JAX's greedy tokens, JAX's train step or None: its loss, grad_norm,
    gradients and updated parameters, numpy; JAX's aux loss).  A config on
    the local MoE dispatch is held to the port's ``moe_ffn_local`` on a
    ``core.comm.VirtualMesh`` of the mesh's shape (its "plain" reference:
    the unsharded model with that mesh in ``meshctx``), with the dropped
    pairs of each rank's data shard, and to JAX's shard_map path."""
    import contextlib

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch import bridge
    from repro_torch.checkpoint.store import flatten
    from repro_torch.core.comm import VirtualMesh
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
            np_params, inp, jax_logits, jax_tokens, jax_train, jax_aux = ref
            tcfg = _port_cfg(arch, kv)
            model = get_model(tcfg, plain=True)
            local = tcfg.family == "moe" and tcfg.moe_dispatch == "local"

            @contextlib.contextmanager
            def reference_mesh():
                """The VirtualMesh of a local-dispatch config."""
                meshctx.set_mesh(VirtualMesh(mesh_shape, ("data", "model"))
                                 if local else None)
                try:
                    yield
                finally:
                    meshctx.set_mesh(None)

            def fresh():
                return bridge.params_from_jax(np_params, tcfg, device="cpu")
            vm = make_mesh(mesh_shape, ("data", "model"))
            dmesh = init_device_mesh("cpu", mesh_shape,
                                     mesh_dim_names=("data", "model"))
            _, pspecs = specs.param_sds(tcfg, vm)
            t = {k: torch.from_numpy(v) for k, v in inp.items()}
            row = {"case": case_name(arch, kv, mesh_shape)}

            def forward(p):
                with torch.no_grad():
                    if tcfg.family == "encoder":
                        return model.forward(p, features=t["features"])
                    return model.forward(p, t["tokens"],
                                         prefix_emb=t.get("prefix_emb"))

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
            trains = "train" in checks or "train_plain" in checks
            with reference_mesh(), DropLog() as ref_drops:
                ref_logits, ref_aux = forward(plain)
                ref_tokens = generate(plain) if "decode" in checks else None
            with reference_mesh():
                ref_train = train(fresh()) if trains else None
            meshctx.set_device_mesh(dmesh)
            try:
                placed = sh.distribute(fresh(), pspecs, dmesh)
                with DropLog() as drops:
                    logits, aux = forward(placed)
                    toks = (torch.stack([x.full_tensor()
                                         for x in generate(placed)], 1)
                            if "decode" in checks else None)
                logits = logits.full_tensor()
                aux = float(aux.full_tensor() if sh.is_dtensor(aux) else aux)
                row["logit_err_plain"] = float(
                    (logits - ref_logits).abs().max())
                row["logit_err_jax"] = float(
                    (logits - torch.from_numpy(jax_logits)).abs().max())
                row["logit_scale"] = float(ref_logits.abs().max())
                row["aux_err_plain"] = abs(aux - float(ref_aux))
                row["aux_err_jax"] = abs(aux - jax_aux)
                if local:
                    same = torch.tensor(int(_same_drops(
                        drops.calls, ref_drops.calls, sh.batch_index())))
                    dist.all_reduce(same, op=dist.ReduceOp.MIN)
                    row["drops_equal"] = bool(same)
                    row["drops"] = int(sum(d.sum() for d in ref_drops.calls))
                if "decode" in checks:
                    row["tokens_equal_plain"] = bool(torch.equal(
                        toks, torch.stack(ref_tokens, 1)))
                    row["tokens_equal_jax"] = bool(np.array_equal(
                        toks.numpy(), jax_tokens))
                if trains:
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
           "grad_norm_plain": float(met_plain["grad_norm"]),
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


def kernel_rank(rank, world, port, cases, new_tokens, out_path):
    """One NCCL rank on card ``rank``: each case (arch, KV heads or None)
    reduced, in f32, on a (1, world) mesh, a prefill and ``new_tokens``
    decode steps through the kernels, against the unsharded kernel path
    on the same card.  Reduced granite-8b with 2 KV heads gathers K and V
    in the prefill and decodes on a sequence-parallel cache (B3's split
    pass on the rank's rows, then the MAX and SUM all-reduces); rwkv6-7b
    runs B10 on the rank's head; hymba-1.5b at head dim 64 B2 and B3 on
    its attention head and the mamba branch on its 16 channels;
    deepseek-moe-16b on the local dispatch its f block of every expert,
    the stacks redistributed from E by all-to-alls.  Rank 0 writes, per
    case, the comparison, the sharded run's launch counts and its
    collectives (kind: [calls, group sizes]) as JSON."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.core import step_comm
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
    rows = []
    try:
        dmesh = init_device_mesh("cuda", (1, world),
                                 mesh_dim_names=("data", "model"))
        for arch, kv in cases:
            cfg = _port_cfg(arch, kv)
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
            _, pspecs = specs.param_sds(cfg, make_mesh((1, world),
                                                       ("data", "model")))
            placed = sh.distribute(params, pspecs, dmesh)
            meshctx.set_device_mesh(dmesh)
            _build.reset_launches()
            try:
                (logits, toks), log_ = step_comm.record(generate, placed)
                torch.cuda.synchronize()
            finally:
                meshctx.set_device_mesh(None)
            colls = {}
            for c in log_:
                row = colls.setdefault(c.kind, [0, []])
                row[0] += 1
                row[1] = sorted(set(row[1]) | {c.group_size})
            rows.append({
                "case": case_name(arch, kv, (1, world)),
                "layout": (kv_layout(cfg, world, width)
                           if cfg.family != "ssm" else None),
                "launches": dict(_build.LAUNCHES),
                "collectives": colls,
                "layers": cfg.num_layers,
                "logit_err": max(float((a - b).abs().max())
                                 for a, b in zip(logits, want_logits)),
                "logit_scale": max(float(b.abs().max())
                                   for b in want_logits),
                "tokens_equal": all(torch.equal(a, b)
                                    for a, b in zip(toks, want_toks))})
            del params, placed
    finally:
        dist.destroy_process_group()
    if rank == 0:
        with open(out_path, "w") as f:
            json.dump(rows, f)
