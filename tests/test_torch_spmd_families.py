"""The port's sharded step of the moe, ssm and hybrid families on a
``DeviceMesh`` against its closed form and JAX's compiled step.

  * Collectives: reduced deepseek-moe-16b, mixtral-8x22b, rwkv6-7b and
    hymba-1.5b on (data, model) = (1, 2) and (2, 2), prefill and decode on
    both and train on (2, 2); hymba-1.5b also on (1, 4), where in_proj
    splits and its d_inner leaves do not.  ``step_comm.summarize`` of the
    port's step on a fake process group equals ``step_comm.closed_form``.
    XLA's partitioner picks its own schedule for these families (the MoE
    dispatch through all-to-alls, RWKV's channel mix through repeated
    all-gathers, hymba's in_proj through collective-permutes), so the
    port's counts are not JAX's: its prefill and decode move at most the
    message bytes of JAX's compiled step (``hlo_comm.summarize``); both
    summaries are printed, and for train only printed.
  * ``op_cost``'s per-chip FLOPs of the prefill against the per-device
    module JAX compiles (``hlo_cost``, loops expanded): within 2% where
    the work per chip is the same, which is every case but the MoE on a
    split batch (there the port's rank runs its experts over its own data
    shard's pairs, XLA's partition of the global dispatch more: printed
    only).  hymba's scan forms y = s·C as an einsum in JAX, counted, and
    as an elementwise product and sum in the port, not counted: 0.1% of
    its FLOPs.
  * Full width: mixtral-8x22b ``decode_32k`` on (16, 16) through
    ``launch.dryrun.run_one`` (8 experts on 16: the stacks split on f; 8
    KV heads on 16 and a 4096-row window: the "seq" ring decode), equal to
    the closed form.
  * The local MoE dispatch (``moe_dispatch="local"``): reduced
    deepseek-moe-16b on (1, 2) and (2, 2) (4 experts on 2: stacks stored
    on E, redistributed to f by all-to-alls), with ``moe_fsdp`` on (2, 2)
    (the stacks' h over "data", gathered just in time), prefill and
    decode; mixtral-8x22b with 6 experts on (1, 4) (stored on f), prefill;
    deepseek train on (2, 2), with and without ``moe_fsdp``, and with it
    at a batch of one row, which "data" does not split.  Each equals
    the closed form, and its prefill and decode the collectives of JAX's
    compiled shard_map step (JAX's meshctx set, Auto axes); train's are
    printed.  At full width, deepseek-moe-16b ``decode_32k``
    ``moe_local`` runs ``ok`` through ``dryrun.run_one`` (the test's name
    is from before the local dispatch ran sharded).

The values of these families on gloo ranks are rows of
``test_torch_spmd.py``'s one spawn (``VALUE_RUNS``).
"""
import pytest

torch = pytest.importorskip("torch")

from repro.core import hlo_comm, hlo_cost  # noqa: E402
from repro_torch.configs import get_config as port_config  # noqa: E402
from repro_torch.core import step_comm  # noqa: E402

from test_torch_spmd import (_batch, _cfgs, _jax_text,  # noqa: E402,F401
                             _no_mesh_after, _port_step, _rows)

ARCHS = ["deepseek-moe-16b", "mixtral-8x22b", "rwkv6-7b", "hymba-1.5b"]
CASES = ([(a, m, mode) for a in ARCHS for m in [(1, 2), (2, 2)]
          for mode in ("prefill", "decode")]
         + [(a, (2, 2), "train") for a in ARCHS]
         + [("hymba-1.5b", (1, 4), mode)
            for mode in ("prefill", "decode", "train")])


def _msg_bytes(summary) -> int:
    return sum(v["msg_bytes"] for v in summary.values())


@pytest.mark.parametrize("arch,mesh_shape,mode", CASES,
                         ids=[f"{a}-{m[0]}x{m[1]}-{mode}"
                              for a, m, mode in CASES])
def test_collectives_hold_the_closed_form(arch, mesh_shape, mode):
    """The port's collectives equal their closed form; its prefill and
    decode move no more message bytes than JAX's compiled step."""
    _, tcfg = _cfgs(arch)
    got, form, _ = _port_step(tcfg, mesh_shape, mode)
    text, _ = _jax_text(arch, mesh_shape, mode)
    want = hlo_comm.summarize(hlo_comm.parse_hlo_collectives(text))
    print(f"{arch} {mesh_shape} {mode}: port {_rows(got)} "
          f"({_msg_bytes(got)} B) jax {_rows(want)} ({_msg_bytes(want)} B)")
    assert step_comm.same(got, form), _rows(form)
    if mode != "train":
        assert _msg_bytes(got) <= _msg_bytes(want)


# the local MoE dispatch (variants of torch_spmd_ranks.VARIANTS):
# deepseek's 4 experts on a model axis of 2 are stored on E (the step
# redistributes them to f), under moe_fsdp also split on h over "data";
# mixtral's 6 on 4 are stored on f
LOCAL_CASES = ([("deepseek-moe-16b", "local", m, mode)
                for m in [(1, 2), (2, 2)] for mode in ("prefill", "decode")]
               + [("deepseek-moe-16b", "local_fsdp", (2, 2), mode)
                  for mode in ("prefill", "decode")]
               + [("mixtral-8x22b", "e6_local", (1, 4), "prefill")]
               + [("deepseek-moe-16b", kv, (2, 2), "train")
                  for kv in ("local", "local_fsdp", "local_fsdp_b1")])


@pytest.mark.parametrize("arch,kv,mesh_shape,mode", LOCAL_CASES,
                         ids=[f"{a}-{kv}-{m[0]}x{m[1]}-{mode}"
                              for a, kv, m, mode in LOCAL_CASES])
def test_local_dispatch_holds_the_closed_form(arch, kv, mesh_shape, mode):
    """The local dispatch's collectives equal their closed form; its
    prefill and decode issue the collectives of JAX's compiled shard_map
    step (kind, count, message bytes: XLA redistributes E-stored stacks
    by all-to-alls too), so move no more message bytes."""
    _, tcfg = _cfgs(arch, kv)
    got, form, _ = _port_step(tcfg, mesh_shape, mode, rows=_batch(kv))
    text, _ = _jax_text(arch, mesh_shape, mode, kv, rows=_batch(kv))
    want = hlo_comm.summarize(hlo_comm.parse_hlo_collectives(text))
    print(f"{arch} {kv} {mesh_shape} {mode}: port {_rows(got)} "
          f"({_msg_bytes(got)} B) jax {_rows(want)} ({_msg_bytes(want)} B)")
    assert step_comm.same(got, form), _rows(form)
    stored_on_e = tcfg.moe.num_experts % mesh_shape[1] == 0
    assert ("alltoall" in got) == stored_on_e
    assert ("allgather" in got) == (tcfg.moe_fsdp or mode == "decode")
    if mode != "train":
        assert _msg_bytes(got) <= _msg_bytes(want)
        assert _rows(got) == _rows(want)


@pytest.mark.parametrize("mesh_shape", [(1, 2), (2, 2)], ids=["1x2", "2x2"])
@pytest.mark.parametrize("arch", ARCHS)
def test_op_cost_per_chip_flops_against_jax(arch, mesh_shape):
    _, tcfg = _cfgs(arch)
    # where the per-chip work of the two steps is the same (module doc)
    same_work = not (tcfg.family == "moe" and mesh_shape[0] > 1)
    _, _, cost = _port_step(tcfg, mesh_shape, "prefill", walk=True)
    text, _ = _jax_text(arch, mesh_shape, "prefill")
    flops, _ = hlo_cost.analyze_flops_bytes(text)
    top = sorted(cost.ops.items(), key=lambda kv: -kv[1][1])[:3]
    print(f"{arch} {mesh_shape}: port {cost.flops:.6g} jax {flops:.6g} "
          f"({cost.flops / flops:.4f}); the port's largest: "
          f"{[(k, v[1]) for k, v in top]}")
    assert cost.flops > 0 and cost.peak_bytes > 0
    if same_work:
        assert cost.flops == pytest.approx(flops, rel=0.02)


def test_full_width_mixtral_decode_matches_the_closed_form():
    """mixtral-8x22b decode_32k on (16, 16): the experts split on f, the
    batch of 128 split over 16 data shards (one all-gather of the
    experts' counts a layer), the "seq" decode's q, k, v gathers and
    MAX / SUM all-reduces a layer."""
    from repro_torch.launch import dryrun
    from repro_torch.models.blocks import kv_layout
    from repro_torch.runtime import sharding as sh
    cfg = port_config("mixtral-8x22b")
    specs = sh.param_specs(cfg, {"we1": torch.empty(
        (cfg.num_layers, 8, cfg.d_model, cfg.moe.expert_d_ff),
        device="meta")}, axis_size=16)
    assert specs["we1"] == sh.P(None, None, None, "model")
    assert kv_layout(cfg, 16, cfg.sliding_window) == "seq"
    rec = dryrun.run_one("mixtral-8x22b", "decode_32k", False)
    print(rec["collectives"], rec["seconds_to_compile"])
    assert rec["status"] == "ok" and rec["collectives_match"]
    L = cfg.num_layers
    # 2L + 1 layer and embedding sums, 2L partial softmax (MAX, SUM)
    assert rec["collectives"]["allreduce"]["count"] == 4 * L + 1
    # q, k, v a layer, the expert counts a layer, the argmax's two
    assert rec["collectives"]["allgather"]["count"] == 4 * L + 2


def test_moe_local_variant_is_not_ported():
    """Named when the local dispatch did not run on a DeviceMesh; now
    deepseek-moe-16b ``decode_32k`` ``moe_local`` on (16, 16) is ``ok``
    and equal to the closed form: 64 experts on 16 are stored on E and
    redistributed to f, three all-to-alls a layer; the batch of 128 on 16
    data shards, each routing its own 8 tokens (no gather of counts); 16
    KV heads on 16 (no attention gathers)."""
    from repro_torch.launch import dryrun
    rec = dryrun.run_one("deepseek-moe-16b", "decode_32k", False,
                         "moe_local")
    print(rec["collectives"], rec["seconds_to_compile"])
    assert rec["status"] == "ok" and rec["collectives_match"]
    cfg = port_config("deepseek-moe-16b")
    L, E, h, f = (cfg.num_layers, cfg.moe.num_experts, cfg.d_model,
                  cfg.moe.expert_d_ff)
    got = {k: (v["count"], v["msg_bytes"])
           for k, v in rec["collectives"].items()}
    # the embedding's and 2 a layer; the argmax's two gathers of [8, 16]
    assert got["allreduce"][0] == 2 * L + 1
    assert got["allgather"][0] == 2
    assert got["alltoall"] == (3 * L, 3 * L * E * h * f // 16 * 2)
