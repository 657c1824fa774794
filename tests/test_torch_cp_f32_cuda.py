"""Context parallelism at full width in float32 against the c = 1 path,
on one card: whether the bf16 disagreement that ``chip_smoke.py`` phase 8
reads at (t, c, p) = (1, 2, 1) against ``Model`` is the rounding of the
shards' GEMMs (a CP shard's [S/c, h] products round otherwise than the
whole sequence's [S, h] ones).

The weights are the smoke's (llama32-3b's seed-0 init, cut to
``chip_smoke.LLAMA_DEPTH`` layers as the smoke runs it, and all 28) and
the prompt is phase 8's; its measure (``chip_smoke.teacher_forced``: a
128-token prefill and 128 decode steps, 129 positions, scored by
``chip_smoke.agreement``) is taken in bf16 as the phase takes it and with
the same weights cast to float32, TF32 off.  Each case prints one JSON
line per dtype: the top-1 match and max logit drift of the CP prefill
(phase 8's ``chip_smoke.cp_model``) against ``Model``'s, and of the
c = 1 ``TPModel`` at t = 1 against ``Model``'s (the same GEMM shapes as
``Model``: the yardstick).  Held: in float32 the CP run matches every
position with a drift under 1e-3, and ``TPModel`` at t = 1 is bitwise
``Model`` in both dtypes.  Needs a CUDA card (marker ``gpu``; skipped
without one):

    python -m pytest -q -s -p no:cacheprovider --noconftest \\
        tests/test_torch_cp_f32_cuda.py
"""
import dataclasses
import json
import pathlib
import sys

import pytest

torch = pytest.importorskip("torch")

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
import chip_smoke as cs  # noqa: E402  (the repo root: phase 8's measure)


@pytest.mark.gpu
@pytest.mark.parametrize("depth", [cs.LLAMA_DEPTH, None],
                         ids=["smoke_depth", "all_layers"])
def test_f32_cp_prefill_agrees_with_model(depth):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.configs import get_config
    from repro_torch.core.parallel_exec import TPModel, shard_params
    from repro_torch.kernels import _build
    from repro_torch.models.transformer import get_model

    dev = torch.device("cuda", 0)
    print(cs.nvidia_smi_line(), flush=True)
    _build.build()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    full_cfg = get_config(cs.ARCH)
    depth = depth or full_cfg.num_layers
    params = cs.cut_depth(get_model(full_cfg).init(seed=0, device=dev),
                          depth)
    prompt = torch.randint(2, full_cfg.vocab_size, (1, cs.FORCED),
                           generator=torch.Generator().manual_seed(2)
                           ).to(dev)
    for dtype in ("bfloat16", "float32"):
        cfg = dataclasses.replace(full_cfg, num_layers=depth, dtype=dtype)
        dparams = params if dtype == "bfloat16" else {
            k: ({n: w.float() for n, w in v.items()}
                if isinstance(v, dict) else v.float())
            for k, v in params.items()}
        ref = cs.teacher_forced(get_model(cfg), dparams, prompt, False)
        model, mp = cs.cp_model(cfg, dparams, 1, 2, 1, dev)
        cp = cs.agreement(cs.teacher_forced(model, mp, prompt, False), ref)
        tp1 = cs.agreement(cs.teacher_forced(
            TPModel(cfg, 1), shard_params(cfg, dparams, 1), prompt, False),
            ref)
        print(json.dumps({"layers": depth, "dtype": dtype,
                          "positions": ref.shape[0],
                          "cp_1_2_1": {"match": cp[0], "drift": cp[1]},
                          "tp_1_1_1": {"match": tp1[0], "drift": tp1[1]}}),
              flush=True)
        assert tp1 == (1.0, 0.0), (dtype, tp1)
        if dtype == "float32":
            assert cp[0] == 1.0 and cp[1] < 1e-3, cp
        del model, mp, dparams, ref
