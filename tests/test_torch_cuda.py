"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA card (marker ``gpu``) and skips where there is
none; the card is looked for inside a fixture.  The file imports neither
JAX nor the JAX package, so it runs on a machine with only PyTorch:

    python -m pytest -q -p no:cacheprovider --noconftest tests/test_torch_cuda.py

Tolerances: bf16 rounds the output once on each side, so the two may land
one bf16 ulp apart (2^-8 relative); f32 differs only in summation order.
The shapes are small and ragged on purpose (odd lengths, partial tiles, a
hidden width with no 16-byte vector path); ``chip_smoke.py`` checks the
full model's shapes.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.decode_attention import ops as dops  # noqa: E402
from repro_torch.kernels.decode_attention import ref as dref  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fops  # noqa: E402
from repro_torch.kernels.flash_attention import ref as fref  # noqa: E402
from repro_torch.kernels.rmsnorm import ops as rops  # noqa: E402
from repro_torch.kernels.rmsnorm import ref as rref  # noqa: E402

DTYPES = [pytest.param(torch.float32, 1e-4, id="f32"),
          pytest.param(torch.bfloat16, 2e-2, id="bf16")]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _rand(dev, dtype, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    return lambda *shape: torch.randn(shape, generator=g, device=dev).to(dtype)


def _i32(dev, vals):
    return torch.tensor(vals, dtype=torch.int32, device=dev)


def _close(a, b, tol):
    torch.testing.assert_close(a.float(), b.float(), atol=tol, rtol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("rows,h", [(5, 3072), (3, 100), (1, 8)])
def test_rmsnorm_kernel(cuda, dtype, tol, rows, h):
    rnd = _rand(cuda, dtype)
    x, w = rnd(rows, h), 0.1 * rnd(h)
    _close(rops.rms_norm_cuda(x, w), rref.rms_norm_ref(x, w), tol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("d,hkv,g,window", [(128, 8, 3, None),
                                            (64, 2, 2, 17), (32, 1, 4, None)])
def test_flash_kernel(cuda, dtype, tol, d, hkv, g, window):
    rnd = _rand(cuda, dtype, seed=d)
    q, k, v = rnd(2, 77, hkv * g, d), rnd(2, 90, hkv, d), rnd(2, 90, hkv, d)
    off, kl = _i32(cuda, [0, 13]), _i32(cuda, [77, 90])
    _close(fops.flash_attention_cuda(q, k, v, off, kl, window),
           fref.flash_attention_ref(q, k, v, off, kl, window), tol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("d,g", [(128, 3), (64, 1), (32, 8)])
def test_decode_kernel(cuda, dtype, tol, d, g):
    rnd = _rand(cuda, dtype, seed=g)
    q, k, v = rnd(3, 2 * g, d), rnd(3, 90, 2, d), rnd(3, 90, 2, d)
    lens = _i32(cuda, [1, 40, 90])
    _close(dops.decode_attention_cuda(q, k, v, lens),
           dref.decode_attention_ref(q, k, v, lens), tol)
    # a strided view: one layer of a [L, B, W, Hkv, D] cache is contiguous,
    # a slot-subset view is not — the kernel reads through the strides
    big = rnd(2, 6, 90, 2, d)
    kv = big[1, ::2]
    _close(dops.decode_attention_cuda(q, kv, kv, lens),
           dref.decode_attention_ref(q, kv, kv, lens), tol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("ps", [16, 5])
def test_paged_decode_kernel(cuda, dtype, tol, ps):
    rnd = _rand(cuda, dtype, seed=ps)
    q = rnd(3, 24, 128)
    kp, vp = rnd(13, ps, 8, 128), rnd(13, ps, 8, 128)
    bt = _i32(cuda, [[3, 1, 7, 2], [0, 0, 0, 0], [12, 11, 10, 9]])
    lens = _i32(cuda, [3 * ps + 2, 1, 4 * ps])
    _close(dops.paged_decode_attention_cuda(q, kp, vp, bt, lens),
           dref.paged_decode_attention_ref(q, kp, vp, bt, lens), tol)


@pytest.mark.gpu
def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    rnd = _rand(cuda, torch.float32)
    x = rnd(4, 64)
    with pytest.raises(TypeError):
        rops.rms_norm_cuda(x.half(), rnd(64).half())
    with pytest.raises(ValueError, match="contiguous"):
        rops.rms_norm_cuda(x.t(), rnd(4))
    q, k = rnd(1, 8, 3, 48), rnd(1, 8, 1, 48)
    with pytest.raises(ValueError, match="head_dim"):
        fops.flash_attention_cuda(q, k, k, _i32(cuda, [0]), _i32(cuda, [8]))
    with pytest.raises(ValueError, match="KV heads"):
        dops.decode_attention_cuda(rnd(1, 18, 32), rnd(1, 8, 2, 32),
                                   rnd(1, 8, 2, 32), _i32(cuda, [8]))


def test_cuda_wrappers_refuse_cpu_tensors():
    """A CPU tensor never reaches a kernel: the *_cuda wrappers raise, and
    only the dispatchers route it to the plain version."""
    x = torch.ones(2, 8)
    with pytest.raises(ValueError, match="CUDA"):
        rops.rms_norm_cuda(x, torch.zeros(8))
    q = torch.ones(1, 4, 2, 32)
    with pytest.raises(ValueError, match="CUDA"):
        fops.flash_attention_cuda(q, q, q, torch.zeros(1, dtype=torch.int32),
                                  torch.ones(1, dtype=torch.int32))
    with pytest.raises(ValueError, match="CUDA"):
        dops.decode_attention_cuda(q[:, 0], q, q,
                                   torch.ones(1, dtype=torch.int32))
    with pytest.raises(ValueError, match="CUDA"):
        dops.paged_decode_attention_cuda(q[:, 0], q, q,
                                         torch.zeros(1, 1, dtype=torch.int32),
                                         torch.ones(1, dtype=torch.int32))
