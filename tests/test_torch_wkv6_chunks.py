"""B10's chunked arithmetic against the JAX package.

The chunked, column-tiled WKV6 kernel does not run on the CPU, so what it
computes is modelled in plain PyTorch (``rwkv6_scan/ref.py``
``wkv6_chunk_ref``: chunks of C tokens with a ragged last one, every decay
a product of w).  The same numpy inputs (from a seed) go through the JAX
package's reference (``lax.scan``) and, where the TPU kernel takes the
shape (its chunk divides S), its Pallas kernel in interpret mode.

Shapes: head sizes 16/32/64; S = 1, C-1, C, C+1 and 200 for C = 16 (the
kernel's) and 32; decays from U(0.8, 0.999) (the JAX sweep's range) and a
strong-decay draw from U(0, 0.2) with a quarter of them exactly 0 (the
model's bf16 exp(-exp(dw)) rounds to 0); a non-zero initial state.  Tolerance: f32
1e-5 absolute and relative, as ``test_torch_rwkv.py``'s recurrence cases
(the two sides sum the same f32 products in another order).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.rwkv6_scan.ref import wkv6_ref as jax_wkv6_ref  # noqa: E402
from repro.kernels.rwkv6_scan.wkv6_kernel import wkv6_pallas  # noqa: E402
from repro_torch.kernels.rwkv6_scan.ops import CHUNK  # noqa: E402
from repro_torch.kernels.rwkv6_scan.ref import wkv6_chunk_ref  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-5)
CHUNKS = (CHUNK, 2 * CHUNK)     # the kernel's C, and C as a parameter
CASES = [(hs, s, c) for c in CHUNKS for hs in (16, 32, 64)
         for s in (1, c - 1, c, c + 1, 200)]


def _inputs(seed, b, s, h, hs, strong):
    """numpy f32 r, k, v, w [b,s,h,hs], u [h,hs], state [b,h,hs,hs]."""
    rng = np.random.default_rng(seed)
    r, k, v = (0.5 * rng.standard_normal((b, s, h, hs)).astype(np.float32)
               for _ in range(3))
    if strong:
        w = rng.uniform(0.0, 0.2, (b, s, h, hs)).astype(np.float32)
        w[rng.random(w.shape) < 0.25] = 0.0
    else:
        w = rng.uniform(0.8, 0.999, (b, s, h, hs)).astype(np.float32)
    u = (0.3 * rng.standard_normal((h, hs))).astype(np.float32)
    st = (0.1 * rng.standard_normal((b, h, hs, hs))).astype(np.float32)
    return r, k, v, w, u, st


def _model(args, chunk):
    y, st = wkv6_chunk_ref(*(torch.from_numpy(a) for a in args), chunk=chunk)
    assert y.dtype == torch.float32 and st.dtype == torch.float32
    return y.numpy(), st.numpy()


@pytest.mark.parametrize("strong", [False, True], ids=["w0.8", "strong"])
@pytest.mark.parametrize("hs,s,chunk", CASES)
def test_chunk_model_matches_jax_ref(hs, s, chunk, strong):
    """y and the final state == JAX's step-by-step reference."""
    args = _inputs(hs * s + chunk, 2, s, 2, hs, strong)
    if strong:
        assert (args[3] == 0).any()
    y, st = _model(args, chunk)
    want_y, want_st = jax_wkv6_ref(*(jnp.asarray(a) for a in args))
    np.testing.assert_allclose(y, np.asarray(want_y), **TOL)
    np.testing.assert_allclose(st, np.asarray(want_st), **TOL)


@pytest.mark.parametrize("strong", [False, True], ids=["w0.8", "strong"])
@pytest.mark.parametrize("hs,s", [(16, 1), (64, 15), (32, 16), (64, 17),
                                  (16, 33), (32, 200)])
def test_chunk_model_matches_pallas(hs, s, strong):
    """== the TPU kernel in interpret mode, with its chunk set to divide S
    (S itself up to 128; 40 at S = 200)."""
    args = _inputs(7 * s + hs, 1, s, 2, hs, strong)
    y, st = _model(args, CHUNK)
    want_y, want_st = wkv6_pallas(*(jnp.asarray(a) for a in args),
                                  chunk=s if s <= 128 else 40,
                                  interpret=True)
    np.testing.assert_allclose(y, np.asarray(want_y), **TOL)
    np.testing.assert_allclose(st, np.asarray(want_st), **TOL)


def test_chunk_model_keeps_the_input_type():
    """bf16 inputs give a bf16 y (rounded once) and an f32 state."""
    args = [torch.from_numpy(a) for a in _inputs(3, 1, 20, 1, 16, False)]
    args[:4] = [a.to(torch.bfloat16) for a in args[:4]]
    y, st = wkv6_chunk_ref(*args, chunk=CHUNK)
    assert y.dtype == torch.bfloat16 and st.dtype == torch.float32
    want_y, want_st = wkv6_chunk_ref(*[a.float() for a in args[:4]],
                                     *args[4:], chunk=CHUNK)
    torch.testing.assert_close(y, want_y.to(torch.bfloat16), rtol=0, atol=0)
    torch.testing.assert_close(st, want_st, rtol=0, atol=0)
