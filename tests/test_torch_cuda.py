"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA card (marker ``gpu``) and skips where there is
none; the card is looked for inside a fixture.  The file imports neither
JAX nor the JAX package, so it runs on a machine with only PyTorch:

    python -m pytest -q -p no:cacheprovider --noconftest tests/test_torch_cuda.py

Tolerances: bf16 rounds the output once on each side, so the two may land
one bf16 ulp apart (2^-8 relative); f32 differs only in summation order.
The fused norms (``add_rms_norm``, ``dequantize_add_rms_norm``) hold their
s output, the new residual stream, bit for bit to the plain add, and n to
B1's tolerance and bit for bit to ``rms_norm_cuda(s)`` (one reduction tree).
B10 (the WKV6 recurrence, both its kernels) is held to the same
tolerances: its f32 state updates are contracted to FMAs and summed in
another order, about one f32 ulp per step over these short sequences.  The
quantization kernels (B5, B6, B9 and the int4 wire's fused passes) have
no tolerance: integer, byte and fp8 outputs, B5's f32 abs-max, the shared
scales B6 computes from the abs-max and the dequantize's single rounding
must be bitwise equal to the plain versions.  The shapes are small and ragged on purpose (odd
lengths, partial tiles, a hidden width with no 16-byte vector path, a
last chunk shorter than the rest); ``chip_smoke.py`` checks the full
model's shapes.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.decode_attention import ops as dops  # noqa: E402
from repro_torch.kernels.decode_attention import ref as dref  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fops  # noqa: E402
from repro_torch.kernels.flash_attention import ref as fref  # noqa: E402
from repro_torch.kernels.quant_collective import ops as qops  # noqa: E402
from repro_torch.kernels.quant_collective import ref as qref  # noqa: E402
from repro_torch.kernels.rmsnorm import ops as rops  # noqa: E402
from repro_torch.kernels.rmsnorm import ref as rref  # noqa: E402
from repro_torch.kernels.rwkv6_scan import ops as wops  # noqa: E402
from repro_torch.kernels.rwkv6_scan import ref as wref  # noqa: E402

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


# rows: one, a decode step's 4 slots, a ragged prefill, more rows than the
# card holds CTAs at once (each CTA takes several); h: llama32-3b's and
# rwkv6-7b's widths (the 16-byte path) and an odd one (the element path);
# "shifted": x off a 16-byte boundary (the element path, which sums in the
# 16-byte path's order); "last": the last position of each of two
# sequences, a row-strided view (the final norm of a prefill pass)
NORM_CASES = [pytest.param(r, h, "", id=f"{r}x{h}")
              for r in (1, 4, 333, 2048) for h in (3072, 4096)]
NORM_CASES += [pytest.param(5, 1001, "", id="5x1001"),
               pytest.param(4, 3072, "shifted", id="4x3072-shifted"),
               pytest.param(2, 3072, "last", id="2x3072-last")]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("rows,h,view", NORM_CASES)
def test_fused_norm_kernels(cuda, dtype, tol, rows, h, view):
    """B1, add_rms_norm and dequantize_add_rms_norm (int8, fp8) against
    their plain versions: s bit for bit, n within the tolerance, and n bit
    for bit the redesigned B1's of s."""
    rnd = _rand(cuda, dtype, seed=rows + h)
    x, y, w = rnd(rows, h), rnd(rows, h), 0.1 * rnd(h)
    if view == "shifted":
        x = rnd(rows * h + 1)[1:].view(rows, h)
    elif view == "last":
        x, y = rnd(rows, 33, h)[:, -1], rnd(rows, 33, h)[:, -1]
    if view != "last":
        _close(rops.rms_norm_cuda(x, w), rref.rms_norm_ref(x, w), tol)
    s, n = rops.add_rms_norm_cuda(x, y, w)
    want_s, want_n = rref.add_rms_norm_ref(x, y, w)
    assert torch.equal(_bits(s), _bits(want_s))
    _close(n, want_n, tol)
    assert torch.equal(_bits(n), _bits(rops.rms_norm_cuda(s, w)))
    if view == "last":
        return
    chunk = 128 if h % 128 == 0 else 77
    y = y.contiguous()
    for quant in ("int8", "fp8"):
        scales = qops.scales_from_amax(qops.chunk_amax_cuda(y, chunk),
                                       qops.collective_qmax(quant, 4))
        q = qops.chunk_quantize_cuda(y, scales, chunk,
                                     qops.QUANT_DTYPES[quant])
        s, n = qops.dequantize_add_rms_norm_cuda(q, scales, chunk, x, w)
        want_s, want_n = qref.dequantize_add_rms_norm_ref(q, scales, chunk,
                                                          x, w)
        assert torch.equal(_bits(s), _bits(want_s))
        _close(n, want_n, tol)
        assert torch.equal(_bits(n), _bits(rops.rms_norm_cuda(s, w)))


# B2 across its tiling: S below, at and off one 64-query tile, a paged
# chunk (q_offset > 0, kv_len > S), a window, every head width and group
FLASH_CASES = [  # B, S, T, q_offset, kv_len, window, D, Hkv, G
    pytest.param(2, 77, 90, [0, 13], [77, 90], None, 128, 8, 3, id="d128"),
    pytest.param(2, 77, 90, [0, 13], [77, 90], 17, 64, 2, 2, id="d64-w17"),
    pytest.param(2, 77, 90, [0, 13], [77, 90], None, 32, 1, 4, id="d32"),
    pytest.param(1, 40, 40, [0], [40], None, 128, 8, 3, id="S40"),
    pytest.param(2, 64, 64, [0, 0], [64, 64], None, 64, 2, 1, id="S64"),
    pytest.param(2, 77, 77, [0, 0], [77, 50], None, 32, 1, 8, id="S77"),
    pytest.param(1, 333, 333, [0], [333], None, 128, 8, 3, id="S333"),
    pytest.param(2, 100, 400, [300, 37], [400, 137], None, 128, 2, 3,
                 id="chunk"),
    pytest.param(1, 333, 333, [0], [333], 17, 64, 2, 3, id="window17"),
    pytest.param(1, 130, 200, [70], [200], 17, 32, 1, 8, id="chunk-window17"),
    # context-parallel shards: a 333-token prompt padded to 334 at c = 2,
    # each shard's 167 queries at its offset over the assembled K/V, at
    # llama32-3b's heads (t = 1 and t = 2), and one windowed shard
    pytest.param(1, 167, 334, [0], [334], None, 128, 8, 3, id="cp-shard0"),
    pytest.param(1, 167, 334, [167], [334], None, 128, 8, 3, id="cp-shard1"),
    pytest.param(1, 167, 334, [167], [334], None, 128, 4, 3,
                 id="cp-shard1-t2"),
    pytest.param(1, 167, 334, [167], [334], 64, 128, 8, 3,
                 id="cp-shard1-window64"),
]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("B,S,T,off,kl,window,d,hkv,g", FLASH_CASES)
def test_flash_kernel(cuda, dtype, tol, B, S, T, off, kl, window, d, hkv,
                      g):
    """B2 (bf16: tensor cores; f32: CUDA cores) against the plain version,
    whose P stays f32 (bf16 rounds P for P·V: 2^-9 relative)."""
    rnd = _rand(cuda, dtype, seed=S + d)
    q, k, v = rnd(B, S, hkv * g, d), rnd(B, T, hkv, d), rnd(B, T, hkv, d)
    off, kl = _i32(cuda, off), _i32(cuda, kl)
    _close(fops.flash_attention_cuda(q, k, v, off, kl, window),
           fref.flash_attention_ref(q, k, v, off, kl, window), tol)


# B2's mask modes (the encoder's bidirectional mask, the vlm's prefix mask
# over a prefix off the 64-key tile grid, with and without a window, and
# the causal mask) at every head dim: two sequences of 150 queries (a
# ragged last tile), one with a shorter KV length
FLASH_MODES = [pytest.param("causal", 0, None, id="causal"),
               pytest.param("bidirectional", 0, None, id="bidir"),
               pytest.param("bidirectional", 0, 40, id="bidir-w40"),
               pytest.param("prefix", 77, None, id="prefix77"),
               pytest.param("prefix", 77, 20, id="prefix77-w20"),
               pytest.param("prefix", 150, None, id="prefix-all")]
FLASH_DIMS = [pytest.param(d, hkv, g, id=f"d{d}") for d, hkv, g in
              ((32, 1, 4), (64, 2, 2), (80, 2, 1), (128, 2, 3), (256, 1, 8))]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("d,hkv,g", FLASH_DIMS)
@pytest.mark.parametrize("mode,prefix_len,window", FLASH_MODES)
def test_flash_kernel_mask_modes(cuda, dtype, tol, mode, prefix_len, window,
                                 d, hkv, g):
    rnd = _rand(cuda, dtype, seed=d + prefix_len)
    q, k, v = rnd(2, 150, hkv * g, d), rnd(2, 150, hkv, d), rnd(2, 150, hkv, d)
    off, kl = _i32(cuda, [0, 0]), _i32(cuda, [150, 101])
    _close(fops.flash_attention_cuda(q, k, v, off, kl, window, mode,
                                     prefix_len),
           fref.flash_attention_ref(q, k, v, off, kl, window, mode=mode,
                                    prefix_len=prefix_len), tol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", DTYPES)
def test_flash_kernel_prefix_mode_at_an_offset(cuda, dtype, tol):
    """The prefix mask where queries start past the prefix (a chunk at
    offset 300 over a 256-key prefix, D 256): every query still sees the
    prefix, loaded in tiles below its own position."""
    rnd = _rand(cuda, dtype, seed=7)
    q, k, v = rnd(1, 70, 8, 256), rnd(1, 370, 1, 256), rnd(1, 370, 1, 256)
    off, kl = _i32(cuda, [300]), _i32(cuda, [370])
    for window in (None, 100):
        _close(fops.flash_attention_cuda(q, k, v, off, kl, window, "prefix",
                                         256),
               fref.flash_attention_ref(q, k, v, off, kl, window,
                                        mode="prefix", prefix_len=256), tol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("d,g", [(128, 3), (64, 1), (32, 8), (256, 8)])
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
@pytest.mark.parametrize("d,hkv,g", [(128, 8, 3), (64, 2, 1), (32, 1, 8),
                                     (256, 1, 8)])
def test_decode_split_boundaries(cuda, dtype, tol, d, hkv, g):
    """B3's split pass + combine pass (128 rows a split) at lengths 1, 127,
    128, 129 and W = 300 (a ragged last split), so the short rows' later
    splits are empty."""
    rnd = _rand(cuda, dtype, seed=d + g)
    q, k, v = rnd(5, hkv * g, d), rnd(5, 300, hkv, d), rnd(5, 300, hkv, d)
    lens = _i32(cuda, [1, 127, 128, 129, 300])
    _close(dops.decode_attention_cuda(q, k, v, lens),
           dref.decode_attention_ref(q, k, v, lens), tol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("d,hkv,g", [(128, 8, 2), (256, 1, 8)])
def test_decode_split_pass_alone(cuda, dtype, tol, d, hkv, g):
    """B3's split pass without its combine (a sequence-parallel cache
    shard's partials): the live splits' m, l and acc equal
    ``split_partials``', a shard with no valid row (length 0) included,
    and ``combine_partials`` of them is the attention."""
    rnd = _rand(cuda, dtype, seed=d + hkv)
    q, k, v = rnd(5, hkv * g, d), rnd(5, 300, hkv, d), rnd(5, 300, hkv, d)
    lens = _i32(cuda, [0, 1, 128, 129, 300])
    got = dops.decode_attention_partials_cuda(q, k, v, lens)
    want = dref.split_partials(q, k, v, lens, dops.SPLIT_KEYS)
    live = torch.arange(3, device=cuda)[None] < \
        (-(-lens.long() // dops.SPLIT_KEYS))[:, None]          # [B, ns]
    for a, b in zip(got, want):
        sel = live[:, None].expand(a.shape[:3])
        _close(a[sel], b[sel], tol)
    keep = lens > 0
    _close(dref.combine_partials(*got, lens, 300, dops.SPLIT_KEYS,
                                 dtype)[keep],
           dref.decode_attention_ref(q, k, v, lens)[keep], tol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", DTYPES)
def test_decode_kernel_d256_wrapped_ring(cuda, dtype, tol):
    """B3 at paligemma's head shape (8 query heads over 1 KV head, D 256)
    on ring caches built as the model builds them (``build_ring_cache``)
    from 200 to 700 positions into 256 rows, wrapped past the width,
    against the plain attention of the last query over the last 256
    positions."""
    from repro_torch.models.blocks import build_ring_cache
    rnd = _rand(cuda, dtype, seed=256)
    P, W = (200, 256, 257, 700), 256
    q = rnd(4, 8, 256)
    kf, vf = rnd(4, P[-1], 1, 256), rnd(4, P[-1], 1, 256)
    rings = [build_ring_cache(kf[b:b + 1, :n], vf[b:b + 1, :n], W)
             for b, n in enumerate(P)]
    ck = torch.cat([r["k"] for r in rings])
    cv = torch.cat([r["v"] for r in rings])
    pos = _i32(cuda, P)
    _close(dops.decode_attention_cuda(q, ck, cv, pos.clamp(max=W)),
           fref.flash_attention_ref(q[:, None], kf, vf, pos - 1, pos,
                                    W)[:, 0], tol)


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
@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("d,hkv,g", [(128, 8, 3), (64, 2, 1), (32, 1, 8),
                                     (256, 1, 8)])
@pytest.mark.parametrize("ps", [16, 5])
def test_paged_decode_split_boundaries(cuda, dtype, tol, ps, d, hkv, g):
    """B4's split pass + combine pass at lengths 1, exactly on a split
    boundary, one past it and 1024 (the short rows' later splits are
    empty), then with an inactive slot on scratch page 0."""
    pps, _ = dops.split_geometry(ps, 1)
    n = -(-1024 // ps)
    P = 1 + 4 * n
    rnd = _rand(cuda, dtype, seed=ps * d)
    q, kp, vp = rnd(4, hkv * g, d), rnd(P, ps, hkv, d), rnd(P, ps, hkv, d)
    perm = torch.randperm(P - 1, generator=torch.Generator().manual_seed(ps))
    bt = (perm + 1).reshape(4, n).to(device=cuda, dtype=torch.int32)
    for lens in ([1, pps * ps, pps * ps + 1, 1024],
                 [pps * ps + 1, 1, 1, 1024]):
        if lens[1] == 1:
            bt[1] = 0
        lens = _i32(cuda, lens)
        _close(dops.paged_decode_attention_cuda(q, kp, vp, bt, lens),
               dref.paged_decode_attention_ref(q, kp, vp, bt, lens), tol)


def _wkv6_inputs(dev, dtype, b, s, h, hs, seed=0, strong=False):
    """w from U(0.8, 0.999), or (``strong``) from U(0, 0.2) with a quarter
    of them exactly 0."""
    g = torch.Generator(device=dev).manual_seed(seed)

    def rnd(*shape, scale=0.5):
        return scale * torch.randn(shape, generator=g, device=dev)
    r, k, v = (rnd(b, s, h, hs).to(dtype) for _ in range(3))
    u01 = torch.rand((b, s, h, hs), generator=g, device=dev)
    if strong:
        w = torch.where(torch.rand(u01.shape, generator=g, device=dev) < 0.25,
                        0.0, 0.2 * u01).to(dtype)
    else:
        w = (0.8 + 0.199 * u01).to(dtype)
    return r, k, v, w, rnd(h, hs, scale=0.3), rnd(b, h, hs, hs, scale=0.1)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("b,s,h,hs", [(2, 77, 3, 64), (1, 1, 4, 32),
                                      (3, 40, 1, 16), (4, 1, 64, 64)])
def test_wkv6_kernel(cuda, dtype, tol, b, s, h, hs):
    """B10 (the wrapper's pick: per-step at S = 1, chunked above) against
    the plain version: y and the final state, from a non-zero initial
    state, any S (77 is a multiple of neither chunk size), decode (S = 1);
    then in place over the state."""
    r, k, v, w, u, st = _wkv6_inputs(cuda, dtype, b, s, h, hs, seed=s)
    want_y, want_s = wref.wkv6_ref(r, k, v, w, u, st)
    y, s_out = wops.wkv6_cuda(r, k, v, w, u, st)
    _close(y, want_y, tol)
    _close(s_out, want_s, 1e-4)
    y, s_out = wops.wkv6_cuda(r, k, v, w, u, st, state_out=st)
    assert s_out is st
    _close(y, want_y, tol)
    _close(st, want_s, 1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("strong", [False, True], ids=["w0.8", "strong"])
@pytest.mark.parametrize("chunk,s", [(0, 17), (0, 200), (16, 1), (16, 15),
                                     (16, 16), (16, 17), (16, 31), (16, 32),
                                     (16, 33), (16, 200)])
@pytest.mark.parametrize("hs", [64, 16])
def test_wkv6_kernels_across_chunk_edges(cuda, dtype, tol, hs, chunk, s,
                                         strong):
    """Each B10 kernel, forced (chunk 0: per-step; 16: chunked), against
    the plain version across the chunk edges (S = C-1, C, C+1, 2C-1, 2C,
    2C+1, a ragged 200) and with strong decays that hold exact zeros; then
    with ``state_out=state``, which S > C makes the chunked kernel carry
    over several chunks before it writes."""
    r, k, v, w, u, st = _wkv6_inputs(cuda, dtype, 1, s, 2, hs, seed=s + hs,
                                     strong=strong)
    if strong:
        assert bool((w == 0).any())
    want_y, want_s = wref.wkv6_ref(r, k, v, w, u, st)
    y, s_out = wops.wkv6_cuda(r, k, v, w, u, st, chunk=chunk)
    _close(y, want_y, tol)
    _close(s_out, want_s, 1e-4)
    y, s_out = wops.wkv6_cuda(r, k, v, w, u, st, state_out=st, chunk=chunk)
    assert s_out is st
    _close(y, want_y, tol)
    _close(st, want_s, 1e-4)


def _bits(t):
    return t.contiguous().view(torch.uint8) if t.element_size() == 1 \
        else t.contiguous().view(torch.int32 if t.element_size() == 4
                                 else torch.int16)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("shape,chunk", [((4, 3072), 128), ((3, 160), 64),
                                         ((2, 5, 257), 128), ((1, 8), 8)])
def test_quant_kernels_bitwise(cuda, dtype, shape, chunk):
    """B5, B6 (int8 and fp8) and B9 against their plain versions, bit for
    bit; the scales are tight enough that both clips bind, and one chunk
    has a zero scale (taken as 1)."""
    x = 3.0 * _rand(cuda, dtype, seed=shape[-1])(*shape)
    amax = qops.chunk_amax_cuda(x, chunk)
    assert torch.equal(_bits(amax), _bits(qref.chunk_amax_ref(x, chunk)))
    scales = qops.scales_from_amax(amax, 31.0).contiguous()
    scales.view(-1)[0] = 0.0
    for qdtype in (torch.int8, torch.float8_e4m3fn):
        q = qops.chunk_quantize_cuda(x, scales, chunk, qdtype)
        want = qref.chunk_quantize_ref(x, scales, chunk, qdtype)
        assert torch.equal(_bits(q), _bits(want))
        for out in (torch.float32, torch.bfloat16):
            assert torch.equal(
                _bits(qops.chunk_dequantize_cuda(q, scales, chunk, out)),
                _bits(qref.chunk_dequantize_ref(q, scales, chunk, out)))


@pytest.mark.gpu
def test_chunk_amax_kernel_propagates_nan(cuda):
    x = torch.ones(2, 300, device=cuda)
    x[1, 257] = float("nan")
    got = qops.chunk_amax_cuda(x, 128)
    assert got[1, 2].isnan() and not got[0].isnan().any()
    assert torch.equal(got[:, :2], qref.chunk_amax_ref(x, 128)[:, :2])


# B5's lane groups: a 16-byte vector a lane, the group the chunk's vectors
# rounded up to a power of two (at most 32): bf16 chunk 8 -> 1 lane, 16 ->
# 2, 64 -> 8, 128 -> 16, 512 -> 32 lanes of two vectors; f32 chunk 128 ->
# 32; ragged last chunks, and h or a view with no vector path (scalar path)
AMAX_CASES = [((4, 3072), 128), ((3, 160), 64), ((2, 72), 8), ((5, 48), 16),
              ((2, 1100), 512), ((3, 200), 25), ((2, 5, 257), 128),
              ((70000, 16), 8)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("shape,chunk", AMAX_CASES)
@pytest.mark.parametrize("view", [False, True], ids=["aligned", "offset"])
def test_chunk_amax_lane_groups_bitwise(cuda, dtype, shape, chunk, view):
    """B5 on every lane-group size, bit for bit; ``offset``: x a view one
    element past a 16-byte boundary (the scalar path); 70000 rows pass the
    grid's 65535 in y."""
    n = 1
    for d in shape:
        n *= d
    flat = 3.0 * _rand(cuda, dtype, seed=shape[-1] + chunk)(n + 1)
    x = (flat[1:] if view else flat[:-1]).view(shape)
    got = qops.chunk_amax_cuda(x, chunk)
    assert torch.equal(_bits(got), _bits(qref.chunk_amax_ref(x, chunk)))


# (shape, chunk): the decode shape, ragged h = 160 / chunk 64, an odd chunk
# (a 16-byte step straddles two scales), h with no vector path
SHARED_CASES = [((4, 3072), 128), ((3, 160), 64), ((2, 200), 25),
                ((2, 5, 258), 128)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("t", [2, 4, 8])
@pytest.mark.parametrize("quant", ["int8", "fp8", "int4"])
@pytest.mark.parametrize("shape,chunk", SHARED_CASES)
def test_shared_scale_quantize_kernels_bitwise(cuda, dtype, shape, chunk,
                                               quant, t):
    """B6 from the all-reduced abs-max (int8, fp8) and the int4 pre-pass
    from it, against their plain versions, bit for bit, with and without
    the scales write (times t on int4), on x and on a view of x off a
    16-byte boundary: an all-zero chunk, a NaN, an infinite and a subnormal
    abs-max (its scale underflows to 0, which the quantize takes as 1),
    and chunks whose abs-max is below their values' (the clips bind).
    Then ``quantized_psum`` with kernels against it with plain versions."""
    from repro_torch.core import comm
    from repro_torch.core.parallel_exec import quantized_psum

    h = shape[-1]
    n = 1
    for d in shape:
        n *= d
    flat = 3.0 * _rand(cuda, dtype, seed=h + t)(n + 1)
    qmax = qops.collective_qmax(quant, t)
    for x in (flat[:-1].view(shape), flat[1:].view(shape)):
        x.reshape(-1, h)[0, :chunk] = 0.0
        amax = qref.chunk_amax_ref(x, chunk)
        amax[..., 1::3] /= 40.0
        flat_a = amax.view(-1)
        flat_a[1], flat_a[-1] = float("nan"), float("inf")
        flat_a[2 % flat_a.numel()] = 1e-45
        for write in (True, False):
            if quant == "int4":
                got = qops.chunk_quantize_pack_shared_cuda(
                    x, amax, qmax, chunk, t, write)
                want = qref.chunk_quantize_pack_shared_ref(
                    x, amax, qmax, chunk, t, write)
            else:
                qdt = qops.QUANT_DTYPES[quant]
                got = qops.chunk_quantize_shared_cuda(x, amax, qmax, chunk,
                                                      qdt, write)
                want = qref.chunk_quantize_shared_ref(x, amax, qmax, chunk,
                                                      qdt, write)
            assert torch.equal(_bits(got[0]), _bits(want[0]))
            if write:
                assert torch.equal(_bits(got[1]), _bits(want[1]))
            else:
                assert got[1] is None
    if h % (2 * t) == 0:
        xs = [3.0 * _rand(cuda, dtype, seed=h + r)(*shape) for r in range(t)]
        assert torch.equal(
            _bits(quantized_psum(xs, comm.VirtualGroup(t), quant, chunk)),
            _bits(quantized_psum(xs, comm.VirtualGroup(t), quant, chunk,
                                 plain=True)))


@pytest.mark.gpu
def test_quant_grid_floor(cuda):
    """The empty kernel runs at B5's and B6's grids: at the decode shape
    B5 takes 16 lanes a bf16 chunk (8 chunks a 128-thread block), B6 a
    step of two values a thread."""
    x = _rand(cuda, torch.bfloat16)(4, 3072)
    assert qops.quant_grid_cuda("chunk_amax", x, 128, launch=True) \
        == (3, 4, 128)
    assert qops.quant_grid_cuda("chunk_quantize", x, 128, launch=True) \
        == (12, 4, 128)
    assert qops.quant_grid_cuda("chunk_quantize_pack", x, 128) \
        == (12, 4, 128)
    torch.cuda.synchronize()


# (shape, chunk, t): the decode shape, even and ragged chunks, an odd chunk
# (pairs straddle two scales) under a 3-d lead, a hidden width with no
# 16-byte vector path (h % 8 != 0 for bf16)
INT4_CASES = [((4, 3072), 128, 4), ((3, 256), 128, 2), ((3, 160), 64, 4),
              ((2, 3, 200), 25, 4), ((2, 12), 5, 2), ((1, 2), 1, 1)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("shape,chunk,t", INT4_CASES)
def test_nibble_kernels_bitwise(cuda, dtype, shape, chunk, t):
    """The int4 wire's fused kernels against their plain versions, bit for
    bit: quantize + pack (clipped and off-grid values, a zero scale),
    reduce + requantize over every sum of t nibbles from -8t to 7t, and
    unpack + dequantize over every byte value; then the whole int4 branch
    of ``quantized_psum`` with kernels against it with plain versions."""
    from repro_torch.core import comm
    from repro_torch.core.parallel_exec import quantized_psum

    h = shape[-1]
    x = 3.0 * _rand(cuda, dtype, seed=h)(*shape)
    scales = qops.scales_from_amax(qops.chunk_amax_cuda(x, chunk), 31.0)
    scales.view(-1)[0] = 0.0
    packed = qops.chunk_quantize_pack_cuda(x, scales, chunk)
    assert torch.equal(packed, qref.chunk_quantize_pack_ref(x, scales, chunk))
    # random bytes, every byte value where the row block holds 256, read as
    # t source blocks a row
    g = torch.Generator(device=cuda).manual_seed(t)
    b = torch.randint(0, 256, (*shape[:-1], h // 2), generator=g,
                      device=cuda).to(torch.uint8)
    n = min(b.numel(), 256)
    b.view(-1)[:n] = torch.arange(n, device=cuda).to(torch.uint8)
    assert torch.equal(qops.nibble_reduce_requant_cuda(b, t),
                       qref.nibble_reduce_requant_ref(b, t))
    # every sum of t nibbles, -8t .. 7t, spread over the t sources
    sums = torch.arange(-8 * t, 7 * t + 1)
    sums = torch.cat([sums, sums[:len(sums) % 2]])   # whole bytes per block
    left, src = sums, []
    for _ in range(t):
        src.append(left.clamp(-8, 7))
        left = left - src[-1]
    assert not left.any()
    every = qref.nibble_pack_ref(
        torch.stack(src).to(torch.int8).reshape(1, -1)).to(cuda)
    assert torch.equal(qops.nibble_reduce_requant_cuda(every, t),
                       qref.nibble_reduce_requant_ref(every, t))
    for out in (torch.float32, torch.bfloat16):
        for wire in (packed, b):
            assert torch.equal(
                _bits(qops.nibble_unpack_dequantize_cuda(wire, scales, chunk,
                                                         out)),
                _bits(qref.nibble_unpack_dequantize_ref(wire, scales, chunk,
                                                        out)))
    if t > 1 and h % (2 * t) == 0:
        xs = [3.0 * _rand(cuda, dtype, seed=h + r)(*shape) for r in range(t)]
        assert torch.equal(
            _bits(quantized_psum(xs, comm.VirtualGroup(t), "int4", chunk)),
            _bits(quantized_psum(xs, comm.VirtualGroup(t), "int4", chunk,
                                 plain=True)))


@pytest.mark.gpu
def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    rnd = _rand(cuda, torch.float32)
    x = rnd(4, 64)
    with pytest.raises(TypeError):
        rops.rms_norm_cuda(x.half(), rnd(64).half())
    with pytest.raises(ValueError, match="contiguous"):
        rops.rms_norm_cuda(x.t(), rnd(4))
    # the fused norms: y unlike x, rows at no one stride, a strided last
    # axis; a wire payload of another shape than x, scales of the wrong
    # shape, a strided payload
    with pytest.raises(ValueError, match="y is"):
        rops.add_rms_norm_cuda(x, rnd(4, 32), rnd(64))
    with pytest.raises(TypeError):
        rops.add_rms_norm_cuda(x.half(), x.half(), rnd(64).half())
    uneven = rnd(4, 6, 64)[:, :3, :32]
    with pytest.raises(ValueError, match="one stride"):
        rops.add_rms_norm_cuda(uneven, uneven, rnd(32))
    with pytest.raises(ValueError, match="last axis"):
        rops.add_rms_norm_cuda(x.t(), x.t(), rnd(4))
    q8 = torch.zeros(4, 64, dtype=torch.int8, device=cuda)
    s2 = torch.ones(4, 2, device=cuda)
    with pytest.raises(ValueError, match="x is"):
        qops.dequantize_add_rms_norm_cuda(q8, s2, 32, rnd(4, 32), rnd(32))
    with pytest.raises(ValueError, match="scales"):
        qops.dequantize_add_rms_norm_cuda(q8, s2[:, :1].contiguous(), 32, x,
                                          rnd(64))
    with pytest.raises(ValueError, match="contiguous"):
        qops.dequantize_add_rms_norm_cuda(q8.t(), s2, 32, x.t(), rnd(4))
    with pytest.raises(TypeError):
        qops.dequantize_add_rms_norm_cuda(q8.to(torch.uint8), s2, 32, x,
                                          rnd(64))
    q, k = rnd(1, 8, 3, 48), rnd(1, 8, 1, 48)
    with pytest.raises(ValueError, match="head_dim"):
        fops.flash_attention_cuda(q, k, k, _i32(cuda, [0]), _i32(cuda, [8]))
    with pytest.raises(ValueError, match="KV heads"):
        dops.decode_attention_cuda(rnd(1, 18, 32), rnd(1, 8, 2, 32),
                                   rnd(1, 8, 2, 32), _i32(cuda, [8]))
    # B2 bf16 copies 16 bytes a thread: an input off a 16-byte boundary
    qb = rnd(1 + 8 * 3 * 32).to(torch.bfloat16)[1:].view(1, 8, 3, 32)
    kb = rnd(1, 8, 1, 32).to(torch.bfloat16)
    with pytest.raises(ValueError, match="16-byte"):
        fops.flash_attention_cuda(qb, kb, kb, _i32(cuda, [0]), _i32(cuda, [8]))
    # B4 loads 16 bytes a lane: a pool view off a 16-byte boundary, or with
    # a head stride that is not a multiple of 16 bytes
    bt, lens = _i32(cuda, [[3, 1]]), _i32(cuda, [20])
    flat = rnd(1 + 5 * 16 * 2 * 32)
    shifted = flat[1:].view(5, 16, 2, 32)
    padded = rnd(5, 16, 2, 33)[..., :32]
    for pool in (shifted, padded):
        with pytest.raises(ValueError, match="16-byte"):
            dops.paged_decode_attention_cuda(rnd(1, 2, 32), pool, pool, bt,
                                             lens)
    # B3 loads 16 bytes a lane too: a cache view off a 16-byte boundary,
    # or with a head stride that is not a multiple of 16 bytes
    lens = _i32(cuda, [5])
    shifted = rnd(1 + 8 * 2 * 32)[1:].view(1, 8, 2, 32)
    padded = rnd(1, 8, 2, 33)[..., :32]
    for cache in (shifted, padded):
        with pytest.raises(ValueError, match="16-byte"):
            dops.decode_attention_cuda(rnd(1, 2, 32), cache, cache, lens)
    with pytest.raises(TypeError):
        qops.chunk_amax_cuda(x.half())
    with pytest.raises(ValueError, match="scales"):
        qops.chunk_quantize_cuda(x, torch.ones(4, 3, device=cuda), 32)
    # B6 from the abs-max: the abs-max of the wrong shape or type, an odd h
    # for the int4 wrapper
    with pytest.raises(ValueError, match="amax"):
        qops.chunk_quantize_shared_cuda(x, torch.ones(4, 3, device=cuda),
                                        7.0, 32)
    with pytest.raises(TypeError, match="amax"):
        qops.chunk_quantize_pack_shared_cuda(
            x, torch.ones(4, 2, device=cuda, dtype=torch.float64), 7.0, 32)
    with pytest.raises(ValueError, match="even"):
        qops.chunk_quantize_pack_shared_cuda(rnd(2, 7),
                                             torch.ones(2, 2, device=cuda),
                                             7.0, 4)
    # the int4 wire's fused kernels: odd h, h % 2t != 0, wrong dtypes,
    # scales of the wrong shape, a strided input
    s4 = torch.ones(2, 2, device=cuda)
    with pytest.raises(ValueError, match="even"):
        qops.chunk_quantize_pack_cuda(rnd(2, 7), s4, 4)
    with pytest.raises(TypeError):
        qops.chunk_quantize_pack_cuda(rnd(2, 8).half(), s4, 4)
    with pytest.raises(ValueError, match="scales"):
        qops.chunk_quantize_pack_cuda(rnd(2, 8), torch.ones(2, 3, device=cuda),
                                      4)
    with pytest.raises(ValueError, match="contiguous"):
        qops.chunk_quantize_pack_cuda(rnd(8, 2).t(), s4, 4)
    u8 = torch.zeros(2, 6, dtype=torch.uint8, device=cuda)
    with pytest.raises(ValueError, match="2t"):
        qops.nibble_reduce_requant_cuda(u8, 4)
    with pytest.raises(TypeError):
        qops.nibble_reduce_requant_cuda(u8.to(torch.int8), 2)
    with pytest.raises(ValueError, match="scales"):
        qops.nibble_unpack_dequantize_cuda(u8, torch.ones(2, 2, device=cuda),
                                           4)
    with pytest.raises(TypeError):
        qops.nibble_unpack_dequantize_cuda(u8, torch.ones(2, 3, device=cuda),
                                           4, torch.float16)
    with pytest.raises(TypeError):
        qops.nibble_unpack_dequantize_cuda(u8.to(torch.int8),
                                           torch.ones(2, 3, device=cuda), 4)
    r, k, v, w, u, st = _wkv6_inputs(cuda, torch.float32, 1, 3, 2, 48)
    with pytest.raises(ValueError, match="head size"):
        wops.wkv6_cuda(r, k, v, w, u, st)
    r, k, v, w, u, st = _wkv6_inputs(cuda, torch.float32, 1, 3, 2, 16)
    with pytest.raises(TypeError):
        wops.wkv6_cuda(r, k, v, w.to(torch.bfloat16), u, st)
    with pytest.raises(TypeError):
        wops.wkv6_cuda(r, k, v, w, u.to(torch.bfloat16), st)
    with pytest.raises(TypeError):
        wops.wkv6_cuda(r, k, v, w, u, st.to(torch.bfloat16))
    with pytest.raises(ValueError, match="contiguous"):
        wops.wkv6_cuda(r, k.transpose(1, 2).contiguous().transpose(1, 2),
                       v, w, u, st)
    with pytest.raises(ValueError, match="chunk"):
        wops.wkv6_cuda(r, k, v, w, u, st, chunk=8)
    # the chunked kernel copies 16 bytes a lane: r off a 16-byte boundary
    r1 = rnd(1 + r.numel())[1:].view(r.shape)
    with pytest.raises(ValueError, match="16-byte"):
        wops.wkv6_cuda(r1, k, v, w, u, st, chunk=16)


@pytest.mark.gpu
@pytest.mark.parametrize("quant", [None, "int8"], ids=["full", "int8"])
def test_pipeline_engine_kernel_path_matches_plain(cuda, quant):
    """The hybrid engine at (t, p) = (2, 2), reduced width, f32: the kernel
    path (B1, add_rms_norm, B2, B3, B4; on the int8 decode step B5, B6,
    dequantize_add_rms_norm and the standalone B9 at the boundary) against
    the plain path on the same weights — logits within 1e-3 (int8: 5e-2,
    a chunk scale may round the other way), greedy tokens identical."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.core.parallel_exec import PipelineEngine
    from repro_torch.kernels import _build
    from repro_torch.models.transformer import get_model

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_config("llama32-3b").reduced(num_layers=5),
                              num_kv_heads=2)
    params = get_model(cfg).init(seed=0, device=cuda)
    g = torch.Generator().manual_seed(1)
    toks = torch.randint(2, cfg.vocab_size, (2, 40), generator=g).to(cuda)
    bt = torch.tensor([[3, 1, 5], [2, 6, 4]], dtype=torch.int32, device=cuda)
    tol = 1e-3 if quant is None else 5e-2
    out = {}
    for plain in (False, True):
        eng = PipelineEngine(cfg, t=2, p=2, quant_collectives=quant,
                             plain=plain, device=cuda)
        staged = eng.prepare(params)
        _build.reset_launches()
        lg, caches = eng.prefill_with_cache(staged, toks[:, :32], 48)
        steps = []
        for i in range(32, 40):
            step, caches = eng.decode_once(staged, caches, toks[:, i], i)
            steps.append(step)
        pools = eng.init_paged_cache(7, 16)
        paged = [eng.paged_pass(staged, pools, toks[:, :32],
                                torch.zeros(2, dtype=torch.int32,
                                            device=cuda), bt, "prefill")[0]]
        for i in range(32, 36):
            paged.append(eng.paged_pass(
                staged, pools, toks[:, i:i + 1],
                torch.full((2,), i, dtype=torch.int32, device=cuda), bt)[0])
        gen, _ = eng.generate(staged, caches, steps[-1].argmax(-1), 40, 6)
        torch.cuda.synchronize()
        out[plain] = (torch.stack([lg, *steps, *paged]), gen,
                      dict(_build.LAUNCHES))
    _close(out[False][0], out[True][0], tol)
    assert torch.equal(out[False][1], out[True][1])
    launches, L = out[False][2], cfg.num_layers
    assert launches["flash_attention"] == 2 * L * 2     # prefill + chunk
    assert launches["decode_attention"] == 2 * L * (8 + 6)
    assert launches["paged_decode_attention"] == 2 * L * 4
    assert launches["chunk_dequantize"] == (0 if quant is None else 8 + 6)
    assert sum(out[True][2].values()) == 0


def test_cuda_wrappers_refuse_cpu_tensors():
    """A CPU tensor never reaches a kernel: the *_cuda wrappers raise, and
    only the dispatchers route it to the plain version."""
    x = torch.ones(2, 8)
    with pytest.raises(ValueError, match="CUDA"):
        rops.rms_norm_cuda(x, torch.zeros(8))
    with pytest.raises(ValueError, match="CUDA"):
        rops.add_rms_norm_cuda(x, x, torch.zeros(8))
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
    z = torch.zeros(1, 2, 1, 16)
    with pytest.raises(ValueError, match="CUDA"):
        wops.wkv6_cuda(z, z, z, z, torch.zeros(1, 16),
                       torch.zeros(1, 1, 16, 16))
    s = torch.ones(2, 1)
    for call in (lambda: qops.chunk_amax_cuda(x),
                 lambda: qops.chunk_quantize_cuda(x, s, 8),
                 lambda: qops.chunk_dequantize_cuda(x.to(torch.int8), s, 8),
                 lambda: qops.dequantize_add_rms_norm_cuda(
                     x.to(torch.int8), s, 8, x, torch.zeros(8)),
                 lambda: qops.chunk_quantize_pack_cuda(x, s, 8),
                 lambda: qops.chunk_quantize_shared_cuda(x, s, 7.0, 8),
                 lambda: qops.chunk_quantize_pack_shared_cuda(x, s, 7.0, 8),
                 lambda: qops.quant_grid_cuda("chunk_amax", x, 8),
                 lambda: qops.nibble_reduce_requant_cuda(x.to(torch.uint8), 2),
                 lambda: qops.nibble_unpack_dequantize_cuda(
                     x.to(torch.uint8), torch.ones(2, 2), 8)):
        with pytest.raises(ValueError, match="CUDA"):
            call()


@pytest.mark.gpu
def test_cp_prefill_ring_is_bitwise_and_matches_plain(cuda):
    """A context-parallel prefill at (t, c) = (1, 2), reduced width, f32:
    every worker's ring-assembled K and V is bitwise its shards' blocks in
    order, the kernel path launches B2 once per layer and shard and runs
    no plain attention, and its logits and caches match the plain path's
    within 1e-3."""
    from repro_torch.configs import get_config
    from repro_torch.core.parallel_exec import TPModel, shard_params
    from repro_torch.kernels import _build
    from repro_torch.models import blocks, layers
    from repro_torch.models.transformer import get_model

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("llama32-3b").reduced(num_layers=3)
    params = shard_params(cfg, get_model(cfg).init(seed=0, device=cuda), 1)
    g = torch.Generator().manual_seed(2)
    toks = torch.randint(2, cfg.vocab_size, (2, 70), generator=g).to(cuda)
    ring, plain_calls = layers.ring_kv_assemble, []
    seen = []

    def checked(parts, group):
        full = ring(parts, group)
        seen.append(all(torch.equal(f, torch.cat(parts, dim=1))
                        for f in full))
        return full

    def counted(*a):
        plain_calls.append(1)
        return gqa(*a)

    gqa = blocks.gqa_attention
    layers.ring_kv_assemble, blocks.gqa_attention = checked, counted
    try:
        _build.reset_launches()
        got, cache = TPModel(cfg, 1, c=2).cp_prefill(params, toks, 68, 80)
        torch.cuda.synchronize()
        launches = dict(_build.LAUNCHES)
        assert not plain_calls
        want, want_cache = TPModel(cfg, 1, c=2, plain=True).cp_prefill(
            params, toks, 68, 80)
    finally:
        layers.ring_kv_assemble, blocks.gqa_attention = ring, gqa
    assert seen and all(seen) and len(seen) == 2 * 2 * cfg.num_layers
    assert launches["flash_attention"] == cfg.num_layers * 2
    assert launches["rmsnorm"] == 2 + 1
    _close(got, want, 1e-3)
    for key in ("k", "v"):
        _close(cache[0][key], want_cache[0][key], 1e-3)


# ---------------------------------------------------------------------------
# the prefix cache and the KV-page handoff on the card
# ---------------------------------------------------------------------------

BACKENDS = [pytest.param("gspmd", {}, id="gspmd"),
            pytest.param("tp", dict(t=2), id="tp2"),
            pytest.param("pp", dict(t=1, p=2), id="pp12"),
            pytest.param("pp", dict(t=2, p=2), id="pp22")]


def _serving_cfg(dtype):
    import dataclasses
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config("llama32-3b").reduced(num_layers=3),
                               dtype=dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("kind,kw", BACKENDS)
def test_page_export_import_and_copy_bitwise(cuda, kind, kw):
    """bf16: a prefilled page exported (to CPU tensors) and imported into
    another backend's pools round-trips bitwise with ``kv_page_bytes``
    bytes, on every rank and stage; ``_copy_page`` copies a page in place
    on every pool of the backend."""
    from repro_torch.core.commodel import kv_page_bytes
    from repro_torch.models.transformer import get_model
    from repro_torch.runtime.backends import make_backend

    cfg = _serving_cfg("bfloat16")
    params = get_model(cfg).init(seed=0, device=cuda)
    mk = dict(max_len=64, paged=True, page_size=16, device=cuda, **kw)
    dec = make_backend(kind, cfg, params, num_slots=2, num_pages=9, **mk)
    pre = make_backend(kind, cfg, params, num_slots=1, pool=dec.pool,
                       owner_base=2, **mk)
    prompt = torch.randint(2, cfg.vocab_size, (40,),
                           generator=torch.Generator().manual_seed(3))
    pre.begin_prefill(0, 40, 1)
    pre.prefill_whole(0, prompt.numpy())
    pages = [int(p) for p in pre.pool.block_table(pre._owner(0))]
    for pg in pages[:2]:
        data = pre.export_page(pg)
        assert data["k"].device.type == "cpu"
        assert data["k"].dtype == torch.bfloat16
        assert data["k"].abs().sum() > 0
        assert dec.import_page(pg, data) == kv_page_bytes(cfg, 16, b=2)
        back = dec.export_page(pg)
        for key in ("k", "v"):
            assert torch.equal(back[key], data[key])
    dec._copy_page(pages[0], 8)
    for key in ("k", "v"):
        assert torch.equal(dec.export_page(8)[key],
                           dec.export_page(pages[0])[key])
    pre.free_slots([0])


@pytest.mark.gpu
@pytest.mark.parametrize("suffix", [9, 0], ids=["suffix9", "one-token"])
def test_warm_suffix_pass_matches_plain(cuda, suffix):
    """A cache hit's suffix pass over adopted pages at query offset = hit,
    reduced width, f32: a 9-token suffix runs B2 (L launches, no B4), the
    fully cached prompt's one-token suffix (hit capped one short, its last
    page copied on write) runs B4 (L launches, no B2); logits and pages
    within 1e-3 of the plain path's on the same pages."""
    import numpy as np
    from repro_torch.kernels import _build
    from repro_torch.models.transformer import get_model
    from repro_torch.runtime.backends import make_backend
    from repro_torch.runtime.request import Request
    from repro_torch.runtime.scheduler import Scheduler, VirtualClock

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = _serving_cfg("float32")
    params = get_model(cfg).init(seed=0, device=cuda)
    g = torch.Generator().manual_seed(4)
    tmpl = torch.randint(2, cfg.vocab_size, (48,), generator=g).numpy()
    backend = make_backend("gspmd", cfg, params, num_slots=2, max_len=96,
                           paged=True, page_size=16, prefix_cache=True,
                           device=cuda)
    Scheduler(backend, clock=VirtualClock()).run(
        [Request(rid=0, prompt=tmpl, max_new_tokens=2)])
    extra = torch.randint(2, cfg.vocab_size, (suffix,), generator=g).numpy()
    prompt = np.concatenate([tmpl, extra])
    hit = backend.begin_prefill_cached(0, prompt, 4)
    assert hit == (48 if suffix else 47)
    assert backend.pool.stats().cow_copies == (0 if suffix else 1)
    bt = torch.as_tensor(backend.block_tables[0:1], device=cuda)
    toks = torch.as_tensor(prompt[hit:], device=cuda)[None]
    pos = torch.tensor([hit], dtype=torch.int32, device=cuda)
    plain_cache = {k: v.clone() for k, v in backend.cache.items()}
    _build.reset_launches()
    with torch.inference_mode():
        got, _ = get_model(cfg).paged_step(params, backend.cache, toks, pos,
                                           bt)
        torch.cuda.synchronize()
        launches = dict(_build.LAUNCHES)
        want, _ = get_model(cfg, plain=True).paged_step(params, plain_cache,
                                                        toks, pos, bt)
    L = cfg.num_layers
    assert launches["flash_attention"] == (L if suffix else 0)
    assert launches["paged_decode_attention"] == (0 if suffix else L)
    _close(got, want, 1e-3)
    for key in ("k", "v"):
        _close(backend.cache[key], plain_cache[key], 1e-3)


# the moe and hybrid families at reduced width; hymba's reduced head
# dimension (66) is not one B2/B3 take, so its variant has D 64 and 8/2
# heads (4 of them attention heads, in groups of 2, beside 4 SSM heads)
FAMILIES = ["deepseek-moe-16b", "mixtral-8x22b", "hymba-1.5b"]


def _chip_smoke():
    """``chip_smoke.py`` at the repository's root: the card tests hold the
    families to its limits and its yardstick."""
    import importlib.util
    import pathlib
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _family_cfg(arch, dtype):
    import dataclasses
    from repro_torch.configs import get_config
    cfg = get_config(arch).reduced(num_layers=3)
    if cfg.family == "hybrid":
        cfg = dataclasses.replace(cfg, num_heads=8, num_kv_heads=2,
                                  head_dim=64)
    return dataclasses.replace(cfg, dtype=dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", FAMILIES)
def test_family_kernel_path_matches_plain(cuda, arch):
    """f32: engine greedy tokens of the kernel path (B1, add_rms_norm, B2
    windowed past mixtral's and hymba's window of 64, B3 on the wrapped
    ring) equal the plain path's, with the launches of the formula (hymba:
    2L more B1 a pass, its branch norms).  bf16: teacher-forced next-token
    logits (a 64-token prefill, 64 decode steps) within chip_smoke.py's
    limits of the plain path's (the floor and ceiling, or the yardstick's
    agreement within the margin)."""
    from repro_torch.kernels import _build
    from repro_torch.models import blocks
    from repro_torch.models.transformer import get_model
    from repro_torch.runtime.engine import InferenceEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = _family_cfg(arch, "float32")
    L, branch = cfg.num_layers, 2 if cfg.family == "hybrid" else 0
    params = get_model(cfg).init(seed=0, device=cuda)
    g = torch.Generator().manual_seed(1)
    toks = torch.randint(2, cfg.vocab_size, (2, 80), generator=g)
    out = {}
    for plain in (False, True):
        _build.reset_launches()
        out[plain] = InferenceEngine(cfg, params, max_len=128, device=cuda,
                                     plain=plain).generate(
            toks, max_new_tokens=16)
        torch.cuda.synchronize()
        if not plain:
            launches = dict(_build.LAUNCHES)
    assert torch.equal(out[False], out[True])
    assert launches["rmsnorm"] == 16 * (1 + branch * L)
    assert launches["add_rms_norm"] == 16 * 2 * L
    assert launches["flash_attention"] == L
    assert launches["decode_attention"] == 15 * L

    cfg = _family_cfg(arch, "bfloat16")
    params = get_model(cfg).init(seed=0, device=cuda)
    prompt = torch.randint(2, cfg.vocab_size, (1, 128), generator=g).to(cuda)

    def forced(model):
        with torch.inference_mode():
            logits, cache, _ = model.prefill(params, prompt[:, :64], 128)
            got = [logits]
            for i in range(64, 128):
                logits, cache = model.decode_step(params, cache,
                                                  prompt[:, i], i)
                got.append(logits)
        return torch.cat(got).float()

    def agreement(got, ref):
        return (float((got.argmax(-1) == ref.argmax(-1)).float().mean()),
                float((got - ref).abs().max()))

    cs = _chip_smoke()
    ref = forced(get_model(cfg, plain=True))
    match, drift = agreement(forced(get_model(cfg)), ref)
    if match >= cs.LOGIT_MATCH_FLOOR and drift <= cs.LOGIT_DRIFT_CEILING:
        return
    plain_attention = blocks.gqa_attention
    blocks.gqa_attention = cs.gqa_attention_exact
    try:
        y_match, y_drift = agreement(forced(get_model(cfg, plain=True)), ref)
    finally:
        blocks.gqa_attention = plain_attention
    margin = cs.YARDSTICK_MARGIN
    assert match >= y_match - margin and drift <= y_drift + margin, \
        (match, drift, y_match, y_drift)


@pytest.mark.gpu
@pytest.mark.parametrize("cf", [64.0, 1.0], ids=["dropless", "drops"])
def test_moe_dispatch_and_combine_are_deterministic(cuda, cf):
    """deepseek-moe-16b's routing (64 experts, top-6) at d 512, bf16, over
    333 tokens: the routed experts run twice give bitwise-equal output and
    aux loss (the combine is a gather, no atomics), and the card's
    dispatch plan (kept pairs, buffer slots) equals the CPU's on the same
    choices, drops included."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import moe as moe_lib

    full = get_config("deepseek-moe-16b")
    cfg = dataclasses.replace(full, num_layers=1, d_model=512,
                              moe=dataclasses.replace(
                                  full.moe, expert_d_ff=256,
                                  capacity_factor=cf))
    gen = torch.Generator(device=cuda).manual_seed(0)
    p = {k: v[0] for k, v in moe_lib.init_moe_blocks(
        gen, cfg, 1, torch.bfloat16).items()}
    xf = torch.randn(333, 512, generator=gen, device=cuda).to(torch.bfloat16)
    cap = moe_lib.moe_capacity(333, cfg)
    with torch.inference_mode():
        y1, a1 = moe_lib._moe_compute(cfg, p, xf, cap)
        y2, a2 = moe_lib._moe_compute(cfg, p, xf, cap)
        _, top_i, _ = moe_lib.route(cfg, p["router"], xf)
        top_i = torch.sort(top_i, dim=-1).values
        plan = moe_lib.dispatch_plan(top_i, 64, cap)
        cpu = moe_lib.dispatch_plan(top_i.cpu(), 64, cap)
    assert torch.equal(y1, y2) and torch.equal(a1, a2)
    assert bool(torch.isfinite(y1).all())
    for a, b in zip(plan, cpu):
        assert torch.equal(a.cpu(), b)
    assert bool((~plan[3]).any()) == (cf == 1.0)


@pytest.mark.gpu
@pytest.mark.parametrize("arch,head_dim", [("hubert-xlarge", 80),
                                           ("paligemma-3b", 256)])
def test_encoder_vlm_kernel_path_matches_plain(cuda, arch, head_dim):
    """f32, 3 layers at the full models' head dims: hubert's encode logits
    (B2 bidirectional at D 80) within 1e-4 of the plain path's, with L B2,
    1 B1 and 2L add_rms_norm and no decode kernel; paligemma's greedy
    tokens after 16 prefix embeddings (B2 prefix mode at D 256, then B3
    at D 256 over one KV head) equal the plain path's, with L B2 a
    prefill and L B3 a decode step."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.models.transformer import get_model
    from repro_torch.runtime.engine import InferenceEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_config(arch).reduced(num_layers=3),
                              head_dim=head_dim)
    L = cfg.num_layers
    params = get_model(cfg).init(seed=0, device=cuda)
    g = torch.Generator().manual_seed(2)
    out = {}
    for plain in (False, True):
        eng = InferenceEngine(cfg, params, max_len=128, device=cuda,
                              plain=plain)
        _build.reset_launches()
        if cfg.family == "encoder":
            f = torch.randn((2, 150, cfg.d_model), generator=g)
            out[plain] = eng.encode(f)
            g.manual_seed(2)
        else:
            toks = torch.randint(2, cfg.vocab_size, (2, 40), generator=g)
            pe = 0.02 * torch.randn((2, cfg.num_prefix_tokens, cfg.d_model),
                                    generator=g)
            g.manual_seed(2)
            out[plain] = eng.generate(toks, max_new_tokens=12, prefix_emb=pe)
        torch.cuda.synchronize()
        if not plain:
            launches = dict(_build.LAUNCHES)
    if cfg.family == "encoder":
        _close(out[False], out[True], 1e-4)
        passes, decode = 1, 0
    else:
        assert torch.equal(out[False], out[True])
        passes, decode = 12, 11
    assert launches["rmsnorm"] == passes
    assert launches["add_rms_norm"] == 2 * L * passes
    assert launches["flash_attention"] == L
    assert launches["decode_attention"] == decode * L
    assert launches["paged_decode_attention"] == 0



# ---------------------------------------------------------------------------
# gradients through the kernels: the plain versions' (kernels/grad.py)
# ---------------------------------------------------------------------------

GRAD_DTYPES = [pytest.param(torch.float32, 1e-5, id="f32"),
               pytest.param(torch.bfloat16, 2e-2, id="bf16")]


def _leaves(dev, dtype, seed, *shapes):
    rnd = _rand(dev, dtype, seed=seed)
    return [rnd(*s).requires_grad_() for s in shapes]


def _grads_of(fn, inputs, seed):
    """(outputs, d sum(out · g) / d inputs) with a random g per output."""
    outs = fn(*inputs)
    outs = outs if isinstance(outs, tuple) else (outs,)
    g = torch.Generator(device=outs[0].device).manual_seed(seed)
    ups = [torch.randn(o.shape, generator=g, device=o.device).to(o.dtype)
           for o in outs]
    return outs, torch.autograd.grad(outs, inputs, ups)


def _check_grads(kernel_fn, plain_fn, inputs, tol, launches, out_tol=None):
    """The dispatcher's outputs within ``out_tol`` (default ``tol``) of the
    plain version's and its gradients within ``tol`` (relative to each
    gradient's largest value) of plain autograd's, with ``launches``
    kernel launches in the forward and none in the backward."""
    from repro_torch.kernels import _build
    _build.reset_launches()
    outs = kernel_fn(*inputs)
    outs = outs if isinstance(outs, tuple) else (outs,)
    assert all(o.requires_grad for o in outs)
    assert {k: n for k, n in _build.LAUNCHES.items() if n} == launches
    _build.reset_launches()
    got_outs, got = _grads_of(kernel_fn, inputs, seed=5)
    torch.cuda.synchronize()
    assert {k: n for k, n in _build.LAUNCHES.items() if n} == launches
    want_outs, want = _grads_of(plain_fn, inputs, seed=5)
    for a, b in zip(got_outs, want_outs):
        _close(a, b, out_tol or tol)
    for a, b in zip(got, want):
        scale = float(b.float().abs().max())
        torch.testing.assert_close(a.float(), b.float(), rtol=tol,
                                   atol=tol * scale)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", GRAD_DTYPES)
@pytest.mark.parametrize("rows", [4, 333])
def test_norm_kernel_grads_are_plain_autograd(cuda, dtype, tol, rows):
    """B1 and add_rms_norm under autograd at [rows, 3072]: the kernels run
    the forward, the gradients of x, y and the weight are the plain
    versions'."""
    x, y, w = _leaves(cuda, dtype, rows, (rows, 3072), (rows, 3072), (3072,))
    _check_grads(rops.rms_norm, rref.rms_norm_ref, [x, w], tol,
                 {"rmsnorm": 1})
    _check_grads(rops.add_rms_norm, rref.add_rms_norm_ref, [x, y, w], tol,
                 {"add_rms_norm": 1})


GRAD_FLASH_MODES = [pytest.param("causal", 0, 40, id="causal-w40"),
                    pytest.param("bidirectional", 0, 40, id="bidir-w40"),
                    pytest.param("prefix", 77, 20, id="prefix77-w20")]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", GRAD_DTYPES)
@pytest.mark.parametrize("d,hkv,g", [(64, 2, 2), (80, 2, 1), (128, 2, 3),
                                     (256, 1, 8)])
@pytest.mark.parametrize("mode,prefix_len,window", GRAD_FLASH_MODES)
def test_flash_kernel_grads_are_plain_autograd(cuda, dtype, tol, mode,
                                               prefix_len, window, d, hkv, g):
    """B2 under autograd in each mask with a window, a ragged KV length:
    the gradients of q, k and v are flash_attention_ref's."""
    q, k, v = _leaves(cuda, dtype, d + prefix_len, (2, 150, hkv * g, d),
                      (2, 150, hkv, d), (2, 150, hkv, d))
    off, kl = _i32(cuda, [0, 0]), _i32(cuda, [150, 101])
    kw = dict(window=window, mode=mode, prefix_len=prefix_len)

    def kernel(q, k, v):
        return fops.flash_attention(q, k, v, off, kl, **kw)

    def plain(q, k, v):
        return fref.flash_attention_ref(q, k, v, off, kl, **kw)
    _check_grads(kernel, plain, [q, k, v], tol, {"flash_attention": 1})


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", GRAD_DTYPES)
@pytest.mark.parametrize("s,chunk", [(77, 16), (8, 0)],
                         ids=["chunked", "per-step"])
def test_wkv6_kernel_grads_are_plain_autograd(cuda, dtype, tol, s, chunk):
    """B10 under autograd, its chunked kernel (S = 77) and its per-step one
    (S = 8): y and the final state, and the gradients of r, k, v, w, u and
    the initial state, are those of the plain form of the kernel that ran
    (wkv6_chunk_ref, wkv6_ref)."""
    r, k, v, w, u, st = _wkv6_inputs(cuda, dtype, 2, s, 3, 64, seed=s)
    inputs = [t.requires_grad_() for t in (r, k, v, w, u, st)]
    assert wops.kernel_chunk(*r.shape) == chunk
    plain = wref.wkv6_chunk_ref if chunk else wref.wkv6_ref
    # the outputs to B10's card tolerance (test_wkv6_kernel: f32 state
    # updates contracted to FMAs); the gradients are plain autograd's
    _check_grads(wops.wkv6, plain, inputs, tol, {"wkv6": 1},
                 out_tol=tol if dtype == torch.bfloat16 else 1e-4)


@pytest.mark.gpu
def test_dispatchers_launch_as_before_without_autograd(cuda):
    """Under inference_mode (every serving entry) and with no input that
    requires grad, each dispatcher launches its kernel once, outputs
    bitwise the *_cuda wrapper's, nothing recorded for autograd."""
    from repro_torch.kernels import _build
    rnd = _rand(cuda, torch.bfloat16, seed=3)
    x, y, w = rnd(4, 3072), rnd(4, 3072), rnd(3072)
    q, k, v = rnd(1, 70, 8, 128), rnd(1, 70, 2, 128), rnd(1, 70, 2, 128)
    off, kl = _i32(cuda, [0]), _i32(cuda, [70])
    wk = _wkv6_inputs(cuda, torch.bfloat16, 1, 33, 2, 64)
    calls = [("rmsnorm", lambda: rops.rms_norm(x, w),
              lambda: rops.rms_norm_cuda(x, w)),
             ("add_rms_norm", lambda: rops.add_rms_norm(x, y, w),
              lambda: rops.add_rms_norm_cuda(x, y, w)),
             ("flash_attention", lambda: fops.flash_attention(q, k, v, off, kl),
              lambda: fops.flash_attention_cuda(q, k, v, off, kl)),
             ("wkv6", lambda: wops.wkv6(*wk), lambda: wops.wkv6_cuda(*wk))]
    for mode in (torch.inference_mode, torch.enable_grad):
        for name, fn, direct in calls:
            with mode():
                _build.reset_launches()
                out = fn()
                torch.cuda.synchronize()
                assert {n: c for n, c in _build.LAUNCHES.items() if c} == \
                    {name: 1}
                outs = out if isinstance(out, tuple) else (out,)
                assert not any(o.requires_grad for o in outs)
                for a, b in zip(outs, (lambda o: o if isinstance(o, tuple)
                                       else (o,))(direct())):
                    assert torch.equal(_bits(a), _bits(b)), name


@pytest.mark.gpu
@pytest.mark.parametrize("arch,remat", [("llama32-3b", "none"),
                                        ("llama32-3b", "full"),
                                        ("rwkv6-7b", "none")])
def test_train_loss_grads_kernel_path_match_plain(cuda, arch, remat):
    """f32, 2 layers at reduced width: make_loss_fn's gradient on the
    kernel path (B1, add_rms_norm, B2; B10 for rwkv6) within 1e-4 of the
    plain path's for every leaf, relative to the leaf's largest value; the
    forward's launches 1 B1, 2L add_rms_norm and L B2 or B10, no other
    kernel; under remat the backward's recompute launches each layer's
    again (all but the final norm's add_rms_norm)."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.models.transformer import get_model
    from repro_torch.runtime import train

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_config(arch).reduced(), remat=remat)
    L = cfg.num_layers
    params = get_model(cfg).init(seed=0, device=cuda)
    tokens = torch.randint(2, cfg.vocab_size, (2, 64),
                           generator=torch.Generator().manual_seed(1))
    batch = {"tokens": tokens.to(cuda)}
    _build.reset_launches()
    loss, _, grads = train.loss_and_grads(
        train.make_loss_fn(get_model(cfg)), params, batch)
    torch.cuda.synchronize()
    launches = {n: c for n, c in _build.LAUNCHES.items() if c}
    p_loss, _, p_grads = train.loss_and_grads(
        train.make_loss_fn(get_model(cfg, plain=True)), params, batch)
    again = remat != "none"
    layer_kernel = "wkv6" if cfg.family == "ssm" else "flash_attention"
    assert launches == {"rmsnorm": 1 + again,
                        "add_rms_norm": 2 * L + again * (2 * L - 1),
                        layer_kernel: L * (1 + again)}
    assert abs(float(loss) - float(p_loss)) < 1e-4
    from repro_torch.checkpoint.store import flatten
    want = flatten(p_grads)
    for key, g in flatten(grads).items():
        scale = float(want[key].abs().max())
        torch.testing.assert_close(g, want[key], rtol=1e-4,
                                   atol=1e-4 * scale, msg=key)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(1, 2), (2, 2)], ids=["1x2", "2x2"])
def test_expert_tp_kernel_path_matches_plain(cuda, shape):
    """Reduced deepseek-moe-16b on the expert-TP path (``moe_dispatch``
    "local" on a virtual (data, model) mesh), f32: engine greedy tokens
    of the kernel path equal the plain path's and the GSPMD path's (the
    reduced config drops no pair, so the data shards' routing changes
    nothing), the launches are the dense formula (the FFN runs no
    kernel), and the comm log is one model all-reduce of one data
    shard's [tokens, h] a layer and pass, as on the CPU."""
    import dataclasses
    from repro_torch.core.comm import VirtualMesh
    from repro_torch.kernels import _build
    from repro_torch.models.transformer import get_model
    from repro_torch.runtime import meshctx
    from repro_torch.runtime.engine import InferenceEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    gspmd = _family_cfg("deepseek-moe-16b", "float32")
    cfg = dataclasses.replace(gspmd, moe_dispatch="local")
    L = cfg.num_layers
    params = get_model(cfg).init(seed=0, device=cuda)
    toks = torch.randint(2, cfg.vocab_size, (2, 40),
                         generator=torch.Generator().manual_seed(1))
    want = InferenceEngine(gspmd, params, max_len=64,
                           device=cuda).generate(toks, max_new_tokens=12)
    mesh = VirtualMesh(shape, ("data", "model"))
    meshctx.set_mesh(mesh)
    try:
        out = {}
        for plain in (False, True):
            mesh.log.clear()
            _build.reset_launches()
            out[plain] = InferenceEngine(cfg, params, max_len=64, device=cuda,
                                         plain=plain).generate(
                toks, max_new_tokens=12)
            torch.cuda.synchronize()
            if not plain:
                launches = {n: c for n, c in _build.LAUNCHES.items() if c}
                log = mesh.summary()
    finally:
        meshctx.set_mesh(None)
    assert torch.equal(out[False], out[True])
    assert torch.equal(out[False], want)
    assert launches == {"rmsnorm": 12, "add_rms_norm": 12 * 2 * L,
                        "flash_attention": L, "decode_attention": 11 * L}
    dp, t = shape
    assert [(o.collective, o.count, o.shape, o.workers, o.dtype_bytes)
            for o in log] == [
        ("allreduce", L, (2 * 40 // dp, cfg.d_model), t, 4),
        ("allreduce", 11 * L, (2 // dp, cfg.d_model), t, 4)]
