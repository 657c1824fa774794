from repro_torch.kernels.quant_collective.ops import (  # noqa: F401
    DEFAULT_CHUNK, QUANT_DTYPES, QUANT_TOLERANCE, chunk_amax,
    chunk_dequantize, chunk_quantize, chunk_quantize_pack,
    chunk_quantize_pack_shared, chunk_quantize_shared, collective_qmax,
    dequantize_add_rms_norm, nibble_reduce_requant, nibble_unpack_dequantize,
    scales_from_amax)
