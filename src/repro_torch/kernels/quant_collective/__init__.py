from repro_torch.kernels.quant_collective.ops import (  # noqa: F401
    DEFAULT_CHUNK, QUANT_DTYPES, QUANT_TOLERANCE, chunk_amax,
    chunk_dequantize, chunk_quantize, collective_qmax, nibble_pack,
    nibble_unpack, scales_from_amax)
