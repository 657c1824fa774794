"""Hand-written Hopper kernels of the port, each beside its plain version.

``rmsnorm`` (B1), ``flash_attention`` (B2), ``decode_attention`` (B3 and
B4), ``quant_collective`` (B5–B9) and ``rwkv6_scan`` (B10) each hold
``csrc/*.cu`` (the CUDA kernels), ``ref.py`` (the plain PyTorch versions)
and ``ops.py`` (the dispatch: the plain version for a CPU tensor, the
kernel for a CUDA tensor).  ``_build.py`` compiles all sources with one
``nvcc`` call and keeps the launch counts.
"""
