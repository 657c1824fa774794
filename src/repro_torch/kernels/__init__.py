"""Hand-written Hopper kernels of the port, each beside its plain version.

``rmsnorm`` (B1), ``flash_attention`` (B2) and ``decode_attention`` (B3 and
B4) each hold ``csrc/*.cu`` (the CUDA kernel), ``ref.py`` (the plain
PyTorch version) and ``ops.py`` (the dispatch: the plain version for a CPU
tensor, the kernel for a CUDA tensor).  ``_build.py`` compiles all sources
with one ``nvcc`` call and keeps the launch counts.
"""
