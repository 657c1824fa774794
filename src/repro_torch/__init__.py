"""PyTorch/CUDA port of the ``repro`` package for NVIDIA Hopper (H100).

The JAX package ``repro`` is the reference; this package mirrors its layout
and module names, imports ``torch`` and numpy, and never imports JAX or
``repro``.  Its entry points run on the CUDA card unless the caller passes
``device="cpu"``.
"""
