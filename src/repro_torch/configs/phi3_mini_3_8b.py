"""Phi-3-mini 3.8B — dense, RoPE + SwiGLU, MHA-as-GQA (kv=32) [arXiv:2404.14219]."""
from repro_torch.config.base import ModelConfig

CONFIG = ModelConfig(
    name="phi3-mini-3.8b",
    family="dense",
    num_layers=32,
    d_model=3072,
    num_heads=32,
    num_kv_heads=32,
    head_dim=96,
    d_ff=8192,
    vocab_size=32064,
    activation="swiglu",
    rope_theta=10_000.0,
    citation="arXiv:2404.14219 (Phi-3 Technical Report)",
)
