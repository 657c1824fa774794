"""Llama-3.1-8B — the paper's primary profiling subject (Tables III, V, VI)."""
from repro_torch.config.base import ModelConfig

CONFIG = ModelConfig(
    name="llama31-8b",
    family="dense",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=128256,
    activation="swiglu",
    rope_theta=500_000.0,
    citation="arXiv:2407.21783 (Llama 3 herd); paper Table III/V/VI subject",
)
