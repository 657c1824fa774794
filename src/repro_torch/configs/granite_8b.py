"""IBM Granite Code 8B — llama-architecture dense GQA model [arXiv:2405.04324]."""
from repro_torch.config.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-8b",
    family="dense",
    num_layers=36,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=49152,
    activation="swiglu",
    rope_theta=10_000_000.0,
    citation="arXiv:2405.04324 (Granite Code Models)",
)
