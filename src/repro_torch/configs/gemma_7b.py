"""Gemma 7B — dense, GeGLU, head_dim 256 [arXiv:2403.08295]."""
from repro_torch.config.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma-7b",
    family="dense",
    num_layers=28,
    d_model=3072,
    num_heads=16,
    num_kv_heads=16,
    head_dim=256,
    d_ff=24576,
    vocab_size=256000,
    activation="geglu",
    tie_embeddings=True,
    scale_embedding=True,
    citation="arXiv:2403.08295 (Gemma)",
)
