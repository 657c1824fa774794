"""Llama-3.2-3B — paper's SLO-scaling subject (Figs 8, 9) and Table IV column."""
from repro_torch.config.base import ModelConfig

CONFIG = ModelConfig(
    name="llama32-3b",
    family="dense",
    num_layers=28,
    d_model=3072,
    num_heads=24,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=128256,
    activation="swiglu",
    rope_theta=500_000.0,
    citation="Llama 3.2 model card; paper Fig 8/9 + Table IV subject",
)
