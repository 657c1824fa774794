"""Hymba 1.5B — hybrid-head: parallel attention + mamba heads per layer [arXiv:2411.13676]."""
from repro_torch.config.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="hymba-1.5b",
    family="hybrid",
    num_layers=32,
    d_model=1600,
    num_heads=25,
    num_kv_heads=5,
    head_dim=64,
    d_ff=5504,
    vocab_size=32001,
    activation="swiglu",
    sliding_window=1024,     # hymba uses SWA on most layers
    attn_head_fraction=0.5,  # heads split between attention and SSM paths
    ssm=SSMConfig(state_size=16, kind="mamba", head_size=64),
    citation="arXiv:2411.13676 (Hymba)",
)
