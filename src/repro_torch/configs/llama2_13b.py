"""Llama-2-13B — paper's hybrid-parallelism SLO subject (Fig 10) and Table IV column."""
from repro_torch.config.base import ModelConfig

CONFIG = ModelConfig(
    name="llama2-13b",
    family="dense",
    num_layers=40,
    d_model=5120,
    num_heads=40,
    num_kv_heads=40,
    head_dim=128,
    d_ff=13824,
    vocab_size=32000,
    activation="swiglu",
    citation="arXiv:2307.09288 (Llama 2); paper Fig 10 + Table IV subject",
)
