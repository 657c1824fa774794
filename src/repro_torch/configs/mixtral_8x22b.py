"""Mixtral 8x22B — sparse MoE, 8 experts top-2, sliding-window attention [arXiv:2401.04088]."""
from repro_torch.config.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b",
    family="moe",
    num_layers=56,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab_size=32768,
    activation="swiglu",
    rope_theta=1_000_000.0,
    sliding_window=4096,     # SWA per assignment bracket (Mixtral lineage)
    moe=MoEConfig(num_experts=8, top_k=2, expert_d_ff=16384),
    citation="arXiv:2401.04088 (Mixtral of Experts)",
)
