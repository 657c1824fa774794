"""DeepSeekMoE 16B — fine-grained MoE: 2 shared + 64 routed, top-6 [arXiv:2401.06066]."""
from repro_torch.config.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b",
    family="moe",
    num_layers=28,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=1408,               # per-expert width (fine-grained)
    vocab_size=102400,
    activation="swiglu",
    moe=MoEConfig(num_experts=64, top_k=6, expert_d_ff=1408,
                  num_shared_experts=2, shared_d_ff=1408),
    citation="arXiv:2401.06066 (DeepSeekMoE)",
)
