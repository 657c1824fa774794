"""RWKV-6 "Finch" 7B — attention-free RNN with data-dependent decay [arXiv:2404.05892]."""
from repro_torch.config.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="rwkv6-7b",
    family="ssm",
    num_layers=32,
    d_model=4096,
    num_heads=64,            # 4096 / head_size 64 wkv heads
    num_kv_heads=64,
    head_dim=64,
    d_ff=14336,              # channel-mix hidden
    vocab_size=65536,
    activation="swiglu",     # channel-mix uses squared-relu in paper; swiglu-width kept
    ssm=SSMConfig(head_size=64, kind="rwkv6"),
    citation="arXiv:2404.05892 (Eagle and Finch: RWKV-5/6)",
)
