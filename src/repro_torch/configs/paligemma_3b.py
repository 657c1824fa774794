"""PaliGemma 3B — SigLIP vision encoder (stubbed) + Gemma decoder [arXiv:2407.07726].

Assignment carve-out: the SigLIP ViT is a stub — ``input_specs`` provides 256
precomputed patch embeddings per image that are prepended to the token sequence.
"""
from repro_torch.config.base import ModelConfig

CONFIG = ModelConfig(
    name="paligemma-3b",
    family="vlm",
    num_layers=18,
    d_model=2048,
    num_heads=8,
    num_kv_heads=1,          # MQA
    head_dim=256,
    d_ff=16384,
    vocab_size=257216,
    activation="geglu",
    tie_embeddings=True,
    scale_embedding=True,
    frontend="siglip_stub",
    num_prefix_tokens=256,   # 224px / patch14 -> 256 patches
    citation="arXiv:2407.07726 (PaliGemma)",
)
