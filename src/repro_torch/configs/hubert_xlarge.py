"""HuBERT X-Large — encoder-only audio transformer (w2v2 backbone) [arXiv:2106.07447].

Assignment carve-out: the conv/mel frontend is a stub — ``input_specs`` feeds
precomputed frame embeddings of shape (batch, frames, d_model).  Encoder-only:
no decode phases (decode_32k / long_500k skipped, see DESIGN.md).
"""
from repro_torch.config.base import ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge",
    family="encoder",
    num_layers=48,
    d_model=1280,
    num_heads=16,
    num_kv_heads=16,
    head_dim=80,
    d_ff=5120,
    vocab_size=504,          # k-means target codebook
    activation="gelu",
    frontend="audio_stub",
    is_decoder=False,
    citation="arXiv:2106.07447 (HuBERT)",
)
