"""Configuration dataclasses for the repro framework.

Everything downstream (model zoo, comm model, sharding rules, dry-run) is driven
by these frozen dataclasses.  Architectures live in ``repro_torch.configs.<id>`` and
are looked up through :func:`repro_torch.configs.get_config`.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts block configuration."""

    num_experts: int
    top_k: int
    expert_d_ff: int
    num_shared_experts: int = 0
    shared_d_ff: int = 0
    router_aux_coef: float = 0.01
    capacity_factor: float = 1.25   # == num_experts ⇒ dropless

    @property
    def active_experts(self) -> int:
        return self.top_k + self.num_shared_experts


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    """State-space / linear-attention (RWKV6, Mamba-style) configuration."""

    head_size: int = 64          # per-head recurrent channel width
    state_size: int = 16         # mamba-style SSM state (hymba); rwkv uses head_size
    kind: str = "rwkv6"          # "rwkv6" | "mamba"
    expand: int = 1              # channel expansion for mamba-style blocks
    conv_width: int = 4          # local conv width (mamba-style)
    scan_impl: str = "step"      # "step" (per-token scan) | "chunked" (§Perf)
    scan_chunk: int = 16         # time-chunk length for the chunked path


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """A single architecture.  ``family`` selects the model-zoo implementation."""

    name: str
    family: str                  # dense | moe | ssm | hybrid | encoder | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None
    activation: str = "swiglu"   # swiglu | geglu | gelu
    norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    tie_embeddings: bool = False
    sliding_window: Optional[int] = None   # sliding-window attention width
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    # hybrid (hymba): how many of num_heads are attention vs ssm heads
    attn_head_fraction: float = 1.0
    # modality frontends (assignment carve-out: stubbed, embeddings provided)
    frontend: Optional[str] = None         # None | "siglip_stub" | "audio_stub"
    num_prefix_tokens: int = 0             # image patches / audio frames
    is_decoder: bool = True                # False => encoder-only (no decode phases)
    scale_embedding: bool = False          # multiply embeddings by sqrt(d_model) (gemma)
    remat: str = "none"                    # "none" | "full" | "dots" (train-time)
    attention_impl: str = "ref"            # "ref" | "chunked" (flash-style, §Perf)
    attention_chunk: int = 1024            # KV block size for the chunked path
    moe_dispatch: str = "gspmd"            # "gspmd" | "local" (shard_map, §Perf)
    moe_fsdp: bool = False                 # shard expert weights over "data" too
    dtype: str = "bfloat16"
    citation: str = ""

    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        assert self.num_heads % max(self.num_kv_heads, 1) == 0, (
            f"{self.name}: heads {self.num_heads} not divisible by kv {self.num_kv_heads}")

    # ---- derived quantities used by the comm model and roofline ----
    @property
    def padded_vocab(self) -> int:
        """Vocab padded to a multiple of 128 so the embedding/LM-head shard
        cleanly on a 16-wide model axis (pad logits are masked to -inf)."""
        return ((self.vocab_size + 127) // 128) * 128

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    @property
    def gqa_groups(self) -> int:
        return self.num_heads // self.num_kv_heads

    def param_count(self) -> int:
        """Total parameter count N (embedding included once if tied)."""
        h, L = self.d_model, self.num_layers
        attn = h * self.q_dim + 2 * h * self.kv_dim + self.q_dim * h
        n_glu = 3 if self.activation in ("swiglu", "geglu") else 2
        if self.moe is not None:
            mlp = self.moe.num_experts * n_glu * h * self.moe.expert_d_ff
            mlp += self.moe.num_shared_experts * n_glu * h * self.moe.shared_d_ff
            mlp += h * self.moe.num_experts  # router
        else:
            mlp = n_glu * h * self.d_ff
        if self.family == "ssm":
            # rwkv6: time-mix (r,k,v,g,o ~ 5 h^2 at head granularity) + channel-mix
            attn = 5 * h * h + h * self.ssm.head_size  # decay/projection extras folded in
            mlp = 2 * h * self.d_ff
        if self.family == "hybrid":
            # parallel attn + ssm head groups share qkv/out projections; add ssm extras
            attn += 2 * h * self.ssm.state_size * 2
        norms = 2 * h
        per_layer = attn + mlp + norms
        emb = self.vocab_size * h
        head = 0 if self.tie_embeddings else self.vocab_size * h
        return L * per_layer + emb + head + h

    def active_param_count(self) -> int:
        """Active (per-token) parameters — differs from total only for MoE."""
        if self.moe is None:
            return self.param_count()
        h, L = self.d_model, self.num_layers
        n_glu = 3 if self.activation in ("swiglu", "geglu") else 2
        dense_total = self.param_count()
        all_experts = self.moe.num_experts * n_glu * h * self.moe.expert_d_ff
        active = self.moe.top_k * n_glu * h * self.moe.expert_d_ff
        return dense_total - L * (all_experts - active)

    def reduced(self, max_d_model: int = 256, num_layers: int = 2,
                max_experts: int = 4, vocab: int = 512) -> "ModelConfig":
        """Reduced variant of the same family for CPU smoke tests."""
        scale = max(1, self.d_model // max_d_model)
        d_model = max(64, self.d_model // scale)
        num_heads = max(1, min(self.num_heads, 4))
        num_kv = max(1, min(self.num_kv_heads, num_heads))
        while num_heads % num_kv:
            num_kv -= 1
        head_dim = max(8, d_model // num_heads)
        moe = None
        if self.moe is not None:
            n_exp = min(self.moe.num_experts, max_experts)
            moe = dataclasses.replace(
                self.moe,
                num_experts=n_exp,
                top_k=min(self.moe.top_k, 2),
                expert_d_ff=d_model * 2,
                shared_d_ff=d_model * 2 if self.moe.num_shared_experts else 0,
                num_shared_experts=min(self.moe.num_shared_experts, 1),
                capacity_factor=float(n_exp),   # dropless at test scale
            )
        return dataclasses.replace(
            self,
            name=self.name + "-reduced",
            num_layers=num_layers,
            d_model=d_model,
            num_heads=num_heads,
            num_kv_heads=num_kv,
            head_dim=head_dim,
            d_ff=d_model * 4,
            vocab_size=vocab,
            moe=moe,
            sliding_window=min(self.sliding_window, 64) if self.sliding_window else None,
            num_prefix_tokens=min(self.num_prefix_tokens, 16),
            dtype="float32",
        )


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """An assigned (seq_len, global_batch) workload shape."""

    name: str
    seq_len: int
    global_batch: int
    mode: str                    # "train" | "prefill" | "decode"


INPUT_SHAPES = {
    "train_4k":    ShapeConfig("train_4k",    4_096,   256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768,  32,  "prefill"),
    "decode_32k":  ShapeConfig("decode_32k",  32_768,  128, "decode"),
    "long_500k":   ShapeConfig("long_500k",   524_288, 1,   "decode"),
}


@dataclasses.dataclass(frozen=True)
class ParallelismConfig:
    """Paper-study parallelism layout (explicit TP / PP engine) or mesh layout."""

    tensor_parallel: int = 1
    pipeline_parallel: int = 1
    data_parallel: int = 1
    pods: int = 1

    @property
    def world_size(self) -> int:
        return (self.tensor_parallel * self.pipeline_parallel
                * self.data_parallel * self.pods)


@dataclasses.dataclass(frozen=True)
class HardwareProfile:
    """α–β hardware model used by core/slo.py and core/roofline.py."""

    name: str
    peak_flops: float            # bf16 FLOP/s per chip
    hbm_bw: float                # bytes/s per chip
    intra_bw: float              # bytes/s per chip, fast domain (NVLink / ICI)
    inter_bw: float              # bytes/s per chip, slow domain (IB / DCN)
    intra_alpha: float           # seconds per collective, fast domain
    inter_alpha: float           # seconds per collective, slow domain
    intra_degree: int = 4        # chips per fast domain (node / pod slice)


# Target hardware for this repo (assignment constants).
TPU_V5E = HardwareProfile(
    name="tpu_v5e",
    peak_flops=197e12, hbm_bw=819e9,
    intra_bw=50e9, inter_bw=25e9,
    intra_alpha=1e-6, inter_alpha=10e-6,
    intra_degree=256,
)

# The paper's platform (Table II): 4xH100-94GB NVLink node, IB NDR400.
# inter_alpha is the *effective* cross-node small-message collective latency
# observed through vLLM V0 + NCCL (fitted to Fig 8's TP=8 TPOT blow-up); raw
# NCCL IB latency is ~20 µs, the engine stack inflates it ~6×.
H100_NODE = HardwareProfile(
    name="h100_node",
    peak_flops=660e12, hbm_bw=2.4e12,
    intra_bw=450e9, inter_bw=50e9,
    intra_alpha=8e-6, inter_alpha=120e-6,
    intra_degree=4,
)

HARDWARE = {"tpu_v5e": TPU_V5E, "h100_node": H100_NODE}
