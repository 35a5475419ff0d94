"""Configuration dataclasses: the HARMONY ANNS engine (``HarmonyConfig``)
and the LM architecture pool (``ModelConfig`` with ``MoEConfig``, the
shape cells ``SHAPES``).

Field-for-field copies of ``repro.config``'s dataclasses. Everything is a
frozen dataclass, so configs are hashable; ``repro_torch.configs``
registers one ``ModelConfig`` per assigned architecture.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class HarmonyConfig:
    """Config for the HARMONY distributed ANNS engine."""

    dim: int = 128                  # vector dimensionality D
    nlist: int = 64                 # number of IVF clusters
    nprobe: int = 8                 # probed clusters per query
    topk: int = 10                  # K of top-K search
    metric: str = "l2"              # "l2" | "ip" (inner product / cosine on normalized)

    # Partition plan search space: factorizations (B_vec, B_dim) of n_devices.
    max_dim_blocks: int = 8         # upper bound on B_dim the planner may pick
    alpha: float = 1.0              # imbalance weight α in C(π,Q)

    # Pipeline / pruning switches (Mode in the paper's CLI):
    #   "harmony" (hybrid adaptive), "vector", "dimension"
    mode: str = "harmony"
    enable_pruning: bool = True
    prewarm_samples: int = 4        # vectors per probed cluster used to seed τ
    query_block: int = 32           # vector-level pipeline batch size

    # Kernel tiling
    tile_n: int = 128               # candidate tile
    tile_q: int = 128               # query tile
    tile_d: int = 128               # dimension-block inner tile

    # Two-stage int8 search tier (precision="int8"):
    quant_blocks: int = 4           # dimension blocks per int8 scale/zero grid
    rerank_factor: int = 4          # stage-1 keeps k·rerank_factor candidates

    # Selectivity-aware probe widening for filtered search.
    filter_widen_threshold: float = 0.2
    filter_widen_cap: float = 4.0

    # k-means training
    kmeans_iters: int = 12
    kmeans_seed: int = 0

    def replace(self, **kw) -> "HarmonyConfig":
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# LM architectures
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 0
    experts_per_token: int = 0
    # d_ff of each expert is ModelConfig.d_ff when MoE is enabled.
    router_jitter: float = 0.0
    load_balance_loss: float = 0.01


@dataclass(frozen=True)
class ModelConfig:
    """One assigned architecture. Field names follow the assignment table."""

    name: str
    family: str                    # dense | moe | audio | ssm | vlm | hybrid
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None          # default d_model // num_heads

    # attention flavor
    qkv_bias: bool = False                   # qwen1.5
    rope_theta: float = 10000.0
    rope_style: str = "rope"                 # rope | mrope (qwen2-vl) | none
    sliding_window: int = 0                  # >0 → local attention window
    local_global_ratio: int = 0              # gemma3: N local layers per 1 global
    attn_logit_softcap: float = 0.0

    # mlp flavor
    mlp: str = "swiglu"                      # swiglu | gelu
    # norms
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    scale_embed: bool = False                # gemma-style sqrt(d) embed scale

    # MoE
    moe: MoEConfig = field(default_factory=MoEConfig)

    # SSM / hybrid
    ssm_state: int = 0                       # mamba2 state size (zamba2)
    ssm_conv: int = 4
    ssm_expand: int = 2
    xlstm_slstm_every: int = 0               # xlstm: 1-in-N blocks are sLSTM
    hybrid_attn_every: int = 0               # zamba2: shared attn block period

    # modality frontend stubs
    frontend: str = "none"                   # none | audio_frames | vision_patches
    encoder_only: bool = False               # hubert

    # precision / training
    dtype: str = "bfloat16"
    param_dtype: str = "bfloat16"
    optimizer: str = "adamw"                 # adamw | adafactor (1T-scale)
    remat: bool = True
    fsdp_params: bool = False                # shard params over data axis too
    # layers folded into one scan step (pattern unit for mixed stacks)
    scan_unit: int = 1

    # which of the 4 assigned shapes apply (see DESIGN.md skip policy)
    supports_decode: bool = True
    supports_long_context: bool = False

    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)

    @property
    def is_moe(self) -> bool:
        return self.moe.num_experts > 0

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class ShapeSpec:
    """One assigned input-shape cell."""

    name: str                      # train_4k | prefill_32k | decode_32k | long_500k
    seq_len: int
    global_batch: int
    kind: str                      # train | prefill | decode


SHAPES: Tuple[ShapeSpec, ...] = (
    ShapeSpec("train_4k", 4096, 256, "train"),
    ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    ShapeSpec("decode_32k", 32768, 128, "decode"),
    ShapeSpec("long_500k", 524288, 1, "decode"),
)


def shape_by_name(name: str) -> ShapeSpec:
    for s in SHAPES:
        if s.name == name:
            return s
    raise KeyError(f"unknown shape {name!r}; known: {[s.name for s in SHAPES]}")


def applicable_shapes(cfg: ModelConfig) -> Tuple[ShapeSpec, ...]:
    """Shape cells that apply to an arch per DESIGN.md's skip policy."""
    out = []
    for s in SHAPES:
        if s.kind == "decode" and (cfg.encoder_only or not cfg.supports_decode):
            continue
        if s.name == "long_500k" and not cfg.supports_long_context:
            continue
        out.append(s)
    return tuple(out)
