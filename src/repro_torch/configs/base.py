"""Model/shape configuration dataclasses.

Every assigned architecture is described by a :class:`ModelConfig`. The same
config object drives parameter-spec construction, forward functions, sharding
rules, the dry-run, and the serving engine, so there is exactly one source of
truth per architecture.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.utils import round_up

# Block kinds that may appear in ``ModelConfig.pattern``.
ATTN = "attn"      # full (global) attention
LOCAL = "local"    # sliding-window attention (window = cfg.window)
SSM = "ssm"        # Mamba2 SSD mixer
REC = "rec"        # RG-LRU recurrent block


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff_expert: int
    shared_expert: bool = False          # llama4-style always-on expert
    capacity_factor: float = 1.25
    min_capacity: int = 4
    router_dtype: str = "float32"


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    head_dim: int = 64
    expand: int = 2
    conv_width: int = 4
    chunk: int = 256                     # SSD chunk length


@dataclasses.dataclass(frozen=True)
class RGLRUConfig:
    d_rnn: int = 0                       # 0 => d_model
    conv_width: int = 4
    c: float = 8.0                       # RG-LRU gate sharpness constant


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                          # dense|moe|ssm|hybrid|vlm|audio
    num_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int

    pattern: tuple = (ATTN,)             # repeating block-kind pattern
    window: int = 0                      # sliding window for LOCAL blocks
    mlp: str = "swiglu"                  # swiglu|gelu|none
    norm_eps: float = 1e-6
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    attn_softcap: float = 0.0
    final_softcap: float = 0.0
    scale_embed: bool = False            # gemma-style sqrt(d_model) scaling
    post_norms: bool = False             # gemma2-style post-block norms
    tie_embeddings: bool = False

    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    rglru: Optional[RGLRUConfig] = None

    # encoder-decoder (seamless)
    is_encdec: bool = False
    enc_layers: int = 0

    # modality stub: None | "image_patches" | "audio_frames"
    modality: Optional[str] = None
    img_tokens: int = 0                  # patch-embedding token count (vlm)

    # distribution
    optimizer: str = "adamw"             # adamw|adafactor
    remat: bool = True
    microbatches: int = 1                # gradient-accumulation splits
    seq_shard_train: bool = False        # Megatron-SP residual activations

    # hints for serving memory planning
    sliding_kv: bool = True              # LOCAL layers keep window-sized KV

    @property
    def vocab_padded(self) -> int:
        # Padded so the vocab dim shards evenly over a 16-way axis and stays
        # lane-aligned (multiples of 256).
        return round_up(self.vocab_size, 256)

    @property
    def q_per_kv(self) -> int:
        return self.n_heads // self.n_kv_heads

    def pattern_split(self):
        """(pattern, n_groups, leftover): layers = pattern*n_groups + leftover."""
        p = self.pattern
        n_groups = self.num_layers // len(p)
        leftover = tuple(p[: self.num_layers % len(p)])
        return p, n_groups, leftover


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str                            # train|prefill|decode
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524288, 1),
}

# long_500k requires sub-quadratic attention / bounded state; pure
# full-attention archs skip it (documented in DESIGN.md §4).
LONG_CONTEXT_ARCHS = frozenset(
    {"mamba2-130m", "recurrentgemma-2b", "gemma2-27b"}
)


def shape_applicable(cfg: ModelConfig, shape: ShapeSpec) -> bool:
    if shape.name == "long_500k":
        return cfg.name in LONG_CONTEXT_ARCHS
    return True
