"""mamba2-130m [ssm]: attention-free SSD (state-space duality).

24L d_model=768 d_ff=0 vocab=50280, ssm_state=128 [arXiv:2405.21060;
unverified]. Blocks are pure Mamba2 mixers (no MLP): d_inner=2*d_model=1536,
24 SSD heads of dim 64, state 128. O(1) decode state — runs long_500k.
"""
import dataclasses

from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-130m",
    family="ssm",
    num_layers=24,
    d_model=768,
    n_heads=24,          # == SSD heads (d_model*expand/head_dim)
    n_kv_heads=24,
    head_dim=64,
    d_ff=0,
    vocab_size=50280,
    mlp="none",
    pattern=("ssm",),
    ssm=SSMConfig(d_state=128, head_dim=64, expand=2, conv_width=4,
                  chunk=256),
    tie_embeddings=True,
    optimizer="adamw",
    microbatches=2,
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, num_layers=2, d_model=64, n_heads=8, n_kv_heads=8,
        head_dim=16, vocab_size=503,
        ssm=SSMConfig(d_state=16, head_dim=16, expand=2, conv_width=4,
                      chunk=16))
