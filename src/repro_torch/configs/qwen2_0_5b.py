"""qwen2-0.5b [dense]: GQA with QKV bias, tied embeddings.

24L d_model=896 14H (GQA kv=2) d_ff=4864 vocab=151936 [arXiv:2407.10671;
hf]. 14 heads ∤ 16 -> context-parallel attention.
"""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-0.5b",
    family="dense",
    num_layers=24,
    d_model=896,
    n_heads=14,
    n_kv_heads=2,
    head_dim=64,
    d_ff=4864,
    vocab_size=151936,
    mlp="swiglu",
    qkv_bias=True,
    rope_theta=1e6,
    tie_embeddings=True,
    optimizer="adamw",
    microbatches=2,
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, num_layers=2, d_model=64, n_heads=7, n_kv_heads=1,
        head_dim=16, d_ff=128, vocab_size=503)
