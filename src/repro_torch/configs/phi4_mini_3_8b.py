"""phi4-mini-3.8b [dense]: RoPE + SwiGLU + GQA, 200k vocab.

32L d_model=3072 24H (GQA kv=8) d_ff=8192 vocab=200064 [arXiv:2412.08905;
hf]. 24 heads ∤ 16 -> context-parallel attention.
"""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="phi4-mini-3.8b",
    family="dense",
    num_layers=32,
    d_model=3072,
    n_heads=24,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=200064,
    mlp="swiglu",
    tie_embeddings=True,
    optimizer="adafactor",
    microbatches=4,
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, num_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        head_dim=16, d_ff=128, vocab_size=503)
