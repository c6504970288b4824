"""starcoder2-3b [dense]: GQA + RoPE, standard GeLU MLP with biases.

30L d_model=3072 24H (GQA kv=2) d_ff=12288 vocab=49152 [arXiv:2402.19173;
hf]. 24 heads do not divide the 16-way model axis -> context-parallel
attention (DESIGN.md §4).
"""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-3b",
    family="dense",
    num_layers=30,
    d_model=3072,
    n_heads=24,
    n_kv_heads=2,
    head_dim=128,
    d_ff=12288,
    vocab_size=49152,
    mlp="gelu",
    qkv_bias=True,
    rope_theta=1e5,
    optimizer="adafactor",
    microbatches=4,
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, num_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        head_dim=16, d_ff=128, vocab_size=503)
