"""recurrentgemma-2b [hybrid]: RG-LRU + local attention, 1:2 ratio.

26L d_model=2560 10H (GQA kv=1) d_ff=7680 vocab=256000 [arXiv:2402.19427;
hf]. Pattern (rec, rec, local) x 8 + (rec, rec) leftover = 26 blocks.
Fixed-size LRU state + 2048-window KV -> O(1) decode; runs long_500k.
"""
import dataclasses

from repro_torch.configs.base import ModelConfig, RGLRUConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    num_layers=26,
    d_model=2560,
    n_heads=10,
    n_kv_heads=1,
    head_dim=256,
    d_ff=7680,
    vocab_size=256000,
    pattern=("rec", "rec", "local"),
    window=2048,
    mlp="swiglu",
    scale_embed=True,
    rglru=RGLRUConfig(d_rnn=2560, conv_width=4),
    tie_embeddings=True,
    optimizer="adamw",
    microbatches=4,
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, num_layers=5, d_model=64, n_heads=2, n_kv_heads=1,
        head_dim=32, d_ff=128, vocab_size=503, window=16,
        rglru=RGLRUConfig(d_rnn=64, conv_width=4))
