"""llama4-maverick-400b-a17b [moe]: 128 experts top-1 + shared expert.

48L d_model=5120 40H (GQA kv=8) d_ff=8192 (per-expert) vocab=202048
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]. 40 heads ∤ 16 ->
context-parallel attention; experts over the data axis. Early-fusion
multimodality is out of scope for the backbone cells (text path only).
"""
import dataclasses

from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    num_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=202048,
    mlp="swiglu",
    rope_theta=5e5,
    moe=MoEConfig(num_experts=128, top_k=1, d_ff_expert=8192,
                  shared_expert=True),
    optimizer="adafactor",
    microbatches=16,
    seq_shard_train=True,
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, num_layers=2, d_model=64, n_heads=5, n_kv_heads=1,
        head_dim=16, d_ff=32,
        moe=MoEConfig(num_experts=4, top_k=1, d_ff_expert=32,
                      shared_expert=True),
        vocab_size=503)
