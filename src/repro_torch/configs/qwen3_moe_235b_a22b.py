"""qwen3-moe-235b-a22b [moe]: 128 experts, top-8.

94L d_model=4096 64H (GQA kv=4) d_ff=1536 (per-expert) vocab=151936
[hf:Qwen/Qwen3-30B-A3B; hf]. Expert parallelism over the data axis
(128e / 16 = 8 per shard), expert d_ff TP over the model axis. 64 q-heads
shard over the 16-way model axis; kv=4 replicated for prefill/train, decode
uses context-sharded KV.
"""
import dataclasses

from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    num_layers=94,
    d_model=4096,
    n_heads=64,
    n_kv_heads=4,
    head_dim=128,
    d_ff=1536,
    vocab_size=151936,
    mlp="swiglu",
    rope_theta=1e6,
    moe=MoEConfig(num_experts=128, top_k=8, d_ff_expert=1536),
    optimizer="adafactor",
    microbatches=16,
    seq_shard_train=True,
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, num_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        head_dim=16, d_ff=32,
        moe=MoEConfig(num_experts=4, top_k=2, d_ff_expert=32),
        vocab_size=503)
