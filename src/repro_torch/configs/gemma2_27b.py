"""gemma2-27b [dense]: local+global alternating attention, logit softcaps.

46L d_model=4608 32H (GQA kv=16) d_ff=36864 vocab=256000 [arXiv:2408.00118;
hf]. Pattern = (local-4096, global) x 23; attn softcap 50, final softcap 30,
gemma-style embed scaling + post-norms; tied embeddings. Runs long_500k:
local layers keep a 4096 ring KV, global layers shard the 524288 KV over
(seq x heads).
"""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-27b",
    family="dense",
    num_layers=46,
    d_model=4608,
    n_heads=32,
    n_kv_heads=16,
    head_dim=128,
    d_ff=36864,
    vocab_size=256000,
    pattern=("local", "attn"),
    window=4096,
    mlp="swiglu",
    attn_softcap=50.0,
    final_softcap=30.0,
    scale_embed=True,
    post_norms=True,
    tie_embeddings=True,
    optimizer="adafactor",
    microbatches=8,
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, num_layers=4, d_model=64, n_heads=4, n_kv_heads=2,
        head_dim=16, d_ff=128, vocab_size=503, window=16)
