"""llava-next-mistral-7b [vlm]: Mistral-7B backbone + anyres patch stub.

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=32000
[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]. The vision tower +
projector is a stub: input_specs provides 2880 precomputed patch embeddings
(anyres 4 tiles + base image, 576 tokens each) at d_model.
"""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-mistral-7b",
    family="vlm",
    num_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=32000,
    mlp="swiglu",
    rope_theta=1e6,
    modality="image_patches",
    img_tokens=2880,
    optimizer="adafactor",
    microbatches=8,
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, num_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        head_dim=16, d_ff=128, vocab_size=503, img_tokens=8)
