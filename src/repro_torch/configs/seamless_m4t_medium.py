"""seamless-m4t-medium [audio]: enc-dec multimodal backbone.

12L d_model=1024 16H (GQA kv=16) d_ff=4096 vocab=256206
[arXiv:2308.11596; hf]. Interpreted as 12 encoder + 12 decoder layers; the
speech frontend is a stub (input_specs provides precomputed frame embeddings
at d_model). Sinusoidal/relative positions simplified to RoPE (DESIGN.md).
"""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium",
    family="audio",
    num_layers=12,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    vocab_size=256206,
    mlp="gelu",
    is_encdec=True,
    enc_layers=12,
    modality="audio_frames",
    optimizer="adamw",
    microbatches=4,
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, num_layers=2, enc_layers=2, d_model=64, n_heads=4,
        n_kv_heads=4, head_dim=16, d_ff=128, vocab_size=503)
