"""Input specs per (architecture x shape) (port of
``repro.configs.shapes``): stand-ins that carry a shape and a dtype and
allocate nothing, tensors on the ``meta`` device, which the dry run and
``build_sharded_step`` take as their abstract arguments.
``batch_logical_axes`` mirrors each batch with its logical sharding axes.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig, ShapeSpec

# decode-time self-cache length for encoder-decoder models (the encoder/cross
# context carries the shape's seq_len; generated translations are short).
ENCDEC_DEC_LEN = 4096
# decoder prime length for enc-dec prefill
ENCDEC_PRIME = 1024


def sds(shape, dtype):
    """A tensor of ``shape`` and ``dtype`` on the meta device (the
    reference's ``jax.ShapeDtypeStruct``)."""
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def train_inputs(cfg: ModelConfig, shape: ShapeSpec):
    B, S = shape.global_batch, shape.seq_len
    if cfg.is_encdec:
        return {
            "frames": sds((B, S, cfg.d_model), torch.bfloat16),
            "tokens": sds((B, S), torch.int32),
            "targets": sds((B, S), torch.int32),
        }
    if cfg.modality == "image_patches":
        st = S - cfg.img_tokens
        return {
            "tokens": sds((B, st), torch.int32),
            "image_embeds": sds((B, cfg.img_tokens, cfg.d_model),
                                torch.bfloat16),
            "targets": sds((B, st), torch.int32),
        }
    return {
        "tokens": sds((B, S), torch.int32),
        "targets": sds((B, S), torch.int32),
    }


def prefill_inputs(cfg: ModelConfig, shape: ShapeSpec):
    B, S = shape.global_batch, shape.seq_len
    if cfg.is_encdec:
        return {
            "frames": sds((B, S, cfg.d_model), torch.bfloat16),
            "tokens": sds((B, min(ENCDEC_PRIME, S)), torch.int32),
        }
    if cfg.modality == "image_patches":
        return {
            "tokens": sds((B, S - cfg.img_tokens), torch.int32),
            "image_embeds": sds((B, cfg.img_tokens, cfg.d_model),
                                torch.bfloat16),
        }
    return {"tokens": sds((B, S), torch.int32)}


def decode_inputs(cfg: ModelConfig, shape: ShapeSpec):
    B = shape.global_batch
    return {
        "tokens": sds((B, 1), torch.int32),
        "cur_index": sds((), torch.int32),
    }


def batch_logical_axes(batch):
    """Logical axes for a train/prefill/decode batch dict."""
    axes = {}
    for k, v in batch.items():
        if k == "cur_index":
            axes[k] = ()
        elif len(v.shape) == 3:
            axes[k] = ("batch", "seq", "d_model")
        else:
            axes[k] = ("batch", "seq")
    return axes


def decode_cache_len(cfg: ModelConfig, shape: ShapeSpec):
    """(self_len, cross_len) for decode-shape caches."""
    if cfg.is_encdec:
        return min(ENCDEC_DEC_LEN, shape.seq_len), shape.seq_len
    return shape.seq_len, 0


def inputs_for(cfg: ModelConfig, shape: ShapeSpec):
    return {
        "train": train_inputs,
        "prefill": prefill_inputs,
        "decode": decode_inputs,
    }[shape.kind](cfg, shape)
