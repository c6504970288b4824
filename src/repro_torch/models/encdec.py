"""Encoder-decoder wrapper, seamless-m4t (port of ``repro.models.encdec``):
a bidirectional encoder over stub audio-frame embeddings, then a causal
decoder with cross-attention to the encoder's output."""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ModelConfig
from repro_torch.models import lm


def encoder_config(cfg: ModelConfig) -> ModelConfig:
    return dataclasses.replace(cfg, num_layers=cfg.enc_layers,
                               is_encdec=False, moe=None)


def encdec_spec(cfg: ModelConfig):
    enc = lm.model_spec(encoder_config(cfg))
    enc.pop("embed")
    dec = lm.model_spec(cfg, cross=True)
    return {"encoder": enc, "decoder": dec}


def _encode(params, cfg: ModelConfig, frames):
    """(encoder output, its positions (B, Se))."""
    enc_out = lm.encode(params["encoder"], encoder_config(cfg), frames)
    B, Se = enc_out.shape[:2]
    return enc_out, lm.seq_positions(B, Se, enc_out.device)


def train_logits(params, cfg: ModelConfig, frames, dec_tokens):
    enc_out, enc_pos = _encode(params, cfg, frames)
    logits, _ = lm.forward(params["decoder"], cfg, mode="train",
                           tokens=dec_tokens, enc_out=enc_out,
                           enc_positions=enc_pos)
    return logits


def prefill(params, cfg: ModelConfig, frames, dec_tokens, cache_len=None):
    enc_out, enc_pos = _encode(params, cfg, frames)
    return lm.forward(params["decoder"], cfg, mode="prefill",
                      tokens=dec_tokens, enc_out=enc_out,
                      enc_positions=enc_pos, cache_len=cache_len)


def decode(params, cfg: ModelConfig, cache, tokens, cur_index):
    return lm.forward(params["decoder"], cfg, mode="decode", tokens=tokens,
                      cache=cache, cur_index=cur_index)
