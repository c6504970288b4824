"""Plain prefill and decode steps (port of the single-device builders in
``repro.distributed.steps``): the entry points of the prefill → decode
path. The train step and the mesh-sharded builder come with the training
and multi-device ports.

Each builder resolves its device once: CUDA by default, never swapped for
the CPU (``device="cuda"`` without a card raises). A step moves its inputs
there and runs under ``torch.no_grad()``; the caller's parameters and cache
must already live on that device.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.lm import greedy_sample
from repro_torch.models.registry import get_bundle
from repro_torch.utils import resolve_device


INPUTS = ("tokens", "frames", "image_embeds")


def make_prefill_step(cfg: ModelConfig, cache_len: Optional[int] = None,
                      device="cuda"):
    """prefill_step(params, {"tokens": (B, S)} with, for an encoder-decoder
    model, "frames" (B, Se, d) and, for a VLM, "image_embeds" (B, P, d)) ->
    (next tokens (B, 1) int32, decode-ready cache of ``cache_len`` slots,
    default the prefilled length: S, or P + S for a VLM)."""
    bundle = get_bundle(cfg)
    dev = resolve_device(device)

    def prefill_step(params, batch):
        inputs = {k: batch[k].to(dev) for k in INPUTS if k in batch}
        with torch.no_grad():
            logits, cache = bundle.prefill(params, inputs,
                                           cache_len=cache_len)
        return greedy_sample(logits), cache

    return prefill_step


def make_decode_step(cfg: ModelConfig, device="cuda"):
    """decode_step(params, cache, tokens (B, 1), cur_index) -> (next tokens
    (B, 1) int32, cache). The cache is updated in place and returned."""
    bundle = get_bundle(cfg)
    dev = resolve_device(device)

    def decode_step(params, cache, tokens, cur_index):
        with torch.no_grad():
            logits, cache = bundle.decode(params, cache, tokens.to(dev),
                                          cur_index)
        return greedy_sample(logits), cache

    return decode_step
