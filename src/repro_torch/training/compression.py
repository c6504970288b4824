"""Gradient compression with error feedback (port of
``repro.training.compression``).

int8 block-quantization: a gradient is quantized to int8 with a per-block
f32 scale (blocks of ``BLOCK`` values of the flattened tensor) and the
quantization error is carried to the next step (error feedback keeps the
method unbiased in the long run — Seide et al. / EF-SGD). The arithmetic is
the reference's step for step in f32, so the int8 values and the scales
equal its bit for bit.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.utils import (tree_leaves, tree_leaves_like, tree_map,
                               tree_unflatten)

BLOCK = 256


def _pad_len(n: int) -> int:
    return (BLOCK - n % BLOCK) % BLOCK


def quantize_int8(x):
    """x (any shape) -> (q int8 (blocks, BLOCK), scales f32 (blocks, 1),
    meta) with per-block scaling."""
    flat = x.reshape(-1).float()
    pad = _pad_len(flat.shape[0])
    blocks = F.pad(flat, (0, pad)).reshape(-1, BLOCK)
    scale = torch.clamp(blocks.abs().amax(dim=1, keepdim=True) / 127.0,
                        min=1e-12)
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return q, scale, (tuple(x.shape), pad)


def dequantize_int8(q, scale, meta):
    shape, pad = meta
    flat = (q.float() * scale).reshape(-1)
    if pad:
        flat = flat[:-pad]
    return flat.reshape(shape)


def compress_with_error_feedback(grads, error_state):
    """Returns (compressed-dequantized grads, new error state), both of the
    grads' tree structure; ``error_state`` None starts from f32 zeros."""
    if error_state is None:
        error_state = tree_map(lambda g: torch.zeros(g.shape, device=g.device),
                               grads)

    def one(g, e):
        corrected = g.float() + e
        deq = dequantize_int8(*quantize_int8(corrected))
        return deq.to(g.dtype), corrected - deq

    pairs = [one(g, e) for g, e in zip(tree_leaves(grads),
                                       tree_leaves_like(error_state, grads))]
    return (tree_unflatten(grads, [p[0] for p in pairs]),
            tree_unflatten(grads, [p[1] for p in pairs]))
