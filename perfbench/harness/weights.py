"""Seeded weights and inputs, drawn by the benchmark on the device.

One generator per (seed, stream) and one large draw per tree: a flat
buffer of standard normals, cut at ±2 (a truncated normal, as the port's
``materialize`` draws), which each leaf takes a slice of and scales. The
same (seed, stream) gives the same tensors on the same device, so the
reference can draw again what the program was given.
"""
from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import numpy as np
import torch


def mix(seed: int, *stream: int) -> int:
    """A 63-bit generator seed from ``--seed`` (any whole number) and a
    stream index."""
    state = np.random.SeedSequence([seed % 2 ** 64, *stream])
    return int(state.generate_state(1, np.uint64)[0] >> np.uint64(1))


def generator(seed: int, device, *stream: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(mix(seed, *stream))


def draw(shapes: Sequence[Tuple[tuple, float, float]], seed: int, device,
         dtype, *stream: int) -> List[torch.Tensor]:
    """One tensor per (shape, std, mean): mean + std · N(0, 1) cut at ±2,
    in ``dtype``, from one draw of the stream's generator."""
    sizes = [math.prod(s) for s, _, _ in shapes]
    flat = torch.randn(sum(sizes), generator=generator(seed, device, *stream),
                       device=device)
    flat.clamp_(-2.0, 2.0)
    out, off = [], 0
    for (shape, std, mean), n in zip(shapes, sizes):
        out.append((flat[off:off + n].view(shape) * std + mean).to(dtype))
        off += n
    return out
