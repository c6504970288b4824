"""Model-layout wrappers over the kernels (port of ``repro.kernels.ops``).

They take the model's tensors (B, S, H/K, D) and hand the kernel views,
never transposed copies: the kernel reads the cache through its strides.
"""
from __future__ import annotations

from repro_torch.kernels import flash_decode as _fd


def flash_decode(q, k, v, kpos, cur_index, *, window: int = 0,
                 cap: float = 0.0):
    """q (B,1,H,D); k,v (B,S,K,D); kpos (S,) int32 -> (B,1,H,D)."""
    out = _fd.flash_decode(q[:, 0], k, v, kpos, cur_index, window=window,
                           cap=cap)
    return out[:, None]
