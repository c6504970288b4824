"""Model-layout wrappers over the kernels (port of ``repro.kernels.ops``).

They take the model's tensors (B, S, H/K, D) and hand the kernels views,
never transposed or GQA-repeated copies: the kernels read them through
their strides.
"""
from __future__ import annotations

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import flash_decode as _fd
from repro_torch.kernels import ssd_scan as _ssd


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    cap: float = 0.0):
    """q (B,Sq,H,D); k,v (B,Skv,K,D) with H = K*G -> (B,Sq,H,D). Under
    grad, with an input that requires it, this is the FlashAttention
    autograd.Function (the kernels' backward on the card)."""
    return _fa.flash_attention(q, k, v, causal=causal, window=window,
                               cap=cap)


def flash_decode(q, k, v, kpos, cur_index, *, window: int = 0,
                 cap: float = 0.0):
    """q (B,1,H,D); k,v (B,S,K,D); kpos (S,) int32 -> (B,1,H,D)."""
    out = _fd.flash_decode(q[:, 0], k, v, kpos, cur_index, window=window,
                           cap=cap)
    return out[:, None]


def ssd(x, dt, a, bmat, cmat, *, chunk: int = 128):
    """Model layout: x (B,L,H,P); dt (B,L,H); a (H,); b/c (B,L,N).

    Returns (y (B,L,H,P), state (B,H,P,N)). Under grad, with an input that
    requires it, this is the SSDScan autograd.Function: differentiable on
    the card, its backward the hand-written kernel ``ssd_scan_bwd``."""
    return _ssd.ssd_scan(x, dt, a, bmat, cmat, chunk=chunk)
