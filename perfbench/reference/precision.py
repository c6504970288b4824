"""Rounding of the references' weights and matrix inputs.

``"f32"`` leaves every tensor as it is. ``"fp8"`` is the lower-precision
control: each weight tensor is rounded to float8 e4m3 with one scale per
tensor (its largest magnitude at 448, e4m3's largest finite), and each
convolution or matrix product's input with one scale per row (per image or
token), as an fp8 serving path would compute. The products themselves run
in float32.
"""
from __future__ import annotations

import torch

PRECISIONS = ("f32", "fp8")
E4M3_MAX = 448.0


def _fp8(t: torch.Tensor, dims) -> torch.Tensor:
    amax = t.abs().amax(dim=dims, keepdim=True) if dims else t.abs().amax()
    scale = torch.clamp(amax, min=1e-12) / E4M3_MAX
    return (t / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def weight(t: torch.Tensor, precision: str) -> torch.Tensor:
    """A weight in float32, rounded as ``precision`` says."""
    t = t.to(torch.float32)
    if precision == "f32":
        return t
    if precision == "fp8":
        return _fp8(t, None)
    raise ValueError(f"unknown precision {precision!r}; {PRECISIONS}")


def activation(t: torch.Tensor, precision: str) -> torch.Tensor:
    """A product's input (rows on dim 0), rounded as ``precision`` says."""
    if precision == "f32":
        return t
    if precision == "fp8":
        return _fp8(t, tuple(range(1, t.dim())))
    raise ValueError(f"unknown precision {precision!r}; {PRECISIONS}")


class no_tf32:
    """Float32 products in float32: TF32 off for cuBLAS and cuDNN inside
    the block, restored after."""

    def __enter__(self):
        self._saved = (torch.backends.cuda.matmul.allow_tf32,
                       torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        return self

    def __exit__(self, *exc):
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = self._saved
        return False
