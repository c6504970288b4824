"""Plain float32 ResNet-50 inference (He et al., arXiv:1512.03385, Table 1;
torchvision's ``resnet50``, v1.5: the stride of a stage's first block on its
3×3 convolution and on the projection).

Weights, as the benchmark draws them: each convolution's kernel HWIO
(kh, kw, C_in, C_out); each batch norm in inference form, folded into a
per-channel ``scale`` and ``bias`` (C,); the head (C, classes). Keys:
``stem``, ``bn_stem``, ``stage0``..``stage3`` (tuples of blocks with
``conv1``..``conv3``, ``bn1``..``bn3`` and, in each stage's first block,
``proj`` and ``bn_proj``), ``head``.

Departures from torchvision, kept because the served model has them: the
padding is XLA's ``"SAME"`` (output ceil(n / stride); under stride 2 the odd
extra row and column go at the end), the 3×3 max pool pads with -inf, and
the head has no bias. Images are NHWC float32.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from perfbench.reference.precision import activation, no_tf32, weight


def same_pad(n: int, k: int, stride: int):
    """(before, after) padding of XLA's "SAME" along an axis of size n."""
    total = max((math.ceil(n / stride) - 1) * stride + k - n, 0)
    return total // 2, total - total // 2


def _conv(x, w_hwio, stride, precision):
    w = weight(w_hwio, precision).permute(3, 2, 0, 1).contiguous()  # OIHW
    k = w.shape[-1]
    (t, b), (l, r) = (same_pad(n, k, stride) for n in x.shape[-2:])
    x = F.pad(activation(x, precision), (l, r, t, b))
    return F.conv2d(x, w, stride=stride)


def _bn(p, x):
    return (x * p["scale"].float()[:, None, None]
            + p["bias"].float()[:, None, None])


def _max_pool(x):
    (t, b), (l, r) = (same_pad(n, 3, 2) for n in x.shape[-2:])
    return F.max_pool2d(F.pad(x, (l, r, t, b), value=-math.inf), 3, 2)


def _block(p, x, stride, precision):
    y = F.relu(_bn(p["bn1"], _conv(x, p["conv1"], 1, precision)))
    y = F.relu(_bn(p["bn2"], _conv(y, p["conv2"], stride, precision)))
    y = _bn(p["bn3"], _conv(y, p["conv3"], 1, precision))
    r = _bn(p["bn_proj"], _conv(x, p["proj"], stride, precision)) \
        if "proj" in p else x
    return F.relu(y + r)


@torch.no_grad()
def forward(weights, images, precision: str = "f32") -> torch.Tensor:
    """images (B, H, W, 3) float32 -> logits (B, classes) float32."""
    with no_tf32():
        x = images.float().permute(0, 3, 1, 2).contiguous()
        x = F.relu(_bn(weights["bn_stem"],
                       _conv(x, weights["stem"], 2, precision)))
        x = _max_pool(x)
        si = 0
        while f"stage{si}" in weights:
            for bi, p in enumerate(weights[f"stage{si}"]):
                x = _block(p, x, 2 if (bi == 0 and si > 0) else 1, precision)
            si += 1
        x = x.mean(dim=(2, 3))
        return activation(x, precision) @ weight(weights["head"], precision)
