"""Compact ResNet-50 (inference), port of ``repro.models.resnet`` — the
paper's own evaluation model family (Fig 5/6: 15–3,600 ResNet50 copies on
one worker). Inference-mode batchnorm (folded scale/bias).

The spec keeps the reference's HWIO conv shapes, so ``materialize`` draws
the reference's distribution (fan-in ``shape[-2]`` = C_in) and
``param_bytes`` equals the reference's. ``port_layout`` converts such a
tree once, outside any timed call, to what cuDNN runs fastest: OIHW conv
weights in ``torch.channels_last`` memory format and BN vectors as
(C, 1, 1). ``resnet50_forward`` takes that layout and NCHW activations in
``channels_last``; it holds no permute or copy of a weight.

XLA's ``"SAME"`` padding is asymmetric under stride 2 (the odd extra row
and column go at the end) and its max-pool pads with -inf; ``_same_pad``
reproduces both, where ``padding="same"`` or ``k // 2`` would shift the
output window by one pixel. Stride sits on the 3×3 conv (ResNet-50 v1.5).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.params import ParamSpec, from_numpy_tree

STAGES = (3, 4, 6, 3)
WIDTHS = (64, 128, 256, 512)


def _conv_spec(cin, cout, k):
    return ParamSpec((k, k, cin, cout), (None, None, None, None))


def _bn_spec(c):
    return {"scale": ParamSpec((c,), (None,), init="ones"),
            "bias": ParamSpec((c,), (None,), init="zeros")}


def _bottleneck_spec(cin, width, stride):
    cout = width * 4
    s = {
        "conv1": _conv_spec(cin, width, 1), "bn1": _bn_spec(width),
        "conv2": _conv_spec(width, width, 3), "bn2": _bn_spec(width),
        "conv3": _conv_spec(width, cout, 1), "bn3": _bn_spec(cout),
    }
    if stride != 1 or cin != cout:
        s["proj"] = _conv_spec(cin, cout, 1)
        s["bn_proj"] = _bn_spec(cout)
    return s


def resnet50_spec(num_classes: int = 1000, scale: int = 1):
    """scale>1 shrinks widths (for fast smoke/serving tests)."""
    widths = tuple(max(8, w // scale) for w in WIDTHS)
    spec = {"stem": _conv_spec(3, widths[0], 7), "bn_stem": _bn_spec(widths[0])}
    cin = widths[0]
    for si, (n, w) in enumerate(zip(STAGES, widths)):
        blocks = []
        for bi in range(n):
            stride = 2 if (bi == 0 and si > 0) else 1
            blocks.append(_bottleneck_spec(cin, w, stride))
            cin = w * 4
        spec[f"stage{si}"] = tuple(blocks)
    spec["head"] = ParamSpec((cin, num_classes), (None, None))
    return spec


def port_layout(params):
    """A tree in the reference's layout (HWIO convs, (C,) BN vectors) as the
    forward's: OIHW conv weights in channels_last, BN vectors as (C, 1, 1).
    Values are copied bit for bit."""
    if isinstance(params, dict):
        return {k: port_layout(v) for k, v in params.items()}
    if isinstance(params, tuple):
        return tuple(port_layout(v) for v in params)
    if params.dim() == 4:                                  # HWIO -> OIHW
        return params.permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
    if params.dim() == 1:
        return params[:, None, None].contiguous()
    return params                                          # the head (C, K)


def from_reference(tree, device):
    """The reference's ResNet parameter tree, as numpy arrays (e.g.
    ``jax.tree.map(np.asarray, params)``), in the port's layout on
    ``device``, bit for bit."""
    return port_layout(from_numpy_tree(tree, device))


def _same_pad(n: int, k: int, stride: int):
    """(lo, hi) padding of XLA's "SAME" along one axis of size ``n``."""
    total = max((math.ceil(n / stride) - 1) * stride + k - n, 0)
    return total // 2, total - total // 2


def _conv(x, w, stride=1):
    """``conv_general_dilated(x, w, stride, "SAME")`` on NCHW/OIHW. A
    symmetric pad goes to cuDNN's own padding; an asymmetric one (stride 2)
    is an explicit ``F.pad`` before an unpadded conv."""
    k = w.shape[-1]
    (ht, hb), (wl, wr) = (_same_pad(n, k, stride) for n in x.shape[-2:])
    if ht == hb and wl == wr:
        return F.conv2d(x, w, stride=stride, padding=(ht, wl))
    return F.conv2d(F.pad(x, (wl, wr, ht, hb)), w, stride=stride)


def _max_pool(x):
    """``reduce_window(x, -inf, max, 3x3, stride 2, "SAME")``."""
    (ht, hb), (wl, wr) = (_same_pad(n, 3, 2) for n in x.shape[-2:])
    x = F.pad(x, (wl, wr, ht, hb), value=-math.inf)
    return F.max_pool2d(x, 3, 2)


def _bn(p, x):
    return x * p["scale"] + p["bias"]


def _bottleneck(p, x, stride):
    r = x
    y = F.relu(_bn(p["bn1"], _conv(x, p["conv1"])))
    y = F.relu(_bn(p["bn2"], _conv(y, p["conv2"], stride)))
    y = _bn(p["bn3"], _conv(y, p["conv3"]))
    if "proj" in p:
        r = _bn(p["bn_proj"], _conv(x, p["proj"], stride))
    return F.relu(y + r)


def resnet50_forward(params, x):
    """x (B, 3, H, W), channels_last, params in ``port_layout`` -> logits
    (B, num_classes)."""
    x = x.to(params["stem"].dtype)
    y = F.relu(_bn(params["bn_stem"], _conv(x, params["stem"], 2)))
    y = _max_pool(y)
    for si in range(len(STAGES)):
        for bi, bp in enumerate(params[f"stage{si}"]):
            stride = 2 if (bi == 0 and si > 0) else 1
            y = _bottleneck(bp, y, stride)
    y = y.mean(dim=(2, 3))
    return y @ params["head"]
