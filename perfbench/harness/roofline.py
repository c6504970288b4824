"""The yardstick's peaks and the work each served request needs.

Frozen copies: the peaks and the bound of ``chip_smoke.py:_bound`` (the
larger of bytes at the HBM bandwidth and operations at the dense bf16
tensor-core peak), ResNet-50's FLOPs of ``chip_smoke.py:_resnet_flops``
(here from the configuration's sizes, with its 1,000-class head), and the
flash_decode byte count of ``chip_smoke.py:_time_decode`` (each input read
once, the output written once, K/V over the live slots only).
"""
from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense bf16 on the tensor cores, HBM3; at the
# card's 700 W limit.
PEAK_BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12


def bound_s(bytes_moved: float, flops: float) -> float:
    """The least time the card could take for this work."""
    return max(bytes_moved / HBM_BYTES_PER_S, flops / PEAK_BF16_FLOPS)


def _same(n: int, stride: int) -> int:
    """Output size of XLA's "SAME" padding: ceil(n / stride)."""
    return -(-n // stride)


def resnet50_flops(sizes: dict) -> int:
    """FLOPs of one image through ResNet-50 v1.5 (stride on the 3×3 conv):
    2 per multiply-add of every conv at its output size and of the head.
    Elementwise work (BN, ReLU, the pools) is not counted."""
    img, cin = sizes["image_size"], sizes["channels"]
    stem_w, k = sizes["widths"][0], sizes["stem_kernel"]

    def conv(ci, co, kk, n):
        return 2 * ci * co * kk * kk * n * n

    n = _same(img, 2)
    flops = conv(cin, stem_w, k, n)
    n = _same(n, 2)                                   # the max-pool
    c = stem_w
    for si, (blocks, w) in enumerate(zip(sizes["stages"], sizes["widths"])):
        cout = w * sizes["expansion"]
        for bi in range(blocks):
            m = _same(n, 2 if (bi == 0 and si > 0) else 1)
            flops += conv(c, w, 1, n) + conv(w, w, 3, m) + conv(w, cout, 1, m)
            if bi == 0:
                flops += conv(c, cout, 1, m)           # the projection
            c, n = cout, m
    return flops + 2 * c * sizes["num_classes"]


def decode_attention_live(cur: int) -> int:
    """Cache slots a decode step at position ``cur`` attends to: 0..cur."""
    return cur + 1


def qwen2_decode_flops(sizes: dict, cur: int) -> int:
    """FLOPs of one token's decode step at position ``cur`` (2 per
    multiply-add): per layer the Q/K/V and output projections, the SwiGLU
    MLP, and attention over the live slots (QKᵀ and PV); then the tied
    unembedding over the real vocabulary (not its padding)."""
    d, ff = sizes["hidden_size"], sizes["intermediate_size"]
    h, kv = sizes["num_attention_heads"], sizes["num_key_value_heads"]
    hd = d // h
    live = decode_attention_live(cur)
    layer = (2 * d * (h + 2 * kv) * hd        # Q, K, V
             + 2 * h * hd * d                 # output projection
             + 3 * 2 * d * ff                 # gate, in, out
             + 4 * h * live * hd)             # QKᵀ and PV
    return sizes["num_hidden_layers"] * layer + 2 * d * sizes["vocab_size"]


def flash_decode_work(batch: int, heads: int, kv_heads: int, head_dim: int,
                      slots: int, live: int, itemsize: int = 2):
    """(bytes, FLOPs) one flash_decode call needs: q read and out written
    once, the K and V rows of the live slots read once, the slot positions
    (int32) read once; 4·D FLOPs per live (query head, slot) pair."""
    bytes_moved = (2 * batch * heads * head_dim * itemsize
                   + 2 * batch * live * kv_heads * head_dim * itemsize
                   + slots * 4)
    return bytes_moved, 4 * batch * heads * live * head_dim
