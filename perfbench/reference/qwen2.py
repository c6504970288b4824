"""Plain float32 Qwen2 decode step (arXiv:2407.10671; the published
Qwen2-0.5B: RMSNorm, GQA with Q/K/V biases, half-split (NeoX) rotary
embeddings, SwiGLU MLP, tied embeddings).

One decode step of tokens at position ``cur`` against a cache whose slots
0..cur-1 hold zero keys and values (the served INFER's cache) and whose
slot ``cur`` holds the token's own key and value: each query attends over
those cur + 1 slots.

Weights, as the benchmark draws them, in the served model's layout, each
layer's tensors stacked on a leading dim: ``embed.embedding`` (V_padded,
d); ``stack[0]`` with ``ln1.scale`` and ``ln2.scale`` (L, d), ``attn``
``w_q`` (L, d, H, D), ``w_k``/``w_v`` (L, d, K, D), ``w_o`` (L, H, D, d),
``b_q`` (L, H, D), ``b_k``/``b_v`` (L, K, D), ``mlp`` ``w_gate``/``w_in``
(L, d, F) and ``w_out`` (L, F, d); ``final_norm.scale`` (d,).

Departure from the published parameterisation, kept because the served
model has it: a norm's stored parameter is the offset from 1 (the weight
is 1 + scale). The logits cover the real vocabulary only (the table's
padding rows are not vocabulary).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from perfbench.reference.precision import activation, no_tf32, weight


def _rms(x, scale, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) \
        * (1.0 + scale.float())


def _rope(x, pos: int, theta: float):
    """x (B, heads, D) at one position: rotate the two halves."""
    half = x.shape[-1] // 2
    freq = theta ** (-torch.arange(half, dtype=torch.float64,
                                   device=x.device) / half)
    ang = (pos * freq).to(torch.float32)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _layer(p, i, x, cur, sizes, precision):
    eps, theta = sizes["rms_norm_eps"], sizes["rope_theta"]
    a, m = p["attn"], p["mlp"]
    B = x.shape[0]
    h = activation(_rms(x, p["ln1"]["scale"][i], eps), precision)
    q = torch.einsum("bd,dhx->bhx", h, weight(a["w_q"][i], precision)) \
        + a["b_q"][i].float()
    k = torch.einsum("bd,dkx->bkx", h, weight(a["w_k"][i], precision)) \
        + a["b_k"][i].float()
    v = torch.einsum("bd,dkx->bkx", h, weight(a["w_v"][i], precision)) \
        + a["b_v"][i].float()
    q, k = _rope(q, cur, theta), _rope(k, cur, theta)
    H, K, D = q.shape[1], k.shape[1], q.shape[2]
    keys = torch.zeros((B, cur + 1, K, D), device=x.device)
    vals = torch.zeros((B, cur + 1, K, D), device=x.device)
    keys[:, cur], vals[:, cur] = k, v
    kv_of = torch.arange(H, device=x.device) // (H // K)   # GQA
    scores = torch.einsum("bhd,bshd->bhs", q, keys[:, :, kv_of]) * D ** -0.5
    out = torch.einsum("bhs,bshd->bhd", scores.softmax(-1), vals[:, :, kv_of])
    x = x + torch.einsum("bhx,hxd->bd", activation(out, precision),
                         weight(a["w_o"][i], precision))
    h = activation(_rms(x, p["ln2"]["scale"][i], eps), precision)
    g = h @ weight(m["w_gate"][i], precision)
    u = h @ weight(m["w_in"][i], precision)
    y = activation(F.silu(g) * u, precision) @ weight(m["w_out"][i], precision)
    return x + y


@torch.no_grad()
def decode_logits(weights, sizes: dict, tokens, cur: int,
                  precision: str = "f32") -> torch.Tensor:
    """tokens (B,) -> logits (B, vocab_size) float32 of one decode step at
    position ``cur``."""
    with no_tf32():
        table = weight(weights["embed"]["embedding"], precision)
        x = table[tokens]
        for p in weights["stack"]:
            for i in range(p["attn"]["w_q"].shape[0]):
                x = _layer(p, i, x, cur, sizes, precision)
        x = activation(_rms(x, weights["final_norm"]["scale"],
                            sizes["rms_norm_eps"]), precision)
        return x @ table[:sizes["vocab_size"]].T
