"""GQA attention, decode half (port of ``repro.models.attention``).

One token against a KV cache. The score/softmax/PV block runs through
``kernels.ops.flash_decode``: the hand-written CUDA kernel on the card, its
plain PyTorch version on the CPU. Prefill (``attend_full`` through
``flash_attention_bhsd``) and cross-attention are not ported yet (ROADMAP
queue 1, item 5).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import rope
from repro_torch.models.params import ParamSpec


def attn_spec(cfg: ModelConfig):
    d, h, k, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    s = {
        "w_q": ParamSpec((d, h, hd), ("d_model_tp", "heads", "head_dim")),
        "w_k": ParamSpec((d, k, hd), ("d_model_tp", "kv_heads", "head_dim")),
        "w_v": ParamSpec((d, k, hd), ("d_model_tp", "kv_heads", "head_dim")),
        "w_o": ParamSpec((h, hd, d), ("heads_o", "head_dim", "d_model_out")),
    }
    if cfg.qkv_bias:
        s["b_q"] = ParamSpec((h, hd), ("heads", "head_dim"), init="zeros")
        s["b_k"] = ParamSpec((k, hd), ("kv_heads", "head_dim"), init="zeros")
        s["b_v"] = ParamSpec((k, hd), ("kv_heads", "head_dim"), init="zeros")
    return s


def _ring_window(cfg: ModelConfig, kind: str) -> int:
    return cfg.window if (kind == "local" and cfg.sliding_kv and cfg.window) else 0


def make_cache(cfg: ModelConfig, kind: str, batch: int, max_len: int,
               dtype=torch.bfloat16, device="cuda"):
    """Zero cache for one attention layer (window-sized ring for local
    layers)."""
    W = _ring_window(cfg, kind)
    S = min(max_len, W) if W else max_len
    shape = (batch, S, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def cache_axes():
    return ("batch", "seq_kv", "kv_heads", "head_dim")


def attend_decode(p, cfg: ModelConfig, x, cache, cur_index: int, *,
                  kind: str, cross: bool = False):
    """One-token decode. x (B,1,d). Returns (y, cache).

    Unlike the reference, which returns a new cache, the new token's K/V are
    written into ``cache`` in place and the same dict is returned."""
    if cross:
        raise NotImplementedError(
            "cross-attention decode: ROADMAP queue 1, item 12")
    B = x.shape[0]
    cur = int(cur_index)
    pos = torch.full((B, 1), cur, dtype=torch.int32, device=x.device)
    q = torch.einsum("bsd,dhx->bshx", x, p["w_q"])
    k_new = torch.einsum("bsd,dkx->bskx", x, p["w_k"])
    v_new = torch.einsum("bsd,dkx->bskx", x, p["w_v"])
    if "b_q" in p:
        q, k_new, v_new = q + p["b_q"], k_new + p["b_k"], v_new + p["b_v"]
    q = rope(q, pos, cfg.rope_theta)

    k_all, v_all = cache["k"], cache["v"]
    S = k_all.shape[1]
    W = _ring_window(cfg, kind)
    ring = bool(W) and S == W
    slot = cur % S if ring else cur
    # jax.lax.dynamic_update_slice clamps an out-of-range start to S-1
    slot = min(max(slot, 0), S - 1)
    k_all[:, slot] = rope(k_new, pos, cfg.rope_theta)[:, 0].to(k_all.dtype)
    v_all[:, slot] = v_new[:, 0].to(v_all.dtype)
    kpos = torch.arange(S, dtype=torch.int32, device=x.device)
    if ring:                          # ring buffer: absolute pos per slot
        kpos = cur - torch.remainder(cur - kpos, S)

    out = ops.flash_decode(q, k_all, v_all, kpos, cur, window=W,
                           cap=cfg.attn_softcap)
    y = torch.einsum("bshx,hxd->bsd", out, p["w_o"])
    return y, cache
