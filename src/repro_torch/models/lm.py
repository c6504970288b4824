"""Decoder-only language model, dense family, decode mode (port of
``repro.models.lm``).

The parameter and cache trees are the reference's: the repeating
``cfg.pattern`` is stacked along a leading ``layers`` dim under ``"stack"``
and the leftover layers sit unstacked under ``"leftover"``. The reference
drives the stack with ``lax.scan`` and carries the cache through it; here a
Python loop walks the leading dim and each layer writes its cache slice in
place.

Only ``mode="decode"`` of the dense family is ported. Prefill and train
(ROADMAP queue 1, item 5), Mamba2 (item 9), RG-LRU (item 10), MoE (item 11)
and encoder-decoder / VLM input (item 12) raise NotImplementedError.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import params as pspec
from repro_torch.models.attention import attend_decode, attn_spec, make_cache
from repro_torch.models.layers import (embed, embed_spec, mlp, mlp_spec,
                                       rmsnorm, rmsnorm_spec, unembed)
from repro_torch.utils import tree_map

ATTN_KINDS = ("attn", "local")
_NOT_PORTED = {
    "ssm": "Mamba2 blocks: ROADMAP queue 1, item 9",
    "rec": "RG-LRU blocks: ROADMAP queue 1, item 10",
}


def _check_dense(cfg: ModelConfig, kind: str):
    if kind in _NOT_PORTED:
        raise NotImplementedError(_NOT_PORTED[kind])
    if kind not in ATTN_KINDS:
        raise ValueError(kind)
    if cfg.moe is not None:
        raise NotImplementedError("MoE blocks: ROADMAP queue 1, item 11")


# ------------------------------------------------------------------ specs

def block_spec(cfg: ModelConfig, kind: str):
    _check_dense(cfg, kind)
    d = cfg.d_model
    s = {"ln1": rmsnorm_spec(d), "attn": attn_spec(cfg)}
    if cfg.post_norms:
        s["ln1_post"] = rmsnorm_spec(d)
    if cfg.mlp != "none":
        s["ln2"] = rmsnorm_spec(d)
        s["mlp"] = mlp_spec(cfg)
        if cfg.post_norms:
            s["ln2_post"] = rmsnorm_spec(d)
    return s


def model_spec(cfg: ModelConfig):
    pattern, n_groups, leftover = cfg.pattern_split()
    return {
        "embed": embed_spec(cfg),
        "stack": tuple(
            pspec.stack_specs(block_spec(cfg, kind), n_groups, "layers")
            for kind in pattern),
        "leftover": tuple(block_spec(cfg, kind) for kind in leftover),
        "final_norm": rmsnorm_spec(cfg.d_model),
    }


# ------------------------------------------------------------------ caches

def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device="cuda"):
    pattern, n_groups, leftover = cfg.pattern_split()
    for kind in pattern + leftover:
        _check_dense(cfg, kind)
    stack = tuple(
        {"kv": tree_map(lambda a: a.new_zeros((n_groups,) + tuple(a.shape)),
                        make_cache(cfg, kind, batch, max_len, dtype, device))}
        for kind in pattern)
    left = tuple({"kv": make_cache(cfg, kind, batch, max_len, dtype, device)}
                 for kind in leftover)
    return {"stack": stack, "leftover": left}


# ------------------------------------------------------------------ blocks

def block_apply(p, cfg: ModelConfig, kind: str, x, *, cur_index, cache):
    """Apply one block in decode mode. Returns (x, cache); the cache is
    updated in place."""
    _check_dense(cfg, kind)
    eps = cfg.norm_eps
    h = rmsnorm(p["ln1"], x, eps)
    y, _ = attend_decode(p["attn"], cfg, h, cache["kv"], cur_index, kind=kind)
    if cfg.post_norms:
        y = rmsnorm(p["ln1_post"], y, eps)
    x = x + y
    if "mlp" in p:
        h = rmsnorm(p["ln2"], x, eps)
        y = mlp(p["mlp"], cfg, h)
        if cfg.post_norms:
            y = rmsnorm(p["ln2_post"], y, eps)
        x = x + y
    return x, cache


# ------------------------------------------------------------------ forward

def _run_stack(params, cfg: ModelConfig, x, *, cur_index, cache):
    pattern, n_groups, leftover = cfg.pattern_split()
    for gi in range(n_groups):
        for i, kind in enumerate(pattern):
            x, _ = block_apply(
                tree_map(lambda a: a[gi], params["stack"][i]), cfg, kind, x,
                cur_index=cur_index,
                cache=tree_map(lambda a: a[gi], cache["stack"][i]))
    for i, kind in enumerate(leftover):
        x, _ = block_apply(params["leftover"][i], cfg, kind, x,
                           cur_index=cur_index, cache=cache["leftover"][i])
    return x


def forward(params, cfg: ModelConfig, *, mode: str, tokens, cache,
            cur_index):
    """Decode: logits for the new token (B, 1, V) in f32, and ``cache``,
    updated in place."""
    if mode != "decode":
        raise NotImplementedError(
            f"mode={mode!r}: prefill/train are ROADMAP queue 1, item 5")
    x = embed(params["embed"], cfg, tokens)
    x = _run_stack(params, cfg, x, cur_index=cur_index, cache=cache)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return unembed(params["embed"], cfg, x), cache

