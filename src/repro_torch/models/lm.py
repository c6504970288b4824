"""Decoder-only language model, dense and Mamba2 families (port of
``repro.models.lm``).

The parameter and cache trees are the reference's: the repeating
``cfg.pattern`` is stacked along a leading ``layers`` dim under ``"stack"``
and the leftover layers sit unstacked under ``"leftover"``. The reference
drives the stack with ``lax.scan``; here a Python loop walks the leading
dim.

Three modes share one block implementation:
  * ``train``   — full attention, no cache (the forward only: the backward
    comes with the training port)
  * ``prefill`` — full attention, returns a decode-ready cache with the
    ``init_cache`` structure
  * ``decode``  — one token against the cache, which is updated in place

RG-LRU blocks, MoE blocks and encoder-decoder / VLM input are not ported
yet and raise NotImplementedError.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import params as pspec
from repro_torch.models.attention import (attend_decode, attend_full,
                                          attn_spec, make_cache,
                                          prefill_into_cache)
from repro_torch.models.layers import (embed, embed_spec, mlp, mlp_spec,
                                       rmsnorm, rmsnorm_spec, unembed)
from repro_torch.models.ssm import (mamba_decode, mamba_full, mamba_spec,
                                    mamba_state)
from repro_torch.utils import tree_map

ATTN_KINDS = ("attn", "local")
MODES = ("train", "prefill", "decode")
_NOT_PORTED = "is not ported yet (ROADMAP, modules to port)"


def _check_kind(cfg: ModelConfig, kind: str):
    if kind == "rec":
        raise NotImplementedError(f"RG-LRU blocks {_NOT_PORTED}")
    if kind not in ATTN_KINDS + ("ssm",):
        raise ValueError(kind)
    if cfg.moe is not None:
        raise NotImplementedError(f"MoE blocks {_NOT_PORTED}")


# ------------------------------------------------------------------ specs

def block_spec(cfg: ModelConfig, kind: str):
    _check_kind(cfg, kind)
    d = cfg.d_model
    s = {"ln1": rmsnorm_spec(d)}
    if kind == "ssm":
        s["ssm"] = mamba_spec(cfg)
    else:
        s["attn"] = attn_spec(cfg)
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

def _block_cache(cfg: ModelConfig, kind: str, batch: int, max_len: int,
                 dtype, device):
    _check_kind(cfg, kind)
    if kind == "ssm":
        return {"state": mamba_state(cfg, batch, dtype, device)}
    return {"kv": make_cache(cfg, kind, batch, max_len, dtype, device)}


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device="cuda"):
    pattern, n_groups, leftover = cfg.pattern_split()
    stack = tuple(
        tree_map(lambda a: a.new_zeros((n_groups,) + tuple(a.shape)),
                 _block_cache(cfg, kind, batch, max_len, dtype, device))
        for kind in pattern)
    left = tuple(_block_cache(cfg, kind, batch, max_len, dtype, device)
                 for kind in leftover)
    return {"stack": stack, "leftover": left}


# ------------------------------------------------------------------ blocks

def block_apply(p, cfg: ModelConfig, kind: str, x, *, mode: str,
                positions=None, cur_index=None, cache=None, cache_len=None):
    """Apply one block. Returns (x, new_cache): in decode the new cache is
    ``cache``, updated in place; in prefill a new cache; in train None."""
    _check_kind(cfg, kind)
    eps = cfg.norm_eps
    h = rmsnorm(p["ln1"], x, eps)
    new_cache = None
    if kind == "ssm":
        if mode == "decode":
            y, st = mamba_decode(p["ssm"], cfg, h, cache["state"])
            for name, t in st.items():
                cache["state"][name].copy_(t)
            new_cache = cache
        else:
            y, st = mamba_full(p["ssm"], cfg, h)
            if mode == "prefill":
                new_cache = {"state": st}
    elif mode == "decode":
        y, _ = attend_decode(p["attn"], cfg, h, cache["kv"], cur_index,
                             kind=kind)
        new_cache = cache
    else:
        y, (k, v) = attend_full(p["attn"], cfg, h, kind=kind,
                                positions=positions)
        if mode == "prefill":
            new_cache = {"kv": prefill_into_cache(
                cfg, kind, k, v, max_len=cache_len or k.shape[1])}
    if cfg.post_norms:
        y = rmsnorm(p["ln1_post"], y, eps)
    x = x + y
    if "mlp" in p:
        h = rmsnorm(p["ln2"], x, eps)
        y = mlp(p["mlp"], cfg, h)
        if cfg.post_norms:
            y = rmsnorm(p["ln2_post"], y, eps)
        x = x + y
    return x, new_cache


# ------------------------------------------------------------------ forward

def _run_stack(params, cfg: ModelConfig, x, *, mode, positions=None,
               cur_index=None, cache=None, cache_len=None):
    """Returns (x, cache). Prefill stacks the groups' caches along a new
    leading dim (``torch.stack`` copies, so decode can write the stacked
    leaves in place)."""
    pattern, n_groups, leftover = cfg.pattern_split()
    kw = dict(mode=mode, positions=positions, cur_index=cur_index,
              cache_len=cache_len)
    per_group = [[] for _ in pattern]
    for gi in range(n_groups):
        for i, kind in enumerate(pattern):
            c = (tree_map(lambda a: a[gi], cache["stack"][i])
                 if mode == "decode" else None)
            x, nc = block_apply(tree_map(lambda a: a[gi], params["stack"][i]),
                                cfg, kind, x, cache=c, **kw)
            per_group[i].append(nc)
    left = []
    for i, kind in enumerate(leftover):
        c = cache["leftover"][i] if mode == "decode" else None
        x, nc = block_apply(params["leftover"][i], cfg, kind, x, cache=c,
                            **kw)
        left.append(nc)
    if mode != "prefill":
        return x, cache
    stack = tuple(_stack(c) for c in per_group) if n_groups else ()
    return x, {"stack": stack, "leftover": tuple(left)}


def _stack(trees):
    """Trees of one structure -> one tree, leaves stacked on a new dim 0."""
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def forward(params, cfg: ModelConfig, *, mode: str, tokens, cache=None,
            cur_index=None, cache_len=None):
    """Returns (logits in f32, cache).

    * train:   logits over all positions, cache None
    * prefill: logits for the last position only, decode-ready cache
    * decode:  logits for the new token (B, 1, V); ``cache`` updated in
      place and returned
    """
    if mode not in MODES:
        raise ValueError(mode)
    x = embed(params["embed"], cfg, tokens)
    B, S = x.shape[:2]
    positions = None
    if mode != "decode":
        positions = torch.arange(S, dtype=torch.int32,
                                 device=x.device).expand(B, S)
    x, cache = _run_stack(params, cfg, x, mode=mode, positions=positions,
                          cur_index=cur_index, cache=cache,
                          cache_len=cache_len)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    if mode == "prefill":
        x = x[:, -1:]
    return unembed(params["embed"], cfg, x), cache


def greedy_sample(logits):
    """(B, 1, V) -> (B, 1) int32 next tokens."""
    return logits[:, -1, :].argmax(dim=-1).to(torch.int32)[:, None]
