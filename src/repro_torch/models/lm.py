"""Language model assembled from pattern blocks (port of
``repro.models.lm``): every family of the reference — dense, Mamba2, the
RG-LRU hybrid, MoE, and the decoder and encoder of the encoder-decoder and
VLM models.

The parameter and cache trees are the reference's: the repeating
``cfg.pattern`` is stacked along a leading ``layers`` dim under ``"stack"``
and the leftover layers sit unstacked under ``"leftover"``. The reference
drives the stack with ``lax.scan``; here a Python loop walks the leading
dim.

Three modes share one block implementation:
  * ``train``   — full attention, no cache; differentiable (attention's
    backward is ``kernels.flash_attention.FlashAttention``). Under
    ``cfg.remat`` each group of the stack runs under
    ``torch.utils.checkpoint`` (non-reentrant), saving only the group's
    input, as the reference wraps its scan body in ``jax.checkpoint`` with
    ``nothing_saveable``
  * ``prefill`` — full attention, returns a decode-ready cache with the
    ``init_cache`` structure
  * ``decode``  — one token against the cache, which is updated in place
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import constrain
from repro_torch.models import params as pspec
from repro_torch.models.attention import (attend_decode, attend_full,
                                          attn_spec, cache_axes, make_cache,
                                          prefill_into_cache)
from repro_torch.models.layers import (embed, embed_spec, mlp, mlp_spec,
                                       rmsnorm, rmsnorm_spec, unembed)
from repro_torch.models.moe import moe_apply, moe_spec
from repro_torch.models.rglru import (rglru_decode, rglru_full, rglru_spec,
                                      rglru_state, rglru_state_axes)
from repro_torch.models.ssm import (mamba_decode, mamba_full, mamba_spec,
                                    mamba_state, mamba_state_axes)
from repro_torch.utils import tree_leaves, tree_map, tree_unflatten

ATTN_KINDS = ("attn", "local")
MODES = ("train", "prefill", "decode")


# ------------------------------------------------------------------ specs

def block_spec(cfg: ModelConfig, kind: str, cross: bool = False):
    d = cfg.d_model
    s = {"ln1": rmsnorm_spec(d)}
    if kind in ATTN_KINDS:
        s["attn"] = attn_spec(cfg)
        if cross:
            s["ln_x"] = rmsnorm_spec(d)
            s["cross"] = attn_spec(cfg)
    elif kind == "ssm":
        s["ssm"] = mamba_spec(cfg)
    elif kind == "rec":
        s["rec"] = rglru_spec(cfg)
    else:
        raise ValueError(kind)
    if cfg.post_norms:
        s["ln1_post"] = rmsnorm_spec(d)
    if cfg.moe is not None:
        s["ln2"] = rmsnorm_spec(d)
        s["moe"] = moe_spec(cfg)
        if cfg.moe.shared_expert:
            s["shared"] = mlp_spec(cfg, cfg.moe.d_ff_expert)
        if cfg.post_norms:
            s["ln2_post"] = rmsnorm_spec(d)
    elif cfg.mlp != "none":
        s["ln2"] = rmsnorm_spec(d)
        s["mlp"] = mlp_spec(cfg)
        if cfg.post_norms:
            s["ln2_post"] = rmsnorm_spec(d)
    return s


def model_spec(cfg: ModelConfig, cross: bool = False):
    pattern, n_groups, leftover = cfg.pattern_split()
    return {
        "embed": embed_spec(cfg),
        "stack": tuple(
            pspec.stack_specs(block_spec(cfg, kind, cross), n_groups,
                              "layers")
            for kind in pattern),
        "leftover": tuple(block_spec(cfg, kind, cross) for kind in leftover),
        "final_norm": rmsnorm_spec(cfg.d_model),
    }


# ------------------------------------------------------------------ caches

def _block_cache(cfg: ModelConfig, kind: str, batch: int, max_len: int,
                 dtype, device, cross_len: int = 0):
    if kind in ATTN_KINDS:
        c = {"kv": make_cache(cfg, kind, batch, max_len, dtype, device)}
        if cross_len:
            c["cross"] = make_cache(cfg, "attn", batch, cross_len, dtype,
                                    device)
        return c
    if kind == "ssm":
        return {"state": mamba_state(cfg, batch, dtype, device)}
    if kind == "rec":
        return {"state": rglru_state(cfg, batch, dtype, device)}
    raise ValueError(kind)


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device="cuda", cross_len: int = 0):
    pattern, n_groups, leftover = cfg.pattern_split()
    stack = tuple(
        tree_map(lambda a: a.new_zeros((n_groups,) + tuple(a.shape)),
                 _block_cache(cfg, kind, batch, max_len, dtype, device,
                              cross_len))
        for kind in pattern)
    left = tuple(_block_cache(cfg, kind, batch, max_len, dtype, device,
                              cross_len)
                 for kind in leftover)
    return {"stack": stack, "leftover": left}


def _block_cache_axes(cfg: ModelConfig, kind: str, cross_len: int = 0):
    if kind in ATTN_KINDS:
        c = {"kv": {"k": cache_axes(), "v": cache_axes()}}
        if cross_len:
            c["cross"] = {"k": cache_axes(), "v": cache_axes()}
        return c
    if kind == "ssm":
        return {"state": mamba_state_axes()}
    if kind == "rec":
        return {"state": rglru_state_axes()}
    raise ValueError(kind)


def cache_abstract(cfg: ModelConfig, batch: int, max_len: int,
                   dtype=torch.bfloat16, cross_len: int = 0):
    """``init_cache``'s tree as meta tensors: shapes and dtypes, no
    storage."""
    return init_cache(cfg, batch, max_len, dtype, "meta", cross_len)


def cache_logical_axes(cfg: ModelConfig, cross_len: int = 0):
    """Tree of logical-axis tuples matching the init_cache structure."""
    pattern, n_groups, leftover = cfg.pattern_split()

    def stacked(tree):
        if isinstance(tree, dict):
            return {k: stacked(v) for k, v in tree.items()}
        return ("layers",) + tuple(tree)

    stack = tuple(stacked(_block_cache_axes(cfg, kind, cross_len))
                  for kind in pattern)
    left = tuple(_block_cache_axes(cfg, kind, cross_len)
                 for kind in leftover)
    return {"stack": stack, "leftover": left}


# ------------------------------------------------------------------ blocks

def block_apply(p, cfg: ModelConfig, kind: str, x, *, mode: str,
                positions=None, cur_index=None, cache=None, enc_out=None,
                enc_positions=None, causal: bool = True, cache_len=None):
    """Apply one block. Returns (x, new_cache): in decode the new cache is
    ``cache``, updated in place; in prefill a new cache; in train None."""
    eps = cfg.norm_eps
    h = rmsnorm(p["ln1"], x, eps)
    new_cache = cache if mode == "decode" else {}
    if kind in ATTN_KINDS:
        if mode == "decode":
            y, _ = attend_decode(p["attn"], cfg, h, cache["kv"], cur_index,
                                 kind=kind)
        else:
            y, (k, v) = attend_full(p["attn"], cfg, h, kind=kind,
                                    positions=positions, causal=causal)
            if mode == "prefill":
                new_cache["kv"] = prefill_into_cache(
                    cfg, kind, k, v, max_len=cache_len or k.shape[1])
    elif kind in ("ssm", "rec"):
        full, step = ((mamba_full, mamba_decode) if kind == "ssm"
                      else (rglru_full, rglru_decode))
        if mode == "decode":
            y, st = step(p[kind], cfg, h, cache["state"])
            for name, t in st.items():        # the new state, in place
                cache["state"][name].copy_(t)
        else:
            y, st = full(p[kind], cfg, h)
            if mode == "prefill":
                new_cache["state"] = st
    else:
        raise ValueError(kind)
    if cfg.post_norms:
        y = rmsnorm(p["ln1_post"], y, eps)
    x = x + y

    if "cross" in p:
        h = rmsnorm(p["ln_x"], x, eps)
        if mode == "decode":
            y, _ = attend_decode(p["cross"], cfg, h, cache["cross"],
                                 cur_index, kind="attn", cross=True)
        else:
            y, (ck, cv) = attend_full(p["cross"], cfg, h, kind="attn",
                                      positions=positions, x_kv=enc_out,
                                      kv_positions=enc_positions, cross=True)
            if mode == "prefill":     # the encoder's K/V, unpadded
                new_cache["cross"] = {"k": ck, "v": cv}
        x = x + y

    if "moe" in p:
        h = rmsnorm(p["ln2"], x, eps)
        y = moe_apply(p["moe"], cfg, h)
        if "shared" in p:
            y = y + mlp(p["shared"], cfg, h)
        if cfg.post_norms:
            y = rmsnorm(p["ln2_post"], y, eps)
        x = x + y
    elif "mlp" in p:
        h = rmsnorm(p["ln2"], x, eps)
        y = mlp(p["mlp"], cfg, h)
        if cfg.post_norms:
            y = rmsnorm(p["ln2_post"], y, eps)
        x = x + y
    # residual stream between blocks: optionally sequence-sharded over the
    # model axis (Megatron-SP)
    x = constrain(x, "batch", "seq_act", "d_model")
    return x, (new_cache if mode != "train" else None)


# ------------------------------------------------------------------ forward

def _run_stack(params, cfg: ModelConfig, x, *, mode, positions=None,
               cur_index=None, cache=None, enc_out=None, enc_positions=None,
               causal=True, cache_len=None):
    """Returns (x, cache). Prefill stacks the groups' caches along a new
    leading dim (``torch.stack`` copies, so decode can write the stacked
    leaves in place)."""
    pattern, n_groups, leftover = cfg.pattern_split()
    kw = dict(mode=mode, positions=positions, cur_index=cur_index,
              enc_out=enc_out, enc_positions=enc_positions, causal=causal,
              cache_len=cache_len)
    per_group = [[] for _ in pattern]
    # one unbind per stacked leaf: under autograd its backward stacks the
    # groups' gradients once, where slicing a[gi] per group would add a
    # full-size, zero-padded gradient for every group
    groups = [_unstack(p, n_groups) for p in params["stack"]]
    for gi in range(n_groups):
        group = [g[gi] for g in groups]
        if mode == "train":
            if cfg.remat:   # saves the group's input; recomputed in backward
                x = checkpoint(_train_group, group, cfg, pattern, x, kw,
                               use_reentrant=False)
            else:
                x = _train_group(group, cfg, pattern, x, kw)
            continue
        for i, kind in enumerate(pattern):
            c = (tree_map(lambda a: a[gi], cache["stack"][i])
                 if mode == "decode" else None)
            x, nc = block_apply(group[i], cfg, kind, x, cache=c, **kw)
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


def _unstack(tree, n: int):
    """A tree of stacked leaves -> n trees, leaf i of each from unbind."""
    parts = [t.unbind(0) for t in tree_leaves(tree)]
    return [tree_unflatten(tree, [p[gi] for p in parts]) for gi in range(n)]


def _train_group(group, cfg: ModelConfig, pattern, x, kw):
    """One group of the stack in train mode (the unit of remat): ``group``
    holds the group's parameters, one tree per pattern entry."""
    for p, kind in zip(group, pattern):
        x, _ = block_apply(p, cfg, kind, x, **kw)
    return x


def _stack(trees):
    """Trees of one structure -> one tree, leaves stacked on a new dim 0."""
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def forward(params, cfg: ModelConfig, *, mode: str, tokens,
            image_embeds=None, cache=None, cur_index=None, enc_out=None,
            enc_positions=None, causal: bool = True, cache_len=None):
    """Returns (logits in f32, cache).

    * train:   logits over all positions, cache None
    * prefill: logits for the last position only, decode-ready cache
    * decode:  logits for the new token (B, 1, V); ``cache`` updated in
      place and returned

    ``image_embeds`` (B, P, d) go before the token embeddings (VLM input);
    ``enc_out`` (B, Se, d) is what a decoder's cross-attention reads.
    """
    if mode not in MODES:
        raise ValueError(mode)
    x = embed(params["embed"], cfg, tokens)
    if image_embeds is not None:
        img = image_embeds.to(x.dtype)
        if cfg.scale_embed:
            # the scale is rounded to x's dtype first, as in embed()
            img = img * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype,
                                     device=x.device)
        x = torch.cat([img, x], dim=1)
        x = constrain(x, "batch", "seq", "d_model")
    B, S = x.shape[:2]
    positions = None
    if mode != "decode":
        positions = seq_positions(B, S, x.device)
    x, cache = _run_stack(params, cfg, x, mode=mode, positions=positions,
                          cur_index=cur_index, cache=cache, enc_out=enc_out,
                          enc_positions=enc_positions, causal=causal,
                          cache_len=cache_len)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    if mode == "prefill":
        x = x[:, -1:]
    return unembed(params["embed"], cfg, x), cache


def seq_positions(B: int, S: int, device):
    """Positions 0..S-1 of each of B rows, (B, S) int32."""
    return torch.arange(S, dtype=torch.int32, device=device).expand(B, S)


def encode(params, cfg: ModelConfig, embeds):
    """Bidirectional encoder pass (encoder-decoder models): embeds (B,S,d)
    -> (B,S,d), final norm applied."""
    B, S = embeds.shape[:2]
    embeds = constrain(embeds, "batch", "seq", "d_model")
    x, _ = _run_stack(params, cfg, embeds, mode="train",
                      positions=seq_positions(B, S, embeds.device),
                      causal=False)
    return rmsnorm(params["final_norm"], x, cfg.norm_eps)


def greedy_sample(logits):
    """(B, 1, V) -> (B, 1) int32 next tokens. Under a mesh the vocab dim
    is gathered first: DTensor's argmax over a sharded dim fails."""
    logits = constrain(logits, "batch", "seq", None)
    return logits[:, -1, :].argmax(dim=-1).to(torch.int32)[:, None]
