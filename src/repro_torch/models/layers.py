"""Shared layers: norms, MLPs, rotary embeddings, token embedding (port of
``repro.models.layers``). Plain functions over tensors in the reference's
parameter tree and einsum layouts, with its ``constrain`` calls (no-ops
outside a mesh)."""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import vocab
from repro_torch.distributed.sharding import constrain
from repro_torch.models.params import ParamSpec


# ---------------------------------------------------------------- norms

def rmsnorm_spec(d: int):
    return {"scale": ParamSpec((d,), ("d_model",), init="zeros")}


def rmsnorm(p, x, eps: float):
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    # gemma-style (1 + scale): zero-init = identity
    return (y * (1.0 + p["scale"].float())).to(x.dtype)


def layernorm_spec(d: int):
    return {"scale": ParamSpec((d,), ("d_model",), init="zeros"),
            "bias": ParamSpec((d,), ("d_model",), init="zeros")}


def layernorm(p, x, eps: float):
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mu).square().mean(dim=-1, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * (1.0 + p["scale"].float()) + p["bias"].float()).to(x.dtype)


# ---------------------------------------------------------------- MLP

def mlp_spec(cfg: ModelConfig, d_ff: int = 0):
    d, ff = cfg.d_model, (d_ff or cfg.d_ff)
    if cfg.mlp == "swiglu":
        return {
            "w_gate": ParamSpec((d, ff), ("d_model", "d_ff")),
            "w_in": ParamSpec((d, ff), ("d_model", "d_ff")),
            "w_out": ParamSpec((ff, d), ("d_ff", "d_model")),
        }
    return {  # standard gelu MLP (starcoder2-style)
        "w_in": ParamSpec((d, ff), ("d_model", "d_ff")),
        "b_in": ParamSpec((ff,), ("d_ff",), init="zeros"),
        "w_out": ParamSpec((ff, d), ("d_ff", "d_model")),
        "b_out": ParamSpec((d,), ("d_model",), init="zeros"),
    }


def mlp(p, cfg: ModelConfig, x):
    if "w_gate" in p:
        g = x @ p["w_gate"]
        h = x @ p["w_in"]
        h = F.silu(g.float()).to(x.dtype) * h
    else:
        h = x @ p["w_in"] + p["b_in"]
        h = F.gelu(h.float(), approximate="tanh").to(x.dtype)
    h = constrain(h, "batch", "seq", "d_ff")
    y = h @ p["w_out"]
    if "b_out" in p:
        y = y + p["b_out"]
    return y


# ---------------------------------------------------------------- rotary

def rope(x, positions, theta: float):
    """Half-split (NeoX) rotary embedding, computed in f32.

    x: (..., seq, heads, head_dim); positions: (..., seq) int.
    """
    half = x.shape[-1] // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=x.device) / half)
    ang = positions[..., None].float() * freq                 # (..., S, half)
    cos = torch.cos(ang)[..., None, :]                         # (..., S, 1, half)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------- embedding

def embed_spec(cfg: ModelConfig):
    s = {"embedding": ParamSpec((cfg.vocab_padded, cfg.d_model),
                                ("vocab", "d_model"), init="embed",
                                scale=cfg.d_model ** -0.5)}
    if not cfg.tie_embeddings:
        s["lm_head"] = ParamSpec((cfg.d_model, cfg.vocab_padded),
                                 ("d_model", "vocab"))
    return s


def embed(p, cfg: ModelConfig, tokens):
    """Token embeddings. A table split over the vocab under a mesh is never
    moved: each rank looks up the ids in its own rows and the ranks sum
    (``distributed/vocab.py``)."""
    table = p["embedding"]
    x = (vocab.embed(table, tokens) if vocab.vocab_groups(table, 0)
         else table[tokens])
    if cfg.scale_embed:
        # the scale is rounded to x's dtype first, as jnp.asarray(.., dtype)
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype, device=x.device)
    return constrain(x, "batch", "seq", "d_model")


def unembed(p, cfg: ModelConfig, x):
    table = p["embedding"].T if cfg.tie_embeddings else p["lm_head"]
    logits = (x @ table).float()
    if cfg.final_softcap:
        c = cfg.final_softcap
        logits = c * torch.tanh(logits / c)
    # mask padded vocab entries
    if cfg.vocab_padded != cfg.vocab_size:
        neg = torch.finfo(torch.float32).min
        if isinstance(logits, DTensor):   # a DTensor has no in-place fill
            keep = torch.arange(cfg.vocab_padded,
                                device=logits.device) < cfg.vocab_size
            logits = torch.where(keep, logits, neg)
        else:
            logits[..., cfg.vocab_size:] = neg
    return constrain(logits, "batch", "seq", "vocab")


def softcap(x, cap: float):
    return cap * torch.tanh(x / cap) if cap else x
