"""Mixture-of-Experts FFN (port of ``repro.models.moe``), single-device path.

The reference's path for one device (no mesh): a dense compute of every
expert on every token, masked by the normalised top-k router weights, so no
token is dropped. Under a mesh the same dense path runs on DTensors; the
reference's expert-parallel ``shard_map`` path (sort-based capacity
dispatch, all_to_all over the data axis) is not ported yet.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import constrain
from repro_torch.models.params import ParamSpec


def moe_spec(cfg: ModelConfig):
    m = cfg.moe
    d, e, f = cfg.d_model, m.num_experts, m.d_ff_expert
    return {
        "router": ParamSpec((d, e), ("d_model", None), dtype=torch.float32),
        "w_gate": ParamSpec((e, d, f), ("experts", "d_model", "expert_ff")),
        "w_in": ParamSpec((e, d, f), ("experts", "d_model", "expert_ff")),
        "w_out": ParamSpec((e, f, d), ("experts", "expert_ff", "d_model")),
    }


# rows per router product (see _router_logits)
ROUTER_ROWS = 64


def _router_logits(x, router):
    """x @ router in f32, over fixed blocks of ROUTER_ROWS rows (the last one
    zero-padded), so that every token's logits come from a product of the
    same shape and do not depend on how many tokens share the call. One
    product over all the rows lets cuBLAS pick its f32 kernel by the row
    count: on an H100 a token's logits then differ by up to 2.4e-6 between
    a prefill of 2048 tokens and a train forward of 2049, enough to flip
    the bf16 rounding of the block's output and break the prefill/train
    identity."""
    xf = x.reshape(-1, x.shape[-1]).float()
    n = xf.shape[0]
    # zero rows to a whole block (by torch.cat, as for DTensors)
    xf = torch.cat([xf, xf.new_zeros(((-n) % ROUTER_ROWS, xf.shape[1]))])
    logits = torch.cat([blk @ router for blk in xf.split(ROUTER_ROWS)])
    return logits[:n].reshape(x.shape[:-1] + (router.shape[1],))


def _router(p, cfg: ModelConfig, x):
    """(top-k weights normalised to sum 1, their expert indices, logits), in
    f32. Ties go to the lower expert index, as ``lax.top_k`` breaks them: a
    stable sort of the negated probabilities (``torch.topk`` promises no
    order among ties)."""
    logits = _router_logits(x, p["router"])
    probs = torch.softmax(logits, dim=-1)
    top_i = torch.argsort(-probs, dim=-1, stable=True)[..., :cfg.moe.top_k]
    top_p = probs.gather(-1, top_i)
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
    return top_p, top_i, logits


def _expert_ffn(xs, w_gate, w_in, w_out):
    """xs (E, C, d); weights (E, d, f)/(E, f, d). Returns (E, C, d)."""
    g = torch.einsum("ecd,edf->ecf", xs, w_gate)
    h = torch.einsum("ecd,edf->ecf", xs, w_in)
    h = F.silu(g.float()).to(xs.dtype) * h
    return torch.einsum("ecf,efd->ecd", h, w_out)


def moe_apply(p, cfg: ModelConfig, x):
    """x (B, S, d) -> (B, S, d): every expert on every token, combined in
    f32 with the router's normalised top-k weights. The other experts'
    weights are 0, so the combine adds the k chosen experts' weighted
    outputs one after another, in top-k order: the reference's f32 sum over
    all experts, in another order. Elementwise adds keep each token's
    result independent of how many tokens share the call; a sum or a
    batched product over the expert dim does not on the card (its
    reduction order varies from call to call)."""
    top_p, top_i, _ = _router(p, cfg, x)
    g = torch.einsum("bsd,edf->bsef", x, p["w_gate"])
    h = torch.einsum("bsd,edf->bsef", x, p["w_in"])
    h = F.silu(g.float()).to(x.dtype) * h
    y = torch.einsum("bsef,efd->bsed", h, p["w_out"])
    # under a mesh, every expert's output on each rank before the pick:
    # DTensor's gather over a sharded dim leaves a masked partial that its
    # next reduction cannot take
    y = constrain(y, "batch", "seq", None, "d_model")
    chosen = y.gather(2, top_i[..., None].expand(-1, -1, -1, y.shape[-1]))
    out = chosen[:, :, 0].float() * top_p[..., 0:1]
    for j in range(1, cfg.moe.top_k):
        out = out + chosen[:, :, j].float() * top_p[..., j:j + 1]
    return constrain(out.to(x.dtype), "batch", "seq", "d_model")
