"""Mixture-of-Experts FFN (port of ``repro.models.moe``).

Expert-parallel path (a mesh with a ``data`` or ``pod`` axis whose size
divides the expert count, as the reference chooses it: every production
mesh and the one-rank (1, 1) mesh): the reference's ``shard_map`` body on
each rank's local shards (``local_map``), remat'd as one unit under
training. Tokens go in chunks of at most 4096 through a sort-based
capacity dispatch (``_dispatch_tables``: a stable sort by expert, a rank
within the expert, Switch-style drops past ``capacity``), an all_to_all
over the data axes (every rank keeps its experts' slots), the expert FFN
with its d_ff sharded over ``model`` (the partials summed over ``model``,
the sum's gradient the identity), the all_to_all back and the weighted
combine. Dropped (token, expert) pairs add nothing.

Two choices keep a token's result independent of the call and repeated
calls bit-equal on the card: the expert products run over the capacity
dim padded to whole ``EXPERT_ROWS``-row blocks, each block's bits those
of a call of that block alone (``_expert_ffn_blocks``), and the combine
gathers each pair's slot through the inverse table ``slot_for_pair`` and
adds the k pairs in top-k order in f32, where the reference scatter-adds
(float atomics on the card).

Single-device path (no mesh): a dense compute of every expert on every
token, masked by the normalised top-k router weights, so no token is
dropped.
"""
from __future__ import annotations

import math

import torch
import torch.distributed._functional_collectives as funcol
import torch.nn.functional as F
from torch.distributed.tensor import Partial
from torch.distributed.tensor.experimental import local_map
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import (axis_sizes, constrain,
                                              current_mesh_rules, placements,
                                              replicated, spec_for)
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


# the capacity dim's rows are padded to a multiple of this (see
# _expert_ffn_blocks)
EXPERT_ROWS = 64
# tokens per dispatch chunk (the reference's token_chunk)
TOKEN_CHUNK = 4096


def _expert_ffn_blocks(xs, w_gate, w_in, w_out):
    """``_expert_ffn`` with the capacity dim zero-padded to whole blocks of
    EXPERT_ROWS rows, in one batched product per weight. A slot's bits must
    not depend on the capacity, which grows with the token count (the
    router's fixed blocks, ``_router_logits``, are there for the same
    reason): on an H100 the bf16 products at qwen3-moe's and llama4's
    expert shapes give each 64-row block the bits of a call of that block
    alone, at 1 to 160 blocks (``chip_smoke.py`` checks it on the card)."""
    E, C, d = xs.shape
    xs = torch.cat([xs, xs.new_zeros((E, (-C) % EXPERT_ROWS, d))], dim=1)
    return _expert_ffn(xs, w_gate, w_in, w_out)[:, :C]


def _dispatch_tables(top_i, num_experts: int, capacity: int):
    """Sort-based capacity dispatch tables (the reference's, plus the
    inverse the combine reads).

    Pairs (token t, choice j) are sorted by expert, stably (ties keep token
    order); a pair's rank within its expert is its sorted index less its
    expert's first index, and ranks past ``capacity`` are dropped. Returns
    (token_for_slot (E*C,), -1 where empty; slot_for_pair (n, k), -1 where
    dropped), int64, every shape static."""
    n, k = top_i.shape
    flat_e = top_i.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    se = flat_e[order]
    starts = torch.searchsorted(
        se, torch.arange(num_experts, device=se.device, dtype=se.dtype))
    rank = torch.arange(n * k, device=se.device) - starts[se]
    keep = rank < capacity
    overflow = num_experts * capacity             # a slot sliced off below
    slot = torch.where(keep, se * capacity + rank, overflow)
    token_for_slot = torch.full((overflow + 1,), -1, dtype=torch.long,
                                device=se.device)
    token_for_slot[slot] = order // k
    slot_for_pair = torch.empty(n * k, dtype=torch.long, device=se.device)
    slot_for_pair[order] = torch.where(keep, slot, -1)
    return token_for_slot[:overflow], slot_for_pair.reshape(n, k)


class _SumOverModel(torch.autograd.Function):
    """Sum of the expert-ff partials over the model axis. The sum is
    replicated over that axis, so every rank's partial gets the sum's
    gradient unchanged (a differentiable all-reduce would sum it again,
    scaling the expert weights' gradients by the axis size)."""

    @staticmethod
    def forward(ctx, y, group):
        return funcol.wait_tensor(funcol.all_reduce(y, "sum", group))

    @staticmethod
    def backward(ctx, g):
        return g, None


def _exchange(x, group, n: int):
    """(n*a, b, d) -> (a, n*b, d) over ``group``: block r of the first dim
    goes to rank r, the blocks received are laid side by side in rank order
    (the reference's tiled all_to_all, split_axis=0, concat_axis=1)."""
    a, b, d = x.shape[0] // n, x.shape[1], x.shape[2]
    y = funcol.all_to_all_single_autograd(x.contiguous(), None, None, group)
    return y.reshape(n, a, b, d).transpose(0, 1).reshape(a, n * b, d)


def _exchange_back(y, group, n: int):
    """The inverse of ``_exchange``: (a, n*b, d) -> (n*a, b, d)."""
    a, b, d = y.shape[0], y.shape[1] // n, y.shape[2]
    x = y.reshape(a, n, b, d).transpose(0, 1).reshape(n * a, b, d)
    return funcol.all_to_all_single_autograd(x.contiguous(), None, None,
                                             group)


def _moe_local(x_router, x_expert, p, cfg: ModelConfig, capacity: int,
               data_groups=(), model_group=None):
    """The expert-parallel body on one rank's tokens (N_loc, d): router,
    dispatch, all_to_all over each (group, size) of ``data_groups``, the
    experts, the sum over ``model_group``, all_to_all back, combine. The
    router reads ``x_router`` and the experts ``x_expert``: the same tokens,
    two inputs so that under a mesh their gradients can be laid out apart
    (the experts' is a partial sum over the model axis, the router's is
    not). Without groups it is the reference's ``_moe_local`` with no
    collectives."""
    m = cfg.moe
    E, d = m.num_experts, x_expert.shape[-1]
    top_p, top_i, _ = _router(p, cfg, x_router)
    tok, slot = _dispatch_tables(top_i, E, capacity)
    valid = (tok >= 0)[:, None].to(x_expert.dtype)
    xs = (x_expert[tok.clamp(min=0)] * valid).reshape(E, capacity, d)
    for group, n in data_groups:      # (E, C, d) -> (E_loc, n*C, d)
        xs = _exchange(xs, group, n)
    ys = _expert_ffn_blocks(xs, p["w_gate"], p["w_in"], p["w_out"])
    if model_group is not None:
        ys = _SumOverModel.apply(ys, model_group)
    for group, n in reversed(data_groups):
        ys = _exchange_back(ys, group, n)
    ys = torch.cat([ys.reshape(E * capacity, d), ys.new_zeros((1, d))])
    chosen = ys[torch.where(slot < 0, E * capacity, slot)]     # (N, k, d)
    out = chosen[:, 0].float() * top_p[:, 0:1]
    for j in range(1, m.top_k):
        out = out + chosen[:, j].float() * top_p[:, j:j + 1]
    return out.to(x_expert.dtype)


def _capacity(cfg: ModelConfig, n_local: int):
    """(tokens a chunk, capacity per expert): the reference's 4096-token
    chunks (fewer where they do not divide the tokens) and
    max(min_capacity, ceil(chunk·top_k/E·capacity_factor))."""
    m = cfg.moe
    n_chunks = max(1, -(-n_local // TOKEN_CHUNK))
    while n_local % n_chunks:
        n_chunks -= 1
    chunk = n_local // n_chunks
    return chunk, max(m.min_capacity, int(math.ceil(
        chunk * m.top_k / m.num_experts * m.capacity_factor)))


def _moe_ep(p, cfg: ModelConfig, x, mesh, rules, dp):
    """The expert-parallel path on ``mesh`` (see the module's note)."""
    B, S, d = x.shape
    sizes = axis_sizes(mesh)
    n_dp = math.prod(sizes[a] for a in dp)
    chunk, capacity = _capacity(cfg, (B // n_dp if B % n_dp == 0 else B) * S)
    names = tuple(mesh.mesh_dim_names)
    data_groups = [(mesh.get_group(names.index(a)), sizes[a]) for a in dp
                   if sizes[a] > 1]
    model_group = (mesh.get_group(names.index("model"))
                   if sizes.get("model", 1) > 1 else None)
    xp = placements(mesh, spec_for(rules, ("batch",), (B,)) + (None, None))
    w_ep = dp if len(dp) > 1 else dp[0]
    wp = placements(mesh, (w_ep, None, "model"))
    wo = placements(mesh, (w_ep, "model", None))
    rep = replicated(mesh)
    # gradients: the experts' x a partial sum over model; the router's
    # weights a partial sum over the dims that split the tokens
    x_grad = tuple(Partial() if n == "model" and sizes[n] > 1 else q
                   for n, q in zip(names, xp))
    r_grad = tuple(Partial() if q.is_shard() else r
                   for q, r in zip(xp, rep))

    def body(xr, xe, router, w_gate, w_in, w_out):
        pl = {"router": router, "w_gate": w_gate, "w_in": w_in,
              "w_out": w_out}
        xr, xe = xr.reshape(-1, d), xe.reshape(-1, d)
        out = [_moe_local(xr[i:i + chunk], xe[i:i + chunk], pl, cfg,
                          capacity, data_groups, model_group)
               for i in range(0, xr.shape[0], chunk)]
        return torch.cat(out).reshape(-1, S, d)

    run = local_map(body, out_placements=list(xp),
                    in_placements=(xp, xp, rep, wp, wp, wo),
                    in_grad_placements=(xp, x_grad, r_grad, wp, wp, wo),
                    device_mesh=mesh, redistribute_inputs=True)
    args = (x, x, p["router"], p["w_gate"], p["w_in"], p["w_out"])
    if torch.is_grad_enabled():
        # remat as one unit, as the reference's jax.checkpoint(smapped):
        # the dispatch buffers are recomputed in the backward, not saved
        y = checkpoint(run, *args, use_reentrant=False)
    else:
        y = run(*args)
    return constrain(y, "batch", "seq", "d_model")


def moe_apply(p, cfg: ModelConfig, x):
    """x (B, S, d) -> (B, S, d). Under a mesh whose data axes (``pod``,
    ``data``) divide the expert count: the expert-parallel path
    (``_moe_ep``). Otherwise every expert on every token, combined in
    f32 with the router's normalised top-k weights. The other experts'
    weights are 0, so the combine adds the k chosen experts' weighted
    outputs one after another, in top-k order: the reference's f32 sum over
    all experts, in another order. Elementwise adds keep each token's
    result independent of how many tokens share the call; a sum or a
    batched product over the expert dim does not on the card (its
    reduction order varies from call to call)."""
    mesh, rules = current_mesh_rules()
    if mesh is not None and rules is not None:
        sizes = axis_sizes(mesh)
        dp = tuple(a for a in ("pod", "data") if a in sizes)
        if dp and cfg.moe.num_experts % math.prod(sizes[a] for a in dp) == 0:
            return _moe_ep(p, cfg, x, mesh, rules, dp)
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
