"""The vocab-parallel layer: the token embedding's lookup and the
next-token log-likelihood on a table and logits split over the vocab, as
XLA partitions the reference's ``jnp.take`` (``models/layers.py::embed``)
and ``log_softmax`` (``distributed/steps.py::cross_entropy``) when the
vocab dim is sharded over ``model``. Nothing of size V moves:

* lookup: each shard holds vocab rows [lo, lo + V_loc). It reads the ids in
  its range (an id outside reads its row 0, zeroed) in f32, the shards'
  rows are summed (one shard contributes to each row, so the sum is the
  plain lookup's bits) and cast once. The backward of the shard's indexing
  scatters each row's gradient into the shard's own rows;
* log-likelihood: ``ll = (t - m) - log Σ`` with m the rows' max over every
  shard (a MAX over shards), Σ the sum of exp(l - m) (a SUM) and t the
  target's logit, taken by the shard that holds the target id (a SUM of
  one non-zero). The backward is the shard's own ``(onehot - softmax) · g``
  from the saved (m + log Σ): no collective. The padded vocab entries sit
  at ``finfo.min`` (``unembed``) and add exp(-huge) = 0 to Σ.

The per-shard bodies (``embed_shard``, ``ll_max``, ``ll_sumexp``,
``ll_target``, ``ll_grad``) are merged over shards held by one process (a
tensor cut into n shards here: ``embed_split``, ``token_ll_split``), or one
shard a rank, over the process groups of the mesh dims that split the vocab
(``embed``, ``token_ll``: inside ``use_rules``, on DTensors), as
``kernels/ops.py`` merges attention partials by lse (``merge`` and
``merge_over``). Merged over ranks, the sums are all-reduces in f32.
"""
from __future__ import annotations

import functools

import torch
from torch.distributed.tensor import DTensor, Partial
from torch.distributed.tensor.experimental import local_map

from repro_torch.distributed.sharding import (all_reduce_over, constrain,
                                              current_mesh_rules,
                                              current_placements, replicated,
                                              shard_groups, shard_offset)


# ----------------------------------------------------------- shard bodies

def _local_ids(ids, lo: int, n: int):
    """(ids - lo with the ids outside [lo, lo + n) at 0, mask of those
    inside)."""
    local = ids.long() - lo
    hit = (local >= 0) & (local < n)
    return torch.where(hit, local, 0), hit


def embed_shard(table, ids, lo: int):
    """f32 rows of ``ids`` from a shard of the table holding vocab rows
    [lo, lo + table.shape[0]); the rows of ids outside are 0."""
    local, hit = _local_ids(ids, lo, table.shape[0])
    return torch.where(hit[..., None], table[local].float(), 0.0)


def ll_max(logits):
    """The rows' max over a shard of f32 logits (..., V_loc)."""
    return logits.amax(dim=-1)


def ll_sumexp(logits, m):
    """Σ exp(l - m) over a shard, m the rows' max over every shard."""
    return torch.sub(logits, m[..., None]).exp_().sum(dim=-1)


def ll_target(logits, targets, lo: int):
    """The target's logit where this shard (vocab from ``lo``) holds the
    target id, 0 elsewhere."""
    local, hit = _local_ids(targets, lo, logits.shape[-1])
    t = torch.gather(logits, -1, local[..., None])[..., 0]
    return torch.where(hit, t, 0.0)


def ll_grad(logits, targets, lo: int, lse, g):
    """d ll / d logits of a shard times the rows' upstream gradient g:
    (onehot - exp(l - lse)) · g, lse = m + log Σ over every shard. One
    element a row gets the onehot term (a scatter with no two writes to one
    address)."""
    local, hit = _local_ids(targets, lo, logits.shape[-1])
    grad = torch.sub(logits, lse[..., None]).exp_().mul_(-g[..., None])
    idx = local[..., None]
    own = grad.gather(-1, idx) + torch.where(hit, g, 0.0)[..., None]
    return grad.scatter_(-1, idx, own)


def _ll(t, m, s):
    """ll from the merged target logit, max and sum: log_softmax's
    (l - m) - log Σ."""
    return (t - m) - torch.log(s)


# ---------------------------------------------------- shards held here

def _bounds(v: int, n: int):
    """The column ranges of ``n`` equal shards of ``v``."""
    if v % n:
        raise ValueError(f"a vocab of {v} does not split into {n} shards")
    w = v // n
    return [(a, a + w) for a in range(0, v, w)]


def embed_split(table, ids, n: int):
    """The lookup with the table cut into ``n`` vocab shards here: the
    shards' f32 rows summed in order, cast once to the table's dtype."""
    out = None
    for a, b in _bounds(table.shape[0], n):
        rows = embed_shard(table[a:b], ids, a)
        out = rows if out is None else out + rows
    return out.to(table.dtype)


# ------------------------------------------------------ the autograd form

class VocabLL(torch.autograd.Function):
    """Per-token log-likelihood of f32 logits split over the vocab: all
    ``shards`` of ``logits`` here (``groups`` None), or this rank's shard,
    its vocab from ``lo``, merged over ``groups``. The forward saves
    (logits, targets, m + log Σ); the backward runs ``ll_grad`` on each
    shard."""

    @staticmethod
    def forward(ctx, logits, targets, shards, groups, lo):
        if groups is None:
            parts = [(logits[..., a:b], a)
                     for a, b in _bounds(logits.shape[-1], shards)]
            m = functools.reduce(torch.maximum,
                                 [ll_max(l) for l, _ in parts])
            s = sum(ll_sumexp(l, m) for l, _ in parts)
            t = sum(ll_target(l, targets, a) for l, a in parts)
        else:
            m = all_reduce_over(ll_max(logits), "max", groups)
            s = all_reduce_over(ll_sumexp(logits, m), "sum", groups)
            t = all_reduce_over(ll_target(logits, targets, lo), "sum", groups)
        ctx.save_for_backward(logits, targets, m + torch.log(s))
        ctx.args = (shards, groups, lo)
        return _ll(t, m, s)

    @staticmethod
    def backward(ctx, g):
        logits, targets, lse = ctx.saved_tensors
        shards, groups, lo = ctx.args
        if groups is not None:
            return ll_grad(logits, targets, lo, lse, g), None, None, None, None
        grad = torch.empty_like(logits)
        for a, b in _bounds(logits.shape[-1], shards):
            grad[..., a:b] = ll_grad(logits[..., a:b], targets, a, lse, g)
        return grad, None, None, None, None


def token_ll_split(logits, targets, n: int):
    """(..., V) f32 logits, (...) ids -> (...) log-likelihoods, the vocab in
    ``n`` shards held here (differentiable)."""
    return VocabLL.apply(logits.float(), targets, n, None, 0)


# -------------------------------------------------------- under a mesh

def vocab_groups(x, dim: int = 0):
    """The (process group, index) of each mesh dim that splits dim ``dim``
    of the DTensor ``x`` over more than one rank (a one-rank dim is
    ``Replicate``), or [] for a tensor that is not so split."""
    if not isinstance(x, DTensor) or current_mesh_rules()[0] is None:
        return []
    return shard_groups(x.placements, dim % x.dim())


def _rows_over(ids, groups_dims):
    """``ids`` as a DTensor laid out by ("batch", "seq"), which replicate it
    over the vocab's mesh dims (the rules' ``"seq": ()``): a plain tensor
    is taken as replicated, a DTensor split over those dims is refused, not
    gathered."""
    mesh, _ = current_mesh_rules()
    if not isinstance(ids, DTensor):
        ids = DTensor.from_local(ids, mesh, replicated(mesh), run_check=False)
    if any(not ids.placements[d].is_replicate() for d in groups_dims):
        raise ValueError(f"vocab-parallel: ids {ids.placements} are split "
                         "over the vocab's mesh dims")
    rows = current_placements(ids.shape, "batch", "seq")
    assert all(rows[d].is_replicate() for d in groups_dims), rows
    return ids, rows


def embed(table, ids):
    """The lookup of ``ids`` in a DTensor table split over the vocab
    (``vocab_groups(table)`` not empty), under ``use_rules``: each rank's
    f32 rows (``embed_shard``) summed over the vocab's mesh dims, laid out
    as ("batch", "seq", "d_model"), cast once to the table's dtype. The
    table's gradient keeps its vocab shards (each rank's own rows); over a
    mesh dim that splits the rows it is a partial sum."""
    mesh, _ = current_mesh_rules()
    groups = vocab_groups(table, 0)
    dims = [i for i, p in enumerate(table.placements) if p.is_shard(0)]
    ids, rows = _rows_over(ids, dims)
    lo = shard_offset(groups, table.to_local().shape[0])
    out = [Partial() if i in dims else p for i, p in enumerate(rows)]
    grad = tuple(Partial() if r.is_shard() and p.is_replicate() else p
                 for p, r in zip(table.placements, rows))
    x = local_map(lambda t, i: embed_shard(t, i, lo), out_placements=out,
                  in_placements=(table.placements, rows),
                  in_grad_placements=(grad, rows), device_mesh=mesh,
                  redistribute_inputs=True)(table, ids)
    return constrain(x, "batch", "seq", "d_model").to(table.dtype)


def token_ll(logits, targets):
    """Per-token log-likelihoods of DTensor logits (B, S, V) split over the
    vocab (``vocab_groups(logits, -1)`` not empty), laid out by ("batch",
    "seq", "vocab"), under ``use_rules``: ``VocabLL`` on each rank's
    shard, merged over the vocab's mesh dims. Laid out as ("batch",
    "seq")."""
    mesh, _ = current_mesh_rules()
    vp = current_placements(logits.shape, "batch", "seq", "vocab")
    dims = [i for i, p in enumerate(vp) if p.is_shard(2)]
    groups = shard_groups(vp, 2)
    targets, rows = _rows_over(targets, dims)
    v_loc = logits.shape[-1]
    for d in dims:
        v_loc //= mesh.size(d)
    lo = shard_offset(groups, v_loc)
    return local_map(
        lambda l, t: VocabLL.apply(l.float(), t, 1, groups, lo),
        out_placements=list(rows), in_placements=(vp, rows),
        device_mesh=mesh, redistribute_inputs=True)(logits, targets)

