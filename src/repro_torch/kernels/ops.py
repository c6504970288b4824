"""Model-layout wrappers over the kernels (port of ``repro.kernels.ops``).

They take the model's tensors (B, S, H/K, D) and hand the kernels views,
never transposed or GQA-repeated copies: the kernels read them through
their strides.

Under a mesh (``distributed.sharding.use_rules``) the model's tensors are
DTensors. Each wrapper then runs its function on the local shards through
``local_map``, with the placements the current rules give: attention
sharded over heads (kv heads for K/V), the SSD scan over ``ssm_hd`` (the
scan is exact per P column), the batch over the data axes. Each local call
dispatches as a plain call does: the CUDA kernel on a CUDA shard, the plain
version on a CPU shard.

Context mode (the query heads do not divide the model axis) shards K/V,
and the decode cache, over the sequence, as the reference does:

* ``flash_attention`` gathers sequence-sharded K/V for the local call.
  ``models/flash_xla.py`` takes the reference's segment-parallel path
  instead where it applies, through ``on_kv_segments``: each rank runs its
  function on its own segment of K/V, q replicated over those mesh dims;
* ``flash_decode`` never gathers the cache: each rank runs the kernel on
  its own slots (its ``seq_kv`` shard, with its slots' positions) with the
  rows' lse, and the ranks merge as the kernel merges its cluster's splits
  (``merge_over``).

The merge by lse of partial attentions is written once here, over
partials held by one process (``merge``) or one partial a rank over
process groups (``merge_over``):

    lse_tot = logsumexp_r lse_r,   out = sum_r exp(lse_r - lse_tot) * out_r.

A row that sees no key of a part has lse_r ~ NEG_INF there and merges with
weight 0 (no NaN).
"""
from __future__ import annotations

import torch
import torch.distributed._functional_collectives as funcol
from torch.distributed.tensor import DTensor, Partial
from torch.distributed.tensor.experimental import local_map

from repro_torch.distributed.sharding import (current_mesh_rules,
                                              current_placements,
                                              shard_groups, shard_offset)
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import flash_decode as _fd
from repro_torch.kernels import ssd_scan as _ssd

HEADS = ("batch", "seq", "heads", "head_dim")
KV = ("batch", "seq", "kv_heads", "head_dim")


def _meshed(x) -> bool:
    """Whether ``x`` is a DTensor to run on its local shards. A DTensor
    outside ``use_rules`` has no layout for the local call: raise."""
    if not isinstance(x, DTensor):
        return False
    if current_mesh_rules()[0] is None:
        raise ValueError("kernels.ops: a DTensor argument outside use_rules")
    return True


def _kv_axes(q, k):
    """K/V's axes for the local call: their own heads when GQA groups them,
    the query's when they were expanded to one head per query head. The
    sequence is not sharded (a sharded one is gathered)."""
    return HEADS if k.shape[2] == q.shape[2] else KV


def _local(fn, out_placements, args, in_placements):
    """``fn(*args)`` on the local shards. ``out_placements`` holds one
    placement tuple per output, ``in_placements`` one per argument.

    An argument replicated over a mesh dim that splits the first output
    (the SSD scan's dt, a, B and C beside x sharded over P; ``a`` beside
    the batch) gets only this rank's part of its gradient: its gradient is
    Partial there."""
    mesh, _ = current_mesh_rules()
    split = [p.is_shard() for p in out_placements[0]]
    grads = tuple(tuple(Partial() if s and p.is_replicate() else p
                        for s, p in zip(split, pl)) for pl in in_placements)
    if len(out_placements) == 1:      # local_map's form for one output
        out_placements = list(out_placements[0])
    return local_map(fn, out_placements=out_placements,
                     in_placements=in_placements, in_grad_placements=grads,
                     device_mesh=mesh, redistribute_inputs=True)(*args)


def _rows(w, out):
    """Weights of lse's shape (B, H, Sq) or (B, H) broadcast against out
    (B, Sq, H, D) or (B, H, D)."""
    return (w.transpose(1, 2) if out.dim() == 4 else w)[..., None]


def merge_weights(lses):
    """(weights exp(lse_r - lse_tot), lse_tot) of stacked lses (n, ...)."""
    lse_tot = torch.logsumexp(lses, dim=0)
    return torch.exp(lses - lse_tot), lse_tot


def merge(outs, lses):
    """(out f32, lse_tot) of partials held here: outs[r] (B, Sq, H, D) or
    (B, H, D), lses[r] their rows' lse, summed in order in f32."""
    w, lse_tot = merge_weights(torch.stack(lses))
    out = _rows(w[0], outs[0]) * outs[0].float()
    for r in range(1, len(outs)):
        out = out + _rows(w[r], outs[r]) * outs[r].float()
    return out, lse_tot


def merge_over(out, lse, groups):
    """(out f32, lse_tot) of one partial a rank, over the ranks of each
    (process group, this rank's index in it) of ``groups`` in turn (the
    merge is associative: two mesh dims merge one after the other): the
    lses are gathered, the weighted outputs summed by an all-reduce."""
    out = out.float()
    for group, index in groups:
        lses = funcol.all_gather_tensor(lse.contiguous()[None], 0, group)
        w, lse = merge_weights(lses)
        part = _rows(w[index], out) * out
        del out                     # not held beside the sum
        out = funcol.all_reduce(part, "sum", group)
    return out, lse.contiguous()


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    cap: float = 0.0):
    """q (B,Sq,H,D); k,v (B,Skv,K,D) with H = K*G -> (B,Sq,H,D). Under
    grad, with an input that requires it, this is the FlashAttention
    autograd.Function (the kernels' backward on the card)."""
    def run(q, k, v):
        return _fa.flash_attention(q, k, v, causal=causal, window=window,
                                   cap=cap)

    if not _meshed(q):
        return run(q, k, v)
    qp = current_placements(q.shape, *HEADS)
    kvp = current_placements(k.shape, *_kv_axes(q, k))
    return _local(run, (qp,), (q, k, v), (qp, kvp, kvp))


def on_kv_segments(fn, q, k, v):
    """``fn(q, k, v, groups)`` on the local shards, K/V keeping their
    ``kv_seg`` placement (this rank's segment of the keys), q replicated
    over the mesh dims that split them; ``groups`` holds (process group,
    this rank's index) of each such dim. q's gradient takes q's placement:
    ``fn``'s backward sums dq over the groups itself."""
    qp = current_placements(q.shape, *HEADS)
    kvp = current_placements(k.shape, "batch", "kv_seg", "kv_heads",
                             "head_dim")
    groups = shard_groups(kvp, 1)
    return _local(lambda q, k, v: fn(q, k, v, groups), (qp,), (q, k, v),
                  (qp, kvp, kvp))


def flash_decode(q, k, v, kpos, cur_index, *, window: int = 0,
                 cap: float = 0.0):
    """q (B,1,H,D); k,v (B,S,K,D); kpos (S,) int32 -> (B,1,H,D). A cache
    sharded over its slots (context mode) is not gathered: each rank takes
    its own slots and the ranks merge by lse."""
    kw = dict(window=window, cap=cap)

    def run(q, k, v):
        return _fd.flash_decode(q[:, 0], k, v, kpos, cur_index, **kw)[:, None]

    if not _meshed(q):
        return run(q, k, v)
    if isinstance(kpos, DTensor):
        kpos = kpos.full_tensor()
    qp = current_placements(q.shape, *HEADS)
    kvp = current_placements(k.shape, "batch", "seq_kv", "kv_heads",
                             "head_dim")
    groups = shard_groups(kvp, 1)
    if not groups:
        kvp = current_placements(k.shape, *_kv_axes(q, k))
        return _local(run, (qp,), (q, k, v), (qp, kvp, kvp))

    def split(q, k, v):
        n = k.shape[1]
        a = shard_offset(groups, n)
        out, lse = _fd.flash_decode(q[:, 0], k, v, kpos[a:a + n], cur_index,
                                    return_lse=True, **kw)
        return merge_over(out, lse, groups)[0].to(q.dtype)[:, None]

    return _local(split, (qp,), (q, k, v), (qp, kvp, kvp))


def ssd(x, dt, a, bmat, cmat, *, chunk: int = 128):
    """Model layout: x (B,L,H,P); dt (B,L,H); a (H,); b/c (B,L,N).

    Returns (y (B,L,H,P), state (B,H,P,N)). Under grad, with an input that
    requires it, this is the SSDScan autograd.Function: differentiable on
    the card, its backward the hand-written kernel ``ssd_scan_bwd``."""
    def run(x, dt, a, bmat, cmat):
        return _ssd.ssd_scan(x, dt, a, bmat, cmat, chunk=chunk)

    if not _meshed(x):
        return run(x, dt, a, bmat, cmat)
    B, _, H, P = x.shape
    xp = current_placements(x.shape, "batch", "seq", "ssm_heads", "ssm_hd")
    rows = current_placements(dt.shape, "batch", "seq", "ssm_heads")
    bp = current_placements(bmat.shape, "batch", "seq", "ssm_state")
    ap = current_placements(a.shape, "ssm_heads")
    state = current_placements((B, H, P, bmat.shape[-1]), "batch",
                               "ssm_heads", "ssm_hd", "ssm_state")
    return _local(run, (xp, state), (x, dt, a, bmat, cmat),
                  (xp, rows, ap, bp, bp))
