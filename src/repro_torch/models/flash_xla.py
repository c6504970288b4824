"""Segment-parallel flash attention (port of the combine-once context path
of ``repro.models.flash_xla``: ``_seg_fwd`` and ``_make_seg_flash``).

The keys and values are cut into ``segments`` equal segments along the
sequence. Segment r (keys from position k0 = r·S_loc) gives a partial
output and its rows' log-sum-exp from one call of the attention kernel with
that key offset (``kernels/flash_attention.py``); the partials are merged
once, by lse (``kernels/ops.py::merge``):

    lse_tot = logsumexp_r lse_r,   out = Σ_r exp(lse_r - lse_tot) · out_r.

A row that sees no key of a segment has lse_r ~ NEG_INF there and merges
with weight 0 (no NaN). The backward (:class:`SegmentFlash`) runs the
attention backward kernel per segment against the merged out and lse_tot,
as the reference's ``bwd`` does with the global ``lse`` and ``delta``:
each segment's dk and dv are its own, and dq is the sum of the segments'
parts, taken in f32 and cast once.

The segments are all held by one process (the CPU tests, and the card's
checks, which loop over them) or one a rank of the model axis (context
mode under a mesh: ``kernels/ops.py::on_kv_segments`` lays the shards
out, the ranks merge over their process groups, ``ops.merge_over``, and
the backward all-reduces dq's f32 parts over the same groups).

Layout: the model's, q (B, Sq, H, D), k and v (B, Skv, K, D); lse (B, H,
Sq) f32. The reference's ``chunk`` (its XLA key-chunk width) and
``kv_dim_is_heads`` (its sharding labels) have no counterpart: the kernel
tiles the keys itself and never takes expanded K/V in context mode.
"""
from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor

from repro_torch.distributed.sharding import all_reduce_over, shard_offset
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import ops

NEG_INF = _fa.NEG_INF


def segmented(skv: int, segments: int) -> bool:
    """The reference's condition for the segment path
    (``flash_attention_xla``): more than one segment, each a whole number of
    keys, at least 16 of them."""
    return segments > 1 and skv % segments == 0 and skv // segments >= 16


def _forward(q, k, v, causal, window, cap, segments, groups):
    """(out in q's dtype, lse_tot): all ``segments`` segments of k, v here
    (``groups`` None), or this rank's segment merged over ``groups``."""
    if groups is None:
        s_loc = k.shape[1] // segments
        parts = [_fa._forward(q, k[:, a:a + s_loc], v[:, a:a + s_loc], causal,
                              window, cap, True, k0=a)
                 for a in range(0, k.shape[1], s_loc)]
        out, lse = ops.merge([o for o, _ in parts], [l for _, l in parts])
    else:
        out, lse = _fa._forward(q, k, v, causal, window, cap, True,
                                k0=shard_offset(groups, k.shape[1]))
        out, lse = ops.merge_over(out, lse, groups)
    return out.to(q.dtype), lse


class SegmentFlash(torch.autograd.Function):
    """Segment-parallel attention with the flash backward: the forward saves
    (q, k, v, merged out, lse_tot); the backward runs each segment's
    attention backward against them and sums the segments' dq in f32. With
    ``groups`` (one segment a rank) that sum is an all-reduce over them, so
    every rank holds the whole dq, as q is replicated over them."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, cap, segments, groups):
        out, lse = _forward(q, k, v, causal, window, cap, segments, groups)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (causal, window, cap, segments, groups)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        causal, window, cap, segments, groups = ctx.args
        kw = dict(causal=causal, window=window, cap=cap)
        if groups is not None:
            dq, dk, dv = _fa.flash_attention_bwd(
                q, k, v, out, lse, dout,
                k0=shard_offset(groups, k.shape[1]), **kw)
            dq = all_reduce_over(dq.float(), "sum", groups)
            return dq.to(q.dtype), dk, dv, None, None, None, None, None
        s_loc = k.shape[1] // segments
        dq, dks, dvs = None, [], []
        for a in range(0, k.shape[1], s_loc):
            dq_r, dk, dv = _fa.flash_attention_bwd(
                q, k[:, a:a + s_loc], v[:, a:a + s_loc], out, lse, dout, k0=a,
                **kw)
            dq = dq_r.float() if dq is None else dq + dq_r.float()
            dks.append(dk)
            dvs.append(dv)
        return (dq.to(q.dtype), torch.cat(dks, dim=1), torch.cat(dvs, dim=1),
                None, None, None, None, None)


def seg_flash(q, k, v, *, causal: bool, window: int = 0, cap: float = 0.0,
              segments: int, groups=None):
    """Segment-parallel attention: all ``segments`` segments of k, v in this
    process, or (``groups``: a list of (process group, this rank's index))
    this rank's segment, merged across the groups. Differentiable through
    :class:`SegmentFlash` when grad is enabled and an input requires it."""
    args = (bool(causal), int(window), float(cap), int(segments), groups)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return SegmentFlash.apply(q, k, v, *args)
    return _forward(q, k, v, *args)[0]


def flash_attention_xla(q, k, v, *, causal: bool, window: int = 0,
                        cap: float = 0.0, segments: int = 0):
    """q (B,Sq,H,D); k, v (B,Skv,K,D) -> (B,Sq,H,D): the segment path where
    :func:`segmented` holds (the reference's condition), one segment a rank
    of the model axis on DTensors, all of them here otherwise; else the
    whole-sequence kernel (``kernels/ops.py::flash_attention``)."""
    kw = dict(causal=causal, window=window, cap=cap)
    if not segmented(k.shape[1], segments):
        return ops.flash_attention(q, k, v, **kw)
    if isinstance(q, DTensor):
        return ops.on_kv_segments(
            lambda q, k, v, groups: seg_flash(
                q, k, v, segments=segments, groups=groups, **kw), q, k, v)
    return seg_flash(q, k, v, segments=segments, **kw)
