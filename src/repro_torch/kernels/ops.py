"""Model-layout wrappers over the kernels (port of ``repro.kernels.ops``).

They take the model's tensors (B, S, H/K, D) and hand the kernels views,
never transposed or GQA-repeated copies: the kernels read them through
their strides.

Under a mesh (``distributed.sharding.use_rules``) the model's tensors are
DTensors. Each wrapper then runs its function on the local shards through
``local_map``, with the placements the current rules give: attention
sharded over heads (kv heads for K/V), the SSD scan over ``ssm_hd`` (the
scan is exact per P column), the batch over the data axes. K/V, or a
decode cache, sharded over the sequence (context mode) are first gathered
over it: the reference combines partial softmaxes across that dim
instead, with the same result. Each local call dispatches as a plain
call does: the CUDA kernel on a CUDA shard, the plain version on a CPU
shard.
"""
from __future__ import annotations

from torch.distributed.tensor import DTensor, Partial
from torch.distributed.tensor.experimental import local_map

from repro_torch.distributed.sharding import (current_mesh_rules,
                                              current_placements)
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
    sequence is never sharded (a sharded one is gathered)."""
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


def flash_decode(q, k, v, kpos, cur_index, *, window: int = 0,
                 cap: float = 0.0):
    """q (B,1,H,D); k,v (B,S,K,D); kpos (S,) int32 -> (B,1,H,D)."""
    def run(q, k, v):
        out = _fd.flash_decode(q[:, 0], k, v, kpos, cur_index,
                               window=window, cap=cap)
        return out[:, None]

    if not _meshed(q):
        return run(q, k, v)
    if isinstance(kpos, DTensor):
        kpos = kpos.full_tensor()
    qp = current_placements(q.shape, *HEADS)
    kvp = current_placements(k.shape, *_kv_axes(q, k))
    return _local(run, (qp,), (q, k, v), (qp, kvp, kvp))


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
