"""Optimizers (port of ``repro.training.optimizer``): AdamW (small models)
and Adafactor (large models: factored second moments keep the optimizer
state small).

The state is the reference's tree: one dict per parameter leaf, ``{"m",
"v"}`` for AdamW and ``{"vr", "vc"}`` (factored) or ``{"v"}`` for
Adafactor, all f32, so a state crosses between the packages by
``models.params.from_numpy_tree`` or a checkpoint. ``spec`` maps a
``ParamSpec`` tree to the state's spec tree, as parameters are spec-first.
The arithmetic is the reference's, in f32, with the same bias correction
(``(step + 1)`` in f32) and update clipping. ``update`` is functional: it
returns new trees and leaves its arguments as they were.

On DTensors (the sharded step), each gradient comes laid out as its
parameter and each state leaf by its spec. The updates run on the local
shards, and every reduction over a dim that the mesh splits (the global
norm, Adafactor's factored means and the RMS of its update) sums the local
shard and all-reduces the small result, a scalar or a ``vr``/``vc`` row,
over the dim's process groups: nothing of a weight's size moves, as in the
reference's partitioned program. On a plain tensor, or where no mesh dim of
more than one rank splits a leaf, the arithmetic is the plain one.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.distributed.sharding import all_reduce_over
from repro_torch.models.params import ParamSpec, tree_map_specs
from repro_torch.utils import (tree_leaves, tree_leaves_like, tree_map,
                               tree_unflatten)


@dataclasses.dataclass(frozen=True)
class Optimizer:
    name: str
    spec: Callable          # param_spec_tree -> opt_state_spec_tree
    init: Callable          # params -> opt_state
    update: Callable        # (grads, opt_state, params, step) -> (params, opt_state)


class _Split:
    """How one parameter (or gradient) is split over its mesh: for a plain
    tensor, nowhere. ``local`` and ``wrap`` move between a DTensor and its
    local shard; ``mean`` and ``mean_all`` reduce a local shard and, where a
    mesh dim splits the dim reduced, all-reduce the small result over that
    mesh dim's process group and divide by the global size."""

    def __init__(self, p):
        self.shape = tuple(p.shape)
        dt = isinstance(p, DTensor)
        self.mesh = p.device_mesh if dt else None
        self.placements = tuple(p.placements) if dt else ()

    def mesh_dims(self, *dims) -> list:
        """The mesh dims that split one of the parameter's ``dims``."""
        nd = len(self.shape)
        want = {d % nd for d in dims}
        return [i for i, pl in enumerate(self.placements)
                if pl.is_shard() and pl.dim % nd in want]

    def _groups(self, *dims) -> list:
        return [(self.mesh.get_group(i), None)
                for i in self.mesh_dims(*dims)]

    def placements_for(self, kept) -> tuple:
        """The placements of a tensor that keeps the parameter's dims
        ``kept`` (its dim j is the parameter's ``kept[j]``) and reduces the
        others: a mesh dim that split a kept dim splits it there."""
        nd = len(self.shape)
        out = []
        for pl in self.placements:
            d = pl.dim % nd if pl.is_shard() else None
            out.append(Shard(kept.index(d)) if d in kept else Replicate())
        return tuple(out)

    def local(self, x, placements=None):
        """``x``'s local shard, laid out as ``placements`` (default the
        parameter's) first if it is not."""
        if not isinstance(x, DTensor):
            return x
        pl = self.placements if placements is None else placements
        if tuple(x.placements) != pl:
            x = x.redistribute(self.mesh, pl)
        return x.to_local()

    def wrap(self, x, like=None, placements=None):
        """A local result as a DTensor laid out as ``placements`` (default
        the parameter's), then as ``like`` is if that differs; a plain
        tensor where the parameter is one."""
        if self.mesh is None:
            return x
        pl = self.placements if placements is None else placements
        out = DTensor.from_local(x, self.mesh, pl, run_check=False)
        if like is not None and tuple(like.placements) != pl:
            out = out.redistribute(self.mesh, like.placements)
        return out

    def mean(self, x, dim: int, pdim: int, keepdim: bool = False):
        """``x.mean(dim)``, where ``x``'s dim ``dim`` is the parameter's
        dim ``pdim``."""
        groups = self._groups(pdim)
        if not groups:
            return x.mean(dim=dim, keepdim=keepdim)
        return (all_reduce_over(x.sum(dim=dim, keepdim=keepdim), "sum",
                                groups) / self.shape[pdim])

    def mean_all(self, x):
        """``torch.mean(x)`` over every element of the parameter."""
        groups = self._groups(*range(len(self.shape)))
        if not groups:
            return torch.mean(x)
        return (all_reduce_over(torch.sum(x), "sum", groups)
                / math.prod(self.shape))


def _on_local(fn, x):
    """``fn`` of ``x``'s local shard, laid out as ``x`` (of a plain tensor:
    ``fn(x)``)."""
    if not isinstance(x, DTensor):
        return fn(x)
    return DTensor.from_local(fn(x.to_local()), x.device_mesh, x.placements,
                              run_check=False)


def _global_norm(tree):
    """f32 scalar tensor: the l2 norm over every leaf. Each leaf's squares
    are summed over its local shard; the sums of the leaves that the same
    mesh dims split are added in leaf order and all-reduced once, a scalar,
    over those dims. Of DTensor leaves the norm is a replicated DTensor."""
    parts, split = {}, None
    for leaf in tree_leaves(tree):
        split = _Split(leaf)
        sq = torch.sum(torch.square(split.local(leaf).float()))
        key = tuple(split.mesh_dims(*range(leaf.ndim)))
        parts[key] = parts[key] + sq if key in parts else sq
    total = sum(all_reduce_over(v, "sum",
                                [(split.mesh.get_group(i), None) for i in k])
                for k, v in parts.items())
    norm = torch.sqrt(total)
    if split is None or split.mesh is None:
        return norm
    return DTensor.from_local(norm, split.mesh,
                              (Replicate(),) * split.mesh.ndim,
                              run_check=False)


def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled to a global norm of at most ``max_norm``, in their own
    dtypes and layouts; the norm before clipping, an f32 scalar tensor)."""
    norm = _global_norm(grads)
    local = norm.to_local() if isinstance(norm, DTensor) else norm
    scale = torch.clamp(max_norm / torch.clamp(local, min=1e-9), max=1.0)
    return tree_map(lambda g: _on_local(
        lambda x: (x.float() * scale).to(x.dtype), g), grads), norm


def _step_f32(step, device):
    """(step + 1) as an f32 scalar tensor: the reference's ``t``."""
    return torch.as_tensor(step, device=device).to(torch.float32) + 1.0


def _apply(one, grads, state, params):
    """``one(g, s, p, split) -> (new p, new s)`` over the parameter
    leaves, ``split`` the parameter's ``_Split``."""
    out = [one(g, s, p, _Split(p))
           for g, s, p in zip(tree_leaves_like(grads, params),
                              tree_leaves_like(state, params),
                              tree_leaves(params))]
    return (tree_unflatten(params, [o[0] for o in out]),
            tree_unflatten(params, [o[1] for o in out]))


# ------------------------------------------------------------------ AdamW

def adamw(lr: float = 1e-3, b1: float = 0.9, b2: float = 0.95,
          eps: float = 1e-8, weight_decay: float = 0.0) -> Optimizer:
    def spec(pspec_tree):
        def one(s: ParamSpec):
            f32 = ParamSpec(s.shape, s.axes, torch.float32, init="zeros")
            return {"m": f32, "v": f32}
        return tree_map_specs(one, pspec_tree)

    def init(params):
        return tree_map(lambda p: {"m": torch.zeros(p.shape, device=p.device),
                                   "v": torch.zeros(p.shape, device=p.device)},
                        params)

    def update(grads, state, params, step):
        dev = tree_leaves(params)[0].device
        t = _step_f32(step, dev)
        c1 = 1.0 - torch.tensor(b1, device=dev) ** t
        c2 = 1.0 - torch.tensor(b2, device=dev) ** t

        def one(g, s, p, split):
            # elementwise: every leaf on its local shard, no collective
            g32 = split.local(g).float()
            m = b1 * split.local(s["m"]) + (1 - b1) * g32
            v = b2 * split.local(s["v"]) + (1 - b2) * torch.square(g32)
            u = (m / c1) / (torch.sqrt(v / c2) + eps)
            p32 = split.local(p).float()
            if weight_decay:
                u = u + weight_decay * p32
            return (split.wrap((p32 - lr * u).to(p.dtype)),
                    {"m": split.wrap(m, s["m"]), "v": split.wrap(v, s["v"])})

        return _apply(one, grads, state, params)

    return Optimizer("adamw", spec, init, update)


# ---------------------------------------------------------------- Adafactor

def adafactor(lr: float = 1e-2, decay_pow: float = 0.8, eps: float = 1e-30,
              clip_threshold: float = 1.0,
              min_dim_size_to_factor: int = 128) -> Optimizer:
    def _factored(shape):
        return (len(shape) >= 2 and shape[-1] >= min_dim_size_to_factor
                and shape[-2] >= min_dim_size_to_factor)

    def spec(pspec_tree):
        def one(s: ParamSpec):
            shape, axes = tuple(s.shape), tuple(s.axes)
            if _factored(shape):
                return {
                    "vr": ParamSpec(shape[:-1], axes[:-1], torch.float32,
                                    init="zeros"),
                    "vc": ParamSpec(shape[:-2] + shape[-1:],
                                    axes[:-2] + axes[-1:], torch.float32,
                                    init="zeros"),
                }
            return {"v": ParamSpec(shape, axes, torch.float32, init="zeros")}
        return tree_map_specs(one, pspec_tree)

    def init(params):
        def one(p):
            shape = tuple(p.shape)
            if _factored(shape):
                return {"vr": torch.zeros(shape[:-1], device=p.device),
                        "vc": torch.zeros(shape[:-2] + shape[-1:],
                                          device=p.device)}
            return {"v": torch.zeros(shape, device=p.device)}
        return tree_map(one, params)

    def update(grads, state, params, step):
        dev = tree_leaves(params)[0].device
        t = _step_f32(step, dev)
        beta = 1.0 - t ** (-decay_pow)

        def one(g, s, p, split):
            g32 = split.local(g).float()
            g2 = torch.square(g32) + eps
            nd = g32.ndim
            if "vr" in s:
                # vr keeps the parameter's dims but the last, vc all but
                # the one before it; their means over a split dim are
                # all-reduced rows
                rows = split.placements_for(tuple(range(nd - 1)))
                cols = split.placements_for(tuple(range(nd - 2)) + (nd - 1,))
                vr = (beta * split.local(s["vr"], rows)
                      + (1 - beta) * split.mean(g2, -1, nd - 1))
                vc = (beta * split.local(s["vc"], cols)
                      + (1 - beta) * split.mean(g2, -2, nd - 2))
                del g2      # not held beside u: a weight-sized f32 each
                rfac = torch.rsqrt(
                    vr / torch.clamp(split.mean(vr, -1, nd - 2, keepdim=True),
                                     min=eps)
                    + eps)
                cfac = torch.rsqrt(vc + eps)
                u = g32 * rfac[..., None] * cfac[..., None, :]
                new_s = {"vr": split.wrap(vr, s["vr"], rows),
                         "vc": split.wrap(vc, s["vc"], cols)}
            else:
                v = beta * split.local(s["v"]) + (1 - beta) * g2
                del g2
                u = g32 * torch.rsqrt(v + eps)
                new_s = {"v": split.wrap(v, s["v"])}
            del g32
            rms_u = torch.sqrt(split.mean_all(torch.square(u)) + 1e-30)
            u = u / torch.clamp(rms_u / clip_threshold, min=1.0)
            return (split.wrap((split.local(p).float() - lr * u).to(p.dtype)),
                    new_s)

        return _apply(one, grads, state, params)

    return Optimizer("adafactor", spec, init, update)


def get_optimizer(name: str, lr: float = 1e-3) -> Optimizer:
    if name == "adamw":
        return adamw(lr=lr)
    if name == "adafactor":
        return adafactor(lr=lr)
    raise ValueError(name)
