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
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.models.params import ParamSpec, tree_map_specs
from repro_torch.utils import (tree_leaves, tree_leaves_like, tree_map,
                               tree_unflatten)


@dataclasses.dataclass(frozen=True)
class Optimizer:
    name: str
    spec: Callable          # param_spec_tree -> opt_state_spec_tree
    init: Callable          # params -> opt_state
    update: Callable        # (grads, opt_state, params, step) -> (params, opt_state)


def _global_norm(tree):
    """f32 scalar tensor: the l2 norm over every leaf."""
    return torch.sqrt(sum(torch.sum(torch.square(l.float()))
                          for l in tree_leaves(tree)))


def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled to a global norm of at most ``max_norm``, in their own
    dtypes; the norm before clipping, an f32 scalar tensor)."""
    norm = _global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), grads), norm


def _step_f32(step, device):
    """(step + 1) as an f32 scalar tensor: the reference's ``t``."""
    return torch.as_tensor(step, device=device).to(torch.float32) + 1.0


def _apply(one, grads, state, params):
    """``one(g, s, p) -> (new p, new s)`` over the parameter leaves."""
    out = [one(g, s, p) for g, s, p in zip(tree_leaves_like(grads, params),
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

        def one(g, s, p):
            g32 = g.float()
            m = b1 * s["m"] + (1 - b1) * g32
            v = b2 * s["v"] + (1 - b2) * torch.square(g32)
            u = (m / c1) / (torch.sqrt(v / c2) + eps)
            if weight_decay:
                u = u + weight_decay * p.float()
            return (p.float() - lr * u).to(p.dtype), {"m": m, "v": v}

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

        def one(g, s, p):
            g32 = g.float()
            g2 = torch.square(g32) + eps
            if "vr" in s:
                vr = beta * s["vr"] + (1 - beta) * g2.mean(dim=-1)
                vc = beta * s["vc"] + (1 - beta) * g2.mean(dim=-2)
                rfac = torch.rsqrt(
                    vr / torch.clamp(vr.mean(dim=-1, keepdim=True), min=eps)
                    + eps)
                cfac = torch.rsqrt(vc + eps)
                u = g32 * rfac[..., None] * cfac[..., None, :]
                new_s = {"vr": vr, "vc": vc}
            else:
                v = beta * s["v"] + (1 - beta) * g2
                u = g32 * torch.rsqrt(v + eps)
                new_s = {"v": v}
            rms_u = torch.sqrt(torch.mean(torch.square(u)) + 1e-30)
            u = u / torch.clamp(rms_u / clip_threshold, min=1.0)
            return (p.float() - lr * u).to(p.dtype), new_s

        return _apply(one, grads, state, params)

    return Optimizer("adafactor", spec, init, update)


def get_optimizer(name: str, lr: float = 1e-3) -> Optimizer:
    if name == "adamw":
        return adamw(lr=lr)
    if name == "adafactor":
        return adafactor(lr=lr)
    raise ValueError(name)
