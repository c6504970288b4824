"""Spec-first parameters (port of ``repro.models.params``).

Models are described as trees (dicts and tuples) of :class:`ParamSpec`, with
the reference's keys and einsum layouts, so a tree of tensors made here and a
JAX tree made by ``repro`` line up leaf for leaf:

* ``materialize(spec, gen)``     -> real tensors, drawn from a torch.Generator
* ``from_numpy_tree(tree, dev)`` -> the JAX package's weights as tensors,
  bit-exact (the weight bridge the parity tests use)
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch.utils import tree_map


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: tuple
    axes: tuple                  # logical axis name (or None) per dim
    dtype: torch.dtype = torch.bfloat16
    init: str = "normal"         # normal|zeros|ones|embed
    scale: float = 1.0           # stddev multiplier / fan-in override

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} vs axes {self.axes}")


def _map_specs(fn, tree):
    if isinstance(tree, ParamSpec):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map_specs(fn, v) for k, v in tree.items()}
    return tuple(_map_specs(fn, v) for v in tree)


def stack_specs(tree, n: int, axis_name=None):
    """Add a leading stacked-layer dim of size ``n`` to every spec."""
    return _map_specs(
        lambda s: ParamSpec((n,) + tuple(s.shape), (axis_name,) + tuple(s.axes),
                            s.dtype, s.init, s.scale), tree)


def materialize(tree, gen: torch.Generator):
    """Initialize real tensors from a spec tree, on ``gen``'s device, with
    the reference's rules: truncated normal (±2σ) at scale/sqrt(fan_in),
    ``embed`` normal at ``scale``, ``zeros`` and ``ones``. The draws are
    torch's, not jax.random's: bridge weights with from_numpy_tree to
    compare with the JAX package."""
    dev = gen.device

    def make(spec: ParamSpec):
        shape = tuple(spec.shape)
        if spec.init == "zeros":
            return torch.zeros(shape, dtype=spec.dtype, device=dev)
        if spec.init == "ones":
            return torch.ones(shape, dtype=spec.dtype, device=dev)
        x = torch.empty(shape, dtype=torch.float32, device=dev)
        if spec.init == "embed":
            x.normal_(0.0, spec.scale, generator=gen)
        else:
            fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
            std = spec.scale / math.sqrt(max(fan_in, 1))
            torch.nn.init.trunc_normal_(x, 0.0, 1.0, -2.0, 2.0, generator=gen)
            x.mul_(std)
        return x.to(spec.dtype)

    return _map_specs(make, tree)


def _leaf_specs(tree):
    if isinstance(tree, ParamSpec):
        return [tree]
    vals = tree.values() if isinstance(tree, dict) else tree
    return [s for v in vals for s in _leaf_specs(v)]


def param_count(tree) -> int:
    return sum(math.prod(s.shape) for s in _leaf_specs(tree))


def param_bytes(tree) -> int:
    return sum(math.prod(s.shape) * s.dtype.itemsize for s in _leaf_specs(tree))


def _from_numpy(a, device) -> torch.Tensor:
    a = np.array(a, copy=True)            # writable, contiguous
    if a.dtype.name == "bfloat16":        # ml_dtypes.bfloat16: no torch mapping
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def from_numpy_tree(tree, device):
    """The same tree with each numpy array (e.g. ``jax.tree.map(np.asarray,
    params)``) as a tensor on ``device``, bit for bit (bf16 crosses as its
    raw 16 bits)."""
    return tree_map(lambda a: _from_numpy(a, device), tree)
