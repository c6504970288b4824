"""Helpers the configuration adapters share: seeded weight trees in a
spec's layout, host copies as the engine keeps them, input pools, and the
profile seeding of identical replicas.

An adapter (``configs/<config>.py``) exposes ``build(sizes, cell, seed,
device, tiny, reuse)`` returning a deployment with:

``engines``        model id -> ``TorchModel`` (the served models, in order)
``buckets``        the batch buckets the scheduler may pick
``last_input``     (first pool row, bucket) of the input the last
                   ``make_input`` made: row i of the batch is pool row
                   first + i
``flops_per_row()``            useful FLOPs of one request
``kernel_work(bucket)``        {kernel name part: (bytes, FLOPs)} of the
                               port's kernels in one INFER
``port_kernels_per_infer()``   {kernel name part: launches per INFER}
``compare(samples, precision)`` yields (samples, program rows,
                               reference rows) in float32 blocks, after
                               ``release()``
``release()``      drops the program's state (engines, device weights)
"""
from __future__ import annotations

import random
from typing import Callable, List, Tuple

import torch

from perfbench.harness import weights as wt
from repro_torch.models.params import ParamSpec
from repro_torch.utils import tree_leaves, tree_unflatten


def spec_paths(tree, prefix=()) -> List[Tuple[tuple, ParamSpec]]:
    """(path, spec) of every leaf of a spec tree, in ``tree_leaves``
    order; a path holds dict keys and tuple indices."""
    if isinstance(tree, ParamSpec):
        return [(prefix, tree)]
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    return [x for k, v in items for x in spec_paths(v, prefix + (k,))]


def draw_tree(spec, recipe: Callable[[tuple, ParamSpec], Tuple[float, float]],
              seed: int, device, *stream: int):
    """A tensor tree in ``spec``'s layout and dtype: each leaf mean + std ·
    N(0, 1) cut at ±2, with (std, mean) = ``recipe(path, leaf_spec)``,
    from one draw of the (seed, stream) generator."""
    leaves = spec_paths(spec)
    dtypes = {s.dtype for _, s in leaves}
    if len(dtypes) != 1:
        raise ValueError(f"a spec of one dtype expected, got {dtypes}")
    shapes = [(tuple(s.shape), *recipe(p, s)) for p, s in leaves]
    return tree_unflatten(spec, wt.draw(shapes, seed, device, dtypes.pop(),
                                        *stream))


def host_copy(tree, device: torch.device):
    """The tree in host memory as ``TorchModel`` keeps it: pinned when the
    engine's device is a card."""
    def one(t):
        t = t.to("cpu")
        return t.pin_memory() if device.type == "cuda" else t.clone()
    return tree_unflatten(tree, [one(t) for t in tree_leaves(tree)])


def seed_replicas(first, others) -> None:
    """Build the kernels of every bucket and measure the INFER and LOAD
    profiles on ``first`` (``compile``, ``warmup``, ``measure_load``);
    hand the same profiles to ``others`` through ``apply_profile``, the
    engine's path for profiles that were measured elsewhere."""
    first.compile()
    first.warmup()
    first.measure_load(reps=2)
    entries = {(t, b): d for (t, _, b), d in first.seed_profiles().items()}
    for tm in others:
        tm.apply_profile(entries)


class Slices:
    """Draws the start of each batch's slice of an input pool from a
    seeded generator: batch b reads pool rows [start, start + b)."""

    def __init__(self, pool_rows: int, seed: int):
        self.rows = pool_rows
        self.rng = random.Random(wt.mix(seed, 2))

    def start(self, b: int) -> int:
        if b > self.rows:
            raise ValueError(f"bucket {b} > input pool of {self.rows}")
        return self.rng.randrange(self.rows - b + 1)


BLOCK_ROWS = 64           # rows the reference computes at a time


def blocks(samples):
    """(model index, up to BLOCK_ROWS samples of that model) in order."""
    by_model = {}
    for s in samples:
        by_model.setdefault(s.index, []).append(s)
    for index, group in sorted(by_model.items()):
        for i in range(0, len(group), BLOCK_ROWS):
            yield index, group[i:i + BLOCK_ROWS]
