"""Small shared helpers (port of ``repro.utils``)."""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def tree_leaves(tree: Any) -> list:
    """Tensors of a nested dict/tuple/list tree, in insertion order."""
    if isinstance(tree, dict):
        return [l for v in tree.values() for l in tree_leaves(v)]
    if isinstance(tree, (tuple, list)):
        return [l for v in tree for l in tree_leaves(v)]
    return [tree]


def tree_map(fn, tree: Any):
    """Apply ``fn`` to every leaf of a nested dict/tuple/list tree."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(tree_map(fn, v) for v in tree)
    if isinstance(tree, list):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def tree_bytes(tree: Any) -> int:
    """Total bytes of a tree of tensors."""
    return sum(t.nelement() * t.element_size() for t in tree_leaves(tree))


def human_bytes(n: float) -> str:
    for unit in ("B", "KB", "MB", "GB", "TB", "PB"):
        if abs(n) < 1024.0:
            return f"{n:.2f}{unit}"
        n /= 1024.0
    return f"{n:.2f}EB"


@dataclasses.dataclass(frozen=True)
class HardwareSpec:
    """Roofline constants for the target card."""

    name: str
    peak_bf16_flops: float   # FLOP/s, dense tensor cores
    hbm_bandwidth: float     # bytes/s
    hbm_capacity: float      # bytes


# NVIDIA H100 SXM data sheet (dense bf16, HBM3), at the 700 W power limit.
H100 = HardwareSpec(name="h100-sxm", peak_bf16_flops=989e12,
                    hbm_bandwidth=3.35e12, hbm_capacity=80e9)


def percentile(xs, q: float) -> float:
    if not len(xs):
        return float("nan")
    return float(np.percentile(np.asarray(xs, dtype=np.float64), q))


def welford_summary(xs) -> dict:
    a = np.asarray(xs, dtype=np.float64)
    if a.size == 0:
        return {"n": 0}
    return {
        "n": int(a.size),
        "mean": float(a.mean()),
        "p50": float(np.percentile(a, 50)),
        "p99": float(np.percentile(a, 99)),
        "p99.9": float(np.percentile(a, 99.9)),
        "max": float(a.max()),
        "min": float(a.min()),
    }


def resolve_device(device) -> torch.device:
    """The device an entry point runs on. CUDA is the default and is never
    swapped for the CPU: asking for it without a card raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' was asked for but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain PyTorch path")
    return dev
