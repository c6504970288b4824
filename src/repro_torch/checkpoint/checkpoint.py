"""Atomic, resumable checkpoints (port of ``repro.checkpoint.checkpoint``).

The on-disk format is the reference's, so each package restores the
other's checkpoints: ``<dir>/step_<N>/`` holds one ``.npy`` per leaf, named
by the leaf's key path exactly as the reference's ``_flatten`` names it
from ``jax.tree.flatten_with_path`` (a dict key ``k`` is ``__k__``, a tuple
index ``i`` is ``_i_``, joined by dots), and a ``manifest.json`` with each
leaf's shape and dtype. bfloat16 is stored as its raw 16 bits (uint16) and
read back through a torch view. Writes go to a temporary directory that is
renamed into place, so a crash mid-save never leaves a partial step that
``latest_step`` would pick.

The port runs on one device, so ``restore_checkpoint`` places every leaf on
the ``device`` it is given (the reference re-shards on a mesh).
"""
from __future__ import annotations

import json
import os
import re
import shutil
import tempfile
import threading
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.utils import tree_unflatten

# numpy's names of the dtypes, as the reference's manifest writes them
_NP_DTYPES = {torch.float32: "float32", torch.bfloat16: "bfloat16",
              torch.float16: "float16", torch.int32: "int32",
              torch.int64: "int64", torch.int8: "int8", torch.bool: "bool"}


def _key(path) -> str:
    """The reference's file name for a leaf at ``path`` (dict keys and tuple
    indices): each element as jax prints its path entry, sanitised."""
    return ".".join(re.sub(r"[^A-Za-z0-9_-]", "_",
                           f"[{p!r}]" if isinstance(p, str) else f"[{p}]")
                    for p in path)


def _flatten(tree, path=()):
    """[(key, leaf)] in insertion order (the order ``tree_unflatten``
    fills); anything but a dict, tuple or list is a leaf."""
    if isinstance(tree, dict):
        return [kv for k, v in tree.items() for kv in _flatten(v, path + (k,))]
    if isinstance(tree, (tuple, list)):
        return [kv for i, v in enumerate(tree)
                for kv in _flatten(v, path + (i,))]
    return [(_key(path), tree)]


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """A host copy of ``t`` (never a view of it): bf16 as its uint16 bits."""
    t = t.detach()
    bits = t.dtype == torch.bfloat16
    a = (t.view(torch.int16) if bits else t).cpu().numpy()
    if t.device.type == "cpu":
        a = a.copy()
    return a.view(np.uint16) if bits else a


def save_checkpoint(directory: str, step: int, tree: Any,
                    wait: bool = True) -> threading.Thread:
    """Atomic (optionally asynchronous) write of a tensor tree. The tensors
    are copied to the host before this returns, so the caller may update
    them while the write runs."""
    os.makedirs(directory, exist_ok=True)
    host = [(k, _to_numpy(v), _NP_DTYPES[v.dtype]) for k, v in _flatten(tree)]

    def _write():
        tmp = tempfile.mkdtemp(dir=directory, prefix=f".tmp_step_{step}_")
        try:
            manifest = {}
            for k, a, dtype in host:
                np.save(os.path.join(tmp, k + ".npy"), a)
                manifest[k] = {"shape": list(a.shape), "dtype": dtype}
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump({"step": step, "arrays": manifest}, f)
            final = os.path.join(directory, f"step_{step}")
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)
        finally:
            if os.path.exists(tmp):
                shutil.rmtree(tmp, ignore_errors=True)

    t = threading.Thread(target=_write)
    t.start()
    if wait:
        t.join()
    return t


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = []
    for name in os.listdir(directory):
        m = re.fullmatch(r"step_(\d+)", name)
        if m and os.path.exists(os.path.join(directory, name,
                                             "manifest.json")):
            steps.append(int(m.group(1)))
    return max(steps) if steps else None


def restore_checkpoint(directory: str, step: int, target: Any,
                       device="cpu") -> Any:
    """Restore into the structure of ``target``, a tree of ParamSpec or of
    tensors: each leaf in the target's dtype, on ``device``."""
    path = os.path.join(directory, f"step_{step}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)["arrays"]
    leaves = []
    for k, tgt in _flatten(target):
        a = np.load(os.path.join(path, k + ".npy"))
        stored = manifest[k]["dtype"]
        if stored == "bfloat16":
            t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(a)
        want = tuple(tgt.shape)
        if tuple(t.shape) != want:
            raise ValueError(f"checkpoint leaf {k}: shape {tuple(t.shape)}, "
                             f"target {want}")
        leaves.append(t.to(device=device, dtype=tgt.dtype))
    return tree_unflatten(target, leaves)
