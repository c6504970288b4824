"""Production meshes (port of ``repro.launch.mesh``).

Functions, never module-level constants: importing this module creates no
process group and no mesh. Each builds a
``torch.distributed.device_mesh.DeviceMesh`` through ``init_device_mesh``
over the process group the caller has initialised, whose world size must
equal the mesh's size. ``device_type`` is ``"cuda"`` unless the caller asks
for ``"cpu"`` (the tests and the dry run); ``"cuda"`` without a card
raises.
"""
from __future__ import annotations

import torch
from torch.distributed.device_mesh import init_device_mesh


def make_production_mesh(*, multi_pod: bool = False, device_type="cuda"):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device_type=device_type)


def make_mesh(shape, axes, device_type="cuda"):
    """Arbitrary mesh (tests use small ones, e.g. (2, 4))."""
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device_type='cuda' was asked for but torch.cuda.is_available() "
            "is False; pass device_type='cpu' for a mesh of CPU ranks")
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axes))
