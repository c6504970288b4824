"""The port's sharding rules and placements (``distributed/sharding.py``,
``launch/mesh.py``) against the JAX package's.

* ``make_rules`` (every key and ``_mode``) and ``spec_for`` of every
  parameter, optimizer, batch and cache leaf, for every architecture at full
  width and every ``SHAPES`` entry, on the production meshes (16, 16) and
  (2, 16, 16) and the (2, 4) test mesh: exactly equal. The port's side runs
  on a real ``DeviceMesh`` over a ``fake`` process group of the mesh's size,
  in a subprocess; the reference's on a device-free
  ``jax.sharding.AbstractMesh``.
* Smoke gemma2 on (2, 4): every rank's local shard (offset and shape per
  dim), from the port's placements as DTensor lays them out, equals the
  slice ``NamedSharding.devices_indices_map`` gives the device at the same
  mesh position (8 forced host devices), for the train step's parameters,
  optimizer state and batch and the decode step's cache and tokens.

Each subprocess has its own process group and a timeout of 240 s.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "2x4": ((2, 4), ("data", "model"))}
ARCHS = ["seamless-m4t-medium", "llava-next-mistral-7b", "mamba2-130m",
         "gemma2-27b", "starcoder2-3b", "phi4-mini-3.8b", "qwen2-0.5b",
         "qwen3-moe-235b-a22b", "llama4-maverick-400b-a17b",
         "recurrentgemma-2b"]


def _norm(spec):
    """A PartitionSpec or a spec_for tuple as JSON-able lists."""
    return json.loads(json.dumps([list(e) if isinstance(e, tuple) else e
                                  for e in spec]))


def _is_axes(x):
    return isinstance(x, tuple) and all(a is None or isinstance(a, str)
                                        for a in x)


def _flat(tree, leaf, path=()):
    if leaf(tree):
        return {"/".join(map(str, path)): tree}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    out = {}
    for k, v in items:
        out.update(_flat(v, leaf, path + (k,)))
    return out


def leaf_specs(pkg, mesh, cfg, shape, smoke_cache=None):
    """{group: {path: spec}} for one (config, shape) under package ``pkg``'s
    rules (``repro`` or ``repro_torch``), and the rules themselves."""
    import importlib
    sh = importlib.import_module(f"{pkg}.distributed.sharding")
    shp = importlib.import_module(f"{pkg}.configs.shapes")
    reg = importlib.import_module(f"{pkg}.models.registry")
    par = importlib.import_module(f"{pkg}.models.params")
    opt = importlib.import_module(f"{pkg}.training.optimizer")
    bundle = reg.get_bundle(cfg)
    spec = bundle.spec()
    rules = sh.make_rules(mesh, cfg, shape.kind, shape)
    dec_rules = sh.make_rules(mesh, cfg, "decode", shape)

    def of_specs(tree, r):
        with sh.use_rules(mesh, r):
            return {p: _norm(sh.spec_for(r, s.axes, tuple(s.shape)))
                    for p, s in _flat(tree, par.is_spec).items()}

    def of_arrays(tree, axes_tree, r):
        arrays = _flat(tree, lambda x: hasattr(x, "shape"))
        axes = _flat(axes_tree, _is_axes)
        with sh.use_rules(mesh, r):
            return {p: _norm(sh.spec_for(r, axes[p], tuple(a.shape)))
                    for p, a in arrays.items()}

    out = {"params": of_specs(spec, rules)}
    batch = shp.inputs_for(cfg, shape)
    out["batch"] = of_arrays(batch, shp.batch_logical_axes(batch), rules)
    if shape.kind == "train":
        out["opt"] = of_specs(opt.get_optimizer(cfg.optimizer).spec(spec),
                              rules)
    else:
        self_len, cross_len = shp.decode_cache_len(cfg, shape)
        if shape.kind == "prefill":     # prefill's cache: decode's rules
            self_len, cross_len = shape.seq_len, (
                shape.seq_len if cfg.is_encdec else 0)
        cache = smoke_cache or bundle.cache_abstract(
            shape.global_batch, self_len, cross_len)
        out["cache"] = of_arrays(cache, bundle.cache_axes(cross_len),
                                 rules if shape.kind == "decode"
                                 else dec_rules)
    rules = {k: (list(v) if isinstance(v, tuple) else v)
             for k, v in rules.items()}
    return rules, out


# ------------------------------------------------------------- subprocesses

def _child(args, env=None, timeout=240):
    out = subprocess.run(
        [sys.executable, str(Path(__file__).resolve())] + args,
        capture_output=True, text=True, timeout=timeout, cwd=ROOT,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src"),
             **(env or {})})
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def _port_all_cells(mesh_key):
    """Child: the port's rules and specs of every cell on one mesh."""
    import torch.distributed as dist
    import torch.testing._internal.distributed.fake_pg  # noqa: F401
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.launch.mesh import make_mesh
    shape, names = MESHES[mesh_key]
    n = 1
    for s in shape:
        n *= s
    dist.init_process_group("fake", store=dist.HashStore(), rank=0,
                            world_size=n)
    mesh = make_mesh(shape, names, device_type="cpu")
    res = {a: {s: leaf_specs("repro_torch", mesh, get_config(a), sh)
               for s, sh in SHAPES.items()} for a in ARCHS}
    dist.destroy_process_group()
    print(json.dumps(res))


@pytest.fixture(scope="module")
def port_cells():
    cache = {}

    def get(mesh_key):
        if mesh_key not in cache:
            cache[mesh_key] = _child(["cells", mesh_key])
        return cache[mesh_key]
    return get


@pytest.mark.parametrize("mesh_key", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_rules_and_specs_equal_reference(port_cells, mesh_key, arch):
    from jax.sharding import AbstractMesh
    from repro.configs import SHAPES, get_config
    shape, names = MESHES[mesh_key]
    mesh = AbstractMesh(shape, names)
    got = port_cells(mesh_key)[arch]
    for name, sh in SHAPES.items():
        rules, specs = leaf_specs("repro", mesh, get_config(arch), sh)
        grules, gspecs = got[name]
        assert grules == rules, (name, grules, rules)
        assert gspecs.keys() == specs.keys(), name
        for group in specs:
            assert gspecs[group] == specs[group], (name, group)


# ------------------------------------------------- local shards per rank

SMOKE = {"train": (64, 8), "decode": (64, 8)}


def _smoke_trees(pkg, kind):
    """(rules' spec trees, the arrays' shapes) of smoke gemma2's step."""
    import importlib
    cfgs = importlib.import_module(f"{pkg}.configs")
    base = importlib.import_module(f"{pkg}.configs.base")
    cfg = cfgs.get_smoke_config("gemma2-27b")
    S, B = SMOKE[kind]
    return cfg, base.ShapeSpec("s", kind, S, B)


def _shapes(pkg, cfg, shape):
    import importlib
    shp = importlib.import_module(f"{pkg}.configs.shapes")
    reg = importlib.import_module(f"{pkg}.models.registry")
    par = importlib.import_module(f"{pkg}.models.params")
    opt = importlib.import_module(f"{pkg}.training.optimizer")
    bundle = reg.get_bundle(cfg)
    spec = bundle.spec()
    out = {"params": {p: list(s.shape) for p, s in
                      _flat(spec, par.is_spec).items()},
           "batch": {p: list(a.shape) for p, a in _flat(
               shp.inputs_for(cfg, shape), lambda x: hasattr(x, "shape")
           ).items()}}
    if shape.kind == "train":
        out["opt"] = {p: list(s.shape) for p, s in _flat(
            opt.get_optimizer(cfg.optimizer).spec(spec), par.is_spec).items()}
    else:
        out["cache"] = {p: list(a.shape) for p, a in _flat(
            bundle.cache_abstract(shape.global_batch, shape.seq_len),
            lambda x: hasattr(x, "shape")).items()}
    return out


def _port_local_shards(kind):
    """Child: each rank's (offset, size) per dim of every leaf, from the
    port's placements as DTensor lays them out, keyed by mesh position."""
    import torch.distributed as dist
    import torch.testing._internal.distributed.fake_pg  # noqa: F401
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    from repro_torch.distributed.sharding import placements
    from repro_torch.launch.mesh import make_mesh
    cfg, shape = _smoke_trees("repro_torch", kind)
    shapes = _shapes("repro_torch", cfg, shape)
    res = {}
    for rank in range(8):
        dist.init_process_group("fake", store=dist.HashStore(), rank=rank,
                                world_size=8)
        mesh = make_mesh((2, 4), ("data", "model"), device_type="cpu")
        _, specs = leaf_specs("repro_torch", mesh, cfg, shape)
        pos = ",".join(map(str, mesh.get_coordinate()))
        res[pos] = {}
        for group, leaves in specs.items():
            for p, spec in leaves.items():
                spec = [tuple(e) if isinstance(e, list) else e for e in spec]
                size, off = compute_local_shape_and_global_offset(
                    shapes[group][p], mesh, placements(mesh, spec))
                res[pos][f"{group}/{p}"] = [list(off), list(size)]
        dist.destroy_process_group()
    print(json.dumps(res))


def _ref_local_shards(kind):
    """Child (8 forced host devices): the reference's slice for the device
    at each mesh position, from NamedSharding.devices_indices_map."""
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro.launch.mesh import make_mesh
    cfg, shape = _smoke_trees("repro", kind)
    shapes = _shapes("repro", cfg, shape)
    mesh = make_mesh((2, 4), ("data", "model"))
    _, specs = leaf_specs("repro", mesh, cfg, shape)
    res = {}
    for i in range(2):
        for j in range(4):
            dev = mesh.devices[i, j]
            leaves = res[f"{i},{j}"] = {}
            for group, lv in specs.items():
                for p, spec in lv.items():
                    spec = [tuple(e) if isinstance(e, list) else e
                            for e in spec]
                    dims = shapes[group][p]
                    idx = NamedSharding(mesh, P(*spec)).devices_indices_map(
                        tuple(dims))[dev]
                    off = [sl.start or 0 for sl in idx]
                    size = [(sl.stop if sl.stop is not None else d)
                            - (sl.start or 0) for sl, d in zip(idx, dims)]
                    leaves[f"{group}/{p}"] = [off, size]
    print(json.dumps(res))


@pytest.mark.parametrize("kind", ["train", "decode"])
def test_local_shards_equal_devices_indices_map(kind):
    got = _child(["port_shards", kind])
    want = _child(["ref_shards", kind], env={
        "XLA_FLAGS": "--xla_force_host_platform_device_count=8",
        "JAX_PLATFORMS": "cpu"})
    assert got.keys() == want.keys() and len(got) == 8
    sharded = 0
    for pos in want:
        assert got[pos] == want[pos], pos
        sharded += sum(w[1] != _full(want, k) for k, w in want[pos].items())
    assert sharded > 0          # the mesh really splits some leaves


def _full(res, key):
    """The leaf's full shape: the largest size per dim over positions."""
    return [max(r[key][1][d] + r[key][0][d] for r in res.values())
            for d in range(len(next(iter(res.values()))[key][1]))]


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT / "src"))
    what, arg = sys.argv[1], sys.argv[2]
    {"cells": _port_all_cells, "port_shards": _port_local_shards,
     "ref_shards": _ref_local_shards}[what](arg)
