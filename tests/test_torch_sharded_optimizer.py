"""The optimizer on sharded gradients: ``steps.reduce_to_params``, then
``clip_by_global_norm`` and the optimizer's ``update`` on DTensors, against
the JAX package's ``clip_by_global_norm`` and ``update`` jitted on its mesh.

* A JAX child (4 forced host devices) draws, from seed 0, smoke gemma2's or
  smoke qwen3-moe's parameters, an optimizer state (positive second
  moments, so step 3's ``beta`` mixes them in) and, for each mesh dim a
  parameter does not split, one gradient part per rank of that dim; the
  gradient is their sum. It runs the reference's clip and update, jitted
  with the reference's train shardings on a (2, 2) and a (4, 1) ("data",
  "model") mesh.
* 4 ``gloo`` processes hold the same parts as ``Partial`` gradients (each
  rank its own part, on its shard of the dims the parameter splits), as a
  meshed backward leaves them, and run ``reduce_to_params``, then the clip
  and the update, recorded with ``launch/dryrun.py``'s recorder.

Bounds, f32 (test_torch_train_dense.py's): the norm within 1e-4 relative;
each clipped gradient leaf within 3e-4 of its largest element plus 1e-6 of
the largest element of any leaf; each updated weight within 1e-3·lr plus 8
ulps of |w| + lr where the gradient's sign is settled; each new state leaf
(Adafactor's ``vr``, ``vc``, ``v``; AdamW's ``m``, ``v``) within 1e-5
relative, the loss's bound there, plus 1e-6 of the leaf's largest element
(AdamW's ``m`` mixes a positive state with gradients of either sign, and
may cancel to near zero).

Collectives: the reduction is one all_reduce of each gradient leaf a
mesh dim it is partial over, in f32, the parameter dtype here; the clip
and the update issue all_reduces only, none of a weight's local size (the
norm's scalars, Adafactor's rows and RMS scalars); no all_gather or
reduce_scatter anywhere. AdamW's update issues no collective at all, nor
does Adafactor's where the mesh splits no parameter (gemma2 on (4, 1)).

Each subprocess has a timeout of 240 s; the gloo group rendezvouses through
a ``file://`` store under the test's tmp_path.
"""
import math
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_train_dense import assert_leaves_match, grad_bounds

ROOT = Path(__file__).resolve().parents[1]
MESHES = {"2x2": (2, 2), "4x1": (4, 1)}
LR, STEP = 1e-3, 3
SHAPE = ("t", "train", 32, 8)
CASES = [("gemma2-27b", "2x2", "adafactor"), ("gemma2-27b", "4x1", "adafactor"),
         ("qwen3-moe-235b-a22b", "2x2", "adafactor"),
         ("qwen3-moe-235b-a22b", "4x1", "adafactor"),
         ("gemma2-27b", "2x2", "adamw")]


def _run(args, env=None):
    out = subprocess.run(
        [sys.executable, str(Path(__file__).resolve()), *args],
        capture_output=True, text=True, timeout=240, cwd=ROOT,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src"), **(env or {})})
    assert out.returncode == 0, out.stderr[-3000:]


def _part_index(coords, sizes, partial):
    """A rank's gradient part: its index over the mesh dims ``partial``,
    major to minor."""
    idx = 0
    for i in partial:
        idx = idx * sizes[i] + coords[i]
    return idx


# ------------------------------------------------------------ JAX child

def _ref_child(arch, tmp):
    """Data for every case of ``arch``, then the reference's clip and update
    of each (mesh, optimizer) case."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro.configs import get_smoke_config
    from repro.configs.base import ShapeSpec
    from repro.distributed.sharding import make_rules, shardings_for
    from repro.launch.mesh import make_mesh
    from repro.models.params import abstract
    from repro.models.registry import get_bundle
    from repro.training.optimizer import clip_by_global_norm, get_optimizer
    cfg = get_smoke_config(arch)
    spec = get_bundle(cfg).spec()
    rng = np.random.default_rng(0)
    params = jax.tree.map(
        lambda s: (0.02 * rng.standard_normal(s.shape)).astype(np.float32),
        abstract(spec))
    out = {"params": params, "cases": {}}
    for mesh_name, opt_name in sorted({(m, o) for a, m, o in CASES
                                       if a == arch}):
        shape = MESHES[mesh_name]
        mesh = make_mesh(shape, ("data", "model"))
        rules = make_rules(mesh, cfg, "train", ShapeSpec(*SHAPE))
        opt = get_optimizer(opt_name, lr=LR)
        p_sh = shardings_for(spec, mesh, rules)
        o_sh = shardings_for(opt.spec(spec), mesh, rules)
        state = jax.tree.map(
            lambda a: (rng.uniform(0.5, 1.5, a.shape) * 1e-4).astype(
                np.float32),
            jax.tree.map(np.asarray, opt.init(params)))
        parts = {}
        grads = []

        def draw(p, sh):
            used = {a for e in sh.spec if e is not None
                    for a in ((e,) if isinstance(e, str) else e)}
            n = math.prod(s for a, s in zip(("data", "model"), shape)
                          if a not in used)
            g = (0.1 * rng.standard_normal((n,) + p.shape)).astype(
                np.float32)
            grads.append(g.sum(0, dtype=np.float32))
            return g
        parts = jax.tree.map(draw, params, p_sh)
        grads = jax.tree.unflatten(jax.tree.structure(params), grads)
        rep = NamedSharding(mesh, P())

        def fn(g, s, p):
            g, norm = clip_by_global_norm(g, 1.0)
            new_p, new_s = opt.update(g, s, p, jnp.asarray(STEP, jnp.int32))
            return new_p, new_s, norm, g

        with mesh:
            new_p, new_s, norm, clipped = jax.jit(
                fn, in_shardings=(p_sh, o_sh, p_sh),
                out_shardings=(p_sh, o_sh, rep, p_sh))(
                    grads, state, params)
        out["cases"][(mesh_name, opt_name)] = {
            "state": state, "parts": parts,
            "new_params": jax.tree.map(np.asarray, new_p),
            "new_state": jax.tree.map(np.asarray, new_s),
            "norm": float(norm),
            "clipped": jax.tree.map(np.asarray, clipped)}
    with open(f"{tmp}/ref.pkl", "wb") as f:
        pickle.dump(out, f)


# ------------------------------------------------------------ gloo ranks

def _port_child(rank, arch, mesh_name, opt_name, tmp):
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Partial, Replicate
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)
    from repro_torch.configs import get_smoke_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.distributed import steps
    from repro_torch.distributed.sharding import make_rules, shardings_for
    from repro_torch.launch.dryrun import _Recorder
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.params import from_numpy_tree
    from repro_torch.models.registry import get_bundle
    from repro_torch.training.optimizer import (clip_by_global_norm,
                                                get_optimizer)
    from repro_torch.utils import (tree_leaves, tree_leaves_like, tree_map,
                                   tree_unflatten)
    torch.set_num_threads(2)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store",
                            rank=rank, world_size=4)
    with open(f"{tmp}/ref.pkl", "rb") as f:
        ref = pickle.load(f)
    case = ref["cases"][(mesh_name, opt_name)]
    cfg = get_smoke_config(arch)
    shape = MESHES[mesh_name]
    mesh = make_mesh(shape, ("data", "model"), device_type="cpu")
    rules = make_rules(mesh, cfg, "train", ShapeSpec(*SHAPE))
    spec = get_bundle(cfg).spec()
    opt = get_optimizer(opt_name, lr=LR)
    coords = mesh.get_coordinate()

    def local(a, pl):
        """This rank's shard of a global array laid out by ``pl`` (a
        ``Partial`` dim holds the whole)."""
        whole = [Replicate() if p.is_partial() else p for p in pl]
        lshape, off = compute_local_shape_and_global_offset(
            a.shape, mesh, whole)
        return torch.from_numpy(np.ascontiguousarray(
            a[tuple(slice(o, o + n) for o, n in zip(off, lshape))]))

    def laid_out(tree, sh):
        leaves = [DTensor.from_local(local(a, pl), mesh, pl, run_check=False)
                  for a, pl in zip(tree_leaves(tree),
                                   tree_leaves_like(sh, tree))]
        return tree_unflatten(tree, leaves)

    params_np = ref["params"]
    p_sh = shardings_for(spec, mesh, rules)
    params = laid_out(params_np, p_sh)
    o_sh = shardings_for(opt.spec(spec), mesh, rules)
    state = laid_out(case["state"], o_sh)
    grads = []
    partial_leaves = 0
    for p, parts in zip(tree_leaves(params), tree_leaves_like(
            case["parts"], params_np)):
        partial = [i for i, pl in enumerate(p.placements)
                   if pl.is_replicate() and shape[i] > 1]
        pl = tuple(Partial() if i in partial else x
                   for i, x in enumerate(p.placements))
        partial_leaves += len(partial)
        part = parts[_part_index(coords, shape, partial)]
        grads.append(DTensor.from_local(local(part, pl), mesh, pl,
                                        run_check=False))
    grads = tree_unflatten(params_np, grads)
    recs = {k: _Recorder(None) for k in ("reduce", "clip", "update")}
    with recs["reduce"]:
        reduced = steps.reduce_to_params(grads, params)
    placed = all(tuple(g.placements) == tuple(p.placements)
                 for g, p in zip(tree_leaves(reduced), tree_leaves(params)))
    with recs["clip"]:
        clipped, norm = clip_by_global_norm(reduced, 1.0)
    with recs["update"]:
        new_p, new_s = opt.update(clipped, state, params, STEP)
    full = lambda t: tree_map(lambda x: x.full_tensor(), t)  # noqa: E731
    res = {"new_params": full(new_p), "new_state": full(new_s),
           "clipped": full(clipped), "norm": norm.full_tensor().item(),
           "placed": placed, "partial_leaves": partial_leaves,
           "split_leaves": sum(any(pl.is_shard() for pl in p.placements)
                               for p in tree_leaves(params)),
           "ops": {k: r.collectives for k, r in recs.items()},
           "weight_numels": sorted({math.prod(p.to_local().shape)
                                    for p in tree_leaves(params)
                                    if p.ndim >= 2})}
    if rank == 0:
        torch.save(res, f"{tmp}/port.pt")
    dist.destroy_process_group()


# --------------------------------------------------------------- tests

_REFS = {}


def _reference(arch, tmp_path_factory):
    """The JAX child's data and results for every case of ``arch``, run
    once per session."""
    if arch not in _REFS:
        tmp = tmp_path_factory.mktemp(arch)
        _run(["ref", arch, str(tmp)], env={
            "XLA_FLAGS": "--xla_force_host_platform_device_count=4",
            "JAX_PLATFORMS": "cpu"})
        _REFS[arch] = tmp
    return _REFS[arch]


def _leaves(tree):
    from repro_torch.utils import tree_leaves
    return [np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)
            for x in tree_leaves(tree)]


@pytest.mark.parametrize("arch,mesh,opt", CASES)
def test_sharded_update_matches_meshed_reference(tmp_path, tmp_path_factory,
                                                 arch, mesh, opt):
    ref_dir = _reference(arch, tmp_path_factory)
    (tmp_path / "ref.pkl").symlink_to(ref_dir / "ref.pkl")
    _run(["port", arch, mesh, opt, str(tmp_path)])
    got = torch.load(tmp_path / "port.pt")
    with open(ref_dir / "ref.pkl", "rb") as f:
        ref = pickle.load(f)
    want = ref["cases"][(mesh, opt)]
    # every gradient laid out as its parameter, each partial leaf reduced
    # by one f32 all_reduce a mesh dim, nothing gathered or scattered
    assert got["placed"]
    reduce_ops = got["ops"]["reduce"]
    assert [o["kind"] for o in reduce_ops] == (
        ["all_reduce"] * got["partial_leaves"])
    assert all(o["dtype"] == "float32" for o in reduce_ops)
    smallest = got["weight_numels"][0]
    for phase in ("clip", "update"):
        for o in got["ops"][phase]:
            assert o["kind"] == "all_reduce", (phase, o)
            assert math.prod(o["shape"]) < smallest, (phase, o)
    assert len(got["ops"]["clip"]) <= 2 ** len(MESHES[mesh])
    # AdamW's update is elementwise; Adafactor's reduces over the dims
    # that the mesh splits (on (4, 1) only qwen3-moe's experts are)
    assert bool(got["ops"]["update"]) == (
        opt == "adafactor" and got["split_leaves"] > 0)
    # the numbers, within test_torch_train_dense.py's f32 bounds
    assert abs(got["norm"] - want["norm"]) <= 1e-4 * want["norm"]
    ref_g, port_g = _leaves(want["clipped"]), _leaves(got["clipped"])
    assert_leaves_match(
        _leaves(ref["params"]), _leaves(got["new_params"]),
        _leaves(want["new_params"]), port_g, ref_g, grad_bounds(ref_g), LR,
        update_rel=1e-3)
    for g, w in zip(_leaves(got["new_state"]), _leaves(want["new_state"])):
        np.testing.assert_allclose(g, w, rtol=1e-5,
                                   atol=1e-6 * np.abs(w).max())


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT / "src"))
    what = sys.argv[1]
    if what == "ref":
        _ref_child(sys.argv[2], sys.argv[3])
    else:
        import torch.multiprocessing as mp
        mp.spawn(_port_child, args=tuple(sys.argv[2:]), nprocs=4)
