"""The expert-parallel MoE path (``models/moe.py``: ``_dispatch_tables``,
``_moe_local``, ``moe_apply`` under a mesh) against the JAX package's.

* ``_dispatch_tables``: the token of every slot equal to the reference's,
  and the weight the reference writes there equal to the router weight of
  the pair the port's inverse table ``slot_for_pair`` puts there; every
  kept pair's slot holds its token, every dropped pair is -1. Cases: random
  routing, an expert over its capacity, and every pair on one expert (all
  ties, which the stable sort keeps in token order).
* ``_moe_local`` with no collectives against the reference's on the same
  weights, smoke qwen3-moe (top-2) and llama4-maverick (top-1), at a
  capacity that drops pairs and one that drops none: f32 within 2e-4.
* 4 ``gloo`` processes on (2, 2) and (4, 1) ("data", "model") meshes: the
  port's ``moe_apply`` on DTensors (the expert-parallel path: all_to_all
  over data, the expert-ff partials summed over model) against the JAX
  package's meshed ``moe_apply`` (its shard_map path) on 4 forced host
  devices, jitted under its rules, on the same weights and inputs: the
  output and the gradients of x and of every weight (a fixed output
  cotangent) within test_torch_train_dense.py's f32 bounds, 3e-4 of each
  leaf's largest element plus 1e-6 of the largest gradient element. The
  inputs share a component that skews the routing; both meshes drop pairs
  (asserted from the port's drop count), so the dense single-device path is
  not the reference here.

Each subprocess has a timeout of 240 s; the gloo group rendezvouses through
a ``file://`` store under the test's tmp_path.
"""
import contextlib
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
B, S = 4, 16
MESHES = {"2x2": (2, 2), "4x1": (4, 1)}


@contextlib.contextmanager
def _drop_log():
    """While open, the dropped (token, expert) pairs of each expert-parallel
    dispatch, one count tensor a call, appended to the list it yields
    (``moe._dispatch_tables`` wrapped)."""
    from repro_torch.models import moe
    log, tables = [], moe._dispatch_tables

    def counted(*args):
        tok, slot = tables(*args)
        log.append((slot < 0).sum())
        return tok, slot
    moe._dispatch_tables = counted
    try:
        yield log
    finally:
        moe._dispatch_tables = tables


def _weights(arch):
    """Smoke MoE weights and inputs drawn with numpy (f32), a cotangent."""
    from repro_torch.configs import get_smoke_config
    cfg = get_smoke_config(arch)
    d, m = cfg.d_model, cfg.moe
    rng = np.random.default_rng(0)
    p = {"router": rng.standard_normal((d, m.num_experts)) * 0.5,
         "w_gate": rng.standard_normal((m.num_experts, d, m.d_ff_expert))
         / np.sqrt(d),
         "w_in": rng.standard_normal((m.num_experts, d, m.d_ff_expert))
         / np.sqrt(d),
         "w_out": rng.standard_normal((m.num_experts, m.d_ff_expert, d))
         / np.sqrt(m.d_ff_expert)}
    shared = rng.standard_normal((1, 1, d))
    x = rng.standard_normal((B, S, d)) + 1.5 * shared
    dout = rng.standard_normal((B, S, d))
    as32 = lambda a: np.asarray(a, np.float32)              # noqa: E731
    return cfg, {k: as32(v) for k, v in p.items()}, as32(x), as32(dout)


# ----------------------------------------------------------- in process

@pytest.mark.parametrize("case", ["random", "overflow", "ties"])
def test_dispatch_tables_match_reference(case):
    import jax.numpy as jnp
    from repro.models.moe import _dispatch_tables as ref_tables
    from repro_torch.models.moe import _dispatch_tables
    rng = np.random.default_rng(1)
    n, k, E, C = 24, 2, 4, 8
    if case == "random":
        top_i = np.stack([rng.permutation(E)[:k] for _ in range(n)])
    elif case == "overflow":
        top_i = np.stack([[0, 1 + t % 3] for t in range(n)])
    else:
        top_i, k = np.zeros((n, 1), np.int64), 1
    top_p = rng.random((n, k)).astype(np.float32)
    want_tok, want_w = ref_tables(jnp.asarray(top_i, jnp.int32),
                                  jnp.asarray(top_p), E, C)
    tok, slot = _dispatch_tables(torch.from_numpy(top_i).long(), E, C)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(want_tok))
    kept = slot.numpy() >= 0
    w = np.zeros(E * C, np.float32)
    w[slot.numpy()[kept]] = top_p[kept]
    np.testing.assert_array_equal(w, np.asarray(want_w))
    rows = np.broadcast_to(np.arange(n)[:, None], (n, k))
    np.testing.assert_array_equal(tok.numpy()[slot.numpy()[kept]],
                                  rows[kept])
    # expert 0 takes all 24 tokens' first pairs (8 slots): 16 dropped
    if case != "random":
        assert (~kept).sum() == 16


@pytest.mark.parametrize("capacity", [3, 64])
@pytest.mark.parametrize("arch", ["qwen3-moe-235b-a22b",
                                  "llama4-maverick-400b-a17b"])
def test_moe_local_matches_reference(arch, capacity):
    import jax.numpy as jnp
    from repro.configs import get_smoke_config as ref_smoke
    from repro.models.moe import _moe_local as ref_local
    from repro_torch.models import moe
    cfg, p, x, _ = _weights(arch)
    x = x.reshape(-1, x.shape[-1])
    want = ref_local(jnp.asarray(x), {k: jnp.asarray(v) for k, v in p.items()},
                     ref_smoke(arch), capacity, None, None)
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    tx = torch.from_numpy(x)
    with _drop_log() as drops:
        got = moe._moe_local(tx, tx, tp, cfg, capacity)
    dropped = int(sum(drops))
    assert (dropped > 0) == (capacity == 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-4)


# ---------------------------------------------------------- 4 processes

def _run(args, env=None):
    out = subprocess.run(
        [sys.executable, str(Path(__file__).resolve()), *args],
        capture_output=True, text=True, timeout=240, cwd=ROOT,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src"), **(env or {})})
    assert out.returncode == 0, out.stderr[-3000:]


def _ref_child(shape, out_path):
    """The JAX package's meshed moe_apply on 4 forced host devices: output
    and the vjp of a fixed cotangent, jitted under its train rules."""
    import jax
    import jax.numpy as jnp
    from repro.configs import get_smoke_config
    from repro.configs.base import ShapeSpec
    from repro.distributed.sharding import make_rules, use_rules
    from repro.launch.mesh import make_mesh
    from repro.models.moe import moe_apply
    arch = "qwen3-moe-235b-a22b"
    _, p, x, dout = _weights(arch)
    cfg = get_smoke_config(arch)
    mesh = make_mesh(shape, ("data", "model"))
    rules = make_rules(mesh, cfg, "train", ShapeSpec("t", "train", S, B))

    def f(x_, p_):
        with use_rules(mesh, rules):
            return moe_apply(p_, cfg, x_)

    with mesh:
        out, vjp = jax.vjp(jax.jit(f), jnp.asarray(x),
                           {k: jnp.asarray(v) for k, v in p.items()})
        dx, dp = vjp(jnp.asarray(dout))
    np.savez(out_path, out=np.asarray(out), dx=np.asarray(dx),
             **{f"d_{k}": np.asarray(v) for k, v in dp.items()})


def _port_child(rank, shape, tmp):
    import torch.distributed as dist
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.distributed.sharding import (current_placements,
                                                  make_rules, shardings_for,
                                                  use_rules)
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import moe
    torch.set_num_threads(2)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store",
                            rank=rank, world_size=4)
    arch = "qwen3-moe-235b-a22b"
    cfg, p, x, dout = _weights(arch)
    mesh = make_mesh(shape, ("data", "model"), device_type="cpu")
    rules = make_rules(mesh, cfg, "train", ShapeSpec("t", "train", S, B))
    sh = shardings_for(moe.moe_spec(cfg), mesh, rules)
    with use_rules(mesh, rules):
        tp = {k: distribute_tensor(torch.from_numpy(v), mesh, sh[k])
              .requires_grad_() for k, v in p.items()}
        xp = current_placements(x.shape, "batch", "seq", "d_model")
        tx = distribute_tensor(torch.from_numpy(x), mesh, xp).requires_grad_()
        with _drop_log() as drops:
            out = moe.moe_apply(tp, cfg, tx)
        dropped = int(sum(drops))
        out.backward(distribute_tensor(torch.from_numpy(dout), mesh,
                                       out.placements))
    res = {"out": out.full_tensor().detach(), "dx": tx.grad.full_tensor(),
           **{f"d_{k}": v.grad.full_tensor() for k, v in tp.items()}}
    total = torch.tensor([dropped])
    dist.all_reduce(total)
    if rank == 0:
        res["dropped"] = int(total)
        torch.save(res, f"{tmp}/port.pt")
    dist.destroy_process_group()


@pytest.mark.parametrize("mesh", list(MESHES))
def test_gloo_expert_parallel_matches_meshed_reference(tmp_path, mesh):
    _run(["ref", mesh, str(tmp_path / "ref.npz")], env={
        "XLA_FLAGS": "--xla_force_host_platform_device_count=4",
        "JAX_PLATFORMS": "cpu"})
    _run(["port", mesh, str(tmp_path)])
    want = np.load(tmp_path / "ref.npz")
    got = torch.load(tmp_path / "port.pt")
    grads = [k for k in want.files if k.startswith("d")]
    top = max(np.abs(want[k]).max() for k in grads)
    for key in ["out"] + grads:
        w = want[key]
        bound = 3e-4 * np.abs(w).max() + (1e-6 * top if key != "out" else 0)
        err = np.abs(got[key].numpy() - w).max()
        assert got[key].shape == w.shape and err <= bound, (key, err, bound)
    assert got["dropped"] > 0


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT / "src"))
    what, mesh = sys.argv[1], MESHES[sys.argv[2]]
    if what == "ref":
        _ref_child(mesh, sys.argv[3])
    else:
        import torch.multiprocessing as mp
        mp.spawn(_port_child, args=(mesh, sys.argv[3]), nprocs=4)
