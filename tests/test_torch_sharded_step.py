"""The port's sharded step (``distributed/steps.py::build_sharded_step``) and
the meshed launcher on real collectives: ``gloo`` process groups on the CPU.

* 4 processes, a (2, 2) ("data", "model") mesh, f32, one train step of
  smoke gemma2-27b (heads mode), qwen2-0.5b (7 heads on a model axis of 2:
  context mode), mamba2-130m (its SSD sharded over ``ssm_hd``) and
  qwen3-moe (the dense MoE path on DTensors, experts over the data axis),
  against
  the port's single-device ``make_train_step`` on the same weights and
  batch (itself held to the JAX package in test_torch_train_dense.py and
  test_torch_train_mixers.py). Both run an optimizer that hands back the
  clipped gradients in its state, so every leaf is compared. Bounds, f32
  (the same function, sums in another order and across ranks): loss within
  2e-4 relative; grad_norm within 1e-4 relative; each leaf's gradient within
  3e-4 of the leaf's largest element plus 1e-6 of the model's largest
  gradient element (test_torch_train_dense.py's bound).
* 4 processes, (2, 2): a prefill and 4 greedy decode steps of smoke qwen2
  (batch 1: the decode rules give the whole mesh to the cache's sequence)
  and gemma2 (batch 2): every token equal to the single-device steps'.
* 1 process: ``launch.train.train(device="cpu", mesh_shape=(1, 1))`` under
  a gloo group gives the single-device launcher's losses bit for bit, and a
  resume from its step-2 checkpoint reaches the same step-4 loss.
* 1 process: the train step's backward (``backward_under_rules``) runs
  remat's recompute under the forward's rules when it runs on another
  thread, as autograd runs a CUDA backward, where Python's thread-local
  rules are unset: the same gradients as a backward on the forward's
  thread.

Each group lives in a subprocess of its own, rendezvous through a
``file://`` store under the test's tmp_path, with a 240 s timeout.
"""
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]


def _run(tmp_path, *args):
    out = subprocess.run(
        [sys.executable, str(Path(__file__).resolve()), *args,
         str(tmp_path)], capture_output=True, text=True, timeout=240,
        cwd=ROOT, env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert out.returncode == 0, out.stderr[-3000:]
    return torch.load(tmp_path / "out.pt")


# ------------------------------------------------------------ children

def _with_grads(inner):
    """``inner`` whose state also holds the clipped gradients it was given,
    with a spec for them (so the sharded step lays them out)."""
    from repro_torch.training.optimizer import Optimizer
    from repro_torch.utils import tree_map

    def update(grads, state, params, step):
        p, s = inner.update(grads, state["opt"], params, step)
        return p, {"opt": s, "grads": grads}
    return Optimizer(inner.name,
                     lambda ps: {"opt": inner.spec(ps), "grads": ps},
                     lambda p: {"opt": inner.init(p),
                                "grads": tree_map(torch.zeros_like, p)},
                     update)


def _group(rank, world, tmp):
    import torch.distributed as dist
    torch.set_num_threads(2)        # 4 ranks share the host's cores
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store",
                            rank=rank, world_size=world)


def _train_child(rank, arch, tmp):
    import torch.distributed as dist
    from repro_torch.configs import get_smoke_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.distributed import steps
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.utils import tree_leaves, tree_map
    _group(rank, 4, tmp)
    get = steps.get_optimizer
    steps.get_optimizer = lambda name, lr=1e-3: _with_grads(get(name, lr))
    cfg = get_smoke_config(arch)
    mesh = make_mesh((2, 2), ("data", "model"), device_type="cpu")
    step = steps.build_sharded_step(cfg, mesh, ShapeSpec("t", "train", 32, 8))
    bundle = steps.get_bundle(cfg)
    params = tree_map(lambda t: t.float(),
                      bundle.init(torch.Generator().manual_seed(0)))
    opt = steps.get_optimizer(cfg.optimizer)
    state = opt.init(params)
    gen = torch.Generator().manual_seed(1)
    batch = {k: torch.randint(0, cfg.vocab_size, (8, 32), generator=gen)
             for k in ("tokens", "targets")}
    _, new_state, m = step.fn(params, state, batch, 0)
    grads = [g.full_tensor() for g in tree_leaves(new_state["grads"])]
    res = {"mode": step.rules["_mode"], "loss": m["loss"].full_tensor(),
           "grad_norm": m["grad_norm"].full_tensor(), "grads": grads}
    if rank == 0:
        plain = steps.make_train_step(
            cfg, opt, microbatches=steps.microbatches_for(cfg, 8, 2),
            device="cpu")
        _, ps, pm = plain(params, state, batch, 0)
        res.update(plain_loss=pm["loss"], plain_grad_norm=pm["grad_norm"],
                   plain_grads=tree_leaves(ps["grads"]))
        torch.save(res, f"{tmp}/out.pt")
    dist.destroy_process_group()


def _serve_child(rank, arch, tmp):
    import torch.distributed as dist
    from repro_torch.configs import get_smoke_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.distributed import steps
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.utils import tree_map
    _group(rank, 4, tmp)
    cfg = get_smoke_config(arch)
    B, S, N = (1 if arch == "qwen2-0.5b" else 2), 24, 4
    mesh = make_mesh((2, 2), ("data", "model"), device_type="cpu")
    pre = steps.build_sharded_step(cfg, mesh, ShapeSpec("p", "prefill", S, B),
                                   cache_len=S + N)
    dec = steps.build_sharded_step(cfg, mesh,
                                   ShapeSpec("d", "decode", S + N, B))
    params = tree_map(lambda t: t.float(), steps.get_bundle(cfg).init(
        torch.Generator().manual_seed(0)))
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, S),
                                     generator=torch.Generator().manual_seed(1))}
    tok, cache = pre.fn(params, batch)
    got = [tok.full_tensor()]
    for i in range(N):
        tok, cache = dec.fn(params, cache, tok, S + i)
        got.append(tok.full_tensor())
    if rank == 0:
        p1 = steps.make_prefill_step(cfg, cache_len=S + N, device="cpu")
        d1 = steps.make_decode_step(cfg, device="cpu")
        tok, cache = p1(params, batch)
        want = [tok]
        for i in range(N):
            tok, cache = d1(params, cache, tok, S + i)
            want.append(tok)
        torch.save({"got": got, "want": want,
                    "modes": (pre.rules["_mode"], dec.rules["_mode"])},
                   f"{tmp}/out.pt")
    dist.destroy_process_group()


def _launch_child(tmp):
    import torch.distributed as dist
    from repro_torch.launch.train import train
    kw = dict(batch=4, seq=32, device="cpu", log_every=100)
    plain = train("qwen2-0.5b", steps=4, **kw)
    _group(0, 1, tmp)
    meshed = train("qwen2-0.5b", steps=4, mesh_shape=(1, 1), **kw)
    first = train("qwen2-0.5b", steps=2, mesh_shape=(1, 1),
                  ckpt_dir=f"{tmp}/ckpt", ckpt_every=2, **kw)
    resumed = train("qwen2-0.5b", steps=4, mesh_shape=(1, 1),
                    ckpt_dir=f"{tmp}/ckpt", ckpt_every=2, **kw)
    dist.destroy_process_group()
    torch.save({"plain": plain, "meshed": meshed, "first": first,
                "resumed": resumed}, f"{tmp}/out.pt")


def _thread_child(tmp):
    import dataclasses
    import threading
    import torch.distributed as dist
    from repro_torch.configs import get_smoke_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.distributed import steps
    from repro_torch.distributed.sharding import (backward_under_rules,
                                                  distribute, make_rules,
                                                  use_rules)
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.utils import tree_leaves, tree_map, tree_unflatten
    from torch.distributed.tensor.experimental import implicit_replication
    _group(0, 1, tmp)
    cfg = dataclasses.replace(get_smoke_config("qwen2-0.5b"), remat=True)
    mesh = make_mesh((1, 1), ("data", "model"), device_type="cpu")
    shape = ShapeSpec("t", "train", 16, 2)
    rules = make_rules(mesh, cfg, "train", shape)
    step = steps.build_sharded_step(cfg, mesh, shape)
    bundle = steps.get_bundle(cfg)
    params = distribute(tree_map(lambda t: t.float(), bundle.init(
        torch.Generator().manual_seed(0))), step.in_shardings[0], mesh)
    tokens = torch.randint(0, cfg.vocab_size, (2, 16),
                           generator=torch.Generator().manual_seed(1))
    grads = {}

    def backward(leaves, loss, key):
        # autograd hands its device thread the caller's C++ thread-local
        # state (DTensor's implicit replication among it), not Python's
        # thread-locals (the rules)
        try:
            with implicit_replication():
                grads[key] = torch.autograd.grad(loss, leaves)
        except Exception as e:      # noqa: BLE001 - reported below
            grads[key] = e

    for key in ("same", "other"):
        leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
        with use_rules(mesh, rules):
            logits = bundle.train_logits(tree_unflatten(params, leaves),
                                         {"tokens": tokens})
            loss = steps.cross_entropy(cfg, logits, tokens)
            backward_under_rules(loss)
            if key == "same":
                backward(leaves, loss, key)
        if key == "other":
            t = threading.Thread(target=backward, args=(leaves, loss, key))
            t.start()
            t.join()
    dist.destroy_process_group()
    out = {k: (repr(v) if isinstance(v, Exception) else
               [g.full_tensor() for g in v]) for k, v in grads.items()}
    torch.save(out, f"{tmp}/out.pt")


# --------------------------------------------------------------- tests

@pytest.mark.parametrize("arch,mode", [("gemma2-27b", "heads"),
                                       ("qwen2-0.5b", "context"),
                                       ("mamba2-130m", "heads"),
                                       ("qwen3-moe-235b-a22b", "heads")])
def test_gloo_train_step_matches_single_device(tmp_path, arch, mode):
    r = _run(tmp_path, "train", arch)
    assert r["mode"] == mode
    loss, want = r["loss"].item(), r["plain_loss"].item()
    assert abs(loss - want) <= 2e-4 * abs(want)
    gn, want_gn = r["grad_norm"].item(), r["plain_grad_norm"].item()
    assert abs(gn - want_gn) <= 1e-4 * want_gn
    grads, ref = r["grads"], r["plain_grads"]
    assert len(grads) == len(ref)
    top = max(g.abs().max().item() for g in ref)
    for i, (g, w) in enumerate(zip(grads, ref)):
        assert g.shape == w.shape, i
        bound = 3e-4 * w.abs().max().item() + 1e-6 * top
        assert (g - w).abs().max().item() <= bound, i


@pytest.mark.parametrize("arch,modes", [("qwen2-0.5b", ("context",
                                                        "context")),
                                        ("gemma2-27b", ("heads", "heads"))])
def test_gloo_prefill_decode_tokens_equal_single_device(tmp_path, arch,
                                                        modes):
    r = _run(tmp_path, "serve", arch)
    assert r["modes"] == modes
    assert len(r["got"]) == len(r["want"]) == 5
    for got, want in zip(r["got"], r["want"]):
        assert torch.equal(got, want)


def test_meshed_launcher_equals_single_device_and_resumes(tmp_path):
    r = _run(tmp_path, "launch")
    assert len(r["plain"]) == 4
    assert r["meshed"] == r["plain"]             # bit for bit
    assert r["first"] == r["plain"][:2]
    assert r["resumed"] == r["plain"][2:]


def test_remat_recompute_keeps_rules_on_another_thread(tmp_path):
    r = _run(tmp_path, "thread")
    assert not isinstance(r["other"], str), r["other"]
    assert len(r["other"]) == len(r["same"]) > 0
    for a, b in zip(r["other"], r["same"]):
        assert torch.equal(a, b)


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT / "src"))
    what, tmp = sys.argv[1], sys.argv[-1]
    if what == "launch":
        _launch_child(tmp)
    elif what == "thread":
        _thread_child(tmp)
    else:
        import torch.multiprocessing as mp
        child = {"train": _train_child, "serve": _serve_child}[what]
        mp.spawn(child, args=(sys.argv[2], tmp), nprocs=4)
