"""The port's sharded step (``distributed/steps.py::build_sharded_step``) and
the meshed launcher on real collectives: ``gloo`` process groups on the CPU.

* 4 processes, a (2, 2) ("data", "model") mesh, f32, one train step of
  smoke gemma2-27b (heads mode), qwen2-0.5b (7 heads on a model axis of 2:
  context mode, its attention the segment-parallel combine: K/V taken
  into their sequence segments, never gathered out of them, in every
  layer's forward) and mamba2-130m (its SSD
  sharded over ``ssm_hd``), against the port's single-device
  ``make_train_step`` on the same weights and batch (itself held to the JAX
  package in test_torch_train_dense.py and test_torch_train_mixers.py); and
  qwen3-moe, whose meshed step takes the expert-parallel path and drops
  (token, expert) pairs past the capacity (asserted), so its reference is
  the JAX package's meshed step (``build_sharded_step`` on 4 forced host
  devices) from the same weights (the reference's init) and batch. Both
  sides run an optimizer that hands back the clipped gradients in its
  state, so every leaf is compared. Bounds, f32 (the same function, sums in
  another order and across ranks): loss within 2e-4 relative; grad_norm
  within 1e-4 relative; each leaf's gradient within 3e-4 of the leaf's
  largest element plus 1e-6 of the model's largest gradient element
  (test_torch_train_dense.py's bound). The vocab-parallel layer, from the
  step's collectives (``launch/dryrun.py``'s recorder): no all_gather or
  all_to_all of the table's vocab shard, no collective of a (B, S, V) or
  (B, S, V/2) operand, and each microbatch's lookup one all_reduce over
  the 2 model ranks of its (B_local, S, d) f32 rows. The optimizer
  (Adafactor for gemma2 and qwen3-moe, AdamW for the others) gets every
  gradient laid out as its parameter (``steps.reduce_to_params``: the
  ``Partial`` sums reduced once); no all_gather or reduce_scatter has the
  local shape of a stacked weight matrix but for its layers dim; each new
  weight is held to the single-device step's (qwen3-moe: the reference's)
  by test_torch_train_dense.py's bounds on an updated weight.
* 4 processes, (2, 2): a prefill of 32 tokens and 4 greedy decode steps
  of smoke qwen2 (batch 1: the decode rules give the whole mesh to the
  cache's sequence; prefill's attention the segment combine, K/V never
  gathered; at 24 tokens, 12 keys a segment, the unsegmented path, K/V
  whole on every rank; each decode step's the split-merge of the cache's shards,
  never gathered, whose collectives under ``CommDebugMode`` hold the
  merge's all_gather of the rows' lse and all_reduce of the weighted
  outputs) and gemma2 (batch 2): every token equal to the single-device
  steps'.
* 1 process: ``launch.train.train(device="cpu", mesh_shape=(1, 1))`` under
  a gloo group gives the single-device launcher's losses bit for bit, and a
  resume from its step-2 checkpoint reaches the same step-4 loss.
* 1 process: the train step's backward (``backward_under_rules``) runs
  remat's recompute under the forward's rules when it runs on another
  thread, as autograd runs a CUDA backward, where Python's thread-local
  rules are unset: the same gradients as a backward on the forward's
  thread; for qwen2 and for qwen3-moe, whose expert-parallel body has a
  checkpoint of its own.

Each group lives in a subprocess of its own, rendezvous through a
``file://`` store under the test's tmp_path, with a 240 s timeout.
"""
import contextlib
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from test_torch_train_dense import assert_leaves_match, grad_bounds

ROOT = Path(__file__).resolve().parents[1]


def _run_ref(tmp_path, arch):
    out = subprocess.run(
        [sys.executable, str(Path(__file__).resolve()), "ref_train", arch,
         str(tmp_path)], capture_output=True, text=True, timeout=240,
        cwd=ROOT, env={**os.environ, "PYTHONPATH": str(ROOT / "src"),
                       "XLA_FLAGS": "--xla_force_host_platform_device_count=4",
                       "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr[-3000:]


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


def _batch(cfg):
    gen = torch.Generator().manual_seed(1)
    return {k: torch.randint(0, cfg.vocab_size, (8, 32), generator=gen)
            for k in ("tokens", "targets")}


def _collectives(comm):
    """{kind: count} of a CommDebugMode's functional collectives."""
    return {str(op).split(".")[-1]: n
            for op, n in comm.get_comm_counts().items()}


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


@contextlib.contextmanager
def _kv_layouts(kv):
    """Record, inside the attention layers' forwards, each redistribute of a
    K/V-shaped DTensor (B, S, K, D), ``kv`` = (K, D): "gather" where it
    leaves a sequence shard (dim 1) for a layout without one, "segment"
    where it takes one. Yields the list of those words."""
    from torch.distributed.tensor import DTensor
    from repro_torch.models import lm
    seen, depth = [], [0]
    redistribute = DTensor.redistribute

    def recording(self, *args, **kwargs):
        placements = kwargs.get("placements", args[1] if len(args) > 1
                                else None)
        if (depth[0] and placements is not None and self.dim() == 4
                and tuple(self.shape[2:]) == kv
                and torch._C._current_graph_task_id() == -1):
            had = any(p.is_shard(1) for p in self.placements)
            has = any(p.is_shard(1) for p in placements)
            if had != has:
                seen.append("gather" if had else "segment")
        return redistribute(self, *args, **kwargs)

    def counted(fn):
        def call(*a, **kw):
            depth[0] += 1
            try:
                return fn(*a, **kw)
            finally:
                depth[0] -= 1
        return call
    saved = (lm.attend_full, lm.attend_decode)
    lm.attend_full, lm.attend_decode = map(counted, saved)
    DTensor.redistribute = recording
    try:
        yield seen
    finally:
        DTensor.redistribute = redistribute
        lm.attend_full, lm.attend_decode = saved


@contextlib.contextmanager
def _embed_spans(rec):
    """While open, the span of ``rec.collectives`` (a dry-run recorder's
    list) that each call of ``lm.embed`` issued, appended to the list it
    yields."""
    from repro_torch.models import lm
    spans, embed = [], lm.embed

    def recorded(*args):
        a = len(rec.collectives)
        out = embed(*args)
        spans.append((a, len(rec.collectives)))
        return out
    lm.embed = recorded
    try:
        yield spans
    finally:
        lm.embed = embed


def _ref_train_child(arch, tmp):
    """The JAX package's meshed train step ((2, 2) on 4 forced host
    devices) from its own init in f32 and _batch: the weights, the batch,
    loss, grad_norm and the clipped gradients (jax's leaf order)."""
    import pickle
    import jax
    import jax.numpy as jnp
    import numpy as np
    from repro.configs import get_smoke_config
    from repro.configs.base import ShapeSpec
    from repro.distributed import steps
    from repro.launch.mesh import make_mesh
    from repro.training.optimizer import Optimizer
    get = steps.get_optimizer

    def with_grads(name, lr=1e-3):
        inner = get(name, lr)

        def update(grads, state, params, step):
            p, s = inner.update(grads, state["opt"], params, step)
            return p, {"opt": s, "grads": grads}
        return Optimizer(inner.name,
                         lambda ps: {"opt": inner.spec(ps), "grads": ps},
                         lambda p: {"opt": inner.init(p),
                                    "grads": jax.tree.map(jnp.zeros_like, p)},
                         update)

    steps.get_optimizer = with_grads
    cfg = get_smoke_config(arch)
    mesh = make_mesh((2, 2), ("data", "model"))
    step = steps.build_sharded_step(cfg, mesh, ShapeSpec("t", "train", 32, 8))
    params = jax.tree.map(lambda a: a.astype(jnp.float32),
                          steps.get_bundle(cfg).init(jax.random.PRNGKey(0)))
    host = jax.tree.map(np.asarray, params)
    batch = {k: v.numpy().astype(np.int32)
             for k, v in _batch(cfg).items()}
    opt = with_grads(cfg.optimizer)
    new, state, m = step.jitted(params, opt.init(params),
                                {k: jnp.asarray(v) for k, v in batch.items()},
                                jnp.asarray(0, jnp.int32))
    with open(f"{tmp}/ref.pkl", "wb") as f:
        pickle.dump({"params": host, "loss": float(m["loss"]),
                     "grad_norm": float(m["grad_norm"]),
                     "grads": [np.asarray(g) for g in
                               jax.tree.leaves(state["grads"])],
                     "new_params": [np.asarray(w) for w in
                                    jax.tree.leaves(new)]}, f)


def _train_child(rank, arch, tmp):
    import pickle
    import torch.distributed as dist
    from torch.distributed.tensor.debug import CommDebugMode
    from repro_torch.configs import get_smoke_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.distributed import steps
    from repro_torch.launch.dryrun import _Recorder
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.params import from_numpy_tree
    from repro_torch.utils import tree_leaves, tree_leaves_like, tree_map
    _group(rank, 4, tmp)
    get = steps.get_optimizer
    steps.get_optimizer = lambda name, lr=1e-3: _with_grads(get(name, lr))
    clip, at_finish = steps.clip_by_global_norm, []

    def clip_recorded(grads, max_norm):     # finish's first call
        at_finish.append([tuple(g.placements) for g in tree_leaves(grads)])
        return clip(grads, max_norm)
    steps.clip_by_global_norm = clip_recorded
    cfg = get_smoke_config(arch)
    mesh = make_mesh((2, 2), ("data", "model"), device_type="cpu")
    step = steps.build_sharded_step(cfg, mesh, ShapeSpec("t", "train", 32, 8))
    bundle = steps.get_bundle(cfg)
    ref = None
    if cfg.moe is not None:         # the reference's weights and step
        with open(f"{tmp}/ref.pkl", "rb") as f:
            ref = pickle.load(f)
        params = from_numpy_tree(ref["params"], "cpu")
    else:
        params = tree_map(lambda t: t.float(),
                          bundle.init(torch.Generator().manual_seed(0)))
    opt = steps.get_optimizer(cfg.optimizer)
    state = opt.init(params)
    batch = _batch(cfg)
    rec = _Recorder(None)
    with _kv_layouts((cfg.n_kv_heads, cfg.head_dim)) as kv, \
            CommDebugMode() as comm, _drop_log() as drops, \
            _embed_spans(rec) as spans, rec:
        new_params, new_state, m = step.fn(params, state, batch, 0)
    dropped = torch.tensor([int(sum(drops))])
    dist.all_reduce(dropped)
    grads = [g.full_tensor() for g in tree_leaves(new_state["grads"])]
    # each parameter's placements, and the local shape of each stacked
    # matrix (a leading "layers" dim) but for that dim (a stacked vector's
    # would be an activation row's shape too)
    placed = tree_leaves_like(step.in_shardings[0], params)
    stacked = []
    for p, pl, sp in zip(tree_leaves(params), placed,
                         tree_leaves_like(bundle.spec(), params)):
        if sp.axes[0] == "layers" and len(sp.axes) >= 3:
            local = list(p.shape)
            for i, x in enumerate(pl):
                if x.is_shard():
                    local[x.dim] //= mesh.size(i)
            stacked.append(local[1:])
    res = {"mode": step.rules["_mode"], "loss": m["loss"].full_tensor(),
           "grad_norm": m["grad_norm"].full_tensor(), "grads": grads,
           "collectives": _collectives(comm), "dropped": int(dropped),
           "kv_layouts": kv, "ops": rec.collectives,
           "embed_ops": [rec.collectives[a:b] for a, b in spans],
           "microbatches": steps.microbatches_for(cfg, 8, 2),
           "dims": (cfg.vocab_padded, cfg.d_model),
           "at_finish": at_finish, "placements": [tuple(p) for p in placed],
           "stacked": stacked, "optimizer": cfg.optimizer,
           "old_params": [p.detach().clone() for p in tree_leaves(params)],
           "new_params": [w.full_tensor() for w in tree_leaves(new_params)]}
    if rank == 0 and ref is not None:
        res.update(plain_loss=torch.tensor(ref["loss"]),
                   plain_grad_norm=torch.tensor(ref["grad_norm"]),
                   plain_grads=[torch.from_numpy(g) for g in ref["grads"]],
                   plain_new_params=[torch.from_numpy(w)
                                     for w in ref["new_params"]])
        torch.save(res, f"{tmp}/out.pt")
    elif rank == 0:
        steps.clip_by_global_norm = clip
        plain = steps.make_train_step(
            cfg, opt, microbatches=steps.microbatches_for(cfg, 8, 2),
            device="cpu")
        pp, ps, pm = plain(params, state, batch, 0)
        res.update(plain_loss=pm["loss"], plain_grad_norm=pm["grad_norm"],
                   plain_grads=tree_leaves(ps["grads"]),
                   plain_new_params=tree_leaves(pp))
        torch.save(res, f"{tmp}/out.pt")
    dist.destroy_process_group()


def _serve_child(rank, arch, seq, tmp):
    import torch.distributed as dist
    from torch.distributed.tensor.debug import CommDebugMode
    from repro_torch.configs import get_smoke_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.distributed import steps
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.utils import tree_map
    _group(rank, 4, tmp)
    cfg = get_smoke_config(arch)
    B, S, N = (1 if arch == "qwen2-0.5b" else 2), int(seq), 4
    mesh = make_mesh((2, 2), ("data", "model"), device_type="cpu")
    pre = steps.build_sharded_step(cfg, mesh, ShapeSpec("p", "prefill", S, B),
                                   cache_len=S + N)
    dec = steps.build_sharded_step(cfg, mesh,
                                   ShapeSpec("d", "decode", S + N, B))
    params = tree_map(lambda t: t.float(), steps.get_bundle(cfg).init(
        torch.Generator().manual_seed(0)))
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, S),
                                     generator=torch.Generator().manual_seed(1))}
    kv = (cfg.n_kv_heads, cfg.head_dim)
    with _kv_layouts(kv) as layouts, CommDebugMode() as comm:
        tok, cache = pre.fn(params, batch)
    colls = {"prefill": (_collectives(comm), layouts), "decode": []}
    got = [tok.full_tensor()]
    for i in range(N):
        with _kv_layouts(kv) as layouts, CommDebugMode() as comm:
            tok, cache = dec.fn(params, cache, tok, S + i)
        colls["decode"].append((_collectives(comm), layouts))
        got.append(tok.full_tensor())
    if rank == 0:
        p1 = steps.make_prefill_step(cfg, cache_len=S + N, device="cpu")
        d1 = steps.make_decode_step(cfg, device="cpu")
        tok, cache = p1(params, batch)
        want = [tok]
        for i in range(N):
            tok, cache = d1(params, cache, tok, S + i)
            want.append(tok)
        torch.save({"got": got, "want": want, "collectives": colls,
                    "layers": cfg.num_layers,
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


def _thread_child(tmp, arch="qwen2-0.5b"):
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
    cfg = dataclasses.replace(get_smoke_config(arch), remat=True)
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
    if arch == "qwen3-moe-235b-a22b":
        _run_ref(tmp_path, arch)
    r = _run(tmp_path, "train", arch)
    assert r["mode"] == mode
    # the segment combine: K/V taken into their sequence segments in each
    # layer's forward (remat's recompute runs in the backward), never
    # gathered out of them; the expert-parallel path's all_to_all, and its
    # drops
    if arch == "qwen2-0.5b":
        assert "segment" in r["kv_layouts"]
        assert "gather" not in r["kv_layouts"]
    assert (r["collectives"].get("all_to_all_single", 0) > 0) == (
        arch == "qwen3-moe-235b-a22b")
    if arch == "qwen3-moe-235b-a22b":
        assert r["dropped"] > 0
    # the vocab-parallel layer: the table (and an untied head) keeps its
    # vocab shards and no (B, S, V) or (B, S, V/2) operand moves; each
    # forward's lookup is one sum over the model axis of its rows in f32
    v, d = r["dims"]
    for op in r["ops"]:
        shape = tuple(op["shape"])
        if op["kind"] in ("all_gather_into_tensor", "all_to_all_single"):
            assert shape not in ((v // 2, d), (d, v // 2)), op
        assert not (len(shape) == 3 and shape[-1] in (v, v // 2)), op
    assert len(r["embed_ops"]) == r["microbatches"]
    for ops in r["embed_ops"]:
        assert [(o["kind"], o["group"], o["dtype"], o["shape"])
                for o in ops] == [("all_reduce", 2, "float32",
                                   [8 // 2 // r["microbatches"], 32, d])]
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
    # the optimizer (Adafactor for gemma2 and qwen3-moe) gets every
    # gradient laid out as its parameter, reduced once; no collective
    # scatters or gathers a stacked weight over its layers; its new weights
    # are the single-device step's (qwen3-moe: the reference's meshed
    # step's) within test_torch_train_dense.py's bounds
    assert r["optimizer"] == ("adafactor" if arch in (
        "gemma2-27b", "qwen3-moe-235b-a22b") else "adamw")
    assert r["at_finish"] == [r["placements"]]
    for op in r["ops"]:
        if op["kind"] in ("all_gather_into_tensor", "reduce_scatter_tensor"):
            assert op["shape"][1:] not in r["stacked"], op
    ref_g = [g.numpy() for g in ref]
    assert_leaves_match(
        [w.numpy() for w in r["old_params"]],
        [w.numpy() for w in r["new_params"]],
        [w.numpy() for w in r["plain_new_params"]],
        [g.numpy() for g in grads], ref_g, grad_bounds(ref_g), 1e-3,
        update_rel=1e-3)


@pytest.mark.parametrize("arch,modes,seq", [
    pytest.param("qwen2-0.5b", ("context", "context"), 32,
                 id="qwen2-0.5b-modes0"),
    pytest.param("gemma2-27b", ("heads", "heads"), 32, id="gemma2-27b-modes1"),
    pytest.param("qwen2-0.5b", ("context", "context"), 24,
                 id="qwen2-0.5b-24-gathered")])
def test_gloo_prefill_decode_tokens_equal_single_device(tmp_path, arch,
                                                        modes, seq):
    r = _run(tmp_path, "serve", arch, str(seq))
    assert r["modes"] == modes
    if arch == "qwen2-0.5b":
        # prefill at 32 tokens (16 keys a segment on the model axis of 2,
        # the least the reference's condition takes) takes K/V into
        # segments and gathers none; at 24 (12 a segment) it keeps the
        # unsegmented path, K/V whole on every rank, taken into no
        # segment. Decode never gathers the cache
        # out of its sequence shards, and merges each layer's shards over
        # the 2 mesh dims they are split over: an all_gather of the rows'
        # lse and an all_reduce of the weighted outputs each, beside the
        # layout's own
        _, layouts = r["collectives"]["prefill"]
        if seq == 32:
            assert "segment" in layouts and "gather" not in layouts
        else:
            assert "segment" not in layouts
        for counts, layouts in r["collectives"]["decode"]:
            assert "gather" not in layouts
            assert counts.get("all_gather_into_tensor", 0) >= 2 * r["layers"]
            assert counts.get("all_reduce", 0) >= 2 * r["layers"]
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


def test_expert_parallel_remat_recompute_on_another_thread(tmp_path):
    """qwen3-moe on the (1, 1) mesh takes the expert-parallel path, which
    runs under its own checkpoint (nested in the layer group's): its
    recompute on autograd's thread gives the forward thread's gradients."""
    r = _run(tmp_path, "thread", "qwen3-moe-235b-a22b")
    assert not isinstance(r["other"], str), r["other"]
    assert len(r["other"]) == len(r["same"]) > 0
    for a, b in zip(r["other"], r["same"]):
        assert torch.equal(a, b)


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT / "src"))
    what, tmp = sys.argv[1], sys.argv[-1]
    if what == "launch":
        _launch_child(tmp)
    elif what == "ref_train":
        _ref_train_child(sys.argv[2], tmp)
    elif what == "thread":
        _thread_child(tmp, *sys.argv[2:-1])
    else:
        import torch.multiprocessing as mp
        child = {"train": _train_child, "serve": _serve_child}[what]
        mp.spawn(child, args=(*sys.argv[2:-1], tmp), nprocs=4)
