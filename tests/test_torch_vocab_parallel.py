"""The vocab-parallel layer (``distributed/vocab.py``: the embedding lookup
and the next-token log-likelihood on vocab shards) against the plain
functions and the JAX package's meshed ones.

* In process, the per-shard bodies merged over 1, 2 and 16 shards of one
  CPU tensor (``embed_split``, ``token_ll_split``): the lookup bit-equal to
  plain indexing in f32 and bf16; the log-likelihood and its gradient (a
  fixed upstream gradient) within 1e-5 of the largest element of the plain
  ``steps._token_ll`` and of its autograd gradient, with the padded vocab
  at ``finfo.min`` as ``unembed`` leaves it: 9 padded columns of 512, and
  112, so that the last 3 of 16 shards hold nothing but padding.
* 4 ``gloo`` processes on (2, 2), (4, 1) and (1, 4) ("data", "model")
  meshes, smoke qwen2-0.5b and gemma2-27b (vocab 503 padded to 512, tied
  embeddings; gemma2 scales the embeddings and softcaps the logits):
  ``x = embed(tokens)``, ``loss = cross_entropy(unembed(x + h), targets)``
  on DTensors laid out by the train rules, against the JAX package's
  ``layers.embed``, ``layers.unembed`` and ``steps.cross_entropy`` under its
  rules, ``jax.jit`` of ``value_and_grad`` on 4 forced host devices with
  the table on its rules' sharding. The same f32 table, h, tokens and
  targets from numpy. The lookup bit for bit; the loss within 1e-5
  relative and the gradients of the table (embedding and unembedding, tied)
  and of h within test_torch_train_dense.py's f32 bounds (3e-4 of the
  leaf's largest element plus 1e-6 of the largest gradient element). Where
  the model axis splits the vocab (2 or 4 ranks), the collectives of the
  forward and backward (recorded with ``launch/dryrun.py``'s recorder) hold
  no all_gather or all_to_all of the table's shard and no collective of a
  (B, S, V) or (B, S, V/n) operand; each sum over model is of (B_local,
  S, d) f32 rows (the lookup) or (B_local, S) f32 rows (the max, the sum
  and the target's logit).

Each subprocess has a timeout of 240 s; the gloo group rendezvouses through
a ``file://`` store under the test's tmp_path.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
B, S = 4, 16
MESHES = {"2x2": (2, 2), "4x1": (4, 1), "1x4": (1, 4)}
ARCHS = ("qwen2-0.5b", "gemma2-27b")


# ----------------------------------------------------------- in process

def _logits(v_real, v=512, seed=0):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((3, 8, v)).astype(np.float32) * 4
    logits[..., v_real:] = np.finfo(np.float32).min
    ids = rng.integers(0, v_real, (3, 8))
    g = rng.standard_normal((3, 8)).astype(np.float32)
    return torch.from_numpy(logits), torch.from_numpy(ids), torch.from_numpy(g)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [1, 2, 16])
def test_embed_split_equals_plain_lookup(n, dtype):
    from repro_torch.distributed import vocab
    rng = np.random.default_rng(1)
    table = torch.from_numpy(rng.standard_normal((512, 24))
                             .astype(np.float32)).to(dtype)
    ids = torch.from_numpy(rng.integers(0, 503, (3, 40)))
    got = vocab.embed_split(table, ids, n)
    assert got.dtype == dtype
    assert torch.equal(got, table[ids])


@pytest.mark.parametrize("v_real", [503, 400])
@pytest.mark.parametrize("n", [1, 2, 16])
def test_token_ll_split_matches_plain(n, v_real):
    from repro_torch.distributed import vocab
    from repro_torch.distributed.steps import _token_ll
    logits, ids, g = _logits(v_real)
    want_l = logits.clone().requires_grad_()
    want = _token_ll(want_l, ids)
    (want * g).sum().backward()
    got_l = logits.clone().requires_grad_()
    got = vocab.token_ll_split(got_l, ids, n)
    (got * g).sum().backward()
    assert torch.isfinite(got).all() and torch.isfinite(got_l.grad).all()
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()
    err = (got_l.grad - want_l.grad).abs().max()
    assert err <= 1e-5 * want_l.grad.abs().max(), err
    # the padded columns get no gradient
    assert (got_l.grad[..., v_real:] == 0).all()


def test_shard_bodies_merge_to_the_plain_terms():
    """One shard's terms: the max and Σ exp merge to log_softmax's, each
    target's logit comes from the one shard holding its id."""
    from repro_torch.distributed import vocab
    logits, ids, _ = _logits(503)
    parts = [(logits[..., a:a + 128], a) for a in range(0, 512, 128)]
    m = torch.stack([vocab.ll_max(p) for p, _ in parts]).amax(0)
    assert torch.equal(m, logits.amax(-1))
    s = sum(vocab.ll_sumexp(p, m) for p, _ in parts)
    lse = m + torch.log(s)
    torch.testing.assert_close(lse, torch.logsumexp(logits, -1),
                               rtol=1e-6, atol=1e-5)
    hits = torch.stack([vocab.ll_target(p, ids, a) != 0 for p, a in parts])
    assert (hits.sum(0) == 1).all()
    t = sum(vocab.ll_target(p, ids, a) for p, a in parts)
    assert torch.equal(t, torch.gather(logits, -1, ids[..., None])[..., 0])


# ---------------------------------------------------------- 4 processes

def _inputs(arch):
    """Smoke config, f32 table, h, tokens and targets from numpy."""
    from repro_torch.configs import get_smoke_config
    cfg = get_smoke_config(arch)
    rng = np.random.default_rng(2)
    table = (rng.standard_normal((cfg.vocab_padded, cfg.d_model))
             * cfg.d_model ** -0.5).astype(np.float32)
    h = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    tokens = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    targets = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    return cfg, table, h, tokens, targets


def _run(args, env=None):
    out = subprocess.run(
        [sys.executable, str(Path(__file__).resolve()), *args],
        capture_output=True, text=True, timeout=240, cwd=ROOT,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src"), **(env or {})})
    assert out.returncode == 0, out.stderr[-3000:]


def _ref_child(shape, arch, out_path):
    """The JAX package's meshed embed -> unembed -> cross_entropy: the
    lookup, the loss and the gradients of the table and of h."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding
    from repro.configs import get_smoke_config
    from repro.configs.base import ShapeSpec
    from repro.distributed.sharding import make_rules, spec_for, use_rules
    from repro.distributed.steps import cross_entropy
    from repro.launch.mesh import make_mesh
    from repro.models.layers import embed, unembed
    _, table, h, tokens, targets = _inputs(arch)
    cfg = get_smoke_config(arch)
    mesh = make_mesh(shape, ("data", "model"))
    rules = make_rules(mesh, cfg, "train", ShapeSpec("t", "train", S, B))

    def f(table_, h_, tokens_, targets_):
        with use_rules(mesh, rules):
            p = {"embedding": table_}
            x = embed(p, cfg, tokens_)
            return cross_entropy(cfg, unembed(p, cfg, x + h_), targets_), x

    def put(a, *axes):
        with use_rules(mesh, rules):
            spec = spec_for(rules, axes, a.shape)
        return jax.device_put(jnp.asarray(a), NamedSharding(mesh, spec))

    with mesh:
        step = jax.jit(jax.value_and_grad(f, argnums=(0, 1), has_aux=True))
        (loss, x), (d_table, d_h) = step(
            put(table, "vocab", "d_model"), put(h, "batch", "seq", "d_model"),
            put(tokens, "batch", "seq"), put(targets, "batch", "seq"))
    np.savez(out_path, x=np.asarray(x), loss=np.asarray(loss),
             d_table=np.asarray(d_table), d_h=np.asarray(d_h))


def _port_child(rank, shape, arch, tmp):
    import torch.distributed as dist
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.distributed import vocab
    from repro_torch.distributed.sharding import (current_placements,
                                                  make_rules, shardings_for,
                                                  use_rules)
    from repro_torch.distributed.steps import cross_entropy
    from repro_torch.launch.dryrun import _Recorder
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.layers import embed, embed_spec, unembed
    torch.set_num_threads(2)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store",
                            rank=rank, world_size=4)
    cfg, table, h, tokens, targets = _inputs(arch)
    mesh = make_mesh(shape, ("data", "model"), device_type="cpu")
    rules = make_rules(mesh, cfg, "train", ShapeSpec("t", "train", S, B))
    with use_rules(mesh, rules):
        def put(a, *axes):
            return distribute_tensor(torch.from_numpy(a), mesh,
                                     current_placements(a.shape, *axes))
        sh = shardings_for(embed_spec(cfg), mesh, rules)["embedding"]
        tt = distribute_tensor(torch.from_numpy(table), mesh, sh)
        tt.requires_grad_()
        th = put(h, "batch", "seq", "d_model").requires_grad_()
        p = {"embedding": tt}
        rec = _Recorder(None)
        with rec:
            x = embed(p, cfg, put(tokens, "batch", "seq"))
            loss = cross_entropy(cfg, unembed(p, cfg, x + th),
                                 put(targets, "batch", "seq"))
            loss.backward()
        split = bool(vocab.vocab_groups(tt, 0))
    res = {"x": x.full_tensor().detach(), "loss": loss.full_tensor().detach(),
           "d_table": tt.grad.full_tensor(), "d_h": th.grad.full_tensor(),
           "local_table": list(tt.to_local().shape), "split": split,
           "collectives": rec.collectives}
    if rank == 0:
        torch.save(res, f"{tmp}/port.pt")
    dist.destroy_process_group()


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mesh", list(MESHES))
def test_gloo_vocab_parallel_matches_meshed_reference(tmp_path, mesh, arch):
    _run(["ref", mesh, arch, str(tmp_path / "ref.npz")], env={
        "XLA_FLAGS": "--xla_force_host_platform_device_count=4",
        "JAX_PLATFORMS": "cpu"})
    _run(["port", mesh, arch, str(tmp_path)])
    want = np.load(tmp_path / "ref.npz")
    got = torch.load(tmp_path / "port.pt")
    np.testing.assert_array_equal(got["x"].numpy(), want["x"])
    loss = float(want["loss"])
    assert abs(got["loss"].item() - loss) <= 1e-5 * abs(loss)
    top = max(np.abs(want[k]).max() for k in ("d_table", "d_h"))
    for key in ("d_table", "d_h"):
        w = want[key]
        bound = 3e-4 * np.abs(w).max() + 1e-6 * top
        err = np.abs(got[key].numpy() - w).max()
        assert got[key].shape == w.shape and err <= bound, (key, err, bound)
    model = MESHES[mesh][1]
    assert got["split"] == (model > 1)
    if model == 1:
        return
    from repro_torch.configs import get_smoke_config
    cfg = get_smoke_config(arch)
    v, d, b = cfg.vocab_padded, cfg.d_model, B // MESHES[mesh][0]
    assert got["local_table"] == [v // model, d]
    rows = []
    for op in got["collectives"]:
        shape = tuple(op["shape"])
        if op["kind"] in ("all_gather_into_tensor", "all_to_all_single"):
            assert shape != (v // model, d), op
        assert not (len(shape) == 3 and shape[-1] in (v, v // model)), op
        if op["kind"] == "all_reduce" and op["group"] == model:
            rows.append((shape, op["dtype"]))
    # the lookup's sum and the log-likelihood's max, sum and target logit
    assert rows.count(((b, S, d), "float32")) >= 1
    assert rows.count(((b, S), "float32")) == 3


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT / "src"))
    what, mesh, arch = sys.argv[1], MESHES[sys.argv[2]], sys.argv[3]
    if what == "ref":
        _ref_child(mesh, arch, sys.argv[4])
    else:
        import torch.multiprocessing as mp
        mp.spawn(_port_child, args=(mesh, arch, sys.argv[4]), nprocs=4)
