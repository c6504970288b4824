"""Port parity for the training path (``repro_torch.training``,
``repro_torch.data``, ``repro_torch.checkpoint``, ``cross_entropy`` and
``make_train_step`` in ``repro_torch.distributed.steps``, and
``repro_torch.launch.train``), against the JAX package at smoke size, and
the checks of ``tests/test_training.py`` ported to the port.

Inputs are made with numpy and handed to both packages; weights and
optimizer state cross by ``from_numpy_tree`` (bit for bit) or by a
checkpoint. Each tolerance is stated where it is used.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_cfg
from repro.configs.base import ShapeSpec as JShape
from repro.data.pipeline import SyntheticLM as JSyntheticLM
from repro.models.registry import get_bundle as jax_bundle
from repro.training import compression as jcomp
from repro.training import optimizer as jopt
from repro_torch.checkpoint import (latest_step, restore_checkpoint,
                                    save_checkpoint)
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.data.pipeline import Prefetcher, SyntheticLM
from repro_torch.distributed.steps import cross_entropy, make_train_step
from repro_torch.models.params import from_numpy_tree
from repro_torch.models.registry import get_bundle
from repro_torch.training.compression import (compress_with_error_feedback,
                                              dequantize_int8, quantize_int8)
from repro_torch.training.optimizer import (adafactor, adamw,
                                            clip_by_global_norm,
                                            get_optimizer)
from repro_torch.utils import tree_leaves, tree_map

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _np(t):
    return t.detach().float().numpy()


def _paired(ttree, jtree, path=()):
    """[(path, torch leaf, jax leaf)] walking the port's tree and indexing
    the JAX tree by the same keys."""
    if isinstance(ttree, dict):
        return [x for k, v in ttree.items()
                for x in _paired(v, jtree[k], path + (k,))]
    if isinstance(ttree, (tuple, list)):
        return [x for i, v in enumerate(ttree)
                for x in _paired(v, jtree[i], path + (i,))]
    return [(path, ttree, jtree)]


def _bridge(jtree):
    return from_numpy_tree(jax.tree.map(np.asarray, jtree), "cpu")


# ------------------------------------------------------------------ data

@pytest.mark.parametrize("arch", ["qwen2-0.5b", "seamless-m4t-medium",
                                  "llava-next-mistral-7b"])
def test_synthetic_batches_equal_reference(arch):
    """Every array of the port's batches equals the reference's, bit for
    bit, at several steps (the port's module is a verbatim copy)."""
    S = 24 if arch != "llava-next-mistral-7b" else 40
    ref = JSyntheticLM(jax_cfg(arch), JShape("t", "train", S, 3), seed=5)
    got = SyntheticLM(get_smoke_config(arch), ShapeSpec("t", "train", S, 3),
                      seed=5)
    for step in (0, 1, 7, 123):
        a, b = ref.batch(step), got.batch(step)
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])


def test_data_pipeline_deterministic_and_resumable():
    """tests/test_training.py::test_data_pipeline_deterministic_and_resumable
    on the port: deterministic per (seed, step), the Prefetcher resumes at
    start_step, targets are the next-token shift of tokens."""
    cfg = get_smoke_config("qwen2-0.5b")
    shape = ShapeSpec("t", "train", 16, 2)
    a = SyntheticLM(cfg, shape, seed=3)
    b = SyntheticLM(cfg, shape, seed=3)
    np.testing.assert_array_equal(a.batch(5)["tokens"], b.batch(5)["tokens"])
    pf = Prefetcher(a, start_step=7)
    got = [next(pf) for _ in range(3)]
    pf.close()
    assert [s for s, _ in got] == [7, 8, 9]
    for step, batch in got:
        np.testing.assert_array_equal(batch["tokens"], b.batch(step)["tokens"])
    t = a.batch(0)
    np.testing.assert_array_equal(t["tokens"][:, 1:], t["targets"][:, :-1])


# ------------------------------------------------------------------ compression

@pytest.mark.parametrize("shape", [(7,), (256,), (300,), (3, 100), (2, 3, 45),
                                   (4, 1, 9, 33)])
def test_int8_quantization_equals_reference(shape):
    """quantize_int8 / dequantize_int8 against the reference bit for bit:
    the same f32 arithmetic, round half to even in both."""
    x = np.random.default_rng(len(shape)).standard_normal(shape).astype(
        np.float32) * 10.0
    qj, sj, mj = jcomp.quantize_int8(jnp.asarray(x))
    qt, st, mt = quantize_int8(torch.from_numpy(x))
    assert qt.dtype == torch.int8 and mt == (tuple(shape), mj[1])
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    np.testing.assert_array_equal(dequantize_int8(qt, st, mt).numpy(),
                                  np.asarray(jcomp.dequantize_int8(qj, sj, mj)))


@pytest.mark.parametrize("ndim,seed", [(1, 0), (2, 11), (3, 42), (4, 99)])
def test_int8_quantization_bounded_error(ndim, seed):
    """tests/test_training.py::test_int8_quantization_bounded_error on the
    port (its hypothesis draws replaced by fixed cases)."""
    rng = np.random.default_rng(seed)
    shape = tuple(rng.integers(1, 40, ndim))
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32) * 10.0)
    q, s, meta = quantize_int8(x)
    err = (dequantize_int8(q, s, meta) - x).abs()
    assert err.max().item() <= x.abs().max().item() / 127.0 + 1e-6


def test_error_feedback_converges_on_constant_gradient():
    """tests/test_training.py's check on the port, and each step's output
    and error state equal to the reference's bit for bit."""
    g = {"w": torch.full((300,), 0.01)}
    gj = {"w": jnp.full((300,), 0.01, jnp.float32)}
    acc = np.zeros(300)
    err, errj = None, None
    for _ in range(50):
        deq, err = compress_with_error_feedback(g, err)
        deqj, errj = jcomp.compress_with_error_feedback(gj, errj)
        np.testing.assert_array_equal(deq["w"].numpy(), np.asarray(deqj["w"]))
        np.testing.assert_array_equal(err["w"].numpy(), np.asarray(errj["w"]))
        acc += deq["w"].numpy()
    np.testing.assert_allclose(acc / 50, 0.01, rtol=0.02)


# ------------------------------------------------------------------ optimizer

def _opt_problem():
    """Leaves that Adafactor factors ((160, 130) and a stacked (2, 128, 136))
    and does not ((3, 5): dims under 128; (7,): one dim; (130, 100): one
    dim under 128); f32 and one bf16 leaf. Grads for three steps."""
    rng = np.random.default_rng(0)
    shapes = {"a": (160, 130), "b": (3, 5), "c": (7,), "d": (130, 100),
              "e": (2, 128, 136)}
    params = {k: rng.standard_normal(s).astype(np.float32) * 0.1
              for k, s in shapes.items()}
    grads = [{k: rng.standard_normal(s).astype(np.float32) * 0.01
              for k, s in shapes.items()} for _ in range(3)]
    return params, grads


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_optimizer_matches_reference(name):
    """Three updates from the same params, grads and initial state (both
    compute the same f32 expressions; only reductions and pow may round
    differently): every state leaf within 1e-6 relative, every f32
    parameter within 1e-6 relative plus 1e-7 absolute (a few f32 ulps of
    the largest weight, ~0.4: the subtraction p - lr·u rounds at the
    weight's magnitude, which is all of the error of a weight that passes
    near zero), and the bf16 leaf within one bf16 ulp (2^-8 relative: an
    f32 difference at the rounding boundary flips it). The state has the
    reference's tree."""
    params, grads = _opt_problem()
    lr = 1e-2
    ref = jopt.get_optimizer(name, lr=lr)
    got = get_optimizer(name, lr=lr)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jp["e"] = jp["e"].astype(jnp.bfloat16)
    tp = _bridge(jp)
    js, ts = ref.init(jp), got.init(tp)
    assert jax.tree.structure(_bridge(js)) == jax.tree.structure(
        {k: dict(v) for k, v in ts.items()})
    for step, g in enumerate(grads):
        jg = {k: jnp.asarray(v).astype(jp[k].dtype) for k, v in g.items()}
        jp, js = ref.update(jg, js, jp, jnp.asarray(step, jnp.int32))
        tp, ts = got.update(_bridge(jg), ts, tp, step)
    for path, t, j in _paired(ts, js):
        assert t.dtype == torch.float32, path
        np.testing.assert_allclose(_np(t), np.asarray(j), rtol=1e-6, atol=0,
                                   err_msg=str(path))
    for path, t, j in _paired(tp, jp):
        j = np.asarray(j, np.float32)
        if t.dtype == torch.bfloat16:
            np.testing.assert_allclose(_np(t), j, rtol=2 ** -8, atol=0,
                                       err_msg=str(path))
        else:
            np.testing.assert_allclose(_np(t), j, rtol=1e-6, atol=1e-7,
                                       err_msg=str(path))


def test_optimizer_spec_matches_reference():
    """spec() maps the port's ParamSpec tree to the reference's state
    shapes, leaf for leaf, for both optimizers (qwen2 smoke)."""
    jspec = jax_bundle(jax_cfg("qwen2-0.5b")).spec()
    tspec = get_bundle(get_smoke_config("qwen2-0.5b")).spec()
    for name, fac in (("adamw", adamw), ("adafactor", adafactor)):
        ref = getattr(jopt, name)().spec(jspec)
        got = fac().spec(tspec)
        for path, t, j in _paired(got, ref):
            assert tuple(t.shape) == tuple(j.shape), path
            assert t.dtype == torch.float32 and t.init == "zeros", path


def test_grad_clip_by_global_norm():
    """tests/test_training.py::test_grad_clip_by_global_norm on the port,
    and the clipped leaves and norm against the reference's (f32, 1e-6
    relative)."""
    g = {"a": torch.ones((4,)) * 100.0, "b": torch.ones((3,)) * -100.0}
    clipped, norm = clip_by_global_norm(g, 1.0)
    total = sum(torch.sum(torch.square(x)) for x in tree_leaves(clipped))
    assert float(total) == pytest.approx(1.0, rel=1e-3)
    assert float(norm) == pytest.approx(100.0 * np.sqrt(7), rel=1e-4)
    rng = np.random.default_rng(1)
    raw = {"x": rng.standard_normal((5, 6)).astype(np.float32),
           "y": (rng.standard_normal((9,)) * 0.01).astype(np.float32)}
    for max_norm in (1.0, 100.0):
        jc, jn = jopt.clip_by_global_norm(
            {k: jnp.asarray(v) for k, v in raw.items()}, max_norm)
        tc, tn = clip_by_global_norm(
            {k: torch.from_numpy(v) for k, v in raw.items()}, max_norm)
        np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
        for k in raw:
            np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]),
                                       rtol=1e-6, atol=1e-12)


# ------------------------------------------------------------------ checkpoints

def _qwen2_setup(B=4, S=32):
    cfg = get_smoke_config("qwen2-0.5b")
    b = get_bundle(cfg)
    params = b.init(torch.Generator().manual_seed(0))
    src = SyntheticLM(cfg, ShapeSpec("t", "train", S, B), seed=0)
    return cfg, b, params, src.batch(0)


def test_checkpoint_roundtrip_and_atomicity(tmp_path):
    """tests/test_training.py::test_checkpoint_roundtrip_and_atomicity on
    the port: restore into a spec tree and into a tensor tree, bit for bit;
    the newer step wins; no temporary directory is left."""
    cfg, b, params, _ = _qwen2_setup()
    d = str(tmp_path / "ckpt")
    save_checkpoint(d, 10, params)
    assert latest_step(d) == 10
    for target in (b.spec(), tree_map(torch.zeros_like, params)):
        restored = restore_checkpoint(d, 10, target)
        for x, y in zip(tree_leaves(params), tree_leaves(restored)):
            assert x.dtype == y.dtype and torch.equal(x, y)
    save_checkpoint(d, 20, params, wait=False).join()
    assert latest_step(d) == 20
    assert not [f for f in os.listdir(d) if f.startswith(".tmp")]


def test_checkpoint_snapshot_taken_before_return(tmp_path):
    """save_checkpoint(wait=False) copies the tensors before it returns: an
    update that follows does not reach the files."""
    t = {"w": torch.arange(6, dtype=torch.float32)}
    th = save_checkpoint(str(tmp_path), 1, t, wait=False)
    t["w"].add_(100.0)
    th.join()
    back = restore_checkpoint(str(tmp_path), 1, {"w": torch.zeros(6)})
    assert torch.equal(back["w"], torch.arange(6, dtype=torch.float32))


def _jax_train_state():
    """Reference qwen2 smoke params and an AdamW state after one update
    (nonzero m and v)."""
    cfg = jax_cfg("qwen2-0.5b")
    params = jax_bundle(cfg).init(jax.random.PRNGKey(0))
    opt = jopt.adamw()
    grads = jax.tree.map(lambda p: (jnp.ones(p.shape, jnp.float32) * 1e-3
                                    ).astype(p.dtype), params)
    _, state = opt.update(grads, opt.init(params), params,
                          jnp.asarray(0, jnp.int32))
    return cfg, params, state


def test_checkpoint_crosses_packages_both_ways(tmp_path):
    """A qwen2 smoke checkpoint (bf16 params and the f32 AdamW state)
    written by the reference restores in the port bit for bit, into the
    port's spec trees; one written by the port restores in the reference
    bit for bit. Same file names, same manifest."""
    from repro.checkpoint import checkpoint as jck
    from repro.models import params as jpspec
    cfg, jparams, jstate = _jax_train_state()
    spec = get_bundle(get_smoke_config("qwen2-0.5b")).spec()
    tspec_opt = adamw().spec(spec)
    a, b = str(tmp_path / "ref"), str(tmp_path / "port")
    jck.save_checkpoint(a, 3, jparams)
    jck.save_checkpoint(a + "/opt", 3, jstate)
    tp = restore_checkpoint(a, 3, spec)
    ts = restore_checkpoint(a + "/opt", 3, tspec_opt)
    for path, t, j in _paired(tp, jparams) + _paired(ts, jstate):
        assert t.dtype == {"bfloat16": torch.bfloat16,
                           "float32": torch.float32}[str(j.dtype)], path
        np.testing.assert_array_equal(_np(t), np.asarray(j, np.float32),
                                      err_msg=str(path))
    save_checkpoint(b, 3, tp)
    save_checkpoint(b + "/opt", 3, ts)
    for sub in ("", "/opt"):
        assert sorted(os.listdir(a + sub + "/step_3")) == sorted(
            os.listdir(b + sub + "/step_3"))
    jspec = jax_bundle(cfg).spec()
    back_p = jck.restore_checkpoint(b, 3, jpspec.abstract(jspec))
    back_s = jck.restore_checkpoint(
        b + "/opt", 3, jpspec.abstract(jopt.adamw().spec(jspec)))
    for x, y in zip(jax.tree.leaves(back_p) + jax.tree.leaves(back_s),
                    jax.tree.leaves(jparams) + jax.tree.leaves(jstate)):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(np.asarray(x, np.float32),
                                      np.asarray(y, np.float32))


# ------------------------------------------------------------------ train step

def test_cross_entropy_matches_reference():
    """f32 log-softmax and the mean over positions, 1e-6 relative."""
    from repro.distributed.steps import cross_entropy as jce
    rng = np.random.default_rng(2)
    logits = rng.standard_normal((2, 5, 50)).astype(np.float32) * 3
    targets = rng.integers(0, 50, (2, 5)).astype(np.int32)
    cfg = get_smoke_config("qwen2-0.5b")
    got = cross_entropy(cfg, torch.from_numpy(logits), torch.from_numpy(targets))
    want = jce(jax_cfg("qwen2-0.5b"), jnp.asarray(logits), jnp.asarray(targets))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_step_matches_reference(microbatches):
    """One qwen2-0.5b smoke make_train_step step (bf16 weights bridged from
    the reference, the same batch, AdamW) against the reference's
    make_train_step(chunk=16). Bounds, from bf16 rounding: the two forwards
    round the bf16 matmul and attention outputs at different places, so the
    loss agrees within 2e-3 relative and the gradient norm within 2e-2
    relative (the gradients pass through bf16 products in both). The first
    AdamW step moves each weight w by lr·g/(|g| + eps), about ±lr wherever
    |g| > eps, so an updated weight differs by at most 2·lr where a
    gradient near zero changes sign, plus the bf16 rounding of each side's
    result: one ulp at |w| + lr (2^-7 of it). That bound is a sanity check:
    at this init the softmax is all but one-hot and bf16 rounding decides
    which key wins, so the bf16 gradients are mostly rounding (chip_smoke.py's
    train phase prints how far the CPU's bf16 gradients lie from its f32
    ones). Each leaf's gradient is held to the reference's in f32 instead,
    by test_torch_train_dense.py and test_torch_train_mixers.py (this model
    there with its 2 microbatches)."""
    from repro.distributed.steps import make_train_step as jmake
    lr = 1e-3
    jc = jax_cfg("qwen2-0.5b")
    jparams = jax_bundle(jc).init(jax.random.PRNGKey(0))
    batch = JSyntheticLM(jc, JShape("t", "train", 32, 4), seed=0).batch(0)
    jstep = jax.jit(jmake(jc, jopt.adamw(lr=lr), chunk=16,
                          microbatches=microbatches))
    jp, _, jm = jstep(jparams, jopt.adamw(lr=lr).init(jparams),
                      {k: jnp.asarray(v) for k, v in batch.items()},
                      jnp.asarray(0, jnp.int32))
    opt = adamw(lr=lr)
    tparams = _bridge(jparams)
    tstep = make_train_step(get_smoke_config("qwen2-0.5b"), opt,
                            microbatches=microbatches, device="cpu")
    tp, ts, tm = tstep(tparams, opt.init(tparams), batch, 0)
    assert tm["step"] == 1
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=2e-3)
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]),
                               rtol=2e-2)
    for path, t, j, w in [(p, t, j, w) for (p, t, j), (_, w, _) in zip(
            _paired(tp, jp), _paired(tparams, jparams))]:
        assert t.dtype == torch.bfloat16, path
        bound = 2 * lr + 2 ** -7 * (np.abs(_np(w)) + lr)
        err = np.abs(_np(t) - np.asarray(j, np.float32))
        assert (err <= bound).all(), (path, float((err - bound).max()))
    # the inputs are left as they were: the step returns new trees
    for x, y in zip(tree_leaves(tparams), tree_leaves(_bridge(jparams))):
        assert torch.equal(x, y)


def _run_steps(arch, opt, n, B=4, S=32):
    cfg = get_smoke_config(arch)
    params = get_bundle(cfg).init(torch.Generator().manual_seed(0))
    batch = SyntheticLM(cfg, ShapeSpec("t", "train", S, B), seed=0).batch(0)
    step = make_train_step(cfg, opt, device="cpu")
    state = opt.init(params)
    losses = []
    for i in range(n):
        params, state, m = step(params, state, batch, i)
        losses.append(float(m["loss"]))
    return losses


def test_loss_decreases_adamw():
    """tests/test_training.py::test_loss_decreases_adamw on the port."""
    losses = _run_steps("qwen2-0.5b", adamw(lr=3e-3), 12)
    assert losses[-1] < losses[0] - 0.5, losses


def test_loss_decreases_adafactor():
    """tests/test_training.py::test_loss_decreases_adafactor on the port
    (gemma2-27b smoke: window 16, attention and final softcaps)."""
    losses = _run_steps("gemma2-27b", adafactor(lr=1e-2), 12)
    assert losses[-1] < losses[0] - 0.3, losses


def test_microbatching_matches_full_batch_grads():
    """tests/test_training.py::test_microbatching_matches_full_batch_grads
    on the port: 1 against 4 microbatches, within its bf16-accumulation
    bounds."""
    cfg, b, params, batch = _qwen2_setup(B=4)
    opt = adamw(lr=1e-3)
    s1 = make_train_step(cfg, opt, microbatches=1, device="cpu")
    s4 = make_train_step(cfg, opt, microbatches=4, device="cpu")
    p1, _, m1 = s1(params, opt.init(params), batch, 0)
    p4, _, m4 = s4(params, opt.init(params), batch, 0)
    assert abs(float(m1["loss"]) - float(m4["loss"])) < 2e-2
    diffs = [(x.float() - y.float()).abs().max().item()
             for x, y in zip(tree_leaves(p1), tree_leaves(p4))]
    assert max(diffs) < 2e-2


def test_train_restart_resumes_identically(tmp_path):
    """tests/test_training.py::test_train_restart_resumes_identically on the
    port, through repro_torch.launch.train.train(device="cpu"): resuming
    from the step-4 checkpoint reproduces the uninterrupted run's step-8
    loss."""
    from repro_torch.launch.train import train
    d1 = str(tmp_path / "a")
    full = train("qwen2-0.5b", steps=8, batch=2, seq=32, smoke=True,
                 ckpt_dir=None, device="cpu")
    train("qwen2-0.5b", steps=4, batch=2, seq=32, smoke=True,
          ckpt_dir=d1, ckpt_every=4, device="cpu")
    assert latest_step(d1) == 4 and latest_step(d1 + "/opt") == 4
    resumed = train("qwen2-0.5b", steps=8, batch=2, seq=32, smoke=True,
                    ckpt_dir=d1, ckpt_every=100, device="cpu")
    assert len(resumed) == 4
    np.testing.assert_allclose(resumed[-1], full[-1], rtol=1e-3, atol=1e-3)


def test_train_defaults_to_the_card():
    """train() and make_train_step() run on device='cuda' unless asked
    otherwise, and raise where there is no card."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default does not raise")
    from repro_torch.launch.train import train
    with pytest.raises(RuntimeError, match="device='cuda'"):
        train("qwen2-0.5b", steps=1)
    with pytest.raises(RuntimeError, match="device='cuda'"):
        make_train_step(get_smoke_config("qwen2-0.5b"), adamw())


def test_train_example_runs_on_the_cpu(tmp_path):
    """examples/train_lm_torch.py with --device cpu: two steps of the
    smoke config print the loss line (the example checkpoints every 50
    steps, as examples/train_lm.py)."""
    import subprocess
    import sys
    ck = str(tmp_path / "ck")
    cmd = [sys.executable, os.path.join(ROOT, "examples", "train_lm_torch.py"),
           "--steps", "2", "--batch", "2", "--seq", "16", "--ckpt", ck,
           "--device", "cpu"]
    out = subprocess.run(cmd, capture_output=True, text=True, timeout=300,
                         cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "[train_lm] loss" in out.stdout and "over 2 steps" in out.stdout
