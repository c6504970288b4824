"""Port parity for the Mamba2 mixer (``repro_torch.models.ssm``): the JAX
package's weights, bridged bit-exact through ``from_numpy_tree``, and the
same numpy inputs go through ``repro.models.ssm`` and its port, at the
mamba2-130m smoke size (d_model 64, 8 SSD heads of dim 16, state 16,
chunk 16).

Tolerances, as max |got - ref| <= tol * max(max |ref|, 1):

* f32: 1e-4 — the same arithmetic summed in another order.
* bf16: 2e-2 — one bf16 rounding of the block's output (one ulp near 1 is
  7.8e-3) plus rounding in another order inside the projections.

The depthwise convolutions are elementwise in f32 with one rounding at the
end, so they are held bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_cfg
from repro.models import params as jp
from repro.models import ssm as jssm
from repro_torch.configs import get_smoke_config as torch_cfg
from repro_torch.models import ssm as tssm
from repro_torch.models.params import from_numpy_tree
from repro_torch.serving.engine import make_lm_decode_model

ARCH = "mamba2-130m"
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
DTYPES = ["float32", "bfloat16"]


def _close(got, want, dtype, what):
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1.0)
    err = float(np.abs(got - want).max())
    assert err <= TOL[dtype] * scale, (what, err, TOL[dtype] * scale)


def _params(dtype, seed=1):
    """Mamba2 block weights: bf16 as the spec makes them (a_log, d_skip and
    norm stay f32 leaves) or all cast to f32. Random (not zero) b_dt and
    norm, so that every term of the block is exercised."""
    p = jp.materialize(jssm.mamba_spec(jax_cfg(ARCH)),
                       jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    p["b_dt"] = jnp.asarray(rng.uniform(-1, 1, p["b_dt"].shape),
                            p["b_dt"].dtype)
    p["norm"] = jnp.asarray(rng.standard_normal(p["norm"].shape) * 0.1,
                            p["norm"].dtype)
    if dtype == "float32":
        p = jax.tree.map(lambda a: a.astype(jnp.float32), p)
    return p, from_numpy_tree(jax.tree.map(np.asarray, p), "cpu")


def _x(shape, dtype, seed=2):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return jnp.asarray(x, getattr(jnp, dtype)), torch.from_numpy(x).to(
        getattr(torch, dtype))


def test_mamba_spec_matches_reference():
    jc, tc = jax_cfg(ARCH), torch_cfg(ARCH)
    js, ts = jssm.mamba_spec(jc), tssm.mamba_spec(tc)
    assert set(js) == set(ts)
    for k in js:
        assert tuple(ts[k].shape) == tuple(js[k].shape), k
        assert ts[k].axes == js[k].axes, k
        assert str(ts[k].dtype).split(".")[-1] == np.dtype(js[k].dtype).name
    assert tssm.ssm_heads(tc) == jssm.ssm_heads(jc)
    assert tssm.mamba_state_axes() == jssm.mamba_state_axes()


def test_bridge_keeps_f32_leaves_of_a_bf16_tree():
    _, pt = _params("bfloat16")
    for k in ("a_log", "d_skip", "norm"):
        assert pt[k].dtype == torch.float32, k
    assert pt["w_x"].dtype == torch.bfloat16


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape,w", [((2, 11, 3, 4), 4), ((2, 9, 5), 4),
                                     ((1, 2, 6), 4)])
def test_causal_conv_matches_reference(shape, w, dtype):
    xj, xt = _x(shape, dtype)
    kern = np.random.default_rng(3).standard_normal(
        (w,) + shape[2:]).astype(np.float32)
    want = jssm.causal_conv(xj, jnp.asarray(kern, getattr(jnp, dtype)))
    got = tssm.causal_conv(xt, torch.from_numpy(kern).to(xt.dtype))
    assert got.dtype == xt.dtype
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))


@pytest.mark.parametrize("dtype", DTYPES)
def test_conv_step_matches_reference(dtype):
    xj, xt = _x((2, 1, 3, 4), dtype)
    sj, st = _x((2, 3, 3, 4), dtype, seed=4)
    kern = np.random.default_rng(5).standard_normal((4, 3, 4)).astype(
        np.float32)
    yj, nj = jssm.conv_step(xj, sj, jnp.asarray(kern, getattr(jnp, dtype)))
    yt, nt = tssm.conv_step(xt, st, torch.from_numpy(kern).to(xt.dtype))
    np.testing.assert_array_equal(yt.float().numpy(), np.asarray(yj, np.float32))
    np.testing.assert_array_equal(nt.float().numpy(), np.asarray(nj, np.float32))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("L", [32, 21])          # whole chunks; ragged tail
def test_mamba_full_matches_reference(L, dtype):
    jc, tc = jax_cfg(ARCH), torch_cfg(ARCH)
    pj, pt = _params(dtype)
    xj, xt = _x((2, L, jc.d_model), dtype)
    yj, sj = jssm.mamba_full(pj, jc, xj)
    yt, st = tssm.mamba_full(pt, tc, xt)
    assert yt.dtype == xt.dtype
    _close(yt, yj, dtype, "y")
    assert set(st) == set(sj)
    for k in sj:
        assert st[k].dtype == getattr(torch, str(sj[k].dtype)), k
        _close(st[k], sj[k], dtype, k)


@pytest.mark.parametrize("dtype", DTYPES)
def test_mamba_decode_matches_reference(dtype):
    """One decode step from a random state (conv tails and an f32 SSM
    state), output and every new state leaf."""
    jc, tc = jax_cfg(ARCH), torch_cfg(ARCH)
    pj, pt = _params(dtype)
    rng = np.random.default_rng(6)
    state0 = jax.tree.map(
        lambda a: jnp.asarray(rng.standard_normal(a.shape) * 0.5, a.dtype),
        jssm.mamba_state(jc, 2, getattr(jnp, dtype)))
    st0 = from_numpy_tree(jax.tree.map(np.asarray, state0), "cpu")
    xj, xt = _x((2, 1, jc.d_model), dtype)
    yj, nj = jssm.mamba_decode(pj, jc, xj, state0)
    yt, nt = tssm.mamba_decode(pt, tc, xt, st0)
    _close(yt, yj, dtype, "y")
    for k in nj:
        _close(nt[k], nj[k], dtype, k)


def test_mamba_state_matches_reference():
    jc, tc = jax_cfg(ARCH), torch_cfg(ARCH)
    js = jssm.mamba_state(jc, 3)
    ts = tssm.mamba_state(tc, 3, device="cpu")
    for k in js:
        assert tuple(ts[k].shape) == js[k].shape, k
        assert ts[k].dtype == getattr(torch, str(js[k].dtype)), k
        assert not ts[k].any()


def test_mamba2_decode_model_runs_on_the_cpu():
    """The serving engine's LM decode model takes the Mamba2 family, as the
    JAX profiler's ``mamba2_decode`` does."""
    tm = make_lm_decode_model("m", "mamba2-130m", batches=(1, 2),
                              device="cpu")
    tm.load()
    with torch.inference_mode():
        logits = tm.forward(tm.device_params, tm.make_input(2))
    vocab = torch_cfg(ARCH).vocab_size
    assert logits.shape == (2, 1, torch_cfg(ARCH).vocab_padded)
    assert torch.isfinite(logits[..., :vocab]).all()
    assert tm.run(1) > 0
