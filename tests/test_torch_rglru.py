"""Port parity for the RG-LRU block (``repro_torch.models.rglru``) against
``repro.models.rglru``: the log-depth scan alone against
``lax.associative_scan``, then ``rglru_full`` and ``rglru_decode`` on the
JAX package's weights bridged bit-exact through ``from_numpy_tree``
(recurrentgemma-2b's smoke widths, d_rnn 64, conv width 4).

Tolerances, as max |got - ref| <= tol * max(max |ref|, 1):

* f32: 1e-4 — the same arithmetic, the scan associated in another order.
* bf16 (the bf16 leaves, input and conv state in bf16; the gates, the
  recurrence and its state stay f32 in both): 2e-2 — the frameworks round
  the bf16 projections and the conv differently, one bf16 ulp near 1 is
  7.8e-3.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_cfg
from repro.models import params as jp
from repro.models import rglru as jr
from repro_torch.configs import get_smoke_config as torch_cfg
from repro_torch.models import rglru as tr
from repro_torch.models.params import from_numpy_tree

ARCH = "recurrentgemma-2b"
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
    """The reference's init, with the f32 gate leaves (all ones or zeros
    there) drawn at random so that every channel differs; the bf16 leaves
    cast to ``dtype``."""
    p = jp.materialize(jr.rglru_spec(jax_cfg(ARCH)), jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    for name in ("lam", "a_w", "a_b", "i_w", "i_b"):
        p[name] = jnp.asarray(rng.standard_normal(p[name].shape), jnp.float32)
    p = {k: v if v.dtype == jnp.float32 else v.astype(getattr(jnp, dtype))
         for k, v in p.items()}
    return p, from_numpy_tree(jax.tree.map(np.asarray, p), "cpu")


def _x(shape, dtype, seed=2):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return jnp.asarray(x, getattr(jnp, dtype)), torch.from_numpy(x).to(
        getattr(torch, dtype))


@pytest.mark.parametrize("L", [1, 7, 2048, 3000])
def test_linear_scan_matches_associative_scan(L):
    """The scan alone, f32, with a and b as the gates make them at c = 8
    (a = exp(-8 softplus(lam) r), down to ~e^-50 per step): a closed form
    through exp(-cumsum(log a)) would overflow here."""
    rng = np.random.default_rng(L)
    log_a = -8.0 * np.log1p(np.exp(rng.standard_normal((2, 1, 16)))) \
        * rng.uniform(0.0, 1.0, (2, L, 16))
    a = np.exp(log_a).astype(np.float32)
    b = (np.sqrt(1 - a ** 2) * rng.standard_normal((2, L, 16))).astype(
        np.float32)

    def combine(lhs, rhs):
        return rhs[0] * lhs[0], rhs[0] * lhs[1] + rhs[1]

    _, want = jax.lax.associative_scan(combine, (jnp.asarray(a),
                                                 jnp.asarray(b)), axis=1)
    got = tr.linear_scan(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.float32
    _close(got, want, "float32", "h")
    assert torch.isfinite(got).all()


def test_spec_matches_reference():
    want = jr.rglru_spec(jax_cfg(ARCH))
    got = tr.rglru_spec(torch_cfg(ARCH))
    assert set(got) == set(want)
    for k, s in want.items():
        assert (tuple(got[k].shape), got[k].axes, got[k].init,
                str(got[k].dtype).split(".")[-1]) == \
            (tuple(s.shape), s.axes, s.init, np.dtype(s.dtype).name), k


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("L", [2, 29])
def test_rglru_full_matches_reference(L, dtype):
    """y, the last h (f32) and the conv state (the pre-conv projection's
    last w-1 rows); L=2 is shorter than w-1 = 3, as the reference keeps
    it."""
    pj, pt = _params(dtype)
    xj, xt = _x((2, L, jax_cfg(ARCH).d_model), dtype)
    yj, sj = jr.rglru_full(pj, jax_cfg(ARCH), xj)
    yt, st = tr.rglru_full(pt, torch_cfg(ARCH), xt)
    assert yt.dtype == xt.dtype and st["h"].dtype == torch.float32
    assert st["conv"].dtype == xt.dtype
    _close(yt, yj, dtype, "y")
    _close(st["h"], sj["h"], dtype, "h")
    _close(st["conv"], sj["conv"], dtype, "conv")


@pytest.mark.parametrize("dtype", DTYPES)
def test_rglru_decode_matches_reference(dtype):
    """Three steps from a random state, each step's state fed to the next."""
    jc, tc = jax_cfg(ARCH), torch_cfg(ARCH)
    pj, pt = _params(dtype, seed=3)
    rng = np.random.default_rng(4)
    h = rng.standard_normal((2, 64)).astype(np.float32)
    conv = rng.standard_normal((2, 3, 64)).astype(np.float32)
    sj = {"h": jnp.asarray(h), "conv": jnp.asarray(conv, getattr(jnp, dtype))}
    st = {"h": torch.from_numpy(h),
          "conv": torch.from_numpy(conv).to(getattr(torch, dtype))}
    for step in range(3):
        xj, xt = _x((2, 1, jc.d_model), dtype, seed=10 + step)
        yj, sj = jr.rglru_decode(pj, jc, xj, sj)
        yt, st = tr.rglru_decode(pt, tc, xt, st)
        _close(yt, yj, dtype, f"y{step}")
        _close(st["h"], sj["h"], dtype, f"h{step}")
        _close(st["conv"], sj["conv"], dtype, f"conv{step}")


def test_rglru_state_matches_reference():
    want = jr.rglru_state(jax_cfg(ARCH), 3)
    got = tr.rglru_state(torch_cfg(ARCH), 3, device="cpu")
    for k, a in want.items():
        assert tuple(got[k].shape) == a.shape
        assert str(got[k].dtype).split(".")[-1] == np.dtype(a.dtype).name
        assert not got[k].any()
