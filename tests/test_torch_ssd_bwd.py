"""Port parity for the SSD scan's backward (``ssd_scan_bwd_plain``, what a
CPU tensor runs, and the ``SSDScan`` autograd.Function around the scan):
against ``jax.vjp`` of the JAX package's ``ssd_reference`` on the same
numpy inputs, and through the Mamba2 mixer against ``jax.vjp`` of its
``mamba_full``.

Tolerances, of each gradient's largest element: 3e-4 in f32 and 4e-2 in
bf16, the reference's own SSD tolerances (tests/test_torch_kernels.py).
In bf16 the reference's vjp rounds its cotangents where its forward
rounds (x·dt, the decay-weighted scores, the intra-chunk product) and the
port's backward computes in f32 from the bf16 inputs; the reference's own
bf16 gradients lie within 0.7% of its f32 ones at these cases. SSDScan on
the CPU is held to autograd of the plain forward within 1e-5 of each
gradient's largest element: the same f32 arithmetic in another order.

Cases: tests/test_kernels.py::SSD_CASES, plus four chunks with a ragged
tail over an odd head count (nc >= 3: the incoming states, the reverse
state pass and every inter-chunk term are live)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_cfg
from repro.models import ssm as jssm
from repro.models.ssm import ssd_reference
from repro_torch.configs import get_smoke_config as torch_cfg
from repro_torch.kernels import ssd_scan as ss
from repro_torch.models import ssm as tssm
from test_torch_kernels import SSD_CASES, SSD_TOL, _ssd_inputs
from test_torch_ssm import _params

BWD_CASES = SSD_CASES + [(2, 100, 5, 16, 16, 32)]
NAMES = ("x", "dt", "a", "b", "c")


def _cotangents(case, seed=3):
    B, L, H, P, N, _ = case
    rng = np.random.default_rng(seed)
    dy = rng.standard_normal((B, L, H, P)).astype(np.float32)
    ds = rng.standard_normal((B, H, P, N)).astype(np.float32)
    return dy, ds


def _assert_close(got, want, tol, what):
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy()
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got - want).max())
    bound = tol * float(np.abs(want).max())
    assert err <= bound, (what, err, bound)


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", BWD_CASES)
def test_ssd_scan_bwd_plain_matches_reference_vjp(case, dtype, with_state):
    chunk = case[-1]
    x, dt, a, b, c = _ssd_inputs(case)
    dy, ds = _cotangents(case)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    _, vjp = jax.vjp(lambda *t: ssd_reference(*t, chunk=chunk),
                     jnp.asarray(x, jd), jnp.asarray(dt), jnp.asarray(a),
                     jnp.asarray(b, jd), jnp.asarray(c, jd))
    want = vjp((jnp.asarray(dy, jd),
                jnp.asarray(ds if with_state else np.zeros_like(ds))))
    got = ss.ssd_scan_bwd_plain(
        torch.from_numpy(x).to(td), torch.from_numpy(dt), torch.from_numpy(a),
        torch.from_numpy(b).to(td), torch.from_numpy(c).to(td),
        torch.from_numpy(dy).to(td),
        torch.from_numpy(ds) if with_state else None, chunk=chunk)
    for name, g, w, t in zip(NAMES, got, want, (td, torch.float32,
                                                torch.float32, td, td)):
        assert g.dtype == t, name
        _assert_close(g, w, SSD_TOL[dtype], name)


@pytest.mark.parametrize("case", BWD_CASES)
def test_ssd_scan_function_matches_autograd_of_plain(case):
    """ssd_scan under grad goes through SSDScan, whose backward on a CPU
    tensor is ssd_scan_bwd_plain: against autograd of ssd_scan_plain, with
    cotangents on both outputs."""
    chunk = case[-1]
    inputs = [torch.from_numpy(t) for t in _ssd_inputs(case)]
    dy, ds = (torch.from_numpy(t) for t in _cotangents(case))

    def grads(fn):
        leaves = [t.clone().requires_grad_() for t in inputs]
        y, state = fn(*leaves, chunk=chunk)
        return torch.autograd.grad((y * dy).sum() + (state * ds).sum(),
                                   leaves)

    for name, g, w in zip(NAMES, grads(ss.ssd_scan),
                          grads(ss.ssd_scan_plain)):
        _assert_close(g, w.numpy(), 1e-5, name)


def test_ssd_scan_function_takes_one_unused_output():
    """A loss of y alone (the train path: the final state is dropped) and of
    the state alone (which c does not reach: its gradient is zero)."""
    case = BWD_CASES[-1]
    inputs = [torch.from_numpy(t) for t in _ssd_inputs(case)]
    for pick in (0, 1):
        got = [t.clone().requires_grad_() for t in inputs]
        want = [t.clone().requires_grad_() for t in inputs]
        g = torch.autograd.grad(ss.ssd_scan(*got, chunk=32)[pick].sum(), got)
        w = torch.autograd.grad(
            ss.ssd_scan_plain(*want, chunk=32)[pick].sum(), want,
            allow_unused=True)
        for name, a, b, t in zip(NAMES, g, w, want):
            _assert_close(a, (torch.zeros_like(t) if b is None else b
                              ).detach().numpy(), 1e-5, name)


@pytest.mark.parametrize("L", [32, 21])          # whole chunks; ragged tail
def test_mamba_full_gradients_match_reference(L):
    """The Mamba2 mixer at the mamba2-130m smoke size in f32, weights
    bridged from the reference: the input's and every parameter's gradient
    of a random projection of y against jax.vjp of the reference's
    mamba_full, each within 3e-4 of its largest element."""
    jc, tc = jax_cfg("mamba2-130m"), torch_cfg("mamba2-130m")
    pj, pt = _params("float32")
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, L, jc.d_model)).astype(np.float32)
    dy = rng.standard_normal((2, L, jc.d_model)).astype(np.float32)
    _, vjp = jax.vjp(lambda p, x: jssm.mamba_full(p, jc, x)[0], pj,
                     jnp.asarray(x))
    want_p, want_x = vjp(jnp.asarray(dy))
    pt = {k: v.clone().requires_grad_() for k, v in pt.items()}
    xt = torch.from_numpy(x).requires_grad_()
    before = ss.ssd_scan.launches
    y, _ = tssm.mamba_full(pt, tc, xt)
    names = sorted(pt)
    grads = torch.autograd.grad((y * torch.from_numpy(dy)).sum(),
                                [xt] + [pt[k] for k in names])
    assert ss.ssd_scan.launches == before        # the CPU runs no kernel
    _assert_close(grads[0], want_x, SSD_TOL["float32"], "x")
    for k, g in zip(names, grads[1:]):
        _assert_close(g, want_p[k], SSD_TOL["float32"], k)


def test_ssd_scan_bwd_refuses_devices_without_kernel():
    x = torch.zeros((1, 8, 2, 16), device="meta")
    b = torch.zeros((1, 8, 4), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        ss.ssd_scan_bwd(x, b[..., :2], b[0, 0, :2], b, b, x, chunk=4)
