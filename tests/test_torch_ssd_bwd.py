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
import torch.nn.functional as F

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


# ------------------------------------------- the bf16 kernel's rounding points

def _bf(t):
    """t rounded to bf16, back in f32."""
    return t.to(torch.bfloat16).float()


def _two_parts(s):
    """An f32 state as the bf16 kernel carries it into a product: a high
    bf16 part and the bf16 rounding of the rest."""
    hi = _bf(s)
    return hi + _bf(s - hi)


def _bf16_kernel_emulation(x, dt, a, b, c, dy, ds, *, chunk):
    """(dx, ddt, da, db, dc) with csrc/ssd_scan_bwd.cu's bf16 rounding
    points, in plain f32 torch: S = C·Bᵀ and M = dy·uᵀ exact from the bf16
    inputs (u = bf16(x·dt)); W = S∘L and X = L∘M rounded to bf16 before du,
    dB and dC; the chunk-state operands u·to_end and dy·exp(cum) rounded to
    bf16; S_in and dS_out as two bf16 parts in every product; the sums of
    T = W∘M, ⟨dS_out, S_in⟩ and the outputs' f32 sums as the kernel takes
    them. x, b, c and dy are f32 tensors holding bf16 values."""
    Bt, L, H, Pd = x.shape
    N = b.shape[-1]
    Q = min(chunk, L)
    L0 = L
    u = _bf(x * dt[..., None])
    xf, dyf, bf, cf = x, dy, b, c
    if L % Q:
        pad = Q - L % Q
        u, xf, dyf = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (u, xf, dyf))
        dt = F.pad(dt, (0, 0, 0, pad))
        bf, cf = (F.pad(t, (0, 0, 0, pad)) for t in (bf, cf))
        L += pad
    nc = L // Q
    u_c = u.reshape(Bt, nc, Q, H, Pd)
    dy_c = dyf.reshape(Bt, nc, Q, H, Pd)
    b_c, c_c = bf.reshape(Bt, nc, Q, N), cf.reshape(Bt, nc, Q, N)
    cum = torch.cumsum((dt * a).reshape(Bt, nc, Q, H), dim=2)
    tri = torch.tril(torch.ones((Q, Q), dtype=torch.bool))[None, None, :, :,
                                                           None]
    rel = cum[:, :, :, None, :] - cum[:, :, None, :, :]
    lmat = torch.where(tri, torch.exp(torch.where(tri, rel, 0.0)), 0.0)
    to_end = torch.exp(cum[:, :, -1:, :] - cum)
    decay_in = torch.exp(cum)
    t_total = torch.exp(cum[:, :, -1, :])

    s_chunk = torch.einsum("bcqhp,bcqn->bchpn",
                           _bf(u_c * to_end[..., None]), b_c)
    g_chunk = torch.einsum("bcqhp,bcqn->bchpn",
                           _bf(dy_c * decay_in[..., None]), c_c)
    s = torch.zeros((Bt, H, Pd, N))
    s_in = []
    for ci in range(nc):
        s_in.append(s)
        s = s * t_total[:, ci, :, None, None] + s_chunk[:, ci]
    g = torch.zeros_like(s) if ds is None else ds
    ds_out = [None] * nc
    for ci in reversed(range(nc)):
        ds_out[ci] = g
        g = g_chunk[:, ci] + t_total[:, ci, :, None, None] * g
    s_in, ds_out = torch.stack(s_in, dim=1), torch.stack(ds_out, dim=1)
    s_in2, ds_out2 = _two_parts(s_in), _two_parts(ds_out)

    scores = torch.einsum("bcqn,bckn->bcqk", c_c, b_c)
    m = torch.einsum("bcqhp,bckhp->bcqkh", dy_c, u_c)
    w = scores[..., None] * lmat
    xm = lmat * m
    t = w * m
    ds_b = torch.einsum("bchpn,bckn->bckhp", ds_out2, b_c)
    du = (torch.einsum("bcqkh,bcqhp->bckhp", _bf(w), dy_c)
          + to_end[..., None] * ds_b)
    dc_ = (torch.einsum("bcqkh,bckn->bcqn", _bf(xm), b_c)
           + torch.einsum("bcqh,bchpn,bcqhp->bcqn", decay_in, s_in2, dy_c))
    db_ = (torch.einsum("bcqkh,bcqn->bckn", _bf(xm), c_c)
           + torch.einsum("bckh,bchpn,bckhp->bckn", to_end, ds_out2, u_c))
    y_inter = torch.einsum("bcqn,bcqh,bchpn->bcqhp", c_c, decay_in, s_in2)
    v = to_end * (u_c * ds_b).sum(-1)
    dcum = t.sum(3) - t.sum(2) + (dy_c * y_inter).sum(-1) - v
    dcum[:, :, -1] += v.sum(2) + t_total * (ds_out * s_in).sum((-2, -1))
    dda = torch.flip(torch.cumsum(torch.flip(dcum, [2]), 2), [2])
    dda = dda.reshape(Bt, L, H)
    du = du.reshape(Bt, L, H, Pd)
    ddt = dda * a + (du * xf).sum(-1)
    return (_bf(du * dt[..., None])[:, :L0], ddt[:, :L0],
            (dda * dt).sum((0, 1)), _bf(db_.reshape(Bt, L, N))[:, :L0],
            _bf(dc_.reshape(Bt, L, N))[:, :L0])


@pytest.mark.parametrize("with_state", [False, True])
def test_bf16_kernel_rounding_matches_reference_vjp(with_state):
    """The bf16 kernel's design, emulated on the CPU at mamba2-130m's widths
    (P=64, N=128, chunk 256) over three chunks with a ragged tail and three
    heads: every gradient within SSD_TOL["bfloat16"] of its largest element
    of jax.vjp of ssd_reference in f32 on the same bf16 values."""
    case = (1, 600, 3, 64, 128, 256)
    x, dt, a, b, c = _ssd_inputs(case)
    dy, ds = _cotangents(case)
    x, b, c, dy = (torch.from_numpy(t).to(torch.bfloat16).float().numpy()
                   for t in (x, b, c, dy))
    _, vjp = jax.vjp(lambda *t: ssd_reference(*t, chunk=256),
                     *(jnp.asarray(t) for t in (x, dt, a, b, c)))
    want = vjp((jnp.asarray(dy),
                jnp.asarray(ds if with_state else np.zeros_like(ds))))
    got = _bf16_kernel_emulation(
        *(torch.from_numpy(t) for t in (x, dt, a, b, c, dy)),
        torch.from_numpy(ds) if with_state else None, chunk=256)
    for name, g, w in zip(NAMES, got, want):
        _assert_close(g, w, SSD_TOL["bfloat16"], name)
