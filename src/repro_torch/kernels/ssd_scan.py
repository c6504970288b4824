"""Mamba2 SSD chunk scan.

Port of the Pallas TPU kernel ``repro/kernels/ssd_scan.py::ssd_scan_bh``.
On a CUDA tensor :func:`ssd_scan` launches the hand-written kernels in
``csrc/ssd_scan.cu`` (chunk states, a short pass over the chunks, then the
outputs; see the source); on a CPU tensor it runs :func:`ssd_scan_plain`,
the port of ``repro/models/ssm.py::ssd_reference``. Any other device
raises. The kernels are chosen by dtype: bfloat16 (the models' type) runs
every product on the tensor cores (wgmma), with the head-independent
scores C·Bᵀ computed once per group of heads; float32 (the parity cases)
runs the CUDA-core kernels.

Layout (the model's, read through strides, no copy): x (B, L, H, P);
dt (B, L, H) f32; a (H,) f32 (negative); b, c (B, L, N), shared by all
heads. Returns y (B, L, H, P) in x's dtype and the final state
(B, H, P, N) in f32.

Under grad the scan is :class:`SSDScan`, whose backward
:func:`ssd_scan_bwd` launches ``csrc/ssd_scan_bwd.cu`` on a CUDA tensor
(the reference leaves this backward to XLA's autodiff of
``ssd_reference``; bfloat16 on the tensor cores, C·Bᵀ once per group of
heads, float32 on the CUDA cores) and runs :func:`ssd_scan_bwd_plain` on a
CPU one.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.kernels import build, work
from repro_torch.utils import cdiv

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def ssd_scan_plain(x, dt, a, b, c, *, chunk: int):
    """Chunked SSD (port of ``ssd_reference``): x·dt and the decay-weighted
    scores are rounded to x's dtype before their products, as the reference
    rounds them; chunk states and the inter-chunk term in f32."""
    Bt, L, H, Pd = x.shape
    N = b.shape[-1]
    Q = min(chunk, L)
    L0 = L
    if L % Q:        # pad tail: dt=0 => decay 1, zero input; state unaffected
        pad = Q - L % Q
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        b = F.pad(b, (0, 0, 0, pad))
        c = F.pad(c, (0, 0, 0, pad))
        L += pad
    nc = L // Q

    xdt = (x.float() * dt[..., None]).to(x.dtype)
    dA = dt * a                                       # (Bt,L,H) log-decay
    cum = torch.cumsum(dA.reshape(Bt, nc, Q, H), dim=2)
    x_c = xdt.reshape(Bt, nc, Q, H, Pd)
    b_c = b.reshape(Bt, nc, Q, N)
    c_c = c.reshape(Bt, nc, Q, N)

    # intra-chunk
    scores = torch.einsum("bcqn,bckn->bcqk", c_c, b_c).float()
    rel = cum[:, :, :, None, :] - cum[:, :, None, :, :]     # (Bt,nc,Q,Q,H)
    tri = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device))
    lmat = torch.where(tri[None, None, :, :, None], torch.exp(rel), 0.0)
    w_full = scores[..., None] * lmat
    y_intra = torch.einsum("bcqkh,bckhp->bcqhp", w_full.to(x.dtype), x_c)

    # chunk summary states
    to_end = torch.exp(cum[:, :, -1:, :] - cum)       # (Bt,nc,Q,H)
    s_chunk = torch.einsum("bcqh,bcqn,bcqhp->bchpn", to_end, b_c.float(),
                           x_c.float())               # (Bt,nc,H,P,N)

    # inter-chunk state recurrence
    t_total = torch.exp(cum[:, :, -1, :])             # (Bt,nc,H)
    s = torch.zeros((Bt, H, Pd, N), dtype=torch.float32, device=x.device)
    s_ins = []
    for ci in range(nc):
        s_ins.append(s)
        s = s * t_total[:, ci, :, None, None] + s_chunk[:, ci]
    s_in = torch.stack(s_ins, dim=1)                  # (Bt,nc,H,P,N) incoming

    y_inter = torch.einsum("bcqn,bcqh,bchpn->bcqhp", c_c.float(),
                           torch.exp(cum), s_in)
    y = (y_intra.float() + y_inter).reshape(Bt, L, H, Pd)
    return y[:, :L0].to(x.dtype), s


def ssd_scan_bwd_plain(x, dt, a, b, c, dy, dstate=None, *, chunk: int):
    """(dx, ddt, da, db, dc) of :func:`ssd_scan_plain` given the output's
    cotangent dy (B,L,H,P) and the final state's, dstate (B,H,P,N) f32 or
    None (zero), from the formulas ``csrc/ssd_scan_bwd.cu`` computes, in
    f32: per chunk u = x·dt (rounded to x's dtype, as the forward rounds
    it), cum the cumulative log-decay, L_qk = exp(cum_q - cum_k) for k <= q,
    s_qk = C_q·B_k, M_qk = dy_q·u_k. Each gradient comes back in its
    input's dtype."""
    Bt, L, H, Pd = x.shape
    N = b.shape[-1]
    Q = min(chunk, L)
    L0 = L
    f32 = torch.float32
    u = (x.float() * dt[..., None]).to(x.dtype).float()
    xf, dyf, bf, cf = x.float(), dy.float(), b.float(), c.float()
    if L % Q:        # padded rows: dt = 0, zero input and zero cotangent
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
    tri = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device))
    tri = tri[None, None, :, :, None]
    rel = cum[:, :, :, None, :] - cum[:, :, None, :, :]    # (Bt,nc,Q,Q,H)
    lmat = torch.where(tri, torch.exp(torch.where(tri, rel, 0.0)), 0.0)
    to_end = torch.exp(cum[:, :, -1:, :] - cum)            # (Bt,nc,Q,H)
    decay_in = torch.exp(cum)                              # <= 1
    t_total = torch.exp(cum[:, :, -1, :])                  # (Bt,nc,H)

    # forward states S_in, then the reverse pass for dS_out
    s_chunk = torch.einsum("bcqh,bcqn,bcqhp->bchpn", to_end, b_c, u_c)
    g_chunk = torch.einsum("bcqh,bcqn,bcqhp->bchpn", decay_in, c_c, dy_c)
    s = torch.zeros((Bt, H, Pd, N), dtype=f32, device=x.device)
    s_in = []
    for ci in range(nc):
        s_in.append(s)
        s = s * t_total[:, ci, :, None, None] + s_chunk[:, ci]
    g = (torch.zeros_like(s) if dstate is None else dstate.float())
    ds_out = [None] * nc
    for ci in reversed(range(nc)):
        ds_out[ci] = g
        g = g_chunk[:, ci] + t_total[:, ci, :, None, None] * g
    s_in, ds_out = torch.stack(s_in, dim=1), torch.stack(ds_out, dim=1)

    scores = torch.einsum("bcqn,bckn->bcqk", c_c, b_c)
    m = torch.einsum("bcqhp,bckhp->bcqkh", dy_c, u_c)
    w = scores[..., None] * lmat                           # s L
    xm = lmat * m                                          # L M
    t = w * m
    ds_b = torch.einsum("bchpn,bckn->bckhp", ds_out, b_c)  # dS_out B_k
    du = (torch.einsum("bcqkh,bcqhp->bckhp", w, dy_c)
          + to_end[..., None] * ds_b)
    dc_ = (torch.einsum("bcqkh,bckn->bcqn", xm, b_c)
           + torch.einsum("bcqh,bchpn,bcqhp->bcqn", decay_in, s_in, dy_c))
    db_ = (torch.einsum("bcqkh,bcqn->bckn", xm, c_c)
           + torch.einsum("bckh,bchpn,bckhp->bckn", to_end, ds_out, u_c))
    y_inter = torch.einsum("bcqn,bcqh,bchpn->bcqhp", c_c, decay_in, s_in)
    v = to_end * (u_c * ds_b).sum(-1)                      # (Bt,nc,Q,H)
    dcum = t.sum(3) - t.sum(2) + (dy_c * y_inter).sum(-1) - v
    dcum[:, :, -1] += v.sum(2) + t_total * (ds_out * s_in).sum((-2, -1))
    dda = torch.flip(torch.cumsum(torch.flip(dcum, [2]), 2), [2])
    dda = dda.reshape(Bt, L, H)
    du = du.reshape(Bt, L, H, Pd)
    ddt = dda * a + (du * xf).sum(-1)
    dx = du * dt[..., None]
    da = (dda * dt).sum((0, 1))
    return (dx[:, :L0].to(x.dtype), ddt[:, :L0].to(dt.dtype), da.to(a.dtype),
            db_.reshape(Bt, L, N)[:, :L0].to(b.dtype),
            dc_.reshape(Bt, L, N)[:, :L0].to(c.dtype))


def _kernel():
    """(launch function, (max P, max N, max chunk)) of the built library."""
    lib = build.load("ssd_scan")
    fn = lib.ssd_scan_launch
    if fn.argtypes is None:
        P, L, I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        fn.argtypes = [I, P, L, L, L, P, L, L, L, P, P, L, L, P, L, L,
                       P, P, P, P, I, I, I, I, I, I, P]
        fn.restype = I
        for name in ("ssd_scan_max_p", "ssd_scan_max_n", "ssd_scan_max_q"):
            getattr(lib, name).argtypes = []
            getattr(lib, name).restype = I
    return fn, (lib.ssd_scan_max_p(), lib.ssd_scan_max_n(),
                lib.ssd_scan_max_q())


def _check(x, dt, a, b, c, Q, limits):
    dev = x.device
    if any(t.device != dev for t in (dt, a, b, c)):
        raise ValueError("ssd_scan: x, dt, a, b and c must share a device")
    if x.dtype not in _DTYPES or b.dtype != x.dtype or c.dtype != x.dtype:
        raise TypeError(f"ssd_scan: x/b/c must all be float32 or bfloat16, "
                        f"got {x.dtype}/{b.dtype}/{c.dtype}")
    if dt.dtype != torch.float32 or a.dtype != torch.float32:
        raise TypeError(f"ssd_scan: dt and a must be float32, got "
                        f"{dt.dtype}/{a.dtype}")
    if x.dim() != 4 or b.dim() != 3 or c.shape != b.shape:
        raise ValueError(f"ssd_scan: want x (B,L,H,P), b/c (B,L,N); got "
                         f"{tuple(x.shape)}, {tuple(b.shape)}, "
                         f"{tuple(c.shape)}")
    B, L, H, P = x.shape
    N = b.shape[-1]
    if dt.shape != (B, L, H) or a.shape != (H,) or b.shape[:2] != (B, L):
        raise ValueError(f"ssd_scan: dt {tuple(dt.shape)}, a "
                         f"{tuple(a.shape)}, b {tuple(b.shape)} do not fit "
                         f"x {tuple(x.shape)}")
    max_p, max_n, max_q = limits
    if P > max_p or N > max_n or Q > max_q:
        raise ValueError(f"ssd_scan: P={P} (max {max_p}), N={N} (max "
                         f"{max_n}) or chunk {Q} (max {max_q}) is not "
                         f"supported")
    if x.stride(-1) != 1 or b.stride(-1) != 1 or c.stride(-1) != 1:
        raise ValueError("ssd_scan: x's, b's and c's last dims must be "
                         "contiguous")
    if not a.is_contiguous():
        raise ValueError("ssd_scan: a must be contiguous")
    if x.dtype == torch.bfloat16:
        check_layout(x, b, c)


def copyable(t):
    """Whether the bf16 kernels' 16-byte copies can read t as it is: its
    base 16-byte aligned and every stride of a dim longer than one, but the
    innermost, a multiple of 8 elements."""
    return t.data_ptr() % 16 == 0 and not any(
        t.stride(i) % 8 for i in range(t.dim() - 1) if t.shape[i] > 1)


def check_layout(x, b, c):
    """Raise unless the bf16 kernel's 16-byte copies can read x, b and c as
    they are: P and N multiples of 8, and each :func:`copyable`."""
    P, N = x.shape[-1], b.shape[-1]
    if P % 8 or N % 8:
        raise ValueError(f"ssd_scan: bf16 needs P and N multiples of 8, got "
                         f"P={P}, N={N}")
    for name, t in (("x", x), ("b", b), ("c", c)):
        if not copyable(t):
            raise ValueError(
                f"ssd_scan: {name} {tuple(t.shape)} with strides "
                f"{t.stride()} cannot be read with 16-byte copies: the base "
                f"must be 16-byte aligned and every stride a multiple of 8 "
                f"elements")


def _work(x, b, chunk, backward=False) -> int:
    """The kernels' operations on these shapes (``kernels/work.py``)."""
    B, L, H, P = x.shape
    return work.ssd_flops(B, L, H, P, b.shape[-1], chunk, backward)


def _forward(x, dt, a, b, c, chunk):
    """(y, state): the plain version on a CPU tensor, the kernel on a CUDA
    one (counted in ``ssd_scan.launches``); any other device raises."""
    if x.device.type == "cpu":
        return work.plain("ssd_scan", lambda: _work(x, b, chunk),
                          ssd_scan_plain, x, dt, a, b, c, chunk=chunk)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan: no kernel for device {x.device}")
    launch, limits = _kernel()
    B, L, H, P = x.shape
    N = b.shape[-1]
    Q = min(chunk, L)
    _check(x, dt, a, b, c, Q, limits)
    nc = cdiv(L, Q)
    dev = x.device
    y = torch.empty((B, L, H, P), dtype=x.dtype, device=dev)
    state = torch.empty((B, H, P, N), dtype=torch.float32, device=dev)
    # the chunks' own states; for bf16 also the incoming states as two bf16
    # parts (see the source)
    n_scratch = (2 if x.dtype == torch.bfloat16 else 1) * B * H * nc * P * N
    chunk_state = torch.empty((n_scratch,), dtype=torch.float32, device=dev)
    tot = torch.empty((B * H * nc,), dtype=torch.float32, device=dev)
    rc = launch(
        _DTYPES[x.dtype],
        x.data_ptr(), x.stride(0), x.stride(1), x.stride(2),
        dt.data_ptr(), dt.stride(0), dt.stride(1), dt.stride(2),
        a.data_ptr(), b.data_ptr(), b.stride(0), b.stride(1),
        c.data_ptr(), c.stride(0), c.stride(1),
        y.data_ptr(), state.data_ptr(), chunk_state.data_ptr(),
        tot.data_ptr(), B, L, H, P, N, Q,
        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"ssd_scan kernel launch failed: cudaError {rc}")
    ssd_scan.launches += 1
    return y, state


def _bwd_kernel():
    """(launch function, scratch-size function, (max P, max N, max chunk))
    of the built backward library."""
    lib = build.load("ssd_scan_bwd")
    fn = lib.ssd_scan_bwd_launch
    if fn.argtypes is None:
        P, L, I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        fn.argtypes = ([I, P, L, L, L, P, L, L, L, P, P, L, L, P, L, L,
                        P, L, L, L, P] + [P] * 6 + [I] * 6 + [P])
        fn.restype = I
        lib.ssd_scan_bwd_scratch_floats.argtypes = [I] * 7
        lib.ssd_scan_bwd_scratch_floats.restype = L
        for name in ("max_p", "max_n", "max_q"):
            getattr(lib, f"ssd_scan_bwd_{name}").argtypes = []
            getattr(lib, f"ssd_scan_bwd_{name}").restype = I
    return fn, lib.ssd_scan_bwd_scratch_floats, (
        lib.ssd_scan_bwd_max_p(), lib.ssd_scan_bwd_max_n(),
        lib.ssd_scan_bwd_max_q())


def ssd_scan_bwd(x, dt, a, b, c, dy, dstate=None, *, chunk: int):
    """(dx, ddt, da, db, dc) of the scan given the output's cotangent dy
    (B,L,H,P) in x's dtype and the final state's, dstate (B,H,P,N) f32 or
    None. CPU tensors run :func:`ssd_scan_bwd_plain`; CUDA tensors launch
    the kernels of ``csrc/ssd_scan_bwd.cu`` (one call, one count in
    ``ssd_scan_bwd.launches``; bfloat16 on the tensor cores, float32 on the
    CUDA cores) or raise. The forward's inputs are read through their
    strides as the forward reads them; a dy that the kernel cannot read as
    it is (an innermost dim that is not contiguous, as autograd's expanded
    zeros or ones have, or for bfloat16 a stride or base that
    :func:`copyable` refuses) is made contiguous first, and dstate always
    is."""
    if x.device.type == "cpu":
        return work.plain("ssd_scan_bwd", lambda: _work(x, b, chunk, True),
                          ssd_scan_bwd_plain, x, dt, a, b, c, dy, dstate,
                          chunk=chunk)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan_bwd: no kernel for device {x.device}")
    launch, scratch_floats, limits = _bwd_kernel()
    B, L, H, P = x.shape
    N = b.shape[-1]
    Q = min(chunk, L)
    _check(x, dt, a, b, c, Q, limits)
    if dy.shape != x.shape or dy.dtype != x.dtype or dy.device != x.device:
        raise ValueError(f"ssd_scan_bwd: dy {tuple(dy.shape)} {dy.dtype} "
                         f"does not match x {tuple(x.shape)} {x.dtype}")
    if dy.stride(-1) != 1 or (dy.dtype == torch.bfloat16
                              and not copyable(dy)):
        dy = dy.contiguous()
    if dstate is not None:
        if (dstate.shape != (B, H, P, N) or dstate.dtype != torch.float32
                or dstate.device != x.device):
            raise ValueError(f"ssd_scan_bwd: dstate must be an f32 "
                             f"(B, H, P, N) on x's device, got "
                             f"{tuple(dstate.shape)} {dstate.dtype}")
        dstate = dstate.contiguous()
    dev = x.device
    dx = torch.empty((B, L, H, P), dtype=x.dtype, device=dev)
    ddt = torch.empty((B, L, H), dtype=torch.float32, device=dev)
    da = torch.empty((H,), dtype=torch.float32, device=dev)
    db = torch.empty((B, L, N), dtype=b.dtype, device=dev)
    dc = torch.empty((B, L, N), dtype=c.dtype, device=dev)
    scratch = torch.empty((scratch_floats(_DTYPES[x.dtype], B, L, H, P, N,
                                          Q),),
                          dtype=torch.float32, device=dev)
    rc = launch(
        _DTYPES[x.dtype],
        x.data_ptr(), x.stride(0), x.stride(1), x.stride(2),
        dt.data_ptr(), dt.stride(0), dt.stride(1), dt.stride(2),
        a.data_ptr(), b.data_ptr(), b.stride(0), b.stride(1),
        c.data_ptr(), c.stride(0), c.stride(1),
        dy.data_ptr(), dy.stride(0), dy.stride(1), dy.stride(2),
        dstate.data_ptr() if dstate is not None else None,
        dx.data_ptr(), ddt.data_ptr(), da.data_ptr(), db.data_ptr(),
        dc.data_ptr(), scratch.data_ptr(), B, L, H, P, N, Q,
        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"ssd_scan_bwd kernel launch failed: cudaError "
                           f"{rc}")
    ssd_scan_bwd.launches += 1
    return dx, ddt, da, db, dc


ssd_scan_bwd.launches = 0


class SSDScan(torch.autograd.Function):
    """The scan with the hand-written backward: the forward saves its
    inputs (what remat would keep) and the backward recomputes the chunk
    states from them."""

    @staticmethod
    def forward(ctx, x, dt, a, b, c, chunk):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x, dt, a, b, c)
        ctx.chunk = chunk
        return _forward(x, dt, a, b, c, chunk)

    @staticmethod
    def backward(ctx, dy, dstate):
        x, dt, a, b, c = ctx.saved_tensors
        if dy is None:                   # only the final state was used
            dy = torch.zeros_like(x)
        return (*ssd_scan_bwd(x, dt, a, b, c, dy, dstate, chunk=ctx.chunk),
                None)


def ssd_scan(x, dt, a, b, c, *, chunk: int):
    """x (B,L,H,P); dt (B,L,H) f32; a (H,) f32; b, c (B,L,N) ->
    (y (B,L,H,P) in x's dtype, state (B,H,P,N) f32).

    CPU tensors run the plain version; CUDA tensors launch the kernel or
    raise. When grad is enabled and an input requires it, the call goes
    through :class:`SSDScan`, whose backward is :func:`ssd_scan_bwd`.
    ``ssd_scan.launches`` counts forward kernel launches (one per call: the
    three passes of the source)."""
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in (x, dt, a, b, c)):
        return SSDScan.apply(x, dt, a, b, c, int(chunk))
    return _forward(x, dt, a, b, c, chunk)


ssd_scan.launches = 0
