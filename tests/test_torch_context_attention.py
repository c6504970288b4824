"""The segment-parallel context attention (``models/flash_xla.py``) and the
kernel changes it needs: the attention kernels' key offset ``k0`` and the
decode kernel's row log-sum-exp.

On the CPU (the wrappers' plain versions):

* ``flash_xla.flash_attention_xla(..., segments=n)``, forward and gradients,
  against the JAX package's ``flash_attention_xla(..., segments=n)`` run
  unmeshed (its ``_make_seg_flash``): n = 2, 4 and 16 over 256 keys; causal
  GQA, a window, a softcap, and K/V expanded to one head per query head
  (the reference's ``kv_dim_is_heads``); f32 within 2e-4 and bf16 within
  2e-2 (rtol = atol, the reference's attention tolerances). In bf16 the
  reference accumulates each segment's output in bf16 and the port in f32,
  and the port's dq is the f32 sum of the segments' bf16-rounded parts
  where the reference sums in f32 before one rounding.
* The plain versions with ``k0`` (attention forward and lse, backward)
  against a float64 mask oracle on the rows that see a key of the segment.
* Dead rows (no key of the segment): weight exactly 0 in the merge, no NaN,
  whether they carry the plain version's lse (NEG_INF + log Skv) or the
  kernel's sentinel (NEG_INF + log 1e-37); a row dead in every segment
  merges to a finite value.
* ``flash_decode_plain(return_lse=True)`` over a cache cut into shards,
  merged, against the whole cache's call and the JAX package's oracle.

On a card (``gpu``, skipped here: the CUDA kernels have no CPU mode): the
forward kernel with ``k0`` against the plain version on live rows, in f32
and bf16; each segment's backward kernel against the plain version from
the merged out and lse; the segment path against the whole-sequence kernel,
forward and gradients; the decode kernel's lse against the plain version's,
and its shards merged against the whole call.
"""
import math

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import flash_decode as fd
from repro_torch.kernels import ops
from repro_torch.models import flash_xla

TOL = {"float32": 2e-4, "bfloat16": 2e-2}
SEGMENTS = [2, 4, 16]
# B, S, H, K, D, causal, window, cap, kv_dim_is_heads
SEG_CASES = [
    (2, 256, 6, 2, 16, True, 0, 0.0, False),
    (1, 256, 4, 2, 16, True, 40, 0.0, False),
    (1, 256, 4, 1, 32, True, 0, 30.0, False),
    (1, 256, 4, 4, 16, True, 0, 0.0, True),
]
# B, Sq, Skv (the segment), H, K, D, causal, window, cap, k0
K0_CASES = [
    (1, 96, 32, 4, 2, 16, True, 0, 0.0, 32),
    (2, 128, 48, 6, 2, 16, True, 24, 0.0, 48),
    (1, 80, 16, 2, 1, 32, True, 0, 20.0, 64),
    (1, 64, 40, 2, 2, 16, False, 0, 0.0, 24),
]


def _torch(a, dtype):
    return torch.from_numpy(np.ascontiguousarray(a)).to(getattr(torch, dtype))


def _np(t):
    return t.detach().float().cpu().numpy()


def _seg_inputs(case, seed=3):
    B, S, H, K, D = case[:5]
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape).astype(np.float32) for shape in
                 ((B, S, H, D), (B, S, K, D), (B, S, K, D), (B, S, H, D)))


def _reference(case, n, dtype, q, k, v, dout):
    """(out, (dq, dk, dv)) of the JAX package's flash_attention_xla with
    ``segments=n``, unmeshed, in the port's layout, as float32 arrays."""
    import jax
    import jax.numpy as jnp
    from repro.models.flash_xla import flash_attention_xla
    B, S, H, K, D, causal, window, cap, expanded = case
    G = 1 if expanded else H // K
    jd = getattr(jnp, dtype)

    def f(q_, k_, v_):
        return flash_attention_xla(
            q_.reshape(B, S, H // G, G, D), k_, v_, causal=causal,
            window=window, cap=cap, kv_dim_is_heads=expanded,
            segments=n).reshape(B, S, H, D)

    args = [jnp.asarray(a, jd) for a in (q, k, v)]
    out, vjp = jax.vjp(f, *args)
    grads = vjp(jnp.asarray(dout, jd))
    return (np.asarray(out, np.float32),
            tuple(np.asarray(g, np.float32) for g in grads))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", SEG_CASES)
@pytest.mark.parametrize("n", SEGMENTS)
def test_segmented_matches_reference(n, case, dtype):
    B, S, H, K, D, causal, window, cap, _ = case
    q, k, v, dout = _seg_inputs(case)
    want_out, want = _reference(case, n, dtype, q, k, v, dout)
    tq, tk, tv = (_torch(a, dtype).requires_grad_() for a in (q, k, v))
    assert flash_xla.segmented(S, n)
    out = flash_xla.flash_attention_xla(tq, tk, tv, causal=causal,
                                        window=window, cap=cap, segments=n)
    assert out.grad_fn is not None and out.dtype == tq.dtype
    out.backward(_torch(dout, dtype))
    tol = TOL[dtype]
    np.testing.assert_allclose(_np(out), want_out, rtol=tol, atol=tol)
    for name, t, w in zip("qkv", (tq, tk, tv), want):
        assert t.grad.dtype == t.dtype and t.grad.shape == t.shape
        np.testing.assert_allclose(_np(t.grad), w, rtol=tol, atol=tol,
                                   err_msg=f"d{name}")


def test_segmented_condition_is_the_reference_s():
    assert not flash_xla.segmented(256, 1)
    assert not flash_xla.segmented(250, 4)          # not a whole number
    assert not flash_xla.segmented(240, 16)         # 15 keys a segment
    assert flash_xla.segmented(256, 16)
    q = torch.randn(1, 240, 2, 16)
    k = torch.randn(1, 240, 1, 16)
    # too short a segment: the whole-sequence call, the same output
    torch.testing.assert_close(
        flash_xla.flash_attention_xla(q, k, k, causal=True, segments=16),
        fa.flash_attention(q, k, k, causal=True), rtol=0, atol=0)


def _oracle(q, k, v, dout, causal, window, cap, k0):
    """float64 (out, lse, live rows, dq, dk, dv) of attention over one
    segment of keys at positions k0.., from the full softmax over it."""
    B, Sq, H, D = q.shape
    Skv, K = k.shape[1], k.shape[2]
    G = H // K
    qf, kf, vf, gf = (torch.from_numpy(a).double().requires_grad_()
                      for a in (q, k, v, dout))
    s = torch.einsum("bqkgd,bskd->bkgqs",
                     qf.reshape(B, Sq, K, G, D) * D ** -0.5, kf)
    if cap:
        s = cap * torch.tanh(s / cap)
    qpos = torch.arange(Sq)[:, None]
    kpos = k0 + torch.arange(Skv)[None, :]
    mask = torch.ones(Sq, Skv, dtype=torch.bool)
    if causal:
        mask &= qpos >= kpos
    if window:
        mask &= qpos - kpos < window
    s = s.masked_fill(~mask, -math.inf)
    live = mask.any(dim=1)
    s = torch.where(live[:, None], s, torch.zeros(()).double())
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None])
    out = torch.einsum("bkgqs,bskd->bqkgd", p, vf).reshape(B, Sq, H, D)
    out = out * live[None, :, None, None]
    dq, dk, dv = torch.autograd.grad(out, (qf, kf, vf), gf)
    return (out.detach().numpy(), lse.reshape(B, H, Sq).detach().numpy(),
            live.numpy(), dq.numpy(), dk.numpy(), dv.numpy())


@pytest.mark.parametrize("case", K0_CASES)
def test_k0_plain_matches_mask_oracle(case):
    B, Sq, Skv, H, K, D, causal, window, cap, k0 = case
    rng = np.random.default_rng(5)
    q, dout = (rng.standard_normal((B, Sq, H, D)).astype(np.float32)
               for _ in range(2))
    k, v = (rng.standard_normal((B, Skv, K, D)).astype(np.float32)
            for _ in range(2))
    want_out, want_lse, live, dq, dk, dv = _oracle(q, k, v, dout, causal,
                                                   window, cap, k0)
    assert live.any() and (not causal or not live.all())
    kw = dict(causal=causal, window=window, cap=cap, k0=k0)
    tq, tk, tv, tg = (torch.from_numpy(a) for a in (q, k, v, dout))
    out, lse = fa.flash_attention_plain(tq, tk, tv, return_lse=True, **kw)
    np.testing.assert_allclose(out.numpy()[:, live], want_out[:, live],
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(lse.numpy()[..., live], want_lse[..., live],
                               rtol=1e-5, atol=1e-5)
    # the plain version's dead rows: lse at NEG_INF (+ log Skv, lost to f32)
    assert (lse.numpy()[..., ~live] <= fa.NEG_INF / 2).all()
    # the backward of one segment given the rows' out and lse, the dead
    # rows' as a merge over segments leaves them for this one: out 0 (the
    # oracle's) and a finite lse (every score NEG_INF: p = 0, no term)
    dead = torch.from_numpy(~live)
    out = torch.where(dead[None, :, None, None], 0.0, out)
    lse = torch.where(dead, 0.0, lse)
    got = fa.flash_attention_bwd_plain(tq, tk, tv, out, lse, tg, **kw)
    for name, g, w in zip("qkv", got, (dq, dk, dv)):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4, atol=1e-4,
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("sentinel", ["plain", "kernel"])
def test_dead_rows_merge_with_weight_zero(sentinel):
    """Segment 1 of a causal split is dead for the rows before its first
    key: their weight is exactly 0 and the merge equals segment 0's rows,
    with no NaN; a row dead everywhere merges to a finite value."""
    B, S, H, K, D = 1, 64, 2, 1, 16
    rng = np.random.default_rng(9)
    q = torch.from_numpy(rng.standard_normal((B, S, H, D)).astype(np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((B, S, K, D)).astype(
        np.float32)) for _ in range(2))
    parts = [fa.flash_attention_plain(q, k[:, a:a + 32], v[:, a:a + 32],
                                      return_lse=True, k0=a)
             for a in (0, 32)]
    if sentinel == "kernel":          # the kernel's dead q tile: out 0
        o1, l1 = parts[1]
        dead = torch.arange(S) < 32
        o1 = torch.where(dead[None, :, None, None], 0.0, o1)
        l1 = torch.where(dead, flash_xla.NEG_INF + math.log(1e-37), l1)
        parts[1] = (o1, l1)
    w, _ = ops.merge_weights(torch.stack([l for _, l in parts]))
    assert (w[1][..., :32] == 0).all()
    out, lse = ops.merge([o for o, _ in parts], [l for _, l in parts])
    assert torch.isfinite(out).all() and torch.isfinite(lse).all()
    torch.testing.assert_close(out[:, :32], parts[0][0][:, :32],
                               rtol=0, atol=0)
    whole = fa.flash_attention_plain(q, k, v)
    torch.testing.assert_close(out, whole, rtol=1e-5, atol=1e-5)
    # a row no segment sees: every lse at the sentinel, weights 1/n
    dead = [torch.full_like(parts[0][1], fa.NEG_INF) for _ in range(2)]
    out, lse = ops.merge([o for o, _ in parts], dead)
    assert torch.isfinite(out).all() and torch.isfinite(lse).all()


DECODE_CASES = [
    # B, S, H, K, D, window, cur, shards
    (2, 64, 4, 2, 32, 0, 40, 2),
    (1, 128, 14, 2, 64, 0, 100, 4),
    (1, 64, 4, 1, 16, 16, 50, 4),
    (1, 96, 8, 2, 16, 0, 95, 3),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", DECODE_CASES)
def test_decode_shards_merge_to_whole_and_oracle(case, dtype):
    import jax.numpy as jnp
    from repro.kernels import ref
    B, S, H, K, D, window, cur, n = case
    rng = np.random.default_rng(2)
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    k, v = (rng.standard_normal((B, S, K, D)).astype(np.float32)
            for _ in range(2))
    kpos = torch.arange(S, dtype=torch.int32)
    tq, tk, tv = (_torch(a, dtype) for a in (q, k, v))
    whole, lse = fd.flash_decode(tq, tk, tv, kpos, cur, window=window,
                                 return_lse=True)
    assert lse.shape == (B, H) and lse.dtype == torch.float32
    c = S // n
    parts = [fd.flash_decode(tq, tk[:, a:a + c], tv[:, a:a + c],
                             kpos[a:a + c], cur, window=window,
                             return_lse=True) for a in range(0, S, c)]
    out, lse_tot = ops.merge([o for o, _ in parts],
                                   [l for _, l in parts])
    tol = TOL[dtype]
    np.testing.assert_allclose(_np(out), _np(whole), rtol=tol, atol=tol)
    np.testing.assert_allclose(lse_tot.numpy(), lse.numpy(), rtol=1e-5,
                               atol=1e-5)
    jd = getattr(jnp, dtype)
    want = ref.flash_decode_ref(
        jnp.asarray(q.reshape(B * K, H // K, D), jd),
        jnp.asarray(k.transpose(0, 2, 1, 3).reshape(B * K, S, D), jd),
        jnp.asarray(v.transpose(0, 2, 1, 3).reshape(B * K, S, D), jd),
        jnp.asarray(kpos.numpy()), cur, window=window)
    np.testing.assert_allclose(_np(out), np.asarray(want, np.float32).reshape(
        B, H, D), rtol=tol, atol=tol)


# ------------------------------------------------------------- card only

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")


def _rel_err(got, want):
    want = want.float()
    return ((got.float() - want).abs().max()
            / want.abs().max().clamp(min=1e-30)).item()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", K0_CASES + [
    (1, 2048, 128, 14, 2, 64, True, 0, 0.0, 1024),
    (1, 3072, 1536, 10, 1, 256, True, 2048, 0.0, 1536),
    (2, 300, 100, 16, 8, 128, True, 64, 50.0, 150)])
def test_k0_cuda_matches_plain(case, dtype):
    """Forward kernel with k0 against the plain version on the rows that
    see a key; the kernel's other rows: out 0 or finite, lse at NEG_INF."""
    _card()
    B, Sq, Skv, H, K, D, causal, window, cap, k0 = case
    g = torch.Generator(device="cuda").manual_seed(0)
    dt = getattr(torch, dtype)
    q = torch.randn((B, Sq, H, D), generator=g, device="cuda").to(dt)
    k, v = (torch.randn((B, Skv, K, D), generator=g, device="cuda").to(dt)
            for _ in range(2))
    kw = dict(causal=causal, window=window, cap=cap, k0=k0)
    before = fa.flash_attention.launches
    out, lse = fa._forward(q, k, v, causal, window, cap, True, k0=k0)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 1
    want, want_lse = fa.flash_attention_plain(q, k, v, return_lse=True, **kw)
    live = fa._mask(Sq, Skv, causal, window, "cuda", k0).any(dim=1)
    tol = TOL[dtype]
    torch.testing.assert_close(out[:, live].float(), want[:, live].float(),
                               rtol=tol, atol=tol)
    torch.testing.assert_close(lse[..., live], want_lse[..., live],
                               rtol=TOL["float32"], atol=TOL["float32"])
    assert torch.isfinite(out).all()
    assert (lse[..., ~live] <= fa.NEG_INF / 2).all()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,shape", [(2, (1, 256, 6, 2, 16)),
                                     (16, (1, 2048, 14, 2, 64)),
                                     (4, (2, 512, 16, 8, 128))])
def test_segments_cuda_match_whole_and_plain(n, shape, dtype):
    """The segment path on the card (each segment a kernel call with its
    k0, merged) against the whole-sequence kernel and the plain version,
    forward and gradients; each segment's backward kernel against the
    plain backward from the merged out and lse."""
    _card()
    B, S, H, K, D = shape
    g = torch.Generator(device="cuda").manual_seed(1)
    dt = getattr(torch, dtype)
    q, dout = (torch.randn((B, S, H, D), generator=g, device="cuda").to(dt)
               for _ in range(2))
    k, v = (torch.randn((B, S, K, D), generator=g, device="cuda").to(dt)
            for _ in range(2))
    tol = TOL[dtype]
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = flash_xla.seg_flash(*leaves, causal=True, segments=n)
    out.backward(dout)
    ref = [t.clone().requires_grad_() for t in (q, k, v)]
    whole = fa.flash_attention(*ref, causal=True)
    whole.backward(dout)
    assert _rel_err(out, whole) <= tol
    for a, b in zip(leaves, ref):
        assert _rel_err(a.grad, b.grad) <= tol
    merged, lse = flash_xla._forward(q, k, v, True, 0, 0.0, n, None)
    c = S // n
    for a in range(0, S, c):
        got = fa.flash_attention_bwd(q, k[:, a:a + c], v[:, a:a + c], merged,
                                     lse, dout, causal=True, k0=a)
        want = fa.flash_attention_bwd_plain(q, k[:, a:a + c], v[:, a:a + c],
                                            merged, lse, dout, causal=True,
                                            k0=a)
        for x, y in zip(got, want):
            assert torch.isfinite(x).all() and _rel_err(x, y) <= tol


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", DECODE_CASES + [
    (1, 4096, 14, 2, 64, 0, 4095, 16), (1, 128, 14, 2, 64, 0, 64, 2),
    (1, 2048, 10, 1, 256, 2048, 3000, 4)])
def test_decode_lse_cuda_matches_plain(case, dtype):
    _card()
    B, S, H, K, D, window, cur, n = case
    g = torch.Generator(device="cuda").manual_seed(2)
    dt = getattr(torch, dtype)
    q = torch.randn((B, H, D), generator=g, device="cuda").to(dt)
    k, v = (torch.randn((B, S, K, D), generator=g, device="cuda").to(dt)
            for _ in range(2))
    kpos = torch.arange(S, dtype=torch.int32, device="cuda")
    whole = fd.flash_decode(q, k, v, kpos, cur, window=window)
    out, lse = fd.flash_decode(q, k, v, kpos, cur, window=window,
                               return_lse=True)
    torch.cuda.synchronize()
    assert torch.equal(out, whole)
    _, want_lse = fd.flash_decode_plain(q, k, v, kpos, cur, window=window,
                                        return_lse=True)
    torch.testing.assert_close(lse, want_lse, rtol=TOL["float32"],
                               atol=TOL["float32"])
    c = S // n
    parts = [fd.flash_decode(q, k[:, a:a + c], v[:, a:a + c], kpos[a:a + c],
                             cur, window=window, return_lse=True)
             for a in range(0, S, c)]
    merged, _ = ops.merge([o for o, _ in parts], [l for _, l in parts])
    tol = TOL[dtype]
    torch.testing.assert_close(merged, whole.float(), rtol=tol, atol=tol)
    for o, l in parts:              # a shard past cur: out 0, the sentinel
        dead = l <= fd.NEG_INF / 2
        assert (o[dead] == 0).all() and torch.isfinite(o).all()
