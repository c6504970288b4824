"""Port parity for the kernel modules (flash_decode, flash_attention,
ssd_scan): each port's plain version (what a CPU tensor runs) against the
JAX package's Pallas kernel (interpret mode, as tests/test_kernels.py runs
it) and its oracle (ref.py, ``ssd_reference``), and — on a card only — the
CUDA kernel against the plain version on the same inputs.

Tolerances are the reference's own (tests/test_kernels.py), as
rtol = atol: 2e-4 in f32 and 2e-2 in bf16 for the attention kernels (one
bf16 ulp near 1 is 7.8e-3; the Pallas kernels and the oracles round p at
different points); 3e-4 in f32 and 4e-2 in bf16 for the SSD scan (the
oracle rounds x·dt and the decay-weighted scores to bf16, the Pallas kernel
keeps them in f32; the CUDA bf16 kernel rounds them as the oracle does, and
also x·dt·exp(cum[-1] - cum) for the chunk states and the incoming state
into two bf16 parts).

The JAX package is imported inside the parity test, not at the top, so
that ``-m gpu`` runs this file where JAX is not installed."""
import numpy as np
import pytest
import torch

from repro_torch.kernels import build
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import flash_decode as fd
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ssd_scan as ss

TOL = {"float32": 2e-4, "bfloat16": 2e-2}
SSD_TOL = {"float32": 3e-4, "bfloat16": 4e-2}

# tests/test_kernels.py::DECODE_CASES (B, S, H, K, D, window, ring), plus
# G=7 (qwen2-0.5b's 14 q-heads over 2 kv-heads), then (with a softcap) a
# window whose leading cache blocks are wholly masked, and a gemma2-style
# ring (S == window) with the softcap.
CASES = [
    # B, S, H, K, D, window, ring, cap, cur
    (2, 40, 4, 2, 32, 0, False, 0.0, 25),
    (1, 32, 2, 1, 16, 8, True, 0.0, 25),
    (2, 64, 8, 2, 64, 0, False, 0.0, 25),
    (1, 48, 4, 4, 128, 16, True, 0.0, 25),
    (2, 40, 14, 2, 64, 0, False, 0.0, 33),
    (1, 64, 4, 2, 32, 16, False, 50.0, 60),
    (2, 16, 4, 2, 16, 16, True, 50.0, 40),
    # the fourth slice's heads: recurrentgemma's local layer (G=10, D=256,
    # a ring past its window); a cross-decode cache, every slot live (kpos
    # 0..S-1, cur S-1); qwen3-moe's G=16 at D=128
    (1, 32, 10, 1, 256, 32, True, 0.0, 45),
    (2, 24, 4, 4, 64, 0, False, 0.0, 23),
    (1, 40, 16, 1, 128, 0, False, 0.0, 30),
]


def _kpos(S, cur, ring):
    j = np.arange(S, dtype=np.int32)
    return (cur - np.mod(cur - j, S)).astype(np.int32) if ring else j


def _inputs(case, seed=7):
    B, S, H, K, D, window, ring, cap, cur = case
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, 1, H, D)).astype(np.float32)
    k = rng.standard_normal((B, S, K, D)).astype(np.float32)
    v = rng.standard_normal((B, S, K, D)).astype(np.float32)
    return q, k, v, _kpos(S, cur, ring)


def _torch(a, dtype):
    return torch.from_numpy(a).to(getattr(torch, dtype))


def _np(t):
    return t.detach().float().cpu().numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES)
def test_flash_decode_plain_matches_pallas_and_oracle(case, dtype):
    import jax.numpy as jnp
    from repro.kernels import ops as jops
    from repro.kernels import ref
    B, S, H, K, D, window, ring, cap, cur = case
    q, k, v, kpos = _inputs(case)
    jd = getattr(jnp, dtype)
    pallas = jops.flash_decode(jnp.asarray(q, jd), jnp.asarray(k, jd),
                               jnp.asarray(v, jd), jnp.asarray(kpos), cur,
                               window=window, cap=cap, block_s=16)
    G = H // K
    oracle = ref.flash_decode_ref(
        jnp.asarray(q.reshape(B * K, G, D), jd),
        jnp.asarray(k.transpose(0, 2, 1, 3).reshape(B * K, S, D), jd),
        jnp.asarray(v.transpose(0, 2, 1, 3).reshape(B * K, S, D), jd),
        jnp.asarray(kpos), cur, window=window, cap=cap
    ).reshape(B, 1, H, D)
    got = tops.flash_decode(_torch(q, dtype), _torch(k, dtype),
                            _torch(v, dtype), torch.from_numpy(kpos), cur,
                            window=window, cap=cap)
    assert got.shape == (B, 1, H, D) and got.dtype == getattr(torch, dtype)
    tol = TOL[dtype]
    for want in (pallas, oracle):
        np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                                   rtol=tol, atol=tol)


@pytest.mark.parametrize("B,K,S", [(1, 2, 128), (8, 2, 128), (1, 2, 4096),
                                   (8, 2, 4096), (2, 1, 40), (1, 4, 1),
                                   (1, 2, 2064), (1, 2, 600), (64, 8, 8192)])
def test_split_plan_covers_cache(B, K, S):
    """The splits tile [0, S), each key in exactly one; there are at most 8
    (one portable cluster), none shorter than 256 keys unless there is only
    one, and the grid is about one wave of blocks on 132 SMs."""
    n_split = fd.split_plan(B, K, S, sms=132)
    bounds = [(i * S // n_split, (i + 1) * S // n_split)    # as the kernel
              for i in range(n_split)]
    assert 1 <= n_split <= fd.MAX_SPLIT == 8
    assert bounds[0][0] == 0 and bounds[-1][1] == S
    assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))
    if n_split > 1:
        assert min(end - begin for begin, end in bounds) >= 256
    assert B * K * n_split <= max(132, B * K)


def test_split_plan_serving_shape_is_one_block_per_row():
    """qwen2-0.5b's served cache (S=128) at every engine bucket: one block
    per (b, kh), which writes the output itself."""
    assert [fd.split_plan(b, 2, 128, sms=132) for b in (1, 2, 4, 8)] == [1] * 4
    assert fd.split_plan(1, 2, 4096, sms=132) == 8


def test_flash_decode_refuses_caches_cp_async_cannot_read():
    """A cache whose rows are not 16-byte aligned is refused, not read
    another way."""
    q = torch.zeros((1, 4, 16), dtype=torch.bfloat16)
    kpos = torch.arange(8, dtype=torch.int32)
    good = torch.zeros((1, 8, 2, 16), dtype=torch.bfloat16)
    bad = torch.zeros((1, 8, 2, 20), dtype=torch.bfloat16)[..., :16]
    fd._check(q, good, good, kpos)
    with pytest.raises(ValueError, match="16-byte"):
        fd._check(q, bad, good, kpos)


def test_flash_decode_refuses_devices_without_kernel():
    q = torch.zeros((1, 2, 16), device="meta")
    k = torch.zeros((1, 8, 1, 16), device="meta")
    kpos = torch.zeros((8,), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        fd.flash_decode(q, k, k, kpos, 3)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES + [
    (1, 4096, 14, 2, 64, 0, False, 0.0, 4000),
    (8, 512, 14, 2, 64, 64, False, 50.0, 500),
    (2, 256, 32, 2, 256, 0, False, 0.0, 200),
    (1, 2048, 10, 1, 256, 2048, True, 0.0, 3072),  # recurrentgemma's ring
    (1, 2048, 16, 16, 64, 0, False, 0.0, 2047),    # seamless cross cache
    (4, 528, 64, 4, 128, 0, False, 0.0, 512),      # qwen3-moe, G=16
])
def test_flash_decode_cuda_matches_plain(case, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    q, k, v, kpos = _inputs(case)
    args = [_torch(a, dtype).cuda() for a in (q, k, v)]
    kp = torch.from_numpy(kpos).cuda()
    window, cap, cur = case[5], case[7], case[8]
    before = fd.flash_decode.launches
    got = tops.flash_decode(*args, kp, cur, window=window, cap=cap)
    torch.cuda.synchronize()
    assert fd.flash_decode.launches == before + 1
    want = fd.flash_decode_plain(args[0][:, 0], args[1], args[2], kp, cur,
                                 window=window, cap=cap)[:, None]
    tol = TOL[dtype]
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


# ------------------------------------------------------------ flash_attention

# tests/test_kernels.py::ATTN_CASES (B, Sq, Skv, H, K, D, causal, window, cap)
ATTN_CASES = [
    (2, 64, 64, 4, 2, 32, True, 0, 0.0),
    (1, 100, 100, 2, 2, 16, True, 24, 50.0),
    (2, 48, 48, 4, 1, 64, False, 0, 0.0),
    (1, 96, 96, 8, 8, 128, True, 0, 30.0),
    (1, 33, 33, 2, 1, 16, True, 7, 0.0),
    # the fourth slice's heads: recurrentgemma's local layer (G=10, D=256,
    # window shorter than S); a cross layer (non-causal, Sq != Skv, both
    # ways); qwen3-moe's G=16 at D=128
    (1, 80, 80, 10, 1, 256, True, 32, 0.0),
    (2, 40, 72, 4, 4, 64, False, 0, 0.0),
    (1, 72, 40, 4, 4, 64, False, 0, 0.0),
    (1, 64, 64, 16, 1, 128, True, 0, 0.0),
]


def _attn_inputs(case, seed=7):
    B, Sq, Skv, H, K, D = case[:6]
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Sq, H, D)).astype(np.float32),
            rng.standard_normal((B, Skv, K, D)).astype(np.float32),
            rng.standard_normal((B, Skv, K, D)).astype(np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ATTN_CASES)
def test_flash_attention_plain_matches_pallas_and_oracle(case, dtype):
    import jax.numpy as jnp
    from repro.kernels import ops as jops
    from repro.kernels import ref
    B, Sq, Skv, H, K, D, causal, window, cap = case
    q, k, v = _attn_inputs(case)
    jd = getattr(jnp, dtype)
    pallas = jops.flash_attention(jnp.asarray(q, jd), jnp.asarray(k, jd),
                                  jnp.asarray(v, jd), causal=causal,
                                  window=window, cap=cap, block_q=32,
                                  block_k=32)
    ke, ve = np.repeat(k, H // K, 2), np.repeat(v, H // K, 2)
    oracle = ref.flash_attention_ref(
        *(jnp.asarray(a.transpose(0, 2, 1, 3).reshape(B * H, -1, D), jd)
          for a in (q, ke, ve)), causal=causal, window=window, cap=cap)
    oracle = np.asarray(oracle, np.float32).reshape(B, H, Sq, D
                                                    ).transpose(0, 2, 1, 3)
    got = tops.flash_attention(_torch(q, dtype), _torch(k, dtype),
                               _torch(v, dtype), causal=causal,
                               window=window, cap=cap)
    assert got.shape == (B, Sq, H, D) and got.dtype == getattr(torch, dtype)
    tol = TOL[dtype]
    for want in (pallas, oracle):
        np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                                   rtol=tol, atol=tol)


def test_flash_attention_refuses_layouts_tma_cannot_read():
    """The bf16 kernel's layout check refuses what TMA cannot read (a head
    stride of 40 bytes, D not a multiple of 16) and raises: the wrapper has
    no other way to the card."""
    k = torch.zeros((1, 8, 1, 16), dtype=torch.bfloat16)
    q = torch.zeros((1, 8, 3, 20), dtype=torch.bfloat16)[..., :16]
    with pytest.raises(ValueError, match="cannot be read by TMA"):
        fa.check_tma_layout(q, k, k)
    fa.check_tma_layout(q.contiguous(), k, k)       # same values, packed
    q24 = torch.zeros((1, 8, 2, 24), dtype=torch.bfloat16)
    k24 = torch.zeros((1, 8, 1, 24), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="multiple of 16"):
        fa.check_tma_layout(q24, k24, k24)


# ------------------------------------------------------------ attention backward

# tests/test_kernels.py::test_flash_xla_custom_vjp_grads's cases (G = 3,
# Sq = Skv = 33), then Sq != Skv both ways (a cross layer: non-causal)
BWD_CASES = [
    (2, 33, 33, 6, 2, 16, True, 0, 0.0),
    (2, 33, 33, 6, 2, 16, True, 7, 20.0),
    (2, 33, 33, 6, 2, 16, False, 0, 0.0),
    (1, 20, 37, 6, 2, 16, False, 0, 0.0),
    (1, 37, 20, 6, 2, 16, False, 0, 0.0),
]
# the reference's gradient tolerance (test_flash_xla_custom_vjp_grads) in
# f32; in bf16 the kernel tests' 2e-2 (the reference also rounds its scores
# and dout·vᵀ to bf16, the port keeps them in f32)
BWD_TOL = {"float32": 3e-4, "bfloat16": 2e-2}


def _bwd_inputs(case, seed=11):
    q, k, v = _attn_inputs(case, seed)
    dout = np.random.default_rng(seed + 1).standard_normal(q.shape).astype(
        np.float32)
    return q, k, v, dout


def _reference_vjp(case, dtype, q, k, v, dout):
    """(out, lse (B, H, Sq), (dq, dk, dv)) of the JAX package's custom-vjp
    path, ``chunked_attention`` (chunks of 8 keys), as float32 arrays."""
    import jax
    import jax.numpy as jnp
    from repro.models.attention import chunked_attention
    from repro.models.flash_xla import _fwd_impl
    B, Sq, Skv, H, K, D, causal, window, cap = case
    G = H // K
    jd = getattr(jnp, dtype)

    def f(q_, k_, v_):
        return chunked_attention(q_.reshape(B, Sq, K, G, D), k_, v_,
                                 causal=causal, window=window, cap=cap,
                                 chunk=8).reshape(B, Sq, H, D)

    args = [jnp.asarray(a, jd) for a in (q, k, v)]
    out, vjp = jax.vjp(f, *args)
    grads = vjp(jnp.asarray(dout, jd))
    _, lse = _fwd_impl(args[0].reshape(B, Sq, K, G, D), args[1], args[2],
                       causal=causal, window=window, cap=cap, chunk=8)
    as32 = lambda a: np.asarray(a, np.float32)                  # noqa: E731
    return (as32(out), as32(lse).reshape(B, H, Sq),
            tuple(as32(g) for g in grads))


@pytest.mark.parametrize("route", ["plain", "function"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", BWD_CASES)
def test_flash_attention_bwd_matches_reference_vjp(case, dtype, route):
    """flash_attention_bwd_plain (from the plain forward's out and lse) and
    the FlashAttention autograd.Function (through flash_attention with
    inputs that require grad, on the CPU) against jax.vjp of the JAX
    package's chunked_attention; the plain forward's lse against
    flash_xla's."""
    B, Sq, Skv, H, K, D, causal, window, cap = case
    q, k, v, dout = _bwd_inputs(case)
    want_out, want_lse, want = _reference_vjp(case, dtype, q, k, v, dout)
    kw = dict(causal=causal, window=window, cap=cap)
    tq, tk, tv, tg = (_torch(a, dtype) for a in (q, k, v, dout))
    fwd0, bwd0 = fa.flash_attention.launches, fa.flash_attention_bwd.launches
    if route == "plain":
        out, lse = fa.flash_attention_plain(tq, tk, tv, return_lse=True, **kw)
        assert lse.shape == (B, H, Sq) and lse.dtype == torch.float32
        # in bf16 the reference's scores are rounded to bf16, the port's not
        np.testing.assert_allclose(lse.numpy(), want_lse, rtol=TOL[dtype],
                                   atol=TOL[dtype])
        got = fa.flash_attention_bwd_plain(tq, tk, tv, out, lse, tg, **kw)
    else:
        for t in (tq, tk, tv):
            t.requires_grad_()
        out = tops.flash_attention(tq, tk, tv, **kw)
        assert out.grad_fn is not None
        out.backward(tg)
        got = (tq.grad, tk.grad, tv.grad)
    # the CPU runs the plain versions: no kernel was launched
    assert (fa.flash_attention.launches, fa.flash_attention_bwd.launches) == (
        fwd0, bwd0)
    tol = BWD_TOL[dtype]
    np.testing.assert_allclose(_np(out), want_out, rtol=TOL[dtype],
                               atol=TOL[dtype])
    for name, g, w, t in zip("qkv", got, want, (tq, tk, tv)):
        assert g.dtype == t.dtype and g.shape == t.shape, name
        np.testing.assert_allclose(_np(g), w, rtol=tol, atol=tol,
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", BWD_CASES)
def test_flash_attention_bwd_matches_torch_autograd(case, dtype):
    """The plain backward against torch autograd through
    flash_attention_plain itself, on the same inputs (2e-4 in f32; in bf16
    the kernel tests' 2e-2: autograd differentiates the plain forward's
    bf16 cast of p, the flash backward rounds p and ds as the reference
    does)."""
    causal, window, cap = case[6:]
    q, k, v, dout = _bwd_inputs(case)
    kw = dict(causal=causal, window=window, cap=cap)
    args = [_torch(a, dtype).requires_grad_() for a in (q, k, v)]
    g = _torch(dout, dtype)
    fa.flash_attention_plain(*args, **kw).backward(g)
    with torch.no_grad():
        out, lse = fa.flash_attention_plain(*args, return_lse=True, **kw)
        got = fa.flash_attention_bwd_plain(*args, out, lse, g, **kw)
    tol = TOL[dtype]
    for name, a, t in zip("qkv", got, args):
        np.testing.assert_allclose(_np(a), _np(t.grad), rtol=tol, atol=tol,
                                   err_msg=f"d{name}")


def _live_q_tile_sets(Sq, Skv, causal, window):
    """For each 64-key tile, the query tiles holding a live (q, k) pair,
    from the mask itself."""
    q = np.arange(Sq)[:, None]
    k = np.arange(Skv)[None, :]
    live = np.ones((Sq, Skv), bool)
    if causal:
        live &= k <= q
    if window:
        live &= q - k < window
    T = fa.BWD_TILE
    return [{t for t in range(-(-Sq // T))
             if live[t * T:(t + 1) * T, j * T:(j + 1) * T].any()}
            for j in range(-(-Skv // T))]


@pytest.mark.parametrize("shape", [
    # (B, K, G, Sq, Skv, causal, window): the train path's qwen2-0.5b calls
    # at (4, 256) and (1, 2048), (4, 512); G = 7 and 10 (not a multiple of
    # the chunk count), a window, Sq != Skv both ways, qwen3-moe's G = 16,
    # non-causal G = 1 (no key tile split)
    (4, 2, 7, 256, 256, True, 0),
    (1, 2, 7, 2048, 2048, True, 0),
    (4, 2, 7, 512, 512, True, 0),
    (1, 1, 10, 300, 300, True, 100),
    (2, 1, 7, 100, 180, False, 0),
    (1, 2, 10, 180, 100, True, 0),
    (1, 4, 16, 2048, 2048, True, 0),
    (1, 16, 1, 2048, 2048, False, 0),
])
@pytest.mark.parametrize("slots", [2, 264, 396])
def test_dkdv_plan_covers_every_item_once(shape, slots):
    """The bf16 dk/dv kernel's plan, the rows its blocks read: for every key
    tile, rows in launch order that cover each (query head, live query
    tile) exactly once, in head order, none longer than wt items, and whose
    query tiles hold every live pair of the mask (exactly those where the
    key tile is whole). wt is the larger of the items per slot and the
    longest dq walk (so the chunks, which run first, are never shorter than
    a dq block), or at most a quarter more where that fits every chunk in
    one wave of ``slots``."""
    B, K, G, Sq, Skv, causal, window = shape
    wt, rows = fa.dkdv_plan(B, K, G, Sq, Skv, causal, window, 1, slots)
    assert all(len(r) == 8 for r in rows)           # two int4 loads a row
    T, n_qt = fa.BWD_TILE, -(-Sq // fa.BWD_TILE)
    sets = _live_q_tile_sets(Sq, Skv, causal, window)
    assert [r[0] for r in rows] == sorted(r[0] for r in rows)
    nq = []
    for j, want in enumerate(sets):
        mine = [(p, r) for p, r in enumerate(rows) if r[0] == j]
        first, n, start, n_c = mine[0][1][1], mine[0][1][2], mine[0][0], \
            len(mine)
        assert [p for p, _ in mine] == list(range(start, start + n_c))
        assert all(r[1:3] == (first, n) and r[5:] == (start, n_c, 0)
                   for _, r in mine)
        tiles = set(range(first // T, first // T + n))
        assert first % T == 0 and tiles <= set(range(n_qt))
        assert want <= tiles and (want == tiles or (j + 1) * T > Skv)
        items = [i for _, r in mine for i in range(r[3], r[4])]
        assert items == list(range(G * n))          # in order, each once
        assert all(0 < r[4] - r[3] <= wt for _, r in mine) or n == 0
        nq.append(n)
    walk = fa._longest_dq_walk(Sq, Skv, causal, window)
    base = max(1, -(-B * K * G * sum(nq) // slots), walk)
    assert base <= wt <= base + base // 4
    if wt > base:                                   # bumped into one wave
        assert B * K * len(rows) <= slots
    if causal and not window and Sq == Skv:
        assert walk == len(nq)                      # the last q tile's walk


def test_bwd_panel_widths():
    assert [fa.bwd_panel(D) for D in (16, 32, 48, 64, 80, 128, 144, 256)] == [
        (16, 1), (32, 1), (64, 1), (64, 1), (128, 1), (128, 1), (128, 2),
        (128, 2)]


def test_flash_attention_bwd_refuses_devices_without_kernel():
    q = torch.zeros((1, 8, 2, 16), device="meta")
    k = torch.zeros((1, 8, 1, 16), device="meta")
    lse = torch.zeros((1, 2, 8), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        fa.flash_attention_bwd(q, k, k, q, lse, q)


# ------------------------------------------------------------ ssd_scan

# tests/test_kernels.py::SSD_CASES (B, L, H, P, N, chunk); L=50 is ragged
SSD_CASES = [
    (2, 64, 3, 16, 8, 16),
    (1, 50, 2, 8, 16, 16),
    (1, 128, 4, 32, 16, 32),
]


def _ssd_inputs(case, seed=7):
    """The reference's draws: x, b, c ~ N(0, 0.25), dt ~ U(0.01, 0.2),
    a ~ -U(0.5, 2)."""
    B, L, H, P, N, chunk = case
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, L, H, P)).astype(np.float32) * 0.5
    dt = rng.uniform(0.01, 0.2, (B, L, H)).astype(np.float32)
    a = -rng.uniform(0.5, 2.0, (H,)).astype(np.float32)
    b = rng.standard_normal((B, L, N)).astype(np.float32) * 0.5
    c = rng.standard_normal((B, L, N)).astype(np.float32) * 0.5
    return x, dt, a, b, c


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", SSD_CASES)
def test_ssd_scan_plain_matches_pallas_and_oracle(case, dtype):
    import jax.numpy as jnp
    from repro.kernels import ops as jops
    from repro.models.ssm import ssd_reference
    chunk = case[-1]
    x, dt, a, b, c = _ssd_inputs(case)
    jd = getattr(jnp, dtype)
    jargs = (jnp.asarray(x, jd), jnp.asarray(dt), jnp.asarray(a),
             jnp.asarray(b, jd), jnp.asarray(c, jd))
    pallas = jops.ssd(*jargs, chunk=chunk)
    oracle = ssd_reference(*jargs, chunk=chunk)
    y, state = tops.ssd(_torch(x, dtype), torch.from_numpy(dt),
                        torch.from_numpy(a), _torch(b, dtype),
                        _torch(c, dtype), chunk=chunk)
    assert y.shape == x.shape and y.dtype == getattr(torch, dtype)
    assert state.dtype == torch.float32
    tol = SSD_TOL[dtype]
    for want_y, want_s in (pallas, oracle):
        np.testing.assert_allclose(_np(y), np.asarray(want_y, np.float32),
                                   rtol=tol, atol=tol)
        np.testing.assert_allclose(state.numpy(), np.asarray(want_s),
                                   rtol=tol, atol=tol)


def test_ssd_scan_refuses_layouts_16_byte_copies_cannot_read():
    """The bf16 kernel's layout check refuses what its 16-byte copies cannot
    read (a head stride of 40 bytes, P or N not a multiple of 8) and
    raises: the wrapper has no other way to the card. The packed tensor
    with the same values passes."""
    x = torch.zeros((1, 8, 3, 20), dtype=torch.bfloat16)[..., :16]
    b = torch.zeros((1, 8, 16), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="16-byte copies"):
        ss.check_layout(x, b, b)
    ss.check_layout(x.contiguous(), b, b)
    bad_b = torch.zeros((1, 8, 20), dtype=torch.bfloat16)[..., :16]
    with pytest.raises(ValueError, match="16-byte copies"):
        ss.check_layout(x.contiguous(), b, bad_b)
    x12 = torch.zeros((1, 8, 3, 12), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="multiples of 8"):
        ss.check_layout(x12, b, b)


def test_copyable_refuses_what_16_byte_copies_cannot_read():
    """copyable, which the backward's wrapper holds dy to: a head stride of
    40 bytes or a base one element past a 16-byte boundary is refused; a
    packed tensor, and a stride of a dim of length one, are not."""
    x = torch.zeros((1, 8, 3, 20), dtype=torch.bfloat16)
    assert ss.copyable(x[..., :16].contiguous())
    assert not ss.copyable(x[..., :16])
    assert not ss.copyable(x.flatten()[1:385].view(1, 8, 3, 16))
    one = torch.empty_strided((1, 8, 3, 16), (3, 48, 16, 1),
                              dtype=torch.bfloat16)
    assert ss.copyable(one)


def test_library_name_keys_on_defines():
    """A variant built with defines (ssd_head_groups.py's head groups) gets
    a library of its own; the port's library is the one without."""
    plain = build.library_path("ssd_scan")
    assert build.library_path("ssd_scan", ()) == plain
    variant = build.library_path("ssd_scan", ("SSD_HEAD_GROUP=1",))
    assert variant != plain and variant.parent == plain.parent
    assert variant.name.startswith("ssd_scan-")
    assert variant != build.library_path("ssd_scan", ("SSD_HEAD_GROUP=4",))


def test_new_kernels_refuse_devices_without_kernel():
    q = torch.zeros((1, 8, 2, 16), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        fa.flash_attention(q, q, q)
    x = torch.zeros((1, 8, 2, 16), device="meta")
    b = torch.zeros((1, 8, 4), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        ss.ssd_scan(x, b[..., :2], b[0, 0, :2], b, b, chunk=4)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ATTN_CASES + [
    (2, 300, 300, 16, 8, 128, True, 64, 50.0),     # gemma2-style local
    (1, 130, 130, 4, 2, 256, True, 0, 0.0),        # D=256: 213 KB of smem
    (1, 2048, 2048, 14, 2, 64, True, 0, 0.0),      # qwen2-0.5b prefill
    (4, 512, 512, 14, 2, 64, True, 0, 0.0),
    (1, 3072, 3072, 10, 1, 256, True, 2048, 0.0),  # recurrentgemma, S > W
    (1, 2048, 2048, 16, 16, 64, False, 0, 0.0),    # seamless encoder
    (1, 1024, 2048, 16, 16, 64, False, 0, 0.0),    # seamless cross
    (4, 512, 512, 64, 4, 128, True, 0, 0.0),       # qwen3-moe, G=16
])
def test_flash_attention_cuda_matches_plain(case, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    causal, window, cap = case[6:]
    q, k, v = (_torch(a, dtype).cuda() for a in _attn_inputs(case))
    before = fa.flash_attention.launches
    got = tops.flash_attention(q, k, v, causal=causal, window=window,
                               cap=cap)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 1
    want = fa.flash_attention_plain(q, k, v, causal=causal, window=window,
                                    cap=cap)
    tol = TOL[dtype]
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", SSD_CASES + [
    (1, 2048, 24, 64, 128, 256),                   # mamba2-130m prefill
    (4, 512, 24, 64, 128, 256),
    (1, 300, 24, 64, 128, 256),                    # ragged full-width
    (2, 1000, 24, 64, 128, 256),                   # ragged, L % 64 = 40
    (2, 96, 4, 8, 8, 32),                          # P = 8 with N = 8
    (2, 512, 24, 64, 128, 64),                     # chunks of 64
    (1, 640, 8, 64, 128, 128),                     # chunks of 128
    (2, 64, 8, 16, 16, 16),                        # the mamba2 smoke widths
])
def test_ssd_scan_cuda_matches_plain(case, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    x, dt, a, b, c = _ssd_inputs(case)
    args = (_torch(x, dtype).cuda(), torch.from_numpy(dt).cuda(),
            torch.from_numpy(a).cuda(), _torch(b, dtype).cuda(),
            _torch(c, dtype).cuda())
    before = ss.ssd_scan.launches
    y, state = tops.ssd(*args, chunk=case[-1])
    torch.cuda.synchronize()
    assert ss.ssd_scan.launches == before + 1
    want_y, want_s = ss.ssd_scan_plain(*args, chunk=case[-1])
    tol = SSD_TOL[dtype]
    np.testing.assert_allclose(_np(y), _np(want_y), rtol=tol, atol=tol)
    np.testing.assert_allclose(_np(state), _np(want_s), rtol=tol, atol=tol)


# ------------------------------------------------ layouts, splits and graphs

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", [
    (2, 200, 6, 64, 128, 64),                      # L not a multiple of 64
    (1, 300, 24, 64, 128, 256),
    (2, 80, 3, 16, 16, 16),
])
def test_ssd_scan_cuda_strided_views(case, dtype):
    """x, b and c as views into one fused (B, L, H*P + 2N) projection, and x
    as the transpose of a (B, H, L, P) tensor: read through their strides,
    no copy, against the plain version on the same views."""
    _card()
    B, L, H, P, N, chunk = case
    g = torch.Generator(device="cuda").manual_seed(6)
    dty = getattr(torch, dtype)
    fused = (torch.randn((B, L, H * P + 2 * N), generator=g, device="cuda")
             * 0.5).to(dty)
    x = fused[..., :H * P].unflatten(-1, (H, P))
    b, c = fused[..., H * P:H * P + N], fused[..., H * P + N:]
    xt = (torch.randn((B, H, L, P), generator=g, device="cuda") * 0.5
          ).to(dty).transpose(1, 2)
    dt = torch.rand((B, L, H), generator=g, device="cuda") * 0.19 + 0.01
    a = -(torch.rand((H,), generator=g, device="cuda") * 1.5 + 0.5)
    tol = SSD_TOL[dtype]
    for xx in (x, xt):
        y, state = ss.ssd_scan(xx, dt, a, b, c, chunk=chunk)
        want_y, want_s = ss.ssd_scan_plain(xx, dt, a, b, c, chunk=chunk)
        np.testing.assert_allclose(_np(y), _np(want_y), rtol=tol, atol=tol)
        np.testing.assert_allclose(_np(state), _np(want_s), rtol=tol,
                                   atol=tol)


@pytest.mark.gpu
def test_ssd_scan_cuda_odd_head_count():
    """The bf16 kernel at P=64, N=128 over 23 heads: the last output block
    holds one head of its group of two. Against the plain version."""
    _card()
    x, dt, a, b, c = (torch.from_numpy(t).cuda()
                      for t in _ssd_inputs((2, 700, 23, 64, 128, 256)))
    x, b, c = (t.to(torch.bfloat16) for t in (x, b, c))
    y, state = ss.ssd_scan(x, dt, a, b, c, chunk=256)
    want_y, want_s = ss.ssd_scan_plain(x, dt, a, b, c, chunk=256)
    tol = SSD_TOL["bfloat16"]
    np.testing.assert_allclose(_np(y), _np(want_y), rtol=tol, atol=tol)
    np.testing.assert_allclose(_np(state), _np(want_s), rtol=tol, atol=tol)


@pytest.mark.gpu
def test_ssd_scan_cuda_raises_on_layout_it_cannot_read():
    _card()
    x = torch.zeros((1, 64, 3, 20), dtype=torch.bfloat16, device="cuda")
    b = torch.zeros((1, 64, 16), dtype=torch.bfloat16, device="cuda")
    dt = torch.zeros((1, 64, 3), device="cuda")
    a = -torch.ones((3,), device="cuda")
    before = ss.ssd_scan.launches
    with pytest.raises(ValueError, match="16-byte copies"):
        ss.ssd_scan(x[..., :16], dt, a, b, b, chunk=16)
    assert ss.ssd_scan.launches == before


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", [
    (2, 200, 200, 6, 2, 64, True, 0, 0.0),         # S not a multiple of 64
    (1, 150, 150, 4, 2, 128, True, 40, 30.0),      # D=128: two panels
    (1, 100, 100, 4, 1, 256, False, 0, 0.0),       # D=256: four panels
    (1, 96, 96, 4, 2, 80, True, 0, 0.0),           # D=80 runs the 128 panels
])
def test_flash_attention_cuda_strided_views(case, dtype):
    """q, k and v as views into one fused (B, S, H + 2K, D) projection, and
    q as the transpose of a (B, H, S, D) tensor: read through their strides,
    no copy, against the plain version on the same views."""
    _card()
    B, Sq, Skv, H, K, D, causal, window, cap = case
    g = torch.Generator(device="cuda").manual_seed(5)
    dt = getattr(torch, dtype)
    qkv = torch.randn((B, Sq, H + 2 * K, D), generator=g, device="cuda").to(dt)
    q, k, v = qkv[:, :, :H], qkv[:, :, H:H + K], qkv[:, :, H + K:]
    qt = torch.randn((B, H, Sq, D), generator=g, device="cuda").to(dt
                                                                   ).transpose(1, 2)
    tol = TOL[dtype]
    for qq in (q, qt):
        got = fa.flash_attention(qq, k, v, causal=causal, window=window,
                                 cap=cap)
        want = fa.flash_attention_plain(qq, k, v, causal=causal,
                                        window=window, cap=cap)
        np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


@pytest.mark.gpu
def test_flash_attention_cuda_raises_on_layout_tma_cannot_read():
    _card()
    q = torch.zeros((1, 64, 3, 20), dtype=torch.bfloat16, device="cuda")
    k = torch.zeros((1, 64, 1, 16), dtype=torch.bfloat16, device="cuda")
    before = fa.flash_attention.launches
    with pytest.raises(ValueError, match="cannot be read by TMA"):
        fa.flash_attention(q[..., :16], k, k)
    assert fa.flash_attention.launches == before


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,n_split", [(128, 1), (600, 2), (4096, 8)])
def test_flash_decode_cuda_splits(S, n_split, dtype):
    """One, two and eight blocks per cluster, with a window whose first
    splits are wholly masked at S=4096, against the plain version."""
    _card()
    B, H, K, D = 1, 14, 2, 64
    assert fd.split_plan(B, K, S, fd._sm_count(torch.device("cuda"))) == n_split
    tol = TOL[dtype]
    for window, cap in ((0, 0.0), (S // 4, 50.0)):
        case = (B, S, H, K, D, window, False, cap, S - 3)
        q, k, v, kpos = _inputs(case)
        args = [_torch(a, dtype).cuda() for a in (q[:, 0], k, v)]
        kp = torch.from_numpy(kpos).cuda()
        got = fd.flash_decode(*args, kp, S - 3, window=window, cap=cap)
        want = fd.flash_decode_plain(*args, kp, S - 3, window=window, cap=cap)
        np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


@pytest.mark.gpu
def test_kernels_replay_in_a_cuda_graph():
    """Each kernel captured in a CUDA graph: two replays in a row give the
    eager result bit for bit."""
    _card()
    g = torch.Generator(device="cuda").manual_seed(9)
    bf = torch.bfloat16
    q = torch.randn((1, 300, 14, 64), generator=g, device="cuda").to(bf)
    k = torch.randn((1, 300, 2, 64), generator=g, device="cuda").to(bf)
    v = torch.randn((1, 300, 2, 64), generator=g, device="cuda").to(bf)
    kc = torch.randn((1, 2064, 2, 64), generator=g, device="cuda").to(bf)
    vc = torch.randn((1, 2064, 2, 64), generator=g, device="cuda").to(bf)
    kpos = torch.arange(2064, dtype=torch.int32, device="cuda")
    x = torch.randn((1, 600, 24, 64), generator=g, device="cuda").to(bf)
    dt = torch.rand((1, 600, 24), generator=g, device="cuda") * 0.19 + 0.01
    a = -(torch.rand((24,), generator=g, device="cuda") * 1.5 + 0.5)
    bc = torch.randn((1, 600, 128), generator=g, device="cuda").to(bf)
    calls = (lambda: (fa.flash_attention(q, k, v),),
             lambda: (fd.flash_decode(q[:, 0], kc, vc, kpos, 2048),),
             lambda: ss.ssd_scan(x, dt, a, bc, bc.flip(1), chunk=256))
    for fn in calls:
        eager = fn()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            outs = fn()
        for _ in range(2):
            for out in outs:
                out.zero_()
            graph.replay()
            torch.cuda.synchronize()
            assert all(torch.equal(o, e) for o, e in zip(outs, eager))


# the backward on the card: the forward's cases, then gemma2-style window +
# softcap, D = 256 (32-row tiles, two panels), Sq != Skv both ways, G = 16,
# and the train path's shapes (qwen2-0.5b at (8, 256), the train phase's
# own microbatch (4, 256), (1, 2048), (4, 512))
BWD_CUDA_CASES = ATTN_CASES + [
    (2, 300, 300, 16, 8, 128, True, 64, 50.0),
    (1, 130, 130, 4, 2, 256, True, 0, 0.0),
    (1, 100, 180, 16, 16, 64, False, 0, 0.0),
    (1, 180, 100, 16, 16, 64, False, 0, 0.0),
    (1, 160, 160, 64, 4, 128, True, 0, 0.0),
    (8, 256, 256, 14, 2, 64, True, 0, 0.0),
    (4, 256, 256, 14, 2, 64, True, 0, 0.0),
    (1, 2048, 2048, 14, 2, 64, True, 0, 0.0),
    (4, 512, 512, 14, 2, 64, True, 0, 0.0),
    # the Hopper kernels' edges: Sq and Skv not multiples of 64 with a
    # window (Sq != Skv both ways); D = 16 and 32 (the 32- and 64-byte
    # swizzles); G = 7 and 10 with key tiles cut into chunks that split a
    # head's walk; D = 80 and 144 (zero columns, two panels at 144)
    (1, 150, 230, 7, 1, 64, True, 70, 0.0),
    (2, 230, 150, 4, 2, 64, True, 90, 30.0),
    (1, 200, 200, 6, 2, 16, True, 0, 0.0),
    (1, 200, 200, 6, 2, 32, True, 50, 0.0),
    (1, 700, 700, 14, 2, 64, True, 0, 0.0),
    (1, 1000, 1000, 10, 1, 128, True, 300, 0.0),
    (1, 260, 260, 4, 2, 80, True, 0, 0.0),
    (1, 260, 260, 4, 2, 144, True, 0, 0.0),
]


def _rel_err(got, want):
    """max |got - want| over max |want| (at least 1e-30), f32."""
    want = want.float()
    return ((got.float() - want).abs().max()
            / want.abs().max().clamp(min=1e-30)).item()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", BWD_CUDA_CASES)
def test_flash_attention_bwd_cuda_matches_plain(case, dtype):
    """The forward kernel's lse against the plain version's, then the
    backward kernels against flash_attention_bwd_plain from the same out,
    lse and dout: dq, dk and dv within 2e-4 (f32) or 2e-2 (bf16) of the
    largest element of each."""
    _card()
    causal, window, cap = case[6:]
    kw = dict(causal=causal, window=window, cap=cap)
    q, k, v = (_torch(a, dtype).cuda() for a in _attn_inputs(case))
    g = torch.Generator(device="cuda").manual_seed(3)
    dout = torch.randn(q.shape, generator=g, device="cuda").to(q.dtype)
    out, lse = fa._forward(q, k, v, causal, window, cap, want_lse=True)
    _, want_lse = fa.flash_attention_plain(q, k, v, return_lse=True, **kw)
    np.testing.assert_allclose(lse.cpu().numpy(), want_lse.cpu().numpy(),
                               rtol=TOL["float32"], atol=TOL["float32"])
    before = fa.flash_attention_bwd.launches
    got = fa.flash_attention_bwd(q, k, v, out, lse, dout, **kw)
    torch.cuda.synchronize()
    assert fa.flash_attention_bwd.launches == before + 1
    want = fa.flash_attention_bwd_plain(q, k, v, out, lse, dout, **kw)
    tol = {"float32": 2e-4, "bfloat16": 2e-2}[dtype]
    for name, a, w in zip("qkv", got, want):
        assert a.dtype == w.dtype and a.shape == w.shape
        assert torch.isfinite(a).all().item(), name
        assert _rel_err(a, w) <= tol, (name, _rel_err(a, w))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_grad_on_the_card(dtype):
    """Autograd through ops.flash_attention on CUDA tensors: one forward
    launch (with lse) and one backward launch, and the gradients of q, k
    and v as views into one fused projection against the CPU's (plain)
    gradients of the same values."""
    _card()
    B, S, H, K, D = 2, 150, 6, 2, 64
    g = torch.Generator().manual_seed(4)
    dt = getattr(torch, dtype)
    qkv0 = torch.randn((B, S, H + 2 * K, D), generator=g).to(dt)
    dout = torch.randn((B, S, H, D), generator=g).to(dt)
    grads = {}
    for dev in ("cpu", "cuda"):
        qkv = qkv0.to(dev, copy=True).requires_grad_()
        q, k, v = qkv[:, :, :H], qkv[:, :, H:H + K], qkv[:, :, H + K:]
        fwd0, bwd0 = fa.flash_attention.launches, fa.flash_attention_bwd.launches
        out = tops.flash_attention(q, k, v, causal=True, window=40, cap=30.0)
        out.backward(dout.to(dev))
        if dev == "cuda":
            torch.cuda.synchronize()
            assert fa.flash_attention.launches == fwd0 + 1
            assert fa.flash_attention_bwd.launches == bwd0 + 1
        grads[dev] = qkv.grad.cpu()
    tol = {"float32": 2e-4, "bfloat16": 2e-2}[dtype]
    assert _rel_err(grads["cuda"], grads["cpu"]) <= tol


@pytest.mark.gpu
@pytest.mark.parametrize("case", [
    (1, 1024, 1024, 14, 2, 64, True, 0, 0.0),      # qwen2: key tiles split
    (2, 300, 300, 16, 1, 128, True, 64, 30.0),     # G = 16, window, softcap
])
def test_flash_attention_bwd_cuda_is_deterministic(case):
    """Repeated bf16 backward calls give dq, dk and dv bit for bit: the dk/dv
    chunks' partials are added in chunk order whichever block finishes
    last, at cases whose early key tiles are cut into several chunks and
    whose late ones sum all G heads in one block."""
    _card()
    causal, window, cap = case[6:]
    B, Sq, Skv, H, K, D = case[:6]
    ap, panels = fa.bwd_panel(D)
    _, rows = fa.dkdv_plan(B, K, H // K, Sq, Skv, causal, window, panels,
                           fa._dkdv_slots(torch.device("cuda"), D))
    assert len(rows) > -(-Skv // fa.BWD_TILE)       # some tile is split
    q, k, v = (_torch(a, "bfloat16").cuda() for a in _attn_inputs(case))
    g = torch.Generator(device="cuda").manual_seed(3)
    dout = torch.randn(q.shape, generator=g, device="cuda").to(q.dtype)
    out, lse = fa._forward(q, k, v, causal, window, cap, want_lse=True)
    first = fa.flash_attention_bwd(q, k, v, out, lse, dout, causal=causal,
                                   window=window, cap=cap)
    for _ in range(5):
        again = fa.flash_attention_bwd(q, k, v, out, lse, dout, causal=causal,
                                       window=window, cap=cap)
        torch.cuda.synchronize()
        for name, a, b in zip("qkv", first, again):
            assert torch.equal(a, b), f"d{name} differs between calls"


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_bwd_cuda_length_one_dims(dtype):
    """A batch of one whose tensors step over it with strides TMA cannot
    take (autograd hands the backward such a dout): the wrapper rounds a
    stride it never steps over, as the forward does, and the result matches
    the plain version."""
    _card()
    B, S, H, K, D = 1, 200, 6, 2, 64
    case = (B, S, S, H, K, D, True, 0, 0.0)
    q, k, v = (_torch(a, dtype).cuda() for a in _attn_inputs(case))
    out, lse = fa._forward(q, k, v, True, 0, 0.0, want_lse=True)
    g = torch.Generator(device="cuda").manual_seed(3)
    dense = torch.randn(q.shape, generator=g, device="cuda").to(q.dtype)
    dout = torch.empty_strided(q.shape, (3, H * D, D, 1), dtype=q.dtype,
                               device="cuda")
    dout.copy_(dense)
    got = fa.flash_attention_bwd(q, k, v, out, lse, dout)
    want = fa.flash_attention_bwd_plain(q, k, v, out, lse, dense)
    tol = {"float32": 2e-4, "bfloat16": 2e-2}[dtype]
    for name, a, w in zip("qkv", got, want):
        assert _rel_err(a, w) <= tol, (name, _rel_err(a, w))


# ------------------------------------------------------- ssd_scan backward

# the CPU cases, four chunks with a ragged tail over an odd head count, and
# the train path's mamba2-130m shapes: the main run's microbatch (4, 1024),
# the long steps' (1, 2048), a ragged L and an odd head count at full width
SSD_BWD_CUDA_CASES = SSD_CASES + [
    (2, 100, 5, 16, 16, 32),
    (4, 1024, 24, 64, 128, 256),
    (1, 2048, 24, 64, 128, 256),
    (2, 1000, 24, 64, 128, 256),
    (1, 700, 23, 64, 128, 256),
    (2, 96, 4, 8, 8, 32),
]


def _ssd_bwd_args(case, dtype, seed=4):
    """The forward's inputs and cotangents (dy, dS) on the card."""
    B, L, H, P, N, _ = case
    x, dt, a, b, c = _ssd_inputs(case)
    rng = np.random.default_rng(seed)
    dy = rng.standard_normal((B, L, H, P)).astype(np.float32)
    ds = rng.standard_normal((B, H, P, N)).astype(np.float32)
    return (_torch(x, dtype).cuda(), torch.from_numpy(dt).cuda(),
            torch.from_numpy(a).cuda(), _torch(b, dtype).cuda(),
            _torch(c, dtype).cuda(), _torch(dy, dtype).cuda(),
            torch.from_numpy(ds).cuda())


@pytest.mark.gpu
@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", SSD_BWD_CUDA_CASES)
def test_ssd_scan_bwd_cuda_matches_plain(case, dtype, with_state):
    """dx, ddt, da, db and dc within 3e-4 (f32) or 4e-2 (bf16) of the
    largest element of each, against ssd_scan_bwd_plain on the same
    inputs."""
    _card()
    *args, dy, ds = _ssd_bwd_args(case, dtype)
    ds = ds if with_state else None
    before = ss.ssd_scan_bwd.launches
    got = ss.ssd_scan_bwd(*args, dy, ds, chunk=case[-1])
    torch.cuda.synchronize()
    assert ss.ssd_scan_bwd.launches == before + 1
    want = ss.ssd_scan_bwd_plain(*args, dy, ds, chunk=case[-1])
    for name, g, w in zip(("x", "dt", "a", "b", "c"), got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert torch.isfinite(g).all().item(), name
        assert _rel_err(g, w) <= SSD_TOL[dtype], (name, _rel_err(g, w))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_scan_bwd_cuda_strided_views(dtype):
    """x, b and c as views into one fused projection, x also as the
    transpose of a (B, H, L, P) tensor, and dy with a batch stride it never
    steps over (B = 1), as a transposed view, and as a view whose head
    stride (69 elements) and base the bf16 kernel's 16-byte copies cannot
    read (the wrapper copies it first): against the plain version on the
    same views."""
    _card()
    B, L, H, P, N, chunk = 1, 300, 6, 64, 128, 128
    g = torch.Generator(device="cuda").manual_seed(6)
    dty = getattr(torch, dtype)
    fused = (torch.randn((B, L, H * P + 2 * N), generator=g, device="cuda")
             * 0.5).to(dty)
    x = fused[..., :H * P].unflatten(-1, (H, P))
    b, c = fused[..., H * P:H * P + N], fused[..., H * P + N:]
    xt = (torch.randn((B, H, L, P), generator=g, device="cuda") * 0.5
          ).to(dty).transpose(1, 2)
    dt = torch.rand((B, L, H), generator=g, device="cuda") * 0.19 + 0.01
    a = -(torch.rand((H,), generator=g, device="cuda") * 1.5 + 0.5)
    dense = torch.randn((B, L, H, P), generator=g, device="cuda").to(dty)
    odd = torch.empty_strided(dense.shape, (3, H * P, P, 1), dtype=dty,
                              device="cuda")
    odd.copy_(dense)
    dyt = dense.transpose(1, 2).contiguous().transpose(1, 2)
    wide = torch.zeros((B, L, H, P + 5), dtype=dty, device="cuda")
    wide[..., 1:P + 1] = dense
    padded = wide[..., 1:P + 1]
    assert not ss.copyable(padded)
    for xx in (x, xt):
        for dy in (odd, dyt, padded):
            got = ss.ssd_scan_bwd(xx, dt, a, b, c, dy, chunk=chunk)
            want = ss.ssd_scan_bwd_plain(xx, dt, a, b, c, dense, chunk=chunk)
            for name, gg, w in zip(("x", "dt", "a", "b", "c"), got, want):
                assert _rel_err(gg, w) <= SSD_TOL[dtype], (name,
                                                           _rel_err(gg, w))


@pytest.mark.gpu
def test_ssd_scan_bwd_cuda_is_deterministic():
    """Repeated bf16 calls at the train path's (4, 1024) give every gradient
    bit for bit: db, dc and da are sums over heads and chunks taken in a
    fixed order."""
    _card()
    *args, dy, ds = _ssd_bwd_args((4, 1024, 24, 64, 128, 256), "bfloat16")
    first = ss.ssd_scan_bwd(*args, dy, chunk=256)
    for _ in range(3):
        again = ss.ssd_scan_bwd(*args, dy, chunk=256)
        torch.cuda.synchronize()
        for name, a, b in zip(("x", "dt", "a", "b", "c"), first, again):
            assert torch.equal(a, b), f"d{name} differs between calls"


@pytest.mark.gpu
def test_ssd_scan_bwd_replays_in_a_cuda_graph():
    """The backward captured in a CUDA graph: two replays in a row give the
    eager result bit for bit."""
    _card()
    *args, dy, ds = _ssd_bwd_args((1, 600, 24, 64, 128, 256), "bfloat16")
    fn = lambda: ss.ssd_scan_bwd(*args, dy, ds, chunk=256)  # noqa: E731
    eager = fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = fn()
    for _ in range(2):
        for out in outs:
            out.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(o, e) for o, e in zip(outs, eager))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_grad_on_the_card(dtype):
    """Autograd through ops.ssd on CUDA tensors: one forward launch and one
    backward launch, and the gradients of every input, with cotangents on
    y and on the final state, against the CPU's of the same values."""
    _card()
    case = (2, 700, 5, 64, 128, 256)
    x, dt, a, b, c = _ssd_inputs(case)
    rng = np.random.default_rng(5)
    dy = rng.standard_normal(x.shape).astype(np.float32)
    ds = rng.standard_normal((2, 5, 64, 128)).astype(np.float32)
    grads = {}
    for dev in ("cpu", "cuda"):
        leaves = [(_torch(t, dtype) if i in (0, 3, 4) else
                   torch.from_numpy(t)).to(dev).requires_grad_()
                  for i, t in enumerate((x, dt, a, b, c))]
        fwd0, bwd0 = ss.ssd_scan.launches, ss.ssd_scan_bwd.launches
        y, state = tops.ssd(*leaves, chunk=256)
        torch.autograd.backward(
            [y, state], [_torch(dy, dtype).to(dev), torch.from_numpy(ds).to(dev)])
        if dev == "cuda":
            torch.cuda.synchronize()
            assert ss.ssd_scan.launches == fwd0 + 1
            assert ss.ssd_scan_bwd.launches == bwd0 + 1
        grads[dev] = [t.grad.cpu() for t in leaves]
    for name, g, w in zip(("x", "dt", "a", "b", "c"), grads["cuda"],
                          grads["cpu"]):
        assert _rel_err(g, w) <= SSD_TOL[dtype], (name, _rel_err(g, w))
