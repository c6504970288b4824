"""Port parity for the flash-decode kernel module: the port's plain version
(what a CPU tensor runs) against the JAX package's Pallas kernel (interpret
mode, as tests/test_kernels.py runs it) and its ref.py oracle, and — on a
card only — the CUDA kernel against the plain version.

Tolerances are the reference's own (tests/test_kernels.py): 2e-4 in f32,
2e-2 in bf16 (one bf16 ulp near 1 is 7.8e-3; the Pallas kernel and the
oracle round p at different points).

The JAX package is imported inside the parity test, not at the top, so
that ``-m gpu`` runs this file where JAX is not installed."""
import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_decode as fd
from repro_torch.kernels import ops as tops

TOL = {"float32": 2e-4, "bfloat16": 2e-2}

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
    return t.float().cpu().numpy()


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
                                   (8, 2, 4096), (2, 1, 40), (1, 4, 1)])
def test_split_plan_covers_cache(B, K, S):
    """Every split the kernel is launched with holds at least one key, the
    splits tile [0, S) and each is a whole number of tiles."""
    n_split, split_len = fd.split_plan(B, K, S, sms=132, tile=32)
    assert split_len % 32 == 0
    assert (n_split - 1) * split_len < S <= n_split * split_len
    assert B * K * n_split < 2 * 132 + B * K


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
