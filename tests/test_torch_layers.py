"""Port parity for ``repro_torch.models.layers`` against ``repro.models.layers``:
the same numpy inputs and weights through both, in f32 (tolerance 1e-5: the
same f32 arithmetic, summed in another order) and bf16 (tolerance 2e-2: one
bf16 ulp near 1 is 7.8e-3, and the frameworks round matmul outputs in
different places)."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config
from repro.models import layers as jl
from repro_torch.models import layers as tl

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
DTYPES = ["float32", "bfloat16"]


def _pair(a, dtype):
    """The same numpy array as a JAX array and a tensor of ``dtype``."""
    a = np.asarray(a, np.float32)
    return jnp.asarray(a, getattr(jnp, dtype)), torch.from_numpy(a).to(
        getattr(torch, dtype))


def _close(got, want, dtype):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=TOL[dtype], atol=TOL[dtype])


def _rng(seed=0):
    return np.random.default_rng(seed)


@pytest.mark.parametrize("dtype", DTYPES)
def test_rmsnorm(dtype):
    r = _rng()
    xj, xt = _pair(r.standard_normal((2, 3, 64)) * 3.0, dtype)
    sj, st = _pair(r.standard_normal(64) * 0.1, dtype)
    _close(tl.rmsnorm({"scale": st}, xt, 1e-6),
           jl.rmsnorm({"scale": sj}, xj, 1e-6), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("theta", [1e4, 1e6])
def test_rope(dtype, theta):
    r = _rng(1)
    xj, xt = _pair(r.standard_normal((2, 5, 7, 16)), dtype)
    pos = r.integers(0, 4096, (2, 5)).astype(np.int32)
    _close(tl.rope(xt, torch.from_numpy(pos), theta),
           jl.rope(xj, jnp.asarray(pos), theta), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ["qwen2-0.5b", "starcoder2-3b"])
def test_mlp(dtype, arch):
    """swiglu (qwen2) and tanh-gelu with biases (starcoder2)."""
    cfg = get_smoke_config(arch)
    r = _rng(2)
    d, ff = cfg.d_model, cfg.d_ff
    shapes = ({"w_gate": (d, ff), "w_in": (d, ff), "w_out": (ff, d)}
              if cfg.mlp == "swiglu" else
              {"w_in": (d, ff), "b_in": (ff,), "w_out": (ff, d), "b_out": (d,)})
    pj, pt = {}, {}
    for name, shape in shapes.items():
        pj[name], pt[name] = _pair(r.standard_normal(shape) / np.sqrt(shape[0]),
                                   dtype)
    xj, xt = _pair(r.standard_normal((2, 3, d)), dtype)
    from repro_torch.configs import get_smoke_config as tcfg
    _close(tl.mlp(pt, tcfg(arch), xt), jl.mlp(pj, cfg, xj), dtype)


EMBED_CASES = [
    # arch, overrides: qwen2 (tied, padded vocab 503 -> 512), gemma2 (tied,
    # sqrt(d) scaling, final softcap 30), starcoder2 (untied lm_head)
    ("qwen2-0.5b", {}),
    ("gemma2-27b", {}),
    ("starcoder2-3b", {}),
    ("gemma2-27b", {"final_softcap": 5.0}),
]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch,over", EMBED_CASES)
def test_embed_unembed(dtype, arch, over):
    from repro_torch.configs import get_smoke_config as tcfg
    jc = dataclasses.replace(get_smoke_config(arch), **over)
    tc = dataclasses.replace(tcfg(arch), **over)
    r = _rng(3)
    pj, pt = {}, {}
    pj["embedding"], pt["embedding"] = _pair(
        r.standard_normal((jc.vocab_padded, jc.d_model)), dtype)
    if not jc.tie_embeddings:
        pj["lm_head"], pt["lm_head"] = _pair(
            r.standard_normal((jc.d_model, jc.vocab_padded)) * 0.2, dtype)
    tok = r.integers(0, jc.vocab_size, (2, 3))
    xt = tl.embed(pt, tc, torch.from_numpy(tok))
    xj = jl.embed(pj, jc, jnp.asarray(tok))
    _close(xt, xj, dtype)
    h = r.standard_normal((2, 3, jc.d_model)) * 0.3
    hj, ht = _pair(h, dtype)
    lt, lj = tl.unembed(pt, tc, ht), jl.unembed(pj, jc, hj)
    assert lt.dtype == torch.float32 and lt.shape == (2, 3, jc.vocab_padded)
    lj = np.asarray(lj)
    real = slice(0, jc.vocab_size)
    scale = max(np.abs(lj[..., real]).max(), 1.0)
    np.testing.assert_allclose(lt[..., real].numpy(), lj[..., real],
                               rtol=TOL[dtype], atol=TOL[dtype] * scale)
    # the padded vocab is masked with f32's most negative finite value
    np.testing.assert_array_equal(lt[..., jc.vocab_size:].numpy(),
                                  lj[..., jc.vocab_size:])


@pytest.mark.parametrize("cap", [0.0, 50.0])
def test_softcap(cap):
    x = np.linspace(-200, 200, 41, dtype=np.float32)
    np.testing.assert_allclose(tl.softcap(torch.from_numpy(x), cap).numpy(),
                               np.asarray(jl.softcap(jnp.asarray(x), cap)),
                               rtol=1e-6, atol=1e-5)
