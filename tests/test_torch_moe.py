"""Port parity for the MoE FFN (``repro_torch.models.moe``) against the
single-device path of ``repro.models.moe`` (no mesh: every expert on every
token, masked by the normalised top-k router weights), and for the MoE
block (router, experts, llama4's shared expert) through
``lm.block_apply``. The JAX package's weights cross bit-exact through
``from_numpy_tree``; smoke widths (d_model 64, 4 experts, expert ff 32).

Tolerances, as max |got - ref| <= tol * max(max |ref|, 1): 1e-4 in f32 (the
same arithmetic summed in another order); 2e-2 in bf16 (the bf16 leaves and
input; router and combine in f32 in both; the frameworks round the bf16
expert products differently). The router's expert indices are held
exactly.

The JAX package is imported only where it is installed, so that ``-m gpu``
runs this file's card test where it is not.
"""
import numpy as np
import pytest
import torch

try:
    import jax
    import jax.numpy as jnp
    from repro.configs import get_smoke_config as jax_cfg
    from repro.models import lm as jlm
    from repro.models import moe as jm
    from repro.models import params as jp
except ImportError:                 # the card's machine: no JAX
    jax = None
from repro_torch.configs import get_smoke_config as torch_cfg
from repro_torch.models import lm as tlm
from repro_torch.models import moe as tm
from repro_torch.models.params import from_numpy_tree

TOL = {"float32": 1e-4, "bfloat16": 2e-2}
DTYPES = ["float32", "bfloat16"]
ARCHS = ["qwen3-moe-235b-a22b", "llama4-maverick-400b-a17b"]


def _close(got, want, dtype, what):
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1.0)
    err = float(np.abs(got - want).max())
    assert err <= TOL[dtype] * scale, (what, err, TOL[dtype] * scale)


def _bridge(spec, dtype, seed):
    """The reference's init of ``spec``, bf16 leaves cast to ``dtype`` (f32
    leaves stay f32): (JAX tree, tensors)."""
    p = jax.tree.map(
        lambda a: a if a.dtype == jnp.float32 else a.astype(
            getattr(jnp, dtype)),
        jp.materialize(spec, jax.random.PRNGKey(seed)))
    return p, from_numpy_tree(jax.tree.map(np.asarray, p), "cpu")


def _x(shape, dtype, seed=2):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return jnp.asarray(x, getattr(jnp, dtype)), torch.from_numpy(x).to(
        getattr(torch, dtype))


@pytest.mark.parametrize("arch", ARCHS)
def test_spec_matches_reference(arch):
    want = jm.moe_spec(jax_cfg(arch))
    got = tm.moe_spec(torch_cfg(arch))
    assert set(got) == set(want)
    for k, s in want.items():
        assert (tuple(got[k].shape), got[k].axes,
                str(got[k].dtype).split(".")[-1]) == \
            (tuple(s.shape), s.axes, np.dtype(s.dtype).name), k


@pytest.mark.parametrize("arch", ARCHS)
def test_router_matches_reference(arch):
    jc, tc = jax_cfg(arch), torch_cfg(arch)
    pj, pt = _bridge(jm.moe_spec(jc), "float32", 1)
    xj, xt = _x((3, 11, jc.d_model), "float32")
    wp, wi, wl = jm._router(pj, jc, xj)
    gp, gi, gl = tm._router(pt, tc, xt)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    _close(gp, wp, "float32", "top_p")
    _close(gl, wl, "float32", "logits")
    assert gp.dtype == gl.dtype == torch.float32


def test_router_breaks_ties_as_lax_top_k():
    """Experts 0, 2 and 3 with the same router column, so the same
    probability for every token: top-2 takes the lower indices, 0 then 2,
    as lax.top_k does, with weight 1/2 each."""
    jc, tc = jax_cfg(ARCHS[0]), torch_cfg(ARCHS[0])
    assert jc.moe.num_experts == 4 and jc.moe.top_k == 2
    rng = np.random.default_rng(3)
    col = rng.standard_normal((jc.d_model, 1)).astype(np.float32)
    router = np.concatenate([col, -col, col, col], axis=1)
    x = np.abs(rng.standard_normal((2, 5, jc.d_model))).astype(np.float32)
    x *= np.sign(col[:, 0])                     # col . x > 0: 0, 2, 3 lead
    wp, wi, _ = jm._router({"router": jnp.asarray(router)}, jc,
                           jnp.asarray(x))
    gp, gi, _ = tm._router({"router": torch.from_numpy(router)}, tc,
                           torch.from_numpy(x))
    assert (np.asarray(wi) == [0, 2]).all()
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_array_equal(gp.numpy(), np.asarray(wp))
    assert (gp.numpy() == 0.5).all()


@pytest.mark.parametrize("dtype", DTYPES)
def test_expert_ffn_matches_reference(dtype):
    jc = jax_cfg(ARCHS[0])
    pj, pt = _bridge(jm.moe_spec(jc), dtype, 4)
    xj, xt = _x((jc.moe.num_experts, 6, jc.d_model), dtype)
    want = jm._expert_ffn(xj, pj["w_gate"], pj["w_in"], pj["w_out"])
    got = tm._expert_ffn(xt, pt["w_gate"], pt["w_in"], pt["w_out"])
    assert got.dtype == xt.dtype
    _close(got, want, dtype, "y")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_apply_matches_reference(arch, dtype):
    jc, tc = jax_cfg(arch), torch_cfg(arch)
    pj, pt = _bridge(jm.moe_spec(jc), dtype, 5)
    xj, xt = _x((2, 13, jc.d_model), dtype)
    want = jm.moe_apply(pj, jc, xj)
    got = tm.moe_apply(pt, tc, xt)
    assert got.dtype == xt.dtype
    _close(got, want, dtype, "y")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_block_matches_reference(arch, dtype):
    """A whole MoE block in train mode: attention, the norms, the routed
    experts and, for llama4, the shared expert."""
    jc, tc = jax_cfg(arch), torch_cfg(arch)
    spec = jlm.block_spec(jc, "attn")
    assert ("shared" in spec) == jc.moe.shared_expert
    pj, pt = _bridge(spec, dtype, 6)
    S = 9
    xj, xt = _x((2, S, jc.d_model), dtype, seed=7)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (2, S))
    want, _ = jlm.block_apply(pj, jc, "attn", xj, mode="train",
                              positions=jnp.asarray(pos), chunk=8)
    got, _ = tlm.block_apply(pt, tc, "attn", xt, mode="train",
                             positions=torch.from_numpy(pos.copy()))
    _close(got, want, dtype, "x")


@pytest.mark.gpu
def test_moe_rows_do_not_depend_on_token_count_on_the_card():
    """One full-width qwen3-moe layer (128 experts of 4096 x 1536, bf16) on
    the card: a token's router logits and output are bit for bit the same
    whether it goes through with 2047 others (a prefill of 2048), with
    2048 others (a train forward of 2049) or alone (a decode step). A
    single f32 product over all the rows does not give that (cuBLAS picks
    its kernel by the row count); the identity prefill(S) == train(S+1)
    at S-1 rests on it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import params as tp
    cfg = dataclasses.replace(get_config(ARCHS[0]), num_layers=1)
    gen = torch.Generator(device="cuda").manual_seed(0)
    p = tp.materialize(tm.moe_spec(cfg), gen)
    x = torch.randn((1, 2049, cfg.d_model), generator=gen,
                    device="cuda").to(torch.bfloat16)
    with torch.no_grad():
        whole = tm._router(p, cfg, x)[2], tm.moe_apply(p, cfg, x)
        for part in (slice(0, 2048), slice(2048, 2049)):
            xs = x[:, part]
            got = tm._router(p, cfg, xs)[2], tm.moe_apply(p, cfg, xs)
            for g, w in zip(got, whole):
                assert torch.equal(g, w[:, part])
