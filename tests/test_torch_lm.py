"""Port parity for decode attention and the whole decode slice: the JAX
package's weights, bridged bit-exact through ``from_numpy_tree``, and the
same numpy cache and tokens go through ``repro`` and ``repro_torch``.

Tolerances, as max |got - ref| <= tol * max(max |ref|, 1):

* f32 (params and cache cast to f32 in both): 1e-4 — the same arithmetic
  summed in another order, over a few layers.
* bf16: 2e-2 — JAX rounds the scaled q and the scores to bf16 before the
  softmax, while the port's flash-decode keeps them in f32 (as the Pallas
  kernel does), and the frameworks round matmul outputs differently.
* bf16, gemma2-27b past the window (cur 20) over the whole slice: 2e-2
  plus twice the JAX package's own bf16-vs-f32 error, leaf by leaf (logits
  and the new cache entries), on the same bridged weights, cache and
  tokens. Over 4 bf16 layers with softcaps and post-norms the reference
  drifts from its own f32 result by more than 2e-2 x scale (logits 0.110
  against 0.067), so a flat bound would hold the port to less than the
  reference's own rounding noise.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_cfg
from repro.models import attention as ja
from repro.models import params as jp
from repro.models.registry import get_bundle as jax_bundle
from repro_torch.configs import get_smoke_config as torch_cfg
from repro_torch.models import attention as ta
from repro_torch.models.params import from_numpy_tree
from repro_torch.models.registry import get_bundle as torch_bundle

TOL = {"float32": 1e-4, "bfloat16": 2e-2}
DTYPES = ["float32", "bfloat16"]


def _close(got, want, dtype, what, ref32=None):
    """max |got - want| <= tol * scale, plus twice |want - ref32| where the
    reference's own f32 result ``ref32`` is given."""
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1.0)
    err = float(np.abs(got - want).max())
    bound = TOL[dtype] * scale
    if ref32 is not None:
        bound += 2 * float(np.abs(want - np.asarray(ref32, np.float32)).max())
    assert err <= bound, (what, err, bound)


def _compare_trees(tt, jt, dtype, path="cache", ref32=None):
    """Walk both trees by key: the same structure, leaves within tolerance
    (with ``ref32``'s leaves as in _close)."""
    if isinstance(jt, dict):
        assert set(tt) == set(jt), path
        for k in jt:
            _compare_trees(tt[k], jt[k], dtype, f"{path}.{k}",
                           None if ref32 is None else ref32[k])
    elif isinstance(jt, (tuple, list)):
        assert len(tt) == len(jt), path
        for i, (a, b) in enumerate(zip(tt, jt)):
            _compare_trees(a, b, dtype, f"{path}[{i}]",
                           None if ref32 is None else ref32[i])
    else:
        _close(tt, jt, dtype, path, ref32)


def _to_dtype(tree, dtype):
    return jax.tree.map(lambda a: a.astype(getattr(jnp, dtype)), tree)


def _random_like(tree, rng, dtype):
    return jax.tree.map(
        lambda a: jnp.asarray(rng.standard_normal(a.shape).astype(np.float32),
                              getattr(jnp, dtype)), tree)


def _bridge(tree):
    """JAX tree -> (the same JAX tree, its tensors), bit-exact."""
    return tree, from_numpy_tree(jax.tree.map(np.asarray, tree), "cpu")


ATTN_CASES = [
    # arch, layer kind, cache length, cur
    ("qwen2-0.5b", "attn", 40, 25),        # G = 7 q-heads per kv-head
    ("qwen2-0.5b", "attn", 40, 39),
    ("gemma2-27b", "local", 40, 9),        # ring S == W = 16, cur inside
    ("gemma2-27b", "local", 40, 37),       # ... and past the window
    ("gemma2-27b", "attn", 40, 37),        # global layer, softcap 50
]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch,kind,max_len,cur", ATTN_CASES)
def test_attend_decode_matches_reference(arch, kind, max_len, cur, dtype):
    jc, tc = jax_cfg(arch), torch_cfg(arch)
    rng = np.random.default_rng(0)
    p = _to_dtype(jp.materialize(ja.attn_spec(jc), jax.random.PRNGKey(1)),
                  dtype)
    pj, pt = _bridge(p)
    cache = _random_like(ja.make_cache(jc, kind, 2, max_len), rng, dtype)
    cj, ct = _bridge(cache)
    if kind == "local":
        assert cj["k"].shape[1] == jc.window          # a ring
    x = rng.standard_normal((2, 1, jc.d_model)).astype(np.float32)
    yj, new_j = ja.attend_decode(pj, jc, jnp.asarray(x, getattr(jnp, dtype)),
                                 cj, cur, kind=kind)
    yt, new_t = ta.attend_decode(pt, tc, torch.from_numpy(x).to(
        getattr(torch, dtype)), ct, cur, kind=kind)
    assert new_t is ct                                # written in place
    _close(yt, yj, dtype, "y")
    _compare_trees(new_t, new_j, dtype)


def test_attend_decode_clamps_slot_like_dynamic_update_slice():
    """A global-layer cur past the cache end writes slot S-1, as JAX's
    dynamic_update_slice clamps its start index."""
    jc, tc = jax_cfg("qwen2-0.5b"), torch_cfg("qwen2-0.5b")
    rng = np.random.default_rng(3)
    p = _to_dtype(jp.materialize(ja.attn_spec(jc), jax.random.PRNGKey(2)),
                  "float32")
    pj, pt = _bridge(p)
    cj, ct = _bridge(_random_like(ja.make_cache(jc, "attn", 1, 8), rng,
                                  "float32"))
    x = rng.standard_normal((1, 1, jc.d_model)).astype(np.float32)
    yj, new_j = ja.attend_decode(pj, jc, jnp.asarray(x), cj, 11, kind="attn")
    yt, new_t = ta.attend_decode(pt, tc, torch.from_numpy(x), ct, 11,
                                 kind="attn")
    _close(yt, yj, "float32", "y")
    _compare_trees(new_t, new_j, "float32")


SLICE_CASES = [
    ("qwen2-0.5b", 20, "float32"), ("qwen2-0.5b", 20, "bfloat16"),
    ("gemma2-27b", 9, "float32"), ("gemma2-27b", 9, "bfloat16"),
    ("gemma2-27b", 20, "float32"), ("gemma2-27b", 20, "bfloat16"),
]
# held to the reference's own bf16 error (see the module docstring): its
# logits differ from the reference's by 0.179, the reference's bf16 logits
# from its f32 logits by 0.110, on the same weights, cache and tokens
REF_BOUND_CASES = {("gemma2-27b", 20, "bfloat16")}


@pytest.mark.parametrize("arch,cur,dtype", SLICE_CASES)
def test_decode_slice_matches_reference(arch, cur, dtype):
    """lm.forward(mode="decode") logits and returned cache against the JAX
    Bundle.decode."""
    jb, tb = jax_bundle(jax_cfg(arch)), torch_bundle(torch_cfg(arch))
    rng = np.random.default_rng(5)
    B, max_len = 2, 24
    pj, pt = _bridge(_to_dtype(jb.init(jax.random.PRNGKey(0)), dtype))
    cj, ct = _bridge(_random_like(
        jb.init_cache(B, max_len, dtype=getattr(jnp, dtype)), rng, dtype))
    tokens = rng.integers(0, jb.cfg.vocab_size, (B, 1)).astype(np.int32)
    lj, new_j = jb.decode(pj, cj, jnp.asarray(tokens), cur)
    lt, new_t = tb.decode(pt, ct, torch.from_numpy(tokens).long(), cur)
    V = jb.cfg.vocab_size
    l32 = new_32 = None
    if (arch, cur, dtype) in REF_BOUND_CASES:
        l32, new_32 = jb.decode(_to_dtype(pj, "float32"),
                                _to_dtype(cj, "float32"), jnp.asarray(tokens),
                                cur)
        l32 = np.asarray(l32)[..., :V]
    assert lt.dtype == torch.float32
    _close(lt[..., :V], np.asarray(lj)[..., :V], dtype, "logits", l32)
    np.testing.assert_array_equal(lt[..., V:].numpy(), np.asarray(lj)[..., V:])
    _compare_trees(new_t, new_j, dtype, ref32=new_32)


def test_weight_bridge_is_bit_exact():
    """bf16 weights cross as their raw 16 bits (torch.from_numpy refuses
    ml_dtypes.bfloat16 directly)."""
    jb = jax_bundle(jax_cfg("qwen2-0.5b"))
    params = jb.init(jax.random.PRNGKey(4))
    tp = from_numpy_tree(jax.tree.map(np.asarray, params), "cpu")
    for jl, tl in zip(jax.tree.leaves(params["stack"][0]["attn"]),
                      [tp["stack"][0]["attn"][k]
                       for k in sorted(tp["stack"][0]["attn"])]):
        assert tl.dtype == torch.bfloat16
        np.testing.assert_array_equal(
            tl.view(torch.int16).numpy(),
            np.asarray(jl).view(np.int16))
