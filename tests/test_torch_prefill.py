"""Port parity for the prefill → decode slice: ``attend_full``,
``prefill_into_cache``, ``lm.forward`` in ``train``/``prefill`` mode,
``Bundle.prefill`` then ``Bundle.decode``, against the JAX package (the
plain steps are in tests/test_torch_steps.py). The JAX
package's weights cross bit-exact through ``from_numpy_tree``; tokens and
activations are numpy draws fed to both. Smoke-size configs (2-4 layers,
d_model 64).

Tolerances, as max |got - ref| <= bound with scale = max(max |ref|, 1):

* f32: 1e-4 * scale — the same arithmetic summed in another order.
* bf16, one attention layer: 2e-2 * scale (the reference rounds q*scale
  and the scores to bf16 inside ``flash_xla``, the port's kernel keeps
  them in f32).
* bf16, whole model (prefill logits, then decode logits): 2e-2 * scale
  plus twice the JAX package's own bf16-vs-f32 logit error on the same
  bridged weights and tokens. Over 2-4 bf16 layers the reference drifts
  from its own f32 result by up to 0.56 (phi4-mini decode, scale 3.9), so
  a flat 2e-2 * scale would hold the port to less than the reference's own
  rounding noise.
* prefill_into_cache moves data only: held bit for bit.
* ``decode_matches_full_forward`` (the port against itself, as
  tests/test_models_smoke.py holds the reference): prefill logits within
  1e-3 relative of the train-mode logits at S-1; decode(S) within 0.06
  relative of the train-mode logits at S.
"""
import functools

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
from repro_torch.models import lm as tlm
from repro_torch.models.params import from_numpy_tree
from repro_torch.models.registry import get_bundle as torch_bundle

TOL = {"float32": 1e-4, "bfloat16": 2e-2}
DTYPES = ["float32", "bfloat16"]
ARCHS = ["qwen2-0.5b", "gemma2-27b", "phi4-mini-3.8b", "starcoder2-3b",
         "mamba2-130m", "recurrentgemma-2b", "qwen3-moe-235b-a22b",
         "llama4-maverick-400b-a17b"]


def _err(got, want):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    return (float(np.abs(got - want).max()),
            max(float(np.abs(want).max()), 1.0))


def _close(got, want, dtype, what):
    err, scale = _err(got, want)
    assert err <= TOL[dtype] * scale, (what, err, TOL[dtype] * scale)


def _cast(tree, dtype):
    """Cast the bf16 leaves to ``dtype``; f32 leaves (Mamba2's a_log,
    d_skip, norm) stay f32, as the spec declares them."""
    return jax.tree.map(
        lambda a: a.astype(getattr(jnp, dtype)) if a.dtype != jnp.float32
        else a, tree)


def _bridge(tree):
    return from_numpy_tree(jax.tree.map(np.asarray, tree), "cpu")


def _tokens(cfg, shape, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape).astype(np.int32)


# ------------------------------------------------------------- attention

ATTN_CASES = [
    # arch, layer kind, S
    ("qwen2-0.5b", "attn", 24),            # G = 7 q-heads per kv-head
    ("gemma2-27b", "local", 24),           # window 16 < S, softcap 50
    ("gemma2-27b", "attn", 24),            # global layer, softcap 50
    ("phi4-mini-3.8b", "attn", 19),        # ragged S
]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch,kind,S", ATTN_CASES)
def test_attend_full_matches_reference(arch, kind, S, dtype):
    jc, tc = jax_cfg(arch), torch_cfg(arch)
    p = _cast(jp.materialize(ja.attn_spec(jc), jax.random.PRNGKey(1)), dtype)
    x = np.random.default_rng(2).standard_normal(
        (2, S, jc.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (2, S))
    yj, (kj, vj) = ja.attend_full(p, jc, jnp.asarray(x, getattr(jnp, dtype)),
                                  kind=kind, positions=jnp.asarray(pos),
                                  chunk=8)
    yt, (kt, vt) = ta.attend_full(
        _bridge(p), tc, torch.from_numpy(x).to(getattr(torch, dtype)),
        kind=kind, positions=torch.from_numpy(pos.copy()))
    assert yt.dtype == getattr(torch, dtype)
    _close(yt, yj, dtype, "y")
    _close(kt, kj, dtype, "k")
    _close(vt, vj, dtype, "v")


CACHE_CASES = [
    # arch, kind, S, max_len: local ring with S > cap, S < cap, S == cap;
    # a global layer padded to max_len
    ("gemma2-27b", "local", 37, 40),
    ("gemma2-27b", "local", 10, 40),
    ("gemma2-27b", "local", 16, 40),
    ("gemma2-27b", "attn", 10, 40),
    ("qwen2-0.5b", "attn", 24, 24),
]


@pytest.mark.parametrize("arch,kind,S,max_len", CACHE_CASES)
def test_prefill_into_cache_matches_reference(arch, kind, S, max_len):
    """Bit for bit, and owned contiguous tensors that decode can write into
    in place."""
    jc, tc = jax_cfg(arch), torch_cfg(arch)
    rng = np.random.default_rng(3)
    shape = (2, S, jc.n_kv_heads, jc.head_dim)
    k, v = (rng.standard_normal(shape).astype(np.float32) for _ in "kv")
    want = ja.prefill_into_cache(jc, kind, jnp.asarray(k), jnp.asarray(v),
                                 max_len)
    kt, vt = torch.from_numpy(k), torch.from_numpy(v)
    got = ta.prefill_into_cache(tc, kind, kt, vt, max_len)
    for n, src in (("k", kt), ("v", vt)):
        np.testing.assert_array_equal(got[n].numpy(), np.asarray(want[n]))
        assert got[n].is_contiguous()
        assert got[n].untyped_storage().data_ptr() != \
            src.untyped_storage().data_ptr()


# ------------------------------------------------------------- whole model

B, S, CACHE_LEN = 2, 20, 32


@functools.lru_cache(maxsize=None)
def _jax_prefill_decode(arch, dtype):
    """The JAX Bundle's logits for prefill(S), then decode at S and S+1, on
    the bf16 init cast to ``dtype`` (f32 leaves stay f32), and the decode
    cache's leaves. Cached: the f32 run serves both the f32 case and the
    bf16 case's bound."""
    jb = jax_bundle(jax_cfg(arch))
    params = _cast(jb.init(jax.random.PRNGKey(0)), dtype)
    toks = _tokens(jb.cfg, (B, S + 2))
    logits, cache = jb.prefill(params, {"tokens": jnp.asarray(toks[:, :S])},
                               chunk=8, cache_len=CACHE_LEN)
    out = [logits]
    for i in range(2):
        logits, cache = jb.decode(params, cache,
                                  jnp.asarray(toks[:, S + i:S + i + 1]),
                                  S + i)
        out.append(logits)
    return ([np.asarray(o, np.float32) for o in out],
            [(a.shape, np.dtype(a.dtype).name)
             for a in jax.tree.leaves(cache)], params, toks)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_decode_matches_reference(arch, dtype):
    """Bundle.prefill(S) then Bundle.decode at S and S+1: the logits, and
    the decode cache's structure, shapes and dtypes."""
    tb = torch_bundle(torch_cfg(arch))
    V = tb.cfg.vocab_size
    want, jleaves, params, toks = _jax_prefill_decode(arch, dtype)
    pt = _bridge(params)
    lt, tcache = tb.prefill(pt, {"tokens": torch.from_numpy(toks[:, :S])},
                            cache_len=CACHE_LEN)
    got = [lt]
    for i in range(2):
        tok = torch.from_numpy(toks[:, S + i:S + i + 1])
        lt, out_cache = tb.decode(pt, tcache, tok, S + i)
        assert out_cache is tcache                    # updated in place
        got.append(lt)
    tleaves = jax.tree.leaves(tcache)        # tensors are leaves to jax
    assert [(tuple(t.shape), str(t.dtype).split(".")[-1])
            for t in tleaves] == jleaves

    if dtype == "float32":
        bounds = [TOL[dtype] * _err(w[..., :V], w[..., :V])[1] for w in want]
    else:                  # the reference's own bf16 error, on f32 weights
        ref32 = _jax_prefill_decode(arch, "float32")[0]
        bounds = []
        for w, r in zip(want, ref32):
            ref_err, scale = _err(w[..., :V], r[..., :V])
            bounds.append(TOL[dtype] * scale + 2 * ref_err)
    for step, (g, w, bound) in enumerate(zip(got, want, bounds)):
        assert g.shape == w.shape and g.dtype == torch.float32
        err, _ = _err(g[..., :V], w[..., :V])
        assert err <= bound, (step, err, bound)
        np.testing.assert_array_equal(g[..., V:].numpy(), w[..., V:])


@pytest.mark.parametrize("arch", ARCHS)
def test_train_logits_match_reference(arch):
    jb, tb = jax_bundle(jax_cfg(arch)), torch_bundle(torch_cfg(arch))
    params = _cast(jb.init(jax.random.PRNGKey(0)), "float32")
    toks = _tokens(jb.cfg, (2, 17))
    want = jb.train_logits(params, {"tokens": jnp.asarray(toks)}, chunk=8)
    got = tb.train_logits(_bridge(params),
                          {"tokens": torch.from_numpy(toks)})
    V = jb.cfg.vocab_size
    _close(got[..., :V], np.asarray(want)[..., :V], "float32", "logits")


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_full_forward(arch):
    """tests/test_models_smoke.py's identity in the port: prefill(S) +
    decode(S) == train-mode forward over S+1 tokens, on the port's own bf16
    weights."""
    cfg = torch_cfg(arch)
    bundle = torch_bundle(cfg)
    params = bundle.init(torch.Generator().manual_seed(0))
    B, S = 2, 24
    toks = torch.from_numpy(_tokens(cfg, (B, S + 1)))
    full, _ = tlm.forward(params, cfg, mode="train", tokens=toks)
    plogits, cache = tlm.forward(params, cfg, mode="prefill",
                                 tokens=toks[:, :S], cache_len=S + 8)
    dlogits, _ = tlm.forward(params, cfg, mode="decode",
                             tokens=toks[:, S:S + 1], cache=cache,
                             cur_index=S)
    V = cfg.vocab_size
    ref, fref = full[:, -1, :V], full[:, S - 1, :V]
    got, pref = dlogits[:, 0, :V], plogits[:, -1, :V]
    assert (pref - fref).abs().max() / max(fref.abs().max(), 1.0) < 1e-3
    assert (got - ref).abs().max() / max(ref.abs().max(), 1.0) < 0.06
