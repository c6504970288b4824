"""Port parity for encoder-decoder and image input: cross-attention
(``attend_full`` with ``x_kv``, ``attend_decode(cross=True)``), the encoder
pass ``lm.encode``, ``models.encdec`` and the bundle's dispatch for
seamless-m4t-medium (encoder-decoder over audio frames) and
llava-next-mistral-7b (image patch rows before the prompt), against the JAX
package. Its weights cross bit-exact through ``from_numpy_tree``; frames,
image rows, tokens and activations are numpy draws fed to both. Smoke-size
configs (2 encoder and 2 decoder layers, d_model 64; llava 8 image rows).

Tolerances, as max |got - ref| <= bound with scale = max(max |ref|, 1), as
tests/test_torch_prefill.py holds them:

* f32: 1e-4 * scale — the same arithmetic summed in another order.
* bf16, one layer: 2e-2 * scale.
* bf16, a whole stack (the encoder's output; the model's prefill, then
  decode logits): 2e-2 * scale plus twice the JAX package's own
  bf16-vs-f32 error on the same bridged weights and inputs. Over the two
  encoder layers the reference drifts from its own f32 result by 0.51
  (scale 3.9), the port from the reference by 0.17, so a flat 2e-2 * scale
  would hold the port to less than the reference's own rounding noise.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_cfg
from repro.models import attention as ja
from repro.models import encdec as jed
from repro.models import lm as jlm
from repro.models import params as jp
from repro.models.registry import get_bundle as jax_bundle
from repro_torch.configs import get_smoke_config as torch_cfg
from repro_torch.models import attention as ta
from repro_torch.models import encdec as ted
from repro_torch.models import lm as tlm
from repro_torch.models.params import from_numpy_tree
from repro_torch.models.registry import get_bundle as torch_bundle

TOL = {"float32": 1e-4, "bfloat16": 2e-2}
DTYPES = ["float32", "bfloat16"]
ENCDEC = "seamless-m4t-medium"
VLM = "llava-next-mistral-7b"


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
    return jax.tree.map(
        lambda a: a.astype(getattr(jnp, dtype)) if a.dtype != jnp.float32
        else a, tree)


def _bridge(tree):
    return from_numpy_tree(jax.tree.map(np.asarray, tree), "cpu")


def _draw(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _pair(a, dtype):
    return jnp.asarray(a, getattr(jnp, dtype)), torch.from_numpy(a).to(
        getattr(torch, dtype))


def _spec_shapes(tree):
    if isinstance(tree, dict):
        return {k: _spec_shapes(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return tuple(_spec_shapes(v) for v in tree)
    return (tuple(tree.shape), str(np.dtype(tree.dtype)) if not isinstance(
        tree.dtype, torch.dtype) else str(tree.dtype).split(".")[-1])


@pytest.mark.parametrize("arch", [ENCDEC, VLM])
def test_spec_matches_reference(arch):
    """The same tree, shapes and dtypes: the encoder (no embedding) and the
    decoder with its cross layers for seamless; a plain LM for llava."""
    want = _spec_shapes(jax_bundle(jax_cfg(arch)).spec())
    got = _spec_shapes(torch_bundle(torch_cfg(arch)).spec())
    assert got == want
    if arch == ENCDEC:
        assert set(got) == {"encoder", "decoder"} and "embed" not in \
            got["encoder"]
        assert {"ln_x", "cross"} <= set(got["decoder"]["stack"][0])


@pytest.mark.parametrize("dtype", DTYPES)
def test_encode_matches_reference(dtype):
    """The bidirectional encoder: train mode, causal=False, final norm."""
    jc, tc = jax_cfg(ENCDEC), torch_cfg(ENCDEC)
    enc_j, enc_t = jed.encoder_config(jc), ted.encoder_config(tc)
    assert enc_t.num_layers == tc.enc_layers and not enc_t.is_encdec
    init = jax_bundle(jc).init(jax.random.PRNGKey(0))
    frames = _draw((2, 13, jc.d_model), 1, 0.5)
    params = _cast(init, dtype)
    fj, ft = _pair(frames, dtype)
    want = jlm.encode(params["encoder"], enc_j, fj, chunk=8)
    got = tlm.encode(_bridge(params["encoder"]), enc_t, ft)
    assert got.dtype == ft.dtype
    err, scale = _err(got, want)
    bound = TOL[dtype] * scale
    if dtype == "bfloat16":           # the reference's own bf16 error
        ref32 = jlm.encode(_cast(init, "float32")["encoder"], enc_j,
                           jnp.asarray(frames), chunk=8)
        bound += 2 * _err(want, ref32)[0]
    assert err <= bound, (err, bound)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("Sq,Skv", [(9, 17), (17, 9)])
def test_cross_attend_full_matches_reference(Sq, Skv, dtype):
    """Queries from the decoder, keys and values from the encoder output:
    no RoPE on either, never causal."""
    jc, tc = jax_cfg(ENCDEC), torch_cfg(ENCDEC)
    p = _cast(jp.materialize(ja.attn_spec(jc, cross=True),
                             jax.random.PRNGKey(1)), dtype)
    xj, xt = _pair(_draw((2, Sq, jc.d_model), 2), dtype)
    ej, et = _pair(_draw((2, Skv, jc.d_model), 3), dtype)
    pos = np.broadcast_to(np.arange(Sq, dtype=np.int32), (2, Sq))
    epos = np.broadcast_to(np.arange(Skv, dtype=np.int32), (2, Skv))
    yj, (kj, vj) = ja.attend_full(p, jc, xj, kind="attn",
                                  positions=jnp.asarray(pos), x_kv=ej,
                                  kv_positions=jnp.asarray(epos), cross=True,
                                  chunk=8)
    yt, (kt, vt) = ta.attend_full(_bridge(p), tc, xt, kind="attn",
                                  positions=torch.from_numpy(pos.copy()),
                                  x_kv=et,
                                  kv_positions=torch.from_numpy(epos.copy()),
                                  cross=True)
    _close(yt, yj, dtype, "y")
    _close(kt, kj, dtype, "k")
    _close(vt, vj, dtype, "v")


@pytest.mark.parametrize("dtype", DTYPES)
def test_cross_attend_decode_matches_reference(dtype):
    """One decode step against a cross cache: every slot live, no RoPE, the
    cache left as it was (bit for bit)."""
    jc, tc = jax_cfg(ENCDEC), torch_cfg(ENCDEC)
    p = _cast(jp.materialize(ja.attn_spec(jc, cross=True),
                             jax.random.PRNGKey(4)), dtype)
    shape = (2, 15, jc.n_kv_heads, jc.head_dim)
    k, v = _draw(shape, 5), _draw(shape, 6)
    cj = {"k": jnp.asarray(k, getattr(jnp, dtype)),
          "v": jnp.asarray(v, getattr(jnp, dtype))}
    ct = {"k": _pair(k, dtype)[1], "v": _pair(v, dtype)[1]}
    before = {n: t.clone() for n, t in ct.items()}
    xj, xt = _pair(_draw((2, 1, jc.d_model), 7), dtype)
    yj, _ = ja.attend_decode(p, jc, xj, cj, 4, kind="attn", cross=True)
    yt, new_t = ta.attend_decode(_bridge(p), tc, xt, ct, 4, kind="attn",
                                 cross=True)
    assert new_t is ct
    assert all(torch.equal(ct[n], before[n]) for n in ct)
    _close(yt, yj, dtype, "y")


# ------------------------------------------------------------- whole model

B, S, EXTRA = 2, 12, 4            # EXTRA decode slots past the prefill
SE = 10                           # encoder frames (seamless)


def _batch(cfg, seed=0):
    """Numpy inputs of the reference's prefill_inputs kinds: tokens, with
    frames (B, SE, d) for seamless or image_embeds (B, img_tokens, d) for
    llava; and the decode tokens."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S + 2)).astype(np.int32)
    batch = {"tokens": toks[:, :S]}
    if cfg.is_encdec:
        batch["frames"] = _draw((B, SE, cfg.d_model), seed + 1, 0.5)
    else:
        batch["image_embeds"] = _draw((B, cfg.img_tokens, cfg.d_model),
                                      seed + 1, 0.5)
    return batch, toks[:, S:]


def _prefilled(cfg):
    """The length decode continues at: the image rows and the tokens."""
    return S + (cfg.img_tokens if cfg.modality == "image_patches" else 0)


@functools.lru_cache(maxsize=None)
def _jax_run(arch, dtype):
    """The JAX Bundle's prefill logits, then two decode steps' logits, its
    decode cache's leaves, the weights and the inputs."""
    jb = jax_bundle(jax_cfg(arch))
    params = _cast(jb.init(jax.random.PRNGKey(0)), dtype)
    batch, dec = _batch(jb.cfg)
    jd = getattr(jnp, dtype)
    jbatch = {k: jnp.asarray(v, jnp.int32 if k == "tokens" else jd)
              for k, v in batch.items()}
    L = _prefilled(jb.cfg)
    logits, cache = jb.prefill(params, jbatch, chunk=8, cache_len=L + EXTRA)
    out = [logits]
    for i in range(2):
        logits, cache = jb.decode(params, cache, jnp.asarray(dec[:, i:i + 1]),
                                  L + i)
        out.append(logits)
    return ([np.asarray(o, np.float32) for o in out],
            [(a.shape, np.dtype(a.dtype).name)
             for a in jax.tree.leaves(cache)], params, batch, dec)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", [ENCDEC, VLM])
def test_prefill_then_decode_matches_reference(arch, dtype):
    """Bundle.prefill then two Bundle.decode steps, decode continuing at the
    prefilled length (image rows included): the logits, and the cache's
    structure, shapes and dtypes (seamless's cross entries hold the
    encoder's K/V unpadded)."""
    tb = torch_bundle(torch_cfg(arch))
    V = tb.cfg.vocab_size
    want, jleaves, params, batch, dec = _jax_run(arch, dtype)
    td = getattr(torch, dtype)
    tbatch = {k: torch.from_numpy(v).to(td) if k != "tokens"
              else torch.from_numpy(v) for k, v in batch.items()}
    L = _prefilled(tb.cfg)
    pt = _bridge(params)
    lt, cache = tb.prefill(pt, tbatch, cache_len=L + EXTRA)
    got = [lt]
    for i in range(2):
        lt, out_cache = tb.decode(pt, cache, torch.from_numpy(dec[:, i:i + 1]),
                                  L + i)
        assert out_cache is cache
        got.append(lt)
    assert [(tuple(t.shape), str(t.dtype).split(".")[-1])
            for t in jax.tree.leaves(cache)] == jleaves
    if arch == ENCDEC:
        assert cache["stack"][0]["cross"]["k"].shape[2] == SE

    if dtype == "float32":
        bounds = [TOL[dtype] * _err(w[..., :V], w[..., :V])[1] for w in want]
    else:
        ref32 = _jax_run(arch, "float32")[0]
        bounds = []
        for w, r in zip(want, ref32):
            ref_err, scale = _err(w[..., :V], r[..., :V])
            bounds.append(TOL[dtype] * scale + 2 * ref_err)
    for step, (g, w, bound) in enumerate(zip(got, want, bounds)):
        assert g.shape == w.shape and g.dtype == torch.float32
        err, _ = _err(g[..., :V], w[..., :V])
        assert err <= bound, (step, err, bound)


@pytest.mark.parametrize("arch", [ENCDEC, VLM])
def test_train_logits_match_reference(arch):
    """Train-mode logits, f32: seamless's over the decoder tokens, llava's
    with the image positions dropped."""
    jb, tb = jax_bundle(jax_cfg(arch)), torch_bundle(torch_cfg(arch))
    params = _cast(jb.init(jax.random.PRNGKey(0)), "float32")
    batch, _ = _batch(jb.cfg, seed=3)
    want = jb.train_logits(params, {k: jnp.asarray(v)
                                    for k, v in batch.items()}, chunk=8)
    got = tb.train_logits(_bridge(params), {k: torch.from_numpy(v)
                                            for k, v in batch.items()})
    assert got.shape[:2] == (B, S)
    V = jb.cfg.vocab_size
    _close(got[..., :V], np.asarray(want)[..., :V], "float32", "logits")


def test_init_cache_cross_len_matches_reference():
    """init_cache with a cross cache: the reference's tree, shapes and
    dtypes."""
    jb, tb = jax_bundle(jax_cfg(ENCDEC)), torch_bundle(torch_cfg(ENCDEC))
    want = [(a.shape, np.dtype(a.dtype).name)
            for a in jax.tree.leaves(jb.init_cache(2, 16, cross_len=10))]
    cache = tb.init_cache(2, 16, cross_len=10, device="cpu")
    assert [(tuple(t.shape), str(t.dtype).split(".")[-1])
            for t in jax.tree.leaves(cache)] == want
    assert "cross" in cache["stack"][0]
